"""stage_write_s: program_spans.stage_write_s, in the cells BENCHMARK.json lists for it."""

from bench_port.program_spans import stage_write_s as read  # noqa: F401
