"""stage_read_s: program_spans.stage_read_s, in the cells BENCHMARK.json lists for it."""

from bench_port.program_spans import stage_read_s as read  # noqa: F401
