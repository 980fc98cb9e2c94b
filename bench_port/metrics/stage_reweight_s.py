"""stage_reweight_s: program_spans.stage_reweight_s, in the cells BENCHMARK.json lists for it."""

from bench_port.program_spans import stage_reweight_s as read  # noqa: F401
