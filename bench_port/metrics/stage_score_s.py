"""stage_score_s: program_spans.stage_score_s, in the cells BENCHMARK.json lists for it."""

from bench_port.program_spans import stage_score_s as read  # noqa: F401
