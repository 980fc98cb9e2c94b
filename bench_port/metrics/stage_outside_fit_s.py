"""stage_outside_fit_s: readers.stage_outside_fit_s, in the cells BENCHMARK.json lists for it."""

from bench_port.readers import stage_outside_fit_s as read  # noqa: F401
