"""fit_host_wait.stage: program_spans.fit_host_wait, in the cells BENCHMARK.json lists for it."""

from bench_port.program_spans import fit_host_wait as read  # noqa: F401
