"""fit_edges_s.stage: program_spans.fit_edges_s, in the cells BENCHMARK.json lists for it."""

from bench_port.program_spans import fit_edges_s as read  # noqa: F401
