"""lbfgs_evals_per_iter.fit: program_spans.lbfgs_evals_per_iter, in the cells BENCHMARK.json lists for it."""

from bench_port.program_spans import lbfgs_evals_per_iter as read  # noqa: F401
