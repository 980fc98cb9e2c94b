"""fit_mfu.production: readers.fit_mfu, in the cells BENCHMARK.json lists for it."""

from bench_port.readers import fit_mfu as read  # noqa: F401
