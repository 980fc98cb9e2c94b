"""peak_alloc_gib.fit_production: readers.peak_alloc_gib, in the cells BENCHMARK.json lists for it."""

from bench_port.readers import peak_alloc_gib as read  # noqa: F401
