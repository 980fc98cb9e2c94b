"""device_idle.fit_production: readers.device_idle, in the cells BENCHMARK.json lists for it."""

from bench_port.readers import device_idle as read  # noqa: F401
