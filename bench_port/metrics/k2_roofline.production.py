"""k2_roofline.production: adam_readers.k2_roofline, in the cells BENCHMARK.json lists for it."""

from bench_port.adam_readers import k2_roofline as read  # noqa: F401
