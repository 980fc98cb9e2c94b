"""fit_kernel_roofline.production: readers.fit_kernel_roofline, in the cells BENCHMARK.json lists for it."""

from bench_port.readers import fit_kernel_roofline as read  # noqa: F401
