"""adam_fused_share.production: adam_readers.adam_fused_share, in the cells BENCHMARK.json lists for it."""

from bench_port.adam_readers import adam_fused_share as read  # noqa: F401
