"""epilogue_fused_share.production: epilogue_readers.epilogue_fused_share, in the cells BENCHMARK.json lists for it."""

from bench_port.epilogue_readers import epilogue_fused_share as read  # noqa: F401
