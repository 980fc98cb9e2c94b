"""vg_graph_share.stage: graph_spans.vg_graph_share, in the cells BENCHMARK.json lists for it."""

from bench_port.graph_spans import vg_graph_share as read  # noqa: F401
