"""vg_enqueue_ms.fit_balanced: program_spans.vg_enqueue_ms, in the cells BENCHMARK.json lists for it."""

from bench_port.program_spans import vg_enqueue_ms as read  # noqa: F401
