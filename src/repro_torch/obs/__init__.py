"""Observability: the unified metrics registry behind ``ctx.loads()``.

This package depends only on the standard library — ``repro_torch.core``
imports nothing from here at module scope, so there is no import cycle.
Trace export and critical-path attribution are not ported yet (ROADMAP
Queue 1 item 5).
"""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
