"""Unified metrics registry: one stable ``snapshot()`` schema for every
runtime stats source.

The runtime grew four ad-hoc stats objects (``SchedStats``, ``BackendStats``,
``ChaosStats``, ``MemStats``) plus the cluster load summary, each with its
own ``as_dict``/``snapshot`` spelling, and ``ArrayContext.loads()`` glued
them together inline — so every PR that touched a stats object silently
reshaped the ``loads()`` schema that ``check_smoke.py`` gates on.  The
registry inverts that: stats sources register as named *providers* and
``snapshot()`` merges them in registration order, so the key set is a
function of the registered features alone (golden-tested per feature set in
``tests/test_obs.py``).

Primitives (``Counter``/``Gauge``/``Histogram``) cover metrics that have no
backing stats object; most runtime metrics flow through providers wrapping
the existing dataclasses, which keeps the hot paths free of registry
lookups.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import math


class Counter:
    """Monotonically increasing value with a stable name."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += amount

    def snapshot(self) -> Dict[str, float]:
        return {self.name: self.value}

    def reset(self) -> None:
        self.value = 0.0


class Gauge:
    """Last-written value with a stable name."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> Dict[str, float]:
        return {self.name: self.value}

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Fixed-bucket histogram; snapshots as ``name_count/_sum/_p50/_max``.

    Buckets are cumulative upper bounds (Prometheus-style).  The quantile is
    estimated from the bucket the rank falls in (upper bound), which is
    enough for overhead triage; exact percentiles come from the trace.
    """

    __slots__ = ("name", "help", "bounds", "counts", "count", "sum", "max")

    DEFAULT_BOUNDS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)

    def __init__(self, name: str, help: str = "",
                 bounds: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.help = help
        self.bounds = tuple(bounds) if bounds is not None else self.DEFAULT_BOUNDS
        self.counts = [0] * (len(self.bounds) + 1)  # +inf overflow bucket
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        if v > self.max:
            self.max = v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        rank = math.ceil(q * self.count)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self.bounds[i] if i < len(self.bounds) else self.max
        return self.max  # pragma: no cover - rank <= count always hits

    def snapshot(self) -> Dict[str, float]:
        return {
            f"{self.name}_count": float(self.count),
            f"{self.name}_sum": self.sum,
            f"{self.name}_p50": self.quantile(0.5),
            f"{self.name}_max": self.max,
        }

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0


class MetricsRegistry:
    """Named metrics + named providers, one merged ``snapshot()``.

    Providers are ``name -> () -> dict`` callables merged in registration
    order (later keys win, mirroring the historical ``loads()`` assembly);
    primitive metrics merge last.  ``schema()`` returns the current key list
    without values — what the golden schema test pins.
    """

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._providers: List[Tuple[str, Callable[[], Dict[str, Any]]]] = []

    # -- primitives -------------------------------------------------------
    def _register(self, metric):
        if metric.name in self._metrics:
            raise ValueError(f"duplicate metric name {metric.name!r}")
        self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge(name, help))

    def histogram(self, name: str, help: str = "",
                  bounds: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._register(Histogram(name, help, bounds))

    # -- providers --------------------------------------------------------
    def register_provider(self, name: str,
                          fn: Callable[[], Dict[str, Any]]) -> None:
        if any(n == name for n, _f in self._providers):
            raise ValueError(f"duplicate provider name {name!r}")
        self._providers.append((name, fn))

    def provider_names(self) -> List[str]:
        return [n for n, _f in self._providers]

    # -- snapshot ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for _name, fn in self._providers:
            out.update(fn())
        for metric in self._metrics.values():
            out.update(metric.snapshot())
        return out

    def schema(self) -> List[str]:
        return list(self.snapshot().keys())

    def reset(self) -> None:
        for metric in self._metrics.values():
            metric.reset()
