"""The device trace of one traced window, read from ``torch.profiler``.

The window is the host range ``portbench.window`` that the harness opens
around the measured steps; device operations (kernels, copies, fills) are
clipped to it.  From them come the busy seconds (the union of their
intervals), the device time of kernels by name, the operations that took
most time and the longest idle gaps, each gap named by the innermost host
operation or range that was running at its middle and its start within
the window.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW_RANGE = "portbench.window"
TOP = 10

Span = Tuple[str, int, int]  # name, start ns, end ns


class DeviceTrace:
    def __init__(self, window: Tuple[int, int], device: Sequence[Span], host: Sequence[Span]):
        t0, t1 = window
        self.window = window
        self.device = sorted((n, max(s, t0), min(e, t1)) for n, s, e in device
                             if e > t0 and s < t1)
        self.host = list(host)

    @classmethod
    def from_profiler(cls, prof) -> Optional["DeviceTrace"]:
        """None where the profile holds no window range."""
        window = None
        device: List[Span] = []
        host: List[Span] = []
        ranges = set()
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            start = ev.start_ns()
            span = (name, start, start + ev.duration_ns())
            on_device = ev.device_type().name == "CUDA"
            if name == WINDOW_RANGE:
                if not on_device:
                    window = span[1:]
                continue
            if _is_range(ev):
                ranges.add(name)
            if on_device:
                device.append(span)
            else:
                host.append(span)
        if window is None:
            return None
        # a host range's copy on the device timeline is no device operation
        return cls(window, [sp for sp in device if sp[0] not in ranges], host)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _name, s, e in sorted(self.device, key=lambda sp: sp[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def seconds_of(self, parts: Iterable[str]) -> float:
        """Device seconds of the operations whose name holds any of ``parts``."""
        parts = tuple(parts)
        return sum(e - s for n, s, e in self.device if any(p in n for p in parts)) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """Idle intervals of the device inside the window."""
        t0, t1 = self.window
        out, cursor = [], t0
        for s, e in self.busy_intervals():
            if s > cursor:
                out.append((cursor, s))
            cursor = max(cursor, e)
        if t1 > cursor:
            out.append((cursor, t1))
        return out

    def host_at(self, t: int) -> str:
        """The innermost host operation running at ``t``."""
        best: Optional[Span] = None
        for span in self.host:
            if span[1] <= t < span[2] and (best is None or span[2] - span[1] < best[2] - best[1]):
                best = span
        return best[0] if best is not None else "python (no torch operation)"

    def breakdown(self) -> Dict[str, List]:
        by_name: Dict[str, int] = defaultdict(int)
        for n, s, e in self.device:
            by_name[_short(n)] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        return {
            "device_ops": [[name, ns / 1e9] for name, ns in ops],
            "idle_gaps": [[f"host in {self.host_at((s + e) // 2)} at "
                           f"+{(s - self.window[0]) / 1e9:.3f} s", (e - s) / 1e9]
                          for s, e in gaps],
        }


def _is_range(ev) -> bool:
    """Whether a profiler event is a range opened by ``record_function`` (on
    the host or copied onto the device), where this torch says."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return "annotation" in kind()
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def _short(name: str) -> str:
    """A kernel's name without its parameter list."""
    if not name.startswith("Memcpy"):
        name = name.replace("(anonymous namespace)", "").split("(", 1)[0]
    return name[:160]
