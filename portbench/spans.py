"""Device idle time put down to the port's own spans.

The port opens ranges named ``repro_torch.<layer>...`` on the profiler's
timeline while it is traced (``src/repro_torch/core/trace.py``).  Over the
traced window, each instant at which the device is idle is put down to the
innermost such span open on the host at that instant, by one sorted pass
over the spans and the idle gaps.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "repro_torch."
#: the layers an idle instant can be put down to, by span name prefix;
#: Python's collector (``repro_torch.pycollect.*``) belongs to neither
LAYERS = {"sched": ("repro_torch.sched.",),
          "drain": ("repro_torch.exec.", "repro_torch.backend.")}

Piece = Tuple[int, int, str]  # start ns, end ns, innermost span's name


def program_records_spans() -> bool:
    """Whether the port under test opens spans (a port from before its span
    facility does not: its idle metrics are then not reported)."""
    from repro_torch.core import trace

    return hasattr(trace, "EXEC_DRAIN")


def innermost(host: Sequence[Tuple[str, int, int]]) -> List[Piece]:
    """The timeline cut into pieces, in order, each with the innermost
    program span open over it; none where no program span is open.  Spans
    nest (one thread): one that outlasts its parent is cut at the parent's
    end."""
    spans = sorted(((s, e, n) for n, s, e in host if n.startswith(PREFIX)),
                   key=lambda sp: (sp[0], -sp[1]))
    pieces: List[Piece] = []
    stack: List[Tuple[int, str]] = []  # (end, name), innermost last
    cursor = 0

    def close(until: float) -> None:
        nonlocal cursor
        while stack and stack[-1][0] <= until:
            end, name = stack.pop()
            if end > cursor:
                pieces.append((cursor, end, name))
                cursor = end

    for s, e, name in spans:
        close(s)
        if stack:
            if s > cursor:
                pieces.append((cursor, s, stack[-1][1]))
            e = min(e, stack[-1][0])
        cursor = s
        stack.append((e, name))
    close(math.inf)
    return pieces


def _layer(name: str) -> Optional[str]:
    for layer, prefixes in LAYERS.items():
        if name.startswith(prefixes):
            return layer
    return None


def idle_ns_by_layer(trace) -> Dict[str, int]:
    """Nanoseconds of device idle inside the window, by the layer of the
    innermost program span open on the host (``LAYERS``)."""
    out = {layer: 0 for layer in LAYERS}
    gaps = trace.gaps()
    i = 0
    for a, b, name in innermost(trace.host):
        layer = _layer(name)
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while layer is not None and j < len(gaps) and gaps[j][0] < b:
            out[layer] += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
    return out


def idle_ms_per_step(obs, layer: str) -> Optional[float]:
    """Device-idle milliseconds a step put down to ``layer``; 0.0 where no
    program span covers an idle instant, None without a trace, steps or a
    port that opens spans."""
    if obs.trace is None or obs.steps == 0 or not program_records_spans():
        return None
    return idle_ns_by_layer(obs.trace)[layer] / 1e6 / obs.steps
