"""Device idle put down to the LM path's sublayer spans.

While ``torch.profiler`` records, the port opens ``repro_torch.lm.mamba``,
``.attention``, ``.moe``, ``.mlp`` and ``.head`` around each sublayer
(``src/repro_torch/core/trace.py``).  Each idle instant of the traced window
is put down to the innermost program span open on the host then
(``spans.innermost``), as ``spans.idle_ns_by_layer`` does for the block
runtime's layers.
"""
from __future__ import annotations

from typing import Optional

from portbench.spans import innermost


def program_opens_lm_spans() -> bool:
    """Whether the port under test opens the LM path's spans (one from
    before them does not: the metrics are then not reported)."""
    from repro_torch.core import trace

    return hasattr(trace, "LM_MAMBA")


def idle_ns_under(trace, name: str) -> int:
    """Nanoseconds of device idle in the window while the innermost program
    span on the host is ``name``."""
    gaps = trace.gaps()
    total, i = 0, 0
    for a, b, span in innermost(trace.host):
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        if span != name:
            continue
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            total += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
    return total


def idle_ms_per_step(obs, name: str) -> Optional[float]:
    """Device-idle milliseconds a step under the span ``name``; None without
    a trace, steps or a port that opens the LM spans."""
    if obs.trace is None or obs.steps == 0 or not program_opens_lm_spans():
        return None
    return idle_ns_under(obs.trace, name) / 1e6 / obs.steps
