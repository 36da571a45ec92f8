"""``BlockBackend``: the compiled block-kernel execution protocol.

The scheduler decides *where* a block op runs (LSHS placements) and the
executor decides *when* (sync vs pipelined dispatch); a backend decides
*how*: which kernel implementation executes the block math and where block
values physically live between ops.  Placement decisions never depend on
block values, so every backend sees the identical schedule — backends are a
pure substitution of the execution substrate.

Contract:

* ``from_host(arr, placement)`` commits a host numpy array to backend
  storage (a device tensor for torch); ``to_host(value)`` converts back.  Both
  count in ``stats`` (``h2d``/``d2h``) — the executor's hot path must never
  call them between ops, which the host-transfer regression test asserts.
* ``execute(op, meta, inputs, placement)`` runs one block-level op on
  backend-resident inputs and returns a backend-resident output.
* ``compile_cache`` is the backend's structural compile cache (``None`` for
  interpreters with nothing to compile).

Backends must be bit-exact replaceable at equal precision: the ``numpy``
backend is the reference semantics (``graph_array.execute_block_op``), and
torch/cuda must match it within dtype-appropriate tolerance on every op.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from .compile_cache import CompileCache


@dataclass
class BackendStats:
    """Execution-substrate counters (complement ``ExecStats``, which counts
    dispatches, and ``SchedStats``, which counts scheduling time)."""

    dispatches: int = 0     # execute() calls (one per block op)
    jit_calls: int = 0      # memoized-callable invocations (torch/cuda)
    h2d: int = 0            # host -> device commits (from_host)
    d2h: int = 0            # device -> host gathers (to_host)
    device_moves: int = 0   # device -> device operand moves
    fallbacks: int = 0      # ops executed via the numpy fallback path
    replays: int = 0        # lineage-replay re-executions (fault recovery)

    def reset(self) -> None:
        self.dispatches = 0
        self.jit_calls = 0
        self.h2d = 0
        self.d2h = 0
        self.device_moves = 0
        self.fallbacks = 0
        self.replays = 0

    def as_dict(self) -> Dict[str, int]:
        return {
            "backend_dispatches": self.dispatches,
            "backend_jit_calls": self.jit_calls,
            "backend_h2d": self.h2d,
            "backend_d2h": self.d2h,
            "backend_device_moves": self.device_moves,
            "backend_fallbacks": self.fallbacks,
            "backend_replays": self.replays,
        }


class BlockBackend:
    """Abstract block-kernel execution backend (see module docstring)."""

    name: str = "abstract"

    def __init__(self, dtype: str = "float64"):
        self.dtype = dtype
        self.stats = BackendStats()
        # flight recorder (core.trace): when set, compiled backends record
        # compile-cache hits/misses and fallbacks at dispatch time
        self.tracer = None

    # -- storage ------------------------------------------------------------
    def from_host(self, arr: np.ndarray, placement: Tuple[int, int]):
        raise NotImplementedError

    def to_host(self, value) -> np.ndarray:
        raise NotImplementedError

    # -- execution ----------------------------------------------------------
    def execute(self, op: str, meta: Dict[str, Any], inputs: Sequence[Any],
                placement: Tuple[int, int]):
        raise NotImplementedError

    def wait(self, value) -> None:
        """Block until ``value`` is ready (no-op for synchronous backends;
        async runtimes override — the readiness barrier behind
        ``GraphArray.wait``)."""

    # -- spill channel -------------------------------------------------------
    # Memory-budgeted eviction moves block values to a host-side store and
    # back through the same from_host/to_host paths (counted as d2h/h2d so
    # the host-transfer regression test keeps seeing the hot path clean).
    def spill_out(self, value) -> np.ndarray:
        """Evict a backend-resident block value to a host numpy array."""
        return self.to_host(value)

    def spill_in(self, host: np.ndarray, placement: Tuple[int, int]):
        """Fault a spilled host array back into backend storage."""
        return self.from_host(host, placement)

    # -- introspection -------------------------------------------------------
    @property
    def compile_cache(self) -> Optional[CompileCache]:
        return None

    def counters(self) -> Dict[str, float]:
        d: Dict[str, float] = dict(self.stats.as_dict())
        cc = self.compile_cache
        if cc is not None:
            d.update(cc.counters())
        return d
