"""What the kinds of cell share: the record of one measured window, the
device barrier, freeing, host copies and the set-up's phases; and, for the
kinds that run the port's block runtime, its context built from a
configuration's ``context`` group, the control's precision and the
profiler ranges around the runtime's layers."""
from __future__ import annotations

import gc
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class Window:
    """One measured window: whole steps only, timed on the host's clock.
    ``extra`` holds whatever else a kind records for its own metrics."""

    steps: int
    window_s: float
    step_times: List[float] = field(default_factory=list)
    extra: Dict = field(default_factory=dict)


def make_context(context: Dict, device: str):
    """``repro_torch.core.ArrayContext`` as a configuration's ``context``
    group states it, its blocks on ``device``."""
    from repro_torch.core import ArrayContext
    from repro_torch.core.layout import ClusterSpec

    return ArrayContext(
        cluster=ClusterSpec(*context["cluster"]), node_grid=tuple(context["node_grid"]),
        backend=context["backend"], dtype=context["dtype"], pipeline=context["pipeline"],
        plan_cache=context["plan_cache"], gc=context["gc"], seed=context["seed"],
        device=device)


#: the precision one step below a block configuration's: its control's
_LOWER_DTYPE = {"float64": "float32"}


def lower_precision(config: Dict) -> Dict:
    """The configuration overrides of a block kind's control: the port's
    own path one precision below ``context.dtype``."""
    context = config["context"]
    return {"context": {**context, "dtype": _LOWER_DTYPE[context["dtype"]]}}


def layer_ranges(ctx) -> None:
    """Open a profiler range around each call into the port's layers, so
    that the trace names what the host was doing: the scheduler's
    ``compute``, the executor's ``flush`` and the backend's ``execute``
    (instance attributes; the traced run only)."""
    import torch

    def ranged(obj, attr, label):
        call = getattr(obj, attr)

        def inner(*args, **kwargs):
            with torch.profiler.record_function(label):
                return call(*args, **kwargs)

        setattr(obj, attr, inner)

    ranged(ctx, "compute", "scheduler: ArrayContext.compute")
    ranged(ctx.executor, "flush", "executor: Executor.flush")
    ranged(ctx.executor.backend, "execute", "backend: execute")


def sync(device: str) -> None:
    """Wait for the card (nothing to wait for on the host)."""
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)


def release(device: str) -> None:
    """Free what dropped objects held: a block context holds reference
    cycles, so only the collector frees its store."""
    import torch

    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()


def reset_peak(device: str) -> None:
    """Start the card's memory peak afresh (after the harness's own inputs
    are freed, so that the peak is the port's)."""
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats(device)


def host_copy(tensor):
    """A device tensor as a host numpy array (the port's ``from_numpy`` is its
    only entry for caller data).  A card's tensor goes through page-locked
    memory: on the H100's host a 17 GB copy took 8.2 s into pageable memory
    and 5.3 s into page-locked memory, allocation included, and the port's
    ``from_numpy`` read it back 2.1 s faster."""
    import torch

    if tensor.device.type != "cuda":
        return tensor.numpy()
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor)
    return host.numpy()


class Phases:
    """Host seconds of the named phases of a set-up, in order."""

    def __init__(self, device: str):
        from time import perf_counter

        self._clock = perf_counter
        self._device = device
        self._last = perf_counter()
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        """End the phase ``name`` (waiting for the card first)."""
        sync(self._device)
        now = self._clock()
        self.seconds[name] = now - self._last
        self._last = now
