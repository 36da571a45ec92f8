"""The torch backend: per-op torch callables over device-resident blocks.

Counterpart of ``repro.backend.jax_backend.JaxBackend``.  Blocks stay
``torch.Tensor``s end-to-end: ``from_host`` commits a host block to its
placement's device once at creation, every block op executes as a torch
callable over device-resident operands, and values only return to the host
at ``assemble``/``to_numpy`` time — the regression test counts
``stats.h2d``/``stats.d2h`` across op execution to pin this down.

PyTorch runs eagerly, so there is nothing to compile; the structural
compile cache (``compile_cache.GLOBAL_COMPILE_CACHE``) memoizes the *built*
callable per key (op kind + interned metadata + input (shape, dtype)
signature) with the reference's counters.  ``fused`` vertex chains run
through ``graph_array.apply_chain`` over torch op tables in one callable,
one dispatch per block.

Placements map node -> torch device (node i -> ``devices[i % len]``); on a
single-device host every node shares it and operand moves are no-ops.

dtype: float32 by default, float64 on request (the reference-grade parity
dtype).
"""
from __future__ import annotations

from time import perf_counter
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph_array import apply_chain
from repro_torch.core.trace import BACKEND_SPANS, COMPILE_SPANS, NO_SPAN, span

from .base import BlockBackend
from .compile_cache import GLOBAL_COMPILE_CACHE, CompileCache, structural_key

_DTYPES = ("float32", "float64")


def _pair(a, b):
    """Promote a Python scalar operand to a 0-d tensor beside its partner."""
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, dtype=b.dtype, device=b.device)
    elif not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return a, b


def _logaddexp0(x):
    return torch.logaddexp(torch.zeros((), dtype=x.dtype, device=x.device), x)


def torch_tables():
    """torch mirrors of ``graph_array._UNARY`` / ``_BINARY`` (same formulas,
    so f64 results agree with numpy to rounding of the same order)."""
    unary = {
        "neg": lambda x: -x,
        "exp": torch.exp,
        "log": torch.log,
        "sqrt": torch.sqrt,
        "abs": torch.abs,
        "square": torch.square,
        "sigmoid": lambda x: torch.exp(-_logaddexp0(-x)),
        "tanh": torch.tanh,
        "identity": lambda x: x,
        "softplus": _logaddexp0,
        "relu": lambda x: torch.maximum(x, torch.zeros((), dtype=x.dtype,
                                                       device=x.device)),
        "rsqrt": lambda x: 1.0 / torch.sqrt(x),
        "reciprocal": lambda x: 1.0 / x,
    }
    binary = {
        "add": lambda a, b: a + b,
        "sub": lambda a, b: a - b,
        "mul": lambda a, b: a * b,
        "div": lambda a, b: a / b,
        "pow": lambda a, b: a ** b,
        "maximum": lambda a, b: torch.maximum(*_pair(a, b)),
        "minimum": lambda a, b: torch.minimum(*_pair(a, b)),
    }
    return unary, binary


class TorchBackend(BlockBackend):
    name = "torch"
    _salt = "torch"  # compile-cache flavor for this backend's callables

    def __init__(self, dtype: str = "float32", devices: Optional[list] = None,
                 cache: Optional[CompileCache] = None):
        super().__init__(dtype)
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported block dtype {dtype!r}; one of {_DTYPES}")
        self._devices = resolve_devices(devices)
        self._unary, self._binary = torch_tables()
        self._cache = cache if cache is not None else GLOBAL_COMPILE_CACHE

    # -- storage ------------------------------------------------------------
    @property
    def devices(self) -> list:
        return list(self._devices)

    def device_of(self, placement: Tuple[int, int]) -> torch.device:
        return self._devices[placement[0] % len(self._devices)]

    def from_host(self, arr: np.ndarray, placement: Tuple[int, int]):
        self.stats.h2d += 1
        host = torch.from_numpy(np.ascontiguousarray(arr, dtype=self.dtype))
        return host.to(self.device_of(placement))

    def to_host(self, value) -> np.ndarray:
        self.stats.d2h += 1
        return value.detach().cpu().numpy()

    def wait(self, value) -> None:
        if value.device.type == "cuda":
            torch.cuda.synchronize(value.device)

    # -- execution ----------------------------------------------------------
    def execute(self, op: str, meta: Dict[str, Any], inputs: Sequence[Any],
                placement: Tuple[int, int]):
        return self._dispatch(self._salt, op, meta, inputs, placement,
                              self._build)

    def _dispatch(self, salt: str, op: str, meta: Dict[str, Any],
                  inputs: Sequence[Any], placement: Tuple[int, int],
                  build: Callable[[str, Dict[str, Any]], Optional[Callable]]):
        """The one memoized dispatch protocol (shared with subclasses that
        contribute their own callables under a different ``salt``): one span
        per op while ``spans`` is set."""
        if self.spans:
            with span(BACKEND_SPANS[op]):
                return self._dispatch_op(salt, op, meta, inputs, placement, build)
        return self._dispatch_op(salt, op, meta, inputs, placement, build)

    def _dispatch_op(self, salt: str, op: str, meta: Dict[str, Any],
                     inputs: Sequence[Any], placement: Tuple[int, int],
                     build: Callable[[str, Dict[str, Any]], Optional[Callable]]):
        self.stats.dispatches += 1
        inputs = self._colocate(inputs, placement)
        key = structural_key(salt, op, meta, self._signature(inputs))
        fn = self._cache.get(key)
        tr = self.tracer
        if fn is not None:
            self.stats.jit_calls += 1
            if tr is not None:  # FlightRecorder.record, inlined
                ev = tr.events
                if len(ev) == tr.capacity:
                    tr.dropped += 1
                ev.append(("compile_hit", op, placement, perf_counter()))
            return fn(*inputs)
        with span(COMPILE_SPANS[op]) if self.spans else NO_SPAN:
            fn = build(op, meta)
            if fn is None:
                raise KeyError(f"unknown block op {op!r}")
            t0 = perf_counter()
            self.stats.jit_calls += 1
            out = fn(*inputs)
            self.wait(out)  # charge build + first run to compile_s
        self._cache.put(key, fn, compile_seconds=perf_counter() - t0)
        if tr is not None:
            tr.record("compile_miss", op, placement[0], placement[1],
                      args={"compile_s": perf_counter() - t0})
        return out

    def _signature(self, inputs) -> Tuple[Tuple[Tuple[int, ...], str], ...]:
        return tuple((tuple(x.shape), str(x.dtype)) for x in inputs)

    def _colocate(self, inputs, placement):
        """Move operands onto the placement's device (no-op on one device;
        the scheduler already minimized these moves — they mirror the
        transfers ``ClusterState.transition`` accounted)."""
        if len(self._devices) == 1:
            return list(inputs)
        dev = self.device_of(placement)
        out = []
        for x in inputs:
            if x.device != dev:
                x = x.to(dev)
                self.stats.device_moves += 1
            out.append(x)
        return out

    # -- lowering ------------------------------------------------------------
    def _build(self, op: str, meta: Dict[str, Any]) -> Optional[Callable]:
        """Return a torch callable implementing one block op (metadata baked
        in; shapes/dtypes fixed by the cache key).  The table covers every op
        of ``graph_array.execute_block_op``, so there is no interpreter
        fallback (``stats.fallbacks`` stays 0)."""
        if op in self._unary:
            return self._unary[op]
        if op in self._binary:
            fn = self._binary[op]
            ea, eb = bool(meta.get("expand_a")), bool(meta.get("expand_b"))

            def binary(a, b, fn=fn, ea=ea, eb=eb):
                if ea:
                    a = a[..., None]
                if eb:
                    b = b[..., None]
                return fn(a, b)

            return binary
        if op == "scalar":
            fn = self._binary[meta["op"]]
            s = meta["scalar"]
            if meta.get("reverse"):
                return lambda x: fn(s, x)
            return lambda x: fn(x, s)
        if op == "matmul":
            ta, tb = bool(meta.get("ta")), bool(meta.get("tb"))

            def matmul(a, b):
                if ta:
                    a = a.transpose(-1, -2)
                if tb:
                    b = b.transpose(-1, -2)
                return a @ b

            return matmul
        if op == "reduce_axis":
            axis = meta["axis"]
            red = {"add": torch.sum, "maximum": torch.amax,
                   "minimum": torch.amin}[meta.get("op", "add")]
            if axis is None:
                return red
            return lambda x: red(x, dim=axis)
        if op == "transpose":
            perm = meta.get("perm")
            return lambda x: x.permute(
                tuple(perm) if perm else tuple(reversed(range(x.ndim))))
        if op == "tensordot":
            axes = meta["axes"]
            return lambda a, b: torch.tensordot(a, b, dims=axes)
        if op == "einsum":
            spec = meta["spec"]
            return lambda *xs: torch.einsum(spec, *xs)
        if op == "fused":
            chain = meta["chain"]
            return lambda x: apply_chain(x, chain, self._unary, self._binary)
        if op == "qr_r":
            return lambda x: torch.linalg.qr(x, mode="r")[1]
        if op == "qr_q":
            return lambda x: torch.linalg.qr(x)[0]
        if op == "qr_stackr":
            return lambda *xs: torch.linalg.qr(torch.cat(xs, dim=0),
                                               mode="r")[1]
        if op == "stack":
            return lambda *xs: torch.cat(xs, dim=0)
        if op == "slice_rows":
            start, stop = meta["start"], meta["stop"]
            return lambda x: x[start:stop]
        if op == "slice":
            idx = tuple(slice(int(a), int(b))
                        for a, b in zip(meta["starts"], meta["stops"]))
            return lambda x: x[idx]
        if op == "concat_blocks":
            shape = tuple(int(s) for s in meta["shape"])
            offsets = [tuple(int(o) for o in off) for off in meta["offsets"]]

            def concat_blocks(*pieces):
                out = torch.zeros(shape, dtype=pieces[0].dtype,
                                  device=pieces[0].device)
                for off, piece in zip(offsets, pieces):
                    out[tuple(slice(o, o + s)
                              for o, s in zip(off, piece.shape))] = piece
                return out

            return concat_blocks
        if op == "matricize":
            mode = meta["mode"]
            return lambda x: torch.movedim(x, mode, 0).reshape(
                x.shape[mode], -1)
        if op == "khatri_rao":
            return lambda a, b: torch.einsum("jf,kf->jkf", a, b).reshape(
                a.shape[0] * b.shape[0], a.shape[1])
        if op == "solve":
            return lambda h, g: torch.linalg.solve(h, g)
        if op == "rsolve":
            return lambda x, r: torch.linalg.solve(r.T, x.T).T
        if op == "tsolve":
            return lambda a, b: torch.linalg.solve(a.T, b)
        if op == "potrf":
            return torch.linalg.cholesky
        if op == "trsm":
            return lambda a, l: torch.linalg.solve(l, a.T).T
        if op == "syrk_update":
            return lambda c, a, b: c - a @ b.T
        if op == "svd_u":
            return lambda x: torch.linalg.svd(x, full_matrices=False)[0]
        if op == "svd_s":
            return lambda x: torch.linalg.svd(x, full_matrices=False)[1]
        if op == "svd_vt":
            return lambda x: torch.linalg.svd(x, full_matrices=False)[2]
        return None

    @property
    def compile_cache(self) -> Optional[CompileCache]:
        return self._cache


def resolve_devices(devices: Optional[list]) -> list:
    """Torch devices that nodes map onto.  ``None`` means every visible CUDA
    device and raises where there is none: the port runs on the card unless
    the caller asks for the CPU (``["cpu"]``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("empty device list")
    return out


def resolve_device(device=None) -> torch.device:
    """One device: ``None`` or ``"cuda"`` means the first CUDA device and
    raises where there is none."""
    if device is not None and str(device) == "cuda":
        device = None
    return resolve_devices(None if device is None else [device])[0]
