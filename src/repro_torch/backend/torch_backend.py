"""The torch backend: eager torch ops over device-resident blocks.

Counterpart of ``repro.backend.jax_backend.JaxBackend``.  Blocks stay
``torch.Tensor``s end-to-end: ``from_host`` commits a host block to its
placement's device once at creation, every block op executes as torch ops
over device-resident operands, and values only return to the host at
``assemble``/``to_numpy`` time — the regression test counts
``stats.h2d``/``stats.d2h`` across op execution to pin this down.

PyTorch runs eagerly, so there is nothing to compile: ``OPS`` maps every
op of ``graph_array.execute_block_op`` to ``fn(meta, *inputs)`` with the
same formulas, and ``execute`` is one lookup and one call.  ``fused``
vertex chains run through ``graph_array.apply_chain`` over the torch op
tables, one dispatch per block.

Placements map node -> torch device (node i -> ``devices[i % len]``); on a
single-device host every node shares it and operand moves are no-ops.

dtype: float32 by default, float64 on request (the reference-grade parity
dtype).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph_array import apply_chain
from repro_torch.core.trace import BACKEND_SPANS, span

from .base import BlockBackend

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


#: torch mirrors of ``graph_array._UNARY`` / ``_BINARY`` (same formulas, so
#: f64 results agree with numpy to rounding of the same order)
UNARY: Dict[str, Callable] = {
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
BINARY: Dict[str, Callable] = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "pow": lambda a, b: a ** b,
    "maximum": lambda a, b: torch.maximum(*_pair(a, b)),
    "minimum": lambda a, b: torch.minimum(*_pair(a, b)),
}
_REDUCE = {"add": torch.sum, "maximum": torch.amax, "minimum": torch.amin}


def _unary(fn):
    return lambda meta, x: fn(x)


def _binary(fn):
    def binary(meta, a, b):
        if meta.get("expand_a"):
            a = a[..., None]
        if meta.get("expand_b"):
            b = b[..., None]
        return fn(a, b)

    return binary


def _scalar(meta, x):
    fn, s = BINARY[meta["op"]], meta["scalar"]
    return fn(s, x) if meta.get("reverse") else fn(x, s)


def matmul(meta, a, b):
    if meta.get("ta"):
        a = a.transpose(-1, -2)
    if meta.get("tb"):
        b = b.transpose(-1, -2)
    return a @ b


def _reduce_axis(meta, x):
    red, axis = _REDUCE[meta.get("op", "add")], meta["axis"]
    return red(x) if axis is None else red(x, dim=axis)


def _transpose(meta, x):
    perm = meta.get("perm")
    return x.permute(tuple(perm) if perm else tuple(reversed(range(x.ndim))))


def _slice(meta, x):
    return x[tuple(slice(int(a), int(b))
                   for a, b in zip(meta["starts"], meta["stops"]))]


def _concat_blocks(meta, *pieces):
    out = torch.zeros(tuple(int(s) for s in meta["shape"]),
                      dtype=pieces[0].dtype, device=pieces[0].device)
    for off, piece in zip(meta["offsets"], pieces):
        out[tuple(slice(int(o), int(o) + s)
                  for o, s in zip(off, piece.shape))] = piece
    return out


def _matricize(meta, x):
    mode = meta["mode"]
    return torch.movedim(x, mode, 0).reshape(x.shape[mode], -1)


def _khatri_rao(meta, a, b):
    return torch.einsum("jf,kf->jkf", a, b).reshape(a.shape[0] * b.shape[0],
                                                    a.shape[1])


def _svd(i):
    return lambda meta, x: torch.linalg.svd(x, full_matrices=False)[i]


#: op name -> ``fn(meta, *inputs)``: every op of ``execute_block_op``, so
#: there is no interpreter fallback (``stats.fallbacks`` stays 0)
OPS: Dict[str, Callable] = {
    **{op: _unary(fn) for op, fn in UNARY.items()},
    **{op: _binary(fn) for op, fn in BINARY.items()},
    "scalar": _scalar,
    "matmul": matmul,
    "reduce_axis": _reduce_axis,
    "transpose": _transpose,
    "tensordot": lambda meta, a, b: torch.tensordot(a, b, dims=meta["axes"]),
    "einsum": lambda meta, *xs: torch.einsum(meta["spec"], *xs),
    "fused": lambda meta, x: apply_chain(x, meta["chain"], UNARY, BINARY),
    "qr_r": lambda meta, x: torch.linalg.qr(x, mode="r")[1],
    "qr_q": lambda meta, x: torch.linalg.qr(x)[0],
    "qr_stackr": lambda meta, *xs: torch.linalg.qr(torch.cat(xs, dim=0),
                                                   mode="r")[1],
    "stack": lambda meta, *xs: torch.cat(xs, dim=0),
    "slice_rows": lambda meta, x: x[meta["start"]:meta["stop"]],
    "slice": _slice,
    "concat_blocks": _concat_blocks,
    "matricize": _matricize,
    "khatri_rao": _khatri_rao,
    "solve": lambda meta, h, g: torch.linalg.solve(h, g),
    "rsolve": lambda meta, x, r: torch.linalg.solve(r.T, x.T).T,
    "tsolve": lambda meta, a, b: torch.linalg.solve(a.T, b),
    "potrf": lambda meta, x: torch.linalg.cholesky(x),
    "trsm": lambda meta, a, l: torch.linalg.solve(l, a.T).T,
    "syrk_update": lambda meta, c, a, b: c - a @ b.T,
    "svd_u": _svd(0),
    "svd_s": _svd(1),
    "svd_vt": _svd(2),
}


class TorchBackend(BlockBackend):
    name = "torch"
    #: the op table ``execute`` dispatches through (subclasses swap entries)
    ops: Dict[str, Callable] = OPS

    def __init__(self, dtype: str = "float32", devices: Optional[list] = None):
        super().__init__(dtype)
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported block dtype {dtype!r}; one of {_DTYPES}")
        self._devices = resolve_devices(devices)

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
        """One block op: a table lookup (``KeyError`` on an unknown op) and
        one call, inside the op's span while ``spans`` is set."""
        self.stats.dispatches += 1
        inputs = self._colocate(inputs, placement)
        fn = self.ops[op]
        if self.spans:
            with span(BACKEND_SPANS[op]):
                return fn(meta, *inputs)
        return fn(meta, *inputs)

    def _colocate(self, inputs, placement):
        """Move operands onto the placement's device (no-op on one device;
        the scheduler already minimized these moves — they mirror the
        transfers ``ClusterState.transition`` accounted)."""
        if len(self._devices) == 1:
            return inputs
        dev = self.device_of(placement)
        out = []
        for x in inputs:
            if x.device != dev:
                x = x.to(dev)
                self.stats.device_moves += 1
            out.append(x)
        return out


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
