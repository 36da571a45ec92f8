"""repro_torch.backend: block-kernel execution backends.

A ``BlockBackend`` is the execution substrate under the NumS runtime: the
scheduler (LSHS) and executor (sync/pipelined dispatch, lineage) are backend
agnostic — placement decisions never read block values — so the same
schedule can run through the numpy interpreter (the bit-exact reference),
eager torch ops over device-resident blocks, or the hand-written
Hopper kernels, interchangeably.

Registry::

    from repro_torch.backend import make_backend
    be = make_backend("torch", dtype="float64", devices=["cpu"])

``Executor(mode=...)`` instantiates backends through ``make_backend``;
``register_backend`` lets external code plug in new substrates.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from .base import BackendStats, BlockBackend
from .numpy_backend import NumpyBackend

#: dtype a backend runs at when the user does not choose one: numpy keeps
#: full precision (it is the reference oracle); torch/cuda default to f32,
#: the accelerator-native dtype.
NATURAL_DTYPE: Dict[str, str] = {
    "numpy": "float64",
    "torch": "float32",
    "cuda": "float32",
}

_FACTORIES: Dict[str, Callable[..., BlockBackend]] = {}


def register_backend(name: str, factory: Callable[..., BlockBackend],
                     natural_dtype: str = "float64") -> None:
    _FACTORIES[name] = factory
    NATURAL_DTYPE.setdefault(name, natural_dtype)


def available_backends() -> list:
    return sorted(_FACTORIES)


def make_backend(name: str, dtype: Optional[str] = None,
                 devices: Optional[list] = None) -> BlockBackend:
    """Instantiate a registered backend.  ``dtype=None`` picks the backend's
    natural dtype (see ``NATURAL_DTYPE``); ``devices`` lists the torch
    devices nodes map onto (``None`` = every visible CUDA device)."""
    factory = _FACTORIES.get(name)
    if factory is None:
        raise ValueError(
            f"unknown backend {name!r}; available: {available_backends()}")
    return factory(dtype=dtype or NATURAL_DTYPE.get(name, "float64"),
                   devices=devices)


def _make_numpy(dtype: str, devices=None) -> BlockBackend:
    return NumpyBackend(dtype)


def _make_torch(dtype: str, devices=None) -> BlockBackend:
    from .torch_backend import TorchBackend

    return TorchBackend(dtype, devices=devices)


def _make_cuda(dtype: str, devices=None) -> BlockBackend:
    from .cuda_backend import CudaBackend

    return CudaBackend(dtype, devices=devices)


register_backend("numpy", _make_numpy)
register_backend("torch", _make_torch)
register_backend("cuda", _make_cuda)

__all__ = [
    "BackendStats",
    "BlockBackend",
    "NATURAL_DTYPE",
    "NumpyBackend",
    "available_backends",
    "make_backend",
    "register_backend",
]
