"""Public wrappers of the port's kernels (counterpart of ``repro.kernels.ops``).

Each wrapper checks its inputs, then routes by the device the tensors lie
on: a CPU tensor takes the kernel's plain PyTorch version, a CUDA tensor
launches the hand-written kernel (or the wrapper raises).  There is no
fallback from one to the other.  ``launches`` counts kernel launches per
wrapper, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .glm_fused import DTYPE_CODES as _GLM_DTYPES
from .glm_fused import glm_fused_cuda, glm_fused_ref
from .matmul import DTYPE_CODES as _MATMUL_DTYPES
from .matmul import _CONFIGS, matmul_cuda, matmul_ref, split_plan

#: kernel launches per wrapper since the last ``reset_launches``
launches: Dict[str, int] = {"matmul": 0, "glm_fused": 0}

_GRID_LIMIT = 65535  # CUDA's limit on gridDim.y and gridDim.z


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _device_kind(name: str, *tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on different devices "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = a @ b for 2-D ``a`` (M, K) and ``b`` (K, N) of one dtype (f32,
    bf16 or f64); accumulates in f32 (f64 for f64), returns a's dtype.
    Transposed operands are passed as views (``x.mT``) and read in place."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"matmul: 2-D operands required, got {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: inner dims differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _MATMUL_DTYPES:
        raise TypeError(f"matmul: dtypes {a.dtype}/{b.dtype}; need one of "
                        f"{sorted(map(str, _MATMUL_DTYPES))} on both")
    if _device_kind("matmul", a, b) == "cpu":
        return matmul_ref(a, b)
    M, K = a.shape
    N = b.shape[1]
    if 0 in (M, N, K):
        raise ValueError(f"matmul: empty operand {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    for name, t in (("a", a), ("b", b)):
        if 1 not in t.stride() and 1 not in t.shape:
            raise ValueError(f"matmul: operand {name} has strides {t.stride()}; "
                             "the kernel needs a unit stride on one axis")
    config, _, splits = split_plan(M, N, K)
    if -(-N // _CONFIGS[config][1]) > _GRID_LIMIT or splits > _GRID_LIMIT:
        raise ValueError(f"matmul: ({M}, {K}) @ ({K}, {N}) exceeds the "
                         "kernel's launch grid")
    launches["matmul"] += 1
    return matmul_cuda(a, b)


def glm_fused(z: torch.Tensor, y: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mu, c, w) = (sigmoid(z), mu - y, mu(1 - mu)) in f32 for (n, d) z and
    y of one float dtype."""
    if z.ndim != 2 or z.shape != y.shape:
        raise ValueError(f"glm_fused: z and y must be (n, d) of one shape, got "
                         f"{tuple(z.shape)} and {tuple(y.shape)}")
    if z.dtype != y.dtype or z.dtype not in _GLM_DTYPES:
        raise TypeError(f"glm_fused: dtypes {z.dtype}/{y.dtype}; need one of "
                        f"{sorted(map(str, _GLM_DTYPES))} on both")
    if _device_kind("glm_fused", z, y) == "cpu":
        return glm_fused_ref(z, y)
    if not (z.is_contiguous() and y.is_contiguous()):
        raise ValueError("glm_fused: the kernel needs contiguous z and y")
    if z.numel() == 0:
        raise ValueError("glm_fused: empty input")
    launches["glm_fused"] += 1
    return glm_fused_cuda(z, y)
