"""Fused GLM elementwise pass: the Hopper kernel (``csrc/glm_fused.cu``) and
its plain PyTorch version.

Counterpart of ``repro.kernels.glm_fused.glm_fused_pallas`` (the kernel) and
``repro.kernels.ref.glm_fused_ref`` (the oracle): one pass over z and y
writes mu = sigmoid(z), c = mu - y and w = mu(1 - mu), all in f32.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

#: dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
               torch.float16: 3}

_fn = None


def glm_fused_ref(z: torch.Tensor, y: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version, in f32 like the kernel."""
    mu = torch.sigmoid(z.to(torch.float32))
    return mu, mu - y.to(torch.float32), mu * (1.0 - mu)


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("glm_fused").repro_glm_fused
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int64, ctypes.c_void_p])
        _fn = fn
    return _fn


def glm_fused_cuda(z: torch.Tensor, y: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on contiguous CUDA tensors the wrapper
    (``ops.glm_fused``) has checked; allocates the three outputs."""
    mu, c, w = (torch.empty(z.shape, dtype=torch.float32, device=z.device)
                for _ in range(3))
    with torch.cuda.device(z.device):
        err = _kernel()(
            DTYPE_CODES[z.dtype], z.data_ptr(), y.data_ptr(), mu.data_ptr(),
            c.data_ptr(), w.data_ptr(), z.numel(),
            torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"glm_fused kernel launch failed: CUDA error {err}")
    return mu, c, w
