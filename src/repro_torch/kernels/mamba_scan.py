"""Selective scan (Mamba-1 recurrence): the Hopper kernel
(``csrc/mamba_scan.cu``) and its plain PyTorch version.

Counterpart of ``repro.kernels.mamba_scan.mamba_scan_pallas`` (the kernel)
and ``repro.kernels.ref.mamba_scan_ref`` (the oracle):
h_t = dA_t * h_{t-1} + dBx_t and y_t = sum_n h_t[:, n] * C_t[n], from
h_0 = 0, for dA, dBx (B, S, DI, N) and C (B, S, N), all f32.  Both versions
return y (B, S, DI) and the final carry h_S (B, DI, N): the model keeps the
carry as its SSM state for decoding.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

#: state widths the kernel is instantiated for (N lanes share a warp)
STATE_DIMS = (1, 2, 4, 8, 16, 32)

_fn = None


def mamba_scan_ref(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the recurrence step by step, in f32."""
    B, S, DI, N = dA.shape
    h = torch.zeros((B, DI, N), dtype=torch.float32, device=dA.device)
    y = torch.empty((B, S, DI), dtype=torch.float32, device=dA.device)
    for t in range(S):
        h = dA[:, t] * h + dBx[:, t]
        y[:, t] = (h * C[:, t, None, :]).sum(-1)
    return y, h


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("mamba_scan").repro_mamba_scan
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        _fn = fn
    return _fn


def mamba_scan_cuda(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on contiguous CUDA tensors the wrapper
    (``ops.mamba_scan``) has checked; allocates y and the final carry."""
    B, S, DI, N = dA.shape
    y = torch.empty((B, S, DI), dtype=torch.float32, device=dA.device)
    h = torch.empty((B, DI, N), dtype=torch.float32, device=dA.device)
    with torch.cuda.device(dA.device):
        err = _kernel()(
            dA.data_ptr(), dBx.data_ptr(), C.data_ptr(), y.data_ptr(), h.data_ptr(),
            B, S, DI, N, torch.cuda.current_stream(dA.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error {err}")
    return y, h
