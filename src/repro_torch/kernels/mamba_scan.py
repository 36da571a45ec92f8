"""Selective scan (Mamba-1 recurrence): the Hopper kernel
(``csrc/mamba_scan.cu``) and its plain PyTorch version.

Counterpart of ``repro.kernels.mamba_scan.mamba_scan_pallas`` (the kernel)
and ``repro.kernels.ref.mamba_scan_ref`` (the oracle):
h_t = dA_t * h_{t-1} + dBx_t and y_t = sum_n h_t[:, n] * C_t[n], from
h_0 = 0, for dA, dBx (B, S, DI, N) and C (B, S, N), all f32.  Both versions
return y (B, S, DI) and the final carry h_S (B, DI, N): the model keeps the
carry as its SSM state for decoding.

The backward (``csrc/mamba_scan_bwd.cu`` and ``mamba_scan_bwd_ref``) is the
scan's vector-Jacobian product: from dy and an optional seed dh_S it runs
g_t = dy_t C_t + dA_{t+1} g_{t+1} backward and returns d(dA)_t = g_t h_{t-1},
d(dBx)_t = g_t and dC_t = sum_d h_t dy_t.  It has no Pallas counterpart: the
reference differentiates its SSM with jax autodiff through
``associative_scan``.  ``MambaScan`` joins the two kernels for autograd.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

#: state widths the kernels are instantiated for (N lanes share a warp)
STATE_DIMS = (1, 2, 4, 8, 16, 32)

_fn = None
_bwd = None


def mamba_scan_ref(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the recurrence step by step, in f32.  Autograd can run
    through it: the steps are taken with one ``unbind`` and put together with
    one ``stack``, so its backward allocates each gradient once, not once per
    step."""
    B, S, DI, N = dA.shape
    h = torch.zeros((B, DI, N), dtype=torch.float32, device=dA.device)
    ys = []
    for a, bx, c in zip(dA.unbind(1), dBx.unbind(1), C.unbind(1)):
        h = a * h + bx
        ys.append((h * c[:, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) if ys else torch.zeros((B, 0, DI), device=dA.device)
    return y, h


def mamba_scan_bwd_ref(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
                       dy: torch.Tensor, dh: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward: the states forward, then the reverse
    loop step by step, in f32.  Returns (d(dA), d(dBx), dC)."""
    B, S, DI, N = dA.shape
    hs = []
    h = torch.zeros((B, DI, N), dtype=torch.float32, device=dA.device)
    for t in range(S):
        h = dA[:, t] * h + dBx[:, t]
        hs.append(h)
    d_dA, d_dBx = torch.empty_like(dA), torch.empty_like(dBx)
    dC = torch.empty_like(C)
    g = torch.zeros_like(h) if dh is None else dh.float()
    for t in reversed(range(S)):
        g = dy[:, t, :, None] * C[:, t, None, :] + (dA[:, t + 1] * g if t + 1 < S else g)
        d_dBx[:, t] = g
        d_dA[:, t] = g * hs[t - 1] if t > 0 else 0.0
        dC[:, t] = (hs[t] * dy[:, t, :, None]).sum(1)
    return d_dA, d_dBx, dC


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


def _bwd_kernel():
    global _bwd
    if _bwd is None:
        lib = build.load("mamba_scan_bwd")
        for name in ("repro_mamba_scan_bwd_ckpt_floats", "repro_mamba_scan_bwd_part_floats"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_int] * 4
        fn = lib.repro_mamba_scan_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        _bwd = lib
    return _bwd


def mamba_scan_bwd_cuda(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
                        dy: torch.Tensor, dh: Optional[torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on contiguous CUDA tensors the wrapper
    (``ops.mamba_scan_bwd``) has checked; allocates the gradients and the two
    workspaces (checkpoints of h every 16 steps, per-block partial sums of
    dC)."""
    B, S, DI, N = dA.shape
    lib = _bwd_kernel()
    ckpt = torch.empty(lib.repro_mamba_scan_bwd_ckpt_floats(B, S, DI, N),
                       dtype=torch.float32, device=dA.device)
    part = torch.empty(lib.repro_mamba_scan_bwd_part_floats(B, S, DI, N),
                       dtype=torch.float32, device=dA.device)
    d_dA, d_dBx, dC = torch.empty_like(dA), torch.empty_like(dBx), torch.empty_like(C)
    with torch.cuda.device(dA.device):
        err = lib.repro_mamba_scan_bwd(
            dA.data_ptr(), dBx.data_ptr(), C.data_ptr(), dy.data_ptr(),
            None if dh is None else dh.data_ptr(), ckpt.data_ptr(), d_dA.data_ptr(),
            d_dBx.data_ptr(), part.data_ptr(), dC.data_ptr(), B, S, DI, N,
            torch.cuda.current_stream(dA.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan_bwd kernel launch failed: CUDA error {err}")
    return d_dA, d_dBx, dC


class MambaScan(torch.autograd.Function):
    """The scan with its kernels both ways: the forward (``ops.mamba_scan``)
    saves its inputs, the backward calls ``ops.mamba_scan_bwd`` with the
    gradients of y and of the final carry (either may be absent).  Both route
    by device, so on CPU tensors they run the plain versions."""

    @staticmethod
    def forward(ctx, dA, dBx, C):
        from . import ops

        ctx.set_materialize_grads(False)
        y, h = ops.mamba_scan(dA, dBx, C)
        ctx.save_for_backward(dA, dBx, C)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        from . import ops

        dA, dBx, C = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(dA.shape[:3], dtype=torch.float32, device=dA.device)
        return ops.mamba_scan_bwd(dA, dBx, C, dy.contiguous(),
                                  None if dh is None else dh.contiguous())
