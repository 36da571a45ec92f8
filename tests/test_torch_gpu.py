"""The Hopper kernels on the card against their plain PyTorch versions.

Every test here is marked ``gpu`` and skips (from its fixture) where there
is no CUDA device.  The file imports neither jax nor the reference, so it
runs on a machine with the card and PyTorch only:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances, relative to the largest plain value: matmul 1e-4 at f32 and
2e-2 at bf16 (the reference's own kernel-test tolerances), 1e-10 at f64
(another summation order); GLM quantities 1e-6 absolute (f32 values in
[-1, 1]); flash attention 2e-5 at f32 and 3e-2 at bf16, the selective scan
1e-4 (the reference's tolerances for those kernels).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import ArrayContext, ClusterSpec
from repro_torch.kernels import launches, ops, reset_launches
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.glm_fused import glm_fused_ref
from repro_torch.kernels.mamba_scan import mamba_scan_ref
from repro_torch.kernels.matmul import matmul_ref
from repro_torch.launch.workloads import logreg_newton_loop

pytestmark = pytest.mark.gpu

SHAPES = [(128, 128, 128), (256, 128, 384), (384, 256, 128), (100, 96, 60),
          (256, 65536, 256), (4096, 256, 1), (3, 5000, 700)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float64: 1e-10}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _uniform(seed, shape, dev, dtype):
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64],
                         ids=str)
def test_matmul_kernel_vs_plain(cuda_device, m, k, n, dtype):
    a = _uniform(5, (m, k), cuda_device, dtype)
    b = _uniform(6, (k, n), cuda_device, dtype)
    reset_launches()
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    assert launches["matmul"] == 1
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    ref = matmul_ref(a, b)
    scale = max(ref.abs().max().item(), 1.0)
    assert (got.double() - ref.double()).abs().max().item() <= TOL[dtype] * scale


@pytest.mark.parametrize("ta,tb", [(True, False), (False, True), (True, True)])
def test_matmul_kernel_reads_transposed_views(cuda_device, ta, tb):
    a = _uniform(1, (300, 100) if ta else (100, 300), cuda_device, torch.float64)
    b = _uniform(2, (60, 300) if tb else (300, 60), cuda_device, torch.float64)
    A, B = (a.mT if ta else a), (b.mT if tb else b)
    torch.testing.assert_close(ops.matmul(A, B), A @ B, rtol=1e-12, atol=1e-12)


def test_matmul_kernel_is_deterministic(cuda_device):
    x = torch.randn(65536, 256, dtype=torch.float64, device=cuda_device)
    first = ops.matmul(x.mT, x)
    assert all(torch.equal(first, ops.matmul(x.mT, x)) for _ in range(3))


def test_matmul_kernel_rejects_what_it_does_not_take(cuda_device):
    a = torch.zeros(8, 8, device=cuda_device)[::2, ::2]
    with pytest.raises(ValueError, match="unit stride"):
        ops.matmul(a, torch.zeros(4, 4, device=cuda_device))
    with pytest.raises(ValueError, match="empty"):
        ops.matmul(torch.zeros(0, 4, device=cuda_device),
                   torch.zeros(4, 4, device=cuda_device))
    with pytest.raises(ValueError, match="device"):
        ops.matmul(torch.zeros(4, 4, device=cuda_device), torch.zeros(4, 4))


@pytest.mark.parametrize("n,d", [(1 << 22, 1), (131072, 1), (100, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16],
                         ids=str)
def test_glm_fused_kernel_vs_plain(cuda_device, n, d, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    z = (torch.randn(n, d, device=cuda_device, generator=g) * 8).to(dtype)
    y = (torch.rand(n, d, device=cuda_device, generator=g) > 0.5).to(dtype)
    reset_launches()
    got = ops.glm_fused(z, y)
    assert launches["glm_fused"] == 1
    for a, b in zip(got, glm_fused_ref(z, y)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_glm_fused_kernel_rejects_strided_input(cuda_device):
    z = torch.zeros(8, 4, device=cuda_device)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ops.glm_fused(z, z)


def test_newton_step_with_kernels_on_card(cuda_device):
    """One Newton step over row blocks through both kernels (X @ beta and
    the two X^T products on the matmul kernel, mu/c/w on the GLM kernel as
    f32) against the same step in f64 torch.  Errors are relative to the
    sums of the terms' magnitudes and held to 1e-5, the reference's
    tolerance for this check (test_glm_newton_with_kernel)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    Xs = [torch.randn(4096, 32, device=cuda_device, dtype=torch.float64, generator=g)
          for _ in range(4)]
    ys = [(torch.rand(4096, 1, device=cuda_device, generator=g) > 0.5).double()
          for _ in Xs]
    beta = torch.randn(32, 1, device=cuda_device, dtype=torch.float64, generator=g) * 0.1
    reset_launches()
    grad = hess = grad64 = hess64 = scale = 0
    for X, y in zip(Xs, ys):
        z = ops.matmul(X, beta)
        _mu, c, w = ops.glm_fused(z, y)
        grad = grad + ops.matmul(X.mT, c.double())
        hess = hess + ops.matmul(X.mT, w.double() * X)
        mu64 = torch.sigmoid(z)
        grad64 = grad64 + X.mT @ (mu64 - y)
        scale = scale + X.abs().mT @ (mu64 - y).abs()
        hess64 = hess64 + X.mT @ ((mu64 * (1 - mu64)) * X)
    assert dict(launches) == {"matmul": 3 * len(Xs), "glm_fused": len(Xs),
                              "flash_attention": 0, "mamba_scan": 0}
    assert ((grad - grad64).abs().max() / scale.max()).item() < 1e-5
    assert ((hess - hess64).abs().max() / hess64.abs().max()).item() < 1e-5


def test_newton_loop_on_card_matches_torch_backend(cuda_device):
    """A small Newton loop on the card: every 2-D block product launches
    the kernel, and the result equals the torch backend's to 1e-6."""
    out = {}
    for backend in ("cuda", "torch"):
        ctx = ArrayContext(cluster=ClusterSpec(4, 2), node_grid=(4, 1),
                           backend=backend, dtype="float64", seed=0,
                           pipeline=True, plan_cache=True, device="cuda:0")
        reset_launches()
        _g, H, beta = logreg_newton_loop(ctx, 1 << 14, 32, 8, iters=2)
        out[backend] = (beta.to_numpy(), H.to_numpy(), launches["matmul"])
    (b, H, n_kernel), (b_t, H_t, n_torch) = out["cuda"], out["torch"]
    assert n_kernel == 2 * 3 * 8 and n_torch == 0
    for x, y in ((b, b_t), (H, H_t)):
        assert np.abs(x - y).max() <= 1e-6 * np.abs(y).max()


FLASH_CASES = [  # B, H, KV, Sq, Skv, hd, causal, window, q_offset
    (2, 4, 4, 64, 64, 32, True, None, 0),      # MHA
    (2, 8, 2, 64, 64, 32, True, None, 0),      # GQA 4:1
    (2, 4, 1, 128, 64, 64, True, None, 0),     # MQA, longer q
    (2, 4, 2, 32, 128, 128, True, None, 96),   # q shorter than kv
    (1, 4, 2, 128, 128, 16, True, 32, 0),      # sliding window
    (2, 25, 5, 300, 333, 64, True, None, 0),   # hymba heads, ragged cache
    (2, 25, 5, 300, 333, 64, True, 100, 0),    # ... a local layer
    (3, 25, 5, 1, 333, 64, True, None, 300),   # decode, global
    (3, 25, 5, 1, 333, 64, True, 100, 300),    # decode, local
    (2, 6, 3, 40, 40, 32, False, None, 0),     # non-causal, ragged
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_kernel_vs_plain(cuda_device, case, dtype):
    B, H, KV, Sq, Skv, hd, causal, window, q_offset = case
    q = _uniform(1, (B, H, Sq, hd), cuda_device, dtype)
    k = _uniform(2, (B, KV, Skv, hd), cuda_device, dtype)
    v = _uniform(3, (B, KV, Skv, hd), cuda_device, dtype)
    reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    again = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == 2
    assert torch.equal(got, again)
    assert got.dtype == dtype and got.shape == q.shape
    ref = flash_attention_ref(q, k, v, causal, window, q_offset).float()
    err = (got.float() - ref).abs().max().item()
    assert err <= FLASH_TOL[dtype] * ref.abs().max().item()


def test_flash_attention_kernel_reads_model_layout_views(cuda_device):
    """The model hands the kernel transposed views of (B, S, H, hd)
    activations and of a (B, S_max, KV, hd) cache: read in place."""
    qm = _uniform(4, (2, 50, 10, 64), cuda_device, torch.bfloat16)
    cache = _uniform(5, (2, 77, 2, 64), cuda_device, torch.bfloat16)
    q, k = qm.transpose(1, 2), cache.transpose(1, 2)
    got = ops.flash_attention(q, k, k, window=20, q_offset=3)
    ref = flash_attention_ref(q.contiguous(), k.contiguous(), k.contiguous(),
                              True, 20, 3).float()
    assert (got.float() - ref).abs().max().item() <= 3e-2 * ref.abs().max().item()


def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 8, 64, device=cuda_device)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[..., :48], q[..., :48], q[..., :48])
    with pytest.raises(ValueError, match="contiguous head dim"):
        t = torch.zeros(1, 2, 8, 128, device=cuda_device)[..., ::2]
        ops.flash_attention(t, t, t)


SCAN_SHAPES = [(2, 32, 64, 8), (2, 64, 128, 16), (2, 100, 64, 8), (2, 16, 32, 4),
               (3, 77, 50, 16), (1, 65, 40, 32), (2, 9, 7, 1)]


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_mamba_scan_kernel_vs_plain(cuda_device, shape):
    B, S, DI, N = shape
    dA = _uniform(6, shape, cuda_device, torch.float32) * 0.245 + 0.745  # [0.5, 0.99]
    dBx = _uniform(7, shape, cuda_device, torch.float32)
    C = _uniform(8, (B, S, N), cuda_device, torch.float32)
    reset_launches()
    y, h = ops.mamba_scan(dA, dBx, C)
    y2, h2 = ops.mamba_scan(dA, dBx, C)
    torch.cuda.synchronize()
    assert launches["mamba_scan"] == 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    y_ref, h_ref = mamba_scan_ref(dA, dBx, C)
    assert (y - y_ref).abs().max().item() <= 1e-4 * y_ref.abs().max().item()
    assert (h - h_ref).abs().max().item() <= 1e-4 * h_ref.abs().max().item()


def test_hymba_serve_on_card_kernel_route_matches_plain(cuda_device):
    """Reduced hymba at f32, 8 layers (layer 7 global), prompt longer than
    the window: the kernel route's prefill and decode logits match the plain
    route's to 1e-4 of max|logit| with the same greedy tokens, and every
    layer's attention and prefill scan launched its kernel."""
    from repro_torch.launch.serve import serve_demo

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_layers=8)
    rec_k, rec_p = {}, {}
    reset_launches()
    toks = serve_demo(cfg, 2, 40, 6, device="cuda", record=rec_k, log_fn=lambda *a: None)
    assert launches["flash_attention"] == 8 * 6 and launches["mamba_scan"] == 8
    reset_launches()
    plain = serve_demo(cfg, 2, 40, 6, device="cuda", impl="plain", forced=toks,
                       record=rec_p, log_fn=lambda *a: None)
    assert launches["flash_attention"] == launches["mamba_scan"] == 0
    lk, lp = rec_k["logits"], rec_p["logits"]
    assert np.abs(lk - lp).max() <= 1e-4 * np.abs(lp).max()
    assert np.array_equal(toks, plain)
