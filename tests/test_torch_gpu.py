"""The Hopper kernels on the card against their plain PyTorch versions.

Every test here is marked ``gpu`` and skips (from its fixture) where there
is no CUDA device.  The file imports neither jax nor the reference, so it
runs on a machine with the card and PyTorch only:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances, relative to the largest plain value: 1e-4 at f32 and 2e-2 at
bf16 (the reference's own kernel-test tolerances), 1e-10 at f64 (another
summation order); GLM quantities 1e-6 absolute (f32 values in [-1, 1]).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import ArrayContext, ClusterSpec
from repro_torch.kernels import launches, ops, reset_launches
from repro_torch.kernels.glm_fused import glm_fused_ref
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
    assert dict(launches) == {"matmul": 3 * len(Xs), "glm_fused": len(Xs)}
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
