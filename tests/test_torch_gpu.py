"""The Hopper kernels on the card against their plain PyTorch versions.

Every test here is marked ``gpu`` and skips (from its fixture) where there
is no CUDA device.  The file imports neither jax nor the reference, so it
runs on a machine with the card and PyTorch only:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances, relative to the largest plain value: matmul 1e-4 at f32 and
2e-2 at bf16 (the reference's own kernel-test tolerances), 1e-10 at f64
(another summation order); GLM quantities 1e-6 absolute (f32 values in
[-1, 1]); flash attention 2e-5 at f32 and 3e-2 at bf16, the selective scan
1e-4 (the reference's tolerances for those kernels), forward and backward.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import ArrayContext, ClusterSpec
from repro_torch.kernels import launches, ops, reset_launches
from repro_torch.kernels.flash_attention import (flash_attention_ref, flash_attention_split_ref,
                                                 kv_splits)
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_ref
from repro_torch.kernels.glm_fused import glm_fused_ref
from repro_torch.kernels.mamba_scan import checkpoint_shape, mamba_scan_bwd_ref, mamba_scan_ref
from repro_torch.kernels.matmul import loaders, matmul_ref, tiles, vector_loads
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
                              "flash_attention": 0, "flash_attention_bwd": 0,
                              "mamba_scan": 0, "mamba_scan_bwd": 0, "mamba_step": 0,
                              "mamba2_step": 0}
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


def _rel_err(got, ref) -> float:
    ref = ref.float()
    return (got.float() - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_lse_and_backward_kernels_vs_plain(cuda_device, case, dtype):
    """The forward's lse and the backward kernels against their plain
    versions on the same inputs (the kernel's own O and lse), and two
    backward launches give the same bits."""
    B, H, KV, Sq, Skv, hd, causal, window, q_offset = case
    q = _uniform(1, (B, H, Sq, hd), cuda_device, dtype)
    k = _uniform(2, (B, KV, Skv, hd), cuda_device, dtype)
    v = _uniform(3, (B, KV, Skv, hd), cuda_device, dtype)
    do = _uniform(4, (B, H, Sq, hd), cuda_device, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    reset_launches()
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    _, lse_ref = flash_attention_ref(q, k, v, causal, window, q_offset, return_lse=True)
    seen = torch.isfinite(lse_ref)
    assert torch.equal(seen, torch.isfinite(lse))
    assert (lse - lse_ref)[seen].abs().max().item() <= 1e-5 * lse_ref[seen].abs().max()
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == 1 and launches["flash_attention_bwd"] == 2
    ref = flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window, q_offset)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, a) and g.dtype == dtype and g.shape == r.shape
        assert _rel_err(g, r) <= FLASH_TOL[dtype], _rel_err(g, r)


def test_flash_attention_autograd_on_card_matches_autograd_of_plain(cuda_device):
    """Through the model's layout (transposed views of (B, S, H, hd)), with
    a ragged length and a window: the Function's gradients against torch
    autograd of the plain forward."""
    qm = _uniform(5, (2, 300, 25, 64), cuda_device, torch.float32).requires_grad_()
    km = _uniform(6, (2, 300, 5, 64), cuda_device, torch.float32).requires_grad_()
    vm = _uniform(7, (2, 300, 5, 64), cuda_device, torch.float32).requires_grad_()
    w = _uniform(8, (2, 25, 300, 64), cuda_device, torch.float32)
    grads = []
    for fn in (ops.flash_attention, None):
        q, k, v = qm.transpose(1, 2), km.transpose(1, 2), vm.transpose(1, 2)
        out = (fn(q, k, v, window=100) if fn is not None
               else flash_attention_ref(q, k, v, True, 100, 0))
        grads.append(torch.autograd.grad((out * w).sum(), (qm, km, vm)))
    for g, r in zip(*grads):
        assert _rel_err(g, r) <= 2e-5


@pytest.mark.parametrize("seeded", [False, True], ids=["dy", "dy+dh"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_mamba_scan_backward_kernel_vs_plain(cuda_device, shape, seeded):
    B, S, DI, N = shape
    dA = _uniform(6, shape, cuda_device, torch.float32) * 0.245 + 0.745
    dBx = _uniform(7, shape, cuda_device, torch.float32)
    C = _uniform(8, (B, S, N), cuda_device, torch.float32)
    dy = _uniform(9, (B, S, DI), cuda_device, torch.float32)
    dh = _uniform(10, (B, DI, N), cuda_device, torch.float32) if seeded else None
    reset_launches()
    got = ops.mamba_scan_bwd(dA, dBx, C, dy, dh)
    again = ops.mamba_scan_bwd(dA, dBx, C, dy, dh)
    torch.cuda.synchronize()
    assert launches["mamba_scan_bwd"] == 2
    for g, a, r in zip(got, again, mamba_scan_bwd_ref(dA, dBx, C, dy, dh)):
        assert torch.equal(g, a)
        assert _rel_err(g, r) <= 1e-4


def test_hymba_train_step_on_card_launches_every_kernel(cuda_device):
    """One reduced train step on the card with full remat: per layer the
    attention and scan forwards launch twice (forward and recompute), their
    backwards once; the gradients match the plain route's to 1e-4 and two
    backward passes give the same bits."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import batch_to
    from repro_torch.models import init_params
    from repro_torch.sharding.plans import SINGLE_CARD
    from repro_torch.train import DataConfig, TokenPipeline, make_grad_fn
    from repro_torch.models.transformer import _leaves

    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_layers=8)
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    batch = batch_to(next(TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=40,
                                                   global_batch=2))), cuda_device)
    runs = {}
    for impl in ("kernel", "plain"):
        reset_launches()
        runs[impl] = make_grad_fn(cfg, SINGLE_CARD, compute_dtype="float32",
                                  impl=impl)(params, batch)
        torch.cuda.synchronize()
        if impl == "kernel":
            assert {k: launches[k] for k in ("flash_attention", "flash_attention_bwd",
                                             "mamba_scan", "mamba_scan_bwd")} == {
                "flash_attention": 16, "flash_attention_bwd": 8, "mamba_scan": 16,
                "mamba_scan_bwd": 8}
        else:
            assert sum(launches.values()) == 0
    again = make_grad_fn(cfg, SINGLE_CARD, compute_dtype="float32")(params, batch)
    assert abs(runs["kernel"][0].item() - runs["plain"][0].item()) <= 1e-4
    for (path, g), (_, r), (_, a) in zip(_leaves(runs["kernel"][2]),
                                         _leaves(runs["plain"][2]),
                                         _leaves(again[2])):
        assert torch.equal(g, a), path
        assert _rel_err(g, r) <= 1e-4, path


# ---------------------------------------------------------------------------
# the redesigned kernels: matmul on the FP64 tensor cores and the streaming
# skinny path, and the bf16 attention backward on the tensor cores
# ---------------------------------------------------------------------------

RAGGED_MM = [(1200, 64, 64), (64, 1200, 64), (1200, 64, 1), (64, 1200, 1), (100, 96, 60),
             (100, 96, 5), (1200, 64, 12)]


def _np_product(a, b):
    return a.double().cpu().numpy() @ b.double().cpu().numpy()


@pytest.mark.parametrize("m,k,n", RAGGED_MM, ids=str)
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["nn", "tn", "nt", "tt"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_matmul_kernel_both_orientations_ragged_vs_numpy(cuda_device, m, k, n, ta, tb, dtype):
    """Either unit-stride axis of either operand (a transposed view read in
    place), ragged edges, the vector loader (TMA for f64 with N > 8); f64
    against numpy at 1e-10."""
    a = _uniform(11, (k, m) if ta else (m, k), cuda_device, dtype)
    b = _uniform(12, (n, k) if tb else (k, n), cuda_device, dtype)
    A, B = (a.mT if ta else a), (b.mT if tb else b)
    reset_launches()
    got = ops.matmul(A, B)
    torch.cuda.synchronize()
    want_loader = "tma" if dtype == torch.float64 and n > 8 else "vector"
    assert launches["matmul"] == 1
    assert loaders == {name: int(name == want_loader) for name in loaders}
    want = _np_product(A, B)
    err = np.abs(got.double().cpu().numpy() - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("n", [1, 60, 100], ids=["skinny", "wide", "wide-n100"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_matmul_kernel_misaligned_view_takes_the_scalar_loader(cuda_device, n, dtype):
    """An operand 8 (or 4) bytes past an aligned base: the same kernels copy
    element by element, and the product is still right (at n = 100 in f64
    the view read along m takes the 128 x 128 tile, along k the 128 x 64)."""
    buf = _uniform(13, (1200 * 96 + 1,), cuda_device, dtype)
    for A in (buf[1:].view(1200, 96), buf[1:].view(96, 1200).mT):
        B = _uniform(14, (96, n), cuda_device, dtype)
        reset_launches()
        got = ops.matmul(A, B)
        torch.cuda.synchronize()
        assert loaders == {"vector": 0, "scalar": 1, "tma": 0}
        want = _np_product(A, B)
        assert np.abs(got.double().cpu().numpy() - want).max() <= TOL[dtype] * np.abs(want).max()


#: (m, k, n).  (4096, 1000, 4160): an odd count of N tiles in both block
#: tiles (65 of 64, 33 of 128) and K not a multiple of BK (32); (256, 40002,
#: 136): 3 and 2 N tiles, K split into chunks (44 of 928 in the 128 x 64
#: tile, 33 of 1216 in the 128 x 128), the last ragged
F64_TILE_SHAPES = [(4096, 4096, 4096), (1024, 1024, 1024), (1000, 1000, 1000),
                   (4100, 4099, 4097), (4096, 1000, 4160), (256, 40002, 136)]


@pytest.mark.parametrize("m,k,n", F64_TILE_SHAPES, ids=str)
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["nn", "tn", "nt", "tt"])
def test_f64_block_tiles_vs_numpy_in_every_orientation(cuda_device, m, k, n, ta, tb):
    """dmma_kernel's two block tiles, taken by shape and orientation (128 x
    128 where A is read along m, else 128 x 64): numpy's product to 1e-10,
    the same bits on three more launches, each launch counted under the tile
    and the loader that ran it.  Aligned operands fill the ring by TMA, and
    give the bits of the element loader on the same values 8 bytes past an
    aligned base; odd leading strides (4099, 4097) take the element loader."""
    a = _uniform(21, (k, m) if ta else (m, k), cuda_device, torch.float64)
    b = _uniform(22, (n, k) if tb else (k, n), cuda_device, torch.float64)
    A, B = (a.mT if ta else a), (b.mT if tb else b)
    vec = vector_loads(A, B)
    reset_launches()
    got = ops.matmul(A, B)
    torch.cuda.synchronize()
    want_tile = "128x128" if ta else "128x64"
    want_loader = "tma" if vec else "scalar"
    assert tiles == {name: int(name == want_tile) for name in tiles}
    assert loaders == {name: int(name == want_loader) for name in loaders}
    assert vec == ((m if ta else k) % 2 == 0 and (k if tb else n) % 2 == 0)
    assert all(torch.equal(got, ops.matmul(A, B)) for _ in range(3))
    assert loaders == {name: 4 * int(name == want_loader) for name in loaders}
    if vec:
        buf = torch.empty(a.numel() + 1, dtype=torch.float64, device=cuda_device)
        a_odd = buf[1:].view(a.shape)
        a_odd.copy_(a)
        reset_launches()
        assert torch.equal(got, ops.matmul(a_odd.mT if ta else a_odd, B))
        assert loaders == {name: int(name == "scalar") for name in loaders}
    want = _np_product(A, B)
    err = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-10, err


@pytest.mark.parametrize("shape", [(256, 131072, 256), (256, 131072, 1), (131072, 256, 1)],
                         ids=str)
def test_matmul_kernel_split_k_is_deterministic_f64(cuda_device, shape):
    """The Newton products (split-K, a fixed summation order): the same bits
    on every launch, and numpy's product to 1e-10."""
    m, k, n = shape
    x = torch.randn(max(m, k), min(m, k), dtype=torch.float64, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(3))
    A = x.mT if m < k else x
    B = torch.randn(k, n, dtype=torch.float64, device=cuda_device)
    first = ops.matmul(A, B)
    assert all(torch.equal(first, ops.matmul(A, B)) for _ in range(3))
    want = _np_product(A, B)
    assert np.abs(first.cpu().numpy() - want).max() <= 1e-10 * np.abs(want).max()


BWD_BF16_CASES = [  # B, H, KV, Sq, Skv, hd, causal, window, q_offset
    (2, 5, 5, 77, 77, 64, True, None, 0),       # rep 1, ragged
    (2, 25, 5, 333, 333, 64, True, None, 0),    # rep 5 (hymba), ragged
    (2, 25, 5, 300, 300, 64, True, 100, 0),     # ... a local layer
    (1, 10, 2, 130, 201, 16, True, None, 71),   # q behind the cache, each head dim
    (1, 10, 2, 130, 201, 32, True, None, 71),
    (1, 10, 2, 130, 201, 64, True, None, 71),
    (1, 10, 2, 130, 201, 128, True, None, 71),
    (1, 10, 2, 50, 177, 32, True, 40, 127),     # window and q_offset
    (1, 64, 1, 40, 40, 64, True, None, 0),      # rep 64: the bf16 limit
    (1, 4, 2, 45, 70, 128, False, None, 0),     # non-causal, ragged
]


@pytest.mark.parametrize("case", BWD_BF16_CASES, ids=str)
def test_flash_attention_bwd_bf16_tensor_core_kernels_vs_plain(cuda_device, case):
    B, H, KV, Sq, Skv, hd, causal, window, q_offset = case
    dtype = torch.bfloat16
    q = _uniform(21, (B, H, Sq, hd), cuda_device, dtype)
    k = _uniform(22, (B, KV, Skv, hd), cuda_device, dtype)
    v = _uniform(23, (B, KV, Skv, hd), cuda_device, dtype)
    do = _uniform(24, (B, H, Sq, hd), cuda_device, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    reset_launches()
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert launches["flash_attention_bwd"] == 2
    ref = flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window, q_offset)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, a) and g.dtype == dtype and g.shape == r.shape
        assert _rel_err(g, r) <= FLASH_TOL[dtype], _rel_err(g, r)


def test_flash_attention_bwd_bf16_misaligned_view_and_limits(cuda_device):
    """A q 2 bytes past an aligned base is copied aligned and still right;
    65 query heads per kv head are refused with the limit in the message."""
    dtype = torch.bfloat16
    buf = _uniform(25, (2 * 10 * 60 * 64 + 1,), cuda_device, dtype)
    q = buf[1:].view(2, 10, 60, 64)
    k = _uniform(26, (2, 2, 60, 64), cuda_device, dtype)
    v = _uniform(27, (2, 2, 60, 64), cuda_device, dtype)
    do = _uniform(28, (2, 10, 60, 64), cuda_device, dtype)
    out, lse = ops.flash_attention(q.contiguous(), k, v, return_lse=True)
    got = ops.flash_attention_bwd(q, k, v, out, lse, do)
    ref = flash_attention_bwd_ref(q, k, v, out, lse, do)
    for g, r in zip(got, ref):
        assert _rel_err(g, r) <= FLASH_TOL[dtype]
    q65 = torch.zeros(1, 65, 8, 64, device=cuda_device, dtype=dtype)
    kv = torch.zeros(1, 1, 8, 64, device=cuda_device, dtype=dtype)
    lse65 = torch.zeros(1, 65, 8, device=cuda_device)
    with pytest.raises(ValueError, match="at most 64 at head dim 64"):
        ops.flash_attention_bwd(q65, kv, kv, q65, lse65, q65)


# ---------------------------------------------------------------------------
# the redesigned forward kernels: bf16 attention on the tensor cores, split-KV
# decode, and the scan's checkpoints handed from the forward to the backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 1024], ids=["global", "local"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_split_kv_decode_at_hymba_serve_shapes(cuda_device, dtype, window):
    """One query at 2048 over a 2081 cache, B 8, 25 / 5 heads: more than one
    key range; the output and lse against the plain one-pass and split
    versions, and two launches give the same bits."""
    B, H, KV, hd, Skv, pos = 8, 25, 5, 64, 2081, 2048
    assert kv_splits(B, KV, H // KV, 1, Skv, hd, True, window, pos) > 1
    q = _uniform(31, (B, H, 1, hd), cuda_device, dtype)
    k = _uniform(32, (B, KV, Skv, hd), cuda_device, dtype)
    v = _uniform(33, (B, KV, Skv, hd), cuda_device, dtype)
    kw = dict(causal=True, window=window, q_offset=pos)
    reset_launches()
    got, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    again, lse2 = ops.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == 2
    assert torch.equal(got, again) and torch.equal(lse, lse2)
    for plain in (flash_attention_ref, flash_attention_split_ref):
        ref, lse_ref = plain(q, k, v, True, window, pos, return_lse=True)
        assert _rel_err(got, ref) <= FLASH_TOL[dtype]
        assert (lse - lse_ref).abs().max().item() <= 1e-5 * lse_ref.abs().max().item()


def test_flash_attention_bf16_forward_misaligned_view(cuda_device):
    """A bf16 q 2 bytes past an aligned base is copied aligned and still right."""
    buf = _uniform(34, (2 * 10 * 60 * 64 + 1,), cuda_device, torch.bfloat16)
    q = buf[1:].view(2, 10, 60, 64)
    k = _uniform(35, (2, 2, 60, 64), cuda_device, torch.bfloat16)
    got = ops.flash_attention(q, k, k, window=17)
    assert _rel_err(got, flash_attention_ref(q, k, k, True, 17, 0)) <= FLASH_TOL[torch.bfloat16]


@pytest.mark.parametrize("shape", [(2, 300, 64, 16), (2, 77, 50, 16), (1, 65, 40, 32)],
                         ids=str)
def test_mamba_scan_backward_from_the_forward_checkpoints_is_bitwise(cuda_device, shape):
    """The forward writes checkpoints without changing y or the carry; the
    backward given them skips its own forward pass and gives the same bits
    as without them."""
    B, S, DI, N = shape
    dA = _uniform(6, shape, cuda_device, torch.float32) * 0.245 + 0.745
    dBx = _uniform(7, shape, cuda_device, torch.float32)
    C = _uniform(8, (B, S, N), cuda_device, torch.float32)
    dy = _uniform(9, (B, S, DI), cuda_device, torch.float32)
    dh = _uniform(10, (B, DI, N), cuda_device, torch.float32)
    reset_launches()
    y, h = ops.mamba_scan(dA, dBx, C)
    y2, h2, ck = ops.mamba_scan(dA, dBx, C, checkpoints=True)
    assert ck.shape == checkpoint_shape(B, S, DI, N)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    _, _, ck_ref = mamba_scan_ref(dA, dBx, C, checkpoints=True)
    assert _rel_err(ck, ck_ref) <= 1e-4
    for seed in (None, dh):
        without = ops.mamba_scan_bwd(dA, dBx, C, dy, seed)
        with_ck = ops.mamba_scan_bwd(dA, dBx, C, dy, seed, checkpoints=ck)
        for a, b in zip(without, with_ck):
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert launches["mamba_scan"] == 2 and launches["mamba_scan_bwd"] == 4


def _block_ctx(backend, node_grid=(4, 1), **kw):
    return ArrayContext(cluster=ClusterSpec(4, 2), node_grid=node_grid, backend=backend,
                        dtype="float64", seed=0, device="cuda:0", **kw)


def test_cp_als_on_card_matches_torch_backend_and_mirror(cuda_device):
    """Two CP-ALS sweeps on the card: every MTTKRP and Gram product launches
    the matmul kernel, the factors equal the torch backend's to 1e-8 and the
    numpy mirror's to 1e-8, and both backends schedule alike."""
    from repro_torch.factor import cp_als, cp_als_reference

    Xn = np.random.default_rng(7).standard_normal((32, 24, 16))
    out = {}
    for backend in ("cuda", "torch"):
        ctx = _block_ctx(backend, (4, 1, 1), plan_cache=True, pipeline=True)
        reset_launches()
        res = cp_als(ctx.from_numpy(Xn, grid=(4, 1, 1)), rank=3, iters=2, seed=1)
        out[backend] = ([f.to_numpy() for f in res.factors], launches["matmul"],
                        res.moved_elements)
    (fs, n_kernel, moved), (fs_t, n_torch, moved_t) = out["cuda"], out["torch"]
    # per sweep and mode: 4 MTTKRP row blocks and 2 Grams
    assert n_kernel == 2 * 3 * (4 + 2) and n_torch == 0
    assert moved == moved_t > 0
    for f, f_t, m in zip(fs, fs_t, cp_als_reference(Xn, rank=3, iters=2, seed=1)):
        np.testing.assert_allclose(f, f_t, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(f, m, rtol=1e-8, atol=1e-8)


def test_tsqr_on_card_matches_torch_backend(cuda_device):
    """Indirect TSQR on the card: Q R = X and Q^T Q = I to the chip run's
    limits, the same comm ratio as on backend torch."""
    from repro_torch.linalg import tsqr_indirect

    out = {}
    for backend in ("cuda", "torch"):
        ctx = _block_ctx(backend)
        X = ctx.random((1 << 14, 64), grid=(8, 1))
        Q, R = tsqr_indirect(ctx, X)
        out[backend] = (X.to_numpy(), Q.to_numpy(), R.to_numpy(),
                        ctx.loads()["comm_ratio_tsqr"])
    (X, Q, R, ratio), (_, Q_t, _, ratio_t) = out["cuda"], out["torch"]
    assert np.linalg.norm(Q @ R - X) / np.linalg.norm(X) <= 1e-12
    assert np.abs(Q.T @ Q - np.eye(64)).max() <= 1e-10
    np.testing.assert_allclose(Q, Q_t, rtol=0, atol=1e-10)
    assert ratio == ratio_t


def _newton_on_card(ctx, n=1 << 14, d=64, q=8):
    _g, H, beta = logreg_newton_loop(ctx, n, d, q, iters=2, reset_loads=False)
    ctx.flush()
    return beta.to_numpy(), H.to_numpy()


def _chaos_newton(chaos_plan, device="cuda:0"):
    ctx = ArrayContext(cluster=ClusterSpec(4, 2), node_grid=(4, 1), backend="cuda",
                       dtype="float64", seed=0, device=device, pipeline=True, trace=True)
    eng = ctx.enable_chaos(chaos_plan, seed=3)
    reset_launches()
    return ctx, eng, _newton_on_card(ctx), launches["matmul"]


def test_chaos_node_death_replays_bitwise_on_card(cuda_device):
    """Node 3 dies halfway through the drain, with a straggler and transient
    faults, on the card: lineage replays (products among them) and re-routed
    ops give the fault-free run's bits, and every execution of a 2-D
    product, each replay included, launches the matmul kernel once (the
    trace counts executions and replays)."""
    from repro_torch.core import ChaosPlan

    _c, clean, ref, _n = _chaos_newton(ChaosPlan())
    plan = ChaosPlan(node_failures={3: 0.5 * clean.makespan()}, stragglers={1: 4.0},
                     transient_fault_prob=0.05)
    ctx, eng, got, n_launch = _chaos_newton(plan)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, ref))
    assert eng.dead == {3} and eng.stats.blocks_replayed > 0
    ex = ctx.executor
    runs = [e for e in ctx.tracer.of("retire", "replay") if e.name == "matmul"
            and all(len(ex.shapes[ex.resolve(i)]) == 2
                    for i in ex.lineage[e.args["out"]].in_ids)]
    assert any(e.kind == "replay" for e in runs)
    assert n_launch == len(runs)


def test_traced_run_is_bit_and_clock_neutral_on_card(cuda_device):
    """The flight recorder on the card changes no bits and no simulated
    clocks; every executed op carries its host wall."""
    plain_ctx = _block_ctx("cuda", pipeline=True)
    plain = _newton_on_card(plain_ctx)
    ctx = _block_ctx("cuda", pipeline=True, trace=True)
    traced = _newton_on_card(ctx)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(traced, plain))
    for pipeline in (False, True):
        assert ctx.state.makespan(pipeline=pipeline) == plain_ctx.state.makespan(
            pipeline=pipeline)
    retired = ctx.tracer.of("retire")
    assert retired and all(e.args["wall_s"] > 0.0 for e in retired)


def test_device_class_names_the_card(cuda_device):
    from repro_torch.launch.mesh import device_class, device_inventory

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    assert device_class("cuda") == f"cuda:cuda ({name}) x{count}"
    assert device_class("torch", "cuda:0") == f"torch:cuda ({name}) x1"
    assert [d["device_kind"] for d in device_inventory()][0] == name


# ---------------------------------------------------------------------------
# per-row query offsets (continuous batching) in the attention forward
# ---------------------------------------------------------------------------

RAGGED_CASES = [  # B, H, KV, Sq, Skv, hd, window, offsets
    # decode at the serve_batched shapes: split-KV, offsets crossing the window
    (8, 25, 5, 1, 4096, 64, None, (0, 63, 1023, 1024, 2047, 2500, 3071, 4095)),
    (8, 25, 5, 1, 4096, 64, 1024, (0, 63, 1023, 1024, 2047, 2500, 3071, 4095)),
    # row 3 sees no key (its window starts past the cache's end)
    (4, 25, 5, 1, 333, 64, 100, (0, 100, 332, 500)),
    # prefill of three rows at their own offsets
    (3, 25, 5, 70, 333, 64, None, (0, 100, 263)),
    (3, 25, 5, 70, 333, 64, 100, (0, 100, 263)),
]


@pytest.mark.parametrize("case", RAGGED_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_per_row_offsets_vs_plain(cuda_device, case, dtype):
    """Each batch row at its own offset: output and lse against the plain
    one-pass and per-row split versions; two launches give the same bits."""
    B, H, KV, Sq, Skv, hd, window, offsets = case
    q = _uniform(41, (B, H, Sq, hd), cuda_device, dtype)
    k = _uniform(42, (B, KV, Skv, hd), cuda_device, dtype)
    v = _uniform(43, (B, KV, Skv, hd), cuda_device, dtype)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda_device)
    kw = dict(causal=True, window=window, q_offset=off, max_offset=max(offsets),
              return_lse=True)
    reset_launches()
    got, lse = ops.flash_attention(q, k, v, **kw)
    again, lse2 = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == 2
    assert torch.equal(got, again) and torch.equal(lse, lse2)
    kw.pop("max_offset")
    for plain in (flash_attention_ref, flash_attention_split_ref):
        ref, lse_ref = plain(q, k, v, **kw)
        assert _rel_err(got, ref) <= FLASH_TOL[dtype]
        finite = torch.isfinite(lse_ref)
        assert torch.equal(finite, torch.isfinite(lse))
        assert (lse - lse_ref)[finite].abs().max().item() <= \
            1e-5 * lse_ref[finite].abs().max().item()
    if window == 100 and Sq == 1:  # the row that sees no key gives 0
        assert not got[3].float().abs().any()


@pytest.mark.parametrize("case", [RAGGED_CASES[1], RAGGED_CASES[4]], ids=["decode", "prefill"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_equal_per_row_offsets_give_the_scalar_bits(cuda_device, case, dtype):
    B, H, KV, Sq, Skv, hd, window, _ = case
    q = _uniform(44, (B, H, Sq, hd), cuda_device, dtype)
    k = _uniform(45, (B, KV, Skv, hd), cuda_device, dtype)
    pos = Skv - Sq
    scalar = ops.flash_attention(q, k, k, window=window, q_offset=pos)
    off = torch.full((B,), pos, dtype=torch.int32, device=cuda_device)
    per_row = ops.flash_attention(q, k, k, window=window, q_offset=off, max_offset=pos)
    assert torch.equal(per_row, scalar)


def test_flash_attention_per_row_offsets_need_the_host_max(cuda_device):
    q = torch.zeros(2, 4, 1, 64, device=cuda_device)
    off = torch.tensor([3, 9], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="max_offset"):
        ops.flash_attention(q, q, q, q_offset=off)
    with pytest.raises(ValueError, match="per-row q_offset"):
        ops.flash_attention(q, q, q, q_offset=off.cpu(), max_offset=9)


def test_batched_decode_step_does_not_sync_in_the_attention_wrapper(cuda_device):
    """A per-row decode step's attention calls neither read the offsets back
    nor synchronise: under sync debug mode "error" the wrapper raises
    nothing."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models import layers

    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_layers=8)
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    _, cache = prefill(params, {"tokens": torch.zeros(3, 30, dtype=torch.long,
                                                      device=cuda_device)}, cfg, 64)
    cache["pos"] = (30, 12, 7)
    calls = []
    flash = ops.flash_attention

    def strict(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = flash(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append(kw["max_offset"])
        return out

    layers.ops.flash_attention = strict
    try:
        logits, cache = decode_step(params, torch.zeros(3, 1, dtype=torch.long,
                                                        device=cuda_device), cache, cfg)
    finally:
        layers.ops.flash_attention = flash
    torch.cuda.synchronize()
    assert calls == [30] * 8 and cache["pos"] == (31, 13, 8)
    assert torch.isfinite(logits).all()


def test_continuous_batcher_on_card_equals_standalone_decode(cuda_device):
    """Reduced hymba at f32, 8 layers (layer 7 global), 5 ragged requests
    through 2 slots: every request's tokens equal its own B = 1 prefill and
    decode on the card, logits to 1e-4 of max|logit|, and every layer's
    attention (admissions and decode steps) and prefill scan launched its
    kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve import ContinuousBatcher

    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_layers=8)
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 21, 13, 30, 40)]
    record = {}
    b = ContinuousBatcher(cfg, params, max_slots=2, max_len=64, record=record)
    rids = [b.submit(p, max_new=6) for p in prompts]
    reset_launches()
    out = b.run()
    steps = len(record["steps"])
    assert launches["flash_attention"] == 8 * (len(prompts) + steps)
    assert launches["mamba_scan"] == 8 * len(prompts)
    for rid, p in zip(rids, prompts):
        logits, cache = prefill(params, {"tokens": torch.as_tensor(p[None], device=cuda_device)},
                                cfg, 64)
        rows = [logits[0, -1]]
        for _ in range(5):
            lg, cache = decode_step(params, torch.argmax(rows[-1])[None, None], cache, cfg)
            rows.append(lg[0, -1])
        want = torch.stack(rows).cpu().numpy()
        assert out[rid] == want.argmax(-1).tolist(), rid
        assert np.abs(record["logits"][rid] - want).max() <= 1e-4 * np.abs(want).max()


# ---------------------------------------------------------------------------
# head dim 256 (gemma3-4b, gemma-7b) and the dense decoders' rep 6/7/8
# ---------------------------------------------------------------------------

HD256_CASES = [  # B, H, KV, Sq, Skv, hd, window, q_offset
    (2, 8, 4, 300, 333, 256, None, 0),      # gemma3-4b heads (rep 2), ragged cache
    (2, 8, 4, 300, 333, 256, 100, 0),       # ... a local layer
    (2, 4, 4, 64, 64, 256, None, 0),        # gemma-7b's rep 1
    (1, 12, 2, 77, 120, 256, None, 43),     # rep 6, queries at an offset
    (1, 14, 2, 50, 50, 256, 16, 0),         # rep 7, a window
    (2, 16, 2, 40, 100, 256, None, 60),     # rep 8
    (3, 8, 4, 1, 2065, 256, None, 2048),    # decode: split-KV
    (3, 8, 4, 1, 2065, 256, 1024, 2048),    # decode, local
    (2, 16, 2, 1, 500, 256, None, 499),     # decode, rep 8
    (2, 64, 8, 1, 2065, 128, None, 2048),   # command-r-35b's decode (rep 8, hd 128)
    (1, 28, 4, 70, 100, 128, None, 30),     # qwen2-vl-7b's rep 7 at hd 128
    (1, 48, 8, 33, 33, 128, None, 0),       # nemotron-4-15b's rep 6 at hd 128
]


@pytest.mark.parametrize("case", HD256_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_dense_decoder_shapes_vs_plain(cuda_device, case, dtype):
    """Output and lse against the plain one-pass and split versions; two
    launches give the same bits."""
    B, H, KV, Sq, Skv, hd, window, pos = case
    q = _uniform(51, (B, H, Sq, hd), cuda_device, dtype)
    k = _uniform(52, (B, KV, Skv, hd), cuda_device, dtype)
    v = _uniform(53, (B, KV, Skv, hd), cuda_device, dtype)
    kw = dict(causal=True, window=window, q_offset=pos)
    reset_launches()
    got, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    again, lse2 = ops.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == 2
    assert torch.equal(got, again) and torch.equal(lse, lse2)
    assert got.dtype == dtype and got.shape == q.shape
    if Sq == 1:
        assert kv_splits(B, KV, H // KV, Sq, Skv, hd, True, window, pos) > 1
    for plain in (flash_attention_ref, flash_attention_split_ref):
        ref, lse_ref = plain(q, k, v, True, window, pos, return_lse=True)
        assert _rel_err(got, ref) <= FLASH_TOL[dtype], _rel_err(got, ref)
        assert (lse - lse_ref).abs().max().item() <= 1e-5 * lse_ref.abs().max().item()


@pytest.mark.parametrize("window", [None, 100], ids=["global", "local"])
@pytest.mark.parametrize("sq,offsets", [(1, (0, 100, 700, 1023)), (70, (0, 100, 263, 900))],
                         ids=["decode", "prefill"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_hd256_per_row_offsets_vs_plain(cuda_device, dtype, sq, offsets,
                                                        window):
    B, H, KV, hd, Skv = 4, 8, 4, 256, 1024
    q = _uniform(54, (B, H, sq, hd), cuda_device, dtype)
    k = _uniform(55, (B, KV, Skv, hd), cuda_device, dtype)
    v = _uniform(56, (B, KV, Skv, hd), cuda_device, dtype)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda_device)
    kw = dict(causal=True, window=window, q_offset=off)
    got, lse = ops.flash_attention(q, k, v, max_offset=max(offsets), return_lse=True, **kw)
    torch.cuda.synchronize()
    for plain in (flash_attention_ref, flash_attention_split_ref):
        ref, lse_ref = plain(q, k, v, return_lse=True, **kw)
        assert _rel_err(got, ref) <= FLASH_TOL[dtype]
        finite = torch.isfinite(lse_ref)
        assert torch.equal(finite, torch.isfinite(lse))
        assert (lse - lse_ref)[finite].abs().max().item() <= \
            1e-5 * lse_ref[finite].abs().max().item()


def test_flash_attention_hd256_f32_refuses_more_heads_than_a_block_has_rows(cuda_device):
    """A block has 64 rows: f32 now takes 33 query heads per kv head at head
    dim 256 (the old scalar kernel refused them) and matches the plain
    version both ways; 65 are refused, forward and backward, in f32 and
    bf16, with the limit in the message."""
    dtype = torch.float32
    q = _uniform(65, (1, 33, 40, 256), cuda_device, dtype)
    k = _uniform(66, (1, 1, 40, 256), cuda_device, dtype)
    v = _uniform(67, (1, 1, 40, 256), cuda_device, dtype)
    do = _uniform(68, (1, 33, 40, 256), cuda_device, dtype)
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    assert _rel_err(out, flash_attention_ref(q, k, v)) <= FLASH_TOL[dtype]
    got = ops.flash_attention_bwd(q, k, v, out, lse, do)
    for g, r in zip(got, flash_attention_bwd_ref(q, k, v, out, lse, do)):
        assert _rel_err(g, r) <= FLASH_TOL[dtype], _rel_err(g, r)
    for dt in (torch.float32, torch.bfloat16):
        q65 = torch.zeros(1, 65, 4, 256, device=cuda_device, dtype=dt)
        kv = torch.zeros(1, 1, 4, 256, device=cuda_device, dtype=dt)
        with pytest.raises(ValueError, match="at most 64 at head dim 256"):
            ops.flash_attention(q65, kv, kv)
        with pytest.raises(ValueError, match="at most 64 at head dim 256"):
            ops.flash_attention_bwd(q65, kv, kv, q65, torch.zeros(1, 65, 4, device=cuda_device),
                                    q65)


BWD_HD256_CASES = [  # B, H, KV, Sq, Skv, causal, window, q_offset at head dim 256
    (2, 8, 4, 512, 512, True, None, 0),        # gemma3-4b global (rep 2)
    (1, 8, 4, 1300, 1300, True, 1024, 0),      # gemma3-4b local (window 1024)
    (1, 16, 16, 300, 300, True, None, 0),      # gemma-7b (rep 1)
    (1, 8, 4, 130, 201, True, None, 71),       # queries at an offset, ragged
    (1, 4, 2, 45, 70, False, None, 0),         # non-causal, ragged
]


@pytest.mark.parametrize("case", BWD_HD256_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_backward_at_hd256_on_the_card_vs_plain(cuda_device, case, dtype):
    """The hd-256 backward kernels (bf16: dK and dV split over two warps a
    key group; f32: 16-row tiles) against the plain backward on the
    forward kernel's own O and lse; two launches give the same bits."""
    B, H, KV, Sq, Skv, causal, window, q_offset = case
    q = _uniform(57, (B, H, Sq, 256), cuda_device, dtype)
    k = _uniform(58, (B, KV, Skv, 256), cuda_device, dtype)
    v = _uniform(59, (B, KV, Skv, 256), cuda_device, dtype)
    do = _uniform(60, (B, H, Sq, 256), cuda_device, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    reset_launches()
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert launches["flash_attention_bwd"] == 2
    ref = flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window, q_offset)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, a) and g.dtype == dtype and g.shape == r.shape
        assert _rel_err(g, r) <= FLASH_TOL[dtype], _rel_err(g, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_autograd_at_hd256_on_the_card(cuda_device, dtype):
    """Through the model's layout at head dim 256 with a window: the
    Function's backward launches the kernel and matches torch autograd of
    the plain forward."""
    qm = _uniform(61, (2, 200, 8, 256), cuda_device, dtype).requires_grad_()
    km = _uniform(62, (2, 200, 4, 256), cuda_device, dtype).requires_grad_()
    vm = _uniform(63, (2, 200, 4, 256), cuda_device, dtype).requires_grad_()
    w = _uniform(64, (2, 8, 200, 256), cuda_device, torch.float32)
    reset_launches()
    out = ops.flash_attention(qm.transpose(1, 2), km.transpose(1, 2), vm.transpose(1, 2),
                              window=64)
    got = torch.autograd.grad((out.float() * w).sum(), (qm, km, vm))
    torch.cuda.synchronize()
    assert launches["flash_attention"] == launches["flash_attention_bwd"] == 1
    ref_out = flash_attention_ref(qm.transpose(1, 2).float(), km.transpose(1, 2).float(),
                                  vm.transpose(1, 2).float(), True, 64, 0)
    want = torch.autograd.grad((ref_out * w).sum(), (qm, km, vm))
    for g, r in zip(got, want):
        assert g.dtype == dtype and _rel_err(g, r) <= FLASH_TOL[dtype], _rel_err(g, r)


WHISPER_CASES = [  # B, H, Sq, Skv: whisper-small's heads (12, rep 1, hd 64), no mask
    (2, 12, 1500, 1500),   # the encoder over 30 s of frames (1500 % 64 != 0)
    (8, 12, 4, 1500),      # cross-attention at prefill (a 4-token prompt)
    (8, 12, 1, 1500),      # cross-attention at decode: split-KV
]


@pytest.mark.parametrize("case", WHISPER_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_non_causal_whisper_shapes_vs_plain(cuda_device, case, dtype):
    B, H, Sq, Skv = case
    q = _uniform(65, (B, H, Sq, 64), cuda_device, dtype)
    k = _uniform(66, (B, H, Skv, 64), cuda_device, dtype)
    v = _uniform(67, (B, H, Skv, 64), cuda_device, dtype)
    reset_launches()
    got, lse = ops.flash_attention(q, k, v, causal=False, return_lse=True)
    again = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == 2 and torch.equal(got, again)
    if Sq == 1:
        assert kv_splits(B, H, 1, Sq, Skv, 64, False, None, 0) > 1
    for plain in (flash_attention_ref, flash_attention_split_ref):
        ref, lse_ref = plain(q, k, v, False, None, 0, return_lse=True)
        assert _rel_err(got, ref) <= FLASH_TOL[dtype], _rel_err(got, ref)
        assert (lse - lse_ref).abs().max().item() <= 1e-5 * lse_ref.abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_serve_on_card_kernel_route_matches_plain(cuda_device, dtype):
    """Reduced whisper-small (2 + 2 layers) with 200 frames through prefill
    and decode steps: per prefill 2 encoder + 2 self + 2 cross launches, per
    decode step 2 self + 2 cross; the plain route, teacher-forced, gives the
    same logits (1e-4 of max|logit| at f32, 0.1 at bf16)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    cfg = dataclasses.replace(get_config("whisper-small").reduced(), dtype=dtype)
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    for tree in (params, params["encoder"]):
        tree["final_norm"]["scale"] = torch.ones_like(tree["final_norm"]["scale"])
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((2, 200, cfg.d_model))).to(
        cuda_device, getattr(torch, dtype))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 4))).to(cuda_device)
    runs, forced = {}, None
    for impl in ("kernel", "plain"):
        reset_launches()
        logits, cache = prefill(params, {"frames": frames, "tokens": tokens}, cfg, 12,
                                impl=impl)
        steps, counts = [logits[:, -1].float()], [launches["flash_attention"]]
        for i in range(5):
            tok = forced[:, i:i + 1] if forced is not None else \
                torch.argmax(steps[-1], -1)[:, None]
            reset_launches()
            logits, cache = decode_step(params, tok, cache, cfg, impl=impl)
            steps.append(logits[:, -1].float())
            counts.append(launches["flash_attention"])
        torch.cuda.synchronize()
        runs[impl] = (torch.stack(steps), counts)
        if forced is None:
            forced = torch.stack([torch.argmax(s, -1) for s in steps[:-1]], 1)
    assert runs["kernel"][1] == [6] + [4] * 5 and runs["plain"][1] == [0] * 6
    lk, lp = runs["kernel"][0], runs["plain"][0]
    tol = 1e-4 if dtype == "float32" else 0.1
    assert torch.isfinite(lk).all() and (lk - lp).abs().max() <= tol * lp.abs().max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_serve_at_hd256_on_card_kernel_route_matches_plain(cuda_device, dtype):
    """Reduced gemma3-4b with head dim 256 and 6 layers (layer 5 global),
    prompt longer than its window: every layer's attention launched the
    kernel, and the plain route, teacher-forced with the kernel route's
    tokens, gives the same logits (1e-4 of max|logit| at f32, 0.1 at bf16,
    chip_smoke.py's serve tolerances)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_demo

    cfg = dataclasses.replace(get_config("gemma3-4b").reduced(), n_layers=6, head_dim=256,
                              dtype=dtype)
    rec_k, rec_p = {}, {}
    reset_launches()
    toks = serve_demo(cfg, 2, 40, 6, device="cuda", record=rec_k, log_fn=lambda *a: None)
    assert launches["flash_attention"] == 6 * 6 and launches["mamba_scan"] == 0
    reset_launches()
    serve_demo(cfg, 2, 40, 6, device="cuda", impl="plain", forced=toks, record=rec_p,
               log_fn=lambda *a: None)
    assert launches["flash_attention"] == 0
    lk, lp = rec_k["logits"], rec_p["logits"]
    tol = 1e-4 if dtype == "float32" else 0.1
    assert np.isfinite(lk).all() and np.abs(lk - lp).max() <= tol * np.abs(lp).max()


WHISPER_BWD_CASES = [  # B, Sq, Skv, causal: whisper-small's 12 heads, rep 1, hd 64
    (2, 1500, 1500, False),   # the encoder over 1500 frames (ragged to the key tile)
    (2, 448, 1500, False),    # cross-attention: 448 target positions over the frames
    (2, 448, 448, True),      # the decoder's self-attention
]


@pytest.mark.parametrize("case", WHISPER_BWD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_backward_at_whisper_training_shapes_vs_plain(cuda_device, case,
                                                                      dtype):
    """The backward kernels at whisper-small's training shapes, each run
    twice (bitwise equal), against the plain backward."""
    B, Sq, Skv, causal = case
    q = _uniform(71, (B, 12, Sq, 64), cuda_device, dtype)
    k = _uniform(72, (B, 12, Skv, 64), cuda_device, dtype)
    v = _uniform(73, (B, 12, Skv, 64), cuda_device, dtype)
    do = _uniform(74, (B, 12, Sq, 64), cuda_device, dtype)
    out, lse = ops.flash_attention(q, k, v, causal=causal, return_lse=True)
    reset_launches()
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert launches["flash_attention_bwd"] == 2
    ref = flash_attention_bwd_ref(q, k, v, out, lse, do, causal, None, 0)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, a) and g.dtype == dtype and g.shape == r.shape
        assert _rel_err(g, r) <= FLASH_TOL[dtype], _rel_err(g, r)


@pytest.mark.parametrize("sq,q_offset", [(300, 33), (1, 332)], ids=["prefill", "decode"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_rep16_hd128_qwen3_moe_shapes_vs_plain(cuda_device, sq, q_offset,
                                                               dtype):
    """qwen3-moe-235b-a22b's heads: 64 query heads over 4 kv heads (rep 16)
    at head dim 128, a prefill behind a cache and a decode step."""
    q = _uniform(81, (2, 64, sq, 128), cuda_device, dtype)
    k = _uniform(82, (2, 4, 333, 128), cuda_device, dtype)
    v = _uniform(83, (2, 4, 333, 128), cuda_device, dtype)
    reset_launches()
    got = ops.flash_attention(q, k, v, q_offset=q_offset)
    again = ops.flash_attention(q, k, v, q_offset=q_offset)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == 2 and torch.equal(got, again)
    ref = flash_attention_ref(q, k, v, True, None, q_offset)
    assert _rel_err(got, ref) <= FLASH_TOL[dtype], _rel_err(got, ref)


def _moe_setup(dev, dtype, B=2, S=1100):
    """A wider MoE than reduced()'s (16 experts, top 4) on qwen3-moe's
    reduced config; weights and input from numpy."""
    from repro_torch.configs import get_config
    from repro_torch.models import MoEConfig

    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                              moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=96))
    D, E, F = cfg.d_model, 16, 96
    rng = np.random.default_rng(31)
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "w_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    params = {k: torch.from_numpy(v).to(dev, dtype) for k, v in p.items()}
    x = torch.from_numpy(rng.standard_normal((B, S, D))).to(dev, dtype)
    return cfg, params, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_moe_block_on_card_einsum_matches_gather_and_gather_is_bitwise(cuda_device, dtype):
    """moe_block on the card: N = 2200 tokens (the group size halves from
    2048 to 8), drops at capacity 1.25; "gather" (a scatter on the
    card) run twice gives the same bits, and agrees with "einsum" (1e-5 of
    max|out| at f32, 2e-2 at bf16: another summation order) and, at f32,
    with the same block on the CPU (1e-4)."""
    from repro_torch.models.moe import moe_block

    cfg, params, x = _moe_setup(cuda_device, dtype)
    gather, aux = moe_block(params, x, cfg, dispatch_mode="gather")
    again, aux2 = moe_block(params, x, cfg, dispatch_mode="gather")
    einsum, aux3 = moe_block(params, x, cfg, dispatch_mode="einsum")
    torch.cuda.synchronize()
    assert torch.equal(gather, again) and torch.equal(aux, aux2)
    assert torch.isfinite(gather).all() and aux.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert _rel_err(gather, einsum) <= tol, _rel_err(gather, einsum)
    assert (aux - aux3).abs().item() <= 1e-6 * aux3.abs().item()
    if dtype == torch.float32:
        cpu, cpu_aux = moe_block({k: v.cpu() for k, v in params.items()}, x.cpu(), cfg)
        assert _rel_err(einsum.cpu(), cpu) <= 1e-4
        assert (aux3.cpu() - cpu_aux).abs().item() <= 1e-4 * cpu_aux.abs().item()


def test_moe_serve_on_card_kernel_route_matches_plain(cuda_device):
    """Reduced qwen3-moe-235b-a22b in f32 through serve_demo in both dispatch
    modes: every layer's attention launched the kernel, the plain route,
    teacher-forced, gives the same logits (1e-4 of max|logit|), and gather
    gives einsum's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_demo

    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    recs, toks = {}, {}
    for impl, mode in (("kernel", "einsum"), ("plain", "einsum"), ("kernel", "gather")):
        rec = recs[impl, mode] = {}
        reset_launches()
        toks[impl, mode] = serve_demo(cfg, 2, 40, 6, device="cuda", impl=impl,
                                      dispatch_mode=mode, record=rec,
                                      forced=toks.get(("kernel", "einsum")),
                                      log_fn=lambda *a: None)
        assert launches["flash_attention"] == (cfg.n_layers * 6 if impl == "kernel" else 0)
    lk, lp = recs["kernel", "einsum"]["logits"], recs["plain", "einsum"]["logits"]
    assert np.isfinite(lk).all() and np.abs(lk - lp).max() <= 1e-4 * np.abs(lp).max()
    assert np.array_equal(toks["kernel", "gather"], toks["kernel", "einsum"])


# ---------------------------------------------------------------------------
# SPMD sharding: the sharded step on a 1 x 1 CUDA mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_world(cuda_device):
    """A process group of one rank on the card (NCCL), destroyed after."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=cuda_device)
    try:
        yield cuda_device
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["gemma3-4b", "hymba-1.5b"])
def test_sharded_step_on_1x1_cuda_mesh_equals_plain(cuda_world, arch):
    """A reduced gradient step under fsdp+tp on the host mesh (1 x 1, NCCL):
    parameters and batch as DTensors, the attention (and scan) kernels
    launched on the local shards as often as on plain tensors, the loss and
    every gradient bitwise equal to the same step on plain tensors."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import batch_to
    from repro_torch.models import init_params
    from repro_torch.models.partitioning import spec_placements
    from repro_torch.models.transformer import _leaves
    from repro_torch.sharding import Plan, activation_rules, batch_specs, shard_tree
    from repro_torch.train import DataConfig, TokenPipeline, make_grad_fn

    cfg = get_config(arch).reduced()
    if arch == "gemma3-4b":
        cfg = dataclasses.replace(cfg, n_layers=6, head_dim=256, dtype="bfloat16")
    mesh = make_host_mesh()
    plan = Plan("fsdp_tp", batch_axes=("data",), tp_axis="model", fsdp_axis=("data",),
                remat="dots")
    params = init_params(dataclasses.replace(cfg, dtype="float32"),
                         torch.Generator(device=cuda_world).manual_seed(0))
    batch = batch_to(next(TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=40,
                                                   global_batch=2))), cuda_world)
    kernels = ("flash_attention", "flash_attention_bwd", "mamba_scan", "mamba_scan_bwd")
    reset_launches()
    loss, _, grads = make_grad_fn(cfg, plan)(params, batch)
    want = {k: launches[k] for k in kernels}
    specs = batch_specs(cfg, plan, "train")
    sbatch = {k: distribute_tensor(v, mesh, spec_placements(mesh, specs[k]))
              for k, v in batch.items()}
    reset_launches()
    sloss, _, sgrads = make_grad_fn(cfg, plan, activation_rules(plan, mesh, cfg))(
        shard_tree(params, cfg, plan, mesh), sbatch)
    torch.cuda.synchronize()
    assert {k: launches[k] for k in kernels} == want and want["flash_attention"] > 0
    assert (want["mamba_scan"] > 0) == (cfg.ssm is not None)
    assert torch.equal(sloss, loss)
    for (path, g), (_, s) in zip(_leaves(grads), _leaves(sgrads)):
        assert torch.equal(s.to_local(), g), path


def test_host_mesh_on_the_card(cuda_world):
    from repro_torch.launch.mesh import make_host_mesh, mesh_axis_sizes

    mesh = make_host_mesh(device_type="cuda")
    assert mesh.device_type == "cuda" and mesh_axis_sizes(mesh) == {"data": 1, "model": 1}


# ---------------------------------------------------------------------------
# the redesigned f32 kernels: register micro-tiles of IEEE FMA, 64
# position-major rows a block, up to 64 query heads per kv head
# ---------------------------------------------------------------------------

F32_CASES = [  # B, H, KV, Sq, Skv, hd, causal, window, q_offset
    (2, 4, 4, 77, 77, 16, True, None, 0),        # rep 1, ragged
    (1, 64, 1, 33, 47, 16, True, None, 14),      # rep 64 at hd 16, an offset
    (1, 8, 4, 100, 130, 32, True, 40, 30),       # rep 2, a window and an offset
    (1, 10, 5, 200, 250, 32, False, None, 0),    # rep 2, no mask, ragged
    (2, 25, 5, 333, 333, 64, True, None, 0),     # rep 5 (hymba), ragged
    (1, 25, 5, 300, 300, 64, True, 100, 0),      # ... a local layer
    (2, 12, 12, 150, 150, 64, False, None, 0),   # rep 1, no mask (whisper)
    (1, 64, 1, 50, 50, 64, True, 16, 0),         # rep 64, a window
    (1, 32, 2, 70, 120, 128, True, None, 50),    # rep 16 at hd 128, an offset
    (1, 66, 2, 30, 90, 128, True, None, 60),     # rep 33 at hd 128
    (1, 8, 4, 300, 333, 256, True, 100, 33),     # rep 2 at hd 256 (gemma3-4b), a window
    (1, 33, 1, 65, 65, 256, True, None, 0),      # rep 33 at hd 256
    (1, 64, 1, 40, 72, 256, False, None, 0),     # rep 64 at hd 256, no mask
    (4, 16, 16, 600, 600, 64, True, None, 0),    # grids that fill the card: dK/dV
    (2, 8, 4, 700, 700, 256, True, None, 0),     # blocks take no query split
]


@pytest.mark.parametrize("case", F32_CASES, ids=str)
def test_flash_attention_f32_micro_tile_kernels_vs_plain(cuda_device, case):
    """Forward (output and lse) and backward against the plain versions at
    FLASH_TOL; two launches of each give the same bits.  Small grids split
    each dK/dV block's query rows (``dkv_splits`` > 1), the last two cases
    do not."""
    B, H, KV, Sq, Skv, hd, causal, window, q_offset = case
    dtype = torch.float32
    q = _uniform(71, (B, H, Sq, hd), cuda_device, dtype)
    k = _uniform(72, (B, KV, Skv, hd), cuda_device, dtype)
    v = _uniform(73, (B, KV, Skv, hd), cuda_device, dtype)
    do = _uniform(74, (B, H, Sq, hd), cuda_device, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    reset_launches()
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    out2, lse2 = ops.flash_attention(q, k, v, return_lse=True, **kw)
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == 2 and launches["flash_attention_bwd"] == 2
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref, lse_ref = flash_attention_ref(q, k, v, causal, window, q_offset, return_lse=True)
    assert _rel_err(out, ref) <= FLASH_TOL[dtype], _rel_err(out, ref)
    finite = torch.isfinite(lse_ref)
    assert torch.equal(finite, torch.isfinite(lse))
    assert (lse - lse_ref)[finite].abs().max().item() <= 1e-5 * lse_ref[finite].abs().max()
    for g, a, r in zip(got, again, flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                                           window, q_offset)):
        assert torch.equal(g, a) and g.shape == r.shape
        assert _rel_err(g, r) <= FLASH_TOL[dtype], _rel_err(g, r)


@pytest.mark.parametrize("case", [
    (3, 66, 2, 2065, 256, None, 2048),   # rep 33 at hd 256
    (4, 25, 5, 2081, 64, 1024, 2048),    # hymba's local layer
    (2, 64, 4, 1500, 128, None, 1400),   # rep 16 at hd 128
    (2, 64, 1, 500, 32, None, 499),      # rep 64 at hd 32
], ids=str)
def test_flash_attention_f32_split_kv_decode_with_lse(cuda_device, case):
    """One query over a long cache: more than one key range; output and lse
    against the plain one-pass and split versions, bitwise on repeat."""
    B, H, KV, Skv, hd, window, pos = case
    dtype = torch.float32
    assert kv_splits(B, KV, H // KV, 1, Skv, hd, True, window, pos) > 1
    q = _uniform(75, (B, H, 1, hd), cuda_device, dtype)
    k = _uniform(76, (B, KV, Skv, hd), cuda_device, dtype)
    v = _uniform(77, (B, KV, Skv, hd), cuda_device, dtype)
    kw = dict(causal=True, window=window, q_offset=pos)
    got, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    again, lse2 = ops.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(lse, lse2)
    for plain in (flash_attention_ref, flash_attention_split_ref):
        ref, lse_ref = plain(q, k, v, True, window, pos, return_lse=True)
        assert _rel_err(got, ref) <= FLASH_TOL[dtype]
        assert (lse - lse_ref).abs().max().item() <= 1e-5 * lse_ref.abs().max().item()


@pytest.mark.parametrize("window", [None, 64], ids=["global", "local"])
@pytest.mark.parametrize("sq", [1, 37], ids=["decode", "prefill"])
def test_flash_attention_f32_per_row_offsets_at_rep_64(cuda_device, sq, window):
    """Continuous batching's per-row offsets with 64 query heads over one kv
    head at hd 128: against the plain one-pass and split versions."""
    B, H, KV, hd, Skv, offsets = 4, 64, 1, 128, 600, (0, 90, 311, 560)
    q = _uniform(78, (B, H, sq, hd), cuda_device, torch.float32)
    k = _uniform(79, (B, KV, Skv, hd), cuda_device, torch.float32)
    v = _uniform(80, (B, KV, Skv, hd), cuda_device, torch.float32)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda_device)
    kw = dict(causal=True, window=window, q_offset=off)
    got, lse = ops.flash_attention(q, k, v, max_offset=max(offsets), return_lse=True, **kw)
    again = ops.flash_attention(q, k, v, max_offset=max(offsets), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for plain in (flash_attention_ref, flash_attention_split_ref):
        ref, lse_ref = plain(q, k, v, return_lse=True, **kw)
        assert _rel_err(got, ref) <= FLASH_TOL[torch.float32]
        finite = torch.isfinite(lse_ref)
        assert torch.equal(finite, torch.isfinite(lse))
        assert (lse - lse_ref)[finite].abs().max().item() <= \
            1e-5 * lse_ref[finite].abs().max().item()


@pytest.mark.parametrize("hd", [64, 256])
def test_flash_attention_f32_reads_model_layout_and_misaligned_views(cuda_device, hd):
    """Transposed views of (B, S, H, hd) activations are read in place both
    ways (through the autograd Function), and a q 4 bytes past an aligned
    base is copied aligned; all against the plain versions."""
    B, S, H, KV = 2, 90, 16, 4
    qm = _uniform(81, (B, S, H, hd), cuda_device, torch.float32).requires_grad_()
    km = _uniform(82, (B, S, KV, hd), cuda_device, torch.float32).requires_grad_()
    vm = _uniform(83, (B, S, KV, hd), cuda_device, torch.float32).requires_grad_()
    w = _uniform(84, (B, H, S, hd), cuda_device, torch.float32)
    reset_launches()
    out = ops.flash_attention(qm.transpose(1, 2), km.transpose(1, 2), vm.transpose(1, 2),
                              window=40, q_offset=5)
    got = torch.autograd.grad((out * w).sum(), (qm, km, vm))
    torch.cuda.synchronize()
    assert launches["flash_attention"] == launches["flash_attention_bwd"] == 1
    ref = flash_attention_ref(qm.transpose(1, 2), km.transpose(1, 2), vm.transpose(1, 2),
                              True, 40, 5)
    want = torch.autograd.grad((ref * w).sum(), (qm, km, vm))
    assert _rel_err(out, ref) <= FLASH_TOL[torch.float32]
    for g, r in zip(got, want):
        assert _rel_err(g, r) <= FLASH_TOL[torch.float32], _rel_err(g, r)
    buf = _uniform(85, (B * H * S * hd + 1,), cuda_device, torch.float32)
    q = buf[1:].view(B, H, S, hd)
    k, v = km.detach().transpose(1, 2), vm.detach().transpose(1, 2)
    do = w
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    assert _rel_err(o, flash_attention_ref(q, k, v)) <= FLASH_TOL[torch.float32]
    for g, r in zip(ops.flash_attention_bwd(q, k, v, o, lse, do),
                    flash_attention_bwd_ref(q, k, v, o, lse, do)):
        assert _rel_err(g, r) <= FLASH_TOL[torch.float32], _rel_err(g, r)
