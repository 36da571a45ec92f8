"""The Mamba-1 decode step: ``ops.mamba_conv_step`` and ``ops.mamba_state_step``.

On the CPU: the plain versions update the cache row in place and hand it back,
and compute the step as a float64 formula written out here does; the
wrappers reject what the kernels do not take; a decode step of the stack
copies no conv or SSM state.  On the card (``gpu``; this file imports no jax):
the kernel route's S == 1 ``ssm_block`` against the plain route at the widths
of the three models that decode through it, the cache row written in place
and the other rows of a stacked cache untouched, no (B, DI, N) temporary, and
one ``mamba_step`` launch per Mamba layer of a Jamba decode step.

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_mamba_step.py

Tolerances, relative to the largest plain value.  f32: 1e-4, the selective
scan's; the two routes differ only in summation order.  bf16: the plain route
rounds the conv output, the three RMSNorms, dt's product, bias and softplus,
and the product dt * B * x to bf16 (2**-8 each, a few stacking), the kernels
keep f32 until y: 3e-2 on the block's output, as flash attention's bf16
tolerance, and 1e-2 on the SSM state, which both routes keep in f32 and
where those roundings enter only through dt * B * x and exp(dt * A).  The
conv state is moved, not computed: equal bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.trace import LM_MAMBA
from repro_torch.kernels import launches, ops, reset_launches
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.ssm import ssm_block
from repro_torch.models.transformer import _ssm_shapes

#: the models whose decode runs the step, at their published widths:
#: Jamba (DI 8192, dt_rank 256, N 16, the dt/B/C norms), falcon-mamba-7b
#: (DI 8192, dt_rank 256) and hymba-1.5b (DI 3200, dt_rank 100)
ARCHS = ("jamba2-mini", "falcon-mamba-7b", "hymba-1.5b")
TOL = {torch.float32: {"y": 1e-4, "ssm": 1e-4}, torch.bfloat16: {"y": 3e-2, "ssm": 1e-2}}


def block_params(cfg, dev, dtype, seed=0):
    """One SSM block's leaves, uniform and scaled by 1/sqrt(fan-in) so that
    the activations stay of order 1; A_log = log(1..N), dt_bias near the
    model's -4.6 (dt near 0.01), D = 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in sorted(_ssm_shapes(cfg).items()):
        if name == "A_log":
            v = np.broadcast_to(np.log(np.arange(1, shape[1] + 1)), shape)
        elif name == "dt_bias":
            v = rng.uniform(-5.1, -4.1, shape)
        elif name == "D":
            v = np.ones(shape)
        elif len(shape) == 1:
            v = rng.uniform(-0.3, 0.3, shape)
        else:
            v = rng.uniform(-1.0, 1.0, shape) / np.sqrt(shape[0])
        out[name] = torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev, dtype)
    return out


def uniform(seed, shape, dev, dtype):
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype)


# ---------------------------------------------------------------------------
# CPU: the plain versions and the wrappers
# ---------------------------------------------------------------------------

def small_step(norms, B=3, DI=16, N=4, R=3, K=4, dtype=torch.float32):
    """Inputs of one step at a tiny width, as (conv args, state args)."""
    cfg = dataclasses.replace(get_config("jamba2-mini").reduced(), d_model=DI // 2,
                              ssm_inner_norms=norms)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, d_state=N, dt_rank=R,
                                                           d_conv=K))
    p = block_params(cfg, "cpu", dtype, seed=1)
    x, z = uniform(2, (B, 1, DI), "cpu", dtype), uniform(3, (B, 1, DI), "cpu", dtype)
    conv = uniform(4, (B, K - 1, DI), "cpu", dtype)
    proj = uniform(5, (B, 1, R + 2 * N), "cpu", dtype)
    ssm = uniform(6, (B, DI, N), "cpu", torch.float32)
    norm_leaves = [p[k] for k in ("dt_norm", "b_norm", "c_norm")] if norms else []
    return ((x, conv, p["conv_w"], p["conv_b"]),
            (proj, x, z, ssm, p["dt_proj"], p["dt_bias"], p["A_log"], p["D"], *norm_leaves))


def _rms(v, g, eps):
    return v / np.sqrt((v * v).mean(-1, keepdims=True) + eps) * (1 + g)


@pytest.mark.parametrize("norms", [False, True], ids=["plain-widths", "inner-norms"])
def test_plain_step_updates_the_cache_in_place(norms):
    conv_args, state_args = small_step(norms)
    x, conv, w, b = conv_args
    conv_before = conv.clone()
    out, got = ops.mamba_conv_step(*conv_args)
    assert got is conv
    assert torch.equal(conv, torch.cat([conv_before, x], dim=1)[:, 1:])
    f = {k: t.double().numpy() for k, t in zip("xcwb", (x, conv_before, w, b))}
    pre = (np.concatenate([f["c"], f["x"]], 1) * f["w"][None]).sum(1, keepdims=True) + f["b"]
    np.testing.assert_allclose(out.numpy(), pre / (1 + np.exp(-pre)), rtol=1e-5, atol=1e-5)

    proj, xs, z, ssm, dt_proj, dt_bias, A_log, D, *gs = state_args
    a = {k: t.double().numpy() for k, t in zip(
        ("proj", "x", "z", "h", "W", "bias", "A_log", "D"), state_args[:8])}
    eps, N = 1e-6, ssm.shape[-1]
    R = proj.shape[-1] - 2 * N
    dt, Bm, Cm = a["proj"][..., :R], a["proj"][..., R:R + N], a["proj"][..., R + N:]
    if norms:
        g = [t.double().numpy() for t in gs]
        dt, Bm, Cm = _rms(dt, g[0], eps), _rms(Bm, g[1], eps), _rms(Cm, g[2], eps)
    dt = np.log1p(np.exp(dt @ a["W"] + a["bias"]))[:, 0]            # (B, DI)
    x1 = a["x"][:, 0]
    h = (np.exp(dt[..., None] * -np.exp(a["A_log"])) * a["h"]
         + dt[..., None] * Bm[:, 0, None, :] * x1[..., None])
    z1 = a["z"][:, 0]
    y = ((h * Cm[:, 0, None, :]).sum(-1) + a["D"] * x1) * z1 / (1 + np.exp(-z1))
    ptr = ssm.data_ptr()
    y_got, h_got = ops.mamba_state_step(*state_args, eps=eps)
    assert h_got is ssm and ssm.data_ptr() == ptr
    np.testing.assert_allclose(ssm.numpy(), h, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_got[:, 0].numpy(), y, rtol=1e-5, atol=1e-5)


def _replace(args, i, t):
    return args[:i] + (t,) + args[i + 1:]


@pytest.mark.parametrize("which,bad,error,match", [
    ("conv", lambda a: _replace(a, 0, a[0][:, :, :-1]), ValueError, "do not fit"),
    ("conv", lambda a: _replace(a, 0, torch.cat([a[0]] * 2, 1)), ValueError, r"\(B, 1, DI\)"),
    ("conv", lambda a: _replace(a, 1, torch.zeros(3, 4, 16)), ValueError, "do not fit"),
    ("conv", lambda a: (a[0], torch.zeros(3, 5, 16), torch.zeros(6, 16), a[3]),
     ValueError, "conv width"),
    ("conv", lambda a: _replace(a, 2, a[2].double()), TypeError, "dtypes"),
    ("state", lambda a: _replace(a, 6, a[6][:, :2]), ValueError, "A_log"),
    ("state", lambda a: _replace(a, 0, a[0][:, :, 1:]), ValueError, "dt_proj"),
    ("state", lambda a: _replace(a, 3, torch.zeros(3, 16, 12)), ValueError, "state width"),
    ("state", lambda a: _replace(a, 3, a[3].double()), TypeError, "f32"),
    ("state", lambda a: _replace(a, 4, a[4].bfloat16()), TypeError, "dtypes"),
    ("state", lambda a: a[:-1], ValueError, "together"),
    ("state", lambda a: _replace(a, 8, a[8][:-1]), ValueError, "dt_norm"),
])
def test_wrappers_reject_bad_inputs(which, bad, error, match):
    conv_args, state_args = small_step(norms=True)
    args = bad(conv_args if which == "conv" else state_args)
    with pytest.raises(error, match=match):
        if which == "conv":
            ops.mamba_conv_step(*args)
        else:
            ops.mamba_state_step(*args)


def _inside(event, name):
    while event is not None:
        if event.name == name:
            return True
        event = event.cpu_parent
    return False


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_decode_step_copies_no_state(impl):
    """A decode step's Mamba layers leave their new state in the cache rows
    themselves: no ``copy_`` of a conv or SSM state row outside the layers'
    spans (the stack used to make two a layer)."""
    cfg = get_config("jamba2-mini").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.arange(12).reshape(2, 6) % cfg.vocab
    _, cache = prefill(params, {"tokens": tokens}, cfg, 16, impl=impl)
    rows = {tuple(cache["layers"][k].shape[1:]) for k in ("conv", "ssm")}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        decode_step(params, tokens[:, -1:], cache, cfg, impl=impl)
    copies = [e for e in prof.events() if e.name == "aten::copy_"
              and e.input_shapes and tuple(e.input_shapes[0]) in rows]
    assert copies, "the Mamba layers' own in-place writes were not seen"
    assert not [e for e in copies if not _inside(e, LM_MAMBA)]


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B", [1, 5, 32])
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_step_matches_plain_route(cuda_device, arch, B, dtype):
    cfg = get_config(arch)
    s, dev = cfg.ssm, cuda_device
    DI, N = s.d_inner(cfg.d_model), s.d_state
    p = block_params(cfg, dev, dtype)
    x = uniform(7, (B, 1, cfg.d_model), dev, dtype)
    slot, layers = 1, 3
    first = {"conv": uniform(8, (layers, B, s.d_conv - 1, DI), dev, dtype),
             "ssm": uniform(9, (layers, B, DI, N), dev, torch.float32)}
    caches = {impl: {k: t.clone() for k, t in first.items()} for impl in ("kernel", "plain")}
    for impl in caches:  # builds the kernels, sets up cuBLAS: outside what is measured
        ssm_block(p, x, cfg, {k: t[slot].clone() for k, t in first.items()}, impl=impl)
    ys = {}
    for impl, cache in caches.items():
        row = {k: t[slot] for k, t in cache.items()}
        ptrs = {k: t.data_ptr() for k, t in row.items()}
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ys[impl], new = ssm_block(p, x, cfg, row, impl=impl)
        torch.cuda.synchronize()
        assert all(new[k] is row[k] and new[k].data_ptr() == ptrs[k] for k in row), impl
        if impl == "kernel":
            assert launches["mamba_step"] == 1
            # no (B, DI, N) f32 temporary: the step's own tensors are (B, DI)
            assert torch.cuda.max_memory_allocated(dev) - base < B * DI * N * 4 // 2
        else:
            assert launches["mamba_step"] == 0
        for k, t in cache.items():
            others = [i for i in range(layers) if i != slot]
            assert torch.equal(t[others], first[k][others]), (impl, k)
    kern, plain = caches["kernel"], caches["plain"]
    assert torch.equal(kern["conv"][slot], plain["conv"][slot])
    assert not torch.equal(kern["conv"][slot], first["conv"][slot])
    tol = TOL[dtype]
    for name, got, want in (("y", ys["kernel"], ys["plain"]),
                            ("ssm", kern["ssm"][slot], plain["ssm"][slot])):
        err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
        assert err <= tol[name], (name, err)


@pytest.mark.gpu
def test_jamba_decode_step_launches_once_per_mamba_layer(cuda_device):
    """At the cell's 8 layers (one period: 7 Mamba, 1 attention), reduced
    width: one ``mamba_step`` per Mamba layer a decode step, none in the
    prefill, and the same logits as the plain route to the f32 tolerance."""
    cfg = get_config("jamba2-mini").reduced()
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    tokens = (torch.arange(24, device=cuda_device).reshape(3, 8) * 7) % cfg.vocab
    logits = {}
    for impl in ("kernel", "plain"):
        _, cache = prefill(params, {"tokens": tokens}, cfg, 32, impl=impl)
        reset_launches()
        logits[impl], _ = decode_step(params, tokens[:, -1:], cache, cfg, impl=impl)
        torch.cuda.synchronize()
        want = cfg.layer_count("ssm") if impl == "kernel" else 0
        assert launches["mamba_step"] == want == (7 if impl == "kernel" else 0)
    err = (logits["kernel"] - logits["plain"]).abs().max() / logits["plain"].abs().max()
    assert err.item() <= 1e-4
