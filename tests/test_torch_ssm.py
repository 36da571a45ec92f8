"""The port's selective scan and SSM block on the CPU against the reference.

``repro_torch.kernels.ops.mamba_scan`` runs its plain version on a CPU
tensor; it is held against ``repro.kernels.ref.mamba_scan_ref`` on the cases
of ``tests/test_kernels.py`` (the ragged S = 100 included) and against the
Pallas kernel in interpret mode.  Its final carry, which the Pallas kernel
never writes, is held against the last step of the reference model's
``ssm_scan``; the plain version, which the model's plain route calls, is held
against that ``ssm_scan`` and its C contraction.  The port's ``ssm_block`` (both routes), with and without a
carried state, is held against the reference's.  The scan's backward
(``ops.mamba_scan_bwd``, and ``MambaScan`` under autograd), seeded or not
by a final-carry gradient, is held against ``jax.grad`` of the reference's
``ssm_scan`` followed by the C contraction, and against torch autograd of
the plain scan.  Tolerance 1e-4, the reference's own.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import mamba_scan as ref_scan_pallas
from repro.kernels.ref import mamba_scan_ref as ref_oracle
from repro.models import ssm as ref_ssm
from repro.models.transformer import _ssm_shapes
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.mamba_scan import mamba_scan_bwd_ref, mamba_scan_ref
from repro_torch.models import ssm

RNG = np.random.default_rng(7)


def arr(shape, lo=-1.0, hi=1.0):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def assert_close(got: torch.Tensor, want, tol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


def scan_inputs(B, S, DI, N):
    return arr((B, S, DI, N), 0.5, 0.99), arr((B, S, DI, N)), arr((B, S, N))


@pytest.mark.parametrize("s,di,n", [(32, 64, 8), (64, 128, 16), (100, 64, 8), (16, 32, 4)])
def test_plain_scan_matches_the_oracle(s, di, n):
    dA, dBx, C = scan_inputs(2, s, di, n)
    y, h = ops.mamba_scan(*map(torch.from_numpy, (dA, dBx, C)))
    assert y.shape == (2, s, di) and h.shape == (2, di, n)
    assert_close(y, ref_oracle(jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(C)))


def test_plain_scan_matches_the_pallas_kernel_in_interpret_mode():
    dA, dBx, C = scan_inputs(2, 100, 64, 8)
    want = ref_scan_pallas(jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(C), bd=32,
                           chunk=16, interpret=True)
    y, _ = ops.mamba_scan(*map(torch.from_numpy, (dA, dBx, C)))
    assert_close(y, want)


@pytest.mark.parametrize("s", [1, 32, 100])
def test_final_carry_is_the_last_state_of_ssm_scan(s):
    dA, dBx, C = scan_inputs(2, s, 16, 8)
    _, h = ops.mamba_scan(*map(torch.from_numpy, (dA, dBx, C)))
    assert_close(h, ref_ssm.ssm_scan(jnp.asarray(dA), jnp.asarray(dBx))[:, -1])


def test_plain_scan_matches_the_reference_ssm_scan():
    dA, dBx, C = scan_inputs(1, 32, 16, 8)
    h = ref_ssm.ssm_scan(jnp.asarray(dA), jnp.asarray(dBx))
    y, h_last = mamba_scan_ref(*map(torch.from_numpy, (dA, dBx, C)))
    assert_close(y, jnp.einsum("bsdn,bsn->bsd", h, jnp.asarray(C)))
    assert_close(h_last, h[:, -1])


@pytest.mark.parametrize("bad,match", [
    (((2, 3, 4, 8), (2, 3, 4, 8), (2, 3, 7)), "C must be"),
    (((2, 3, 4, 8), (2, 3, 4, 4), (2, 3, 8)), "one shape"),
    (((2, 3, 4, 12), (2, 3, 4, 12), (2, 3, 12)), "state width"),
])
def test_wrapper_rejects_bad_shapes(bad, match):
    with pytest.raises(ValueError, match=match):
        ops.mamba_scan(*(torch.zeros(s) for s in bad))
    with pytest.raises(TypeError, match="f32"):
        ops.mamba_scan(*(torch.zeros((1, 2, 3, 4), dtype=torch.float64),) * 2,
                       torch.zeros((1, 2, 4), dtype=torch.float64))


def _block_params(rcfg):
    shapes = _ssm_shapes(rcfg)
    raw = {k: arr(v, -0.3, 0.3) for k, v in sorted(shapes.items())}
    N = rcfg.ssm.d_state
    raw["A_log"] = np.broadcast_to(np.log(np.arange(1, N + 1, dtype=np.float32)),
                                   shapes["A_log"]).copy()
    raw["dt_bias"] = np.full(shapes["dt_bias"], -4.6, np.float32)
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.from_numpy(v) for k, v in raw.items()})


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("S", [1, 24])
def test_ssm_block_matches_reference(impl, carried, S):
    rcfg = ref_get_config("hymba-1.5b").reduced()
    cfg = get_config("hymba-1.5b").reduced()
    pj, pt = _block_params(rcfg)
    B, D = 2, cfg.d_model
    DI, N, K = cfg.ssm.d_inner(D), cfg.ssm.d_state, cfg.ssm.d_conv
    x = arr((B, S, D))
    cache_j = cache_t = None
    if carried:
        conv, state = arr((B, K - 1, DI)), arr((B, DI, N))
        cache_j = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(state)}
        cache_t = {"conv": torch.from_numpy(conv), "ssm": torch.from_numpy(state)}
    want, want_cache = ref_ssm.ssm_block(pj, jnp.asarray(x), rcfg, cache_j)
    got, got_cache = ssm.ssm_block(pt, torch.from_numpy(x), cfg, cache_t, impl=impl)
    assert_close(got, want)
    if carried:
        assert_close(got_cache["conv"], want_cache["conv"])
        assert_close(got_cache["ssm"], want_cache["ssm"])
    else:
        assert got_cache is None


def test_ssm_block_rejects_unknown_impl():
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced())
    _, pt = _block_params(ref_get_config("hymba-1.5b").reduced())
    with pytest.raises(ValueError, match="impl"):
        ssm.ssm_block(pt, torch.zeros(1, 3, cfg.d_model), cfg, impl="fast")


def _ref_scan_grads(dA, dBx, C, dy, dh):
    """jax.grad of sum(y * dy) + sum(h_S * dh) through the reference model's
    scan: h = ssm_scan(dA, dBx), y = einsum(h, C) (models/ssm.py)."""
    def loss(dA, dBx, C):
        h = ref_ssm.ssm_scan(dA, dBx)
        y = jnp.einsum("bsdn,bsn->bsd", h, C)
        out = jnp.sum(y * dy)
        return out if dh is None else out + jnp.sum(h[:, -1] * dh)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*map(jnp.asarray, (dA, dBx, C)))


@pytest.mark.parametrize("seeded", [False, True], ids=["dy", "dy+dh"])
@pytest.mark.parametrize("s,di,n", [(1, 16, 8), (32, 64, 16), (100, 64, 8), (16, 32, 4)])
def test_scan_backward_matches_jax_grad_of_the_reference_scan(s, di, n, seeded):
    dA, dBx, C = scan_inputs(2, s, di, n)
    dy = arr((2, s, di))
    dh = arr((2, di, n)) if seeded else None
    want = _ref_scan_grads(dA, dBx, C, jnp.asarray(dy), None if dh is None else
                           jnp.asarray(dh))
    got = ops.mamba_scan_bwd(*map(torch.from_numpy, (dA, dBx, C, dy)),
                             None if dh is None else torch.from_numpy(dh))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close(g, w)


@pytest.mark.parametrize("seeded", [False, True], ids=["dy", "dy+dh"])
def test_scan_autograd_matches_autograd_of_the_plain_scan(seeded):
    """Through ``MambaScan`` (what ops.mamba_scan returns through when an
    input requires grad) and through torch autograd of ``mamba_scan_ref``:
    the same three gradients, S = 100 ragged against any chunking."""
    dA, dBx, C = scan_inputs(2, 100, 24, 8)
    wy, wh = torch.from_numpy(arr((2, 100, 24))), torch.from_numpy(arr((2, 24, 8)))
    grads = []
    for fn in (ops.mamba_scan, mamba_scan_ref):
        ts = [torch.from_numpy(x).requires_grad_() for x in (dA, dBx, C)]
        y, h = fn(*ts)
        loss = (y * wy).sum() + ((h * wh).sum() if seeded else 0.0)
        grads.append(torch.autograd.grad(loss, ts))
    for g, r in zip(*grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-4, rtol=1e-4)


def test_scan_backward_plain_version_uses_no_division_by_dA():
    """dA that underflows to 0 (exp(dt * A) at a large step) cuts the
    recurrence: the gradients stay finite and the states before the cut get
    no gradient through it."""
    dA, dBx, C = scan_inputs(1, 12, 8, 4)
    dA[:, 6] = 0.0
    dy = arr((1, 12, 8))
    d_dA, d_dBx, dC = mamba_scan_bwd_ref(*map(torch.from_numpy, (dA, dBx, C, dy)))
    assert all(torch.isfinite(t).all() for t in (d_dA, d_dBx, dC))
    want = _ref_scan_grads(dA, dBx, C, jnp.asarray(dy), None)
    for g, w in zip((d_dA, d_dBx, dC), want):
        assert_close(g, w)


@pytest.mark.parametrize("bad,match", [("dy", "dy must be"), ("dh", "dh must be")])
def test_scan_backward_wrapper_rejects_bad_gradients(bad, match):
    dA = torch.zeros(2, 3, 4, 8)
    dy, dh = torch.zeros(2, 3, 4), None
    if bad == "dy":
        dy = torch.zeros(2, 3, 5)
    else:
        dh = torch.zeros(2, 4, 4)
    with pytest.raises(ValueError, match=match):
        ops.mamba_scan_bwd(dA, dA, torch.zeros(2, 3, 8), dy, dh)
