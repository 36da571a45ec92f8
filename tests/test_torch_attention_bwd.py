"""The port's flash-attention backward on the CPU against the reference.

``repro_torch.kernels.flash_attention_bwd.FlashAttention`` (what
``ops.flash_attention`` returns through when an input requires grad) runs
its plain forward and backward versions on CPU tensors.  Its gradients are
held against ``jax.grad`` through the reference's custom_vjp
``flash_attention_vjp`` with the Pallas kernels in interpret mode, on the
four shapes of ``tests/test_kernels.py`` (TestFlashAttentionBackward), at the
reference's atol 2e-5; against torch autograd of the plain forward
``flash_attention_ref`` on ragged lengths, which the Pallas wrapper does not
take (it needs Sq % bq == 0 and Skv % bk == 0; ROADMAP Queue 3 (a)); and the
forward's log-sum-exp against the reference's ``_fwd_with_lse``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention_bwd import _fwd_with_lse, flash_attention_vjp
from repro_torch.kernels import launches, ops, reset_launches
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_ref

RNG = np.random.default_rng(11)
TOL = 2e-5


def arr(shape, lo=-0.5, hi=0.5):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def torch_grads(fn, *xs, weights=None):
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = fn(*ts)
    loss = torch.sin(out.float()).sum() if weights is None else (out * weights).sum()
    return out, torch.autograd.grad(loss, ts)


SHAPES = [  # h, kv, sq, skv, window (tests/test_kernels.py:157-162)
    (4, 4, 64, 64, None),    # MHA causal
    (4, 2, 64, 64, None),    # GQA
    (4, 2, 64, 64, 32),      # GQA + sliding window
    (4, 1, 96, 96, None),    # MQA, 3 q-blocks
]


@pytest.mark.parametrize("h,kv,sq,skv,window", SHAPES)
def test_grads_match_the_pallas_vjp_in_interpret_mode(h, kv, sq, skv, window):
    q, k, v = arr((1, h, sq, 32)), arr((1, kv, skv, 32)), arr((1, kv, skv, 32))

    def ref_loss(q, k, v):
        return jnp.sum(jnp.sin(flash_attention_vjp(q, k, v, True, window, 0, 32, 32, True)))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    reset_launches()
    _, got = torch_grads(lambda q, k, v: ops.flash_attention(q, k, v, causal=True,
                                                             window=window), q, k, v)
    assert launches["flash_attention"] == launches["flash_attention_bwd"] == 0  # CPU
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("h,kv,sq,skv,window", SHAPES)
def test_lse_matches_the_reference_fwd_with_lse(h, kv, sq, skv, window):
    q, k, v = arr((2, h, sq, 32)), arr((2, kv, skv, 32)), arr((2, kv, skv, 32))
    want_out, want_lse = _fwd_with_lse(*map(jnp.asarray, (q, k, v)), True, window, 0,
                                       32, 32, True)
    out, lse = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                                   window=window, return_lse=True)
    assert lse.shape == (2, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=TOL, rtol=TOL)


RAGGED = [  # B, H, KV, Sq, Skv, hd, causal, window, q_offset
    (2, 4, 2, 100, 100, 32, True, None, 0),    # ragged causal (Sq = Skv = 100)
    (2, 25, 5, 100, 100, 64, True, 30, 0),     # hymba heads, a local layer
    (1, 6, 3, 37, 90, 16, True, None, 53),     # q behind a ragged cache
    (1, 4, 1, 40, 40, 128, False, None, 0),    # non-causal, ragged
    (2, 4, 2, 33, 33, 32, False, 8, 0),        # non-causal window
]


@pytest.mark.parametrize("case", RAGGED, ids=str)
def test_grads_match_autograd_of_the_plain_forward(case):
    B, H, KV, Sq, Skv, hd, causal, window, q_offset = case
    q, k, v = arr((B, H, Sq, hd)), arr((B, KV, Skv, hd)), arr((B, KV, Skv, hd))
    w = torch.from_numpy(arr((B, H, Sq, hd), -1, 1))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, got = torch_grads(lambda q, k, v: ops.flash_attention(q, k, v, **kw), q, k, v,
                           weights=w)
    ref_out, want = torch_grads(lambda q, k, v: flash_attention_ref(q, k, v, causal, window,
                                                                    q_offset),
                                q, k, v, weights=w)
    torch.testing.assert_close(out, ref_out, atol=TOL, rtol=TOL)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=TOL, rtol=TOL)


def test_a_row_that_sees_no_key_gets_exactly_zero_gradients():
    """Queries past the last key plus the window see nothing: output 0,
    lse -inf, and their rows of dq exactly 0 (no NaN from exp(s - lse));
    keys only they could see get exactly zero dk and dv."""
    B, H, KV, Sq, Skv, hd, window = 1, 2, 1, 10, 4, 16, 2
    q, k, v = arr((B, H, Sq, hd)), arr((B, KV, Skv, hd)), arr((B, KV, Skv, hd))
    out, lse = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), window=window,
                                   return_lse=True)
    blind = torch.arange(Sq) >= Skv + window - 1  # query i sees keys (i - window, i]
    assert blind.any() and torch.isinf(lse[..., blind]).all()
    assert (out[..., blind, :] == 0).all()
    _, (dq, dk, dv) = torch_grads(lambda q, k, v: ops.flash_attention(q, k, v, window=window),
                                  q, k, v, weights=torch.ones(B, H, Sq, hd))
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))
    assert (dq[..., blind, :] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_backward_returns_each_input_dtype(dtype):
    q, k, v = (torch.from_numpy(arr(s)).to(dtype) for s in
               ((1, 4, 24, 32), (1, 2, 24, 32), (1, 2, 24, 32)))
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    do = torch.ones_like(out)
    dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse, do)
    assert (dq.dtype, dk.dtype, dv.dtype) == (dtype,) * 3
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    ref = flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse,
                                  do.float())
    for g, r in zip((dq, dk, dv), ref):
        torch.testing.assert_close(g.float(), r, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("bad,match", [
    ("lse_shape", "lse must be"),
    ("o_dtype", "must match q"),
    ("window", "window"),
])
def test_backward_wrapper_rejects_what_it_does_not_take(bad, match):
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 1, 8, 16)
    lse = torch.zeros(1, 2, 8)
    o, window = q, None
    if bad == "lse_shape":
        lse = torch.zeros(1, 2, 7)
    elif bad == "o_dtype":
        o = q.double()
    else:
        window = 0
    with pytest.raises(ValueError, match=match):
        ops.flash_attention_bwd(q, k, k, o, lse, q, window=window)
