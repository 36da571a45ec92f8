"""The port's flash-attention backward on the CPU against the reference.

``repro_torch.kernels.flash_attention_bwd.FlashAttention`` (what
``ops.flash_attention`` returns through when an input requires grad) runs
its plain forward and backward versions on CPU tensors.  Its gradients are
held against ``jax.grad`` through the reference's custom_vjp
``flash_attention_vjp`` with the Pallas kernels in interpret mode, on the
four shapes of ``tests/test_kernels.py`` (TestFlashAttentionBackward) and at
head dim 256 (rep 1, 2 and 8, a window, a query offset), at the
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
from repro_torch.kernels.flash_attention import MAX_REP, SMS, flash_attention_ref
from repro_torch.kernels.flash_attention_bwd import (check_launch, dkv_key_tile, dkv_row_step,
                                                     dkv_splits, flash_attention_bwd_ref,
                                                     rows_aligned)

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


HD256 = [  # h, kv, sq, skv, window, q_offset: the dense decoders' head dim
    (2, 2, 64, 64, None, 0),     # rep 1 (gemma-7b)
    (4, 2, 64, 64, None, 0),     # rep 2 (gemma3-4b)
    (8, 1, 32, 32, None, 0),     # rep 8
    (4, 2, 96, 96, 24, 0),       # a local layer's window
    (4, 2, 32, 64, None, 32),    # queries at an offset behind 64 keys
    (4, 2, 32, 64, 16, 32),      # window and offset
]


@pytest.mark.parametrize("h,kv,sq,skv,window,q_offset", HD256, ids=str)
def test_hd256_grads_match_the_pallas_vjp_in_interpret_mode(h, kv, sq, skv, window, q_offset):
    """Head dim 256 (gemma3-4b, gemma-7b): the kernels' hd-256 layout (dK and
    dV split over two warps a key group in bf16, 16-row tiles in f32) has the
    same plain version, held here to the reference's vjp."""
    q, k, v = arr((1, h, sq, 256)), arr((1, kv, skv, 256)), arr((1, kv, skv, 256))

    def ref_loss(q, k, v):
        return jnp.sum(jnp.sin(flash_attention_vjp(q, k, v, True, window, q_offset, 32, 32,
                                                   True)))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _, got = torch_grads(lambda q, k, v: ops.flash_attention(q, k, v, causal=True,
                                                             window=window,
                                                             q_offset=q_offset), q, k, v)
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


@pytest.mark.parametrize("dtype,hd,rep,ok", [
    (torch.bfloat16, 64, 5, True),      # hymba
    (torch.bfloat16, 64, 64, True),     # a dQ block's 64 rows: one position
    (torch.bfloat16, 64, 65, False),
    (torch.bfloat16, 128, 64, True),
    (torch.bfloat16, 16, 65, False),
    (torch.float32, 64, 64, True),      # f32: the same 64 at every head dim
    (torch.float32, 64, 65, False),
    (torch.float32, 128, 33, True),
    (torch.float32, 16, 128, False),
    (torch.bfloat16, 256, 64, True),    # head dim 256: the same 64 rows
    (torch.bfloat16, 256, 65, False),
    (torch.float32, 256, 16, True),
    (torch.float32, 256, 17, True),
    (torch.float32, 256, 64, True),
    (torch.float32, 256, 65, False),
], ids=str)
def test_backward_kernel_limits_raise_with_their_message(dtype, hd, rep, ok):
    """The launch check behind ``ops.flash_attention_bwd`` on a CUDA tensor:
    rep query heads per kv head up to 64 at every head dim and dtype (a
    bf16 dQ block's rows; the f32 dQ block is 64 position-major rows
    whatever rep is, and takes the same)."""
    q = torch.zeros(1, rep, 4, hd, dtype=dtype)
    k = torch.zeros(1, 1, 4, hd, dtype=dtype)
    assert MAX_REP == 64
    if ok:
        check_launch(q, k)
    else:
        with pytest.raises(ValueError, match=f"at most {MAX_REP} at head dim {hd}"):
            check_launch(q, k)


@pytest.mark.parametrize("dtype,shape,want", [
    (torch.float32, (1, 4, 2, 2048, 2048, 256), 1),    # gemma3-4b, batch 1: 256 blocks
    (torch.float32, (4, 5, 5, 2048, 2048, 64), 1),     # hymba's train shape
    (torch.float32, (1, 12, 1, 1500, 1500, 64), 1),    # whisper-small's encoder, batch 1
    (torch.float32, (1, 1, 64, 1024, 1024, 256), 9),   # 32 blocks: ceil(264 / 32) ranges
    (torch.float32, (1, 1, 1, 30, 30, 64), 1),         # one step of rows: nothing to split
    (torch.float32, (2, 2, 4, 64, 70, 16), 4),         # capped by the 4 steps of 64 rows
    (torch.bfloat16, (1, 1, 64, 1024, 1024, 256), 1),  # the bf16 kernels never split
], ids=str)
def test_f32_dkv_blocks_split_their_rows_when_the_grid_is_small(dtype, shape, want):
    """B * KV * key blocks under the card's SMS multiprocessors: each f32
    dK/dV block of keys takes one of ``dkv_splits`` ranges of its query
    rows (about two blocks per multiprocessor, at most one range a step)."""
    B, KV, rep, Sq, Skv, hd = shape
    assert dkv_splits(dtype, B, KV, rep, Sq, Skv, hd) == want
    blocks = B * KV * -(-Skv // dkv_key_tile(hd))
    if want > 1:
        assert blocks < SMS and (blocks * want >= SMS or want == -(-Sq * rep // dkv_row_step(hd)))


def test_bf16_rows_alignment_is_read_from_base_and_strides():
    n = 2 * 50 * 10 * 64
    assert rows_aligned(torch.zeros(2, 50, 10, 64, dtype=torch.bfloat16).transpose(1, 2))
    buf = torch.zeros(n + 8, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    assert rows_aligned(buf[8:].view(2, 50, 10, 64).transpose(1, 2))
    assert not rows_aligned(buf[1:n + 1].view(2, 50, 10, 64).transpose(1, 2))
    assert not rows_aligned(torch.zeros(2, 10, 50, 68, dtype=torch.bfloat16)[..., :64])


def test_backward_kernel_limit_on_query_rows_per_kv_head():
    """A kv head's rows (positions x rep heads) are indexed in int32."""
    k = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16)
    check_launch(torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16).expand(1, 64, 2**25 - 1, 64), k)
    with pytest.raises(ValueError, match="2\\^31 query rows"):
        check_launch(torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16).expand(1, 64, 2**25, 64), k)
