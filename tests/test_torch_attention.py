"""The port's flash attention and model attention on the CPU against the
reference.

The wrapper ``repro_torch.kernels.ops.flash_attention`` runs its plain
version on a CPU tensor; it is held against the reference's oracle
``repro.kernels.ref.flash_attention_ref`` on the cases of
``tests/test_kernels.py`` (GQA, MQA, q_offset, windows, bf16), plus a
ragged non-causal case, which the reference's Pallas wrapper gets wrong
(ROADMAP Queue 3 (a)), so it is held against the oracle only.  The port's
``attention_scores`` (both routes) is held against the reference's model
attention with the causal and the windowed decode masks.  Tolerance 2e-5 at
f32 and 3e-2 at bf16, the reference's own.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import flash_attention as ref_flash_pallas
from repro.kernels.ref import flash_attention_ref as ref_oracle
from repro.models import layers as ref_layers
from repro_torch.configs import get_config
from repro_torch.kernels import launches, ops
from repro_torch.models import layers
from repro_torch.models.layers import CausalMask

RNG = np.random.default_rng(42)


def arr(shape, lo=-1.0, hi=1.0):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def both(x, dtype="float32"):
    """The same numbers as a jax array and a torch CPU tensor."""
    j = jnp.asarray(x, jnp.dtype(dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))
    return j, t


def assert_close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("sq,skv,h,kv,hd", [
    (64, 64, 4, 4, 32),     # MHA
    (64, 64, 8, 2, 32),     # GQA 4:1
    (128, 64, 4, 1, 64),    # MQA, longer q
    (32, 128, 4, 2, 128),   # decode-ish: q shorter than kv
])
def test_causal_gqa(sq, skv, h, kv, hd):
    (qj, q), (kj, k), (vj, v) = (both(arr(s)) for s in
                                 ((2, h, sq, hd), (2, kv, skv, hd), (2, kv, skv, hd)))
    off = max(skv - sq, 0)
    got = ops.flash_attention(q, k, v, causal=True, q_offset=off)
    assert_close(got, ref_oracle(qj, kj, vj, causal=True, q_offset=off), 2e-5)


@pytest.mark.parametrize("window", [16, 32, 64])
def test_sliding_window(window):
    (qj, q), (kj, k), (vj, v) = (both(arr(s)) for s in
                                 ((1, 4, 128, 32), (1, 2, 128, 32), (1, 2, 128, 32)))
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    assert_close(got, ref_oracle(qj, kj, vj, causal=True, window=window), 2e-5)


def test_bf16():
    (qj, q), (kj, k), (vj, v) = (both(arr((1, 4, 64, 32)), "bfloat16") for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    assert_close(got, ref_oracle(qj, kj, vj, causal=True), 3e-2)


def test_ragged_non_causal_against_the_oracle():
    """Sq = Skv = 40 is no multiple of the reference wrapper's 32-key tile;
    its padded keys leak into the non-causal softmax (ROADMAP Queue 3 (a)).
    The port masks keys >= Skv, so it agrees with the oracle."""
    (qj, q), (kj, k), (vj, v) = (both(arr(s)) for s in
                                 ((2, 6, 40, 32), (2, 3, 40, 32), (2, 3, 40, 32)))
    got = ops.flash_attention(q, k, v, causal=False)
    assert_close(got, ref_oracle(qj, kj, vj, causal=False), 2e-5)


def test_causal_case_matches_the_pallas_kernel_in_interpret_mode():
    (qj, q), (kj, k), (vj, v) = (both(arr(s)) for s in
                                 ((2, 8, 64, 32), (2, 2, 96, 32), (2, 2, 96, 32)))
    want = ref_flash_pallas(qj, kj, vj, causal=True, window=24, q_offset=32, bq=32, bk=32,
                            interpret=True)
    got = ops.flash_attention(q, k, v, causal=True, window=24, q_offset=32)
    assert_close(got, want, 2e-5)


def test_cpu_tensors_launch_no_kernel():
    q = torch.zeros(1, 2, 4, 16)
    before = dict(launches)
    ops.flash_attention(q, q, q)
    assert launches == before


@pytest.mark.parametrize("bad,exc,match", [
    (dict(window=0), ValueError, "window"),
    (dict(window=-3), ValueError, "window"),
    (dict(q_offset=-1), ValueError, "q_offset"),
])
def test_wrapper_rejects_bad_masks(bad, exc, match):
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(exc, match=match):
        ops.flash_attention(q, q, q, **bad)


def test_wrapper_rejects_head_dims_and_dtypes_the_kernel_lacks():
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(*(torch.zeros(1, 2, 4, 48),) * 3)
    with pytest.raises(TypeError, match="dtypes"):
        ops.flash_attention(*(torch.zeros(1, 2, 4, 16, dtype=torch.float64),) * 3)
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.flash_attention(torch.zeros(1, 3, 4, 16), torch.zeros(1, 2, 4, 16),
                            torch.zeros(1, 2, 4, 16))


# ---------------------------------------------------------------------------
# the model's attention
# ---------------------------------------------------------------------------


def _qkv(B, Sq, Skv, H, KV, hd):
    return [both(arr(s)) for s in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))]


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("window", [None, 16])
def test_attention_scores_prefill_mask(impl, window):
    """Prefill: queries 0..S-1 over a cache of S_kv > S keys (rows past S
    are empty cache rows the causal test masks)."""
    B, S, S_kv, H, KV, hd = 2, 40, 53, 4, 2, 16
    (qj, q), (kj, k), (vj, v) = _qkv(B, S, S_kv, H, KV, hd)
    mask = CausalMask(S, S_kv, window)
    want = ref_layers.attention_scores(qj, kj, vj,
                                       ref_layers.make_causal_mask(S, S_kv, window))
    assert_close(layers.attention_scores(q, k, v, mask, impl=impl), want, 2e-5)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("window", [None, 16])
def test_attention_scores_decode_mask(impl, window):
    """Decode: one query at position pos over the whole cache, the
    reference's (B, 1, S_kv) mask k_pos <= pos (and > pos - window)."""
    B, S_kv, H, KV, hd, pos = 3, 57, 4, 2, 16, 41
    (qj, q), (kj, k), (vj, v) = _qkv(B, 1, S_kv, H, KV, hd)
    k_pos = jnp.arange(S_kv)
    valid = jnp.broadcast_to((k_pos[None, :] <= pos)[None], (B, 1, S_kv))
    if window:
        valid = valid & (k_pos[None, None, :] > pos - window)
    want = ref_layers.attention_scores(qj, kj, vj, valid)
    got = layers.attention_scores(q, k, v, CausalMask(1, S_kv, window, q_offset=pos),
                                  impl=impl)
    assert_close(got, want, 2e-5)


def test_attention_scores_long_query_chunks_like_the_reference():
    """Sq = 2048 takes the reference's q-chunked path on the plain route."""
    B, S, H, KV, hd = 1, 2048, 2, 1, 16
    (qj, q), (kj, k), (vj, v) = _qkv(B, S, S, H, KV, hd)
    want = ref_layers.attention_scores(qj, kj, vj, ref_layers.make_causal_mask(S, S, 64))
    for impl in ("plain", "kernel"):
        got = layers.attention_scores(q, k, v, CausalMask(S, S, 64), impl=impl)
        assert_close(got, want, 2e-5)


@pytest.mark.parametrize("flags", [dict(), dict(attn_bias=True, qk_norm=True)],
                         ids=["plain", "bias+qk_norm"])
def test_attention_block_with_cache_matches_reference(flags):
    """Self-attention with the KV-cache update at pos, against the
    reference's attention_block: output and the written cache."""
    rcfg = dataclasses.replace(ref_get_config("hymba-1.5b").reduced(), **flags)
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), **flags)
    from repro.models.transformer import _attn_shapes

    B, S, S_max, pos = 2, 5, 24, 7
    shapes = _attn_shapes(rcfg)
    pj, pt = {}, {}
    for name in sorted(shapes):
        pj[name], pt[name] = both(arr(shapes[name], -0.3, 0.3))
    xj, x = both(arr((B, S, cfg.d_model)))
    ckj, ck = both(arr((B, S_max, cfg.n_kv_heads, cfg.resolved_head_dim)))
    cvj, cv = both(arr((B, S_max, cfg.n_kv_heads, cfg.resolved_head_dim)))
    positions = np.broadcast_to(np.arange(pos, pos + S), (B, S))
    want, want_cache = ref_layers.attention_block(
        pj, xj, rcfg, jnp.asarray(positions),
        ref_layers.make_causal_mask(S, S_max, rcfg.window, q_offset=pos),
        {"k": ckj, "v": cvj, "pos": jnp.int32(pos)})
    for impl in ("kernel", "plain"):
        cache = {"k": ck.clone(), "v": cv.clone(), "pos": pos}
        got, got_cache = layers.attention_block(
            pt, x, cfg, torch.from_numpy(positions.copy()),
            CausalMask(S, S_max, cfg.window, q_offset=pos), cache, impl=impl)
        assert_close(got, want, 2e-5)
        assert_close(got_cache["k"], want_cache["k"], 2e-5)
        assert_close(got_cache["v"], want_cache["v"], 2e-5)
        assert got_cache["pos"] == pos + S


def test_rope_and_rmsnorm_match_reference():
    xj, x = both(arr((2, 9, 3, 16)))
    pos = np.arange(18).reshape(2, 9) * 37
    assert_close(layers.apply_rope(x, torch.from_numpy(pos), 10000.0),
                 ref_layers.apply_rope(xj, jnp.asarray(pos), 10000.0), 2e-5)
    sj, s = both(arr((16,)))
    assert_close(layers.rmsnorm(x, s), ref_layers.rmsnorm(xj, sj), 2e-5)
    # a zero scale is the identity scale (1 + 0), not a zero output
    zero = layers.rmsnorm(x, torch.zeros(16))
    assert_close(zero, ref_layers.rmsnorm(xj, jnp.zeros(16)), 2e-5)
    assert zero.abs().max() > 0.5


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
def test_mlp_block_matches_reference(act):
    rcfg = dataclasses.replace(ref_get_config("hymba-1.5b").reduced(), act=act)
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), act=act)
    D, F = cfg.d_model, cfg.d_ff
    pj, pt = {}, {}
    for name, shape in (("w_gate", (D, F)), ("w_up", (D, F)), ("w_down", (F, D))):
        pj[name], pt[name] = both(arr(shape, -0.2, 0.2))
    xj, x = both(arr((2, 5, D)))
    assert_close(layers.mlp_block(pt, x, cfg), ref_layers.mlp_block(pj, xj, rcfg), 2e-5)
