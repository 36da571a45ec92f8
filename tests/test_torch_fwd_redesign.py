"""The plain versions of the redesigned attention forward's split-KV decode
and of the scan's checkpoint route, on the CPU, against the port's plain
kernels and the reference.

On the card a flash-attention call whose grid is too small to fill it
(every decode step) splits the keys into ``kv_splits`` ranges, writes each
range's partial (m, l, O) and merges them in range order.
``flash_attention_split_ref`` is that arithmetic in plain PyTorch; it is held
with the shape-to-splits function against ``flash_attention_ref`` and the
reference's oracle ``repro.kernels.ref.flash_attention_ref`` at 2e-5 (f32, the
reference's tolerance): decode at hymba's heads (25 / 5, hd 64), global and
local, with a ragged last range; a window narrower than a range, so that
whole ranges see no key of a row; ranges with no key at all; lse; and the
one-range prefill case.

The scan's forward can also return its checkpoints (the state before every
16th step) and the backward can take them: both are held bitwise against the
plain scan and backward without them, and against ``jax.grad`` of the
reference's ``ssm_scan`` at 1e-4 (the reference's tolerance), S = 100 ragged.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as ref_oracle
from repro.models import ssm as ref_ssm
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (SMS, flash_attention_ref,
                                                 flash_attention_split_ref, key_range,
                                                 key_tile, kv_splits, query_tiles,
                                                 split_ranges)
from repro_torch.kernels.mamba_scan import (CKPT_STEPS, MambaScan, checkpoint_shape,
                                            mamba_scan_bwd_ref, mamba_scan_ref)

RNG = np.random.default_rng(15)
TOL = 2e-5  # f32 attention, the reference's
SCAN_TOL = 1e-4


def arr(shape, lo=-1.0, hi=1.0):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def qkv(B, H, KV, Sq, Skv, hd):
    return [arr(s) for s in ((B, H, Sq, hd), (B, KV, Skv, hd), (B, KV, Skv, hd))]


def close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def blocks(B, KV, rep, Sq, splits):
    return B * KV * query_tiles(rep, Sq) * splits


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 1024], ids=["global", "local"])
def test_decode_at_hymba_serve_shapes_splits_to_fill_the_card(window):
    """B 8, 25 / 5 heads, hd 64, one query at 2048 over a 2081 cache: the
    grid has 40 blocks, the split one at least SMS."""
    B, H, KV, hd, Skv, pos = 8, 25, 5, 64, 2081, 2048
    splits = kv_splits(B, KV, H // KV, 1, Skv, hd, True, window, pos)
    assert blocks(B, KV, H // KV, 1, 1) == 40
    assert splits > 1 and blocks(B, KV, H // KV, 1, splits) >= SMS


@pytest.mark.parametrize("B,Sq", [(8, 2048), (4, 2048), (2, 512)])
def test_prefill_and_training_grids_take_one_range(B, Sq):
    assert blocks(B, 5, 5, Sq, 1) >= SMS
    assert kv_splits(B, 5, 5, Sq, Sq + 33, 64, True, None, 0) == 1


def test_splits_never_exceed_the_key_tiles():
    """A short cache: one tile of keys, so one range however small the grid."""
    assert kv_splits(1, 1, 1, 1, 40, 64, True, None, 39) == 1
    assert kv_splits(1, 1, 1, 1, 200, 128, True, None, 199) == 7  # 32-key tiles


@pytest.mark.parametrize("rep,Sq,tiles", [(1, 1, 1), (5, 2048, 160), (2, 2048, 64),
                                          (33, 65, 34), (64, 40, 40), (16, 1, 1), (64, 1, 1)])
def test_query_tiles_are_64_position_major_rows_whatever_rep(rep, Sq, tiles):
    """Both kernels' blocks are 64 position-major rows (position * rep +
    head) of one kv head, at every dtype and head dim: rep 33 and 64 fill
    them too (the f32 kernel's old blocks held whole positions, at most 32
    rows at hd 256)."""
    assert query_tiles(rep, Sq) == tiles


@pytest.mark.parametrize("n,splits", [(33, 7), (17, 7), (5, 5), (3, 7), (0, 4), (1, 1)])
def test_split_ranges_cover_the_tiles_in_order(n, splits):
    ranges = split_ranges(n, splits)
    assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [hi - lo for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= 1


def test_key_range_trims_causal_and_window_to_whole_tiles():
    assert key_range(1, 2081, True, None, 2048, 64) == (0, 2049)
    assert key_range(1, 2081, True, 1024, 2048, 64) == (1024, 2049)
    assert key_range(40, 40, False, None, 0, 64) == (0, 40)
    assert key_tile(64) == 64 and key_tile(128) == 32


# ---------------------------------------------------------------------------
# split-and-merge against one pass and the reference
# ---------------------------------------------------------------------------


def _both_refs(q, k, v, causal, window, q_offset, **split_kw):
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got, lse = flash_attention_split_ref(*t, causal, window, q_offset, return_lse=True,
                                         **split_kw)
    want, want_lse = flash_attention_ref(*t, causal, window, q_offset, return_lse=True)
    return got, lse, want, want_lse


@pytest.mark.parametrize("window", [None, 100], ids=["global", "local"])
@pytest.mark.parametrize("Skv,pos", [(333, 300), (2081, 2048), (161, 130)])
def test_decode_split_matches_one_pass_and_the_reference(Skv, pos, window):
    """hymba's heads; the visible range's last tile is ragged (pos + 1 keys
    is no multiple of 64), and so is the last range."""
    q, k, v = qkv(2, 25, 5, 1, Skv, 64)
    splits = kv_splits(2, 5, 5, 1, Skv, 64, True, window, pos)
    assert splits > 1
    got, lse, want, want_lse = _both_refs(q, k, v, True, window, pos)
    close(got, want)
    close(lse, want_lse)
    close(got, ref_oracle(*map(jnp.asarray, (q, k, v)), causal=True, window=window,
                          q_offset=pos))


@pytest.mark.parametrize("splits,bk", [(4, 16), (6, 8), (3, 64)])
def test_forced_splits_with_a_ragged_last_range(splits, bk):
    q, k, v = qkv(3, 25, 5, 1, 333, 64)
    got, lse, want, want_lse = _both_refs(q, k, v, True, None, 300, splits=splits, bk=bk)
    assert 301 % bk  # keys 0..300: the last range ends in a partial tile
    close(got, want)
    close(lse, want_lse)
    close(got, ref_oracle(*map(jnp.asarray, (q, k, v)), causal=True, q_offset=300))


def test_window_narrower_than_a_range_leaves_whole_ranges_unseen():
    """Three queries at 40..42 with a window of 2 over one-key tiles in 6
    ranges: the ranges of keys 41 and 42 are beyond query 40's sight, and
    past the last tile hold no key at all; each adds nothing."""
    q, k, v = qkv(1, 4, 2, 3, 48, 32)
    bk, splits, window, pos = 1, 6, 2, 40
    k_begin, k_end = key_range(3, 48, True, window, pos, bk)
    assert (k_begin, k_end) == (39, 43)  # 4 one-key tiles in 6 ranges: two empty
    got, lse, want, want_lse = _both_refs(q, k, v, True, window, pos, splits=splits, bk=bk)
    close(got, want)
    close(lse, want_lse)
    close(got, ref_oracle(*map(jnp.asarray, (q, k, v)), causal=True, window=window,
                          q_offset=pos))


def test_a_row_that_sees_no_key_gives_zero_and_minus_infinite_lse():
    """Queries past the cache with a window shorter than the gap."""
    q, k, v = qkv(1, 4, 2, 2, 10, 16)
    got, lse, want, want_lse = _both_refs(q, k, v, True, 4, 20, splits=3, bk=4)
    assert torch.equal(got, torch.zeros_like(got)) and torch.equal(got, want)
    assert torch.isinf(lse).all() and (lse < 0).all() and torch.equal(lse, want_lse)


@pytest.mark.parametrize("window", [None, 24])
def test_prefill_takes_one_range_and_matches(window):
    q, k, v = qkv(2, 25, 5, 64, 64, 64)
    assert kv_splits(2, 5, 5, 64, 64, 64, True, window, 0) == 1
    got, lse, want, want_lse = _both_refs(q, k, v, True, window, 0)
    close(got, want)
    close(lse, want_lse)
    close(got, ref_oracle(*map(jnp.asarray, (q, k, v)), causal=True, window=window))


def test_split_ref_keeps_bf16_and_non_causal():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in qkv(2, 6, 3, 1, 90, 32))
    got = flash_attention_split_ref(q, k, v, False, None, 0, splits=3, bk=16)
    assert got.dtype == torch.bfloat16
    close(got, flash_attention_ref(q, k, v, False, None, 0).float(), 3e-2)


# ---------------------------------------------------------------------------
# the scan's checkpoints
# ---------------------------------------------------------------------------


def scan_inputs(B, S, DI, N):
    return [torch.from_numpy(x) for x in (arr((B, S, DI, N), 0.5, 0.99),
                                           arr((B, S, DI, N)), arr((B, S, N)))]


@pytest.mark.parametrize("S", [1, 16, 17, 100])
def test_plain_scan_with_checkpoints_is_the_plain_scan_bitwise(S):
    dA, dBx, C = scan_inputs(2, S, 24, 8)
    y, h = mamba_scan_ref(dA, dBx, C)
    y2, h2, ck = mamba_scan_ref(dA, dBx, C, checkpoints=True)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert ck.shape == checkpoint_shape(2, S, 24, 8) == (2, -(-S // CKPT_STEPS), 24, 8)
    # the checkpoint of chunk c is the state after step 16 c - 1 (0 before step 0)
    states = [torch.zeros_like(h)]
    for t in range(S):
        states.append(dA[:, t] * states[-1] + dBx[:, t])
    for c in range(ck.shape[1]):
        assert torch.equal(ck[:, c], states[CKPT_STEPS * c])
    y3, h3, ck3 = ops.mamba_scan(dA, dBx, C, checkpoints=True)
    assert torch.equal(y3, y) and torch.equal(h3, h) and torch.equal(ck3, ck)


@pytest.mark.parametrize("seeded", [False, True], ids=["dy", "dy+dh"])
@pytest.mark.parametrize("S", [1, 32, 100])
def test_plain_backward_from_checkpoints_is_bitwise_and_matches_jax_grad(S, seeded):
    dA, dBx, C = scan_inputs(2, S, 64, 8)
    dy = torch.from_numpy(arr((2, S, 64)))
    dh = torch.from_numpy(arr((2, 64, 8))) if seeded else None
    _, _, ck = mamba_scan_ref(dA, dBx, C, checkpoints=True)
    without = mamba_scan_bwd_ref(dA, dBx, C, dy, dh)
    with_ck = mamba_scan_bwd_ref(dA, dBx, C, dy, dh, ck)
    through_ops = ops.mamba_scan_bwd(dA, dBx, C, dy, dh, checkpoints=ck)
    for a, b, c in zip(without, with_ck, through_ops):
        assert torch.equal(a, b) and torch.equal(a, c)

    def loss(dA, dBx, C):
        hs = ref_ssm.ssm_scan(dA, dBx)
        out = jnp.sum(jnp.einsum("bsdn,bsn->bsd", hs, C) * jnp.asarray(dy.numpy()))
        return out if dh is None else out + jnp.sum(hs[:, -1] * jnp.asarray(dh.numpy()))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(t.numpy()) for t in (dA, dBx, C)))
    for g, w in zip(with_ck, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SCAN_TOL, rtol=SCAN_TOL)


def test_scan_autograd_hands_the_forward_checkpoints_to_the_backward(monkeypatch):
    """``MambaScan`` asks the forward for checkpoints and passes them on;
    the gradients equal torch autograd of the plain scan (S = 100 ragged)."""
    dA, dBx, C = scan_inputs(2, 100, 24, 8)
    wy = torch.from_numpy(arr((2, 100, 24)))
    seen = []
    real = ops.mamba_scan_bwd

    def spy(*args, **kw):
        seen.append(kw.get("checkpoints"))
        return real(*args, **kw)

    monkeypatch.setattr(ops, "mamba_scan_bwd", spy)
    grads = []
    for fn in (MambaScan.apply, mamba_scan_ref):
        ts = [t.clone().requires_grad_() for t in (dA, dBx, C)]
        y, _h = fn(*ts)
        grads.append(torch.autograd.grad((y * wy).sum(), ts))
    assert len(seen) == 1 and seen[0] is not None
    assert torch.equal(seen[0], mamba_scan_ref(dA, dBx, C, checkpoints=True)[2])
    for g, r in zip(*grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=SCAN_TOL, rtol=SCAN_TOL)


def test_no_grad_scan_makes_no_checkpoints():
    dA, dBx, C = (t.requires_grad_() for t in scan_inputs(1, 20, 8, 4))
    with torch.no_grad():
        assert len(ops.mamba_scan(dA, dBx, C)) == 2
    with pytest.raises(ValueError, match="checkpoints"):
        ops.mamba_scan(dA, dBx, C, checkpoints=True)


def test_scan_backward_rejects_checkpoints_of_another_shape():
    dA, dBx, C = scan_inputs(1, 20, 8, 4)
    dy = torch.zeros(1, 20, 8)
    with pytest.raises(ValueError, match="checkpoints must be"):
        ops.mamba_scan_bwd(dA, dBx, C, dy, checkpoints=torch.zeros(1, 1, 8, 4))
    with pytest.raises(ValueError, match="checkpoints must be"):
        ops.mamba_scan_bwd(dA, dBx, C, dy, checkpoints=torch.zeros(1, 2, 8, 4).double())

