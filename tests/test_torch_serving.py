"""Continuous batching in the port (``repro_torch.serve``) on the CPU against
the reference (``repro.serve``), and the per-row query offsets it rests on.

Models: hymba-1.5b reduced to 8 layers (layer 7 is its first global layer,
so the reference sizes its caches at max_len rather than at the window of
16, ROADMAP Queue 3 (f)), gemma3-4b reduced to 6 layers (layer 5 global;
sliding-window and global attention, no SSM), falcon-mamba-7b and
qwen2-vl-7b (M-RoPE) reduced, all f32, with the reference's own weights
(``repro.models.init_params(cfg, PRNGKey(0))``) carried across with
``params_from_jax``.  The port's ``ContinuousBatcher``
must return exactly the reference batcher's token lists and each request's
own standalone decode (the reference's ``tests/test_serving.py`` cases,
ported); per-row attention agrees with the reference's oracle row by row
to 2e-5 of max|out| (the reference's f32 kernel tolerance), and a per-row
``decode_step`` with B = 1 steps row by row to 1e-4 of max|logit|.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.kernels.ref import flash_attention_ref as ref_flash_attention
from repro.models import init_params as ref_init_params
from repro.models import param_shapes as ref_param_shapes
from repro.serve import ContinuousBatcher as RefBatcher
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_ref, flash_attention_split_ref
from repro_torch.models import decode_step, init_params, param_shapes, prefill
from repro_torch.models.layers import CausalMask
from repro_torch.serve import ContinuousBatcher

ATTN_TOL = 2e-5
LOGIT_TOL = 1e-4
MAX_LEN = 64
#: (prompt lengths, new tokens, slots) per model: hymba's and gemma3's cross
#: their window of 16, as the reference's own gemma3 case crosses gemma3's
CASES = {"hymba-1.5b": ((5, 21, 13, 30), 6, 2), "falcon-mamba-7b": ((4, 6, 5), 4, 2),
         "gemma3-4b": ((5, 21, 13, 30), 6, 2), "qwen2-vl-7b": ((4, 9, 6), 4, 2)}


def _model(arch, n_layers=None):
    rcfg = ref_configs.get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    if n_layers is not None:
        rcfg = dataclasses.replace(rcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    rparams = ref_init_params(rcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    return cfg, rcfg, rparams, params


@pytest.fixture(scope="module")
def models():
    return {"hymba-1.5b": _model("hymba-1.5b", 8), "falcon-mamba-7b": _model("falcon-mamba-7b"),
            "gemma3-4b": _model("gemma3-4b", 6), "qwen2-vl-7b": _model("qwen2-vl-7b")}


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in lengths]


def standalone(cfg, params, prompt, n, max_len=MAX_LEN, record=None):
    """The port's own greedy decode of one request at B = 1."""
    logits, cache = prefill(params, {"tokens": torch.as_tensor(prompt[None]).long()}, cfg,
                            max_len)
    rows = [logits[0, -1]]
    for _ in range(n - 1):
        tok = torch.argmax(rows[-1])[None, None]
        logits, cache = decode_step(params, tok, cache, cfg)
        rows.append(logits[0, -1])
    if record is not None:
        record.append(torch.stack(rows).numpy())
    return [int(torch.argmax(r)) for r in rows]


def _batched(cfg, params, prompts, max_new, slots, eos_id=None, record=None, **kw):
    b = ContinuousBatcher(cfg, params, max_slots=slots, max_len=MAX_LEN, eos_id=eos_id,
                          record=record, **kw)
    rids = [b.submit(p, max_new=max_new) for p in prompts]
    return rids, b.run()


def _reference(rcfg, rparams, prompts, max_new, slots, eos_id=None):
    b = RefBatcher(rcfg, rparams, max_slots=slots, max_len=MAX_LEN, eos_id=eos_id)
    rids = [b.submit(p, max_new=max_new) for p in prompts]
    return rids, b.run()


@pytest.fixture(scope="module")
def served(models):
    """Each model's main case through the port and through the reference."""
    out = {}
    for arch, (lengths, max_new, slots) in CASES.items():
        cfg, rcfg, rparams, params = models[arch]
        prompts = _prompts(cfg, lengths, 0)
        record = {}
        rids, port = _batched(cfg, params, prompts, max_new, slots, record=record)
        ref_rids, ref = _reference(rcfg, rparams, prompts, max_new, slots)
        assert rids == ref_rids
        out[arch] = dict(prompts=prompts, rids=rids, port=port, ref=ref, record=record)
    return out


@pytest.mark.parametrize("arch", list(CASES))
def test_matches_reference_batcher(served, arch):
    """More requests than slots, ragged prompts: the port's token lists are
    the reference batcher's."""
    s = served[arch]
    assert s["port"] == {rid: list(map(int, toks)) for rid, toks in s["ref"].items()}


@pytest.mark.parametrize("arch", list(CASES))
def test_matches_independent_decode(models, served, arch):
    """Every request's greedy continuation equals its standalone decode, and
    the recorded logits its standalone logits (the same tokens fed)."""
    cfg, _, _, params = models[arch]
    s = served[arch]
    max_new = CASES[arch][1]
    for rid, p in zip(s["rids"], s["prompts"]):
        rows = []
        assert s["port"][rid] == standalone(cfg, params, p, max_new, record=rows), rid
        got, want = s["record"]["logits"][rid], rows[0]
        assert got.shape == want.shape == (max_new, cfg.vocab)
        assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


def test_record_counts_steps_admissions_and_first_tokens(served):
    rec = served["hymba-1.5b"]["record"]
    lengths, max_new, slots = CASES["hymba-1.5b"]
    assert sum(st["admitted"] for st in rec["steps"]) == len(lengths)
    assert all(1 <= st["active"] <= slots and st["wall_s"] > 0 for st in rec["steps"])
    # every active slot emits one token a step; prefill gives each request one more
    assert sum(st["active"] for st in rec["steps"]) == len(lengths) * (max_new - 1)
    assert sorted(rec["ttft_s"]) == served["hymba-1.5b"]["rids"]
    assert all(t > 0 for t in rec["ttft_s"].values())


@pytest.mark.parametrize("arch", list(CASES))
def test_slot_recycling(models, arch):
    """4 requests through 1 slot: strictly sequential occupancy, the
    reference's tokens."""
    cfg, rcfg, rparams, params = models[arch]
    prompts = _prompts(cfg, (4, 4, 4, 4), 1)
    rids, out = _batched(cfg, params, prompts, 3, 1)
    assert set(out) == set(rids) and all(len(v) == 3 for v in out.values())
    _, ref = _reference(rcfg, rparams, prompts, 3, 1)
    assert out == {rid: list(map(int, toks)) for rid, toks in ref.items()}


def test_eos_frees_slot_early(models):
    cfg, rcfg, rparams, params = models["hymba-1.5b"]
    prompt = _prompts(cfg, (6,), 2)[0]
    ref = standalone(cfg, params, prompt, 8)
    eos = ref[2]  # force an early stop (the token may also occur sooner)
    (rid,), out = _batched(cfg, params, [prompt], 8, 2, eos_id=eos)
    # truncated at the first eos after the prefill's token, inclusive
    stop = ref.index(eos, 1) + 1
    assert stop < 8
    assert out[rid] == ref[:stop]
    _, ref_out = _reference(rcfg, rparams, [prompt], 8, 2, eos_id=eos)
    assert out[rid] == list(map(int, ref_out[rid]))


def test_ssm_family_batched(models):
    """Per-slot state also works for the attention-free family: prompts of
    4, 6 and 5, 4 new tokens, through 2 slots."""
    cfg, _, _, params = models["falcon-mamba-7b"]
    assert cfg.attention_free
    prompts = _prompts(cfg, (4, 6, 5), 3)
    rids, out = _batched(cfg, params, prompts, 4, 2)
    for rid, p in zip(rids, prompts):
        assert out[rid] == standalone(cfg, params, p, 4), rid


def test_idle_slot_stays_parked_inside_the_cache(models):
    """A slot that finishes near the cache's end idles while another request
    decodes on: its position must not run past the cache (it is parked),
    and the long request still gets its standalone tokens."""
    cfg, _, _, params = models["hymba-1.5b"]
    short, long_ = _prompts(cfg, (60, 2), 4)
    b = ContinuousBatcher(cfg, params, max_slots=2, max_len=MAX_LEN)
    r_short, r_long = b.submit(short, max_new=2), b.submit(long_, max_new=30)
    out = b.run()
    assert out[r_short] == standalone(cfg, params, short, 2)
    assert out[r_long] == standalone(cfg, params, long_, 30)
    assert b.pos == [0, 0]


def test_plain_route_gives_the_kernel_routes_tokens(models, served):
    cfg, _, _, params = models["hymba-1.5b"]
    s = served["hymba-1.5b"]
    lengths, max_new, slots = CASES["hymba-1.5b"]
    _, out = _batched(cfg, params, s["prompts"], max_new, slots, impl="plain")
    assert out == s["port"]


def test_submit_rejects_what_the_cache_cannot_hold(models):
    cfg, _, _, params = models["hymba-1.5b"]
    b = ContinuousBatcher(cfg, params, max_slots=1, max_len=16)
    with pytest.raises(ValueError, match="cache positions"):
        b.submit(np.zeros(10, np.int32), max_new=8)
    with pytest.raises(ValueError, match="cache positions"):
        b.submit(np.zeros(0, np.int32), max_new=2)
    b.submit(np.zeros(10, np.int32), max_new=7)


# ---------------------------------------------------------------------------
# decode_step with one position per row
# ---------------------------------------------------------------------------


def _learned_pos_model():
    """hymba reduced to 2 layers with a learned position embedding too (the
    port's own weights): the per-row positions must reach it row by row."""
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), learned_pos=True)
    return cfg, None, None, init_params(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", list(CASES) + ["learned_pos"])
def test_decode_step_per_row_matches_b1_rows(models, arch):
    """Rows at positions 5, 21 and 13 decode in one call: each row's logits
    equal its own B = 1 step to 1e-4 of max|logit|, and the caches it wrote
    equal the B = 1 step's to 1e-5 of the leaf's max (not bitwise: the CPU's
    products round differently at 3 rows than at 1, from layer 1 on)."""
    cfg, _, _, params = models[arch] if arch in models else _learned_pos_model()
    prompts = _prompts(cfg, (5, 21, 13), 5)
    singles = [prefill(params, {"tokens": torch.as_tensor(p[None]).long()}, cfg, MAX_LEN)
               for p in prompts]
    toks = torch.tensor([[int(torch.argmax(lg[0, -1]))] for lg, _ in singles])
    pooled = {name: torch.cat([c["layers"][name] for _, c in singles], dim=1)
              for name in singles[0][1]["layers"]}
    logits, cache = decode_step(params, toks, {"layers": pooled, "pos": (5, 21, 13)}, cfg)
    assert cache["pos"] == (6, 22, 14)
    for b, (_, c1) in enumerate(singles):
        lg1, c1 = decode_step(params, toks[b:b + 1], c1, cfg)
        assert np.abs(logits[b].numpy() - lg1[0].numpy()).max() <= \
            LOGIT_TOL * np.abs(lg1.numpy()).max()
        for name, leaf in cache["layers"].items():
            want = c1["layers"][name][:, 0]
            assert (leaf[:, b] - want).abs().max() <= 1e-5 * want.abs().max(), name


def test_decode_step_per_row_raises_past_the_cache(models):
    cfg, _, _, params = models["hymba-1.5b"]
    _, cache = prefill(params, {"tokens": torch.zeros(2, 4, dtype=torch.long)}, cfg, 8)
    cache["pos"] = (3, 8)
    with pytest.raises(ValueError, match="KV cache of 8 positions"):
        decode_step(params, torch.zeros(2, 1, dtype=torch.long), cache, cfg)
    cache["pos"] = (3,)
    with pytest.raises(ValueError, match="per-row positions"):
        decode_step(params, torch.zeros(2, 1, dtype=torch.long), cache, cfg)


# ---------------------------------------------------------------------------
# the attention wrapper with per-row offsets (its plain version on the CPU)
# ---------------------------------------------------------------------------


def _qkv(B, H, KV, Sq, Skv, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
            for shape in ((B, H, Sq, hd), (B, KV, Skv, hd), (B, KV, Skv, hd))]


@pytest.mark.parametrize("window", [None, 8], ids=["global", "window8"])
@pytest.mark.parametrize("Sq", [1, 5])
def test_per_row_offsets_match_reference_rows(Sq, window):
    """Each row at its own offset equals the reference's oracle run on that
    row alone at a scalar offset."""
    q, k, v = _qkv(4, 4, 2, Sq, 40, 16, Sq)
    offsets = [0, 7, 19, 40 - Sq]
    got = ops.flash_attention(q, k, v, window=window,
                              q_offset=torch.tensor(offsets, dtype=torch.int32))
    for b, off in enumerate(offsets):
        want = np.asarray(ref_flash_attention(jnp.asarray(q[b:b + 1].numpy()),
                                              jnp.asarray(k[b:b + 1].numpy()),
                                              jnp.asarray(v[b:b + 1].numpy()),
                                              True, window, off))
        assert np.abs(got[b:b + 1].numpy() - want).max() <= ATTN_TOL * np.abs(want).max()


@pytest.mark.parametrize("splits", [None, 1, 3, 7])
@pytest.mark.parametrize("window", [None, 20], ids=["global", "window20"])
def test_split_ref_per_row_matches_one_pass(splits, window):
    """Each row cuts its own key range into the same splits (some empty for a
    row near the start; row 3 sees no key at all): output and lse equal the
    one-pass plain version's."""
    q, k, v = _qkv(4, 6, 2, 1, 150, 32, 9)
    offsets = torch.tensor([0, 70, 149, 200 if window else 149], dtype=torch.int32)
    kw = dict(causal=True, window=window, q_offset=offsets, return_lse=True)
    got, lse = flash_attention_split_ref(q, k, v, splits=splits, bk=16, **kw)
    want, lse_want = flash_attention_ref(q, k, v, **kw)
    assert np.abs((got - want).numpy()).max() <= ATTN_TOL * want.abs().max().item()
    finite = torch.isfinite(lse_want)
    assert torch.equal(finite, torch.isfinite(lse))
    assert (lse - lse_want)[finite].abs().max().item() <= 1e-5 * lse_want[finite].abs().max()
    if window:  # the empty row: no key, output 0
        assert not finite[3].any() and torch.equal(got[3], torch.zeros_like(got[3]))


@pytest.mark.parametrize("plain", [flash_attention_ref, flash_attention_split_ref],
                         ids=["one-pass", "split"])
def test_equal_per_row_offsets_give_the_scalar_bits(plain):
    q, k, v = _qkv(3, 4, 4, 2, 50, 16, 11)
    want = plain(q, k, v, True, 12, 30)
    got = plain(q, k, v, True, 12, torch.full((3,), 30, dtype=torch.int32))
    assert torch.equal(got, want)


def test_per_row_offsets_checked_and_refused_where_not_taken():
    q, k, v = _qkv(2, 4, 2, 1, 16, 16, 13)
    for bad in (torch.tensor([1, 2]), torch.tensor([1, 2, 3], dtype=torch.int32),
                torch.tensor([[1, 2]], dtype=torch.int32)):
        with pytest.raises(ValueError, match="per-row q_offset"):
            ops.flash_attention(q, k, v, q_offset=bad)
    offsets = torch.tensor([3, 9], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="6.1"):
        ops.flash_attention(q.requires_grad_(), k, v, q_offset=offsets)
    o = torch.zeros_like(q)
    with pytest.raises(NotImplementedError, match="6.1"):
        ops.flash_attention_bwd(q.detach(), k, v, o, torch.zeros(2, 4, 1), o, q_offset=offsets)


def test_causal_mask_with_device_offsets_stays_a_hashable_value():
    offsets = torch.tensor([4, 9], dtype=torch.int32)
    m = CausalMask(1, 16, q_offset=(4, 9), offsets=offsets)
    bare = CausalMask(1, 16, q_offset=(4, 9))
    assert m == bare and hash(m) == hash(bare)
    local = dataclasses.replace(m, window=8)
    assert local.offsets is offsets and local.per_row
    want = torch.stack([torch.arange(16) <= 4, (torch.arange(16) <= 9) & (torch.arange(16) > 1)])
    assert torch.equal(local.dense()[:, 0], want)


# ---------------------------------------------------------------------------
# falcon-mamba-7b's published configuration
# ---------------------------------------------------------------------------


def test_falcon_mamba_config_is_the_published_one():
    cfg, rcfg = get_config("falcon-mamba-7b"), ref_configs.get_config("falcon-mamba-7b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.attention_free and (cfg.n_layers, cfg.d_model, cfg.vocab) == (64, 4096, 65024)
    shapes = {path: tuple(s) for path, s in _flat(param_shapes(cfg))}
    assert shapes == {path: tuple(s) for path, s in _flat(ref_param_shapes(rcfg))}
    assert "attn" not in param_shapes(cfg)["layers"] and "mlp" not in param_shapes(cfg)["layers"]
    assert cfg.param_count() == rcfg.param_count() and 7.2e9 < cfg.param_count() < 7.3e9


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flat(sub, prefix + (key,))
    else:
        yield prefix, tree
