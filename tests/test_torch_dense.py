"""The dense and VLM decoders of the zoo in the port (gemma3-4b, gemma-7b,
nemotron-4-15b, command-r-35b, qwen2-vl-7b) on the CPU against the
reference, and the attention they add (head dim 256).

Configs: each port ``CONFIG`` equals the reference's field for field, with
the same parameter shapes, counts and ``reduced()`` variant.  Attention at
hd 256: the port's ``ops.flash_attention`` (its plain version on CPU
tensors) against the reference's Pallas kernel in interpret mode, causal
(the reference's non-causal ragged case is wrong, ROADMAP Queue 3 (a)),
f32, to 2e-5 (the reference's kernel-test tolerance); per-row offsets
against the split plain version and the reference's oracle row by row.

Models, f32, each ``reduced()`` config with the reference's own weights
(``repro.models.init_params(cfg, PRNGKey(0))``) carried across with
``params_from_jax``: prefill logits and the whole KV cache, then greedy
decode steps (the same tokens) and the training forward, to 1e-4 of the
largest value, on both routes of the port.  gemma3-4b runs at 6 layers
(layer 5 is its first global layer, so the reference sizes the cache at
max_len and not at the window, Queue 3 (f)), once with its reduced head
dim and once with head dim 256, the published one.  nemotron-4-15b's
final layernorm scale is zero under the reference's init, which makes
every logit exactly 0; its norms' scales are set to ones (the layernorm's
own init) in the weights handed to both packages, as ``chip_smoke.py``
does.  qwen2-vl-7b prefills embeddings (its stub vision frontend), with
the text positions the reference builds and with three distinct M-RoPE
streams.  ``serve_demo`` generates the reference ``serve_demo``'s
sequences for every model.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.kernels.ops import flash_attention as ref_flash_attention
from repro.kernels.ref import flash_attention_ref as ref_oracle
from repro.launch.serve import serve_demo as ref_serve_demo
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro.models import param_shapes as ref_param_shapes
from repro.models import prefill as ref_prefill
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_split_ref
from repro_torch.launch.serve import make_prompts, serve_demo
from repro_torch.models import decode_step, forward, param_shapes, prefill
from repro_torch.models import layers

ARCHS = ["gemma3-4b", "gemma-7b", "nemotron-4-15b", "command-r-35b", "qwen2-vl-7b"]
TOL = 1e-4
ATTN_TOL = 2e-5
B, S, STEPS = 2, 24, 6
MAX_LEN = S + STEPS + 4
#: model variants: (arch, changes to its reduced config)
VARIANTS = {
    "gemma3-4b": ("gemma3-4b", dict(n_layers=6)),
    "gemma3-4b-hd256": ("gemma3-4b", dict(n_layers=6, head_dim=256)),
    "gemma-7b": ("gemma-7b", {}),
    "nemotron-4-15b": ("nemotron-4-15b", {}),
    "command-r-35b": ("command-r-35b", {}),
    "qwen2-vl-7b": ("qwen2-vl-7b", {}),
    "qwen2-vl-7b-mrope3": ("qwen2-vl-7b", {}),
}


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def _shape_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shape_leaves(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree)}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_published_one(arch):
    cfg, rcfg = get_config(arch), ref_configs.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(rcfg.reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_counts_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_configs.get_config(arch)
    assert _shape_leaves(param_shapes(cfg)) == _shape_leaves(ref_param_shapes(rcfg))
    assert cfg.param_count() == rcfg.param_count()
    assert [cfg.is_local_layer(i) for i in range(cfg.n_layers)] == [
        rcfg.is_local_layer(i) for i in range(rcfg.n_layers)]


# ---------------------------------------------------------------------------
# attention at head dim 256
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(19)


def _both(shape):
    x = RNG.uniform(-1.0, 1.0, shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("sq,skv,h,kv,window,q_offset", [
    (64, 64, 4, 4, None, 0),      # rep 1 (gemma-7b)
    (64, 64, 8, 4, None, 0),      # rep 2 (gemma3-4b)
    (40, 72, 8, 4, None, 32),     # queries at an offset, ragged lengths
    (96, 96, 8, 4, 24, 0),        # a local layer's window
    (48, 128, 4, 2, 40, 80),      # window and offset
    (1, 100, 8, 4, None, 99),     # one decode step
], ids=str)
def test_hd256_matches_the_pallas_kernel_in_interpret_mode(sq, skv, h, kv, window, q_offset):
    (qj, q), (kj, k), (vj, v) = (_both(s) for s in
                                 ((2, h, sq, 256), (2, kv, skv, 256), (2, kv, skv, 256)))
    want = ref_flash_attention(qj, kj, vj, causal=True, window=window, q_offset=q_offset,
                               bq=32, bk=32, interpret=True)
    got = ops.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)
    split = flash_attention_split_ref(q, k, v, True, window, q_offset)
    np.testing.assert_allclose(split.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("window", [None, 16], ids=["global", "local"])
@pytest.mark.parametrize("sq", [1, 9])
def test_hd256_per_row_offsets_match_split_and_reference_rows(sq, window):
    offsets = (0, 17, 40, 63)
    (_, q), (_, k), (_, v) = (_both(s) for s in
                              ((4, 8, sq, 256), (4, 4, 64 + sq, 256), (4, 4, 64 + sq, 256)))
    off = torch.tensor(offsets, dtype=torch.int32)
    got, lse = ops.flash_attention(q, k, v, window=window, q_offset=off, return_lse=True)
    split, lse_split = flash_attention_split_ref(q, k, v, True, window, off, return_lse=True,
                                                 splits=3)
    np.testing.assert_allclose(got.numpy(), split.numpy(), atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_split.numpy(), atol=1e-5, rtol=1e-5)
    for b, o in enumerate(offsets):
        want = ref_oracle(jnp.asarray(q[b:b + 1].numpy()), jnp.asarray(k[b:b + 1].numpy()),
                          jnp.asarray(v[b:b + 1].numpy()), causal=True, window=window,
                          q_offset=o)
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(want), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)


def test_mrope_matches_the_reference():
    x = RNG.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(7) // 3, np.arange(7) % 3])[:, None].repeat(2, 1)
    want = ref_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 10000.0, (2, 3, 3))
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="sum to head_dim/2"):
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, (2, 3, 2))


def test_mrope_broadcasts_text_and_per_row_decode_positions():
    cfg = get_config("qwen2-vl-7b").reduced()
    x = torch.from_numpy(RNG.standard_normal((3, 1, 4, 16)).astype(np.float32))
    rows = torch.tensor([[5], [0], [11]])  # (B, 1): one decode step, a position per row
    got = layers.position_embed(x, rows, cfg)
    want = layers.apply_mrope(x, rows[None].expand(3, 3, 1), cfg.rope_theta,
                              cfg.mrope_sections)
    assert torch.equal(got, want)
    # three equal streams are plain RoPE
    np.testing.assert_allclose(got.numpy(),
                               layers.apply_rope(x, rows, cfg.rope_theta).numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the models against the reference
# ---------------------------------------------------------------------------


def _prefill_batch(name, cfg, seed=0):
    """numpy inputs: ``serve_demo``'s prompts (embeddings for qwen2-vl-7b),
    and for the mrope3 variant three distinct M-RoPE position streams."""
    batch = make_prompts(cfg, B, S, seed)
    if name == "qwen2-vl-7b-mrope3":
        t = np.arange(S)
        batch["positions"] = np.stack([t, t // 4, t % 4])[:, None].repeat(B, 1)
    return batch


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    name = request.param
    arch, changes = VARIANTS[name]
    rcfg = dataclasses.replace(ref_configs.get_config(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    nparams = jax.tree.map(np.array, ref_init_params(rcfg, jax.random.PRNGKey(0)))
    if arch == "nemotron-4-15b":  # a zero layernorm scale makes every logit 0
        for norm in (nparams["final_norm"], nparams["layers"]["norm1"],
                     nparams["layers"]["norm2"]):
            norm["scale"] = np.ones_like(norm["scale"])
    rparams = jax.tree.map(jnp.asarray, nparams)
    params = params_from_jax(nparams, device="cpu")
    batch = _prefill_batch(name, cfg)
    rbatch = {k: jnp.asarray(v, jnp.float32 if k == "embeds" else jnp.int32)
              for k, v in batch.items()}
    logits, cache = jax.jit(lambda p, b: ref_prefill(p, b, rcfg, MAX_LEN))(rparams, rbatch)
    step = jax.jit(lambda p, t, c: ref_decode_step(p, t, c, rcfg))
    ref = {"prefill": (np.asarray(logits), jax.tree.map(np.asarray, cache)), "steps": []}
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    for _ in range(STEPS):
        logits, cache = step(rparams, tok, cache)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        ref["steps"].append((np.asarray(logits), np.asarray(tok)))
    ref["forward"] = np.asarray(jax.jit(lambda p, b: ref_forward(p, b, rcfg)[0])(
        rparams, rbatch))
    return name, cfg, params, batch, ref


def _torch_batch(batch):
    return {k: torch.from_numpy(v).float() if k == "embeds" else torch.from_numpy(v).long()
            for k, v in batch.items()}


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_prefill_logits_and_cache_match_reference(model, impl):
    name, cfg, params, batch, ref = model
    logits, cache = prefill(params, _torch_batch(batch), cfg, MAX_LEN, impl=impl)
    want_logits, want_cache = ref["prefill"]
    assert logits.shape == (B, 1, cfg.vocab) and cache["pos"] == S
    assert np.abs(want_logits).max() > 0, name
    assert rel_err(logits, want_logits) <= TOL
    for leaf in ("k", "v"):
        assert cache["layers"][leaf].shape == want_cache["layers"][leaf].shape
        assert rel_err(cache["layers"][leaf], want_cache["layers"][leaf]) <= TOL, leaf


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_greedy_decode_matches_reference(model, impl):
    name, cfg, params, batch, ref = model
    logits, cache = prefill(params, _torch_batch(batch), cfg, MAX_LEN, impl=impl)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    for want_logits, want_tok in ref["steps"]:
        logits, cache = decode_step(params, tok, cache, cfg, impl=impl)
        assert rel_err(logits, want_logits) <= TOL
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), want_tok)
    assert cache["pos"] == S + STEPS


def test_forward_matches_reference(model):
    name, cfg, params, batch, ref = model
    got, aux = forward(params, _torch_batch(batch), cfg)
    assert rel_err(got, ref["forward"]) <= TOL and float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_demo_generates_the_reference_sequences(arch):
    """Each model reduced (gemma3-4b's two layers are local: prompt + gen
    stays inside its window, Queue 3 (f)); qwen2-vl-7b prefills the reference's
    standard-normal embeddings."""
    seqs_ref = ref_serve_demo(arch, batch=2, prompt_len=8, gen=6, seed=0,
                              log_fn=lambda *a: None)
    rcfg = ref_configs.get_config(arch).reduced()
    params = params_from_jax(
        jax.tree.map(np.asarray, ref_init_params(rcfg, jax.random.PRNGKey(0))), device="cpu")
    seqs = serve_demo(get_config(arch).reduced(), batch=2, prompt_len=8, gen=6, seed=0,
                      device="cpu", params=params, log_fn=lambda *a: None)
    np.testing.assert_array_equal(seqs, seqs_ref)


def test_serve_demo_prefills_embeddings_for_an_embedding_model():
    cfg = get_config("qwen2-vl-7b").reduced()
    prompts = make_prompts(cfg, 2, 5, seed=3)
    assert set(prompts) == {"embeds"} and prompts["embeds"].shape == (2, 5, cfg.d_model)
    np.testing.assert_array_equal(
        prompts["embeds"], np.random.default_rng(3).standard_normal((2, 5, cfg.d_model)))
    assert set(make_prompts(get_config("gemma-7b").reduced(), 2, 5)) == {"tokens"}
