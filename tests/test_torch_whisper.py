"""whisper-small, the encoder-decoder of the zoo, in the port on the CPU
against the reference.

Config: the port's ``CONFIG`` equals the reference's field for field, with
the same parameter shapes, ``param_count`` and ``reduced()`` variant (its
encoder-decoder branch: 2 + 2 layers, frames of at most 64).

Attention with no mask (the encoder's self-attention and cross-attention):
``attention_scores(q, k, v, None)`` on the kernel route, which calls
``ops.flash_attention(..., causal=False)`` (its plain version on CPU
tensors), against the reference's model attention with ``mask=None``, on
ragged key counts too, and against the reference's Pallas kernel in
interpret mode at lengths its wrapper takes (Sq % bq == Skv % bk == 0;
ROADMAP Queue 3 (a)), to 2e-5 (the reference's kernel-test tolerance).

Model, f32, reduced, with the reference's own weights carried across by
``params_from_jax``: every layernorm scale set to ones in the weights both
packages get (under the reference's init the final norms' 1-D scales are
zero, so the encoder's output and every logit would be constant).  The
encoder stack, the cross-attention sublayer at prefill (keys and values
from the encoder's output) and at decode (the static cache), the training
forward's logits, prefill's logits and caches and greedy decode steps
agree to 1e-4 of the largest value on both routes of the port, with the
same tokens; ``serve_demo`` generates the reference driver's sequences from
the same seed.
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
from repro.launch.serve import serve_demo as ref_serve_demo
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro.models import param_shapes as ref_param_shapes
from repro.models import prefill as ref_prefill
from repro.models import transformer as ref_transformer
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels import launches, reset_launches
from repro_torch.launch.serve import ENC_FRAMES, make_prompts, serve_demo
from repro_torch.models import decode_step, forward, param_shapes, prefill
from repro_torch.models import layers, transformer
from repro_torch.models.transformer import _leaves

ARCH = "whisper-small"
TOL = 1e-4
ATTN_TOL = 2e-5
B, S, T, STEPS = 2, 6, 40, 5   # T frames: not a multiple of the kernel's tiles
MAX_LEN = S + STEPS + 4
IMPLS = ["kernel", "plain"]
RNG = np.random.default_rng(20)


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max() / np.abs(want).max())


def _shape_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shape_leaves(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree)}


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_config_is_the_published_one():
    cfg, rcfg = get_config(ARCH), ref_configs.get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(rcfg.reduced())
    red = cfg.reduced()
    assert (red.encdec, red.n_layers, red.n_enc_layers, red.enc_max_len) == (True, 2, 2, 64)
    assert (cfg.n_layers, cfg.n_enc_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.vocab, cfg.enc_max_len) == (12, 12, 768, 12, 3072, 51865, 1500)


@pytest.mark.parametrize("reduced", [False, True], ids=["published", "reduced"])
def test_param_shapes_and_count_match_reference(reduced):
    cfg, rcfg = get_config(ARCH), ref_configs.get_config(ARCH)
    if reduced:
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    assert _shape_leaves(param_shapes(cfg)) == _shape_leaves(ref_param_shapes(rcfg))
    assert "encoder" in param_shapes(cfg) and "cross" in param_shapes(cfg)["layers"]
    assert cfg.param_count() == rcfg.param_count()


# ---------------------------------------------------------------------------
# attention with no mask
# ---------------------------------------------------------------------------


def _both(shape):
    x = RNG.uniform(-1.0, 1.0, shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("sq,skv,h,kv,hd", [
    (40, 40, 4, 2, 16),    # the reduced encoder: ragged
    (6, 40, 4, 2, 16),     # cross-attention at prefill
    (1, 40, 4, 2, 16),     # cross-attention at decode
    (100, 100, 12, 12, 64),  # whisper-small's heads, rep 1, ragged
    (1, 150, 12, 12, 64),  # a decode step over ragged keys
], ids=str)
def test_attention_with_no_mask_matches_the_reference_model_attention(sq, skv, h, kv, hd):
    (qj, q), (kj, k), (vj, v) = (_both(s) for s in
                                 ((2, sq, h, hd), (2, skv, kv, hd), (2, skv, kv, hd)))
    want = ref_layers.attention_scores(qj, kj, vj, None)
    reset_launches()
    got = layers.attention_scores(q, k, v, None, impl="kernel")
    assert launches["flash_attention"] == 0  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)
    plain = layers.attention_scores(q, k, v, None, impl="plain")
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("sq,skv,h,kv", [(64, 64, 4, 4), (32, 96, 4, 2), (96, 32, 8, 2)],
                         ids=str)
def test_non_causal_kernel_route_matches_the_pallas_kernel_in_interpret_mode(sq, skv, h, kv):
    (qj, q), (kj, k), (vj, v) = (_both(s) for s in
                                 ((2, h, sq, 64), (2, kv, skv, 64), (2, kv, skv, 64)))
    want = ref_flash_attention(qj, kj, vj, causal=False, bq=32, bk=32, interpret=True)
    got = layers.attention_scores(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  None).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)


def test_kernel_route_refuses_a_boolean_mask_tensor():
    q = torch.zeros(1, 4, 4, 16)
    with pytest.raises(ValueError, match="CausalMask or None"):
        layers.attention_scores(q, q, q, torch.ones(4, 4, dtype=torch.bool))
    out = layers.attention_scores(q, q, q, torch.ones(4, 4, dtype=torch.bool), impl="plain")
    assert out.shape == q.shape


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


def _ones_scales(nparams):
    """Every layernorm scale set to ones (the layernorm's own init)."""
    for tree in (nparams, nparams["encoder"]):
        tree["final_norm"]["scale"] = np.ones_like(tree["final_norm"]["scale"])
        for name, group in tree["layers"].items():
            if name.startswith("norm"):
                group["scale"] = np.ones_like(group["scale"])
    return nparams


@pytest.fixture(scope="module")
def whisper():
    rcfg = ref_configs.get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    nparams = _ones_scales(jax.tree.map(np.array, ref_init_params(rcfg, jax.random.PRNGKey(0))))
    rparams = jax.tree.map(jnp.asarray, nparams)
    params = params_from_jax(nparams, device="cpu")
    rng = np.random.default_rng(5)
    batch = {"frames": rng.standard_normal((B, T, cfg.d_model)).astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)}
    rbatch = {"frames": jnp.asarray(batch["frames"]),
              "tokens": jnp.asarray(batch["tokens"], jnp.int32)}
    ref = {"enc": np.array(jax.jit(lambda p, f: ref_transformer.encoder_stack(
        rcfg, p["encoder"], f))(rparams, rbatch["frames"]))}
    logits, cache = jax.jit(lambda p, b: ref_prefill(p, b, rcfg, MAX_LEN))(rparams, rbatch)
    ref["prefill"] = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    step = jax.jit(lambda p, t, c: ref_decode_step(p, t, c, rcfg))
    ref["steps"] = []
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    for _ in range(STEPS):
        logits, cache = step(rparams, tok, cache)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        ref["steps"].append((np.asarray(logits), np.asarray(tok)))
    ref["forward"] = np.asarray(jax.jit(lambda p, b: ref_forward(p, b, rcfg)[0])(
        rparams, rbatch))
    return dict(cfg=cfg, rcfg=rcfg, nparams=nparams, rparams=rparams, params=params,
                batch=batch, rbatch=rbatch, ref=ref)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_stack_matches_reference(whisper, impl):
    w = whisper
    got = transformer.encoder_stack(w["cfg"], w["params"]["encoder"],
                                    torch.from_numpy(w["batch"]["frames"]), impl=impl)
    assert got.shape == (B, T, w["cfg"].d_model)
    assert rel_err(got, w["ref"]["enc"]) <= TOL


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_encoder_stack_under_remat_is_bitwise_the_same(whisper, remat):
    w = whisper
    frames = torch.from_numpy(w["batch"]["frames"])
    plain = transformer.encoder_stack(w["cfg"], w["params"]["encoder"], frames)
    again = transformer.encoder_stack(w["cfg"], w["params"]["encoder"], frames, remat=remat)
    assert torch.equal(plain, again)


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


@pytest.mark.parametrize("impl", IMPLS)
def test_cross_attention_sublayer_at_prefill_matches_reference(whisper, impl):
    """Queries from the decoder, keys and values projected from the
    encoder's output with their biases, no rotary embedding."""
    w = whisper
    enc = w["ref"]["enc"]
    h = RNG.standard_normal((B, S, w["cfg"].d_model)).astype(np.float32)
    rlp = _layer(w["rparams"]["layers"]["cross"], 1)
    want, _ = ref_layers.attention_block(rlp, jnp.asarray(h), w["rcfg"], None, None,
                                         kv_x=jnp.asarray(enc), cross=True)
    lp = _layer(w["params"]["layers"]["cross"], 1)
    got, cache = layers.attention_block(lp, torch.from_numpy(h), w["cfg"], None, None,
                                        kv_x=torch.from_numpy(enc), cross=True, impl=impl)
    assert cache is None and rel_err(got, want) <= TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_cross_attention_sublayer_at_decode_matches_reference(whisper, impl):
    """One query over the static cross keys and values prefill cached."""
    w = whisper
    ck, cv = (np.array(w["ref"]["prefill"][1]["layers"][n][1]) for n in ("ck", "cv"))
    h = RNG.standard_normal((B, 1, w["cfg"].d_model)).astype(np.float32)
    rlp = _layer(w["rparams"]["layers"]["cross"], 1)
    want, _ = ref_layers.attention_block(rlp, jnp.asarray(h), w["rcfg"], None, None,
                                         {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                                         cross=True)
    lp = _layer(w["params"]["layers"]["cross"], 1)
    got, _ = layers.attention_block(lp, torch.from_numpy(h), w["cfg"], None, None,
                                    {"k": torch.from_numpy(ck), "v": torch.from_numpy(cv)},
                                    cross=True, impl=impl)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_logits_match_reference(whisper, impl):
    w = whisper
    got, aux = forward(w["params"], _torch_batch(w["batch"]), w["cfg"], impl=impl)
    assert got.shape == (B, S, w["cfg"].vocab) and float(aux) == 0.0
    assert rel_err(got, w["ref"]["forward"]) <= TOL


def test_forward_is_differentiable_through_the_encoder(whisper):
    """The loss reaches the encoder's weights through cross-attention, with
    full remat as with none (bitwise)."""
    w = whisper
    grads = {}
    for remat in ("none", "full"):
        params = {k: v for k, v in w["params"].items()}
        wq = params["encoder"]["layers"]["attn"]["wq"].clone().requires_grad_()
        params["encoder"] = dict(params["encoder"],
                                 layers=dict(params["encoder"]["layers"],
                                             attn=dict(params["encoder"]["layers"]["attn"],
                                                       wq=wq)))
        logits, _ = forward(params, _torch_batch(w["batch"]), w["cfg"], remat=remat)
        (grads[remat],) = torch.autograd.grad(logits.square().mean(), wq)
    assert grads["none"].abs().max() > 0
    assert torch.equal(grads["none"], grads["full"])


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_logits_and_caches_match_reference(whisper, impl):
    w = whisper
    reset_launches()
    logits, cache = prefill(w["params"], _torch_batch(w["batch"]), w["cfg"], MAX_LEN,
                            impl=impl)
    want_logits, want_cache = w["ref"]["prefill"]
    assert logits.shape == (B, 1, w["cfg"].vocab) and cache["pos"] == S
    assert rel_err(logits, want_logits) <= TOL
    for leaf in ("k", "v", "ck", "cv"):
        assert cache["layers"][leaf].shape == want_cache["layers"][leaf].shape, leaf
        assert rel_err(cache["layers"][leaf], want_cache["layers"][leaf]) <= TOL, leaf
    assert cache["layers"]["ck"].shape == (2, B, T, w["cfg"].n_kv_heads, 16)


@pytest.mark.parametrize("impl", IMPLS)
def test_greedy_decode_matches_reference(whisper, impl):
    w = whisper
    logits, cache = prefill(w["params"], _torch_batch(w["batch"]), w["cfg"], MAX_LEN,
                            impl=impl)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    for want_logits, want_tok in w["ref"]["steps"]:
        logits, cache = decode_step(w["params"], tok, cache, w["cfg"], impl=impl)
        assert rel_err(logits, want_logits) <= TOL
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), want_tok)
    assert cache["pos"] == S + STEPS


def test_serve_demo_generates_the_reference_sequences(whisper):
    """The reference driver's frames (16 of them) and prompt tokens from
    one numpy generator, its own init (zero final-norm scales), and the
    weights carried across: the same greedy tokens."""
    seqs_ref = ref_serve_demo(ARCH, batch=2, prompt_len=4, gen=6, seed=0,
                              log_fn=lambda *a: None)
    rparams = ref_init_params(whisper["rcfg"], jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    seqs = serve_demo(whisper["cfg"], batch=2, prompt_len=4, gen=6, seed=0, device="cpu",
                      params=params, log_fn=lambda *a: None)
    np.testing.assert_array_equal(seqs, seqs_ref)


def test_serve_demo_with_the_carried_weights_matches_reference_decode(whisper):
    """serve_demo on the ones-scale weights: its tokens are the greedy tokens
    of the reference's prefill and decode steps on the same prompts."""
    w = whisper
    cfg = w["cfg"]
    prompts = make_prompts(cfg, 2, 4, seed=1)
    rbatch = {"frames": jnp.asarray(prompts["frames"], jnp.float32),
              "tokens": jnp.asarray(prompts["tokens"], jnp.int32)}
    logits, cache = ref_prefill(w["rparams"], rbatch, w["rcfg"], 4 + 6 + 1)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    want = [tok]
    for _ in range(5):
        logits, cache = ref_decode_step(w["rparams"], tok, cache, w["rcfg"])
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        want.append(tok)
    seqs = serve_demo(cfg, batch=2, prompt_len=4, gen=6, seed=1, device="cpu",
                      params=w["params"], log_fn=lambda *a: None)
    np.testing.assert_array_equal(seqs, np.concatenate([np.asarray(t) for t in want], 1))


def test_prompts_draw_frames_then_tokens_from_one_generator():
    cfg = get_config(ARCH).reduced()
    prompts = make_prompts(cfg, 3, 5, seed=4)
    rng = np.random.default_rng(4)
    assert set(prompts) == {"frames", "tokens"} and ENC_FRAMES == 16
    np.testing.assert_array_equal(prompts["frames"],
                                  rng.standard_normal((3, ENC_FRAMES, cfg.d_model)))
    np.testing.assert_array_equal(prompts["tokens"], rng.integers(0, cfg.vocab, (3, 5)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_carries_the_encoder_tree(whisper, dtype):
    """Every leaf of the encoder subtree (and the decoder's cross weights)
    crosses over bit for bit, in the reference's keys and layouts."""
    rcfg = whisper["rcfg"]
    rparams = ref_init_params(rcfg, jax.random.PRNGKey(3), dtype=dtype)
    carried = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    got = list(_leaves(carried["encoder"]))
    want = jax.tree.leaves(rparams["encoder"])
    assert len(got) == len(want) == 15  # 13 stacked layer leaves and the final norm's 2
    for (path, leaf), ref_leaf in zip(got, want):
        assert str(leaf.dtype) == f"torch.{dtype}", path
        ref_np = np.asarray(ref_leaf)
        assert tuple(leaf.shape) == ref_np.shape, path
        if dtype == "bfloat16":
            assert np.array_equal(leaf.view(torch.int16).numpy(), ref_np.view(np.int16)), path
        else:
            assert np.array_equal(leaf.numpy(), ref_np), path
    assert {k: tuple(v.shape) for k, v in carried["layers"]["cross"].items()} == \
        {k: tuple(v.shape) for k, v in rparams["layers"]["cross"].items()}
