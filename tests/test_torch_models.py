"""The port's LM serving path on the CPU against the reference.

hymba-1.5b reduced to 8 layers (layer 7 is its first global layer under
local_global_ratio 7) at f32, with the reference's own weights
(``repro.models.init_params(cfg, PRNGKey(0))``) carried across with
``params_from_jax``.  Prefill logits and the whole cache (k, v, conv, ssm),
then 8 greedy decode steps, agree to 1e-4 of the largest value with the
same greedy tokens, on both routes of the port (``impl="kernel"``, whose
wrappers run their plain versions on CPU tensors, and ``impl="plain"``);
``serve_demo`` generates the reference's sequences from the same weights;
the published configs have the reference's parameter shapes and counts.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.launch.serve import serve_demo as ref_serve_demo
from repro.models import decode_step as ref_decode_step
from repro.models import init_params as ref_init_params
from repro.models import param_shapes as ref_param_shapes
from repro.models import prefill as ref_prefill
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.launch.serve import serve_demo
from repro_torch.models import (ModelConfig, MoEConfig, SSMConfig, decode_step, forward,
                                init_params, param_shapes, prefill)
from repro_torch.train import make_prefill, make_serve_step

TOL = 1e-4
L, B, S, MAX_LEN, STEPS = 8, 2, 40, 50, 8


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def hymba8():
    rcfg = dataclasses.replace(ref_configs.get_config("hymba-1.5b").reduced(), n_layers=L)
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_layers=L)
    assert not cfg.is_local_layer(7) and cfg.is_local_layer(6)
    rparams = ref_init_params(rcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    logits, cache = jax.jit(lambda p, b: ref_prefill(p, b, rcfg, MAX_LEN))(
        rparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    step = jax.jit(lambda p, t, c: ref_decode_step(p, t, c, rcfg))
    ref = {"prefill": (logits, cache), "steps": []}
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    for _ in range(STEPS):
        logits, cache = step(rparams, tok, cache)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        ref["steps"].append((np.asarray(logits), np.asarray(tok)))
    return cfg, rcfg, rparams, params, tokens, ref


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_prefill_logits_and_cache_match_reference(hymba8, impl):
    cfg, _, _, params, tokens, ref = hymba8
    logits, cache = prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg, MAX_LEN,
                            impl=impl)
    want_logits, want_cache = ref["prefill"]
    assert logits.shape == (B, 1, cfg.vocab) and cache["pos"] == S
    assert rel_err(logits, want_logits) <= TOL
    for name in ("k", "v", "conv", "ssm"):
        assert cache["layers"][name].shape == want_cache["layers"][name].shape
        assert rel_err(cache["layers"][name], want_cache["layers"][name]) <= TOL, name


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_greedy_decode_matches_reference(hymba8, impl):
    cfg, _, _, params, tokens, ref = hymba8
    logits, cache = prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg, MAX_LEN,
                            impl=impl)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    for want_logits, want_tok in ref["steps"]:
        logits, cache = decode_step(params, tok, cache, cfg, impl=impl)
        assert rel_err(logits, want_logits) <= TOL
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), want_tok)
    assert cache["pos"] == S + STEPS


def test_step_builders_give_the_reference_tokens(hymba8):
    cfg, _, _, params, tokens, ref = hymba8
    logits, cache = make_prefill(cfg, max_len=MAX_LEN)(params,
                                                       {"tokens": torch.from_numpy(tokens)})
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    serve_step = make_serve_step(cfg)
    for _, want_tok in ref["steps"][:3]:
        tok, cache = serve_step(params, tok, cache)
        np.testing.assert_array_equal(tok.numpy(), want_tok)


def test_forward_matches_reference(hymba8):
    from repro.models import forward as ref_forward

    cfg, rcfg, rparams, params, tokens, _ = hymba8
    want, _ = jax.jit(lambda p, b: ref_forward(p, b, rcfg))(
        rparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, aux = forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    assert rel_err(got, want) <= TOL and float(aux) == 0.0


def test_serve_demo_generates_the_reference_sequences():
    """Reduced hymba (2 local layers, window 16).  The reference bounds that
    model's cache at the window (ROADMAP Queue 3 (f)), so prompt + gen stays
    inside it here."""
    seqs_ref = ref_serve_demo("hymba-1.5b", batch=2, prompt_len=8, gen=6, seed=0,
                              log_fn=lambda *a: None)
    rcfg = ref_configs.get_config("hymba-1.5b").reduced()
    params = params_from_jax(
        jax.tree.map(np.asarray, ref_init_params(rcfg, jax.random.PRNGKey(0))), device="cpu")
    record = {}
    seqs = serve_demo(get_config("hymba-1.5b").reduced(), batch=2, prompt_len=8, gen=6,
                      seed=0, device="cpu", params=params, record=record,
                      log_fn=lambda *a: None)
    np.testing.assert_array_equal(seqs, seqs_ref)
    assert record["logits"].shape == (6, 2, rcfg.vocab)
    assert record["prefill_s"] > 0 and record["decode_s"] > 0


def test_serve_demo_teacher_forcing_feeds_the_given_tokens():
    """With ``forced`` tokens the decode inputs are those tokens; the plain
    route, forced with the kernel route's picks, gives the same logits."""
    rec_k, rec_p = {}, {}
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_layers=3)
    seqs = serve_demo(cfg, batch=2, prompt_len=20, gen=5, device="cpu", record=rec_k,
                      log_fn=lambda *a: None)
    forced = np.zeros_like(seqs)
    rec_f = {}
    serve_demo(cfg, batch=2, prompt_len=20, gen=5, device="cpu", forced=forced,
               record=rec_f, log_fn=lambda *a: None)
    np.testing.assert_array_equal(rec_f["logits"][0], rec_k["logits"][0])
    assert not np.array_equal(rec_f["logits"][1:], rec_k["logits"][1:])
    plain = serve_demo(cfg, batch=2, prompt_len=20, gen=5, device="cpu", impl="plain",
                       forced=seqs, record=rec_p, log_fn=lambda *a: None)
    np.testing.assert_array_equal(plain, seqs)
    assert np.abs(rec_p["logits"] - rec_k["logits"]).max() <= TOL * np.abs(
        rec_k["logits"]).max()


def test_cache_overflow_raises():
    cfg = get_config("hymba-1.5b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    _, cache = prefill(params, {"tokens": torch.zeros(1, 6, dtype=torch.long)}, cfg, 7)
    _, cache = decode_step(params, torch.zeros(1, 1, dtype=torch.long), cache, cfg)
    with pytest.raises(ValueError, match="KV cache of 7 positions"):
        decode_step(params, torch.zeros(1, 1, dtype=torch.long), cache, cfg)


def test_serve_demo_rejects_params_of_another_model():
    params = init_params(get_config("hymba-1.5b").reduced(), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="params do not fit"):
        serve_demo(dataclasses.replace(get_config("hymba-1.5b").reduced(), n_layers=3),
                   batch=1, prompt_len=4, gen=2, device="cpu", params=params)


def test_init_params_follows_the_reference_scheme():
    cfg = get_config("hymba-1.5b").reduced()
    p = init_params(cfg, torch.Generator().manual_seed(0))
    ssm = p["layers"]["ssm"]
    assert torch.all(p["final_norm"]["scale"] == 0)
    assert torch.all(ssm["D"] == 1) and torch.all(ssm["dt_bias"] == -4.6)
    np.testing.assert_allclose(ssm["A_log"][0, 0].numpy(), np.log(np.arange(1, 9)), rtol=1e-6)
    std = float(p["layers"]["mlp"]["w_up"].std())
    assert abs(std * np.sqrt(cfg.d_model) - 1.0) < 0.05
    again = init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(p["embed"], again["embed"])


def _port_config(rcfg) -> ModelConfig:
    kw = dataclasses.asdict(rcfg)
    if rcfg.moe is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(rcfg.moe))
    if rcfg.ssm is not None:
        kw["ssm"] = SSMConfig(**dataclasses.asdict(rcfg.ssm))
    return ModelConfig(**kw)


def _shape_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shape_leaves(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree)}


@pytest.mark.parametrize("arch", ref_configs.list_archs())
def test_param_shapes_and_counts_match_reference(arch):
    """Shapes only, nothing allocated: every published config of the zoo."""
    rcfg = ref_configs.get_config(arch)
    cfg = _port_config(rcfg)
    assert _shape_leaves(param_shapes(cfg)) == _shape_leaves(ref_param_shapes(rcfg))
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert [cfg.is_local_layer(i) for i in range(cfg.n_layers)] == [
        rcfg.is_local_layer(i) for i in range(rcfg.n_layers)]
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(rcfg.reduced())


def test_full_hymba_config_is_the_published_one():
    cfg, rcfg = get_config("hymba-1.5b"), ref_configs.get_config("hymba-1.5b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert _shape_leaves(param_shapes(cfg)) == _shape_leaves(ref_param_shapes(rcfg))
    assert 1.4e9 < cfg.param_count() < 1.7e9
