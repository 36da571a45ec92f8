"""The MoE decoders in the port (qwen3-moe-235b-a22b, phi3.5-moe-42b-a6.6b)
on the CPU against the reference, f32, to 1e-4 of the largest value.

``moe_block`` (the reference's ``repro.models.moe.moe_block`` ported):
output and aux loss in both dispatch modes, with drops at capacity 1.25
and at a no-drop capacity, at N = 3000 tokens (the group size halves from
2048 to 8), at N > 2048 (two groups), at one decode step of two rows
(C = 1), and with planted ties among the router's probabilities (a zero
router ties every expert; duplicated columns tie two), where the lower
expert index must come first, as ``jax.lax.top_k`` orders them; its
gradients with respect to the input and every weight.

The models, each ``reduced()`` config with the reference's own weights
carried across with ``params_from_jax`` (phi3.5-moe is a layernorm model:
its norms' scales are set to ones in the weights handed to both packages,
ROADMAP Queue 3 (h)): ``forward``'s logits and aux loss, ``prefill`` and
two ``decode_step``s in both dispatch modes and on both routes; at a
no-drop capacity the decode steps also equal the forward at their
positions (the reference's ``test_models_smoke.py`` check); ``serve_demo``
generates the reference's tokens; the loss and every gradient leaf of
``make_grad_fn`` against ``jax.value_and_grad`` on both routes and in both
modes; three ``make_train_step`` steps against the reference's jitted step
(Adam eps 1e-4, see ``tests/test_torch_train.py``).
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
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models.config import MoEConfig as RefMoEConfig
from repro.models.moe import moe_block as ref_moe_block
from repro.sharding.plans import Plan as RefPlan
from repro.train import AdamConfig as RefAdamConfig
from repro.train import cross_entropy as ref_cross_entropy
from repro.train import init_opt_state as ref_init_opt_state
from repro.train import make_prefill as ref_make_prefill
from repro.train import make_serve_step as ref_make_serve_step
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.launch.serve import make_prompts, serve_demo
from repro_torch.launch.train import batch_to
from repro_torch.models import MoEConfig, decode_step, forward, prefill
from repro_torch.models.moe import moe_block
from repro_torch.models.transformer import _leaves
from repro_torch.sharding.plans import Plan
from repro_torch.train import (AdamConfig, DataConfig, TokenPipeline, init_opt_state,
                               make_grad_fn, make_train_step)

ARCHS = ["qwen3-moe-235b-a22b", "phi3.5-moe-42b-a6.6b"]
MODES = ["einsum", "gather"]
TOL = 1e-4
B, S, STEPS = 2, 24, 2
MAX_LEN = S + STEPS + 2


def rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

#: a wider MoE than reduced()'s 4 experts, top-2: more experts and choices
#: give more collisions at capacity and more ties to order
WIDE = MoEConfig(num_experts=8, top_k=3, d_ff_expert=32)
#: case -> (B, S, capacity factor, router planting)
BLOCK_CASES = {
    "drops": (2, 64, 1.25, "skew"),
    "no-drop": (2, 64, 4.0 * WIDE.num_experts, "skew"),
    "halving-3000": (3, 1000, 1.25, None),
    "groups-4096": (2, 2048, 1.25, None),
    "decode-2": (2, 1, 1.25, "skew"),
    "tied-all": (2, 16, 1.25, "zero"),
    "tied-columns": (2, 64, 1.25, "duplicate"),
}


def _block_setup(case, seed=5):
    Bc, Sc, cf, plant = BLOCK_CASES[case]
    cfg = dataclasses.replace(get_config(ARCHS[0]).reduced(), moe=WIDE)
    rcfg = dataclasses.replace(ref_configs.get_config(ARCHS[0]).reduced(),
                               moe=RefMoEConfig(**dataclasses.asdict(WIDE)))
    D, E, F = cfg.d_model, WIDE.num_experts, WIDE.d_ff_expert
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "w_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    if plant == "zero":
        p["router"][:] = 0.0
    elif plant == "duplicate":  # experts 2 and 5 tie with 1 and 6
        p["router"][:, 2] = p["router"][:, 1]
        p["router"][:, 5] = p["router"][:, 6]
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((Bc, Sc, D))
    if plant == "skew":  # tokens share a mean that expert 0's column favours
        x += 0.5
        p["router"][:, 0] += np.float32(0.5 / np.sqrt(D))
    return cfg, rcfg, p, x.astype(np.float32), cf


def _overflow(p, x, cfg, cf) -> int:
    """Choices past their expert's capacity, counted in numpy (one group:
    the drop cases have N <= 2048)."""
    e = cfg.moe
    probs = x.reshape(-1, x.shape[-1]) @ p["router"]
    picks = np.argsort(-probs, axis=-1, kind="stable")[:, :e.top_k]
    counts = np.bincount(picks.ravel(), minlength=e.num_experts)
    C = max(1, int(np.ceil(e.top_k * len(picks) / e.num_experts * cf)))
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_moe_block_matches_reference(case, mode):
    cfg, rcfg, p, x, cf = _block_setup(case)
    want, want_aux = ref_moe_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x), rcfg, cf,
                                   mode)
    got, aux = moe_block({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                         cfg, cf, mode)
    assert got.shape == x.shape and aux.dtype == torch.float32 and aux.shape == ()
    assert rel(got, want) <= TOL, rel(got, want)
    assert abs(float(aux) - float(want_aux)) <= TOL * abs(float(want_aux))
    if case in ("drops", "tied-all", "decode-2"):  # capacity 1.25 drops choices here
        assert _overflow(p, x, cfg, cf) > 0
        nodrop, _ = moe_block({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), cfg, 4.0 * WIDE.num_experts, mode)
        assert (got - nodrop).abs().max() > 1e-2
    if case == "no-drop":
        assert _overflow(p, x, cfg, cf) == 0 and _overflow(p, x, cfg, 1.25) > 0


def test_tied_router_picks_the_lower_expert_first():
    """With a zero router every expert ties: each token picks experts
    0..K-1, so the top-1 one-hot of the aux loss is expert 0 for every
    token, aux = E * (1/E) * 1 * coef."""
    cfg, _, p, x, _ = _block_setup("tied-all")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _, aux = moe_block(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(float(aux), WIDE.load_balance_coef, rtol=1e-6)
    # the first K experts (and only they) serve every token: zeroing the
    # others' down-projections changes nothing
    cut = dict(tp, w_down=tp["w_down"].clone())
    cut["w_down"][WIDE.top_k:] = 0
    nodrop = 4.0 * WIDE.num_experts
    assert torch.equal(moe_block(cut, torch.from_numpy(x), cfg, nodrop)[0],
                       moe_block(tp, torch.from_numpy(x), cfg, nodrop)[0])


@pytest.mark.parametrize("mode", MODES)
def test_moe_block_gradients_match_reference(mode):
    cfg, rcfg, p, x, cf = _block_setup("drops")
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def ref_loss(pp, xx):
        out, aux = ref_moe_block(pp, xx, rcfg, cf, mode)
        return jnp.sum(out * w) + aux

    want = jax.grad(ref_loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe_block(tp, tx, cfg, cf, mode)
    (torch.sum(out * torch.from_numpy(w)) + aux).backward()
    assert rel(tx.grad, want[1]) <= TOL
    for k in p:
        assert rel(tp[k].grad, want[0][k]) <= TOL, k


def test_unknown_dispatch_mode_raises():
    cfg, _, p, x, cf = _block_setup("decode-2")
    with pytest.raises(ValueError, match="dispatch_mode"):
        moe_block({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), cfg,
                  cf, "scatter")


# ---------------------------------------------------------------------------
# the models against the reference
# ---------------------------------------------------------------------------


def _ref_weights(rcfg):
    """The reference's init (numpy); a layernorm model's scales set to ones
    (under the reference's init its final scale is 0 and every logit 0)."""
    nparams = jax.tree.map(np.array, ref_init_params(rcfg, jax.random.PRNGKey(0)))
    if rcfg.norm == "layernorm":
        for norm in (nparams["final_norm"], nparams["layers"]["norm1"],
                     nparams["layers"]["norm2"]):
            norm["scale"] = np.ones_like(norm["scale"])
    return nparams


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    rcfg, cfg = ref_configs.get_config(arch).reduced(), get_config(arch).reduced()
    nparams = _ref_weights(rcfg)
    rparams = jax.tree.map(jnp.asarray, nparams)
    batch = make_prompts(cfg, B, S, seed=1)
    rbatch = {"tokens": jnp.asarray(batch["tokens"], jnp.int32)}
    ref = {}
    for mode in MODES:
        logits, cache = jax.jit(lambda p, b, m=mode: ref_prefill(
            p, b, rcfg, MAX_LEN, dispatch_mode=m))(rparams, rbatch)
        steps = [np.asarray(logits)]
        for i in range(STEPS):  # teacher-forced with ids from the prompt
            tok = rbatch["tokens"][:, i:i + 1]
            logits, cache = ref_decode_step(rparams, tok, cache, rcfg, dispatch_mode=mode)
            steps.append(np.asarray(logits))
        out, aux = ref_forward(rparams, rbatch, rcfg, dispatch_mode=mode)
        ref[mode] = dict(steps=steps, forward=np.asarray(out), aux=float(aux))
    return dict(arch=arch, cfg=cfg, rcfg=rcfg, nparams=nparams, rparams=rparams,
                params=params_from_jax(nparams, device="cpu"), batch=batch, ref=ref)


@pytest.mark.parametrize("mode", MODES)
def test_forward_logits_and_aux_match_reference(model, mode):
    tokens = {"tokens": torch.from_numpy(model["batch"]["tokens"])}
    got, aux = forward(model["params"], tokens, model["cfg"], dispatch_mode=mode)
    want = model["ref"][mode]
    assert np.abs(want["forward"]).max() > 0
    assert rel(got, want["forward"]) <= TOL
    assert want["aux"] > 0 and abs(float(aux) - want["aux"]) <= TOL * want["aux"]


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_steps_match_reference(model, mode, impl):
    cfg, params = model["cfg"], model["params"]
    tokens = torch.from_numpy(model["batch"]["tokens"])
    logits, cache = prefill(params, {"tokens": tokens}, cfg, MAX_LEN, impl=impl,
                            dispatch_mode=mode)
    got = [logits]
    for i in range(STEPS):
        logits, cache = decode_step(params, tokens[:, i:i + 1], cache, cfg, impl=impl,
                                    dispatch_mode=mode)
        got.append(logits)
    for step, (g, w) in enumerate(zip(got, model["ref"][mode]["steps"])):
        assert g.shape == w.shape and rel(g, w) <= TOL, step


@pytest.mark.parametrize("mode", MODES)
def test_decode_at_a_no_drop_capacity_matches_forward(model, mode):
    """At capacity 4E nothing is dropped, so forward (N = B*S tokens a group)
    and decode (N = B) route alike: prefill of S - 2 tokens and two decode
    steps give the forward's logits at those positions."""
    cfg, params = model["cfg"], model["params"]
    cf = float(cfg.moe.num_experts * 4)
    tokens = torch.from_numpy(model["batch"]["tokens"])
    full, _ = forward(params, {"tokens": tokens}, cfg, dispatch_mode=mode,
                      capacity_factor=cf)
    logits, cache = prefill(params, {"tokens": tokens[:, :S - 2]}, cfg, S + 4,
                            dispatch_mode=mode, capacity_factor=cf)
    assert rel(logits[:, -1], full[:, S - 3].detach()) <= 2e-4
    for pos in (S - 2, S - 1):
        logits, cache = decode_step(params, tokens[:, pos:pos + 1], cache, cfg,
                                    dispatch_mode=mode, capacity_factor=cf)
        assert rel(logits[:, 0], full[:, pos].detach()) <= 2e-4, pos


def _ref_greedy(rcfg, rparams, tokens, gen, mode):
    """The reference driver's greedy loop (``launch/serve.py``) on given
    weights, through its ``make_prefill``/``make_serve_step`` and a plan
    with the dispatch mode."""
    plan = RefPlan("serve_local", batch_axes=(), tp_axis=None, remat="none",
                   dispatch_mode=mode)
    max_len = tokens.shape[1] + gen + 1
    logits, cache = jax.jit(ref_make_prefill(rcfg, plan, max_len=max_len))(
        rparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    out = [tok]
    step = jax.jit(ref_make_serve_step(rcfg, plan))
    for _ in range(gen - 1):
        tok, cache = step(rparams, tok, cache)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("mode", MODES)
def test_serve_demo_generates_the_reference_tokens(model, mode):
    cfg, gen = model["cfg"], 6
    seqs = serve_demo(cfg, batch=2, prompt_len=8, gen=gen, seed=0, device="cpu",
                      params=model["params"], dispatch_mode=mode, log_fn=lambda *a: None)
    tokens = make_prompts(cfg, 2, 8, seed=0)["tokens"]
    want = _ref_greedy(model["rcfg"], model["rparams"], tokens, gen, mode)
    np.testing.assert_array_equal(seqs, want)
    assert len(np.unique(seqs)) > 1  # not the all-zero logits of a zero norm scale


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_demo_on_the_reference_init_matches_its_driver(arch):
    """The reference driver itself (``serve_demo``, its own weights, einsum)."""
    want = ref_serve_demo(arch, batch=2, prompt_len=8, gen=6, seed=0, log_fn=lambda *a: None)
    rcfg = ref_configs.get_config(arch).reduced()
    params = params_from_jax(
        jax.tree.map(np.asarray, ref_init_params(rcfg, jax.random.PRNGKey(0))), device="cpu")
    got = serve_demo(get_config(arch).reduced(), batch=2, prompt_len=8, gen=6, seed=0,
                     device="cpu", params=params, log_fn=lambda *a: None)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

LOCAL = Plan("local", batch_axes=(), tp_axis=None, remat="none")


def _batches(cfg, n):
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=2))
    return [next(pipe) for _ in range(n)]


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("mode", MODES)
def test_loss_and_every_gradient_leaf_match_reference(model, mode, impl):
    rcfg, cfg = model["rcfg"], model["cfg"]
    batch = _batches(cfg, 1)[0]

    def ref_loss(p, b):
        logits, aux = ref_forward(p, b, rcfg, dispatch_mode=mode)
        return ref_cross_entropy(logits, b["labels"]) + aux, aux

    (loss, aux), grads = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(
        model["rparams"], jax.tree.map(jnp.asarray, batch))
    grad_fn = make_grad_fn(cfg, dataclasses.replace(LOCAL, dispatch_mode=mode),
                           compute_dtype="float32", impl=impl)
    got_loss, got_aux, got = grad_fn(model["params"], batch_to(batch, "cpu"))
    assert float(aux) > 0 and abs(float(got_aux) - float(aux)) <= TOL * float(aux)
    assert abs(float(got_loss) - float(loss)) <= TOL * abs(float(loss))
    leaves, want = list(_leaves(got)), jax.tree.leaves(grads)
    assert len(leaves) == len(want) and any(p[0] == "layers" and p[1] == "moe"
                                            for p, _ in leaves)
    for (path, g), w in zip(leaves, want):
        assert g.shape == w.shape, path
        assert rel(g, w) <= TOL, (path, rel(g, w))


@pytest.mark.parametrize("mode", MODES)
def test_train_steps_match_the_reference_jitted_step(model, mode):
    opt_kw = dict(lr=5e-3, warmup_steps=2, total_steps=10, eps=1e-4)
    plan_kw = dict(batch_axes=(), tp_axis=None, remat="none", dispatch_mode=mode)
    ref_step = jax.jit(ref_make_train_step(model["rcfg"], RefPlan("local", **plan_kw),
                                           RefAdamConfig(**opt_kw), compute_dtype="float32"))
    step = make_train_step(model["cfg"], Plan("local", **plan_kw), AdamConfig(**opt_kw),
                           compute_dtype="float32")
    rstate = {"params": model["rparams"], "opt": ref_init_opt_state(model["rparams"])}
    params = params_from_jax(model["nparams"], device="cpu")
    state = {"params": params, "opt": init_opt_state(params)}
    for b in _batches(model["cfg"], 3):
        rstate, rmetrics = ref_step(rstate, jax.tree.map(jnp.asarray, b))
        state, metrics = step(state, batch_to(b, "cpu"))
        assert rel(metrics["loss"], rmetrics["loss"]) <= TOL
        assert rel(metrics["grad_norm"], rmetrics["grad_norm"]) <= TOL
    for (path, got), want in zip(_leaves(state["params"]),
                                 jax.tree.leaves(rstate["params"])):
        assert rel(got, want) <= TOL, (path, rel(got, want))
