"""The port's training path on the CPU against the reference.

The optimizer (``lr_at``, ``adam_update``, ``global_norm``) on the same
arrays at 1e-6; ``TokenPipeline`` batches bit-identical; then hymba-1.5b
reduced to 8 layers (layer 7 is its first global layer under
local_global_ratio 7) at f32, sequence 40 longer than the window of 16, with
the reference's own weights carried across with ``params_from_jax``: the
loss and every gradient leaf agree with ``jax.value_and_grad`` of the
reference's loss to 1e-4 of the leaf's largest gradient, on both routes of
the port (``impl="kernel"``, whose attention and scan run their plain
forward and backward versions on CPU tensors, and ``impl="plain"``, autograd
through the plain forward); three ``make_train_step`` steps agree with the
reference's jitted step to 1e-4; remat does not change the gradients by a
bit; a resumed ``train_loop`` replays a straight run.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.sharding.plans import Plan as RefPlan
from repro.train import AdamConfig as RefAdamConfig
from repro.train import DataConfig as RefDataConfig
from repro.train import TokenPipeline as RefTokenPipeline
from repro.train import adam_update as ref_adam_update
from repro.train import cross_entropy as ref_cross_entropy
from repro.train import init_opt_state as ref_init_opt_state
from repro.train import lr_at as ref_lr_at
from repro.train import make_train_step as ref_make_train_step
from repro.train.optim import global_norm as ref_global_norm
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.launch.train import batch_to, train_loop
from repro_torch.sharding.plans import Plan
from repro_torch.train import (AdamConfig, DataConfig, TokenPipeline, adam_update,
                               global_norm, init_opt_state, lr_at, make_grad_fn,
                               make_train_step)
from repro_torch.models.transformer import _leaves

TOL = 1e-4
L, B, S = 8, 2, 40
LOCAL = Plan("local", batch_axes=(), tp_axis=None, remat="none")


def rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- optimizer -----------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 100, 150])
def test_lr_at_matches_reference(step):
    cfg = dict(lr=0.3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = lr_at(AdamConfig(**cfg), torch.tensor(step, dtype=torch.int32))
    want = ref_lr_at(RefAdamConfig(**cfg), jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= 1e-6 * max(abs(float(want)), 1e-30)


def _opt_tree(rng):
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "stack": {"scale": rng.normal(size=(3, 4)).astype(np.float32),
                      "bias": rng.normal(size=(7,)).astype(np.float32)}}


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adam_update_matches_reference(weight_decay):
    """Three in-place AdamW steps against the reference's functional ones on
    the same parameters and gradients: weights, moments and metrics at 1e-6
    (the 1-D leaf gets no weight decay, the stacked 2-D ones do)."""
    rng = np.random.default_rng(3)
    params_np = _opt_tree(rng)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=weight_decay,
               grad_clip=1.0)
    rp = jax.tree.map(jnp.asarray, params_np)
    ropt = ref_init_opt_state(rp)
    tp = jax.tree.map(torch.from_numpy, params_np)
    topt = init_opt_state(tp)
    for _ in range(3):
        grads_np = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 3,
                                params_np)
        rp, ropt, rm = ref_adam_update(RefAdamConfig(**cfg), rp, jax.tree.map(
            jnp.asarray, grads_np), ropt)
        tp, topt, tm = adam_update(AdamConfig(**cfg), tp, jax.tree.map(
            torch.from_numpy, grads_np), topt)
        for key in ("grad_norm", "lr"):
            assert rel(tm[key], rm[key]) <= 1e-6
    assert int(topt["step"]) == int(ropt["step"]) == 3
    for tree_t, tree_r in ((tp, rp), (topt["m"], ropt["m"]), (topt["v"], ropt["v"])):
        for (path, got), want in zip(_leaves(tree_t), jax.tree.leaves(tree_r)):
            assert rel(got, want) <= 1e-6, path


def test_global_norm_matches_reference():
    rng = np.random.default_rng(4)
    tree = _opt_tree(rng)
    got = global_norm(jax.tree.map(torch.from_numpy, tree))
    assert rel(got, ref_global_norm(jax.tree.map(jnp.asarray, tree))) <= 1e-6


# -- data -----------------------------------------------------------------------


@pytest.mark.parametrize("corpus", ["pattern", "random"])
def test_token_pipeline_batches_are_bit_identical(corpus):
    kw = dict(vocab=32001, seq_len=48, global_batch=3, corpus=corpus, seed=5)
    mine, theirs = TokenPipeline(DataConfig(**kw)), RefTokenPipeline(RefDataConfig(**kw))
    for _ in range(4):
        a, b = next(mine), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    resumed = TokenPipeline.restore(DataConfig(**kw), mine.state())
    assert np.array_equal(next(resumed)["tokens"], next(theirs)["tokens"])


# -- the model's gradients and train steps -------------------------------------------


@pytest.fixture(scope="module")
def hymba8():
    rcfg = dataclasses.replace(ref_configs.get_config("hymba-1.5b").reduced(), n_layers=L)
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_layers=L)
    assert not cfg.is_local_layer(7) and cfg.is_local_layer(6) and S > cfg.window
    assert cfg.dtype == "float32"
    rparams = ref_init_params(rcfg, jax.random.PRNGKey(0))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=1))
    batches = [next(pipe) for _ in range(3)]

    def ref_loss(p, b):
        logits, aux = ref_forward(p, b, rcfg)
        return ref_cross_entropy(logits, b["labels"]) + aux

    loss, grads = jax.jit(jax.value_and_grad(ref_loss))(
        rparams, jax.tree.map(jnp.asarray, batches[0]))
    return dict(cfg=cfg, rcfg=rcfg, rparams=rparams, batches=batches, loss=loss,
                grads=grads)


def _carried(rparams):
    return params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_loss_and_every_gradient_leaf_match_reference(hymba8, impl):
    grad_fn = make_grad_fn(hymba8["cfg"], LOCAL, compute_dtype="float32", impl=impl)
    loss, aux, grads = grad_fn(_carried(hymba8["rparams"]),
                               batch_to(hymba8["batches"][0], "cpu"))
    assert float(aux) == 0.0
    assert abs(float(loss) - float(hymba8["loss"])) <= TOL * abs(float(hymba8["loss"]))
    leaves = list(_leaves(grads))
    assert len(leaves) == len(jax.tree.leaves(hymba8["grads"])) == 21
    for (path, got), want in zip(leaves, jax.tree.leaves(hymba8["grads"])):
        assert got.shape == want.shape, path
        assert rel(got, want) <= TOL, (path, rel(got, want))


def test_train_steps_match_the_reference_jitted_step(hymba8):
    """Three steps of ``make_train_step`` (f32 compute, remat none) against
    the reference's jitted step from the same state: parameters at 1e-4 of
    each leaf's largest value, and the losses.

    Adam's eps is 1e-4 here, not 1e-8: for |g| >> eps the update is about
    lr * sign(g), so an element whose gradient is at rounding level moves
    +-lr on the sign of its rounding noise.  At eps 1e-8 that alone put wo
    9.5e-4 apart after the first step (relative to max|wo|) with every
    gradient leaf within 1e-4; eps 1e-4 makes the update continuous there,
    and the parameters agree to ~5e-6."""
    opt_kw = dict(lr=5e-3, warmup_steps=2, total_steps=10, eps=1e-4)
    ref_step = jax.jit(ref_make_train_step(hymba8["rcfg"], RefPlan(
        "local", batch_axes=(), tp_axis=None, remat="none"), RefAdamConfig(**opt_kw),
        compute_dtype="float32"))
    step = make_train_step(hymba8["cfg"], LOCAL, AdamConfig(**opt_kw),
                           compute_dtype="float32")
    rstate = {"params": hymba8["rparams"], "opt": ref_init_opt_state(hymba8["rparams"])}
    params = _carried(hymba8["rparams"])
    state = {"params": params, "opt": init_opt_state(params)}
    for b in hymba8["batches"]:
        rstate, rmetrics = ref_step(rstate, jax.tree.map(jnp.asarray, b))
        state, metrics = step(state, batch_to(b, "cpu"))
        assert rel(metrics["loss"], rmetrics["loss"]) <= TOL
        assert rel(metrics["grad_norm"], rmetrics["grad_norm"]) <= TOL
    for (path, got), want in zip(_leaves(state["params"]),
                                 jax.tree.leaves(rstate["params"])):
        assert rel(got, want) <= TOL, (path, rel(got, want))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradients_bit_for_bit(hymba8, remat):
    """Checkpointed layers are recomputed with the same kernels in the same
    order: loss and gradients equal those without remat exactly."""
    cfg = dataclasses.replace(hymba8["cfg"], n_layers=2)
    params = {k: v for k, v in _carried(hymba8["rparams"]).items()}
    params["layers"] = {g: {k: v[:2] for k, v in leaves.items()}
                        for g, leaves in params["layers"].items()}
    batch = batch_to(hymba8["batches"][1], "cpu")
    runs = {}
    for r in ("none", remat):
        grad_fn = make_grad_fn(cfg, dataclasses.replace(LOCAL, remat=r),
                               compute_dtype="float32")
        runs[r] = grad_fn(params, batch)
    assert torch.equal(runs["none"][0], runs[remat][0])
    for (path, a), (_, b) in zip(_leaves(runs["none"][2]), _leaves(runs[remat][2])):
        assert torch.equal(a, b), path


def test_accumulated_microbatches_match_one_batch(hymba8):
    """Two microbatches of one each give the mean gradient of the batch of
    two: the step's loss and parameters agree to 1e-5."""
    cfg = dataclasses.replace(hymba8["cfg"], n_layers=2)
    batch = batch_to(hymba8["batches"][2], "cpu")
    out = {}
    for accum in (1, 2):
        params = init_train_params(cfg)
        step = make_train_step(cfg, dataclasses.replace(LOCAL, accum_steps=accum),
                               AdamConfig(lr=1e-2, warmup_steps=0, total_steps=4),
                               compute_dtype="float32")
        state, metrics = step({"params": params, "opt": init_opt_state(params)}, batch)
        out[accum] = (metrics["loss"], state["params"])
    assert rel(out[2][0], out[1][0].numpy()) <= 1e-5
    for (path, a), (_, b) in zip(_leaves(out[2][1]), _leaves(out[1][1])):
        assert rel(a, b.numpy()) <= 1e-5, path


def init_train_params(cfg):
    from repro_torch.models import init_params

    return init_params(cfg, torch.Generator().manual_seed(0))


# -- the driver and checkpoints ----------------------------------------------------


def test_train_loop_resume_matches_straight_run(tmp_path):
    """Crash/restart fidelity: 6 steps straight == 3 + resume + 3, including
    the data stream (as the reference's test_resume_matches_straight_run)."""
    kw = dict(arch="hymba-1.5b", batch=2, seq=24, lr=5e-3, seed=3, schedule_steps=6,
              log_every=1000, log_fn=lambda *_: None, device="cpu")
    _, straight = train_loop(steps=6, ckpt_dir=None, **kw)
    ck = str(tmp_path / "ck")
    train_loop(steps=3, ckpt_dir=ck, ckpt_every=3, **kw)
    assert latest_step(ck) == 3
    _, resumed = train_loop(steps=6, ckpt_dir=ck, ckpt_every=3, **kw)
    np.testing.assert_allclose(straight[3:], resumed, rtol=1e-4, atol=1e-5)


def test_checkpoint_roundtrip_keep_and_atomic_publish(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"step": torch.tensor(5, dtype=torch.int32)}}
    for s in (1, 2, 3):
        save(str(tmp_path), s, state, meta={"data": {"cursor": s, "seed": 0}}, keep=2)
    (tmp_path / ".tmp-9").mkdir()
    assert latest_step(str(tmp_path)) == 3
    got, meta = restore(str(tmp_path))
    assert np.array_equal(got["params"]["w"], np.arange(6.0).reshape(2, 3))
    assert got["opt"]["step"] == 5 and meta["step"] == 3 and meta["data"]["cursor"] == 3
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path), step=1)  # collected: keep=2


def test_params_from_jax_carries_the_optimizer_state(hymba8):
    """A whole reference train state crosses over: moments as f32, the step
    counter as an int, even when a dtype is asked for the floats."""
    rp = hymba8["rparams"]
    ropt = ref_init_opt_state(rp)
    ropt = {"m": jax.tree.map(lambda a: a + 1.5, ropt["m"]), "v": ropt["v"],
            "step": jnp.asarray(7, jnp.int32)}
    carried = params_from_jax(jax.tree.map(np.asarray, {"params": rp, "opt": ropt}),
                              device="cpu", dtype=torch.float32)
    assert carried["opt"]["step"].dtype == torch.int32 and int(carried["opt"]["step"]) == 7
    for (path, got), want in zip(_leaves(carried["opt"]["m"]), jax.tree.leaves(ropt["m"])):
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want), path
