"""Training gemma3-4b in the port on the CPU against the reference.

gemma3-4b reduced to 6 layers (layers 0-4 local with a window of 16, layer
5 global) at its published head dim, 256, in f32, sequence 40 longer than
the window, with the reference's own weights carried across with
``params_from_jax``: the loss and every gradient leaf agree with
``jax.value_and_grad`` of the reference's loss to 1e-4 of the leaf's
largest gradient on both routes of the port (``impl="kernel"``: attention
forward and backward through the kernel wrappers, whose plain versions run
on CPU tensors); three ``make_train_step`` steps agree with the reference's
jitted step to 1e-4 (Adam eps 1e-4, see ``tests/test_torch_train.py``);
remat does not change the gradients by a bit; ``train_loop`` takes the
``ModelConfig`` itself, and a resumed run replays a straight one.
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
from repro.train import cross_entropy as ref_cross_entropy
from repro.train import init_opt_state as ref_init_opt_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels import launches, reset_launches
from repro_torch.launch.train import batch_to, train_loop
from repro_torch.models.transformer import _leaves
from repro_torch.sharding.plans import Plan
from repro_torch.train import (AdamConfig, DataConfig, TokenPipeline, init_opt_state,
                               make_grad_fn, make_train_step)

ARCH = "gemma3-4b"
TOL = 1e-4
CHANGES = dict(n_layers=6, head_dim=256)
B, S = 2, 40
LOCAL = Plan("local", batch_axes=(), tp_axis=None, remat="none")


def rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def gemma6():
    rcfg = dataclasses.replace(ref_configs.get_config(ARCH).reduced(), **CHANGES)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **CHANGES)
    assert [cfg.is_local_layer(i) for i in range(6)] == [True] * 5 + [False]
    assert cfg.dtype == "float32" and S > cfg.window and cfg.resolved_head_dim == 256
    rparams = ref_init_params(rcfg, jax.random.PRNGKey(0))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=2))
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
def test_loss_and_every_gradient_leaf_match_reference(gemma6, impl):
    grad_fn = make_grad_fn(gemma6["cfg"], LOCAL, compute_dtype="float32", impl=impl)
    reset_launches()
    loss, aux, grads = grad_fn(_carried(gemma6["rparams"]),
                               batch_to(gemma6["batches"][0], "cpu"))
    assert launches["flash_attention"] == launches["flash_attention_bwd"] == 0  # CPU
    assert float(aux) == 0.0
    assert abs(float(loss) - float(gemma6["loss"])) <= TOL * abs(float(gemma6["loss"]))
    leaves = list(_leaves(grads))
    want = jax.tree.leaves(gemma6["grads"])
    assert len(leaves) == len(want) == 13
    for (path, got), w in zip(leaves, want):
        assert got.shape == w.shape, path
        assert rel(got, w) <= TOL, (path, rel(got, w))


def test_train_steps_match_the_reference_jitted_step(gemma6):
    opt_kw = dict(lr=5e-3, warmup_steps=2, total_steps=10, eps=1e-4)
    ref_step = jax.jit(ref_make_train_step(gemma6["rcfg"], RefPlan(
        "local", batch_axes=(), tp_axis=None, remat="none"), RefAdamConfig(**opt_kw),
        compute_dtype="float32"))
    step = make_train_step(gemma6["cfg"], LOCAL, AdamConfig(**opt_kw),
                           compute_dtype="float32")
    rstate = {"params": gemma6["rparams"], "opt": ref_init_opt_state(gemma6["rparams"])}
    params = _carried(gemma6["rparams"])
    state = {"params": params, "opt": init_opt_state(params)}
    for b in gemma6["batches"]:
        rstate, rmetrics = ref_step(rstate, jax.tree.map(jnp.asarray, b))
        state, metrics = step(state, batch_to(b, "cpu"))
        assert rel(metrics["loss"], rmetrics["loss"]) <= TOL
        assert rel(metrics["grad_norm"], rmetrics["grad_norm"]) <= TOL
    for (path, got), want in zip(_leaves(state["params"]),
                                 jax.tree.leaves(rstate["params"])):
        assert rel(got, want) <= TOL, (path, rel(got, want))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradients_bit_for_bit(gemma6, remat):
    """A local and the global layer, each recomputed with the same kernels
    in the same order: loss and gradients equal those without remat."""
    cfg = gemma6["cfg"]
    params = _carried(gemma6["rparams"])
    batch = batch_to(gemma6["batches"][1], "cpu")
    runs = {}
    for r in ("none", remat):
        grad_fn = make_grad_fn(cfg, dataclasses.replace(LOCAL, remat=r),
                               compute_dtype="float32")
        runs[r] = grad_fn(params, batch)
    assert torch.equal(runs["none"][0], runs[remat][0])
    for (path, a), (_, b) in zip(_leaves(runs["none"][2]), _leaves(runs[remat][2])):
        assert torch.equal(a, b), path


def test_train_loop_takes_a_config_and_resume_matches_straight_run(tmp_path):
    """``train_loop`` on the ModelConfig itself (``reduced=False``, as the
    card's run passes gemma3-4b at a cut depth): 4 steps straight equal 2 +
    resume + 2, the data stream included."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **CHANGES)
    kw = dict(batch=2, seq=24, reduced=False, lr=5e-3, seed=3, schedule_steps=4,
              log_every=1000, log_fn=lambda *_: None, device="cpu")
    state, straight = train_loop(cfg, steps=4, **kw)
    assert state["params"]["layers"]["attn"]["wq"].shape == (6, cfg.d_model,
                                                             cfg.n_heads * 256)
    ck = str(tmp_path / "ck")
    train_loop(cfg, steps=2, ckpt_dir=ck, ckpt_every=2, **kw)
    assert latest_step(ck) == 2
    _, resumed = train_loop(cfg, steps=4, ckpt_dir=ck, ckpt_every=2, **kw)
    np.testing.assert_allclose(straight[2:], resumed, rtol=1e-4, atol=1e-5)
    assert all(np.isfinite(straight))
