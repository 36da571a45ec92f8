"""Training whisper-small, the encoder-decoder, in the port on the CPU
against the reference.

whisper-small ``reduced()`` (2 encoder + 2 decoder layers, d 64) in f32,
with the reference's own weights carried across by ``params_from_jax`` and
every layernorm scale set to ones in the weights both packages get (under
the reference's init the final norms' scales are zero: ROADMAP Queue 3
(h)); batches carry ``frames`` (B, T, D) beside ``tokens`` and ``labels``,
T ragged against the kernel's tiles.  The loss and every gradient leaf of
``make_grad_fn`` agree with ``jax.value_and_grad`` of the reference's loss
to 1e-4 of the leaf's largest gradient (a key bias, whose exact
gradient is zero, to 1e-4 of its projection's) on both routes of the port
(``impl="kernel"``: the attention forward and backward through the kernel
wrappers, whose plain versions run on CPU tensors); on the kernel route the
backward runs through ``FlashAttention`` for the encoder (no mask), every
decoder layer's self-attention (causal) and its cross-attention (no mask,
Sq != Skv), and the cross-attention's key and value gradients reach the
encoder.  Three ``make_train_step`` steps agree with the reference's jitted
step (Adam eps 1e-4, see ``tests/test_torch_train.py``); remat changes no
bit.  The backward kernels' launch checks take whisper-small's shapes as
published.
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
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels import launches, ops, reset_launches
from repro_torch.kernels.flash_attention_bwd import check_launch
from repro_torch.models.transformer import _leaves
from repro_torch.sharding.plans import Plan
from repro_torch.train import AdamConfig, init_opt_state, make_grad_fn, make_train_step

ARCH = "whisper-small"
TOL = 1e-4
B, S, T = 2, 12, 40     # T frames: not a multiple of the kernel's tiles
LOCAL = Plan("local", batch_axes=(), tp_axis=None, remat="none")


def rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ones_scales(nparams):
    for tree in (nparams, nparams["encoder"]):
        tree["final_norm"]["scale"] = np.ones_like(tree["final_norm"]["scale"])
        for name, group in tree["layers"].items():
            if name.startswith("norm"):
                group["scale"] = np.ones_like(group["scale"])
    return nparams


def _batches(cfg, n, seed=7):
    """n batches of frames and decoder tokens, labels the next token."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, cfg.vocab, (B, S + 1))
        out.append({"frames": rng.standard_normal((B, T, cfg.d_model)).astype(np.float32),
                    "tokens": ids[:, :-1].astype(np.int32),
                    "labels": ids[:, 1:].astype(np.int32)})
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) if k == "frames" else torch.from_numpy(v).long()
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def whisper():
    rcfg = ref_configs.get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    assert cfg.encdec and cfg.dtype == "float32" and T <= cfg.enc_max_len
    nparams = _ones_scales(jax.tree.map(np.array, ref_init_params(rcfg, jax.random.PRNGKey(0))))
    rparams = jax.tree.map(jnp.asarray, nparams)
    batches = _batches(cfg, 3)

    def ref_loss(p, b):
        logits, aux = ref_forward(p, b, rcfg)
        return ref_cross_entropy(logits, b["labels"]) + aux

    loss, grads = jax.jit(jax.value_and_grad(ref_loss))(
        rparams, jax.tree.map(jnp.asarray, batches[0]))
    return dict(cfg=cfg, rcfg=rcfg, nparams=nparams, rparams=rparams, batches=batches,
                loss=loss, grads=grads)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_loss_and_every_gradient_leaf_match_reference(whisper, impl):
    grad_fn = make_grad_fn(whisper["cfg"], LOCAL, compute_dtype="float32", impl=impl)
    reset_launches()
    loss, aux, grads = grad_fn(params_from_jax(whisper["nparams"], device="cpu"),
                               _torch_batch(whisper["batches"][0]))
    assert launches["flash_attention"] == launches["flash_attention_bwd"] == 0  # CPU
    assert float(aux) == 0.0
    assert abs(float(loss) - float(whisper["loss"])) <= TOL * abs(float(whisper["loss"]))
    leaves = list(_leaves(grads))
    want = jax.tree.leaves(whisper["grads"])
    assert len(leaves) == len(want)
    assert {p[0] for p, _ in leaves} >= {"encoder", "layers"}
    tree = dict(zip((p for p, _ in leaves), want))
    for (path, got), w in zip(leaves, want):
        assert got.shape == w.shape, path
        if path[-1] == "bk":
            # softmax over keys is blind to a key bias (q . bk is the same for
            # every key), so its exact gradient is 0 and both sides hold
            # rounding: held against the same projection's weight gradient
            scale = np.abs(np.asarray(tree[path[:-1] + ("wk",)])).max()
            assert max(got.abs().max().item(), np.abs(np.asarray(w)).max()) <= TOL * scale
            continue
        assert np.abs(np.asarray(w)).max() > 0, path
        assert rel(got, w) <= TOL, (path, rel(got, w))


def test_kernel_route_backward_covers_encoder_self_and_cross_attention(whisper, monkeypatch):
    """On the kernel route every attention call goes back through
    ``FlashAttention``: per layer one encoder call (no mask, T x T), one
    decoder self-attention (causal, S x S) and one cross-attention (no mask,
    S x T), whose key and value gradients reach the encoder's weights."""
    cfg = whisper["cfg"]
    calls = []
    real = ops.flash_attention_bwd

    def spy(q, k, v, o, lse, do, **kw):
        calls.append((q.shape[2], k.shape[2], kw["causal"]))
        return real(q, k, v, o, lse, do, **kw)

    monkeypatch.setattr(ops, "flash_attention_bwd", spy)
    _, _, grads = make_grad_fn(cfg, LOCAL, compute_dtype="float32")(
        params_from_jax(whisper["nparams"], device="cpu"), _torch_batch(whisper["batches"][0]))
    want = sorted([(T, T, False)] * cfg.n_enc_layers + [(S, S, True)] * cfg.n_layers
                  + [(S, T, False)] * cfg.n_layers)
    assert sorted(calls) == want
    for name in ("wk", "wv"):  # the decoder's cross keys and values read the encoder
        assert grads["layers"]["cross"][name].abs().max() > 0
    assert grads["encoder"]["layers"]["attn"]["wq"].abs().max() > 0


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_steps_match_the_reference_jitted_step(whisper, remat):
    opt_kw = dict(lr=5e-3, warmup_steps=2, total_steps=10, eps=1e-4)
    plan_kw = dict(batch_axes=(), tp_axis=None, remat=remat)
    ref_step = jax.jit(ref_make_train_step(whisper["rcfg"], RefPlan("local", **plan_kw),
                                           RefAdamConfig(**opt_kw), compute_dtype="float32"))
    step = make_train_step(whisper["cfg"], Plan("local", **plan_kw), AdamConfig(**opt_kw),
                           compute_dtype="float32")
    rstate = {"params": whisper["rparams"], "opt": ref_init_opt_state(whisper["rparams"])}
    params = params_from_jax(whisper["nparams"], device="cpu")
    state = {"params": params, "opt": init_opt_state(params)}
    for b in whisper["batches"]:
        rstate, rmetrics = ref_step(rstate, jax.tree.map(jnp.asarray, b))
        state, metrics = step(state, _torch_batch(b))
        assert rel(metrics["loss"], rmetrics["loss"]) <= TOL
        assert rel(metrics["grad_norm"], rmetrics["grad_norm"]) <= TOL
    for (path, got), want in zip(_leaves(state["params"]),
                                 jax.tree.leaves(rstate["params"])):
        assert rel(got, want) <= TOL, (path, rel(got, want))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradients_bit_for_bit(whisper, remat):
    params = params_from_jax(whisper["nparams"], device="cpu")
    batch = _torch_batch(whisper["batches"][1])
    runs = {}
    for r in ("none", remat):
        runs[r] = make_grad_fn(whisper["cfg"], dataclasses.replace(LOCAL, remat=r),
                               compute_dtype="float32")(params, batch)
    assert torch.equal(runs["none"][0], runs[remat][0])
    for (path, a), (_, b) in zip(_leaves(runs["none"][2]), _leaves(runs[remat][2])):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("sq,skv", [(1500, 1500), (448, 1500), (448, 448)],
                         ids=["encoder", "cross", "decoder-self"])
def test_backward_launch_check_takes_whisper_small_shapes(sq, skv, dtype):
    """rep 1, head dim 64, 1500 keys and Sq != Skv at the published widths
    (shapes only: no tensor is allocated)."""
    cfg = get_config(ARCH)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    assert (H, KV, hd) == (12, 12, 64)
    check_launch(torch.empty((8, H, sq, hd), dtype=dtype, device="meta"),
                 torch.empty((8, KV, skv, hd), dtype=dtype, device="meta"))
