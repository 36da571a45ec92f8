"""The port's sharded path on 8 CPU ranks (``torch.distributed`` with gloo)
against the reference.

Each case spawns 8 processes (one per rank, a ``FileStore`` under
``tmp_path``), each importing only torch and the port; the test process
runs the reference in JAX where a case compares with it.  A case's ranks
are joined within ``SPAWN_TIMEOUT`` seconds and killed past it.

The reference's own sharded tests fail on this tree (jax 0.9.0 against
``jax<0.5``, ROADMAP Queue 3 (c)), so the sharded step is held to the
reference's single-device step (``Plan('local', remat='dots')``), with the
limits of the reference's ``tests/test_distributed.py``: the loss to 5e-3
and the embedding after one update to 5e-2.  Those limits cannot see the
backward (one AdamW step moves an element by at most about lr), so the
sharded gradient itself, every leaf gathered at f32, is held to
``jax.value_and_grad`` of the reference's loss on the same weights and
batch to 1e-4 of each leaf's largest element.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as ref_get_config
from repro.models import forward as ref_forward
from repro.sharding.plans import Plan as RefPlan
from repro.train import AdamConfig as RefAdamConfig
from repro.train import cross_entropy as ref_cross_entropy
from repro.train import init_train_state as ref_init_train_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch.checkpoint import save

ROOT = Path(__file__).resolve().parents[1]
RANKS = 8
SPAWN_TIMEOUT = 90  # s; a case took up to 45 s beside the rest of the suite

PROLOGUE = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.partitioning import spec_placements
from repro_torch.sharding.collectives import CollectiveCounter
from repro_torch.sharding.plans import Plan, activation_rules, batch_specs, shard_tree
from repro_torch.train import AdamConfig, init_opt_state, make_train_step

def tree_to_torch(tree):
    return {k: tree_to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v))
            for k, v in tree.items()}

def shard_batch(batch, cfg, plan, mesh):
    specs = batch_specs(cfg, plan, "train")
    return {k: distribute_tensor(torch.from_numpy(np.asarray(v, np.int64)), mesh,
                                 spec_placements(mesh, specs[k])) for k, v in batch.items()}

def report(**kw):
    if rank == 0:
        print("RESULT " + json.dumps(kw), flush=True)
"""


def spawn(code: str, tmp_path: Path, n: int = RANKS) -> dict:
    """Run ``code`` (after PROLOGUE) on ``n`` gloo ranks; rank 0's RESULT."""
    script = tmp_path / "rank.py"
    script.write_text(PROLOGUE + textwrap.dedent(code) + "\ndist.destroy_process_group()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(n), store],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(tmp_path)) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT))
    finally:
        for p in procs:  # a hung rank must not outlive its case
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exit {p.returncode}\n{out}\n{err[-4000:]}"
    line = next(l for l in outs[0][0].splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _ref_batch(cfg, shape=(8, 16), seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, shape).astype(np.int32)}


def test_fsdp_tp_step_matches_reference_single_device(tmp_path):
    """The train step under fsdp+tp on a 4 x 2 mesh against the reference's
    single-device step from the same weights and batch: loss to 5e-3, the
    embedding after the update to 5e-2, with nonzero collectives; and the
    sharded gradient (f32 compute) against ``jax.value_and_grad`` of the
    reference's loss: the loss and every leaf to 1e-4."""
    cfg = ref_get_config("gemma3-4b").reduced()
    opt = RefAdamConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    state = ref_init_train_state(cfg, jax.random.PRNGKey(0))
    batch = _ref_batch(cfg)
    jbatch = jax.tree.map(jnp.asarray, batch)

    def ref_loss(p, b):
        logits, aux = ref_forward(p, b, cfg)
        return ref_cross_entropy(logits, b["labels"]) + aux

    ref_l, ref_g = jax.jit(jax.value_and_grad(ref_loss))(state["params"], jbatch)
    plan0 = RefPlan("local", batch_axes=(), tp_axis=None, remat="dots")
    s0, m0 = jax.jit(ref_make_train_step(cfg, plan0, opt))(state, jbatch)
    save(str(tmp_path / "w"), 0, {"params": _np_tree(state["params"]), "batch": batch})
    np.save(tmp_path / "embed.npy", np.asarray(s0["params"]["embed"], np.float32))
    got = spawn("""
        from repro_torch.models.transformer import _leaves
        from repro_torch.train import make_grad_fn
        raw, _ = restore("w")
        cfg = get_config("gemma3-4b").reduced()
        params = tree_to_torch(raw["params"])
        mesh = make_host_mesh(model_axis=2, device_type="cpu")
        plan = Plan("fsdp_tp", batch_axes=("data",), tp_axis="model",
                    fsdp_axis=("data",), remat="dots")
        state = shard_tree({"params": params, "opt": init_opt_state(params)}, cfg, plan, mesh)
        batch = shard_batch(raw["batch"], cfg, plan, mesh)
        rules = activation_rules(plan, mesh, cfg)
        g_loss, _, grads = make_grad_fn(cfg, plan, rules, compute_dtype="float32")(
            state["params"], batch)
        leaves = [(path, g.full_tensor().float().numpy()) for path, g in _leaves(grads)]
        if rank == 0:
            np.savez("grads.npz", *[g for _, g in leaves])
        step = make_train_step(cfg, plan, AdamConfig(lr=1e-2, warmup_steps=2, total_steps=20),
                               rules)
        with CollectiveCounter() as cc:
            state, m = step(state, batch)
        embed = state["params"]["embed"]
        want = np.load("embed.npy")
        report(loss=float(m["loss"]), placements=str(embed.placements),
               embed_delta=float(np.abs(embed.full_tensor().numpy() - want).max()),
               collectives=cc.result(), grad_loss=float(g_loss),
               grad_paths=["/".join(p) for p, _ in leaves])
    """, tmp_path)
    assert abs(got["grad_loss"] - float(ref_l)) <= 1e-4 * abs(float(ref_l)), got
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_g)
    assert got["grad_paths"] == ["/".join(k.key for k in p) for p, _ in flat], got
    with np.load(tmp_path / "grads.npz") as sharded:
        for i, (path, want) in enumerate(zip(got["grad_paths"], jax.tree.leaves(ref_g))):
            want = np.asarray(want, np.float32)
            g = sharded[f"arr_{i}"]
            assert g.shape == want.shape, path
            err = np.abs(g - want).max() / max(np.abs(want).max(), 1e-30)
            assert err <= 1e-4, (path, err)
    delta = abs(got["loss"] - float(m0["loss"]))
    assert delta < 5e-3, (got["loss"], float(m0["loss"]))
    assert got["embed_delta"] < 5e-2, got
    assert got["placements"] == "(Shard(dim=1), Shard(dim=0))", got
    coll = got["collectives"]
    assert coll["total"] > 0 and coll["n_all-gather"] > 0 and coll["n_all-reduce"] > 0, coll


def test_tp_serve_step_runs_kernels_on_local_shards(tmp_path):
    """A reduced hymba-1.5b prefill and decode step under tp on a 4 x 2 mesh:
    nonzero collectives, the attention and the scan called on local shards
    (half the heads and half of d_inner a rank), logits equal to the same
    steps on plain tensors to 1e-5."""
    got = spawn("""
        import dataclasses
        from repro_torch.kernels import ops
        from repro_torch.models import init_params
        from repro_torch.train import make_prefill, make_serve_step
        cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_layers=2)
        params = init_params(cfg, torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (8, 24)))
        mesh = make_host_mesh(model_axis=2, device_type="cpu")
        plan = Plan("serve", batch_axes=("data",), tp_axis="model", remat="none")
        rules = activation_rules(plan, mesh, cfg)
        shapes = {"flash_attention": set(), "mamba_scan": set()}
        for name in shapes:
            real = getattr(ops, name)
            def seen(*a, _real=real, _name=name, **kw):
                shapes[_name].add(tuple(a[0].shape))
                return _real(*a, **kw)
            setattr(ops, name, seen)

        def serve(p, tok, r):
            logits, cache = make_prefill(cfg, max_len=32, rules=r)(p, {"tokens": tok})
            nxt, cache = make_serve_step(cfg, rules=r)(p, tok[:, -1:], cache)
            return logits, nxt

        plain = serve(params, tokens, None)
        sharded_params = shard_tree(params, cfg, plan, mesh)
        tok = distribute_tensor(tokens, mesh, spec_placements(mesh, ("data", None)))
        for name in shapes:
            shapes[name].clear()
        with CollectiveCounter() as cc:
            sharded = serve(sharded_params, tok, rules)
        report(logits_err=float((sharded[0].full_tensor() - plain[0]).abs().max()),
               tokens_equal=bool(torch.equal(sharded[1].full_tensor(), plain[1])),
               shapes={k: sorted(v) for k, v in shapes.items()}, collectives=cc.result())
    """, tmp_path)
    assert got["logits_err"] <= 1e-5, got
    assert got["tokens_equal"], got
    # (B/4, H/2, S, hd) attention, (B/4, S, DI/2, N) scan: this rank's shards
    assert got["shapes"]["flash_attention"] == [[2, 2, 1, 16], [2, 2, 24, 16]], got
    assert got["shapes"]["mamba_scan"] == [[2, 24, 64, 8]], got
    assert got["collectives"]["total"] > 0, got


def test_ep_moe_step_is_finite(tmp_path):
    """A reduced phi3.5-moe train step with the experts split over the model
    axis (ep) on a 4 x 2 mesh: a finite loss, the expert weights sharded on
    their expert dim, and the loss of the same step on plain tensors to
    1e-5."""
    got = spawn("""
        import dataclasses
        from repro_torch.models import init_params
        cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
        params = init_params(cfg, torch.Generator().manual_seed(0))
        batch = {k: np.random.default_rng(i).integers(0, cfg.vocab, (8, 16))
                 for i, k in enumerate(("tokens", "labels"))}
        mesh = make_host_mesh(model_axis=2, device_type="cpu")
        plan = Plan("ep", batch_axes=("data",), tp_axis="model", ep=True, remat="dots")
        opt = AdamConfig()
        plain = make_train_step(cfg, plan, opt)(
            {"params": params, "opt": init_opt_state(params)},
            {k: torch.from_numpy(v) for k, v in batch.items()})[1]
        params = init_params(cfg, torch.Generator().manual_seed(0))
        state = shard_tree({"params": params, "opt": init_opt_state(params)}, cfg, plan, mesh)
        with CollectiveCounter() as cc:
            state, m = make_train_step(cfg, plan, opt, activation_rules(plan, mesh, cfg))(
                state, shard_batch(batch, cfg, plan, mesh))
        report(loss=float(m["loss"]), plain_loss=float(plain["loss"]),
               w_up=str(state["params"]["layers"]["moe"]["w_up"].placements),
               collectives=cc.result())
    """, tmp_path)
    assert np.isfinite(got["loss"]), got
    assert abs(got["loss"] - got["plain_loss"]) <= 1e-5 * abs(got["plain_loss"]), got
    assert got["w_up"] == "(Replicate(), Shard(dim=1))", got
    assert got["collectives"]["total"] > 0, got


def test_checkpoint_remesh_resume(tmp_path):
    """Train 4 steps under fsdp+tp on a 4 x 2 mesh, checkpoint (the DTensors
    gathered), restore onto a 2 x 4 mesh under another plan and continue 2
    steps: the loss trajectory continues (the reference's
    ``TestElasticRemesh`` bound), and the 2 x 4 run's first step equals the
    same step taken on the 4 x 2 mesh to 1e-5."""
    got = spawn("""
        from repro_torch.models import init_params
        from repro_torch.train import DataConfig, TokenPipeline
        cfg = get_config("gemma3-4b").reduced()
        opt = AdamConfig(lr=5e-3, warmup_steps=2, total_steps=20)
        data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=1)

        def build(model_axis, name):
            mesh = make_host_mesh(model_axis=model_axis, device_type="cpu")
            plan = Plan(name, batch_axes=("data",), tp_axis="model",
                        fsdp_axis=("data",), remat="dots")
            return mesh, plan, make_train_step(cfg, plan, opt,
                                               activation_rules(plan, mesh, cfg))

        mesh, plan, step = build(2, "ft2")
        params = init_params(cfg, torch.Generator().manual_seed(0))
        state = shard_tree({"params": params, "opt": init_opt_state(params)}, cfg, plan, mesh)
        pipe = TokenPipeline(data)
        losses = []
        for i in range(4):
            state, m = step(state, shard_batch(next(pipe), cfg, plan, mesh))
            losses.append(float(m["loss"]))
        save("ck", 4, state, meta={"data": pipe.state()})
        nxt = next(pipe)
        _, m5 = step(state, shard_batch(nxt, cfg, plan, mesh))

        raw, meta = restore("ck")
        mesh2, plan2, step2 = build(4, "ft4")
        state2 = shard_tree({"params": tree_to_torch(raw["params"]),
                             "opt": {"m": tree_to_torch(raw["opt"]["m"]),
                                     "v": tree_to_torch(raw["opt"]["v"]),
                                     "step": torch.from_numpy(raw["opt"]["step"])}},
                            cfg, plan2, mesh2)
        pipe2 = TokenPipeline.restore(data, meta["data"])
        resumed = []
        for i in range(2):
            state2, m2 = step2(state2, shard_batch(next(pipe2), cfg, plan2, mesh2))
            resumed.append(float(m2["loss"]))
        report(losses=losses, resumed=resumed, same_mesh_step5=float(m5["loss"]),
               placements=str(state2["params"]["layers"]["mlp"]["w_up"].placements))
    """, tmp_path)
    l4, l6 = got["losses"][-1], got["resumed"][-1]
    assert l6 < l4 + 0.5, got
    assert abs(got["resumed"][0] - got["same_mesh_step5"]) <= 1e-5 * got["same_mesh_step5"], got
    assert got["placements"] == "(Shard(dim=1), Shard(dim=2))", got


def test_train_loop_over_a_world_of_8_matches_one_process(tmp_path):
    """``train_loop`` in an initialised world of 8 ranks shards the state
    and batches by its plan over the host mesh (8 x 1); its losses equal
    the same run in one process without a process group to 1e-5."""
    from repro_torch.launch.train import train_loop
    from repro_torch.sharding import Plan

    kw = dict(steps=3, batch=8, seq=16, lr=5e-3, log_fn=lambda *a: None, device="cpu",
              plan=Plan("fsdp", batch_axes=("data",), tp_axis=None, fsdp_axis=("data",),
                        remat="dots"))
    _, want = train_loop("gemma3-4b", **kw)
    got = spawn("""
        from repro_torch.launch.train import train_loop
        state, losses = train_loop("gemma3-4b", steps=3, batch=8, seq=16, lr=5e-3,
                                   log_fn=lambda *a: None, device="cpu",
                                   plan=Plan("fsdp", batch_axes=("data",), tp_axis=None,
                                             fsdp_axis=("data",), remat="dots"))
        report(losses=losses, embed=str(state["params"]["embed"].placements))
    """, tmp_path)
    assert got["embed"] == "(Shard(dim=0), Replicate())", got  # the 8 x 1 host mesh
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got["losses"], want)), (got, want)
