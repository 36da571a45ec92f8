"""Multi-pod dry run (counterpart of ``repro.launch.dryrun``): trace every
(arch x shape x mesh) cell's step on a fake world, with no device.

For each cell: choose a sharding plan with the LSHS plan optimizer, build
the step function (train step / prefill / serve step), run it once on
``meta`` DTensors distributed by the plan over the production mesh of a
fake process group (``init_process_group("fake")``: 256 or 512 ranks in
one process, collectives that move nothing), and append a record to a
resumable JSONL file.  The reference lowers and compiles each cell for 512
host devices and reads XLA's analyses; here

  * ``collectives`` counts the collectives the step issued on this rank
    (``sharding.collectives.CollectiveCounter``); the layer loop is Python,
    so ``collectives_flat`` is the same dict;
  * ``cost.flops`` counts the FLOPs of this rank's ops at their local
    shapes (:class:`DeviceFlopCounter`, ``FlopCounterMode``'s per-op
    formulas): per device, as XLA's cost analysis of the partitioned module
    gives the reference's, the attention inside ``local_map`` included;
  * ``memory`` is the estimator's (``"source": "estimator"``): torch has no
    compiler memory analysis on meta tensors; ``local_param_bytes`` is read
    from the parameters' local shards;
  * ``roofline`` holds the H100 roofline terms of the cell.

Every number is a count from shapes, not a measurement of a device.

    python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import make_production_mesh, mesh_axis_sizes
from repro_torch.launch.shapes import (SHAPES, batch_struct, cache_struct, cell_applicable,
                                       fit_plan_to_mesh, param_struct, train_state_struct)
from repro_torch.models import use_rules
from repro_torch.models.partitioning import fit_spec, spec_placements
from repro_torch.models.transformer import _leaves
from repro_torch.sharding.collectives import CollectiveCounter
from repro_torch.sharding.estimator import estimate, local_param_numel
from repro_torch.sharding.optimizer import choose_plan
from repro_torch.sharding.plans import Plan, activation_rules, batch_specs, shard_tree
from repro_torch.sharding.roofline import roofline
from repro_torch.train import AdamConfig, make_prefill, make_serve_step, make_train_step

ARTIFACT = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                        "dryrun_torch.jsonl")


def init_fake_world(n: int) -> None:
    """A process group of ``n`` ranks in this process (rank 0), whose
    collectives move nothing: enough to build meshes and DTensors."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


class DeviceFlopCounter(TorchDispatchMode):
    """FLOPs of the ops this rank runs, at their local shapes.

    ``FlopCounterMode`` sees a DTensor op at its global shape but the ops
    inside ``local_map`` at one rank's; here a DTensor op passes to DTensor
    (as in ``CollectiveCounter``), so that the ops it runs on local shards
    come back through this mode and every op is counted on the shard this
    rank holds.  DTensor runs an op once more at its global shape on fake
    tensors to learn the output's shape (cached, so only an op's first call
    does); that run is not counted.  Each op's count is
    ``FlopCounterMode``'s formula."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None and not any(issubclass(t, FakeTensor) for t in types):
            self.flops += count(*args, **kwargs, out_val=out)
        return out


def _shrink_batch_axes(plan: Plan, mesh_axes: Dict[str, int], B: int) -> Plan:
    kept = []
    size = 1
    for a in plan.batch_axes:
        if B % (size * mesh_axes.get(a, 1)) == 0:
            kept.append(a)
            size *= mesh_axes.get(a, 1)
    return dataclasses.replace(plan, batch_axes=tuple(kept))


def _distribute(batch, cfg, plan, kind, mesh):
    specs = batch_specs(cfg, plan, kind)
    return {k: distribute_tensor(v, mesh, spec_placements(mesh, fit_spec(mesh, specs[k],
                                                                         v.shape)))
            for k, v in batch.items()}


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size() for _, t in _leaves(tree)
               if isinstance(t, DTensor))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             plan_override: Optional[Plan] = None, plan_mode: str = "time",
             variant: str = "baseline", *, cfg=None, mesh=None,
             shape: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One cell's record.  The process group must be initialised with as
    many ranks as the mesh has (``init_fake_world``).  ``cfg``, ``mesh`` and
    ``shape`` ({"kind", "seq", "batch"}) replace the arch's config, the
    production mesh and ``SHAPES[shape_name]`` (a small cell)."""
    cfg = cfg or get_config(arch)
    info = shape or SHAPES[shape_name]
    kind, S, B = info["kind"], info["seq"], info["batch"]
    ok, why = cell_applicable(cfg, shape_name)
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod,
                                                              device_type="cpu")
    mesh_axes = mesh_axis_sizes(mesh)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": "x".join(str(n) for n in mesh_axes.values()),
        "seq": S, "batch": B, "variant": variant,
    }
    if not ok:
        rec.update({"status": "skipped", "reason": why})
        return rec

    t0 = time.time()
    if plan_override is not None:
        plan = fit_plan_to_mesh(plan_override, mesh_axes)
        ranking = []
    else:
        choice = choose_plan(cfg, mesh_axes, kind, B, S, mode=plan_mode)
        plan = fit_plan_to_mesh(choice.plan, mesh_axes)
        ranking = choice.ranking[:4]
    if B < math.prod(mesh_axes.get(a, 1) for a in plan.batch_axes):
        # batch too small for the full DP extent: shrink the plan's batch axes
        plan = _shrink_batch_axes(plan, mesh_axes, B)
    rules = activation_rules(plan, mesh, cfg)
    rec["plan"] = plan.describe()
    rec["plan_ranking"] = ranking

    counter, flops = CollectiveCounter(), DeviceFlopCounter()
    if kind == "train":
        state = shard_tree(train_state_struct(cfg), cfg, plan, mesh)
        local = _local_bytes(state["params"])
        batch = _distribute(batch_struct(cfg, kind, B, S), cfg, plan, kind, mesh)
        step = make_train_step(cfg, plan, AdamConfig(), rules)
        with counter, flops:
            step(state, batch)
    elif kind == "prefill":
        params = shard_tree(param_struct(cfg), cfg, plan, mesh)
        local = _local_bytes(params)
        batch = _distribute(batch_struct(cfg, kind, B, S), cfg, plan, kind, mesh)
        with counter, flops:
            make_prefill(cfg, max_len=S, rules=rules)(params, batch)
    else:  # decode / long: one new token at the last position of a seq_len cache
        params = shard_tree(param_struct(cfg), cfg, plan, mesh)
        local = _local_bytes(params)
        with use_rules(rules):
            cache = cache_struct(cfg, B, S)
        cache["pos"] = S - 1
        tokens = batch_struct(cfg, "prefill", B, 1)["tokens"]
        tokens = distribute_tensor(tokens, mesh, spec_placements(
            mesh, fit_spec(mesh, (plan.batch_axes,), tokens.shape)))
        with counter, flops:
            make_serve_step(cfg, rules=rules, dispatch_mode=plan.dispatch_mode)(
                params, tokens, cache)
    rec["compile_s"] = round(time.time() - t0, 1)

    est = estimate(cfg, plan, mesh_axes, kind, B, S)
    rec["memory"] = {"source": "estimator", "peak_bytes": est.mem_bytes,
                     "param_bytes": est.param_bytes, "act_bytes": est.act_bytes,
                     "cache_bytes": est.cache_bytes, "local_param_bytes": local}
    rec["cost"] = {"flops": flops.flops, "bytes_accessed": None,
                   "transcendentals": None}
    rec["collectives"] = counter.result()
    rec["collectives_flat"] = dict(rec["collectives"])
    n_dev = mesh.size()
    terms = roofline(cfg, kind, B, S, n_dev, local_param_numel(cfg, plan, mesh_axes),
                     rec["collectives"]["total"], plan.remat, plan.dispatch_mode)
    rec["roofline"] = {**dataclasses.asdict(terms), "dominant": terms.dominant,
                       "bound_fraction": terms.bound_fraction, "hw": "H100_SXM"}
    rec["status"] = "ok"
    return rec


def append_record(rec: Dict[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def existing_cells(path: str):
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
    return done


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--artifact", default=os.path.abspath(ARTIFACT))
    args = ap.parse_args()

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    done = set() if args.force else existing_cells(args.artifact)

    for multi_pod in meshes:
        init_fake_world(512 if multi_pod else 256)
        mesh_name = "2x16x16" if multi_pod else "16x16"
        for arch in archs:
            for shape in shapes:
                if (arch, shape, mesh_name) in done:
                    print(f"[skip-done] {arch} {shape} {mesh_name}")
                    continue
                print(f"[dryrun] {arch} {shape} {mesh_name} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, multi_pod)
                except Exception as ex:  # one cell's failure is its record
                    rec = {
                        "arch": arch, "shape": shape, "mesh": mesh_name,
                        "status": "error", "error": f"{type(ex).__name__}: {ex}",
                        "trace": traceback.format_exc()[-2000:],
                    }
                append_record(rec, args.artifact)
                extra = rec.get("reason") or rec.get("error") or ""
                print(f"  -> {rec.get('status')} {extra} "
                      f"({rec.get('compile_s', '?')}s, plan={rec.get('plan', '-')})",
                      flush=True)
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
