"""The port's dry run (``repro_torch.launch.dryrun``) and input shapes
(``launch/shapes.py``) on a fake world, on the CPU.

A reduced cell on a fake 4 x 2 mesh traces its train step on meta
DTensors: the record has the reference's fields; the per-device parameter
bytes read from the DTensors' local shards equal ``local_param_numel`` x 4
(f32 masters); a tp plan's collectives are nonzero.  The counted FLOPs are
per device: under FSDP over all 8 ranks (every product split 8 ways) 8
times the count agrees with ``analytic_step_flops`` to 10%; under fsdp+tp
the count also holds what the plan replicates over the 2-way model axis, so
it lies between the FSDP cell's and twice that.  ``SHAPES``,
``cell_applicable`` and ``fit_plan_to_mesh`` equal the reference's.
"""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch.distributed as dist

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs
from repro.launch import shapes as ref_shapes
from repro.sharding.estimator import _FakeMesh
from repro_torch.configs import get_config
from repro_torch.launch import shapes
from repro_torch.launch.dryrun import append_record, existing_cells, init_fake_world, run_cell
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import Plan, candidate_plans, local_param_numel
from repro_torch.sharding.roofline import analytic_step_flops

#: the reference's record fields (``repro.launch.dryrun.run_cell``)
REF_FIELDS = {"arch", "shape", "kind", "mesh", "seq", "batch", "variant", "plan",
              "plan_ranking", "compile_s", "memory", "cost", "collectives",
              "collectives_flat", "status"}
CELL = {"kind": "train", "seq": 16, "batch": 8}


@pytest.fixture(scope="module")
def mesh():
    init_fake_world(8)
    try:
        yield make_host_mesh(model_axis=2, device_type="cpu")  # 4 x 2
    finally:
        dist.destroy_process_group()


def test_train_cell_record(mesh, tmp_path):
    cfg = get_config("gemma3-4b").reduced()
    plan = Plan("fsdp_tp", batch_axes=("data",), tp_axis="model", fsdp_axis=("data",),
                remat="none")
    rec = run_cell("gemma3-4b", "tiny", False, plan_override=plan, cfg=cfg, mesh=mesh,
                   shape=CELL)
    assert REF_FIELDS <= set(rec) and rec["status"] == "ok", rec
    assert rec["mesh"] == "4x2" and rec["memory"]["source"] == "estimator"
    axes = {"data": 4, "model": 2}
    assert rec["memory"]["local_param_bytes"] == local_param_numel(cfg, plan, axes) * 4
    coll = rec["collectives"]
    assert coll["total"] > 0 and coll["n_all-reduce"] > 0 and coll == rec["collectives_flat"]
    # per device: at least the FSDP cell's share (each product split 8
    # ways), at most twice it (a product replicated over the model axis)
    fsdp = _fsdp_cell(mesh, cfg, "none")["cost"]["flops"]
    assert fsdp < rec["cost"]["flops"] <= 2 * fsdp, (rec["cost"], fsdp)
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    path = str(tmp_path / "d.jsonl")
    append_record(rec, path)
    append_record({"arch": "x", "shape": "y", "mesh": "z", "status": "error"}, path)
    assert existing_cells(path) == {("gemma3-4b", "tiny", "4x2")}
    json.dumps(rec)


def _fsdp_cell(mesh, cfg, remat):
    plan = Plan("fsdp_all", batch_axes=("data", "model"), tp_axis=None,
                fsdp_axis=("data", "model"), remat=remat)
    return run_cell("gemma3-4b", "tiny", False, plan_override=plan, cfg=cfg, mesh=mesh,
                    shape=CELL)


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_flops_are_per_device(mesh, remat):
    """Under FSDP over all 8 ranks every product is split 8 ways, so 8 times
    the per-device count is the step's: within 10% of the analytic count
    (the plain attention's products over every key, and remat's recompute
    as torch runs it, make the rest)."""
    cfg = get_config("gemma3-4b").reduced()
    rec = _fsdp_cell(mesh, cfg, remat)
    ratio = 8 * rec["cost"]["flops"] / analytic_step_flops(cfg, "train", 8, 16, remat)
    assert 0.9 <= ratio <= 1.1, (rec["cost"], ratio)


@pytest.mark.parametrize("arch,kind", [("hymba-1.5b", "prefill"), ("hymba-1.5b", "decode"),
                                       ("phi3.5-moe-42b-a6.6b", "train"),
                                       ("whisper-small", "train")])
def test_chosen_plan_cells_trace(mesh, arch, kind):
    """Serving and training cells with the plan the optimizer picks (sp and
    ep plans among them) trace, and a tp plan counts collectives."""
    rec = run_cell(arch, "tiny", False, cfg=get_config(arch).reduced(), mesh=mesh,
                   shape={"kind": kind, "seq": 32 if kind != "train" else 16, "batch": 8})
    assert rec["status"] == "ok" and rec["collectives"]["total"] > 0, rec
    assert rec["cost"]["flops"] > 0 and len(rec["plan_ranking"]) == 4


def test_shapes_match_reference():
    assert shapes.SHAPES == ref_shapes.SHAPES
    for arch in list_archs():
        for name in shapes.SHAPES:
            assert shapes.cell_applicable(get_config(arch), name)[0] == \
                ref_shapes.cell_applicable(ref_get_config(arch), name)[0]


@pytest.mark.parametrize("axes", [{"data": 16, "model": 16},
                                  {"pod": 2, "data": 16, "model": 16}, {"data": 8}])
def test_fit_plan_to_mesh_matches_reference(axes):
    from repro.sharding.plans import Plan as RefPlan

    fake = _FakeMesh(tuple(axes.values()), tuple(axes.keys()))
    for arch in list_archs():
        for plan in candidate_plans(get_config(arch), "train"):
            fields = {f: getattr(plan, f) for f in plan.__dataclass_fields__}
            got = shapes.fit_plan_to_mesh(plan, axes)
            want = ref_shapes.fit_plan_to_mesh(RefPlan(**fields), fake)
            assert {f: getattr(got, f) for f in fields} == \
                {f: getattr(want, f) for f in fields}


def test_input_structs_have_the_references_shapes():
    for arch in ("gemma3-4b", "hymba-1.5b", "whisper-small", "qwen2-vl-7b"):
        cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
        for kind in ("train", "prefill"):
            got = shapes.batch_struct(cfg, kind, 4, 32)
            want = ref_shapes.batch_struct(ref_cfg, kind, 4, 32)
            assert {k: tuple(v.shape) for k, v in got.items()} == \
                {k: tuple(v.shape) for k, v in want.items()}
            assert all(v.is_meta for v in got.values())
        got = shapes.train_state_struct(cfg)["params"]
        want = ref_shapes.train_state_struct(ref_cfg)["params"]
        import jax
        from repro_torch.models.transformer import _leaves
        assert [tuple(t.shape) for _, t in _leaves(got)] == \
            [tuple(s.shape) for s in jax.tree.leaves(want)]
        if not cfg.attention_free:
            got = shapes.cache_struct(cfg, 2, 64)["layers"]
            want = ref_shapes.cache_struct(dataclasses.replace(ref_cfg, window=None), 2,
                                           64)["layers"]
            assert {k: tuple(v.shape) for k, v in got.items()} == \
                {k: tuple(v.shape) for k, v in want.items()}
