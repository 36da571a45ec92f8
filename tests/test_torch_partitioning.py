"""The port's logical-axis rules against the reference's, on the CPU.

``Rules.spec`` equals the reference's ``PartitionSpec`` for the tables
``activation_rules`` builds (every plan x config, on axis-size meshes
1 x 1, 16 x 16 and 2 x 16 x 16); ``placements`` on a fake 2 x 4 mesh;
``constrain`` is the identity outside a rules scope or on a plain tensor;
``gather_weights`` keeps only a weight's tensor-parallel split;
``local_call`` keeps only the splits an op is local in.
"""
from __future__ import annotations

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

import repro.sharding.estimator as ref_est
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs
from repro.sharding.plans import activation_rules as ref_activation_rules
from repro_torch.configs import get_config
from repro_torch.models.partitioning import (Rules, constrain, fit_spec, gather_weights,
                                             get_rules, local_call, use_rules)
from repro_torch.sharding import activation_rules, candidate_plans
from repro_torch.sharding.plans import Plan

MESHES = {"1x1": {"data": 1, "model": 1}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
#: every logical name the model code annotates, in the orders it uses them
NAME_LISTS = [("batch", "seq", "embed"), ("batch", "seq", "heads", None),
              ("batch", "seq", "kv_heads", None), ("batch", "seq", "ff"),
              ("batch", "seq", "vocab"), ("experts", None, "ff"), ("experts", None, "embed"),
              ("batch", "seq", "heads"), ("batch", "seq", "kv_heads"), ("batch", "seq", None),
              ("heads", "ff", "vocab", "experts", "seq", "batch")]


def _ref_plan(plan: Plan):
    from repro.sharding.plans import Plan as RefPlan

    return RefPlan(**{f: getattr(plan, f) for f in plan.__dataclass_fields__})


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_rules_spec_matches_reference(arch, mesh):
    axes = MESHES[mesh]
    fake = ref_est._FakeMesh(tuple(axes.values()), tuple(axes.keys()))
    for kind in ("train", "prefill", "decode", "long"):
        for plan in candidate_plans(get_config(arch), kind):
            for cfg, ref_cfg in ((get_config(arch), ref_get_config(arch)), (None, None)):
                mine = activation_rules(plan, axes, cfg)
                theirs = ref_activation_rules(_ref_plan(plan), fake, ref_cfg)
                assert mine.table == theirs.table, (plan.name, cfg)
                for names in NAME_LISTS:
                    assert mine.spec(*names) == tuple(theirs.spec(*names)), (plan.name, names)


def test_constrain_is_the_identity_without_rules_or_on_plain_tensors():
    x = torch.randn(4, 6)
    assert get_rules() is None
    assert constrain(x, "batch", "embed") is x
    with use_rules(Rules({"data": 2, "model": 2}, {"batch": ("data",)})):
        assert constrain(x, "batch", "embed") is x
    assert get_rules() is None


def test_fit_spec_splits_only_what_the_mesh_divides():
    mesh = {"pod": 2, "data": 4, "model": 2}
    assert fit_spec(mesh, (("pod", "data"), "model", None), (16, 1, 3)) == \
        (("pod", "data"), None, None)
    assert fit_spec(mesh, (("pod", "data"), "model"), (6, 4)) == ("pod", "model")


@pytest.fixture
def fake_mesh():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield make_host_mesh(model_axis=4, device_type="cpu")  # 2 x 4
    finally:
        dist.destroy_process_group()


def test_placements_on_a_fake_mesh(fake_mesh):
    rules = Rules(fake_mesh, {"batch": ("data",), "heads": "model", "ff": ("data", "model"),
                              "seq": "model"})
    assert rules.placements("batch", "seq", "heads") == (Shard(0), Shard(1))
    assert rules.placements("ff", None) == (Shard(0), Shard(0))   # one dim over both axes
    assert rules.placements(None, "embed") == (Replicate(), Replicate())
    x = distribute_tensor(torch.zeros(8, 16, 8), fake_mesh, (Replicate(), Replicate()))
    with use_rules(rules):
        y = constrain(x, "batch", None, "heads")
    assert isinstance(y, DTensor) and tuple(y.placements) == (Shard(0), Shard(2))
    assert tuple(y.to_local().shape) == (4, 16, 2)


def test_local_call_keeps_whole_groups(fake_mesh):
    """Attention's operands split by batch and heads keep both splits when
    the heads divide; kv heads that the model axis does not divide are
    gathered, and the query heads with them."""
    seen = []

    def op(q, k, v):
        seen.append((tuple(q.shape), tuple(k.shape)))
        return q

    dims = ((0, 2), (0, 2), (0, 2))
    q = distribute_tensor(torch.zeros(4, 8, 8, 16), fake_mesh, (Shard(0), Shard(2)))
    k = distribute_tensor(torch.zeros(4, 8, 4, 16), fake_mesh, (Shard(0), Shard(2)))
    out = local_call(op, (q, k, k), dims, dims[:1])
    assert seen[-1] == ((2, 8, 2, 16), (2, 8, 1, 16))
    assert tuple(out.placements) == (Shard(0), Shard(2))
    k2 = distribute_tensor(torch.zeros(4, 8, 2, 16), fake_mesh, (Shard(0), Replicate()))
    out = local_call(op, (q, k2, k2), dims, dims[:1])
    assert seen[-1] == ((2, 8, 8, 16), (2, 8, 2, 16))
    assert tuple(out.placements) == (Shard(0), Replicate())


def test_gather_weights_keeps_only_the_tensor_parallel_split(fake_mesh):
    """ZeRO-3: a weight split over the data axis (FSDP) and the model axis
    (tp) is gathered over data for its use; with no tp axis, fully."""
    w = distribute_tensor(torch.zeros(8, 16), fake_mesh, (Shard(1), Shard(0)))
    b = torch.zeros(3)
    assert gather_weights({"w": w})["w"] is w  # no rules: the identity
    with use_rules(Rules(fake_mesh, {"ff": "model"})):
        got = gather_weights({"w": w, "b": b})
    assert tuple(got["w"].placements) == (Replicate(), Shard(0)) and got["b"] is b
    assert tuple(got["w"].to_local().shape) == (2, 16)
    with use_rules(Rules(fake_mesh, {"ff": None})):
        assert tuple(gather_weights(w).placements) == (Replicate(), Replicate())


@pytest.mark.parametrize("grad", [False, True])
def test_kernel_wrappers_refuse_a_dtensor(fake_mesh, grad):
    """A DTensor handed to a kernel wrapper outside ``local_call`` raises,
    with or without autograd, and is never gathered quietly."""
    from repro_torch.kernels import ops

    def dt(*shape):
        t = distribute_tensor(torch.randn(*shape), fake_mesh, (Shard(0), Replicate()))
        return t.requires_grad_() if grad else t

    with pytest.raises(TypeError, match="got a DTensor"):
        ops.flash_attention(dt(4, 4, 8, 16), dt(4, 2, 8, 16), dt(4, 2, 8, 16))
    with pytest.raises(TypeError, match="got a DTensor"):
        ops.mamba_scan(dt(4, 8, 16, 8), dt(4, 8, 16, 8), dt(4, 8, 8))
