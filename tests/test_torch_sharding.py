"""The port's sharding plans, load estimator and LSHS plan optimizer
against the reference's, on the CPU.

For every config, every candidate plan of the four kinds and the meshes
1 x 1, 16 x 16 and 2 x 16 x 16 (axis-size dicts): the parameter specs are
the reference's ``PartitionSpec``s as tuples, ``local_param_numel`` is
equal, and every byte count of ``estimate`` equals the reference's to
1e-12 relative.  Given the reference's own device constants (read from
``repro.sharding.estimator``), ``fits``, both objectives and
``choose_plan``'s choice and ranking are equal.  On the H100 table, one
case worked by hand each; then the reference's ``tests/test_sharding.py``
estimator, optimizer and candidate-plan cases, as spec.
"""
from __future__ import annotations

import math

import pytest

import repro.sharding.estimator as ref_est
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs
from repro.sharding.optimizer import choose_plan as ref_choose_plan
from repro.sharding.plans import candidate_plans as ref_candidate_plans
from repro.sharding.plans import batch_specs as ref_batch_specs
from repro.sharding.plans import cache_spec_tree as ref_cache_spec_tree
from repro.sharding.plans import param_spec_tree as ref_param_spec_tree
from repro_torch.configs import get_config
from repro_torch.sharding import (H100_SXM, Hardware, Plan, batch_specs, cache_spec_tree,
                                  candidate_plans, choose_plan, estimate,
                                  local_param_numel, param_spec_tree)
from repro_torch.sharding.plans import P

MESHES = {"1x1": {"data": 1, "model": 1}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
KINDS = ("train", "prefill", "decode", "long")
#: (global batch, sequence) per kind, the dry run's shapes
SHAPE = {"train": (256, 4096), "prefill": (32, 32768), "decode": (128, 32768),
         "long": (1, 524288)}
#: the reference's device constants, under the port's table
REF_HW = Hardware("reference constants", hbm_bytes=ref_est.HBM_BYTES, hbm_bw=ref_est.HBM_BW,
                  link_bw=ref_est.ICI_BW, peak_bf16=ref_est.PEAK_FLOPS,
                  peak_fp32=ref_est.PEAK_FLOPS, peak_fp64=ref_est.PEAK_FLOPS)
MESH_1POD = MESHES["16x16"]
MESH_2POD = MESHES["2x16x16"]


def _ref_plan(plan: Plan):
    """The reference's Plan with the port plan's fields."""
    from repro.sharding.plans import Plan as RefPlan

    return RefPlan(**{f: getattr(plan, f) for f in plan.__dataclass_fields__})


def _spec_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tuple(tree)


def _close(a: float, b: float) -> bool:
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


def test_candidate_plans_are_the_references():
    for arch in list_archs():
        for kind in KINDS:
            mine = candidate_plans(get_config(arch), kind)
            theirs = ref_candidate_plans(ref_get_config(arch), kind)
            assert [_ref_plan(p) for p in mine] == theirs, (arch, kind)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", list_archs())
def test_specs_and_estimates_match_reference(arch, kind, mesh):
    cfg, ref_cfg, axes = get_config(arch), ref_get_config(arch), MESHES[mesh]
    fake = ref_est._FakeMesh(tuple(axes.values()), tuple(axes.keys()))
    B, S = SHAPE[kind]
    for plan in candidate_plans(cfg, kind):
        rp = _ref_plan(plan)
        assert list(_spec_leaves(param_spec_tree(cfg, plan, axes))) == list(
            _spec_leaves(ref_param_spec_tree(ref_cfg, rp, fake))), plan.name
        assert {k: tuple(v) for k, v in ref_batch_specs(ref_cfg, rp, kind).items()} == \
            batch_specs(cfg, plan, kind), plan.name
        ref_cache = ref_cache_spec_tree(ref_cfg, rp)
        cache = cache_spec_tree(cfg, plan)
        assert {k: tuple(v) for k, v in ref_cache["layers"].items()} == cache["layers"]
        assert tuple(ref_cache["pos"]) == cache["pos"]
        assert local_param_numel(cfg, plan, axes) == ref_est.local_param_numel(
            ref_cfg, rp, axes), plan.name
        got = estimate(cfg, plan, axes, kind, B, S, hw=REF_HW)
        want = ref_est.estimate(ref_cfg, rp, axes, kind, B, S)
        for field in ("mem_bytes", "net_in_bytes", "net_out_bytes", "param_bytes",
                      "act_bytes", "cache_bytes"):
            assert _close(getattr(got, field), getattr(want, field)), (plan.name, field)
        assert got.detail.keys() == want.detail.keys()
        assert all(_close(got.detail[k], want.detail[k]) for k in want.detail), plan.name
        assert got.fits == want.fits, plan.name
        for mode in ("paper", "time"):
            assert _close(got.objective(mode), want.objective(mode)), (plan.name, mode)
        h100 = estimate(cfg, plan, axes, kind, B, S)  # byte counts do not read hw
        assert (h100.mem_bytes, h100.net_in_bytes, h100.detail) == \
            (got.mem_bytes, got.net_in_bytes, got.detail)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", list_archs())
def test_choose_plan_matches_reference_under_its_constants(arch, kind, mesh):
    B, S = SHAPE[kind]
    for mode in ("time", "paper"):
        got = choose_plan(get_config(arch), MESHES[mesh], kind, B, S, mode=mode, hw=REF_HW)
        want = ref_choose_plan(ref_get_config(arch), MESHES[mesh], kind, B, S, mode=mode)
        assert _ref_plan(got.plan) == want.plan
        assert [(n, f) for n, _, f in got.ranking] == [(n, f) for n, _, f in want.ranking]
        assert all(_close(a, b) for (_, a, _), (_, b, _) in zip(got.ranking, want.ranking))


# -- the H100 table, worked by hand ---------------------------------------------


def test_h100_table():
    assert H100_SXM.hbm_bytes == 85017493504           # 79.18 GiB as torch reads it
    assert (H100_SXM.hbm_bw, H100_SXM.link_bw) == (3.35e12, 450e9)
    assert (H100_SXM.peak_bf16, H100_SXM.peak_fp32, H100_SXM.peak_fp64) == \
        (989e12, 67e12, 67e12)


def test_h100_fits_and_time_objective_by_hand():
    """gemma3-4b at 12 layers trained at 4 x 2048 on one card under
    fsdp_tp_sp_bf16g: every parameter leaf's elements x (4 + 8 + 2 + 2)
    bytes + 2.5 residual streams of bf16 a layer + the logits (bf16 + f32);
    no network on a 1 x 1 mesh."""
    import dataclasses

    from repro_torch.models import param_shapes
    from repro_torch.models.transformer import _leaves

    cfg = dataclasses.replace(get_config("gemma3-4b"), n_layers=12)
    plan = next(p for p in candidate_plans(cfg, "train") if p.name == "fsdp_tp_sp_bf16g")
    est = estimate(cfg, plan, MESHES["1x1"], "train", 4, 2048)
    n = sum(math.prod(s) for _, s in _leaves(param_shapes(cfg)))
    mem = n * 16 + 12 * 4 * 2048 * cfg.d_model * 2 * 2.5 + 4 * 2048 * cfg.vocab * 6
    assert est.net_in_bytes == 0
    assert math.isclose(est.mem_bytes, mem, rel_tol=1e-12)
    assert est.fits == (mem < 0.92 * 85017493504)
    assert math.isclose(est.objective("time"), mem / 3.35e12, rel_tol=1e-12)


def test_h100_chooses_full_remat_bf16_grads_on_one_card():
    """On a 1 x 1 mesh nothing crosses a link, so the least memory wins:
    full remat with bf16 gradients, for the three models the card trains."""
    import dataclasses

    for cfg, B, S in ((dataclasses.replace(get_config("gemma3-4b"), n_layers=12), 4, 2048),
                      (get_config("hymba-1.5b"), 4, 2048), (get_config("whisper-small"), 8, 448)):
        choice = choose_plan(cfg, MESHES["1x1"], "train", B, S)
        assert choice.plan.name == "fsdp_tp_sp_bf16g" and choice.est.fits, cfg.name
        assert choice.ranking[0][0] == "fsdp_tp_sp_bf16g"


def test_spec_tuples_normalise_as_partition_spec():
    assert P((), ("data",), ("pod", "data"), None) == (None, "data", ("pod", "data"), None)


# -- the reference's tests/test_sharding.py cases, as spec ------------------------


class TestEstimator:
    def test_param_sharding_reduces_local_bytes(self):
        cfg = get_config("gemma-7b")
        dp = local_param_numel(cfg, Plan("dp", tp_axis=None), MESH_1POD)
        tp = local_param_numel(cfg, Plan("tp", tp_axis="model"), MESH_1POD)
        ftp = local_param_numel(
            cfg, Plan("ftp", tp_axis="model", fsdp_axis=("data",)), MESH_1POD)
        assert dp > tp > ftp
        assert dp == pytest.approx(cfg.param_count(), rel=0.01)
        assert ftp < cfg.param_count() / 128

    def test_ep_shards_expert_weights(self):
        cfg = get_config("qwen3-moe-235b-a22b")
        ep = local_param_numel(
            cfg, Plan("ep", tp_axis="model", ep=True, fsdp_axis=("data",)), MESH_1POD)
        assert ep < cfg.param_count() / 100

    def test_memory_terms_scale_with_pod_count(self):
        cfg = get_config("command-r-35b")
        plan = Plan("fsdp_tp", tp_axis="model", fsdp_axis=("pod", "data"))
        e1 = estimate(cfg, plan, MESH_1POD, "train", 256, 4096)
        e2 = estimate(cfg, plan, MESH_2POD, "train", 256, 4096)
        assert e2.param_bytes < e1.param_bytes

    def test_cache_sp_bounds_long_context(self):
        cfg = get_config("gemma3-4b")
        base = estimate(cfg, Plan("tp", tp_axis="model"), MESH_1POD, "long", 1, 524288)
        sp = estimate(cfg, Plan("sp", tp_axis="model", cache_sp=True), MESH_1POD,
                      "long", 1, 524288)
        assert sp.cache_bytes < base.cache_bytes


class TestPlanOptimizer:
    def test_rejects_oom_plans(self):
        cfg = get_config("command-r-35b")
        choice = choose_plan(cfg, MESH_1POD, "train", 256, 4096)
        assert choice.plan.name != "dp"
        assert choice.est.fits

    def test_moe_plan_fits_and_avoids_einsum_tp(self):
        cfg = get_config("phi3.5-moe-42b-a6.6b")
        choice = choose_plan(cfg, MESH_1POD, "train", 256, 4096)
        assert choice.est.fits
        bad = (choice.plan.tp_axis and not choice.plan.ep
               and choice.plan.dispatch_mode == "einsum")
        assert not bad, choice.plan

    def test_qwen3_fits_one_h100_pod(self):
        """The reference's qwen3 finding is that 235B with f32 Adam does not
        fit one pod of 16 GiB devices; 256 cards of 79 GiB hold it under
        both meshes."""
        cfg = get_config("qwen3-moe-235b-a22b")
        assert choose_plan(cfg, MESH_1POD, "train", 256, 4096).est.fits
        assert choose_plan(cfg, MESH_2POD, "train", 256, 4096).est.fits
        assert not choose_plan(cfg, MESH_1POD, "train", 256, 4096, hw=REF_HW).est.fits

    def test_decode_plans_fit(self):
        for arch in ("command-r-35b", "gemma3-4b", "falcon-mamba-7b"):
            choice = choose_plan(get_config(arch), MESH_1POD, "decode", 128, 32768)
            assert choice.est.fits, arch

    def test_paper_mode_objective_is_eq2_sum(self):
        cfg = get_config("gemma3-4b")
        est = estimate(cfg, Plan("tp", tp_axis="model"), MESH_1POD, "decode", 128, 32768)
        assert est.objective("paper") == pytest.approx(
            est.mem_bytes + est.net_in_bytes + est.net_out_bytes)


class TestCandidatePlans:
    def test_moe_space_includes_ep(self):
        names = {p.name for p in candidate_plans(get_config("qwen3-moe-235b-a22b"), "train")}
        assert any("ep" in n for n in names)

    def test_serving_space_includes_cache_sp(self):
        names = {p.name for p in candidate_plans(get_config("gemma3-4b"), "long")}
        assert "serve_tp_cachesp" in names

    def test_describe_is_the_references(self):
        for kind in KINDS:
            for plan in candidate_plans(get_config("qwen3-moe-235b-a22b"), kind):
                assert plan.describe() == _ref_plan(plan).describe()
