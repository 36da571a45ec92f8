"""The port's roofline model against the reference's, on the CPU.

``analytic_step_flops``, ``model_flops`` and ``analytic_hbm_bytes`` equal
the reference's for every config x kind x remat x dispatch mode;
``RooflineTerms`` is equal under the reference's own constants; ``mfu`` is
checked by hand on the H100 table; then the reference's
``tests/test_roofline.py`` analytic cases, as spec.
"""
from __future__ import annotations

import dataclasses
import math

import pytest

import repro.sharding.roofline as ref_roof
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs
from repro_torch.configs import get_config
from repro_torch.sharding import H100_SXM, Hardware
from repro_torch.sharding.roofline import (analytic_hbm_bytes, analytic_step_flops, mfu,
                                           model_flops, roofline)

KINDS = ("train", "prefill", "decode", "long")
SHAPE = {"train": (256, 4096), "prefill": (32, 32768), "decode": (128, 32768),
         "long": (1, 524288)}
REF_HW = Hardware("reference constants", hbm_bytes=16 * 1024**3, hbm_bw=ref_roof.HBM_BW,
                  link_bw=ref_roof.ICI_BW, peak_bf16=ref_roof.PEAK_FLOPS,
                  peak_fp32=ref_roof.PEAK_FLOPS, peak_fp64=ref_roof.PEAK_FLOPS)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", list_archs())
def test_analytic_terms_match_reference(arch, kind):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    B, S = SHAPE[kind]
    assert model_flops(cfg, kind, B, S) == ref_roof.model_flops(ref_cfg, kind, B, S)
    for remat in ("none", "dots", "full"):
        for mode in ("einsum", "gather"):
            assert analytic_step_flops(cfg, kind, B, S, remat, mode) == \
                ref_roof.analytic_step_flops(ref_cfg, kind, B, S, remat, mode)
        for n_dev in (1, 256, 512):
            p_loc = cfg.param_count() / n_dev
            assert analytic_hbm_bytes(cfg, kind, B, S, n_dev, p_loc, remat) == \
                ref_roof.analytic_hbm_bytes(ref_cfg, kind, B, S, n_dev, p_loc, remat)
        got = roofline(cfg, kind, B, S, 256, cfg.param_count() / 256, 1e9, remat, hw=REF_HW)
        want = ref_roof.roofline(ref_cfg, kind, B, S, 256, cfg.param_count() / 256, 1e9,
                                 remat)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.dominant, got.bound_fraction) == (want.dominant, want.bound_fraction)


def test_h100_terms_and_mfu_by_hand():
    """gemma3-4b, 12 layers, 4 x 2048, one card: compute = FLOPs / 989e12,
    memory = bytes / 3.35e12, collective = bytes / 450e9; mfu of a 0.4265 s
    step = 6 N_active tokens / (989e12 x 0.4265)."""
    cfg = dataclasses.replace(get_config("gemma3-4b"), n_layers=12)
    t = roofline(cfg, "train", 4, 2048, 1, 1e9, 4.5e9, "full")
    assert math.isclose(t.compute_s, analytic_step_flops(cfg, "train", 4, 2048, "full")
                        / 989e12)
    assert math.isclose(t.memory_s, analytic_hbm_bytes(cfg, "train", 4, 2048, 1, 1e9, "full")
                        / 3.35e12)
    assert math.isclose(t.collective_s, 0.01)
    want = 6 * cfg.active_param_count() * 4 * 2048 / (989e12 * 0.4265)
    assert math.isclose(mfu(cfg, "train", 4, 2048, 0.4265), want)
    assert math.isclose(mfu(cfg, "train", 4, 2048, 0.4265, n_dev=4, hw=H100_SXM), want / 4)


class TestAnalyticFlops:
    def test_train_flops_scale_with_tokens(self):
        cfg = get_config("gemma-7b")
        f1 = analytic_step_flops(cfg, "train", 64, 4096)
        f2 = analytic_step_flops(cfg, "train", 128, 4096)
        assert f2 == pytest.approx(2 * f1, rel=0.01)

    def test_train_near_6nd(self):
        cfg = get_config("gemma-7b")
        f = analytic_step_flops(cfg, "train", 256, 4096, remat="none")
        mf = model_flops(cfg, "train", 256, 4096)
        assert 0.5 < mf / f < 1.3

    def test_window_reduces_attention_flops(self):
        cfg = get_config("gemma3-4b")
        full = dataclasses.replace(cfg, window=None, local_global_ratio=0)
        assert analytic_step_flops(cfg, "prefill", 8, 32768) < \
            analytic_step_flops(full, "prefill", 8, 32768)

    def test_moe_gather_cheaper_than_einsum(self):
        cfg = get_config("qwen3-moe-235b-a22b")
        e = analytic_step_flops(cfg, "train", 256, 4096, dispatch_mode="einsum")
        g = analytic_step_flops(cfg, "train", 256, 4096, dispatch_mode="gather")
        assert g < e

    def test_decode_flops_linear_not_quadratic(self):
        cfg = get_config("command-r-35b")
        f32k = analytic_step_flops(cfg, "decode", 128, 32768)
        f64k = analytic_step_flops(cfg, "decode", 128, 65536)
        assert f64k < 2.5 * f32k


class TestHBMModel:
    def test_decode_dominated_by_cache_and_weights(self):
        cfg = get_config("command-r-35b")
        b = analytic_hbm_bytes(cfg, "decode", 128, 32768, 256, p_loc=35e9 / 256)
        cache = 40 * 128 * 32768 * 8 * 128 * 2 * 2 / 256
        assert b > cache

    def test_window_bounds_decode_cache_traffic(self):
        cfg = get_config("gemma3-4b")
        full = dataclasses.replace(cfg, window=None, local_global_ratio=0)
        bw = analytic_hbm_bytes(cfg, "decode", 128, 32768, 256, p_loc=1e9)
        bf = analytic_hbm_bytes(full, "decode", 128, 32768, 256, p_loc=1e9)
        assert bw < bf


class TestRooflineTerms:
    def test_dominant_and_fraction(self):
        cfg = get_config("gemma3-4b")
        t = roofline(cfg, "prefill", 32, 32768, 256, p_loc=4e9 / 256, coll_bytes_per_dev=1e9)
        assert t.dominant in ("compute", "memory", "collective")
        assert 0 <= t.bound_fraction <= 1.2

    def test_decode_memory_bound(self):
        cfg = get_config("gemma3-4b")
        t = roofline(cfg, "decode", 128, 32768, 256, p_loc=4e9 / 256, coll_bytes_per_dev=0.0)
        assert t.memory_s > 10 * t.compute_s
