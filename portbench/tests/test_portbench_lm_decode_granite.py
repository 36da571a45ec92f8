"""The ``lm_decode_granite`` kind (``granite-decode-256``) at its small size on
the host: found by name, correct untraced and traced, its per-layer
metrics read, its control and planted faults not correct; its counts
against hand arithmetic; and on the card, the cell once as the benchmark
runs it."""
from __future__ import annotations

import json
import subprocess
import sys
from time import perf_counter

import pytest
import torch

from conftest import ROOT
from portbench import harness, lm_counts_granite
from portbench.counts import load_peaks

CELL = "granite-decode-256"


def small_cell(control=False):
    cell = harness.resolve(ROOT, CELL)
    over = dict(cell.kind.SMALL)
    if control:
        over.update(cell.kind.control({**cell.config, **over}))
    return harness.resolve(ROOT, CELL, {"config": over, "traffic": cell.kind.SMALL_TRAFFIC})


def run_small(trace=False, control=False, seed=2 ** 31 + 11):
    return harness.run_cell(small_cell(control), seed, 0.3, trace, "cpu", perf_counter(),
                            load_peaks())


def test_the_kind_is_found_by_name():
    cell = harness.resolve(ROOT, CELL)
    assert cell.config["kind"] == "lm_decode_granite" and not harness.missing_protocol(cell.kind)
    assert cell.reference.__name__.endswith("reference_lm_decode_granite")
    assert cell.kind.schedule(cell.config["layer_types"]) == (10, 5)
    cfg = cell.kind.model_config(cell.config)
    assert cfg.n_layers == 10 and cfg.layer_count("ssm") == 9 and cfg.ssm.n_heads == 128
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.shared_d_ff) == (72, 10, 1536)
    per_layer = {entry["name"] for entry, _reader in cell.per_layer}
    assert {"mamba2_idle_ms_per_step", "mamba2_step_roofline", "step_hbm_share",
            "expert_load_max"} <= per_layer and "mamba_idle_ms_per_step" not in per_layer


def test_sound_run_is_correct():
    result, lines = run_small()
    assert result["correct"] and result["failed"] == 0, lines
    assert set(result["checks"]) == {"logit_err", "rerouted_share", "state_err_first",
                                      "state_err_last"}
    p95 = {"step_p95_s.host"} if result["attempted"] >= 2 else set()
    assert set(result["metrics"]) == {"step_s.host", "setup_s"} | p95  # no card: no peak


def test_traced_run_reports_the_cells_per_layer_metrics():
    result, lines = run_small(trace=True)
    assert result["correct"], lines
    wanted = {entry["name"] for entry, _r in small_cell().per_layer}
    # the host has no device operations: no busy time to share bytes over,
    # no device time of the Mamba-2 kernels
    assert set(result["metrics"]) == wanted - {"step_hbm_share", "mamba2_step_roofline"}
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["expert_load_max"] >= 1.0 and 0.0 <= m["mamba2_idle_ms_per_step"]


def test_mamba2_step_roofline_reads_bytes_over_the_kernels_device_time():
    reader = harness.load_module(ROOT / "portbench" / "metrics" / "mamba2_step_roofline.py")

    class Trace:
        def seconds_of(self, parts):
            assert "mamba2_state_kernel" in parts
            return 0.09

    obs = harness.Observation(
        steps=10, window_s=2.0, step_times=[0.2] * 10,
        extra={"mamba2_step_bytes": 2e9, "mamba2_layers": 9}, setup_s=1.0,
        memory_peak_bytes=0, loads={}, launches={"mamba2_step": 90}, step_flops=0.0,
        step_products=[], dtype="bfloat16", peaks={"hbm_bytes_per_s": 3.35e12}, trace=Trace())
    assert reader.read(obs) == pytest.approx(100 * 90 * 2e9 / (0.09 * 3.35e12))
    assert not obs.notes
    obs.launches = {"mamba2_step": 80}
    reader.read(obs)
    assert "80 mamba2_step launches against 90" in obs.notes[0]
    obs.trace = None
    assert reader.read(obs) is None


def test_control_is_not_correct():
    result, _ = run_small(control=True)
    assert not result["correct"]
    assert result["checks"]["logit_err"]["value"] > result["checks"]["logit_err"]["limit"]


@pytest.mark.parametrize("fault", ["state_reset_per_chunk", "shared_expert_dropped",
                                   "residual_multiplier_dropped", "gates_not_renormalised"])
def test_fault_is_not_correct(fault, monkeypatch):
    """Each prefill chunk starting from zero SSM and conv state, as if the
    chunks were separate prompts; the shared expert left out; the sublayers'
    outputs added unscaled; or the top-10 gates taken as the router's
    softmax over all 72 experts, without renormalising them."""
    from repro_torch.models import moe, transformer

    if fault == "state_reset_per_chunk":
        real = transformer.decoder_stack

        def forgetful(cfg, layers, x, positions, mask, caches, cache_pos, *args, **kw):
            if caches is not None and x.shape[1] > 1 and "ssm" in caches:
                caches["ssm"].zero_()
                caches["conv"].zero_()
            return real(cfg, layers, x, positions, mask, caches, cache_pos, *args, **kw)

        monkeypatch.setattr(transformer, "decoder_stack", forgetful)
    elif fault == "shared_expert_dropped":
        monkeypatch.setattr(moe, "_with_shared", lambda params, x, out, cfg: out)
    elif fault == "residual_multiplier_dropped":
        monkeypatch.setattr(transformer, "_residual", lambda cfg, x, out: x + out)
    else:
        real_route = moe._dropless

        def softmax_gates(params, x, cfg, gates, choices, counts):
            probs = torch.softmax(x.float() @ params["router"].float(), dim=-1)
            return real_route(params, x, cfg, probs.gather(1, choices), choices, counts)

        monkeypatch.setattr(moe, "_dropless", softmax_gates)
    result, _ = run_small()
    assert not result["correct"], result["checks"]
    assert result["failed"] > 0


def test_a_first_layer_state_fault_fails_its_own_limit(monkeypatch):
    """The first Mamba-2 layer's state 5% too large in every row, the
    logits untouched: ``state_err_first`` catches it below the last layer's limit,
    whose rounding is ~5x the first's at the cell's size."""
    cell = small_cell()
    real = cell.kind.Job.answers

    def answers(self):
        got = real(self)
        got.states[0] = got.states[0] * 1.05
        return got

    monkeypatch.setattr(cell.kind.Job, "answers", answers)
    result, _ = harness.run_cell(cell, 2 ** 31 + 11, 0.3, False, "cpu", perf_counter(),
                                 load_peaks())
    checks = result["checks"]
    assert not result["correct"] and result["failed"] > 0
    assert checks["state_err_first"]["limit"] < checks["state_err_first"]["value"] \
        < checks["state_err_last"]["limit"]
    assert checks["state_err_last"]["value"] <= checks["state_err_last"]["limit"]


def test_counts_against_hand_arithmetic():
    config = harness.load_json(ROOT / "portbench" / "configs" / "granite-4.0-h-small.json")
    traffic = harness.load_json(ROOT / "portbench" / "traffic" / "sessions-256-ctx128-2k.json")
    kinds = lm_counts_granite.layer_kinds(config)
    assert kinds == ["mamba"] * 5 + ["attn"] + ["mamba"] * 4
    parts = lm_counts_granite.part_params(config)
    assert parts["attn"] == 2 * 4096 * 4096 + 2 * 4096 * 1024
    assert parts["mamba"] == (4096 * (8192 + 8448 + 128) + 5 * 8448 + 3 * 128 + 8192
                              + 8192 * 4096)
    assert parts["expert"] == 3 * 4096 * 768 and parts["shared"] == 3 * 4096 * 1536
    # active matmul parameters of the stage: 9 Mamba-2, 1 attention, 10 routers,
    # shared experts and 10 of 72 experts each, the tied head: 2.509e9
    assert lm_counts_granite.step_flops(config, traffic) == pytest.approx(
        256 * (2 * 2.509e9 + 4 * 32 * 128 * lm_counts_granite.mean_prompt(traffic)), rel=0.01)
    window = lm_counts_granite.window_bytes(config, "bfloat16", [1000] * 256, 1)
    assert window["weights"] == pytest.approx(2 * 1.565e9, rel=0.01)
    assert window["kv"] == 256 * 1001 * 2 * 8 * 128 * 2
    assert window["state"] == 2 * 9 * 256 * (128 * 64 * 128 * 4 + 3 * 8448 * 2)
    assert lm_counts_granite.expert_bytes(config, "bfloat16") == 2 * 3 * 4096 * 768
    assert lm_counts_granite.mamba2_step_bytes(config, "bfloat16", 256) == (
        2 * 4 * 256 * 128 * 64 * 128 + 2 * (256 * (8448 + 128 + 2 * 8192) + 3 * 128 + 8192))


def test_prompts_repeat_from_the_seed_and_fill_the_range():
    kind = harness.load_module(ROOT / "portbench" / "kinds" / "lm_decode_granite.py")
    traffic = harness.load_json(ROOT / "portbench" / "traffic" / "sessions-256-ctx128-2k.json")
    seed = 2 ** 31 + 77
    lengths = kind.lm_decode.prompt_lengths(traffic, seed)
    assert lengths == kind.lm_decode.prompt_lengths(traffic, seed)
    assert len(lengths) == 256 and all(128 <= n <= 2048 and n % 128 == 0 for n in lengths)
    assert 140e3 <= sum(lengths) <= 180e3


@pytest.mark.gpu
def test_the_cell_runs_on_the_card(cuda_device):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
                          str(2 ** 31 + 19), "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"step_s.host", "step_p95_s.host", "setup_s",
                                      "peak_mem_gib"}
