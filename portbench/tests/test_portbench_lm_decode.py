"""The ``lm_decode`` kind (``jamba-decode-32``) at its small size on the
host: correct untraced and traced, its per-layer metrics read, its control
and planted faults not correct; its counts against hand arithmetic; and on
the card, the cell once as the benchmark runs it."""
from __future__ import annotations

import json
import subprocess
import sys
from time import perf_counter

import pytest

from conftest import ROOT
from portbench import harness, lm_counts
from portbench.counts import load_peaks

CELL = "jamba-decode-32"


def small_cell(control=False):
    cell = harness.resolve(ROOT, CELL)
    over = dict(cell.kind.SMALL)
    if control:
        over.update(cell.kind.control({**cell.config, **over}))
    return harness.resolve(ROOT, CELL, {"config": over, "traffic": cell.kind.SMALL_TRAFFIC})


def run_small(trace=False, control=False, seed=2 ** 31 + 11):
    return harness.run_cell(small_cell(control), seed, 0.3, trace, "cpu", perf_counter(),
                            load_peaks())


def test_sound_run_is_correct():
    result, lines = run_small()
    assert result["correct"] and result["failed"] == 0, lines
    p95 = {"step_p95_s.host"} if result["attempted"] >= 2 else set()  # a p95 needs 2 steps
    assert set(result["metrics"]) == {"step_s.host", "setup_s"} | p95  # no card: no peak


def test_traced_run_reports_the_cells_per_layer_metrics():
    result, lines = run_small(trace=True)
    assert result["correct"], lines
    wanted = {entry["name"] for entry, _r in small_cell().per_layer}
    # the host has no device operations, so no busy time to share bytes over
    assert set(result["metrics"]) == wanted - {"step_hbm_share"}
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["expert_load_max"] >= 1.0
    assert 0.0 <= m["mamba_idle_ms_per_step"] and 0.0 <= m["moe_idle_ms_per_step"]
    assert 0 < result["device"]["window_s"]


def test_step_hbm_share_reads_bytes_over_the_busy_time():
    reader = harness.load_module(ROOT / "portbench" / "metrics" / "step_hbm_share.py")
    trace = type("Trace", (), {"busy_s": 0.5})()
    obs = harness.Observation(
        steps=10, window_s=2.0, step_times=[0.2] * 10,
        extra={"lm_bytes": {"weights": 1e9, "kv": 5e8}, "expert_bytes": 1e8}, setup_s=1.0,
        memory_peak_bytes=0, loads={"moe0.experts_hit": 20, "moe1.experts_hit": 30},
        launches={}, step_flops=0.0, step_products=[], dtype="bfloat16",
        peaks={"hbm_bytes_per_s": 3.35e12}, trace=trace)
    # (1.5e9 + 50 experts hit x 1e8) bytes over 0.5 s of 3.35 TB/s
    assert reader.read(obs) == pytest.approx(100 * 6.5e9 / (0.5 * 3.35e12))
    obs.trace = None
    assert reader.read(obs) is None


def test_control_is_not_correct():
    result, _ = run_small(control=True)
    assert not result["correct"]
    assert result["checks"]["logit_err"]["value"] > result["checks"]["logit_err"]["limit"]


@pytest.mark.parametrize("fault", ["renormalised_gates", "state_reset_per_chunk",
                                   "router_skips_its_top_choice"])
def test_fault_is_not_correct(fault, monkeypatch):
    """The router's top-2 gates divided by their sum; each prefill chunk
    starting from zero SSM state, as if the chunks were separate prompts; or
    the router taking its 2nd and 3rd choices, each with its own gate (the
    output then matches the reference forced to those choices: only
    ``rerouted_share`` sees it)."""
    from repro_torch.models import moe, transformer

    if fault == "router_skips_its_top_choice":
        real_top = moe._top_k

        def skip_top(probs, k):
            vals, idx = real_top(probs, k + 1)
            return vals[..., 1:], idx[..., 1:]

        monkeypatch.setattr(moe, "_top_k", skip_top)
    elif fault == "renormalised_gates":
        real_route = moe._dropless

        def renormalised(params, x, cfg, gates, choices, counts):
            return real_route(params, x, cfg, gates / gates.sum(-1, keepdim=True), choices,
                              counts)

        monkeypatch.setattr(moe, "_dropless", renormalised)
    else:
        real = transformer.decoder_stack

        def forgetful(cfg, layers, x, positions, mask, caches, cache_pos, *args, **kw):
            if caches is not None and x.shape[1] > 1 and "ssm" in caches:
                caches["ssm"].zero_()
                caches["conv"].zero_()
            return real(cfg, layers, x, positions, mask, caches, cache_pos, *args, **kw)

        monkeypatch.setattr(transformer, "decoder_stack", forgetful)
    result, _ = run_small()
    assert not result["correct"], result["checks"]
    assert result["failed"] > 0


def test_counts_against_hand_arithmetic():
    config = harness.load_json(ROOT / "portbench" / "configs" / "jamba2-mini.json")
    traffic = harness.load_json(ROOT / "portbench" / "traffic" / "sessions-32-ctx1k-16k.json")
    kinds = lm_counts.layer_kinds(config)
    assert kinds[4] == ("attn", "mlp") and kinds[1] == ("mamba", "moe") and len(kinds) == 8
    parts = lm_counts.part_params(config)
    assert parts["attn"] == 4096 * 4096 * 2 + 2 * 4096 * 1024
    assert parts["expert"] == parts["mlp"] == 3 * 4096 * 14336
    # active matmul parameters of the period: 3.16e9 (attention, 7 Mamba, 4 MLP,
    # 4 routers and 2 of 16 experts each, the head)
    flops = lm_counts.step_flops(config, traffic)
    assert flops == pytest.approx(32 * 2 * 3.16e9, rel=0.02)
    window = lm_counts.window_bytes(config, "bfloat16", [1000] * 32, 1)
    assert window["weights"] == pytest.approx(2 * 1.75e9, rel=0.02)
    assert window["kv"] == 32 * 1001 * 2 * 8 * 128 * 2
    assert window["state"] == 2 * 7 * 32 * (8192 * 16 * 4 + 3 * 8192 * 2)
    assert lm_counts.expert_bytes(config, "bfloat16") == 2 * 3 * 4096 * 14336


def test_prompts_repeat_from_the_seed_and_fill_the_range():
    kind = harness.load_module(ROOT / "portbench" / "kinds" / "lm_decode.py")
    traffic = harness.load_json(ROOT / "portbench" / "traffic" / "sessions-32-ctx1k-16k.json")
    seed = 2 ** 31 + 77
    lengths = kind.prompt_lengths(traffic, seed)
    assert lengths == kind.prompt_lengths(traffic, seed) != kind.prompt_lengths(traffic, 5)
    assert len(lengths) == 32 and all(1024 <= n <= 16384 and n % 256 == 0 for n in lengths)


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
