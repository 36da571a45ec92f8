"""A configuration, a traffic mix, a cell, a metric and a kind of cell added
as new files and new ``BENCHMARK.json`` entries are found by name, with no
file that was there edited; and every kind exports the kind protocol."""
from __future__ import annotations

import hashlib
import json
import shutil

import pytest

from conftest import ROOT, run_small
from portbench import harness

NEW_METRIC = '''"""``steps_seen``: a test metric, the steps of the window."""


def read(obs):
    return float(obs.steps)
'''

#: a kind with no block runtime: one step is the port's attention forward
NEW_KIND = '''"""A test kind that builds no ``ArrayContext``: a step is the port's
``ops.flash_attention`` over q, k, v drawn from the seed (the plain route on
the CPU); the answer judged is the window's last output."""
from __future__ import annotations

from time import perf_counter

import torch

from portbench.runtime import Phases, Window, release, sync

SMALL = {}


def control(config):
    return {"context": {**config["context"], "dtype": "bfloat16"}}


def make_inputs(config, traffic, seed, device, dtype):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (traffic["batch"], config["heads"], config["seq"], config["head_dim"])
    return [torch.randn(shape, generator=gen, device=device).to(dtype) for _ in range(3)]


def step_flops(config, traffic):
    return 2.0 * traffic["batch"] * config["heads"] * config["seq"] ** 2 * config["head_dim"]


def step_products(config, traffic):
    return []


class Job:
    def __init__(self, config, traffic, seed, device, context):
        from repro_torch.kernels import ops

        self.attention = ops.flash_attention
        self.device = device
        self.phases = Phases(device)
        dtype = getattr(torch, context["dtype"])
        self.q, self.k, self.v = make_inputs(config, traffic, seed, device, dtype)
        self.phases.mark("inputs")
        self.queries = 0
        for _ in range(traffic["warmup_steps"]):
            self._step()
        self.phases.mark("warmup")

    def _step(self):
        self.out = self.attention(self.q, self.k, self.v, causal=True)
        self.queries += self.q.shape[0] * self.q.shape[1] * self.q.shape[2]
        sync(self.device)

    def window(self, seconds):
        times = []
        t0 = perf_counter()
        while not times or perf_counter() - t0 < seconds:
            ts = perf_counter()
            self._step()
            times.append(perf_counter() - ts)
        return Window(steps=len(times), window_s=perf_counter() - t0, step_times=times)

    def loads(self):
        return {"queries": self.queries}

    def trace_ranges(self):
        pass

    def answers(self):
        return self.out

    def close(self):
        del self.q, self.k, self.v, self.out
        release(self.device)


def check(config, traffic, seed, device, out, reference):
    q, k, v = make_inputs(config, traffic, seed, device, torch.float32)
    want = reference.causal_attention(q, k, v)
    o_err = float((out.double() - want).abs().max() / want.abs().max())
    return {"o_err": o_err}, int(not o_err <= config["limits"]["o_err"]), []
'''

NEW_REFERENCE = '''"""Plain causal softmax attention in float64."""
import math

import torch


def causal_attention(q, k, v):
    q, k, v = (t.double() for t in (q, k, v))
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    seen = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
    return torch.softmax(s.masked_fill(~seen, -math.inf), dim=-1) @ v
'''

NEW_KIND_METRIC = '''"""``queries_per_step``: a test metric, the query rows a step that the
kind's own counter saw."""


def read(obs):
    if obs.steps == 0 or "queries" not in obs.loads:
        return None
    return obs.loads["queries"] / obs.steps
'''

ATTN_CONFIG = {"name": "attn-f32", "kind": "attention_fwd", "source": "a test",
               "heads": 4, "seq": 64, "head_dim": 32, "context": {"dtype": "float32"},
               "reduced": [], "limits": {"o_err": 1e-4}}


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _copy_tree(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path / "portbench", json.loads((tmp_path / "BENCHMARK.json").read_text())


def test_new_files_are_found(tmp_path):
    bench, spec = _copy_tree(tmp_path)
    before = _digest(tmp_path)

    config = json.loads((bench / "configs" / "logreg-newton.json").read_text())
    config.update(name="logreg-newton-narrow", n_rows=1 << 12, n_features=64,
                  reference_block_rows=1 << 10)
    (bench / "configs" / "logreg-newton-narrow.json").write_text(json.dumps(config))
    (bench / "traffic" / "rowblocks-2.json").write_text(
        json.dumps({"row_blocks": 2, "warmup_fits": 1}))
    (bench / "metrics" / "steps_seen.py").write_text(NEW_METRIC)

    spec["configs"].append({"name": "logreg-newton-narrow", "source": config["source"],
                            "file": "portbench/configs/logreg-newton-narrow.json",
                            "reduced": ["n_rows"], "why": "a test"})
    spec["workloads"].append({"name": "narrow-q2", "config": "logreg-newton-narrow",
                              "traffic": "rowblocks-2", "chips": 1, "why": "a test"})
    for metric in spec["end_to_end"]:
        if metric["name"] in ("step_s", "step_p95_s"):
            metric["workloads"].append("narrow-q2")
    spec["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "step", "moves": "step_s",
                              "workloads": ["narrow-q2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digest(tmp_path)
    assert all(after[name] == digest for name, digest in before.items())

    result, _ = run_small("narrow-q2", root=tmp_path, trace=True, n_rows=1 << 12,
                          n_features=64)
    assert result["correct"]
    assert result["metrics"]["steps_seen"]["value"] > 0
    assert "step_mfu" not in result["metrics"]  # listed for the four cells only
    result, _ = run_small("narrow-q2", root=tmp_path, n_rows=1 << 12, n_features=64)
    assert set(result["metrics"]) == {"step_s", "step_p95_s", "setup_s"}  # no card: no peak


def test_a_new_kind_without_a_block_runtime_is_found(tmp_path):
    """A kind whose job builds no ``ArrayContext`` runs untraced, traced and
    as its control, from new files alone; its metric reads the job's
    ``loads()`` as a delta over the window."""
    bench, spec = _copy_tree(tmp_path)
    before = _digest(tmp_path)

    (bench / "kinds" / "attention_fwd.py").write_text(NEW_KIND)
    (bench / "reference" / "attention_fwd.py").write_text(NEW_REFERENCE)
    (bench / "configs" / "attn-f32.json").write_text(json.dumps(ATTN_CONFIG))
    (bench / "traffic" / "batch-2.json").write_text(
        json.dumps({"batch": 2, "warmup_steps": 2}))
    (bench / "metrics" / "queries_per_step.py").write_text(NEW_KIND_METRIC)

    spec["configs"].append({"name": "attn-f32", "source": "a test",
                            "file": "portbench/configs/attn-f32.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "attn-b2", "config": "attn-f32",
                              "traffic": "batch-2", "chips": 1, "why": "a test"})
    next(m for m in spec["end_to_end"] if m["name"] == "step_s")["workloads"].append("attn-b2")
    spec["per_layer"].append({"name": "queries_per_step", "unit": "rows", "better": "higher",
                              "source": "program_counter", "layer": "kernels",
                              "moves": "step_s", "workloads": ["attn-b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digest(tmp_path)
    assert all(after[name] == digest for name, digest in before.items())

    result, lines = run_small("attn-b2", root=tmp_path)
    assert result["correct"] and result["failed"] == 0, lines
    assert set(result["metrics"]) == {"step_s", "setup_s"}  # no card: no peak

    result, lines = run_small("attn-b2", root=tmp_path, trace=True)
    assert result["correct"], lines
    queries = 2 * ATTN_CONFIG["heads"] * ATTN_CONFIG["seq"]
    assert result["metrics"] == {"queries_per_step": {"value": queries, "unit": "rows"}}
    assert 0 < result["device"]["window_s"]

    result, _ = run_small("attn-b2", root=tmp_path, control=True)
    assert not result["correct"]
    assert result["checks"]["o_err"]["value"] > result["checks"]["o_err"]["limit"]


def test_a_kind_without_the_protocol_is_refused_by_name(tmp_path):
    bench, spec = _copy_tree(tmp_path)
    partial = NEW_KIND.replace("def control(config):", "def _control(config):") \
        .replace("    def loads(self):", "    def _loads(self):")
    (bench / "kinds" / "attention_fwd.py").write_text(partial)
    (bench / "configs" / "attn-f32.json").write_text(json.dumps(ATTN_CONFIG))
    (bench / "traffic" / "batch-2.json").write_text(json.dumps({"batch": 2}))
    spec["configs"].append({"name": "attn-f32", "source": "a test",
                            "file": "portbench/configs/attn-f32.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "attn-b2", "config": "attn-f32",
                              "traffic": "batch-2", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    missing = r"attention_fwd\.py lacks the kind protocol's control, Job\.loads$"
    with pytest.raises(ImportError, match=missing):
        harness.resolve(tmp_path, "attn-b2")


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "kinds").glob("*.py")),
                         ids=lambda p: p.stem)
def test_every_kind_exports_the_protocol(path):
    kind = harness.load_module(path)
    assert harness.missing_protocol(kind) == []
    assert isinstance(kind.SMALL, dict)
