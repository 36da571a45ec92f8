"""A configuration, a traffic mix, a cell and a metric added as new files
and new ``BENCHMARK.json`` entries are found by name, with no file that was
there edited."""
from __future__ import annotations

import hashlib
import json
import shutil

from conftest import ROOT, run_small

NEW_METRIC = '''"""``steps_seen``: a test metric, the steps of the window."""


def read(obs):
    return float(obs.steps)
'''


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path)

    bench = tmp_path / "portbench"
    config = json.loads((bench / "configs" / "logreg-newton.json").read_text())
    config.update(name="logreg-newton-narrow", n_rows=1 << 12, n_features=64,
                  reference_block_rows=1 << 10)
    (bench / "configs" / "logreg-newton-narrow.json").write_text(json.dumps(config))
    (bench / "traffic" / "rowblocks-2.json").write_text(
        json.dumps({"row_blocks": 2, "warmup_fits": 1}))
    (bench / "metrics" / "steps_seen.py").write_text(NEW_METRIC)

    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
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
