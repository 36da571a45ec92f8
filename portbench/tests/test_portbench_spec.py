"""``BENCHMARK.json`` against the benchmark's contract: keys, the characters
of names and units, bounds, sources, the files each entry names, and the
budget of a full check."""
from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT
from portbench import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
CELLS = {w["name"]: w for w in SPEC["workloads"]}
E2E = {m["name"]: m for m in SPEC["end_to_end"]}
BENCH = ROOT / SPEC["paths"][0]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    for word in SPEC["command"][1:]:
        assert word.startswith(tuple(SPEC["paths"])), word


def test_full_check_fits():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert len(c["reduced"]) <= 16 and data["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.fullmatch(key) and key in data and key in data["published"]
            assert not re.search(r"(_dim|_rank|hidden|intermediate|latent|state|head)", key)
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
        for name in ("kinds", "reference"):
            assert (BENCH / name / f"{data['kind']}.py").is_file()
        assert data["limits"] and all(v >= 0 for v in data["limits"].values())


def test_workloads():
    assert 1 <= len(SPEC["workloads"]) <= 24 and len(CELLS) == len(SPEC["workloads"])
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def _metric_keys(m, extra):
    assert set(m) - {"workloads"} == extra, m["name"]
    assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert harness.reader_path(BENCH, m["name"]).is_file()
    for cell in m.get("workloads", []):
        assert cell in CELLS


def test_end_to_end():
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and "setup_s" in E2E
    for m in SPEC["end_to_end"]:
        _metric_keys(m, {"name", "unit", "better", "bound", "source"})
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] <= 0.25


def test_per_layer():
    assert 1 <= len(SPEC["per_layer"]) <= 128
    for m in SPEC["per_layer"]:
        _metric_keys(m, {"name", "unit", "better", "source", "layer", "moves"})
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert _line(m["layer"]) and m["moves"] in E2E
        reported = E2E[m["moves"]].get("workloads", list(CELLS))
        assert set(m.get("workloads", reported)) <= set(reported)
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_enough(cell):
    def applies(m):
        return cell in m.get("workloads", [cell])

    e2e = [m["name"] for m in SPEC["end_to_end"] if applies(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(applies(m) for m in SPEC["per_layer"])


def test_file_names_are_made_of_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert all(NAME.fullmatch(part) for part in rel.split("/")), rel


def test_each_layer_is_named_alike():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
