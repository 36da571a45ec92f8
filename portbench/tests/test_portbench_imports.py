"""Nothing the benchmark runs loads JAX or the JAX package (``repro``),
compared by whole top-level names: ``repro_torch`` is the port.  And the
run's exits where it has nothing to measure."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench.harness import FORBIDDEN, forbidden_modules

BENCH = ROOT / "portbench"


def _top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: p.name)
def test_no_file_imports_jax_or_the_jax_package(path):
    names = set(_top_level_imports(path))
    assert not names & set(FORBIDDEN), (path, names & set(FORBIDDEN))


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        assert not {"repro_torch", "portbench"} & set(_top_level_imports(path)), path


def test_whole_names_are_compared():
    assert forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["repro.core", "jax.numpy", "jaxlib", "repro_torch"]) == [
        "jax", "jaxlib", "repro"]


RUN_AND_LIST = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
from conftest import run_small
result, _ = run_small({workload!r}, trace=True)
print(json.dumps({{"correct": result["correct"],
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


@pytest.mark.parametrize("workload", ["newton-q32", "dgemm-tile4096"])
def test_a_run_leaves_no_jax_in_sys_modules(workload):
    code = RUN_AND_LIST.format(src=str(ROOT / "src"), root=str(ROOT),
                               tests=str(BENCH / "tests"), workload=workload)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert "repro_torch" in got["top"] and "torch" in got["top"]
    assert not set(got["top"]) & set(FORBIDDEN)


def _run(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "newton-q4",
                           "--seed", "5", "--seconds", "1", "--trace", "0", *args],
                          capture_output=True, text=True, timeout=300, cwd=cwd)


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_run_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
