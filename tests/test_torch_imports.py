"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax or the reference package, importing the port
loads neither, the port reads none of the reference's environment defaults,
and its entry points run on the card unless the caller asks for the CPU."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.backend, "
            "repro_torch.backend.cuda_backend, repro_torch.kernels, "
            "repro_torch.glm, repro_torch.launch.blocks, repro_torch.interop, "
            "repro_torch.obs, repro_torch.configs.glm_logreg; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_reads_no_reference_environment_defaults():
    for path in PORT_FILES:
        text = path.read_text()
        assert "REPRO_BACKEND" not in text and "REPRO_DTYPE" not in text, path


def test_default_context_is_on_the_card():
    from repro_torch.core import ArrayContext

    if torch.cuda.is_available():
        ctx = ArrayContext()
        assert ctx.backend == "cuda"
        assert ctx.executor.backend.devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ArrayContext()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ArrayContext(backend="torch", device="cuda")
    assert ArrayContext(device="cpu").executor.backend.devices == [torch.device("cpu")]


def test_features_of_later_slices_raise():
    from repro_torch.core import ArrayContext

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ArrayContext(device="cpu", trace=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ArrayContext(device="cpu", calibration={})
    ctx = ArrayContext(device="cpu")
    X = ctx.random((8, 4), grid=(2, 1))
    for call in (lambda: ctx.enable_chaos(None), lambda: ctx.checkpoint([X], "d"),
                 lambda: ArrayContext.restore("d"), lambda: X.reshard(grid=(1, 1))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
