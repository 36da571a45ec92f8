"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax or the reference package, importing the port
loads neither, the port reads none of the reference's environment defaults,
and its entry points run on the card unless the caller asks for the CPU.  The
block backends import nothing of the runtime above them but block semantics
and spans."""
from __future__ import annotations

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")
BACKEND_FILES = sorted((ROOT / "src" / "repro_torch" / "backend").glob("*.py"))
#: the runtime modules a backend may import: block semantics and spans
BACKEND_MAY_IMPORT = ("repro_torch.core.graph_array", "repro_torch.core.trace")


def _imported_modules(path: Path):
    """Every module ``path`` imports, relative imports resolved against its
    package (``from . import x`` gives the package's ``x``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.ImportFrom) and node.level > 0:
            package = path.relative_to(ROOT / "src").parent.parts
            base = ".".join(package[:len(package) - node.level + 1])
            if node.module:
                yield f"{base}.{node.module}"
            else:
                for alias in node.names:
                    yield f"{base}.{alias.name}"
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", BACKEND_FILES, ids=lambda p: p.name)
def test_backend_imports_no_higher_layer(path):
    """A backend reads block semantics (``core.graph_array``) and opens spans
    (``core.trace``); nothing else of ``repro_torch.core`` sits below it."""
    core = [m for m in _imported_modules(path)
            if m == "repro_torch.core" or m.startswith("repro_torch.core.")]
    bad = [m for m in core if not any(m == ok or m.startswith(ok + ".")
                                      for ok in BACKEND_MAY_IMPORT)]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("modules", [
    "repro_torch, repro_torch.core, repro_torch.backend, repro_torch.backend.cuda_backend, "
    "repro_torch.kernels, repro_torch.glm, repro_torch.launch.blocks, repro_torch.interop, "
    "repro_torch.obs, repro_torch.configs.glm_logreg, repro_torch.factor, repro_torch.linalg, "
    "repro_torch.tensor, repro_torch.core.elastic, repro_torch.core.straggler",
    "repro_torch.models, repro_torch.kernels.flash_attention, repro_torch.kernels.mamba_scan, "
    "repro_torch.train, repro_torch.launch.serve, repro_torch.configs.hymba_1p5b, "
    "repro_torch.serve, repro_torch.configs.falcon_mamba_7b",
    "repro_torch.kernels.flash_attention_bwd, repro_torch.train.optim, "
    "repro_torch.train.data, repro_torch.train.steps, repro_torch.launch.train, "
    "repro_torch.checkpoint, repro_torch.sharding.plans",
    "repro_torch.core.trace, repro_torch.core.chaos, repro_torch.obs.perfetto, "
    "repro_torch.obs.critical_path, repro_torch.obs.calibrate, repro_torch.obs.controller, "
    "repro_torch.launch.chaos, repro_torch.launch.trace_report, repro_torch.launch.mesh",
    "repro_torch.sharding, repro_torch.sharding.hardware, repro_torch.sharding.estimator, "
    "repro_torch.sharding.optimizer, repro_torch.sharding.roofline, "
    "repro_torch.sharding.collectives, repro_torch.launch.shapes, repro_torch.launch.dryrun, "
    "repro_torch.train.compress, repro_torch.models.partitioning",
], ids=["block runtime", "LM serving", "LM training", "fault tolerance and observability",
        "SPMD sharding"])
def test_import_loads_neither_jax_nor_reference(modules):
    code = (f"import sys, {modules}; "
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


def _context(**kw):
    from repro_torch.core import ArrayContext

    ctx = ArrayContext(**kw)
    if kw.get("device") != "cpu":
        assert ctx.backend == kw.get("backend", "cuda")
    return ctx.executor.backend.devices[0]


def _context_torch(**kw):
    return _context(backend="torch", **kw)


def _serve(**kw):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_demo

    record = {}
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_layers=1)
    serve_demo(cfg, batch=1, prompt_len=4, gen=2, log_fn=lambda *a: None, record=record,
               **kw)
    return record["device"]


def _train(**kw):
    from repro_torch.launch.train import train_loop

    state, _ = train_loop("hymba-1.5b", steps=1, batch=1, seq=8, log_fn=lambda *a: None,
                          **kw)
    return state["params"]["embed"].device


def _calibrate(**kw):
    from repro_torch.obs import run_calibration

    profile = run_calibration(nodes=2, workers=1, n=64, d=4, iters=1, sweep=(8,), **kw)
    # the device class reads "<backend>:<platform> (<name>) x<count>"
    return torch.device(profile.metadata["device"].split(":")[1].split(" ")[0])


def _chaos_scenario(**kw):
    from repro_torch.core import ChaosPlan
    from repro_torch.launch.chaos import run_scenario

    run = run_scenario(ChaosPlan(), nodes=2, d=4, iters=1, **kw)
    return run["ctx"].executor.backend.devices[0]


def _carry(**kw):
    from repro_torch.interop import params_from_jax

    return params_from_jax({"w": np.zeros((2, 3), np.float32)}, **kw)["w"].device


@pytest.mark.parametrize("entry", [_context, _context_torch, _serve, _train, _carry,
                                   _calibrate, _chaos_scenario],
                         ids=["ArrayContext", "ArrayContext torch", "serve_demo",
                              "train_loop", "params_from_jax", "run_calibration",
                              "run_scenario"])
def test_default_context_is_on_the_card(entry):
    """Without ``device``, and with ``device="cuda"``, an entry point runs on
    the card, and raises where there is none; ``device="cpu"`` runs on the
    CPU."""
    for kw in ({}, {"device": "cuda"}):
        if torch.cuda.is_available():
            assert entry(**kw).type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                entry(**kw)
    assert entry(device="cpu") == torch.device("cpu")


def _hymba(**changes):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_layers=1, **changes)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0))


def _lm_feature(name):
    from repro_torch.models import forward

    tokens = {"tokens": torch.zeros(1, 4, dtype=torch.long)}
    if name == "softcap":
        cfg, params = _hymba(logit_softcap=30.0)
        return forward(params, tokens, cfg)
    from repro_torch.configs import get_config

    return get_config(name)


@pytest.mark.parametrize("feature", [("lm", "softcap")], ids=lambda f: f[1])
def test_features_of_later_slices_raise(feature):
    _kind, name = feature
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _lm_feature(name)


#: the MoE configs as published: layers, d_model, heads, kv heads, vocab,
#: experts, top-k, expert width, norm
MOE_PUBLISHED = {
    "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 151936, 128, 8, 1536, "rmsnorm"),
    "phi3.5-moe-42b-a6.6b": (32, 4096, 32, 8, 32064, 16, 2, 6400, "layernorm"),
}


@pytest.mark.parametrize("arch", sorted(MOE_PUBLISHED))
def test_moe_configs_load_as_published(arch):
    """Both MoE configs load, by alias and by module name, as published."""
    from repro_torch.configs import get_config, list_archs

    cfg = get_config(arch)
    assert arch in list_archs()
    assert get_config(arch.replace("-", "_").replace(".", "p")) is cfg
    e = cfg.moe
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab,
            e.num_experts, e.top_k, e.d_ff_expert, cfg.norm) == MOE_PUBLISHED[arch]
    assert cfg.family == "moe" and cfg.d_ff == 0 and cfg.resolved_head_dim == 128


def test_hymba_with_moe_runs_forward():
    """A hybrid layer with an MoE channel sublayer (the case that raised
    before MoE was ported) gives finite logits and a positive aux loss."""
    from repro_torch.models import MoEConfig, forward

    cfg, params = _hymba(moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64))
    tokens = torch.arange(8).reshape(1, 8) % cfg.vocab
    logits, aux = forward(params, {"tokens": tokens}, cfg)
    assert logits.shape == (1, 8, cfg.vocab) and torch.isfinite(logits).all()
    assert aux.dtype == torch.float32 and aux.shape == () and float(aux) > 0
