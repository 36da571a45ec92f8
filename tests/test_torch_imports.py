"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax or the reference package, importing the port
loads neither, the port reads none of the reference's environment defaults,
and its entry points run on the card unless the caller asks for the CPU."""
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


@pytest.mark.parametrize("modules", [
    "repro_torch, repro_torch.core, repro_torch.backend, repro_torch.backend.cuda_backend, "
    "repro_torch.kernels, repro_torch.glm, repro_torch.launch.blocks, repro_torch.interop, "
    "repro_torch.obs, repro_torch.configs.glm_logreg",
    "repro_torch.models, repro_torch.kernels.flash_attention, repro_torch.kernels.mamba_scan, "
    "repro_torch.train, repro_torch.launch.serve, repro_torch.configs.hymba_1p5b",
    "repro_torch.kernels.flash_attention_bwd, repro_torch.train.optim, "
    "repro_torch.train.data, repro_torch.train.steps, repro_torch.launch.train, "
    "repro_torch.checkpoint, repro_torch.sharding.plans",
], ids=["block runtime", "LM serving", "LM training"])
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


def _carry(**kw):
    from repro_torch.interop import params_from_jax

    return params_from_jax({"w": np.zeros((2, 3), np.float32)}, **kw)["w"].device


@pytest.mark.parametrize("entry", [_context, _context_torch, _serve, _train, _carry],
                         ids=["ArrayContext", "ArrayContext torch", "serve_demo",
                              "train_loop", "params_from_jax"])
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


def _block_runtime_feature(name):
    from repro_torch.core import ArrayContext

    if name == "trace":
        return ArrayContext(device="cpu", trace=True)
    if name == "calibration":
        return ArrayContext(device="cpu", calibration={})
    if name == "restore":
        return ArrayContext.restore("d")
    ctx = ArrayContext(device="cpu")
    X = ctx.random((8, 4), grid=(2, 1))
    if name == "chaos":
        return ctx.enable_chaos(None)
    if name == "checkpoint":
        return ctx.checkpoint([X], "d")
    return X.reshard(grid=(1, 1))


def _hymba(**changes):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_layers=1, **changes)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0))


def _lm_feature(name):
    from repro_torch.models import MoEConfig, decode_step, forward, prefill
    from repro_torch.models import layers, partitioning

    tokens = {"tokens": torch.zeros(1, 4, dtype=torch.long)}
    if name == "moe":
        cfg, params = _hymba(moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64))
        return forward(params, tokens, cfg)
    if name == "mrope":
        cfg, params = _hymba(rope="mrope", mrope_sections=(2, 3, 3))
        return forward(params, tokens, cfg)
    if name == "encdec":
        cfg, params = _hymba()
        return forward(params, tokens, dataclasses.replace(cfg, encdec=True))
    if name == "softcap":
        cfg, params = _hymba(logit_softcap=30.0)
        return forward(params, tokens, cfg)
    if name == "per-row pos":
        cfg, params = _hymba()
        _, cache = prefill(params, tokens, cfg, 8)
        cache["pos"] = torch.tensor([4, 3])
        return decode_step(params, torch.zeros(2, 1, dtype=torch.long), cache, cfg)
    if name == "non-causal mask":
        q = torch.zeros(1, 4, 4, 16)
        return layers.attention_scores(q, q, q, torch.ones(4, 4, dtype=torch.bool))
    if name == "Rules":
        return partitioning.Rules(None)
    if name == "sharded steps":
        from repro_torch.train import make_prefill

        cfg, params = _hymba()
        return make_prefill(cfg, max_len=8, rules=object())(params, tokens)
    if name == "sharded train step":
        from repro_torch.sharding.plans import SINGLE_CARD
        from repro_torch.train import AdamConfig, init_opt_state, make_train_step

        cfg, params = _hymba()
        step = make_train_step(cfg, SINGLE_CARD, AdamConfig(), rules=object())
        return step({"params": params, "opt": init_opt_state(params)},
                    dict(tokens, labels=tokens["tokens"]))
    if name == "activation_rules":
        from repro_torch.sharding.plans import SINGLE_CARD, activation_rules

        return activation_rules(SINGLE_CARD, None)
    from repro_torch.configs import get_config

    return get_config(name)


@pytest.mark.parametrize("feature", [
    ("block", "trace"), ("block", "calibration"), ("block", "chaos"),
    ("block", "checkpoint"), ("block", "restore"), ("block", "reshard"),
    ("lm", "moe"), ("lm", "mrope"), ("lm", "encdec"), ("lm", "softcap"),
    ("lm", "per-row pos"), ("lm", "non-causal mask"), ("lm", "Rules"),
    ("lm", "sharded steps"), ("lm", "sharded train step"), ("lm", "activation_rules"),
    ("lm", "gemma3-4b"), ("lm", "whisper-small"),
    ("lm", "falcon-mamba-7b"), ("lm", "qwen3-moe-235b-a22b"),
], ids=lambda f: f[1])
def test_features_of_later_slices_raise(feature):
    kind, name = feature
    call = _block_runtime_feature if kind == "block" else _lm_feature
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(name)
