"""Workload configurations: the paper's own GLM workload (``glm_logreg``)
and the LM zoo's architectures that the port serves and trains so far
(``hymba-1.5b``).

Each module exports ``CONFIG`` (exact published sizes).  ``get_config(id)``
and ``list_archs()`` are the programmatic API, as in ``repro.configs``; an
architecture of the reference's zoo that is not ported yet raises
``NotImplementedError`` naming its ROADMAP item.
"""
from importlib import import_module
from typing import List

#: ported architectures: alias -> module
_PORTED = {
    "hymba-1.5b": "hymba_1p5b",
    "glm_logreg": "glm_logreg",
}

#: the reference's other architectures, with the ROADMAP item that ports them
_LATER = {
    "gemma-7b": "Queue 1 item 6 (dense configs with head_dim 256)",
    "gemma3-4b": "Queue 1 item 6 (dense configs with head_dim 256)",
    "nemotron-4-15b": "Queue 1 item 6 (nemotron-4-15b: layernorm, relu^2)",
    "command-r-35b": "Queue 1 item 6 (dense configs)",
    "falcon-mamba-7b": "Queue 1 item 6 (falcon-mamba-7b)",
    "qwen2-vl-7b": "Queue 1 item 6 (qwen2-vl-7b: mrope)",
    "whisper-small": "Queue 1 item 6 (whisper-small: cross and non-causal attention)",
    "qwen3-moe-235b-a22b": "Queue 1 item 6 (the MoE configs)",
    "phi3.5-moe-42b-a6.6b": "Queue 1 item 6 (the MoE configs)",
}


def list_archs() -> List[str]:
    return list(_PORTED)


def get_config(arch: str):
    name = {v: k for k, v in _PORTED.items()}.get(arch, arch)
    if name in _PORTED:
        return import_module(f"repro_torch.configs.{_PORTED[name]}").CONFIG
    later = {k.replace("-", "_").replace(".", "p"): v for k, v in _LATER.items()}
    item = _LATER.get(arch) or later.get(arch)
    if item is not None:
        raise NotImplementedError(f"{arch}: not ported yet, ROADMAP {item}")
    raise ValueError(f"unknown architecture {arch!r}; ported: {list_archs()}")
