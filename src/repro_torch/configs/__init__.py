"""Workload configurations: the paper's own GLM workload (``glm_logreg``)
and the LM zoo's architectures that the port runs so far (``hymba-1.5b``
and ``gemma3-4b``, served and trained; ``falcon-mamba-7b``, the dense and
VLM decoders ``gemma-7b``, ``nemotron-4-15b``, ``command-r-35b`` and
``qwen2-vl-7b``, and the encoder-decoder ``whisper-small``, served).

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
    "falcon-mamba-7b": "falcon_mamba_7b",
    "gemma3-4b": "gemma3_4b",
    "gemma-7b": "gemma_7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "command-r-35b": "command_r_35b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "whisper-small": "whisper_small",
    "glm_logreg": "glm_logreg",
}

#: the reference's other architectures, with the ROADMAP item that ports them
_LATER = {
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
