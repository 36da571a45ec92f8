"""Workload configurations: the paper's own GLM workload (``glm_logreg``)
and every architecture of the reference's LM zoo: the hybrid
``hymba-1.5b``, the SSM ``falcon-mamba-7b``, the dense and VLM decoders
(``gemma3-4b``, ``gemma-7b``, ``nemotron-4-15b``, ``command-r-35b``,
``qwen2-vl-7b``), the MoE decoders (``qwen3-moe-235b-a22b``,
``phi3.5-moe-42b-a6.6b``) and the encoder-decoder ``whisper-small``; and
the port's own ``jamba2-mini`` (Mamba-1, attention and MoE layers by a
layer schedule) and ``granite-4.0-h-small`` (Mamba-2 and attention by a
schedule, a MoE with a shared expert on every layer), which the
reference's zoo lacks.

Each module exports ``CONFIG`` (exact published sizes).  ``get_config(id)``
and ``list_archs()`` are the programmatic API, as in ``repro.configs``.
"""
from importlib import import_module
from typing import List

#: architectures: alias -> module
_MODULES = {
    "hymba-1.5b": "hymba_1p5b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "gemma3-4b": "gemma3_4b",
    "gemma-7b": "gemma_7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "command-r-35b": "command_r_35b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "phi3.5-moe-42b-a6.6b": "phi3p5_moe_42b_a6p6b",
    "whisper-small": "whisper_small",
    "jamba2-mini": "jamba2_mini",
    "granite-4.0-h-small": "granite_4_0_h_small",
    "glm_logreg": "glm_logreg",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch: str):
    name = {v: k for k, v in _MODULES.items()}.get(arch, arch)
    if name in _MODULES:
        return import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG
    raise ValueError(f"unknown architecture {arch!r}; known: {list_archs()}")
