"""Assigned input shapes and per-cell inputs (counterpart of
``repro.launch.shapes``).  The reference's ``ShapeDtypeStruct`` stand-ins
become tensors on the ``meta`` device: shapes and dtypes, no storage, and
DTensors can be built over them."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.partitioning import axis_sizes
from repro_torch.models.transformer import _make_caches, _tree_map, param_shapes
from repro_torch.sharding.plans import Plan

META = torch.device("meta")

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "long", "seq": 524288, "batch": 1},
}


def cell_applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k skipped"
    return True, ""


def fit_plan_to_mesh(plan: Plan, mesh) -> Plan:
    """Drop mesh axes the plan references but the mesh lacks (e.g. 'pod' on
    the single-pod mesh).  ``mesh``: a DeviceMesh or {axis name: size}."""
    names = set(axis_sizes(mesh))
    batch_axes = tuple(a for a in plan.batch_axes if a in names)
    kw: Dict[str, Any] = {"batch_axes": batch_axes}
    if plan.tp_axis and plan.tp_axis not in names:
        kw["tp_axis"] = None
    f = plan.fsdp_axis
    if isinstance(f, str) and f not in names:
        kw["fsdp_axis"] = None
    elif isinstance(f, tuple):
        kept = tuple(a for a in f if a in names)
        kw["fsdp_axis"] = kept if kept else None
    return dataclasses.replace(plan, **kw)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def param_struct(cfg: ModelConfig, dtype: str = None) -> Dict[str, Any]:
    """The parameter tree as meta tensors of ``dtype`` (default
    ``cfg.dtype``)."""
    dt = getattr(torch, dtype or cfg.dtype)
    return _tree_map(lambda s: _meta(s, dt), param_shapes(cfg))


def batch_struct(cfg: ModelConfig, kind: str, B: int, S: int) -> Dict[str, Any]:
    dt = getattr(torch, cfg.dtype)
    batch: Dict[str, Any] = {}
    if cfg.embed_inputs and not cfg.encdec:
        batch["embeds"] = _meta((B, S, cfg.d_model), dt)
    else:
        batch["tokens"] = _meta((B, S), torch.int64)
    if cfg.encdec:
        batch["frames"] = _meta((B, cfg.enc_max_len, cfg.d_model), dt)
    if kind == "train":
        batch["labels"] = _meta((B, S), torch.int64)
    return batch


def cache_struct(cfg: ModelConfig, B: int, max_len: int) -> Dict[str, Any]:
    dt = getattr(torch, cfg.dtype)
    per = _make_caches(cfg, B, max_len, dt, META)
    if cfg.encdec:
        KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        per["ck"] = _meta((cfg.n_layers, B, cfg.enc_max_len, KV, hd), dt)
        per["cv"] = _meta((cfg.n_layers, B, cfg.enc_max_len, KV, hd), dt)
    return {"layers": per, "pos": 0}


def train_state_struct(cfg: ModelConfig) -> Dict[str, Any]:
    p = param_struct(cfg, dtype="float32")
    f32 = lambda t: _meta(t.shape, torch.float32)  # noqa: E731
    return {
        "params": p,
        "opt": {"m": _tree_map(f32, p), "v": _tree_map(f32, p),
                "step": _meta((), torch.int32)},
    }


def input_specs(arch: str, shape_name: str) -> Dict[str, Any]:
    """Every meta input a cell's step function takes."""
    cfg = get_config(arch)
    info = SHAPES[shape_name]
    kind, S, B = info["kind"], info["seq"], info["batch"]
    if kind == "train":
        return {"kind": kind, "state": train_state_struct(cfg),
                "batch": batch_struct(cfg, kind, B, S)}
    if kind == "prefill":
        return {"kind": kind, "params": param_struct(cfg),
                "batch": batch_struct(cfg, kind, B, S)}
    # decode / long: one new token against a seq_len cache
    return {"kind": kind, "params": param_struct(cfg),
            "tokens": _meta((B, 1), torch.int64), "cache": cache_struct(cfg, B, S)}
