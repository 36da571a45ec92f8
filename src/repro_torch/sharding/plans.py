"""Sharding plans (counterpart of ``repro.sharding.plans``): the SPMD
analogue of NumS data layouts.

A :class:`Plan` fixes how every logical axis maps onto the mesh
(``("pod","data","model")`` in production) and how a train step runs
(remat, MoE dispatch, gradient dtype, accumulation).  ``activation_rules``
produces the Rules table the model's ``constrain`` calls read;
``param_spec_tree`` / ``batch_specs`` / ``cache_spec_tree`` give the
reference's per-leaf spec tuples and ``param_sharding_tree`` the DTensor
placements; ``shard_tree`` distributes a parameter (or optimizer) tree by
them.  The LSHS plan optimizer (``optimizer.py``) searches the candidate
plans with the paper's Eq. 2 objective computed from the analytic load model
(``estimator.py``).  A mesh is a ``DeviceMesh`` or, where only its axis
sizes matter, a dict {axis name: size}.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.config import ModelConfig
from repro_torch.models.partitioning import Rules, axis_sizes, spec_placements
from repro_torch.models.transformer import param_shapes

Spec = Tuple[Any, ...]


def P(*entries) -> Spec:
    """A spec tuple as jax's ``PartitionSpec`` normalises one: an empty
    tuple of axes is None, a one-axis tuple its axis."""
    return tuple(None if e == () else e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


@dataclass(frozen=True)
class Plan:
    name: str
    batch_axes: Tuple[str, ...] = ("pod", "data")
    tp_axis: Optional[str] = "model"       # heads / ff / vocab tensor-parallel
    fsdp_axis: Optional[Any] = None        # ZeRO-3 axis (str or tuple of axes)
    sp: bool = False                       # shard activation seq over tp_axis
    cache_sp: bool = False                 # shard KV-cache seq over tp_axis
    ep: bool = False                       # experts over tp_axis (MoE)
    remat: str = "dots"                    # none | dots | full
    dispatch_mode: str = "einsum"          # MoE dispatch: einsum | gather
    grad_dtype: str = "float32"            # bfloat16 = compressed all-reduce
    accum_steps: int = 1                   # gradient accumulation microbatches

    def describe(self) -> str:
        bits = [f"dp={'x'.join(self.batch_axes)}"]
        if self.tp_axis:
            bits.append(f"tp={self.tp_axis}")
        if self.fsdp_axis:
            bits.append(f"fsdp={self.fsdp_axis}")
        if self.sp:
            bits.append("sp")
        if self.cache_sp:
            bits.append("cache_sp")
        if self.ep:
            bits.append("ep")
        bits.append(f"remat={self.remat}")
        return f"{self.name}({','.join(bits)})"


#: the plan of a single-card run that names none: no mesh axes, full remat
SINGLE_CARD = Plan("single_card", batch_axes=(), tp_axis=None, remat="full")


# -- activation rules ---------------------------------------------------------


def activation_rules(plan: Plan, mesh, cfg: Optional[ModelConfig] = None) -> Rules:
    t = plan.tp_axis
    tsize = axis_sizes(mesh).get(t, 1) if t else 1

    def fits(n: Optional[int]) -> Optional[str]:
        """Only shard an activation axis the mesh divides evenly."""
        if t is None or n is None:
            return None
        return t if n % tsize == 0 else None

    if cfg is not None:
        heads = fits(cfg.n_heads if cfg.n_heads else None)
        kv = fits(cfg.n_kv_heads if cfg.n_kv_heads else None)
        ff = t
        vocab = fits(cfg.vocab)
        experts = fits(cfg.moe.num_experts) if (plan.ep and cfg.moe) else None
    else:
        heads, kv, ff, vocab = t, t, t, t
        experts = t if plan.ep else None
    table: Dict[str, Any] = {
        "batch": plan.batch_axes,
        "embed": None,
        "heads": heads,
        "kv_heads": kv,
        "ff": ff,
        "vocab": vocab,
        "experts": experts,
        "seq": t if plan.sp else None,
    }
    return Rules(mesh=mesh, table=table)


# -- parameter specs -----------------------------------------------------------


def _fsize(f, mesh_axes) -> int:
    if isinstance(f, str):
        return mesh_axes.get(f, 1)
    return math.prod(mesh_axes.get(a, 1) for a in f)


def _weight_spec(path: Tuple[str, ...], shape: Tuple[int, ...], plan: Plan,
                 mesh_axes: Dict[str, int]) -> Spec:
    """Logical placement of each parameter leaf.

    TP shards the 'feature-parallel' dim (heads/ff/vocab/experts); FSDP shards
    the largest remaining dim whose size divides the axis."""
    t, f = plan.tp_axis, plan.fsdp_axis
    name = path[-1]
    stacked = path[0] in ("layers", "encoder")  # leading L dim
    d: list = [None] * len(shape)
    base = 1 if stacked else 0  # skip the layer-stack dim

    def set_tp(axis_idx):
        if t and shape[axis_idx] % max(mesh_axes.get(t, 1), 1) == 0:
            d[axis_idx] = t

    def set_fsdp():
        if not f:
            return
        size = _fsize(f, mesh_axes)
        # largest unsharded dim divisible by the fsdp axis
        cands = [i for i in range(base, len(shape)) if d[i] is None and shape[i] % size == 0]
        if cands:
            d[max(cands, key=lambda i: shape[i])] = f

    if name in ("embed", "lm_head"):
        set_tp(0)           # vocab-sharded
        set_fsdp()
    elif name in ("wq", "wk", "wv"):
        set_tp(base + 1)    # (D, H*hd) -> output heads
        set_fsdp()
    elif name == "wo":
        set_tp(base + 0)    # (H*hd, D) -> input heads
        set_fsdp()
    elif name in ("w_gate", "w_up"):
        if len(shape) - base == 3:  # MoE stacked experts (E, D, F)
            if plan.ep:
                d[base + 0] = t
                if f and shape[base + 2] % _fsize(f, mesh_axes) == 0:
                    d[base + 2] = f
            else:
                set_tp(base + 2)
                set_fsdp()
        else:
            set_tp(base + 1)
            set_fsdp()
    elif name == "w_down":
        if len(shape) - base == 3:  # (E, F, D)
            if plan.ep:
                d[base + 0] = t
                if f and shape[base + 1] % _fsize(f, mesh_axes) == 0:
                    d[base + 1] = f
            else:
                set_tp(base + 1)
                set_fsdp()
        else:
            set_tp(base + 0)
            set_fsdp()
    elif name in ("in_proj",):
        set_tp(base + 1)
        set_fsdp()
    elif name in ("out_proj", "dt_proj"):
        set_tp(base + (0 if name == "out_proj" else 1))
        set_fsdp()
    elif name in ("x_proj", "A_log"):
        set_tp(base + 0)
    elif name in ("conv_w",):
        set_tp(base + 1)
    elif name in ("conv_b", "dt_bias", "D"):
        set_tp(base + 0)
    elif name in ("bq", "bk", "bv"):
        set_tp(base + 0)
    elif name == "pos_embed":
        set_fsdp()
    elif name == "router":
        set_fsdp()
    # norms and everything else: replicated
    return P(*d)


def param_spec_tree(cfg: ModelConfig, plan: Plan, mesh):
    """Per parameter leaf, the reference's ``PartitionSpec`` as a tuple."""
    mesh_axes = axis_sizes(mesh)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return _weight_spec(path, tree, plan, mesh_axes)

    return walk(param_shapes(cfg), ())


def _spec_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_sharding_tree(cfg: ModelConfig, plan: Plan, mesh):
    """Per parameter leaf, its DTensor placements on ``mesh``."""
    return _spec_map(lambda spec: spec_placements(mesh, spec),
                     param_spec_tree(cfg, plan, mesh))


def shard_tree(tree, cfg: ModelConfig, plan: Plan, mesh):
    """A parameter tree, or a train state ``{"params", "opt": {"m", "v",
    "step"}}``, distributed onto ``mesh`` by the plan's placements (the
    moments like their parameters, the step counter replicated).  Leaves
    that already are DTensors are redistributed (a remesh from another
    mesh first gathers them, ``full_tensor``)."""
    placements = param_sharding_tree(cfg, plan, mesh)

    def put(t, p):
        if isinstance(t, DTensor):
            if t.device_mesh == mesh:
                return t.redistribute(mesh, p)
            t = t.full_tensor()
        return distribute_tensor(t, mesh, p)

    def walk(sub, pl):
        if isinstance(sub, dict):
            return {k: walk(v, pl[k]) for k, v in sub.items()}
        return put(sub, pl)

    if "params" in tree and "opt" in tree:
        opt = tree["opt"]
        step = opt["step"]
        repl = spec_placements(mesh, ())
        return {"params": walk(tree["params"], placements),
                "opt": {"m": walk(opt["m"], placements), "v": walk(opt["v"], placements),
                        "step": put(step, repl)}}
    return walk(tree, placements)


# -- batch / cache specs ---------------------------------------------------------


def batch_specs(cfg: ModelConfig, plan: Plan, kind: str) -> Dict[str, Spec]:
    b = plan.batch_axes
    seq = plan.tp_axis if plan.sp else None
    specs = {}
    if cfg.embed_inputs and not cfg.encdec:
        specs["embeds"] = P(b, seq, None)
    else:
        specs["tokens"] = P(b, seq)
    if kind == "train":
        specs["labels"] = P(b, seq)
    if cfg.encdec:
        specs["frames"] = P(b, None, None)
    return specs


def cache_spec_tree(cfg: ModelConfig, plan: Plan) -> Dict[str, Any]:
    """Specs for the serving cache {'layers': {...}, 'pos': scalar}."""
    t = plan.tp_axis
    b = plan.batch_axes
    per: Dict[str, Any] = {}
    if not cfg.attention_free:
        kv = t
        seq = None
        if plan.cache_sp:
            kv, seq = None, t
        per["k"] = P(None, b, seq, kv, None)
        per["v"] = P(None, b, seq, kv, None)
    if cfg.ssm is not None:
        per["conv"] = P(None, b, None, t)
        per["ssm"] = P(None, b, t, None)
    if cfg.encdec:
        per["ck"] = P(None, b, None, t, None)
        per["cv"] = P(None, b, None, t, None)
    return {"layers": per, "pos": P()}


def candidate_plans(cfg: ModelConfig, kind: str) -> list:
    """The plan search space offered to the LSHS optimizer (the SPMD
    'placement options' of §4)."""
    is_moe = cfg.moe is not None
    F = ("pod", "data")  # fsdp over every data-parallel axis available
    ALL = ("pod", "data", "model")
    plans = [
        # pure ZeRO-3 over the whole mesh: no TP, batch over every axis
        Plan("fsdp_all", batch_axes=ALL, tp_axis=None, fsdp_axis=ALL, remat="dots"),
        Plan("fsdp_all_full", batch_axes=ALL, tp_axis=None, fsdp_axis=ALL, remat="full"),
        # batch over the whole mesh but FSDP only over the data axes: for
        # models whose dims divide 16 but not 256 (hymba d=1600)
        Plan("dp_fsdp_data", batch_axes=ALL, tp_axis=None, fsdp_axis=F, remat="full"),
        Plan("dp", tp_axis=None, remat="none"),
        Plan("dp_remat", tp_axis=None, remat="full"),
        Plan("fsdp", tp_axis=None, fsdp_axis=F, remat="dots"),
        Plan("fsdp_full", tp_axis=None, fsdp_axis=F, remat="full"),
        Plan("tp", tp_axis="model", remat="dots"),
        Plan("fsdp_tp", tp_axis="model", fsdp_axis=F, remat="dots"),
        Plan("fsdp_tp_sp", tp_axis="model", fsdp_axis=F, sp=True, remat="dots"),
        Plan("fsdp_tp_full", tp_axis="model", fsdp_axis=F, remat="full"),
        Plan("fsdp_tp_sp_full", tp_axis="model", fsdp_axis=F, sp=True, remat="full"),
        Plan("fsdp_tp_sp_bf16g", tp_axis="model", fsdp_axis=F, sp=True,
             remat="full", grad_dtype="bfloat16"),
    ]
    if is_moe:
        plans += [
            Plan("fsdp_ep", tp_axis="model", fsdp_axis=F, ep=True, remat="dots"),
            Plan("fsdp_ep_sp", tp_axis="model", fsdp_axis=F, ep=True, sp=True,
                 remat="full"),
            Plan("fsdp_ep_sp_bf16g", tp_axis="model", fsdp_axis=F, ep=True,
                 sp=True, remat="full", grad_dtype="bfloat16"),
            # gather-mode dispatch under EP is kept out of the search space,
            # as in the reference (its slot-index gathers cost collectives)
        ]
    if kind in ("decode", "long"):
        plans += [
            Plan("serve_tp", tp_axis="model", remat="none"),
            Plan("serve_tp_cachesp", tp_axis="model", cache_sp=True, remat="none"),
        ]
    if kind == "prefill":
        plans += [Plan("prefill_tp_sp", tp_axis="model", sp=True, remat="none")]
    return plans
