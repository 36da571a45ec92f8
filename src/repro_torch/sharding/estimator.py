"""Analytic per-device load model for sharding plans (counterpart of
``repro.sharding.estimator``): the SPMD analogue of the paper's
ClusterState simulation (§5.1).

For a (config, workload, mesh, plan) tuple we estimate, per device:
  * memory bytes: params + optimizer state + gradients + activations +
    KV-cache + logits,
  * network bytes in/out per step: DP grad all-reduce, FSDP all-gather /
    reduce-scatter, TP activation all-reduces, EP all-to-alls, SP boundary
    all-gathers.

SPMD programs are symmetric, so the per-device value *is* the max over
devices that Eq. 2 takes.  Estimates use ring-collective costs
(2(n-1)/n ~ 2x payload for all-reduce, 1x for gather/scatter).  Every byte
count is a function of (config, plan, mesh, shape) alone; only ``fits`` and
the "time" objective read the device table ``hw``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import param_shapes

from .hardware import H100_SXM, Hardware
from .plans import Plan, param_spec_tree


@dataclass
class LoadEstimate:
    plan_name: str
    mem_bytes: float
    net_in_bytes: float
    net_out_bytes: float
    param_bytes: float
    act_bytes: float
    cache_bytes: float
    fits: bool
    detail: Dict[str, float]
    hw: Hardware = field(default=H100_SXM, repr=False)

    def objective(self, mode: str = "paper") -> float:
        if mode == "paper":  # Eq. 2: max mem + max in + max out (bytes)
            return self.mem_bytes + self.net_in_bytes + self.net_out_bytes
        return (
            self.mem_bytes / self.hw.hbm_bw
            + self.net_in_bytes / self.hw.link_bw
            + self.net_out_bytes / self.hw.link_bw
        )


def _axis_size(mesh_axes: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh_axes.get(axes, 1)
    n = 1
    for a in axes:
        n *= mesh_axes.get(a, 1)
    return n


def local_param_numel(cfg: ModelConfig, plan: Plan, mesh_axes: Dict[str, int]) -> float:
    """Exact per-device parameter elements under the plan's spec tree."""
    specs = param_spec_tree(cfg, plan, mesh_axes)
    total = 0.0

    def walk(shape_tree, spec_tree):
        nonlocal total
        if isinstance(shape_tree, dict):
            for k in shape_tree:
                walk(shape_tree[k], spec_tree[k])
            return
        numel = float(math.prod(shape_tree))
        shard = 1
        for entry in spec_tree:
            shard *= _axis_size(mesh_axes, entry)
        total += numel / shard

    walk(param_shapes(cfg), specs)
    return total


def estimate(
    cfg: ModelConfig,
    plan: Plan,
    mesh_axes: Dict[str, int],
    kind: str,                    # train | prefill | decode | long
    global_batch: int,
    seq_len: int,
    dtype_bytes: int = 2,
    hw: Hardware = H100_SXM,
) -> LoadEstimate:
    dp = _axis_size(mesh_axes, plan.batch_axes)
    tp = _axis_size(mesh_axes, plan.tp_axis)
    fsdp = _axis_size(mesh_axes, plan.fsdp_axis)

    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    B_loc = max(global_batch / dp, 1.0)
    S = seq_len if kind in ("train", "prefill") else 1
    S_loc = S / (tp if plan.sp else 1)
    S_cache = seq_len
    S_cache_loc = S_cache / (tp if plan.cache_sp else 1)

    p_loc = local_param_numel(cfg, plan, mesh_axes)

    detail: Dict[str, float] = {}
    if kind == "train":
        # fp32 master + adam m,v + grads + transient bf16 compute copy
        gbytes = 2 if plan.grad_dtype == "bfloat16" else 4
        param_bytes = p_loc * (4 + 8 + gbytes + dtype_bytes)
    else:
        param_bytes = p_loc * dtype_bytes
    detail["param_bytes"] = param_bytes

    # activations (per device): resident residual streams through the layers
    if kind == "train":
        act_mult = {"full": 2.5, "dots": 7.0, "none": 16.0}[plan.remat]
        act_bytes = L * B_loc * S_loc * D * dtype_bytes * act_mult
    elif kind == "prefill":
        # inference transients: a few live layer buffers, not the whole stack
        act_bytes = 4.0 * B_loc * S_loc * D * dtype_bytes
        if cfg.ssm is not None:
            di = cfg.ssm.d_inner(D) / max(tp, 1)
            act_bytes += 3.0 * B_loc * S_loc * di * cfg.ssm.d_state * 4
    else:  # decode
        act_bytes = 4.0 * B_loc * 1 * D * dtype_bytes
    # logits + softmax workspace
    if kind == "train":
        act_bytes += B_loc * S_loc * (V / max(tp, 1)) * (dtype_bytes + 4)
    else:
        act_bytes += B_loc * 1 * (V / max(tp, 1)) * (dtype_bytes + 4)
    detail["act_bytes"] = act_bytes

    # MoE dispatch tensors (einsum mode): the (G,Sg,E,C) one-hot dispatch/
    # combine pair is resident per layer under autodiff; gather mode replaces
    # them with int32 slot indices
    if cfg.moe is not None:
        e = cfg.moe
        if plan.dispatch_mode == "einsum":
            moe_bytes = B_loc * S_loc * e.num_experts * \
                (e.top_k * 1.25 / e.num_experts) * 4 * 2  # dispatch+combine f32
            # one-hot (N,K,E) intermediates
            moe_bytes += B_loc * S_loc * e.top_k * e.num_experts * 4
        else:
            moe_bytes = B_loc * S_loc * e.top_k * 8  # slot indices
        if kind == "train" and plan.remat != "full":
            moe_bytes *= min(L, 4)
        act_bytes += moe_bytes
        detail["moe_dispatch_bytes"] = moe_bytes
        # non-EP TP reshards the dispatched activations every layer
        if not plan.ep and plan.tp_axis and tp > 1:
            net_moe = L * B_loc * S_loc * e.top_k * 1.25 * D * dtype_bytes * 2
            detail["moe_reshard_bytes"] = net_moe
        else:
            detail["moe_reshard_bytes"] = 0.0

    # serving cache
    cache_bytes = 0.0
    if kind in ("decode", "long", "prefill"):
        if not cfg.attention_free:
            kv_shard = 1 if plan.cache_sp else min(tp, max(cfg.n_kv_heads, 1))
            cache_bytes += (
                L * B_loc * S_cache_loc * cfg.n_kv_heads * cfg.resolved_head_dim
                * 2 * dtype_bytes / kv_shard
            )
        if cfg.ssm is not None:
            di = cfg.ssm.d_inner(D)
            cache_bytes += L * B_loc * di * (cfg.ssm.d_state * 4 + cfg.ssm.d_conv * dtype_bytes) / tp
    detail["cache_bytes"] = cache_bytes

    mem = param_bytes + act_bytes + cache_bytes

    # -- collectives ------------------------------------------------------------
    net = 0.0
    tokens_loc = B_loc * S_loc
    if kind == "train":
        gbytes = 2 if plan.grad_dtype == "bfloat16" else 4
        if plan.fsdp_axis:
            # ZeRO-3: all-gather params fwd+bwd (bf16) + reduce-scatter grads
            net += 2 * p_loc * (fsdp - 1) / max(fsdp, 1) * dtype_bytes * 2
            net += p_loc * (fsdp - 1) / max(fsdp, 1) * gbytes
        if dp > 1:
            # grad all-reduce over remaining DP axes (ring: ~2x payload)
            net += 2 * p_loc * (dp - 1) / dp * gbytes
    if plan.tp_axis and tp > 1:
        # TP all-reduces: attn out + mlp out per layer, fwd (+bwd for train)
        per_layer = 2 * tokens_loc * D * dtype_bytes * 2 * (tp - 1) / tp
        net += per_layer * L * (2 if kind == "train" else 1)
    if plan.ep and cfg.moe is not None and tp > 1:
        # all-to-all dispatch+combine per layer each way
        a2a = 2 * tokens_loc * D * dtype_bytes * (tp - 1) / tp * 2
        net += a2a * L * (2 if kind == "train" else 1)
    if cfg.moe is not None and not plan.ep and plan.tp_axis and tp > 1:
        net += detail.get("moe_reshard_bytes", 0.0)
    if cfg.ssm is not None and plan.sp and tp > 1 and kind in ("train", "prefill"):
        # a scan over a seq-sharded axis gathers the (B,S,DI,N) scan inputs
        di = cfg.ssm.d_inner(D) / max(tp, 1)
        net += L * B_loc * S_loc * di * cfg.ssm.d_state * 4 * (tp - 1)
    if plan.cache_sp and kind in ("decode", "long"):
        # distributed decode-attention: partial softmax stats + value combine
        net += L * B_loc * cfg.n_heads * cfg.resolved_head_dim * 4 * 2
    detail["net_bytes"] = net

    return LoadEstimate(
        plan_name=plan.name,
        mem_bytes=mem,
        net_in_bytes=net,
        net_out_bytes=net,
        param_bytes=param_bytes,
        act_bytes=act_bytes,
        cache_bytes=cache_bytes,
        fits=mem < 0.92 * hw.hbm_bytes,
        detail=detail,
        hw=hw,
    )
