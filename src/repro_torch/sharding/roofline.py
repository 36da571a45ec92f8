"""Roofline terms per (arch x shape x mesh) cell (counterpart of
``repro.sharding.roofline``), against a named device table:

  compute    = step_FLOPs / (devices x hw.peak_bf16)
  memory     = HBM traffic / hw.hbm_bw
  collective = collective bytes per device / hw.link_bw

FLOPs and HBM traffic use an analytic per-component model of the step's
graph.  MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); the ratio
MODEL_FLOPS / step_FLOPs exposes remat/dispatch overhead.  ``mfu`` puts
MODEL_FLOPS over a measured step time.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig

from .hardware import H100_SXM, Hardware

def _layer_flops(cfg: ModelConfig, tokens: float, attend_len: float,
                 dispatch_einsum: bool = True) -> float:
    """Forward FLOPs for one decoder layer over ``tokens`` tokens, each
    attending to ``attend_len`` keys (already window/causal-averaged)."""
    D, hd = cfg.d_model, cfg.resolved_head_dim
    f = 0.0
    if not cfg.attention_free:
        H, KV = cfg.n_heads, cfg.n_kv_heads
        f += 2 * tokens * D * (H + 2 * KV) * hd          # qkv proj
        f += 2 * tokens * attend_len * H * hd * 2        # qk^T and pv
        f += 2 * tokens * H * hd * D                     # out proj
    if cfg.ssm is not None:
        s = cfg.ssm
        DI = s.d_inner(D)
        R, N = s.resolved_dt_rank(D), s.d_state
        f += 2 * tokens * D * 2 * DI                     # in_proj
        f += 2 * tokens * DI * s.d_conv                  # conv
        f += 2 * tokens * DI * (R + 2 * N)               # x_proj
        f += 2 * tokens * R * DI                         # dt_proj
        f += tokens * DI * N * 6                         # scan update + y
        f += 2 * tokens * DI * D                         # out_proj
    if cfg.moe is not None:
        e = cfg.moe
        fmul = 6 if cfg.gated_mlp else 4
        f += 2 * tokens * D * e.num_experts              # router
        f += fmul * tokens * e.top_k * 1.25 * D * e.d_ff_expert  # experts (cf)
    elif cfg.d_ff:
        fmul = 6 if cfg.gated_mlp else 4
        f += fmul * tokens * D * cfg.d_ff
    return f


def _moe_dispatch_flops(cfg: ModelConfig, tokens: float, cf: float = 1.25) -> float:
    """GShard dense dispatch/combine einsum FLOPs (einsum mode only).

    The (gsec,gsd->egcd) einsum costs 2*Sg*E*C*D per group with per-group
    capacity C = K*Sg*cf/E, i.e. 2*E*C*D/Sg = 2*K*cf*D per token per
    direction; dispatch + combine -> 4*K*cf*D per token... times E from the
    one-hot construction einsums is avoided by the gather mode (§Perf)."""
    if cfg.moe is None:
        return 0.0
    e = cfg.moe
    # dominant dense terms measured per token: dispatch (2*K*cf*E*D/E) x2
    # plus the (N,K,E)x(N,K,C) one-hot products ~ K*E*C/Sg each
    return tokens * (4.0 * e.top_k * cf * cfg.d_model
                     + 2.0 * e.top_k * e.top_k * cf * e.num_experts)


def analytic_step_flops(
    cfg: ModelConfig, kind: str, B: int, S: int,
    remat: str = "none", dispatch_mode: str = "einsum",
) -> float:
    """Global FLOPs for one step of the lowered graph."""
    if kind == "train":
        tokens = float(B * S)
        attend = S / 2  # causal average
        mult = {"none": 3.0, "dots": 3.4, "full": 4.0}[remat]
    elif kind == "prefill":
        tokens = float(B * S)
        attend = S / 2
        mult = 1.0
    else:  # decode / long: one token against a seq_len cache
        tokens = float(B)
        attend = float(S)
        mult = 1.0

    if cfg.window is not None:
        n_local = sum(cfg.is_local_layer(i) for i in range(cfg.n_layers))
        n_global = cfg.n_layers - n_local
        a_local = min(attend, cfg.window)
        per_layer = (
            n_local * _layer_flops(cfg, tokens, a_local, False)
            + n_global * _layer_flops(cfg, tokens, attend, False)
        )
    else:
        per_layer = cfg.n_layers * _layer_flops(cfg, tokens, attend, False)
    f = per_layer
    if cfg.moe is not None and dispatch_mode == "einsum":
        f += cfg.n_layers * _moe_dispatch_flops(cfg, tokens)
    # lm head + (tied or not) embedding matmul
    f += 2 * tokens * cfg.vocab * cfg.d_model
    if cfg.encdec:
        enc_tokens = float(B * cfg.enc_max_len)
        enc = cfg.n_enc_layers * (
            2 * enc_tokens * cfg.d_model * 4 * cfg.d_model      # qkvo
            + 2 * enc_tokens * cfg.enc_max_len * cfg.d_model * 2
            + (6 if cfg.gated_mlp else 4) * enc_tokens * cfg.d_model * cfg.d_ff
        )
        cross = cfg.n_layers * (
            2 * tokens * cfg.d_model * 2 * cfg.d_model
            + 2 * tokens * cfg.enc_max_len * cfg.n_heads * cfg.resolved_head_dim * 2
        )
        f += enc + cross
    return f * mult


def model_flops(cfg: ModelConfig, kind: str, B: int, S: int) -> float:
    """MODEL_FLOPS = 6·N_active·tokens (train) / 2·N_active·tokens (serve)."""
    n = cfg.active_param_count()
    tokens = B * S if kind in ("train", "prefill") else B
    c = 6 if kind == "train" else 2
    return float(c * n * tokens)


def analytic_hbm_bytes(
    cfg: ModelConfig, kind: str, B: int, S: int, n_dev: int,
    p_loc: float, remat: str = "none", dtype_bytes: int = 2,
) -> float:
    """Per-device HBM traffic for one step (reads+writes)."""
    tokens_loc = (B * S if kind in ("train", "prefill") else B) / n_dev * \
        (n_dev / max(n_dev, 1))
    # tokens per device along the batch/seq shards ~ global/n_dev is a lower
    # bound; activations dominate via L passes over the residual stream.
    tokens_loc = max((B * S if kind in ("train", "prefill") else B) / n_dev, 1)
    D, L = cfg.d_model, cfg.n_layers
    if kind == "train":
        # params: bf16 read fwd+bwd (+1 remat fwd), grad write, Adam r/w fp32
        extra = 1 if remat == "full" else 0
        traffic = p_loc * (dtype_bytes * (2 + extra) + 4 + 24)
        traffic += L * tokens_loc * D * dtype_bytes * 12   # act rd/wr fwd+bwd
        traffic += tokens_loc * cfg.vocab / max(n_dev ** 0, 1) * dtype_bytes
    elif kind == "prefill":
        traffic = p_loc * dtype_bytes
        traffic += L * tokens_loc * D * dtype_bytes * 6
        if not cfg.attention_free:
            traffic += L * tokens_loc * cfg.n_kv_heads * cfg.resolved_head_dim \
                * 2 * dtype_bytes  # cache write
    else:  # decode: weights + full cache read dominate
        traffic = p_loc * dtype_bytes
        if not cfg.attention_free:
            cache = (L * B * S * cfg.n_kv_heads * cfg.resolved_head_dim * 2
                     * dtype_bytes) / n_dev
            n_local = sum(cfg.is_local_layer(i) for i in range(L))
            if cfg.window is not None and n_local:
                full_frac = (L - n_local) / L
                win_frac = n_local / L
                cache = cache * full_frac + cache * win_frac * min(
                    cfg.window / S, 1.0)
            traffic += cache
        if cfg.ssm is not None:
            traffic += (L * B * cfg.ssm.d_inner(D) * cfg.ssm.d_state * 4 * 2) / n_dev
    return traffic


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    coll_bytes: float
    model_flops: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_fraction(self) -> float:
        """Fraction of roofline: useful-compute time / dominant term."""
        ideal = self.model_flops_compute_s
        total = max(self.compute_s, self.memory_s, self.collective_s)
        return ideal / total if total > 0 else 0.0

    @property
    def model_flops_compute_s(self) -> float:
        return self.compute_s * (self.model_flops / max(self.flops, 1))


def roofline(cfg: ModelConfig, kind: str, B: int, S: int, n_dev: int,
             p_loc: float, coll_bytes_per_dev: float,
             remat: str = "none", dispatch_mode: str = "einsum",
             hw: Hardware = H100_SXM) -> RooflineTerms:
    flops = analytic_step_flops(cfg, kind, B, S, remat, dispatch_mode)
    hbm = analytic_hbm_bytes(cfg, kind, B, S, n_dev, p_loc, remat)
    return RooflineTerms(
        compute_s=flops / (n_dev * hw.peak_bf16),
        memory_s=hbm / hw.hbm_bw,
        collective_s=coll_bytes_per_dev / hw.link_bw,
        flops=flops,
        hbm_bytes=hbm,
        coll_bytes=coll_bytes_per_dev,
        model_flops=model_flops(cfg, kind, B, S),
    )


def mfu(cfg: ModelConfig, kind: str, B: int, S: int, step_s: float, n_dev: int = 1,
        hw: Hardware = H100_SXM) -> float:
    """Model FLOPs utilisation of a step measured at ``step_s`` seconds:
    MODEL_FLOPS / (devices x hw.peak_bf16 x step_s)."""
    return model_flops(cfg, kind, B, S) / (n_dev * hw.peak_bf16 * step_s)
