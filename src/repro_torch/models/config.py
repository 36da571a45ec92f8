"""Model configuration for the LM zoo (assigned architectures).

One :class:`ModelConfig` describes any member of the zoo: dense decoder
transformers (GQA + RoPE variants), sliding-window hybrids, MoE, Mamba-1 SSM,
parallel attn+SSM hybrids (hymba), encoder-decoder (whisper) and stub-fronted
VLM/audio backbones.  ``reduced()`` produces the CPU smoke-test variant of the
same family.

The port's own copy of ``repro.models.config`` (pure Python), kept the same
in behaviour so that configurations, ``reduced()``, ``is_local_layer`` and
``param_count`` agree between the packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # router options
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model/16)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank is not None else max(1, d_model // 16)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free
    n_kv_heads: int
    d_ff: int                        # dense MLP width (0 if pure SSM / pure MoE)
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    act: str = "silu"                # silu | gelu | relu2  (gated unless relu2)
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    rope: str = "rope"               # rope | mrope | none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # qwen2-vl temporal/h/w
    window: Optional[int] = None     # sliding-window size for local layers
    local_global_ratio: int = 0      # N local layers per 1 global (gemma3: 5)
    logit_softcap: Optional[float] = None
    scale_embed: bool = False        # gemma: embeddings scaled by sqrt(d)
    learned_pos: bool = False        # whisper decoder: learned positions
    tie_embeddings: bool = False
    qk_norm: bool = False
    attn_bias: bool = False
    mlp_bias: bool = False
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_parallel: bool = False    # hymba: attention + SSM heads in parallel
    # encoder-decoder (whisper)
    encdec: bool = False
    n_enc_layers: int = 0
    enc_max_len: int = 1500          # whisper: 30 s of 20 ms frames
    # stub modality frontend: inputs may be precomputed embeddings
    embed_inputs: bool = False
    max_seq_len: int = 131072
    dtype: str = "bfloat16"

    # -- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM/hybrid/sliding-window families)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window is not None and self.local_global_ratio > 0

    def is_local_layer(self, layer_idx: int) -> bool:
        """gemma3-style local:global interleave — every (ratio+1)-th layer is
        global, the rest are sliding-window."""
        if self.window is None:
            return False
        if self.local_global_ratio <= 0:
            return True
        return (layer_idx + 1) % (self.local_global_ratio + 1) != 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        total = self.vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab * d
        per_layer = 0
        if not self.attention_free:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            per_layer += q + kv + o
        if self.ssm is not None:
            di = self.ssm.d_inner(d)
            dtr = self.ssm.resolved_dt_rank(d)
            per_layer += d * 2 * di                 # in_proj (x, z)
            per_layer += di * self.ssm.d_conv       # conv
            per_layer += di * (dtr + 2 * self.ssm.d_state)  # x_proj
            per_layer += dtr * di + di              # dt_proj
            per_layer += di * self.ssm.d_state + di  # A_log, D
            per_layer += di * d                      # out_proj
        if self.moe is not None:
            e = self.moe
            per_layer += d * e.num_experts           # router
            fmul = 3 if self.gated_mlp else 2
            per_layer += e.num_experts * fmul * d * e.d_ff_expert
        elif self.d_ff:
            fmul = 3 if self.gated_mlp else 2
            per_layer += fmul * d * self.d_ff
        per_layer += 2 * d  # norms
        total += L * per_layer
        if self.encdec:
            enc_layer = 4 * d * d + (3 if self.gated_mlp else 2) * d * self.d_ff + 2 * d
            cross = 4 * d * d + d
            total += self.n_enc_layers * enc_layer + L * cross
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        dense = dataclasses.replace(self, moe=None)
        d = self.d_model
        fmul = 3 if self.gated_mlp else 2
        active_ff = self.n_layers * (
            d * self.moe.num_experts + self.moe.top_k * fmul * d * self.moe.d_ff_expert
        )
        return int(dense.param_count() + active_ff)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/topology, tiny sizes."""
        kw = dict(
            n_layers=min(self.n_layers, 2 if not self.encdec else 2),
            d_model=64,
            n_heads=0 if self.attention_free else 4,
            n_kv_heads=0 if self.attention_free else min(max(self.n_kv_heads, 1), 2),
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16 if not self.attention_free else None,
            max_seq_len=512,
            dtype="float32",
        )
        if self.rope == "mrope":
            kw["mrope_sections"] = (2, 3, 3)  # sums to reduced head_dim/2
        if self.moe is not None:
            kw["moe"] = MoEConfig(num_experts=4, top_k=min(self.moe.top_k, 2), d_ff_expert=64)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=8, d_conv=4, expand=2)
        if self.encdec:
            kw["n_enc_layers"] = 2
            kw["enc_max_len"] = 64
        if self.window is not None:
            kw["window"] = 16
        return dataclasses.replace(self, **kw)
