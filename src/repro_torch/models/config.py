"""Model configuration for the LM zoo (assigned architectures).

One :class:`ModelConfig` describes any member of the zoo: dense decoder
transformers (GQA + RoPE variants), sliding-window hybrids, MoE (with a
shared expert), Mamba-1 and Mamba-2 SSM,
parallel attn+SSM hybrids (hymba), encoder-decoder (whisper) and stub-fronted
VLM/audio backbones.  ``reduced()`` produces the CPU smoke-test variant of the
same family.

The port's own copy of ``repro.models.config`` (pure Python), kept the same
in behaviour so that configurations, ``reduced()``, ``is_local_layer`` and
``param_count`` agree between the packages.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import ClassVar, Dict, Optional, Tuple, Union


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
    """A Mamba-1 selective state-space mixer (``models/ssm.py``): a
    (d_inner, d_state) state with a per-channel A and a low-rank dt
    (``dt_rank``)."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model/16)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank is not None else max(1, d_model // 16)


@dataclass(frozen=True)
class Mamba2Config:
    """A Mamba-2 (SSD, Dao & Gu 2024) mixer (``models/ssd.py``): ``n_heads``
    heads of ``head_dim`` channels, a scalar A and dt a head, B and C of
    ``d_state`` shared by the heads of each of ``n_groups`` groups, a
    (head_dim, d_state) state a head, a gated RMSNorm before out_proj, and a
    prefill in chunks of ``chunk_size`` positions."""
    n_heads: int
    head_dim: int
    d_state: int = 128
    d_conv: int = 4
    n_groups: int = 1
    chunk_size: int = 256

    @property
    def d_inner(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def conv_channels(self) -> int:
        """Channels of the causal conv: x, B and C."""
        return self.d_inner + 2 * self.n_groups * self.d_state

    def n_params(self, d_model: int) -> int:
        """Parameters of one mixer."""
        di, cc, h = self.d_inner, self.conv_channels, self.n_heads
        return (d_model * (di + cc + h)      # in_proj (z, xBC, dt)
                + cc * self.d_conv + cc      # conv and its bias
                + 3 * h                      # dt_bias, A_log, D
                + di                         # the gated norm
                + di * d_model)              # out_proj


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
    ssm: Optional[Union[SSMConfig, Mamba2Config]] = None
    hybrid_parallel: bool = False    # hymba: attention + SSM heads in parallel
    # encoder-decoder (whisper)
    encdec: bool = False
    n_enc_layers: int = 0
    enc_max_len: int = 1500          # whisper: 30 s of 20 ms frames
    # stub modality frontend: inputs may be precomputed embeddings
    embed_inputs: bool = False
    max_seq_len: int = 131072
    dtype: str = "bfloat16"
    #: whether the layers differ in kind (``ScheduledModelConfig``), so that
    #: layer leaves and caches are stacked per kind
    scheduled: ClassVar[bool] = False

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

    # Every layer alike: the parts the config has are in every layer.
    def is_attention_layer(self, layer_idx: int) -> bool:
        return not self.attention_free

    def is_ssm_layer(self, layer_idx: int) -> bool:
        return self.ssm is not None

    def is_moe_layer(self, layer_idx: int) -> bool:
        return self.moe is not None

    def is_mlp_layer(self, layer_idx: int) -> bool:
        return bool(self.d_ff) and not self.is_moe_layer(layer_idx)

    def layer_kinds(self, layer_idx: int) -> Tuple[str, ...]:
        """The parts of layer ``layer_idx``, of "attn", "ssm", "moe" and
        "mlp", in that order."""
        return tuple(kind for kind, has in (
            ("attn", self.is_attention_layer(layer_idx)), ("ssm", self.is_ssm_layer(layer_idx)),
            ("moe", self.is_moe_layer(layer_idx)), ("mlp", self.is_mlp_layer(layer_idx)))
            if has)

    def layer_slots(self) -> Tuple[Dict[str, int], ...]:
        """For each layer, each of its parts' index among the layers that
        have that part: the row of its stacked leaves and caches.  Without a
        schedule every part's index is the layer's own.  Worked out once per
        config (the decode path asks every step)."""
        return _layer_slots(self)

    def layer_count(self, kind: str) -> int:
        """How many layers have the part ``kind``."""
        return sum(kind in self.layer_kinds(i) for i in range(self.n_layers))

    def part_params(self) -> Dict[str, int]:
        """Parameters of one layer's part of each kind ("attn", "ssm", "moe",
        "mlp"; norms aside) that the config has."""
        d, hd = self.d_model, self.resolved_head_dim
        fmul = 3 if self.gated_mlp else 2
        parts: Dict[str, int] = {}
        if not self.attention_free:
            parts["attn"] = 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
        if isinstance(self.ssm, Mamba2Config):
            parts["ssm"] = self.ssm.n_params(d)
        elif self.ssm is not None:
            s = self.ssm
            di, dtr = s.d_inner(d), s.resolved_dt_rank(d)
            parts["ssm"] = (d * 2 * di                 # in_proj (x, z)
                            + di * s.d_conv             # conv (its bias uncounted,
                                                        # as in the reference's count)
                            + di * (dtr + 2 * s.d_state)  # x_proj
                            + dtr * di + di             # dt_proj
                            + di * s.d_state + di       # A_log, D
                            + di * d)                   # out_proj
            if getattr(self, "ssm_inner_norms", False):
                parts["ssm"] += dtr + 2 * s.d_state
        if self.moe is not None:
            e = self.moe
            parts["moe"] = (d * e.num_experts + e.num_experts * fmul * d * e.d_ff_expert
                            + fmul * d * getattr(self, "shared_d_ff", 0))
        if self.d_ff:
            parts["mlp"] = fmul * d * self.d_ff
        return parts

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head), each layer
        counted by its parts."""
        d, L = self.d_model, self.n_layers
        total = self.vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab * d
        parts = self.part_params()
        for i in range(L):
            total += sum(parts[kind] for kind in self.layer_kinds(i)) + 2 * d  # norms
        if self.encdec:
            enc_layer = 4 * d * d + (3 if self.gated_mlp else 2) * d * self.d_ff + 2 * d
            cross = 4 * d * d + d
            total += self.n_enc_layers * enc_layer + L * cross
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        fmul = 3 if self.gated_mlp else 2
        idle = (e.num_experts - e.top_k) * fmul * self.d_model * e.d_ff_expert
        return int(self.param_count() - self.layer_count("moe") * idle)

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


@dataclass(frozen=True)
class ScheduledModelConfig(ModelConfig):
    """A config whose layers differ in kind by a schedule (Jamba), with the
    options its parts take.  Layer i is attention iff ``i %
    attn_layer_period == attn_layer_offset`` (else SSM), and MoE iff ``i %
    expert_layer_period == expert_layer_offset`` (else the dense MLP).
    ``moe_renormalize``: the top-k gates divided by their sum (GShard,
    Mixtral), or left as the softmax over all experts gave them.
    ``moe_dropless``: every (token, choice) pair reaches its expert
    (``moe.moe_block``'s grouped route), with no capacity.
    ``ssm_inner_norms``: RMSNorms on dt, B and C after ``x_proj``.
    ``shared_d_ff``: the width of a shared expert, a gated MLP over every
    token added to the routed experts' output, ungated by the router (0:
    none).  Granite's multipliers: the embeddings times
    ``embedding_multiplier``, each sublayer's output times
    ``residual_multiplier`` before its residual add, attention's scores
    times ``attention_scale`` (None: 1/sqrt(head dim)), the logits over
    ``logits_scaling``.  The zoo's other configs lack these options:
    ``moe.py``, ``ssm.py``, ``layers.py`` and ``transformer.py`` read them
    where a config has them."""
    attn_layer_period: int = 1
    attn_layer_offset: int = 0
    expert_layer_period: int = 1
    expert_layer_offset: int = 0
    moe_renormalize: bool = True
    moe_dropless: bool = False
    ssm_inner_norms: bool = False
    shared_d_ff: int = 0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_scale: Optional[float] = None
    logits_scaling: float = 1.0
    scheduled: ClassVar[bool] = True

    def is_attention_layer(self, layer_idx: int) -> bool:
        return (not self.attention_free
                and layer_idx % self.attn_layer_period == self.attn_layer_offset)

    def is_ssm_layer(self, layer_idx: int) -> bool:
        return self.ssm is not None and not self.is_attention_layer(layer_idx)

    def is_moe_layer(self, layer_idx: int) -> bool:
        return (self.moe is not None
                and layer_idx % self.expert_layer_period == self.expert_layer_offset)

    def reduced(self) -> "ScheduledModelConfig":
        """Tiny sizes, keeping one whole period of the layers (and a shared
        expert and Mamba-2's heads, groups and chunks where the config has
        them)."""
        period = max(2, self.attn_layer_period, self.expert_layer_period)
        kw = dict(n_layers=min(self.n_layers, period))
        if self.shared_d_ff:
            kw["shared_d_ff"] = 96
        if isinstance(self.ssm, Mamba2Config):
            kw["ssm"] = Mamba2Config(n_heads=8, head_dim=16, d_state=16, chunk_size=16)
        return dataclasses.replace(super().reduced(), **kw)


@functools.lru_cache(maxsize=64)
def _layer_slots(cfg: ModelConfig) -> Tuple[Dict[str, int], ...]:
    seen: Dict[str, int] = {}
    slots = []
    for i in range(cfg.n_layers):
        kinds = cfg.layer_kinds(i)
        slots.append({kind: seen.get(kind, 0) if cfg.scheduled else i for kind in kinds})
        for kind in kinds:
            seen[kind] = seen.get(kind, 0) + 1
    return tuple(slots)
