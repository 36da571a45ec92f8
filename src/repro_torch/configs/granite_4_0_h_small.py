"""granite-4.0-h-small [hybrid, MoE]: IBM Granite 4.0-H Small (32B-A9B)
[hf:ibm-granite/granite-4.0-h-small, config.json, model_type
granitemoehybrid].  40L d=4096; Mamba-2 (SSD) and GQA attention (32H kv=8,
head dim 128, no positional embedding) at 9:1, attention at layer 5 of
every 10 (``layer_types``: ``attn_layer_period`` 10, ``attn_layer_offset``
5); a MoE on every layer: 72 experts top-10 of width 768 (``intermediate_size``,
read as the expert width), gates a softmax over the top-10 router logits, and
one shared gated-SiLU expert of width 1536 (``shared_intermediate_size``)
beside them; Mamba-2 with 128 heads of 64 (expand 2), d_state 128, n_groups
1, conv 4, chunk 256, a gated RMSNorm before out_proj; ``embedding_multiplier``
12, ``residual_multiplier`` 0.22, ``attention_multiplier`` 1/128 as the
softmax scale, ``logits_scaling`` 16; vocab 100352, tied embeddings,
rms_norm_eps 1e-5, context 131072.  32.2B parameters, 8.8B active (the model
card rounds to 32B-A9B)."""
from repro_torch.models.config import Mamba2Config, MoEConfig, ScheduledModelConfig

CONFIG = ScheduledModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,
    vocab=100352,
    head_dim=128,
    act="silu",
    gated_mlp=True,
    rope="none",
    tie_embeddings=True,
    norm_eps=1e-5,
    moe=MoEConfig(num_experts=72, top_k=10, d_ff_expert=768),
    shared_d_ff=1536,
    ssm=Mamba2Config(n_heads=128, head_dim=64, d_state=128, d_conv=4, n_groups=1,
                     chunk_size=256),
    attn_layer_period=10,
    attn_layer_offset=5,
    expert_layer_period=1,
    expert_layer_offset=0,
    moe_renormalize=True,
    moe_dropless=True,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_scale=0.0078125,
    logits_scaling=16.0,
    max_seq_len=131072,
)
