"""jamba2-mini [hybrid, MoE]: AI21-Jamba2-Mini
[hf:ai21labs/AI21-Jamba2-Mini, config.json, model_type jamba].  32L d=4096;
Mamba-1 and GQA attention (32H kv=8, head dim 128, no positional embedding)
at 7:1, attention at layer 4 of every 8 (``attn_layer_period`` 8,
``attn_layer_offset`` 4); a 16-expert top-2 MoE on the odd layers and a
dense gated-SiLU MLP on the even ones (``expert_layer_period`` 2, offset 1),
both of width 14336 (``intermediate_size``, read as the expert width too);
router softmax over all 16 experts, top-2 gates not renormalised, dropless;
Mamba d_state 16, d_conv 4, expand 2, dt_rank 256, RMSNorms on dt, B and C;
vocab 65536, untied head, rms_norm_eps 1e-6, context 262144.  51.6B
parameters, 12.1B active."""
from repro_torch.models.config import MoEConfig, ScheduledModelConfig, SSMConfig

CONFIG = ScheduledModelConfig(
    name="jamba2-mini",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    head_dim=128,
    act="silu",
    gated_mlp=True,
    rope="none",
    norm_eps=1e-6,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
    attn_layer_period=8,
    attn_layer_offset=4,
    expert_layer_period=2,
    expert_layer_offset=1,
    moe_renormalize=False,
    moe_dropless=True,
    ssm_inner_norms=True,
    max_seq_len=262144,
)
