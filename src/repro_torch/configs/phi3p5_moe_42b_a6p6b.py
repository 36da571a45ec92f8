"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct].  32L d=4096 32H kv=8 d_ff_expert=6400
vocab=32064."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,
    vocab=32064,
    head_dim=128,
    act="silu",
    gated_mlp=True,
    norm="layernorm",
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400),
    max_seq_len=131072,
)
