"""qwen3-moe-235b-a22b [moe]: 128 experts top-8 [hf:Qwen/Qwen3-*].
94L d=4096 64H kv=4 d_ff_expert=1536 vocab=151936."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=0,
    vocab=151936,
    head_dim=128,
    act="silu",
    gated_mlp=True,
    qk_norm=True,
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
    max_seq_len=131072,
)
