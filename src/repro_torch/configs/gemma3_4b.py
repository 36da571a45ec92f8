"""gemma3-4b [dense]: 5:1 local:global sliding-window attention, 128k context
[hf:google/gemma-3-*-pt].  34L d=2560 8H kv=4 d_ff=10240 vocab=262144.
Sub-quadratic in 5/6 of its layers -> long_500k runs (window-hybrid)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab=262144,
    head_dim=256,
    act="gelu",
    gated_mlp=True,
    window=1024,
    local_global_ratio=5,
    qk_norm=True,
    scale_embed=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
    max_seq_len=524288,
)
