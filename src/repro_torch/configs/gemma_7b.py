"""gemma-7b [dense]: GeGLU, head_dim=256, MQA-free 16/16 heads
[arXiv:2403.08295].  28L d=3072 16H kv=16 d_ff=24576 vocab=256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab=256000,
    head_dim=256,
    act="gelu",
    gated_mlp=True,
    scale_embed=True,
    tie_embeddings=True,
    max_seq_len=32768,
)
