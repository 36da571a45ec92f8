"""qwen2-vl-7b [vlm]: M-RoPE text backbone; vision frontend is a stub
(input_specs provides patch embeddings) [arXiv:2409.12191].
28L d=3584 28H kv=4 d_ff=18944 vocab=152064."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    head_dim=128,
    act="silu",
    gated_mlp=True,
    rope="mrope",
    mrope_sections=(16, 24, 24),
    attn_bias=True,
    embed_inputs=True,
    max_seq_len=131072,
)
