"""whisper-small [audio]: encoder-decoder; conv frontend is a stub
(input_specs provides precomputed frames) [arXiv:2212.04356].
12L enc + 12L dec, d=768 12H d_ff=3072 vocab=51865."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    head_dim=64,
    act="gelu",
    gated_mlp=False,
    norm="layernorm",
    rope="none",
    learned_pos=True,
    attn_bias=True,
    encdec=True,
    n_enc_layers=12,
    enc_max_len=1500,
    embed_inputs=True,
    max_seq_len=32769,
)
