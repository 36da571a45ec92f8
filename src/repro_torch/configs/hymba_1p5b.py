"""hymba-1.5b [hybrid]: parallel attention + Mamba heads per block
[arXiv:2411.13676].  32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16; sliding-window attention with periodic global layers keeps the
attention branch sub-quadratic (long_500k runs)."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    act="silu",
    gated_mlp=True,
    window=1024,
    local_global_ratio=7,   # global full-attention every 8th layer
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    hybrid_parallel=True,
    max_seq_len=524288,
)
