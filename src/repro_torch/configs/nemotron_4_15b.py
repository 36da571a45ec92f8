"""nemotron-4-15b [dense]: GQA, squared-ReLU ungated MLP [arXiv:2402.16819].
32L d=6144 48H kv=8 d_ff=24576 vocab=256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    head_dim=128,
    act="relu2",
    gated_mlp=False,
    norm="layernorm",
    max_seq_len=32768,
)
