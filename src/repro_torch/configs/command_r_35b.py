"""command-r-35b [dense]: GQA, no biases [hf:CohereForAI/c4ai-command-r-v01].
40L d=8192 64H kv=8 d_ff=22528 vocab=256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    head_dim=128,
    act="silu",
    gated_mlp=True,
    tie_embeddings=True,
    max_seq_len=131072,
)
