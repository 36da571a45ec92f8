"""falcon-mamba-7b [ssm]: attention-free Mamba-1 [arXiv:2410.05355].
64L d=4096 ssm_state=16 vocab=65024.  Constant state -> long_500k runs."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    rope="none",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    max_seq_len=524288,
)
