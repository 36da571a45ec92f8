"""LM model zoo: the hymba-style hybrid (attention + SSM) and dense
decoders, for training and serving, with attention and the scan through
the hand-written kernels (forward and backward).  MoE, encoder-decoder,
M-RoPE and sharding rules wait for later slices (ROADMAP Queue 1 items 6
and 7)."""
from .config import ModelConfig, MoEConfig, SSMConfig
from .partitioning import Rules, constrain, use_rules
from .transformer import decode_step, forward, init_params, param_shapes, prefill

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "Rules",
    "SSMConfig",
    "constrain",
    "decode_step",
    "forward",
    "init_params",
    "param_shapes",
    "prefill",
    "use_rules",
]
