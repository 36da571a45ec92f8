"""LM model zoo, inference side: the hymba-style hybrid (attention + SSM)
and dense decoders, with attention and the prefill scan through the
hand-written kernels.  MoE, encoder-decoder, M-RoPE, sharding rules and
training wait for later slices (ROADMAP Queue 1 items 6 and 7)."""
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
