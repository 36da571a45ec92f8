"""LM model zoo: the hymba-style hybrid (attention + SSM), Mamba, dense and
MoE decoders (M-RoPE too) and the whisper-style encoder-decoder, for
training and serving, with attention and the scan through the hand-written
kernels (forward and backward), sharded by logical-axis rules over a
DeviceMesh (``partitioning``)."""
from .config import Mamba2Config, ModelConfig, MoEConfig, ScheduledModelConfig, SSMConfig
from .partitioning import Rules, constrain, use_rules
from .transformer import decode_step, forward, init_params, param_shapes, prefill

__all__ = [
    "Mamba2Config",
    "ModelConfig",
    "MoEConfig",
    "Rules",
    "SSMConfig",
    "ScheduledModelConfig",
    "constrain",
    "decode_step",
    "forward",
    "init_params",
    "param_shapes",
    "prefill",
    "use_rules",
]
