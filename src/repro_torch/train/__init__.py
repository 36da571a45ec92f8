"""Training substrate (counterpart of ``repro.train``): optimizer, step
builders, data pipeline.  Gradient compression (``train/compress.py``)
waits for SPMD sharding (ROADMAP Queue 1 item 7)."""
from .data import DataConfig, TokenPipeline
from .optim import AdamConfig, adam_update, global_norm, init_opt_state, lr_at
from .steps import (cross_entropy, init_train_state, make_grad_fn, make_prefill,
                    make_serve_step, make_train_step)

__all__ = ["AdamConfig", "DataConfig", "TokenPipeline", "adam_update", "cross_entropy",
           "global_norm", "init_opt_state", "init_train_state", "lr_at", "make_grad_fn",
           "make_prefill", "make_serve_step", "make_train_step"]
