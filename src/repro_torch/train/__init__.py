"""Step builders (counterpart of ``repro.train``): the serving steps so far;
the train step, the optimizer and the data pipeline come with training
(ROADMAP Queue 1 item 6)."""
from .steps import make_prefill, make_serve_step

__all__ = ["make_prefill", "make_serve_step"]
