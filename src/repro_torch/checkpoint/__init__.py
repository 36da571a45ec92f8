"""Checkpoint/restart of train state (counterpart of ``repro.checkpoint``)."""
from .ckpt import latest_step, restore, save

__all__ = ["latest_step", "restore", "save"]
