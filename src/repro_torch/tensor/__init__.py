"""Tensor algebra applications (paper §8.4)."""
from .ops import double_contraction, mttkrp, mttkrp_mode

__all__ = ["double_contraction", "mttkrp", "mttkrp_mode"]
