"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``).

``ops.py`` holds the public wrappers; each kernel module holds the launch
code and, beside it, the kernel's plain PyTorch version (the port of
``repro.kernels.ref`` for that kernel); ``build.py`` compiles the sources
with ``nvcc`` on first use.
"""
from . import ops
from .ops import glm_fused, launches, matmul, reset_launches

__all__ = ["glm_fused", "launches", "matmul", "ops", "reset_launches"]
