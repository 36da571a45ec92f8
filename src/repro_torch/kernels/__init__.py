"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``).

``ops.py`` holds the public wrappers; each kernel module holds the launch
code and, beside it, the kernel's plain PyTorch version (the port of
``repro.kernels.ref`` for that kernel); ``build.py`` compiles the sources
with ``nvcc`` on first use.
"""
from . import ops
from .ops import flash_attention, glm_fused, launches, mamba_scan, matmul, reset_launches

__all__ = ["flash_attention", "glm_fused", "launches", "mamba_scan", "matmul", "ops",
           "reset_launches"]
