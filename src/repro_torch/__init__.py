"""repro_torch: the PyTorch/CUDA port of ``repro`` (NumS/LSHS, Elibol et
al., 2022) for an NVIDIA H100.

The reference package ``repro`` (JAX, Pallas TPU kernels) stays beside it;
this package imports neither.  Its blocks are torch tensors on the card
(or on the CPU when asked), and every TPU kernel on its path is a
hand-written Hopper kernel under ``csrc/``.

Subpackages: core, backend, kernels, glm, models, train, checkpoint,
sharding, configs, launch, obs.
"""
__version__ = "0.1.0"
