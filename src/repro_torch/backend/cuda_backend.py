"""The cuda backend: the hand-written Hopper matmul under the torch backend.

Counterpart of ``repro.backend.pallas_backend.PallasBackend``.  Its op table
is the torch backend's with one entry changed: a ``matmul`` of two 2-D
blocks (with its ``ta``/``tb`` flags) goes through
``repro_torch.kernels.ops.matmul`` -> ``csrc/matmul.cu``, a transposed
operand passed as a strided view, never copied.  Every other op — and the
1-D matmul/dot forms the block graphs emit for vectors — runs as on the
torch backend, so a mixed graph splits between the hand-written kernel and
torch.  On CPU tensors the kernel wrapper runs its plain PyTorch version, so
the same backend runs (and is tested) without a card.  The GLM fused kernel
stays off this dispatch, as the Pallas one does in the reference.
"""
from __future__ import annotations

from repro_torch.kernels.ops import matmul as kernel_matmul

from .torch_backend import OPS, TorchBackend, matmul


def _kernel_matmul(meta, a, b):
    if a.ndim != 2 or b.ndim != 2:
        return matmul(meta, a, b)
    return kernel_matmul(a.mT if meta.get("ta") else a,
                         b.mT if meta.get("tb") else b)


class CudaBackend(TorchBackend):
    name = "cuda"
    ops = {**OPS, "matmul": _kernel_matmul}
