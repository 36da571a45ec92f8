"""The cuda backend: the hand-written Hopper matmul under the torch backend.

Counterpart of ``repro.backend.pallas_backend.PallasBackend``.  Routes every
2-D ``matmul`` block op (with its ``ta``/``tb`` flags) through
``repro_torch.kernels.ops.matmul`` -> ``csrc/matmul.cu``; a transposed
operand is passed as a strided view, never copied.  Every other op — and
the 1-D matmul/dot forms the block graphs emit for vectors — goes to the
parent torch backend, so a mixed graph splits between the hand-written
kernel and torch.  On CPU tensors the kernel wrapper runs its plain PyTorch
version, so the same backend runs (and is tested) without a card.

The matmul callables share the structural compile cache with the torch
backend under their own flavor salt (``"cuda"``), so a kernel matmul and a
torch matmul of identical structure cache separately while all other ops
share the torch backend's entries.  The GLM fused kernel stays off this
dispatch, as the Pallas one does in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

from repro_torch.kernels.ops import matmul as kernel_matmul

from .torch_backend import TorchBackend


class CudaBackend(TorchBackend):
    name = "cuda"

    def execute(self, op: str, meta: Dict[str, Any], inputs: Sequence[Any],
                placement: Tuple[int, int]):
        if op != "matmul" or any(x.ndim != 2 for x in inputs):
            return super().execute(op, meta, inputs, placement)
        return self._dispatch("cuda", op, meta, inputs, placement,
                              self._build_kernel_matmul)

    def _build_kernel_matmul(self, op: str, meta: Dict[str, Any]):
        ta, tb = bool(meta.get("ta")), bool(meta.get("tb"))

        def cuda_matmul(a, b):
            return kernel_matmul(a.mT if ta else a, b.mT if tb else b)

        return cuda_matmul
