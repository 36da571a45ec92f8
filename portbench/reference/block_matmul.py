"""Plain PyTorch matrix product, one block row of C at a time.

The reference the port's block DGEMM is judged against.  It imports
nothing of the port: each block row of ``C = A @ B`` is ``A[rows] @ B`` in
the operands' own dtype.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import torch


def product_rows(A: torch.Tensor, B: torch.Tensor,
                 row_blocks: int) -> Iterator[Tuple[int, torch.Tensor]]:
    """``(i, A[rows_i] @ B)`` for each of ``row_blocks`` equal block rows."""
    rows = A.shape[0] // row_blocks
    for i in range(row_blocks):
        yield i, A[i * rows:(i + 1) * rows] @ B
