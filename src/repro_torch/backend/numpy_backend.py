"""The numpy backend: the bit-exact reference interpreter.

This is the executor's historical per-op execution path
(``graph_array.execute_block_op``) extracted behind the ``BlockBackend``
protocol.  Blocks live as host numpy arrays, every op is interpreted one
``np.*`` call at a time, and semantics are — by definition — the oracle the
compiled backends must match.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.graph_array import execute_block_op

from .base import BlockBackend


class NumpyBackend(BlockBackend):
    name = "numpy"

    def from_host(self, arr: np.ndarray, placement: Tuple[int, int]):
        # host memory *is* device memory: no transfer to count
        return np.asarray(arr, dtype=self.dtype)

    def to_host(self, value) -> np.ndarray:
        return np.asarray(value)

    def execute(self, op: str, meta: Dict[str, Any], inputs: Sequence[Any],
                placement: Tuple[int, int]):
        self.stats.dispatches += 1
        return execute_block_op(op, meta, [np.asarray(x) for x in inputs])
