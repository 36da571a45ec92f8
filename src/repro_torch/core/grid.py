"""Logical block partitioning of dense arrays (paper §4).

An :class:`ArrayGrid` describes how an array of a given ``shape`` is split
into a grid of blocks along each axis.  Blocks may be uneven when the axis
size is not divisible by the grid size (the trailing block is smaller), which
generalizes the paper's even-partitioning examples.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Iterator, Sequence, Tuple

import numpy as np

Index = Tuple[int, ...]


@dataclass(frozen=True)
class ArrayGrid:
    """Logical partitioning of an array (the paper's *array grid*)."""

    shape: Tuple[int, ...]
    grid: Tuple[int, ...]
    dtype: str = "float64"

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.grid):
            raise ValueError(f"shape {self.shape} and grid {self.grid} rank mismatch")
        for s, g in zip(self.shape, self.grid):
            if g < 1:
                raise ValueError(f"grid entries must be >= 1, got {self.grid}")
            if g > max(s, 1):
                raise ValueError(f"grid {self.grid} exceeds shape {self.shape}")

    # -- geometry ---------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def num_blocks(self) -> int:
        return int(np.prod(self.grid)) if self.grid else 1

    def block_sizes(self, axis: int) -> Tuple[int, ...]:
        """Sizes of each block along ``axis`` (ceil-division split)."""
        s, g = self.shape[axis], self.grid[axis]
        base = math.ceil(s / g)
        sizes = []
        remaining = s
        for _ in range(g):
            sz = min(base, remaining)
            sizes.append(sz)
            remaining -= sz
        if remaining != 0 or any(sz <= 0 for sz in sizes):
            # fall back to an even-as-possible split
            base, extra = divmod(s, g)
            sizes = [base + (1 if i < extra else 0) for i in range(g)]
        return tuple(sizes)

    def block_shape(self, index: Index) -> Tuple[int, ...]:
        return tuple(self.block_sizes(a)[i] for a, i in enumerate(index))

    def block_slices(self, index: Index) -> Tuple[slice, ...]:
        out = []
        for a, i in enumerate(index):
            sizes = self.block_sizes(a)
            start = sum(sizes[:i])
            out.append(slice(start, start + sizes[i]))
        return tuple(out)

    def block_elements(self, index: Index) -> int:
        return int(np.prod(self.block_shape(index)))

    def iter_indices(self) -> Iterator[Index]:
        return itertools.product(*(range(g) for g in self.grid))

    def with_axis_dropped(self, axis: int) -> "ArrayGrid":
        shape = tuple(s for a, s in enumerate(self.shape) if a != axis)
        grid = tuple(g for a, g in enumerate(self.grid) if a != axis)
        return ArrayGrid(shape, grid, self.dtype)

    def with_axis_collapsed(self, axis: int) -> "ArrayGrid":
        """Collapse an axis to a single block (used by reductions keeping dims)."""
        shape = tuple(1 if a == axis else s for a, s in enumerate(self.shape))
        grid = tuple(1 if a == axis else g for a, g in enumerate(self.grid))
        return ArrayGrid(shape, grid, self.dtype)


def softmax(x: Sequence[float]) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    x = x - np.max(x)
    e = np.exp(x)
    return e / np.sum(e)


def auto_grid(shape: Sequence[int], num_workers: int, dtype: str = "float64") -> ArrayGrid:
    """Paper §4: grid = p ** softmax(shape).

    Larger axes receive a larger share of the ``num_workers`` factorization;
    a tall-skinny matrix is partitioned along its tall axis only and a square
    matrix is partitioned (√p, √p).  Entries are clipped to the axis size and
    rounded to integers ≥ 1.
    """
    shape = tuple(int(s) for s in shape)
    if not shape:
        return ArrayGrid((), (), dtype)
    # softmax over raw dimensions saturates for very skewed shapes (as the
    # paper intends); scale down so comparable dims share smoothly.
    scale = max(max(shape), 1)
    weights = softmax([4.0 * s / scale for s in shape])
    grid = []
    for s, w in zip(shape, weights):
        g = int(round(num_workers ** float(w)))
        g = max(1, min(g, max(s, 1)))
        grid.append(g)
    # Do not over-factor: shrink smallest contributors until prod(grid) <= 2p.
    while int(np.prod(grid)) > 2 * num_workers:
        j = int(np.argmin(weights))
        order = np.argsort(weights)
        for j in order:
            if grid[j] > 1:
                grid[j] -= 1
                break
        else:
            break
    return ArrayGrid(shape, tuple(grid), dtype)
