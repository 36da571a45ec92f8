"""Carry block state from a reference run into the port.

NumS has no weights: its state is block data, generated from the seed with
numpy on the host in both packages.  ``carry_arrays`` rebuilds, in a port
context, arrays read off a reference context — their values, block grids and
placements — so a run started in ``repro`` can resume in ``repro_torch``.
It takes plain numpy arrays and tuples only, so this module imports nothing
of the reference.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

from repro_torch.core import ArrayContext, GraphArray

#: one array as read off a reference context:
#: (``ga.to_numpy()``, ``ga.grid.grid``, ``ga.placements()``)
Carried = Tuple[np.ndarray, Sequence[int], Mapping[Tuple[int, ...], Tuple[int, int]]]


def carry_arrays(ctx: ArrayContext,
                 arrays: Mapping[str, Carried]) -> Dict[str, GraphArray]:
    """Rebuild each ``{name: (values, grid, placements)}`` as a GraphArray of
    ``ctx`` with the same block values, and assert that the port's layout
    places every block where the reference had it."""
    out: Dict[str, GraphArray] = {}
    for name, (values, grid, placements) in arrays.items():
        ga = ctx.from_numpy(np.asarray(values), grid=tuple(grid))
        got = {tuple(k): tuple(v) for k, v in ga.placements().items()}
        want = {tuple(k): tuple(v) for k, v in placements.items()}
        if got != want:
            raise AssertionError(f"{name}: port placements {got} differ from "
                                 f"the reference's {want}")
        out[name] = ga
    return out
