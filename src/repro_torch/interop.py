"""Carry state from a reference run into the port.

The block runtime has no weights: its state is block data, generated from the seed with
numpy on the host in both packages.  ``carry_arrays`` rebuilds, in a port
context, arrays read off a reference context — their values, block grids and
placements — so a run started in ``repro`` can resume in ``repro_torch``.
The LM zoo's state is its weights: ``params_from_jax`` carries the
reference's parameters, so both packages serve the same model.  Both take
plain numpy arrays, dicts and tuples only, so this module imports nothing of
the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.backend.torch_backend import resolve_device
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


def params_from_jax(tree: Mapping[str, Any], device=None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The reference's model parameters (``repro.models.init_params``), or a
    whole train state (``{"params", "opt": {"m", "v", "step"}}``), handed
    over as a nested dict of numpy arrays, as the port's: the same keys and
    layouts (``x @ W`` with W (D, H*hd), stacked (L, ...) layer leaves, embed
    (V, D)), each leaf a plain copy on ``device`` (None: the card).  bfloat16
    arrays (numpy's ``ml_dtypes`` type) are carried bit for bit; ``dtype``
    casts every floating-point leaf (an integer step counter keeps its
    type)."""
    dev = resolve_device(device)

    def carry(x):
        if isinstance(x, Mapping):
            return {k: carry(v) for k, v in x.items()}
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        cast = dtype if dtype is not None and t.is_floating_point() else t.dtype
        return t.to(device=dev, dtype=cast)

    return carry(tree)
