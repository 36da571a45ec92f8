"""Operations, bytes and roofline bounds of block products, and the
published peaks they are held to.

A frozen copy of the arithmetic that ``chip_smoke.py`` uses for its kernel
cases (``bound``): the least time of a product is the larger of its
operations over the peak rate of its dtype and its bytes over the HBM
bandwidth, each input byte read once and each output byte written once.
The peaks live in ``peaks.json`` beside this file.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Tuple

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"

ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2}


def load_peaks(path: Path = PEAKS_FILE) -> Dict:
    with open(path) as f:
        return json.load(f)


def product_flops(m: int, k: int, n: int) -> float:
    """Operations of one (m, k) @ (k, n) product: a multiply and an add per
    term."""
    return 2.0 * m * k * n


def product_bytes(m: int, k: int, n: int, dtype: str) -> float:
    """Bytes of one (m, k) @ (k, n) product: A and B read once, C written
    once."""
    return float(ITEMSIZE[dtype] * (m * k + k * n + m * n))


def product_bound_s(m: int, k: int, n: int, dtype: str, peaks: Dict) -> Tuple[float, str]:
    """The least seconds one product can take on the card, and which of the
    two limits sets it ("operations" or "bytes")."""
    t_ops = product_flops(m, k, n) / peaks["flops_per_s"][dtype]
    t_bytes = product_bytes(m, k, n, dtype) / peaks["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def products_bound_s(products: Iterable[Tuple[int, int, int, int]], dtype: str,
                     peaks: Dict) -> float:
    """Summed bound of ``(m, k, n, count)`` products."""
    return sum(count * product_bound_s(m, k, n, dtype, peaks)[0]
               for m, k, n, count in products)
