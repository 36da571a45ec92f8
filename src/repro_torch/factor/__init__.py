"""Tensor factorization on GraphArrays (paper §8.4, full CP-ALS)."""
from .cpals import (
    CPALSResult,
    cp_als,
    cp_als_reference,
    khatri_rao,
    matricize,
)

__all__ = [
    "CPALSResult",
    "cp_als",
    "cp_als_reference",
    "khatri_rao",
    "matricize",
]
