"""Distributed linear algebra on GraphArray (paper §8.2-8.3, Appendix A)."""
from .cholesky import cholesky, cholesky_solve
from .matmul import recursive_matmul, summa_matmul
from .qr import tsqr_direct, tsqr_indirect
from .rsvd import rsvd

__all__ = [
    "cholesky",
    "cholesky_solve",
    "recursive_matmul",
    "rsvd",
    "summa_matmul",
    "tsqr_direct",
    "tsqr_indirect",
]
