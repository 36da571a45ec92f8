"""MTTKRP and tensor double contraction (paper §8.4).

MTTKRP (Matricized Tensor Times Khatri-Rao Product) is the closed-form inner
step of alternating least squares for CP tensor factorization:
    M[i, f] = sum_{j,k} X[i,j,k] B[j,f] C[k,f]
expressed in Einstein notation as einsum("ijk,jf,kf->if").  The double
contraction sums over two shared modes: einsum("ijk,jkf->if") ==
tensordot(X, Y, axes=2).
"""
from __future__ import annotations

from repro_torch.core import GraphArray, einsum, tensordot


def mttkrp(X: GraphArray, B: GraphArray, C: GraphArray) -> GraphArray:
    return einsum("ijk,jf,kf->if", X, B, C).compute()


def mttkrp_mode(X: GraphArray, factors, mode: int) -> GraphArray:
    """MTTKRP along any mode of a 3-way tensor: contracts ``X`` with the two
    factors of the *other* modes.  ``factors`` is the full ``[A, B, C]``
    list; the entry at ``mode`` is ignored.

    Blocked einsum requires each factor's row grid to match the tensor's
    grid on the shared subscript — the very restriction that made only the
    mode-1 MTTKRP expressible before resharding existed.  Factors whose
    grids don't line up are resharded into alignment, so any mode works on
    any tensor partitioning.  This is the reduce-based alternative to the
    matricization path in ``repro_torch.factor``: contractions over partitioned
    modes pay a reduce tree instead of a tensor layout change."""
    mode = mode % 3
    letters = "ijk"
    rest = [m for m in range(3) if m != mode]
    ops = []
    for m in rest:
        f = factors[m]
        want = (X.grid.grid[m], 1)
        if f.grid.grid != want:
            f = f.reshard(grid=want)
        ops.append(f)
    spec = (letters + "," + ",".join(letters[m] + "f" for m in rest)
            + "->" + letters[mode] + "f")
    return einsum(spec, X, *ops).compute()


def double_contraction(X: GraphArray, Y: GraphArray) -> GraphArray:
    return tensordot(X, Y, axes=2).compute()
