"""Communication lower bounds under the α-β-γ model (paper §7, Appendix A).

All functions return *communication time in seconds* for a dense array of
size ``N`` elements split into ``p`` worker-level blocks of ``n = N/p``
elements over ``k`` nodes with ``r = p/k`` workers per node.

Channels:
  C(n) = α  + β  n   — inter-node transfer
  D(n) = α″ + β″ n   — Dask intra-node worker->worker transfer (TCP)
  R(n) = α′ + β′ n   — Ray intra-node shared-memory write ("implicit" cost)
with α ≫ α″ > α′ and β ≫ β″ > β′, plus γ per dispatched RFC.

"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class CommModel:
    alpha: float = 1e-3       # inter-node latency (s)
    beta: float = 1.0 / 2.5e9  # inter-node inverse bandwidth (s/B): 20 Gbps
    alpha_d: float = 1e-4     # Dask intra-node latency
    beta_d: float = 1.0 / 10e9
    alpha_r: float = 1e-5     # Ray shared-memory latency
    beta_r: float = 1.0 / 50e9
    gamma: float = 1e-4       # driver dispatch latency per RFC
    bytes_per_element: int = 8

    def C(self, n: float) -> float:
        return self.alpha + self.beta * n * self.bytes_per_element

    def D(self, n: float) -> float:
        return self.alpha_d + self.beta_d * n * self.bytes_per_element

    def R(self, n: float) -> float:
        return self.alpha_r + self.beta_r * n * self.bytes_per_element

    def degraded(self, link_factor: float) -> "CommModel":
        """Chaos-runtime link degradation: a copy of this model with every
        network channel's inverse bandwidth scaled by ``link_factor`` (>= 1
        slows links; latencies and the γ dispatch cost are unchanged)."""
        if link_factor < 1.0:
            raise ValueError("link_factor must be >= 1 (1.0 = healthy links)")
        return CommModel(
            alpha=self.alpha, beta=self.beta * link_factor,
            alpha_d=self.alpha_d, beta_d=self.beta_d * link_factor,
            alpha_r=self.alpha_r, beta_r=self.beta_r * link_factor,
            gamma=self.gamma, bytes_per_element=self.bytes_per_element,
        )


# -- Appendix A bounds (Ray communication time) -------------------------------

def unary_elementwise(m: CommModel, N: float, p: int, k: int) -> float:
    """A.1: lower bound γp; LSHS incurs ≈ R(n) beyond it (object-store write)."""
    return m.gamma * p


def binary_elementwise(m: CommModel, N: float, p: int, k: int) -> float:
    """A.1: γp — LSHS achieves 0 inter-node communication."""
    return m.gamma * p


def reduction(m: CommModel, N: float, p: int, k: int) -> float:
    """A.2: γ(p-1) + log2(r)·R(n) + log2(k)·C(n)."""
    n = N / p
    r = max(p // k, 1)
    return (
        m.gamma * (p - 1)
        + math.log2(max(r, 1)) * m.R(n)
        + math.log2(max(k, 1)) * m.C(n)
    )


def blockwise_inner(m: CommModel, N: float, p: int, k: int) -> float:
    """A.3: X^T Y row-partitioned: γ(2p-1) + log2(k)C(n) + (1+log2(r))R(n)."""
    n = N / p
    r = max(p // k, 1)
    return (
        m.gamma * (2 * p - 1)
        + math.log2(max(k, 1)) * m.C(n)
        + (1 + math.log2(max(r, 1))) * m.R(n)
    )


def blockwise_outer(m: CommModel, N: float, p: int, k: int) -> float:
    """A.4: X Y^T with √p row partitions: γp + 2(√k - 1)·r·C(n)."""
    sp = math.isqrt(p)
    n = N / sp
    r = max(p // k, 1)
    sk = math.sqrt(k)
    return m.gamma * p + 2.0 * (sk - 1.0) * r * m.C(n)


def square_matmul_lshs(m: CommModel, N: float, p: int, k: int) -> float:
    """A.5: (√k + log√k)·r·C(n) + log(√r)·R(n) (diagonal terms dropped)."""
    n = N / p
    r = max(p // k, 1)
    sk = math.sqrt(k)
    sr = math.sqrt(max(r, 1))
    return (sk + math.log2(max(sk, 1.0000001))) * r * m.C(n) + math.log2(max(sr, 1.0000001)) * m.R(n)


def square_matmul_summa(m: CommModel, N: float, p: int, k: int) -> float:
    """A.5.1: SUMMA 2√p·log(√p)·C(n) (all channels treated as inter-node)."""
    n = N / p
    sp = math.sqrt(p)
    return 2.0 * sp * math.log2(max(sp, 1.0000001)) * m.C(n)


def summa_internode(m: CommModel, N: float, p: int, k: int) -> float:
    """SUMMA's inter-node component 2√k·log(√k)·C(n) — the term the paper
    compares against LSHS's r(√k + log√k)·C(n)."""
    n = N / p
    sk = math.sqrt(k)
    return 2.0 * sk * math.log2(max(sk, 1.0000001)) * m.C(n)


BOUNDS = {
    "unary": unary_elementwise,
    "binary": binary_elementwise,
    "sum": reduction,
    "inner": blockwise_inner,
    "outer": blockwise_outer,
    "matmul_lshs": square_matmul_lshs,
    "matmul_summa": square_matmul_summa,
}


# -- moved-element floors for the communication-avoiding linalg suite ---------
#
# Unlike the Appendix A *time* formulas above, these price a scheduled
# subgraph in *network elements* — the unit ``ClusterState`` measures — so a
# run's measured transfer volume divides by them directly.  Each is the floor
# a communication-optimal schedule attains in the paper's caching model (a
# block is transmitted to a node at most once, §5.1) when the operation's
# output blocks are forced onto a balanced hierarchical layout; the CI
# bench-smoke ``linalg`` gate asserts measured ≤ constant × floor, turning
# every scheduler change into a checked comm-bound claim.

def tsqr_lower_elements(d: int, k: int, q: int) -> float:
    """Indirect (tree) TSQR of a ``(n, d)`` array in ``q`` row blocks over
    ``k`` nodes: the per-block ``(d, d)`` R factors reduce to one — after
    per-node locality pairing at least ``k' - 1`` merges cross node
    boundaries (``k' = min(k, q)`` nodes hold blocks), each moving one R —
    and recovering ``Q = X R^{-1}`` broadcasts the final R back to the
    ``k' - 1`` non-resident nodes."""
    kk = min(k, q)
    return 2.0 * max(kk - 1, 0) * d * d


def cholesky_lower_elements(n: int, q: int, k: int) -> float:
    """Blocked right-looking Cholesky of an ``(n, n)`` array on a ``(q, q)``
    grid over ``k`` nodes, output forced onto a balanced row layout: at step
    ``t`` the diagonal factor must reach the (up to ``k - 1``) other nodes
    owning panel rows, and every panel block ``L[j, t]`` must reach the
    nodes owning the trailing rows ``> j`` whose updates consume it."""
    b = n / max(q, 1)
    hops = 0.0
    for t in range(q):
        hops += min(k - 1, q - t - 1)          # diagonal-block broadcast
        for j in range(t + 1, q):
            hops += min(k - 1, q - j - 1)      # panel-block fan-out
    return hops * b * b


def rsvd_lower_elements(d: int, sketch: int, k: int, q: int,
                        power_iters: int = 0) -> float:
    """Randomized SVD of a ``(m, d)`` array in ``q`` row blocks over ``k``
    nodes with an ``(d, sketch)`` Gaussian test matrix: broadcast the sketch
    to the ``k' - 1`` non-resident nodes, tree-reduce the ``(d, sketch)``
    projection core (``k' - 1`` cross merges), TSQR the sample matrix, and
    broadcast the ``(sketch, sketch)`` rotation for ``U = Q U_b``.  Each
    power iteration repeats the projection round trip and the TSQR."""
    kk = min(k, q)
    x = max(kk - 1, 0)
    per_proj = 2.0 * x * d * sketch            # reduce core + broadcast back
    one_pass = (
        x * d * sketch                          # sketch broadcast
        + tsqr_lower_elements(sketch, k, q)     # TSQR of the sample matrix
        + x * d * sketch                        # B^T = A^T Q reduce tree
        + x * sketch * sketch                   # U_b rotation broadcast
    )
    return one_pass + power_iters * (per_proj + tsqr_lower_elements(sketch, k, q))


def comm_ratio(measured_elements: float, lower_elements: float) -> float:
    """Measured network elements over the matching moved-element floor — the
    CI-gated comm-bound ratio.  A zero floor (single-node run) with zero
    measured traffic is exactly at the bound (1.0); moving bytes when the
    floor is zero is unboundedly bad (inf)."""
    if lower_elements <= 0.0:
        return 1.0 if measured_elements <= 0.0 else float("inf")
    return float(measured_elements) / float(lower_elements)
