"""Hierarchical data layout (paper §4, Fig. 4).

Blocks of a logical grid are mapped cyclically to nodes of a user-defined
*node grid*, then round-robin over the workers within each node:

    A[i, j]  ->  node ℓ = (i % g1) * g2 + j % g2        (2-D rule, Fig. 4)

generalized to n-D by taking ``c_a = i_a % g_a`` for each node-grid axis and
flattening row-major.  Worker placement within a node is round-robin in
row-major block order (reproduces Fig. 4a exactly: A[2,3] -> N1 W3).

Along any axis on which two operands share shape+grid, this layout co-locates
their blocks, so elementwise operations need zero communication, and the
first level of every reduction tree is node-local.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .grid import ArrayGrid, Index


@dataclass(frozen=True)
class ClusterSpec:
    """A cluster of ``num_nodes`` nodes with ``workers_per_node`` workers."""

    num_nodes: int
    workers_per_node: int = 1
    # relative cost discount of intra-node worker->worker transfers (Dask
    # footnote in §5.1); Ray's shared-memory store means 0.
    intra_node_coeff: float = 0.0

    @property
    def num_workers(self) -> int:
        return self.num_nodes * self.workers_per_node


@dataclass(frozen=True)
class NodeGrid:
    """Multi-dimensional coordinate space for nodes (paper §4)."""

    dims: Tuple[int, ...]

    @property
    def num_nodes(self) -> int:
        return int(np.prod(self.dims)) if self.dims else 1

    def node_of(self, block_index: Index) -> int:
        """Cyclic block->node rule, generalized n-D, row-major flattening."""
        dims = self.dims
        # match node-grid axes to the *leading* block axes; extra block axes
        # (beyond the node grid rank) do not affect node placement.
        coords = []
        for a, g in enumerate(dims):
            i = block_index[a] if a < len(block_index) else 0
            coords.append(i % g)
        # row-major flatten
        node = 0
        for c, g in zip(coords, dims):
            node = node * g + c
        return node


class HierarchicalLayout:
    """Assigns (node, worker) to every block of a grid."""

    def __init__(self, grid: ArrayGrid, node_grid: NodeGrid, cluster: ClusterSpec):
        if node_grid.num_nodes != cluster.num_nodes:
            raise ValueError(
                f"node grid {node_grid.dims} has {node_grid.num_nodes} nodes, "
                f"cluster has {cluster.num_nodes}"
            )
        self.grid = grid
        self.node_grid = node_grid
        self.cluster = cluster
        self._placements: Dict[Index, Tuple[int, int]] = {}
        counters = [0] * cluster.num_nodes
        for idx in grid.iter_indices():  # row-major order
            node = node_grid.node_of(idx)
            worker = counters[node] % cluster.workers_per_node
            counters[node] += 1
            self._placements[idx] = (node, worker)

    def placement(self, index: Index) -> Tuple[int, int]:
        return self._placements[index]

    def node_of(self, index: Index) -> int:
        return self._placements[index][0]

    def items(self) -> Iterator[Tuple[Index, Tuple[int, int]]]:
        return iter(self._placements.items())

    def load_per_node(self) -> np.ndarray:
        """Number of block-elements mapped to each node (for balance checks)."""
        out = np.zeros(self.cluster.num_nodes, dtype=np.int64)
        for idx, (node, _w) in self._placements.items():
            out[node] += self.grid.block_elements(idx)
        return out


def node_grid_factorizations(k: int, nd: int) -> List[Tuple[int, ...]]:
    """All ordered factorizations of ``k`` into ``nd`` axis factors, in
    lexicographic order (deterministic tie-breaking for the tuner and
    ``default_node_grid``)."""
    if nd <= 0:
        return [()]
    out: List[Tuple[int, ...]] = []

    def rec(rem: int, dims: Tuple[int, ...]) -> None:
        if len(dims) == nd - 1:
            out.append(dims + (rem,))
            return
        for d in range(1, rem + 1):
            if rem % d == 0:
                rec(rem // d, dims + (d,))

    rec(k, ())
    return out


def default_node_grid(grid: ArrayGrid, cluster: ClusterSpec) -> NodeGrid:
    """Factor the node count to (approximately) match the block-grid shape.

    Mirrors the paper's guidance: for row-partitioned (q, 1) grids use
    (k, 1); for square (g, g) grids use the most square factorization of k.
    The node count is factored over *all* grid axes (a (1, 1, q)-partitioned
    3-D tensor gets (1, 1, k), not a 2-D (g1, g2, 1) mis-layout)."""
    k = cluster.num_nodes
    nd = max(grid.ndim, 1)
    if nd == 1:
        return NodeGrid((k,))
    # choose the factorization of k with aspect ratio closest to the grid's
    best = None
    target = [g for g in grid.grid] + [1] * (nd - grid.ndim)
    for dims in node_grid_factorizations(k, nd):
        score = 0.0
        for t, d in zip(target, dims):
            score += abs(np.log((t + 1e-9) / d))
        if best is None or score < best[0]:
            best = (score, dims)
    return NodeGrid(best[1])


# ---------------------------------------------------------------------------
# Load-simulated layout tuner (paper §4's heuristic, measured instead of
# hard-coded): score every node-grid factorization against the *live*
# cluster state and pick the min-max-load layout for an upcoming op.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayoutChoice:
    """Tuner verdict for one candidate node grid."""

    node_grid: NodeGrid
    max_load: float          # max per-node elements after adopting the layout
    moved_elements: float    # simulated transfer volume to reach it
    comm_seconds: float      # α-β-γ time for those transfers (bounds.CommModel)
    objective: float         # summed Eq.2 objective over the simulated moves


def tune_node_grid(
    grid: ArrayGrid,
    cluster: ClusterSpec,
    state=None,
    sources: Optional[Dict[Index, Sequence[int]]] = None,
    comm=None,
) -> LayoutChoice:
    """Pick a node grid for laying out ``grid`` on ``cluster``.

    Candidates are every factorization of the node count over the grid's
    axes.  Without ``state``, scoring is pure balance (min-max block
    elements per node — the paper's §4 heuristic).  With ``state`` (a live
    ``ClusterState``) and ``sources`` (dest block index -> object ids of the
    source blocks an upcoming reshard/op would pull into that block), every
    candidate's destination placements are additionally scored with
    ``ClusterState.simulate_cost_batch`` — one vectorized call per
    destination block covering *all* candidates — so the choice reflects
    current residency, per-node load, and link/clock congestion.  Transfer
    time is priced with the α-β-γ ``bounds.CommModel``.  Scoring is
    first-order: each non-resident source is priced at its whole stored
    block size (the residency signal), not at the sliver a move graph would
    actually slice out of it.

    Keys are minimized lexicographically: (max load, moved elements,
    comm seconds, objective, dims).  A layout that matches where the data
    already lives moves zero bytes, so on a balance tie the status quo wins
    and reshard degenerates to a no-op.
    """
    from .bounds import CommModel

    comm = comm or CommModel()
    k = cluster.num_nodes
    nd = max(grid.ndim, 1)
    cands = [NodeGrid(dims) for dims in node_grid_factorizations(k, nd)]
    n = len(cands)
    layouts = [HierarchicalLayout(grid, ng, cluster) for ng in cands]
    base_mem = (np.asarray(state.S[:, 0]) if state is not None
                else np.zeros(k))
    max_load = np.empty(n)
    for i, lay in enumerate(layouts):
        max_load[i] = float((base_mem + lay.load_per_node()).max())
    moved = np.zeros(n)
    comm_s = np.zeros(n)
    objective = np.zeros(n)
    if state is not None and sources:
        n_moves = np.zeros(n)
        for didx, in_ids in sources.items():
            dest_nodes = [lay.node_of(didx) for lay in layouts]
            out_elements = grid.block_elements(didx)
            obj_b, mv_b, _est, _load = state.simulate_cost_batch(
                dest_nodes, out_elements, list(in_ids))
            moved += mv_b
            objective += obj_b
            nz = mv_b > 0
            n_moves += nz
            comm_s[nz] += comm.alpha + comm.beta * mv_b[nz] * comm.bytes_per_element
        comm_s += comm.gamma * n_moves
    best = min(
        range(n),
        key=lambda i: (max_load[i], moved[i], comm_s[i], objective[i],
                       cands[i].dims),
    )
    return LayoutChoice(cands[best], float(max_load[best]), float(moved[best]),
                        float(comm_s[best]), float(objective[best]))
