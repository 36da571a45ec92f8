"""GraphArray: lazily evaluated blocked-array IR (paper §4, Fig. 5).

Creation operations execute *immediately* (blocks are placed by the
hierarchical data layout).  Numerical operations are *deferred*: they induce
per-output-block subgraphs of block-level operations (Fig. 5), which the
scheduler (LSHS, Section 5) later places and dispatches.

Vertex kinds:
  ``leaf``    materialized (or future) block, with a (node, worker) placement
  ``op``      an n-ary block-level operation (unary / binary elementwise,
              scalar ops, matmul with fused transpose flags, reduce-axis,
              tensordot / einsum contractions, fused elementwise chains)
  ``reduce``  n-ary Reduce(add, ...) — scheduled as n-1 locality-paired
              binary additions (paper §4 last ¶)
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from math import prod as _prod
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .grid import ArrayGrid, Index

_VERTEX_COUNTER = itertools.count()


def _next_id() -> int:
    return next(_VERTEX_COUNTER)


class Vertex:
    __slots__ = ("vid", "kind", "op", "shape", "children", "meta", "placement",
                 "parents", "ftok", "__weakref__")

    def __init__(
        self,
        kind: str,
        op: str = "",
        shape: Tuple[int, ...] = (),
        children: Optional[List["Vertex"]] = None,
        meta: Optional[Dict[str, Any]] = None,
    ):
        self.vid = _next_id()
        self.kind = kind              # "leaf" | "op" | "reduce"
        self.op = op
        self.shape = tuple(shape)
        self.children: List[Vertex] = children or []
        self.meta = meta or {}
        self.placement: Optional[Tuple[int, int]] = None  # (node, worker) for leaves
        self.parents: List[Vertex] = []
        self.ftok = None  # cached leaf fingerprint token (plan.fingerprint)
        for c in self.children:
            c.parents.append(self)

    # -- helpers -----------------------------------------------------------
    @property
    def elements(self) -> int:
        return _prod(self.shape) if self.shape else 1

    def is_leaf(self) -> bool:
        return self.kind == "leaf"

    def ready(self) -> bool:
        return self.kind != "leaf" and all(c.is_leaf() for c in self.children)

    def to_leaf(self, node: int, worker: int) -> None:
        """In-place conversion of an op/reduce vertex into a leaf (LSHS
        transition): parents see the result without pointer surgery."""
        # unlink this vertex from its children's parent back-references:
        # child.parents otherwise keeps every past consumer alive (and with
        # it the consumer's whole subgraph), so iterative workloads leaked
        # one graph per iteration through loop-invariant leaves.  The wake
        # machinery reads self.parents (untouched here); a child's parents
        # list only matters while that child can still transition, and a
        # dispatched consumer never needs waking again.
        for c in self.children:
            try:
                c.parents.remove(self)
            except ValueError:
                pass
        self.kind = "leaf"
        self.op = ""
        self.children = []
        self.meta = {}
        self.placement = (node, worker)
        self.ftok = None  # any cached fingerprint token is for the op form

    def __repr__(self) -> str:  # pragma: no cover
        return f"Vertex({self.kind}:{self.op or 'leaf'} id={self.vid} shape={self.shape})"


def leaf(shape: Tuple[int, ...], node: int, worker: int) -> Vertex:
    v = Vertex("leaf", shape=shape)
    v.placement = (node, worker)
    return v


# ---------------------------------------------------------------------------
# Block-level numpy semantics (the executor's oracle; also used by ref tests)
# ---------------------------------------------------------------------------

_UNARY: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "neg": lambda x: -x,
    "exp": np.exp,
    "log": np.log,
    "sqrt": np.sqrt,
    "abs": np.abs,
    "square": np.square,
    "sigmoid": lambda x: np.exp(-np.logaddexp(0.0, -x)),  # overflow-stable
    "tanh": np.tanh,
    "identity": lambda x: x,
    "softplus": lambda x: np.logaddexp(0.0, x),
    "relu": lambda x: np.maximum(x, 0.0),
    "rsqrt": lambda x: 1.0 / np.sqrt(x),
    "reciprocal": lambda x: 1.0 / x,
}

_BINARY: Dict[str, Callable[[np.ndarray, np.ndarray], np.ndarray]] = {
    "add": np.add,
    "sub": np.subtract,
    "mul": np.multiply,
    "div": np.divide,
    "pow": np.power,
    "maximum": np.maximum,
    "minimum": np.minimum,
}


def apply_chain(x, chain: Sequence[Tuple], unary=None, binary=None):
    """Apply a ``fused`` vertex's op chain to ``x`` bottom-up.

    The one definition of fused-chain semantics: the numpy interpreter calls
    it with the default tables, and ``repro_torch.backend`` backends pass their own
    (torch) tables so a chain runs on device-resident tensors.
    """
    unary = _UNARY if unary is None else unary
    binary = _BINARY if binary is None else binary
    for step in chain:
        if step[0] == "unary":
            x = unary[step[1]](x)
        else:  # ("scalar", op, scalar, reverse)
            fn = binary[step[1]]
            x = fn(step[2], x) if step[3] else fn(x, step[2])
    return x


def execute_block_op(op: str, meta: Dict[str, Any], inputs: Sequence[np.ndarray]) -> np.ndarray:
    """Reference/numpy execution of one block-level op."""
    if op in _UNARY:
        return _UNARY[op](inputs[0])
    if op in _BINARY:
        a, b = inputs[0], inputs[1]
        if meta.get("expand_a"):
            a = a[..., None]
        if meta.get("expand_b"):
            b = b[..., None]
        return _BINARY[op](a, b)
    if op == "scalar":
        fn = _BINARY[meta["op"]]
        s = meta["scalar"]
        x = inputs[0]
        return fn(s, x) if meta.get("reverse") else fn(x, s)
    if op == "matmul":
        a, b = inputs
        if meta.get("ta"):
            a = np.swapaxes(a, -1, -2)
        if meta.get("tb"):
            b = np.swapaxes(b, -1, -2)
        if a.ndim == 1 and b.ndim == 1:
            return np.asarray(a @ b)
        return a @ b
    if op == "reduce_axis":
        axis = meta["axis"]
        ufunc = {"add": np.add, "maximum": np.maximum, "minimum": np.minimum}[
            meta.get("op", "add")]
        return ufunc.reduce(inputs[0], axis=axis)
    if op == "transpose":
        return np.transpose(inputs[0], meta.get("perm"))
    if op == "tensordot":
        return np.tensordot(inputs[0], inputs[1], axes=meta["axes"])
    if op == "einsum":
        return np.einsum(meta["spec"], *inputs)
    if op == "fused":
        # beyond-paper operator fusion: a chain of unary/scalar block ops
        return apply_chain(inputs[0], meta["chain"])
    if op == "qr_r":  # linalg substrate: R factor of a thin QR
        return np.linalg.qr(inputs[0], mode="r")
    if op == "qr_q":
        return np.linalg.qr(inputs[0])[0]
    if op == "qr_stackr":  # stack two R factors and re-factor
        return np.linalg.qr(np.concatenate(inputs, axis=0), mode="r")
    if op == "stack":  # vertical concatenation (TSQR tree level)
        return np.concatenate(inputs, axis=0)
    if op == "slice_rows":
        return inputs[0][meta["start"] : meta["stop"]]
    if op == "slice":  # n-D sub-block extraction (reshard move graphs)
        return inputs[0][tuple(
            slice(a, b) for a, b in zip(meta["starts"], meta["stops"]))]
    if op == "concat_blocks":  # paste n pieces into one block at offsets
        out = np.zeros(meta["shape"], dtype=inputs[0].dtype)
        for off, piece in zip(meta["offsets"], inputs):
            out[tuple(slice(o, o + s) for o, s in zip(off, piece.shape))] = piece
        return out
    if op == "matricize":  # mode-n unfolding of a block (CP-ALS, §8.4)
        x = inputs[0]
        return np.moveaxis(x, meta["mode"], 0).reshape(x.shape[meta["mode"]], -1)
    if op == "khatri_rao":  # column-wise Kronecker of two factor blocks
        a, b = inputs
        return np.einsum("jf,kf->jkf", a, b).reshape(a.shape[0] * b.shape[0],
                                                     a.shape[1])
    if op == "solve":  # H^{-1} g on a single-block Hessian (§6)
        return np.linalg.solve(inputs[0], inputs[1])
    if op == "rsolve":  # X R^{-1} (indirect TSQR, §8.3)
        return np.linalg.solve(inputs[1].T, inputs[0].T).T
    if op == "tsolve":  # A^{-T} b — the L^T x = y back-substitution step
        return np.linalg.solve(inputs[0].T, inputs[1])
    if op == "potrf":  # lower Cholesky factor of a diagonal block
        return np.linalg.cholesky(inputs[0])
    if op == "trsm":  # Cholesky panel update A_it L_tt^{-T}
        return np.linalg.solve(inputs[1], inputs[0].T).T
    if op == "syrk_update":  # trailing update C - A B^T (syrk when A is B)
        c, a, b = inputs
        return c - a @ b.T
    if op == "svd_u":  # thin-SVD factors of a small-core block (rSVD §8.3)
        return np.linalg.svd(inputs[0], full_matrices=False)[0]
    if op == "svd_s":
        return np.linalg.svd(inputs[0], full_matrices=False)[1]
    if op == "svd_vt":
        return np.linalg.svd(inputs[0], full_matrices=False)[2]
    raise KeyError(f"unknown block op {op!r}")


def infer_shape(op: str, meta: Dict[str, Any], in_shapes: Sequence[Tuple[int, ...]]) -> Tuple[int, ...]:
    if op in _UNARY or op == "scalar" or op == "fused":
        return tuple(in_shapes[0])
    if op in _BINARY:
        sa = tuple(in_shapes[0]) + ((1,) if meta.get("expand_a") else ())
        sb = tuple(in_shapes[1]) + ((1,) if meta.get("expand_b") else ())
        return tuple(np.broadcast_shapes(sa, sb))
    if op == "matmul":
        a, b = list(in_shapes[0]), list(in_shapes[1])
        if meta.get("ta"):
            a[-1], a[-2] = a[-2], a[-1]
        if meta.get("tb"):
            b[-1], b[-2] = b[-2], b[-1]
        if len(a) == 1 and len(b) == 1:
            return ()
        if len(b) == 1:
            return tuple(a[:-1])
        if len(a) == 1:
            return tuple(b[:-2] + b[-1:])
        return tuple(a[:-1] + b[-1:])
    if op == "reduce_axis":
        axis = meta["axis"]
        s = list(in_shapes[0])
        if axis is None:
            return ()
        s.pop(axis)
        return tuple(s)
    if op == "transpose":
        perm = meta.get("perm") or tuple(reversed(range(len(in_shapes[0]))))
        return tuple(in_shapes[0][p] for p in perm)
    if op == "tensordot":
        k = meta["axes"]
        a, b = in_shapes
        return tuple(list(a[: len(a) - k]) + list(b[k:]))
    if op == "einsum":
        spec = meta["spec"]
        ins, out = spec.split("->")
        dim_of: Dict[str, int] = {}
        for sub, shp in zip(ins.split(","), in_shapes):
            for ch, d in zip(sub, shp):
                dim_of[ch] = d
        return tuple(dim_of[ch] for ch in out)
    if op == "qr_r":
        m, n = in_shapes[0]
        return (min(m, n), n)
    if op == "qr_q":
        m, n = in_shapes[0]
        return (m, min(m, n))
    if op == "qr_stackr":
        n = in_shapes[0][1]
        return (n, n)
    if op == "stack":
        m = sum(s[0] for s in in_shapes)
        return (m,) + tuple(in_shapes[0][1:])
    if op == "slice_rows":
        return (meta["stop"] - meta["start"],) + tuple(in_shapes[0][1:])
    if op == "slice":
        return tuple(b - a for a, b in zip(meta["starts"], meta["stops"]))
    if op == "concat_blocks":
        return tuple(meta["shape"])
    if op == "matricize":
        s = tuple(in_shapes[0])
        mode = meta["mode"]
        return (s[mode], int(_prod(s[:mode] + s[mode + 1:])))
    if op == "khatri_rao":
        a, b = in_shapes
        return (a[0] * b[0], a[1])
    if op == "solve":
        return tuple(in_shapes[1])
    if op == "rsolve":
        return tuple(in_shapes[0])
    if op == "tsolve":
        return tuple(in_shapes[1])
    if op == "potrf":
        return tuple(in_shapes[0])
    if op == "trsm":
        return tuple(in_shapes[0])
    if op == "syrk_update":
        return tuple(in_shapes[0])
    if op == "svd_u":
        m, n = in_shapes[0]
        return (m, min(m, n))
    if op == "svd_s":
        m, n = in_shapes[0]
        return (min(m, n),)
    if op == "svd_vt":
        m, n = in_shapes[0]
        return (min(m, n), n)
    raise KeyError(f"unknown block op {op!r}")


# ---------------------------------------------------------------------------
# GraphArray
# ---------------------------------------------------------------------------

class GraphArray:
    """A block-partitioned array whose blocks are vertices of a computation
    graph.  ``materialized`` iff every block is a leaf."""

    def __init__(self, ctx: "ArrayContext", grid: ArrayGrid, blocks: np.ndarray,
                 node_grid=None):
        self.ctx = ctx
        self.grid = grid
        self.blocks = blocks  # object ndarray of Vertex, shape == grid.grid
        # optional per-array layout override (reshard targets): when set,
        # ``ArrayContext.compute`` forces this array's output blocks onto the
        # hierarchical layout induced by this node grid instead of the
        # context-wide default
        self.node_grid = node_grid

    # -- basic protocol ------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return self.grid.shape

    @property
    def ndim(self) -> int:
        return self.grid.ndim

    def block(self, index: Index) -> Vertex:
        return self.blocks[index] if self.grid.ndim else self.blocks[()]

    def is_materialized(self) -> bool:
        return all(v.is_leaf() for v in self.blocks.flat)

    @property
    def T(self) -> "TransposedView":
        if self.ndim != 2:
            raise ValueError("T requires a 2-D GraphArray")
        return TransposedView(self)

    # -- deferred elementwise -------------------------------------------------
    def _unary(self, op: str) -> "GraphArray":
        out = np.empty(self.grid.grid, dtype=object)
        for idx in self.grid.iter_indices():
            c = self.block(idx)
            out[idx] = Vertex("op", op, infer_shape(op, {}, [c.shape]), [c])
        return GraphArray(self.ctx, self.grid, out, node_grid=self.node_grid)

    def _scalar(self, op: str, scalar: float, reverse: bool = False) -> "GraphArray":
        out = np.empty(self.grid.grid, dtype=object)
        meta = {"op": op, "scalar": float(scalar), "reverse": reverse}
        for idx in self.grid.iter_indices():
            c = self.block(idx)
            out[idx] = Vertex("op", "scalar", c.shape, [c], dict(meta))
        return GraphArray(self.ctx, self.grid, out, node_grid=self.node_grid)

    def _binary(self, op: str, other: "GraphArray") -> "GraphArray":
        a, b = self, other
        if a.grid.grid == b.grid.grid and a.shape == b.shape:
            out = np.empty(a.grid.grid, dtype=object)
            for idx in a.grid.iter_indices():
                ca, cb = a.block(idx), b.block(idx)
                out[idx] = Vertex("op", op, infer_shape(op, {}, [ca.shape, cb.shape]), [ca, cb])
            return GraphArray(a.ctx, a.grid, out, node_grid=a.node_grid or b.node_grid)
        # broadcasting: (q,1)/(q,) vector against (q, m) matrix along axis 0
        def _is_small(x, y) -> bool:
            if x.ndim < y.ndim:
                return True
            if x.ndim == y.ndim == 2 and x.shape[1] == 1 and y.shape[1] > 1:
                return True
            return False

        if _is_small(b, a):
            big, small, rev = a, b, False
        elif _is_small(a, b):
            big, small, rev = b, a, True
        else:
            big, small, rev = a, b, False
        if small.ndim in (1, 2) and big.ndim == 2:
            ok1 = small.ndim == 1 and small.grid.grid[0] == big.grid.grid[0] and small.shape[0] == big.shape[0]
            ok2 = (
                small.ndim == 2
                and small.shape[1] == 1
                and small.grid.grid[0] == big.grid.grid[0]
                and small.shape[0] == big.shape[0]
            )
            if ok1 or ok2:
                out = np.empty(big.grid.grid, dtype=object)
                expand_key = ("expand_a" if rev else "expand_b") if small.ndim == 1 else None
                for idx in big.grid.iter_indices():
                    cb_idx = (idx[0],) if small.ndim == 1 else (idx[0], 0)
                    cbig, csmall = big.block(idx), small.block(cb_idx)
                    first, second = (csmall, cbig) if rev else (cbig, csmall)
                    meta = {expand_key: True} if expand_key else {}
                    shp = infer_shape(op, meta, [first.shape, second.shape])
                    out[idx] = Vertex("op", op, shp, [first, second], meta)
                return GraphArray(big.ctx, big.grid, out,
                                  node_grid=big.node_grid or small.node_grid)
        raise ValueError(
            f"incompatible operands for {op}: shapes {a.shape}/{b.shape}, "
            f"grids {a.grid.grid}/{b.grid.grid}"
        )

    def _coerce(self, other: Union["GraphArray", float, int], op: str, reverse: bool) -> "GraphArray":
        if isinstance(other, GraphArray):
            if reverse:
                return other._binary(op, self)
            return self._binary(op, other)
        return self._scalar(op, float(other), reverse=reverse)

    def __neg__(self):
        return self._unary("neg")

    def __add__(self, o):
        return self._coerce(o, "add", False)

    def __radd__(self, o):
        return self._coerce(o, "add", True)

    def __sub__(self, o):
        return self._coerce(o, "sub", False)

    def __rsub__(self, o):
        return self._coerce(o, "sub", True)

    def __mul__(self, o):
        return self._coerce(o, "mul", False)

    def __rmul__(self, o):
        return self._coerce(o, "mul", True)

    def __truediv__(self, o):
        return self._coerce(o, "div", False)

    def __rtruediv__(self, o):
        return self._coerce(o, "div", True)

    def __pow__(self, o):
        return self._coerce(o, "pow", False)

    def __matmul__(self, other):
        return matmul(self, other)

    def exp(self):
        return self._unary("exp")

    def log(self):
        return self._unary("log")

    def sqrt(self):
        return self._unary("sqrt")

    def sigmoid(self):
        return self._unary("sigmoid")

    def square(self):
        return self._unary("square")

    def softplus(self):
        return self._unary("softplus")

    def relu(self):
        return self._unary("relu")

    def rsqrt(self):
        return self._unary("rsqrt")

    def reciprocal(self):
        return self._unary("reciprocal")

    def tanh(self):
        return self._unary("tanh")

    def abs(self):
        return self._unary("abs")

    def __abs__(self):
        return self._unary("abs")

    # -- reductions ------------------------------------------------------------
    def sum(self, axis: Optional[int] = None) -> "GraphArray":
        return self._reduce("add", axis)

    def max(self, axis: Optional[int] = None) -> "GraphArray":
        return self._reduce("maximum", axis)

    def min(self, axis: Optional[int] = None) -> "GraphArray":
        return self._reduce("minimum", axis)

    def mean(self, axis: Optional[int] = None) -> "GraphArray":
        n = int(np.prod(self.shape)) if axis is None else self.shape[axis]
        return self.sum(axis) * (1.0 / max(n, 1))

    def _reduce(self, rop: str, axis: Optional[int] = None) -> "GraphArray":
        if axis is None:
            # reduce every block to a scalar, then a global reduce tree
            parts: List[Vertex] = []
            for idx in self.grid.iter_indices():
                c = self.block(idx)
                parts.append(Vertex("op", "reduce_axis", (), [c],
                                    {"axis": None, "op": rop}))
            root = parts[0] if len(parts) == 1 else Vertex("reduce", rop, (), parts)
            out_grid = ArrayGrid((), (), self.grid.dtype)
            blocks = np.empty((), dtype=object)
            blocks[()] = root
            return GraphArray(self.ctx, out_grid, blocks)
        axis = axis % self.ndim
        out_shape = tuple(s for a, s in enumerate(self.shape) if a != axis)
        out_gridspec = tuple(g for a, g in enumerate(self.grid.grid) if a != axis)
        out_grid = ArrayGrid(out_shape, out_gridspec, self.grid.dtype)
        blocks = np.empty(out_gridspec, dtype=object)
        for oidx in out_grid.iter_indices():
            parts = []
            for h in range(self.grid.grid[axis]):
                full = list(oidx)
                full.insert(axis, h)
                c = self.block(tuple(full))
                shp = infer_shape("reduce_axis", {"axis": axis}, [c.shape])
                parts.append(Vertex("op", "reduce_axis", shp, [c],
                                    {"axis": axis, "op": rop}))
            root = parts[0] if len(parts) == 1 else Vertex(
                "reduce", rop, parts[0].shape, parts)
            blocks[oidx] = root
        return GraphArray(self.ctx, out_grid, blocks)

    # -- layout ops -------------------------------------------------------------
    def transpose(self, perm: Optional[Tuple[int, ...]] = None) -> "GraphArray":
        """Eager block-wise transpose (distinct from the lazy fused .T)."""
        perm = tuple(perm) if perm else tuple(reversed(range(self.ndim)))
        out_shape = tuple(self.shape[p] for p in perm)
        out_gridspec = tuple(self.grid.grid[p] for p in perm)
        out_grid = ArrayGrid(out_shape, out_gridspec, self.grid.dtype)
        blocks = np.empty(out_gridspec if out_gridspec else (), dtype=object)
        for oidx in out_grid.iter_indices():
            src = tuple(oidx[perm.index(a)] for a in range(self.ndim))
            c = self.block(src)
            shp = infer_shape("transpose", {"perm": perm}, [c.shape])
            blocks[oidx] = Vertex("op", "transpose", shp, [c], {"perm": perm})
        return GraphArray(self.ctx, out_grid, blocks)

    # -- layout transformation (reshard subsystem) ------------------------------
    def reshard(self, grid=None, node_grid=None) -> "GraphArray":
        """Re-partition and/or re-distribute this array to a new
        ``(blockshape, node_grid)`` layout via an LSHS-scheduled block-level
        move graph (``core.reshard``).  ``node_grid=None`` asks the layout
        tuner to pick the min-max-load factorization."""
        from .reshard import reshard as _reshard

        return _reshard(self, grid=grid, node_grid=node_grid)

    # -- materialization --------------------------------------------------------
    def compute(self) -> "GraphArray":
        self.ctx.compute(self)
        return self

    def to_numpy(self) -> np.ndarray:
        self.ctx.compute(self)
        return self.ctx.executor.assemble(self)

    def wait(self) -> "GraphArray":
        """Barrier: flush pending dispatches and block until every block's
        backend value is ready (async backends return futures; timing code
        must call this before stopping the clock)."""
        self.ctx.executor.wait_blocks(self)
        return self

    def placements(self) -> Dict[Index, Tuple[int, int]]:
        return {idx: self.block(idx).placement for idx in self.grid.iter_indices()}


class TransposedView:
    """Lazy transpose; fused into a subsequent matmul (paper §6)."""

    def __init__(self, ga: GraphArray):
        self.ga = ga

    @property
    def shape(self) -> Tuple[int, ...]:
        s = self.ga.shape
        return (s[1], s[0])

    @property
    def T(self) -> GraphArray:
        return self.ga

    def __matmul__(self, other):
        return matmul(self, other)


# ---------------------------------------------------------------------------
# Linear / tensor algebra constructors (Fig. 5 subgraph builders)
# ---------------------------------------------------------------------------

def _reduce_or_single(parts: List[Vertex]) -> Vertex:
    if len(parts) == 1:
        return parts[0]
    return Vertex("reduce", "add", parts[0].shape, parts)


def matmul(a: Union[GraphArray, TransposedView], b: Union[GraphArray, TransposedView]) -> GraphArray:
    ta = isinstance(a, TransposedView)
    tb = isinstance(b, TransposedView)
    A = a.ga if ta else a
    B = b.ga if tb else b
    ctx = A.ctx

    if A.ndim == 1 and B.ndim == 1:
        # vector-vector dot: Reduce over co-partitioned blocks
        if A.grid.grid != B.grid.grid:
            raise ValueError("dot grid mismatch")
        parts = []
        for h in range(A.grid.grid[0]):
            ca, cb = A.block((h,)), B.block((h,))
            parts.append(Vertex("op", "matmul", (), [ca, cb], {"ta": False, "tb": False}))
        out_grid = ArrayGrid((), (), A.grid.dtype)
        blocks = np.empty((), dtype=object)
        blocks[()] = _reduce_or_single(parts)
        return GraphArray(ctx, out_grid, blocks)

    # logical (m, k) x (k, n); 1-D operands get matrix-vector treatment
    if A.ndim == 1 and not ta:
        A_rows, A_cols = A.grid.grid[0], 1
    else:
        ag = A.grid.grid
        A_rows, A_cols = (ag[1], ag[0]) if ta else (ag[0], ag[1])
    if B.ndim == 1 and not tb:
        B_rows, B_cols = B.grid.grid[0], 1
    else:
        bg = B.grid.grid
        B_rows, B_cols = (bg[1], bg[0]) if tb else (bg[0], bg[1])
    if A_cols != B_rows:
        raise ValueError(
            f"matmul grid mismatch: {A.grid.grid}{'^T' if ta else ''} @ "
            f"{B.grid.grid}{'^T' if tb else ''}"
        )

    def a_block(i: int, h: int) -> Vertex:
        if A.ndim == 1:
            return A.block((i if not ta else h,))
        return A.block((h, i) if ta else (i, h))

    def b_block(h: int, j: int) -> Vertex:
        if B.ndim == 1:
            return B.block((h,))
        return B.block((j, h) if tb else (h, j))

    a_vec = A.ndim == 1
    b_vec = B.ndim == 1
    meta = {"ta": ta and not a_vec, "tb": tb and not b_vec}

    # output logical grid
    if a_vec:
        out_shape: Tuple[int, ...] = (B.shape[0] if tb else B.shape[1],)
        out_gridspec: Tuple[int, ...] = (B_cols,)
    elif b_vec:
        out_shape = (A.shape[1] if ta else A.shape[0],)
        out_gridspec = (A_rows,)
    else:
        m = A.shape[1] if ta else A.shape[0]
        n = B.shape[0] if tb else B.shape[1]
        out_shape = (m, n)
        out_gridspec = (A_rows, B_cols)
    out_grid = ArrayGrid(out_shape, out_gridspec, A.grid.dtype)
    blocks = np.empty(out_gridspec, dtype=object)

    for oidx in out_grid.iter_indices():
        if a_vec:
            (j,) = oidx
            i = 0
        elif b_vec:
            (i,) = oidx
            j = 0
        else:
            i, j = oidx
        parts = []
        for h in range(A_cols):
            ca = a_block(i, h) if not a_vec else A.block((h,))
            cb = b_block(h, j)
            shp = infer_shape("matmul", meta, [ca.shape, cb.shape])
            parts.append(Vertex("op", "matmul", shp, [ca, cb], dict(meta)))
        blocks[oidx] = _reduce_or_single(parts)
    return GraphArray(ctx, out_grid, blocks)


def tensordot(a: GraphArray, b: GraphArray, axes: int) -> GraphArray:
    """Contract the last ``axes`` dims of ``a`` with the first ``axes`` of ``b``."""
    if axes < 1:
        raise ValueError("axes must be >= 1")
    ga, gb = a.grid.grid, b.grid.grid
    if ga[a.ndim - axes :] != gb[:axes]:
        raise ValueError(f"tensordot contraction grid mismatch: {ga} vs {gb}")
    if a.grid.shape[a.ndim - axes :] != b.grid.shape[:axes]:
        raise ValueError("tensordot contraction shape mismatch")
    out_shape = a.shape[: a.ndim - axes] + b.shape[axes:]
    out_gridspec = ga[: a.ndim - axes] + gb[axes:]
    out_grid = ArrayGrid(out_shape, out_gridspec, a.grid.dtype)
    blocks = np.empty(out_gridspec if out_gridspec else (), dtype=object)
    contr = [range(g) for g in ga[a.ndim - axes :]]
    for oidx in out_grid.iter_indices():
        ai_free = oidx[: a.ndim - axes]
        bj_free = oidx[a.ndim - axes :]
        parts = []
        for cidx in itertools.product(*contr):
            ca = a.block(tuple(ai_free) + tuple(cidx))
            cb = b.block(tuple(cidx) + tuple(bj_free))
            shp = infer_shape("tensordot", {"axes": axes}, [ca.shape, cb.shape])
            parts.append(Vertex("op", "tensordot", shp, [ca, cb], {"axes": axes}))
        blocks[oidx if out_gridspec else ()] = _reduce_or_single(parts)
    return GraphArray(a.ctx, out_grid, blocks)


def einsum(spec: str, *operands: GraphArray) -> GraphArray:
    """General blocked Einstein summation (paper Table 1 / §8.4 MTTKRP)."""
    spec = spec.replace(" ", "")
    ins_str, out_sub = spec.split("->")
    in_subs = ins_str.split(",")
    if len(in_subs) != len(operands):
        raise ValueError("einsum spec/operand arity mismatch")
    grid_of: Dict[str, int] = {}
    dim_of: Dict[str, int] = {}
    for sub, op_arr in zip(in_subs, operands):
        if len(sub) != op_arr.ndim:
            raise ValueError(f"einsum subscript {sub} rank mismatch with {op_arr.shape}")
        for ch, g, d in zip(sub, op_arr.grid.grid, op_arr.shape):
            if ch in grid_of and (grid_of[ch] != g or dim_of[ch] != d):
                raise ValueError(f"einsum subscript {ch} grid/dim mismatch")
            grid_of[ch] = g
            dim_of[ch] = d
    contracted = [ch for ch in grid_of if ch not in out_sub]
    ctx = operands[0].ctx
    out_shape = tuple(dim_of[ch] for ch in out_sub)
    out_gridspec = tuple(grid_of[ch] for ch in out_sub)
    out_grid = ArrayGrid(out_shape, out_gridspec, operands[0].grid.dtype)
    blocks = np.empty(out_gridspec if out_gridspec else (), dtype=object)
    for oidx in out_grid.iter_indices():
        env = dict(zip(out_sub, oidx))
        parts = []
        for cvals in itertools.product(*(range(grid_of[ch]) for ch in contracted)):
            env.update(zip(contracted, cvals))
            kids = []
            for sub, op_arr in zip(in_subs, operands):
                bidx = tuple(env[ch] for ch in sub)
                kids.append(op_arr.block(bidx))
            shp = infer_shape("einsum", {"spec": spec}, [k.shape for k in kids])
            parts.append(Vertex("op", "einsum", shp, kids, {"spec": spec}))
        blocks[oidx if out_gridspec else ()] = _reduce_or_single(parts)
    return GraphArray(ctx, out_grid, blocks)


def concatenate(arrays: Sequence[GraphArray], axis: int = 0) -> GraphArray:
    """Blockwise concatenation: grids must match on every other axis; the
    block boundary simply extends along ``axis`` (no data movement at all —
    placement of existing leaves is preserved until the next compute)."""
    a0 = arrays[0]
    axis = axis % a0.ndim
    for a in arrays[1:]:
        if a.ndim != a0.ndim:
            raise ValueError("rank mismatch")
        for d in range(a0.ndim):
            if d != axis and (a.shape[d] != a0.shape[d] or a.grid.grid[d] != a0.grid.grid[d]):
                raise ValueError("shape/grid mismatch off the concat axis")
    out_shape = list(a0.shape)
    out_shape[axis] = sum(a.shape[axis] for a in arrays)
    out_gridspec = list(a0.grid.grid)
    out_gridspec[axis] = sum(a.grid.grid[axis] for a in arrays)
    out_grid = ArrayGrid(tuple(out_shape), tuple(out_gridspec), a0.grid.dtype)
    # ArrayGrid assumes ceil-split geometry: the concatenated block sizes
    # must reproduce it exactly (uniform blocks along the concat axis)
    src_sizes = tuple(
        sz for a in arrays for sz in a.grid.block_sizes(axis)
    )
    if out_grid.block_sizes(axis) != src_sizes:
        raise ValueError(
            f"concatenate needs uniform blocks along axis {axis}: "
            f"{src_sizes} vs {out_grid.block_sizes(axis)}"
        )
    blocks = np.empty(tuple(out_gridspec), dtype=object)
    offset = 0
    for a in arrays:
        for idx in a.grid.iter_indices():
            oidx = list(idx)
            oidx[axis] += offset
            blocks[tuple(oidx)] = a.block(idx)
        offset += a.grid.grid[axis]
    return GraphArray(a0.ctx, out_grid, blocks)
