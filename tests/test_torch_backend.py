"""The port's block backends against the reference's block semantics.

The spec is the reference's ``tests/test_backend.py``: every block op on the
port's ``torch`` and ``cuda`` backends (on the CPU, f64) against
``repro.core.graph_array.execute_block_op`` at 1e-8 relative (f64 backends
land many orders below); the structural compile cache; device residency
(no host round-trips between ops); lineage replay; dtype threading.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import ArrayContext as RefContext
from repro.core import ClusterSpec as RefClusterSpec
from repro.core.graph_array import _BINARY, _UNARY, execute_block_op
from repro_torch.backend import (
    GLOBAL_COMPILE_CACHE,
    CompileCache,
    available_backends,
    make_backend,
)
from repro_torch.backend.torch_backend import TorchBackend
from repro_torch.core import ArrayContext, ClusterSpec
from repro_torch.core.executor import Executor

CPU = ["cpu"]


def _ctx(backend: str, k: int = 2, r: int = 2, ng=(2, 1), **kw):
    kw.setdefault("dtype", "float64")
    kw.setdefault("device", "cpu")
    return ArrayContext(cluster=ClusterSpec(k, r), node_grid=ng,
                        backend=backend, seed=0, **kw)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    denom = max(np.abs(b).max(), 1e-12)
    return np.abs(a - b).max() / denom


def _op_cases():
    """(op, meta, input arrays) covering every block-level op kind (the
    reference sweep's cases, made from the same seed)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 5))
    ypos = rng.random((6, 5)) + 0.5       # strictly positive (log/sqrt/rsqrt)
    y = rng.standard_normal((6, 5))
    v = rng.standard_normal(6)
    cases = []
    for op in _UNARY:
        arg = ypos if op in ("log", "sqrt", "rsqrt") else x
        cases.append((op, {}, [arg]))
    for op in _BINARY:
        b = ypos if op == "pow" else y
        a = ypos if op == "pow" else x
        cases.append((op, {}, [a, b]))
    cases.append(("add", {"expand_b": True}, [x, v]))
    cases.append(("mul", {"expand_a": True}, [v, x]))
    for sop in ("add", "mul", "sub", "div", "pow", "maximum", "minimum"):
        base = ypos if sop == "pow" else x
        cases.append(("scalar", {"op": sop, "scalar": 1.75, "reverse": False}, [base]))
        cases.append(("scalar", {"op": sop, "scalar": 1.75, "reverse": True}, [base]))
    a23, b35 = rng.standard_normal((2, 3)), rng.standard_normal((3, 5))
    for ta in (False, True):
        for tb in (False, True):
            aa = a23.T if ta else a23
            bb = b35.T if tb else b35
            cases.append(("matmul", {"ta": ta, "tb": tb}, [aa, bb]))
    cases.append(("matmul", {"ta": False, "tb": False}, [v, v]))       # dot
    cases.append(("matmul", {"ta": False, "tb": False},
                  [rng.standard_normal((6, 4)), rng.standard_normal(4)]))
    for axis in (None, 0, 1):
        for rop in ("add", "maximum", "minimum"):
            cases.append(("reduce_axis", {"axis": axis, "op": rop}, [x]))
    t = rng.standard_normal((3, 4, 2))
    cases.append(("transpose", {"perm": (2, 0, 1)}, [t]))
    cases.append(("transpose", {"perm": None}, [x]))
    cases.append(("tensordot", {"axes": 1},
                  [rng.standard_normal((3, 4)), rng.standard_normal((4, 2))]))
    cases.append(("einsum", {"spec": "ijk,jf,kf->if"},
                  [t, rng.standard_normal((4, 3)), rng.standard_normal((2, 3))]))
    chain = [("unary", "exp"), ("scalar", "mul", 0.5, False),
             ("unary", "tanh"), ("unary", "square")]
    cases.append(("fused", {"chain": chain}, [x]))
    tall = rng.standard_normal((8, 3))
    cases.append(("qr_r", {}, [tall]))
    cases.append(("qr_q", {}, [tall]))
    cases.append(("qr_stackr", {}, [np.triu(rng.standard_normal((3, 3))),
                                    np.triu(rng.standard_normal((3, 3)))]))
    cases.append(("stack", {}, [rng.standard_normal((2, 3)),
                                rng.standard_normal((4, 3))]))
    cases.append(("slice_rows", {"start": 1, "stop": 4}, [x]))
    cases.append(("slice", {"starts": (1, 0), "stops": (5, 3)}, [x]))
    cases.append(("concat_blocks",
                  {"shape": (4, 4), "offsets": [(0, 0), (0, 2), (2, 0), (2, 2)]},
                  [rng.standard_normal((2, 2)) for _ in range(4)]))
    cases.append(("matricize", {"mode": 1}, [t]))
    cases.append(("khatri_rao", {}, [rng.standard_normal((3, 4)),
                                     rng.standard_normal((2, 4))]))
    spd = rng.standard_normal((4, 4))
    spd = spd @ spd.T + 4.0 * np.eye(4)
    cases.append(("solve", {}, [spd, rng.standard_normal((4, 2))]))
    cases.append(("rsolve", {}, [rng.standard_normal((5, 4)), spd]))
    cases.append(("tsolve", {}, [spd, rng.standard_normal((4, 2))]))
    cases.append(("potrf", {}, [spd]))
    low = np.linalg.cholesky(spd)
    cases.append(("trsm", {}, [rng.standard_normal((5, 4)), low]))
    cases.append(("syrk_update", {}, [spd, rng.standard_normal((4, 3)),
                                      rng.standard_normal((4, 3))]))
    for op in ("svd_u", "svd_s", "svd_vt"):
        cases.append((op, {}, [tall]))
    return cases


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_op_parity_sweep(backend):
    be = make_backend(backend, dtype="float64", devices=CPU)
    for op, meta, inputs in _op_cases():
        ref = execute_block_op(op, dict(meta), [np.asarray(i) for i in inputs])
        res = be.execute(op, dict(meta),
                         [be.from_host(np.asarray(i), (0, 0)) for i in inputs],
                         (0, 0))
        got = be.to_host(res)
        assert got.shape == np.asarray(ref).shape, (op, meta)
        if op in ("qr_q", "qr_r", "qr_stackr", "svd_u", "svd_vt"):
            # QR/SVD factors are unique only up to column signs across
            # LAPACK drivers: compare magnitudes (and exact shape above)
            assert _rel(np.abs(got), np.abs(ref)) < 1e-8, (op, meta)
        else:
            assert _rel(got, ref) < 1e-8, (op, meta)
    assert be.stats.fallbacks == 0


def test_numpy_backend_is_bit_exact():
    be = make_backend("numpy")
    for op, meta, inputs in _op_cases():
        ref = execute_block_op(op, dict(meta), [np.asarray(i) for i in inputs])
        got = be.execute(op, dict(meta), list(inputs), (0, 0))
        assert np.array_equal(np.asarray(got), np.asarray(ref)), op


def test_registry():
    assert set(available_backends()) == {"numpy", "torch", "cuda"}
    for name in ("jax", "pallas", "no-such-backend"):
        with pytest.raises(ValueError):
            make_backend(name)
    with pytest.raises(ValueError):
        Executor(mode="jax")
    assert Executor(mode="sim").backend is None


def test_cuda_backend_routes_only_2d_matmul_to_the_kernel(monkeypatch):
    from repro_torch.backend import cuda_backend

    calls = []
    real = cuda_backend.kernel_matmul
    monkeypatch.setattr(cuda_backend, "kernel_matmul", lambda a, b: calls.append(
        (tuple(a.shape), tuple(b.shape), a.is_contiguous())) or real(a, b))
    be = make_backend("cuda", dtype="float64", devices=CPU)
    be._cache = CompileCache()
    rng = np.random.default_rng(0)
    x = be.from_host(rng.standard_normal((6, 4)), (0, 0))
    v = be.from_host(rng.standard_normal(4), (0, 0))
    be.execute("matmul", {"ta": True, "tb": False}, [x, x], (0, 0))
    be.execute("matmul", {"ta": False, "tb": False}, [x, v], (0, 0))
    be.execute("exp", {}, [x], (0, 0))
    # the transposed operand reached the kernel wrapper as a strided view
    assert calls == [((4, 6), (6, 4), False)]


def test_no_host_transfers_between_ops():
    for backend in ("torch", "cuda"):
        ctx = _ctx(backend, k=4, r=2, ng=(2, 2))
        A = ctx.random((32, 32), grid=(2, 2))
        B = ctx.random((32, 32), grid=(2, 2))
        stats = ctx.executor.backend.stats
        h2d0, d2h0 = stats.h2d, stats.d2h
        out = ((A @ B).sum(axis=0) + 1.0).compute()
        assert ctx.executor.stats.n_rfc > 8
        assert stats.h2d == h2d0
        assert stats.d2h == d2h0
        assert stats.fallbacks == 0
        out.to_numpy()
        assert stats.d2h > d2h0


def test_blocks_stay_torch_tensors():
    ctx = _ctx("cuda")
    out = (ctx.random((16, 16), grid=(2, 2)) @ ctx.random((16, 16), grid=(2, 2))).compute()
    for idx in out.grid.iter_indices():
        block = ctx.executor.get(out.block(idx).vid)
        assert isinstance(block, torch.Tensor)
        assert block.device.type == "cpu" and block.dtype == torch.float64


def test_non_tile_multiple_blocks():
    """The reference's (1200, 64)-block regression case: 600-row blocks."""
    ctx = _ctx("cuda", k=2, r=2)
    X = ctx.random((1200, 64), grid=(2, 1))
    out = (X.T @ X).compute().to_numpy()
    ref = X.to_numpy()
    assert _rel(out, ref.T @ ref) < 1e-6


# ---------------------------------------------------------------------------
# structural compile cache (a memo of built callables)
# ---------------------------------------------------------------------------

def test_compile_cache_hits_on_repeat_structure():
    cache = CompileCache()
    be = TorchBackend("float64", devices=CPU, cache=cache)
    x = be.from_host(np.random.default_rng(0).standard_normal((8, 8)), (0, 0))
    be.execute("exp", {}, [x], (0, 0))
    assert (cache.hits, cache.misses, cache.compiles) == (0, 1, 1)
    for _ in range(5):
        be.execute("exp", {}, [x], (0, 0))
    assert (cache.hits, cache.misses, cache.compiles) == (5, 1, 1)
    assert cache.compile_s > 0.0


def test_compile_cache_invalidates_on_shape_dtype_meta_and_salt():
    cache = CompileCache()
    be = TorchBackend("float64", devices=CPU, cache=cache)
    rng = np.random.default_rng(0)
    x88 = be.from_host(rng.standard_normal((8, 8)), (0, 0))
    x44 = be.from_host(rng.standard_normal((4, 4)), (0, 0))
    be.execute("scalar", {"op": "mul", "scalar": 2.0, "reverse": False}, [x88], (0, 0))
    be.execute("scalar", {"op": "mul", "scalar": 2.0, "reverse": False}, [x44], (0, 0))
    be.execute("scalar", {"op": "mul", "scalar": 3.0, "reverse": False}, [x88], (0, 0))
    be.execute("scalar", {"op": "add", "scalar": 2.0, "reverse": False}, [x88], (0, 0))
    assert cache.misses == 4 and cache.hits == 0          # all distinct keys
    be32 = TorchBackend("float32", devices=CPU, cache=cache)
    y88 = be32.from_host(rng.standard_normal((8, 8)), (0, 0))
    be32.execute("scalar", {"op": "mul", "scalar": 2.0, "reverse": False}, [y88], (0, 0))
    assert cache.misses == 5                               # dtype is in the key
    mm = {"ta": False, "tb": False}
    be.execute("matmul", mm, [x88, x88], (0, 0))
    kernel = make_backend("cuda", dtype="float64", devices=CPU)
    kernel._cache = cache
    kernel.execute("matmul", mm, [x88, x88], (0, 0))
    assert cache.misses == 7                               # the salt is too


def test_compile_cache_lru_eviction():
    cache = CompileCache(max_entries=2)
    be = TorchBackend("float64", devices=CPU, cache=cache)
    x = be.from_host(np.random.default_rng(0).standard_normal((4, 4)), (0, 0))
    for op in ("exp", "tanh", "square"):                   # 3 entries, cap 2
        be.execute(op, {}, [x], (0, 0))
    assert cache.evictions == 1 and len(cache) == 2
    be.execute("exp", {}, [x], (0, 0))                     # evicted: rebuild
    assert cache.misses == 4


def test_compile_counters_surface_in_loads():
    ctx = _ctx("cuda")
    A = ctx.random((16, 16), grid=(2, 2))
    (A + A).compute()
    d = ctx.loads()
    for key in ("compile_hits", "compile_misses", "compiles", "compile_s",
                "compile_hit_rate", "backend_jit_calls", "backend_h2d",
                "backend_d2h"):
        assert key in d, key
    assert d["backend_jit_calls"] >= 4
    sd = ctx.sched_stats.as_dict()
    for key in ("backend_compiles", "backend_compile_hits",
                "backend_compile_misses", "backend_compile_hit_rate",
                "backend_compile_s", "backend_jit_calls"):
        assert key in sd, key
    assert ctx.sched_stats.backend_jit_calls == d["backend_jit_calls"]


def test_loads_key_schema_matches_reference():
    """``ctx.loads()`` of the port's torch/cuda contexts carries exactly the
    reference jax context's keys, in the same order."""
    ref = RefContext(cluster=RefClusterSpec(2, 2), node_grid=(2, 1),
                     backend="jax", seed=0)
    A = ref.random((16, 16), grid=(2, 2))
    (A @ A + 1.0).compute()
    want = list(ref.loads())
    for backend in ("torch", "cuda"):
        ctx = _ctx(backend, dtype=None)
        B = ctx.random((16, 16), grid=(2, 2))
        (B @ B + 1.0).compute()
        assert list(ctx.loads()) == want


def test_global_cache_shared_across_contexts():
    ctx1 = _ctx("torch")
    A = ctx1.random((24, 24), grid=(2, 2))
    (A.exp()).compute()
    misses0 = GLOBAL_COMPILE_CACHE.misses
    hits0 = GLOBAL_COMPILE_CACHE.hits
    ctx2 = _ctx("torch")
    B = ctx2.random((24, 24), grid=(2, 2))
    (B.exp()).compute()
    assert GLOBAL_COMPILE_CACHE.misses == misses0
    assert GLOBAL_COMPILE_CACHE.hits > hits0
    assert ctx2.loads()["compile_hit_rate"] > 0


def test_fused_chain_is_single_dispatch_per_block():
    def calls(fuse: bool) -> int:
        ctx = _ctx("torch", fuse=fuse)
        x = ctx.random((16, 16), grid=(2, 2))
        stats = ctx.executor.backend.stats
        before = stats.jit_calls
        (x.exp().relu().sqrt()).compute()
        return stats.jit_calls - before

    assert calls(fuse=True) == 4
    assert calls(fuse=False) == 12


# ---------------------------------------------------------------------------
# dtype and device threading
# ---------------------------------------------------------------------------

def test_natural_dtypes_and_no_environment_defaults(monkeypatch):
    monkeypatch.setenv("REPRO_BACKEND", "jax")
    monkeypatch.setenv("REPRO_DTYPE", "float64")
    ctx = ArrayContext(device="cpu")
    assert ctx.backend == "cuda" and ctx.dtype == "float32"
    assert ArrayContext(backend="torch", device="cpu").dtype == "float32"
    assert ArrayContext(backend="numpy").dtype == "float64"
    assert _ctx("torch").dtype == "float64"


def test_dtype_flows_to_blocks_and_assembly():
    ctx32 = _ctx("cuda", dtype="float32")
    A = ctx32.random((16, 8), grid=(2, 1))
    assert (A.T @ A).compute().to_numpy().dtype == np.float32
    B = _ctx("cuda").random((16, 8), grid=(2, 1))
    assert (B * 2.0).compute().to_numpy().dtype == np.float64


def test_f32_backend_matches_reference_with_dtype_tolerance():
    ref = RefContext(cluster=RefClusterSpec(2, 2), node_grid=(2, 1),
                     backend="numpy", seed=0)
    ctx = _ctx("cuda", dtype="float32")
    Xr = ref.random((64, 16), grid=(4, 1))
    Xc = ctx.random((64, 16), grid=(4, 1))
    a = (Xr.T @ Xr).compute().to_numpy()
    b = (Xc.T @ Xc).compute().to_numpy()
    assert _rel(b, a) < 1e-5  # f32-appropriate tolerance


def test_unknown_dtype_raises():
    with pytest.raises(ValueError, match="dtype"):
        TorchBackend("int8", devices=CPU)


# ---------------------------------------------------------------------------
# fault tolerance through the backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fail_node_recover_parity(backend):
    ctx = _ctx(backend, k=4, r=2, ng=(2, 2), pipeline=True)
    A = ctx.random((32, 32), grid=(4, 4))
    B = ctx.random((32, 32), grid=(4, 4))
    out = ((A @ B) + A).compute()
    before = out.to_numpy()
    lost = ctx.executor.fail_node(1)
    assert lost
    replayed = ctx.executor.recover(
        [out.block(i).vid for i in out.grid.iter_indices()])
    assert replayed > 0
    assert np.array_equal(before, out.to_numpy())
    assert ctx.executor.backend.stats.replays == replayed
