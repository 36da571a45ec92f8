"""Structural compile cache for block-kernel backends.

Compiled block kernels are memoized by a *structural* key built exactly the
way ``core/plan.py`` fingerprints vertices: op kind and metadata are interned
to small ints (process-stable, first-seen order) and the input signature is
the tuple of (shape, dtype) pairs.  Two block ops with the same key present
the compiler with byte-for-byte the same lowering problem, so one compilation
serves every structurally identical block — the per-op analogue of the
scheduling-plan cache.

The cache is LRU (compiled executables hold device buffers on some runtimes,
so the population must be bounded) and keeps hit/miss/eviction/compile-time
counters that ``ArrayContext.loads`` and the bench-smoke artifact surface.
A single process-global instance (``GLOBAL_COMPILE_CACHE``) is shared by
every torch/cuda backend instance: benchmark repeats and short-lived
contexts re-use each other's built callables — invalidation is implicit
because any change to op kind, metadata, input shapes or dtypes changes the
key.  PyTorch runs eagerly, so an entry is a built callable rather than a
compiled executable; the key and the counters are the reference's, which
keeps ``ctx.loads()`` on the reference's key schema.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.plan import _META_MEMO, _intern, _meta_token


def _memo_meta_token(meta: Dict[str, Any]) -> tuple:
    """Canonical meta token through ``plan._META_MEMO``: the handful of
    distinct op metadatas recur once per block per dispatch on the hot path,
    so re-canonicalizing them every call would tax exactly the path this
    subsystem speeds up.  Same (keys, values, value-types) memo key as
    ``plan.fingerprint``; unhashable values fall back to direct
    tokenization."""
    try:
        vals = tuple(meta.values())
        mk = (tuple(meta), vals, tuple(map(type, vals)))
        mt = _META_MEMO.get(mk)
        if mt is None:
            mt = _meta_token(meta)
            _META_MEMO[mk] = mt
        return mt
    except TypeError:
        return _meta_token(meta)


def structural_key(salt: str, op: str, meta: Dict[str, Any],
                   in_sig: Tuple[Tuple[Tuple[int, ...], str], ...]) -> tuple:
    """Compile-cache key: (backend flavor, op kind, canonical interned
    metadata, input (shape, dtype) signature).  ``salt`` separates lowerings
    that differ per backend (the cuda matmul route builds a different
    callable than the plain torch route for the same op/meta/signature)."""
    return (
        _intern[salt],
        _intern[op],
        _memo_meta_token(meta) if meta else (),
        tuple((shape, _intern[dtype]) for shape, dtype in in_sig),
    )


class CompileCache:
    """LRU map structural-key -> compiled callable, with compile accounting.

    ``compile_s`` accumulates the wall time of cache-miss compilations
    (trace + lower + first-execution for lazily compiled runtimes) — the
    one-time cost the hit path amortizes, reported next to the plan cache's
    scheduler-overhead split.
    """

    def __init__(self, max_entries: int = 512):
        self.max_entries = max_entries
        self._fns: "OrderedDict[tuple, Callable]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compiles = 0
        self.compile_s = 0.0

    def __len__(self) -> int:
        return len(self._fns)

    def get(self, key: tuple) -> Optional[Callable]:
        fn = self._fns.get(key)
        if fn is None:
            self.misses += 1
            return None
        self._fns.move_to_end(key)
        self.hits += 1
        return fn

    def put(self, key: tuple, fn: Callable, compile_seconds: float = 0.0) -> None:
        self._fns[key] = fn
        self._fns.move_to_end(key)
        self.compiles += 1
        self.compile_s += compile_seconds
        if len(self._fns) > self.max_entries:
            self._fns.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._fns.clear()

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def counters(self) -> Dict[str, float]:
        return {
            "compile_hits": self.hits,
            "compile_misses": self.misses,
            "compile_evictions": self.evictions,
            "compiles": self.compiles,
            "compile_s": self.compile_s,
            "compile_hit_rate": self.hit_rate(),
            "compiled_entries": len(self._fns),
        }


#: Process-global cache shared by all torch/cuda backend instances.
GLOBAL_COMPILE_CACHE = CompileCache()
