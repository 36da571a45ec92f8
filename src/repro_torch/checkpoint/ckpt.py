"""Atomic, versioned checkpointing of train-state trees (counterpart of
``repro.checkpoint.ckpt``).

Layout: ``<dir>/step_<N>/state.npz`` + ``meta.json``; writes go to a
``.tmp-<N>`` staging directory that is atomically renamed on completion, so a
crash mid-write never corrupts the latest checkpoint.  ``keep`` bounds disk
use.  The data-pipeline cursor rides along in meta, so resume replays the
exact batch stream.  Leaves are tensors (copied to the host) or anything
numpy takes; ``restore`` returns numpy arrays, which the caller puts on its
device (or shards: ``sharding.shard_tree``, onto any mesh).  A DTensor leaf
is gathered whole (``full_tensor``) on every rank, and the first rank of an
initialised process group writes while the others wait for it.  The format
is the reference's, so either package reads the other's checkpoints.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _to_host(x) -> np.ndarray:
    if isinstance(x, DTensor):  # a collective: every rank gathers its leaves
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("checkpoint: bfloat16 leaves have no numpy type; keep "
                            "train state in float32")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(ckpt_dir: str, step: int, state, meta: Optional[Dict] = None,
         keep: int = 3) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat = {k: _to_host(v) for k, v in _flatten(state).items()}
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, final, flat, meta, keep)
        dist.barrier()  # no rank reads the step before it is published
        return final
    _write(ckpt_dir, step, final, flat, meta, keep)
    return final


def _write(ckpt_dir: str, step: int, final: str, flat: Dict[str, np.ndarray],
           meta: Optional[Dict], keep: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "state.npz"), **flat)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep)


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "state.npz")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None) -> Tuple[Any, Dict]:
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "state.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return _unflatten(flat), meta


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Load one checkpoint archive as a flat {key: host array} dict — the
    block-granular read path behind ``create:restore`` lineage roots (the
    executor caches the opened archive per path)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
