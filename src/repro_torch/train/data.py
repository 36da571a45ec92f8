"""Deterministic synthetic data pipeline with checkpointable cursor (the
port's own copy of ``repro.train.data``, which is numpy-only: its batches
are bit-identical to the reference's).

Two corpora:
  * ``random``  — iid tokens (dry-run / throughput benchmarks).
  * ``pattern`` — a learnable synthetic language (repeated motifs with a
    position-dependent transform), so the end-to-end example's loss visibly
    falls.  Batches are pure functions of (seed, cursor), so resuming from a
    checkpoint replays the exact stream (fault-tolerance tests rely on this).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    corpus: str = "pattern"   # random | pattern
    seed: int = 0


class TokenPipeline:
    def __init__(self, cfg: DataConfig, cursor: int = 0):
        self.cfg = cfg
        self.cursor = cursor

    def state(self) -> Dict[str, int]:
        return {"cursor": self.cursor, "seed": self.cfg.seed}

    @classmethod
    def restore(cls, cfg: DataConfig, state: Dict[str, int]) -> "TokenPipeline":
        assert state["seed"] == cfg.seed, "data seed mismatch on restore"
        return cls(cfg, cursor=state["cursor"])

    def _batch_at(self, cursor: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, cursor))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
        if cfg.corpus == "random":
            tokens = rng.integers(0, V, size=(B, S), dtype=np.int32)
        else:
            # motif language: a fixed pool of motifs (function of the seed
            # only); each row tiles one motif with a random phase.  Highly
            # learnable (the model memorizes the pool) but non-constant.
            motif_len = 8
            pool_rng = np.random.default_rng(cfg.seed)
            pool = pool_rng.integers(0, V, size=(16, motif_len), dtype=np.int32)
            choice = rng.integers(0, 16, size=B)
            phase = rng.integers(0, motif_len, size=B)
            reps = (S + 2 * motif_len - 1) // motif_len
            tiled = np.tile(pool[choice], (1, reps))
            rows = np.stack([tiled[i, p : p + S + 1] for i, p in enumerate(phase)])
            tokens = rows[:, :S].astype(np.int32)
            labels = rows[:, 1 : S + 1].astype(np.int32)
            return {"tokens": tokens, "labels": labels}
        labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self._batch_at(self.cursor)
        self.cursor += 1
        return batch
