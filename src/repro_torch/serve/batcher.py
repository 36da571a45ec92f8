"""Continuous batching for LM serving (counterpart of ``repro.serve.batcher``):
vLLM-style slot recycling.

A fixed pool of ``max_slots`` decode slots shares one decode step.  Each
slot carries its own cache position, so requests of different lengths join
and leave the batch independently: when a sequence finishes (EOS or its
length cap), its slot is re-admitted with the next queued prompt's
prefilled state, with no batch-wide drain.

Where the reference vmaps its single-sequence ``decode_step`` over the slot
axis, the port runs one batched ``decode_step`` with one position per row:
the attention kernel takes one query offset per slot, and RoPE and the cache
write take each row's own position (``models.transformer.decode_step``).

Implementation notes:
  * slot positions are host ints; ``decode_step`` sends them to the device
    once a step, as one (max_slots,) int32 tensor that every layer shares.
  * the decode batch is always ``max_slots`` rows, as in the reference's
    vmap, so its shapes stay the same from step to step.  An idle slot is
    parked at position 0 of its own slot: its writes land there, and the
    next admission overwrites the slot whole.  (The reference lets an idle
    slot's position run on and clamps its writes at the cache's end; the
    port raises past the end, ROADMAP Queue 3 (f).)
  * admission prefills one prompt (B = 1) straight into the slot's own rows
    of the pooled caches (views; the slot's conv and SSM state zeroed first),
    in chunks of at most ``prefill_chunk`` positions when one is given
    (``models.transformer.prefill``): no cache of B = 1 is made or copied.
  * a step synchronises with the device once: one copy to the host of every
    slot's new token, and of the first tokens (from prefill) of the slots
    admitted in that step.
  * with ``counters=True`` an ``LMCounters`` (``models.counters``) counts
    decode steps, prefill chunks and tokens, and each MoE layer's routing on
    the device (a few launches a MoE layer, so off by default); ``loads()``
    reads them (one sync) with the collector's seconds.  While
    ``torch.profiler`` records, an admission's prefill opens the span
    ``repro_torch.serve.prefill`` and a decode step ``repro_torch.serve.step``.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.trace import COLLECTOR, SERVE_PREFILL, SERVE_STEP, maybe_span, profiling
from ..models import decode_step, prefill
from ..models.config import ModelConfig
from ..models.counters import LMCounters
from ..models.transformer import _make_caches


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    tokens: List[int] = field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Serves queued prompts through ``max_slots`` decode slots over caches of
    ``max_len`` positions, on the device the parameters lie on.  ``impl`` is
    the route of attention and the scan (``"kernel"`` or ``"plain"``, as in
    ``serve_demo``).  ``record``, when given, receives each step's host wall
    time, admissions and active slots (``"steps"``), each request's time from
    ``submit`` to its first token on the host (``"ttft_s"``) and, when
    ``run`` returns, each request's logits, one row per token
    (``"logits"``, rid -> (n, V) f32 numpy).  ``prefill_chunk`` bounds the
    positions an admission's prefill takes at once (None: the whole prompt).
    On the device stay ``logits``, the last decode step's (max_slots, V),
    and ``prompt_logits[slot]``, the slot's request's (V,) at its last
    prompt position."""

    def __init__(self, cfg: ModelConfig, params, max_slots: int = 4, max_len: int = 256,
                 eos_id: Optional[int] = None, *, impl: str = "kernel",
                 record: Optional[Dict[str, Any]] = None,
                 prefill_chunk: Optional[int] = None, counters: bool = False):
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.impl = impl
        self.prefill_chunk = prefill_chunk
        self.device = params["embed"].device
        self.counters = LMCounters(cfg, self.device) if counters else None
        COLLECTOR.install()
        self._pycollect0 = COLLECTOR.seconds
        self.logits: Optional[torch.Tensor] = None
        self.prompt_logits: List[Optional[torch.Tensor]] = [None] * max_slots
        self._queue: deque = deque()
        self._active: Dict[int, Request] = {}   # slot -> request
        self._next_rid = 0
        # pooled caches: leaves (L, slots, ...), and the slots' positions
        self.cache = _make_caches(cfg, max_slots, max_len, getattr(torch, cfg.dtype),
                                  self.device)
        self.pos = [0] * max_slots
        self.cur_tokens = torch.zeros((max_slots, 1), dtype=torch.long, device=self.device)
        self._fresh: List[int] = []  # slots admitted since the last step
        self._t_step: Optional[float] = None  # when this step's work began
        self.record = record
        if record is not None:
            record.update(steps=[], ttft_s={}, logits={})
            self._submitted: Dict[int, float] = {}
            self._logits: Dict[int, List[torch.Tensor]] = {}

    # -- API -------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int = 16) -> int:
        prompt = np.asarray(prompt, np.int64)
        # prefill writes the prompt; every decode step (at least one) one more
        need = prompt.size + max(max_new - 1, 1)
        if prompt.ndim != 1 or prompt.size == 0 or max_new < 1 or need > self.max_len:
            raise ValueError(f"submit: a prompt of {prompt.shape} tokens and max_new "
                             f"{max_new} need {need} cache positions of {self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, prompt, max_new))
        if self.record is not None:
            self._submitted[rid] = time.perf_counter()
        return rid

    def _admit(self) -> None:
        if self._t_step is None:
            self._t_step = time.perf_counter()
        free = [s for s in range(self.max_slots) if s not in self._active]
        while free and self._queue:
            slot = free.pop(0)
            req = self._queue.popleft()
            tokens = torch.as_tensor(req.prompt[None], device=self.device)
            rows = {name: pooled[:, slot:slot + 1] for name, pooled in self.cache.items()}
            for name in ("conv", "ssm"):  # the state before the first position
                if name in rows:
                    rows[name].zero_()
            if self.counters is not None:
                self.counters.slot = slot
            with maybe_span(profiling(), SERVE_PREFILL):
                logits, cache1 = prefill(self.params, {"tokens": tokens}, self.cfg,
                                         max_len=self.max_len, impl=self.impl,
                                         chunk=self.prefill_chunk, caches=rows,
                                         counters=self.counters)
            if self.counters is not None:
                self.counters.slot = None
            self.prompt_logits[slot] = logits[0, -1]
            self.cur_tokens[slot, 0] = torch.argmax(logits[0, -1])  # read at the step
            self.pos[slot] = cache1["pos"]
            self._active[slot] = req
            self._fresh.append(slot)
            if self.record is not None:
                self._logits[req.rid] = [logits[0, -1]]

    def step(self) -> List[Tuple[int, int]]:
        """One decode step across all slots; returns (rid, token) of the
        active ones."""
        self._admit()
        if not self._active:
            self._t_step = None
            return []
        inputs = self.cur_tokens
        with maybe_span(profiling(), SERVE_STEP):
            logits, _ = decode_step(self.params, inputs,
                                    {"layers": self.cache, "pos": tuple(self.pos)}, self.cfg,
                                    impl=self.impl, counters=self.counters)
            self.logits = logits[:, -1]
            next_tok = torch.argmax(self.logits, dim=-1)
            self.cur_tokens = next_tok[:, None]
            first, new = torch.stack([inputs[:, 0], next_tok]).cpu().tolist()  # the one sync
        t1 = time.perf_counter()
        fresh, self._fresh = self._fresh, []
        for slot in fresh:
            req = self._active[slot]
            req.tokens.append(first[slot])
            if self.record is not None:
                self.record["ttft_s"][req.rid] = t1 - self._submitted[req.rid]
        if self.record is not None:
            self.record["steps"].append(dict(wall_s=t1 - self._t_step, admitted=len(fresh),
                                             active=len(self._active)))
        self._t_step = None
        emitted = []
        for slot, req in list(self._active.items()):
            tok = new[slot]
            req.tokens.append(tok)
            emitted.append((req.rid, tok))
            if self.record is not None:
                self._logits[req.rid].append(logits[slot, -1])
            self.pos[slot] += 1
            if (self.eos_id is not None and tok == self.eos_id) or \
                    len(req.tokens) >= req.max_new:
                req.done = True
                del self._active[slot]   # slot freed -> next admit reuses it
                self.pos[slot] = 0       # parked until then
        return emitted

    def loads(self) -> Dict[str, float]:
        """``pycollect_s``, the seconds Python's collector ran since this
        batcher was made, and with ``counters`` the serving path's counts
        (``LMCounters.loads``, one sync)."""
        counts = self.counters.loads() if self.counters is not None else {}
        return {**counts, "pycollect_s": COLLECTOR.seconds - self._pycollect0}

    def run(self) -> Dict[int, List[int]]:
        """Drain queue + active slots; returns rid -> generated tokens."""
        results: Dict[int, List[int]] = {}
        seen: Dict[int, Request] = {}
        while self._queue or self._active:
            self._admit()
            for req in list(self._active.values()):
                seen[req.rid] = req
            self.step()
        for rid, req in seen.items():
            results[rid] = req.tokens
        if self.record is not None:
            for rid in seen:
                rows = self._logits.pop(rid, None)
                if rows is not None:
                    self.record["logits"][rid] = torch.stack(rows).float().cpu().numpy()
        return results
