"""Counters of the LM serving path (``prefill``, ``decode_step``,
``serve.ContinuousBatcher``).

Host counts (decode steps, prefill chunks and tokens) are Python ints.  The
routing counts stay on the device: each MoE layer adds its per-expert token
counts into a device tensor, so a step gains no sync; :meth:`LMCounters.loads`
reads them to the host, once, where it is called.  With ``choices`` a list,
every MoE layer also appends its expert choices there, as a compact copy on
the device (one launch, no sync): the router's choices are a view of its
whole sort over the experts, which the log would otherwise keep alive (1.5
MB a decode step of 256 rows over 72 experts, which grew the allocator on
every step).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


class LMCounters:
    """Counts of one serving path over the MoE layers of ``cfg``."""

    def __init__(self, cfg, device):
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.prefill_tokens = 0
        n_moe = cfg.layer_count("moe")
        experts = cfg.moe.num_experts if cfg.moe is not None else 0
        #: tokens routed to each expert of each MoE layer, (n_moe, E)
        self.expert_tokens = torch.zeros((n_moe, experts), dtype=torch.int64, device=device)
        #: experts that received a token, summed over decode steps, (n_moe,)
        self.experts_hit = torch.zeros((n_moe,), dtype=torch.int64, device=device)
        #: set by the entry points: whether the pass is a decode step
        self.decoding = False
        #: set by the batcher around an admission: the slot being prefilled
        self.slot: Optional[int] = None
        #: (MoE layer, slot or None for a decode step's rows, (N, K) expert
        #: choices in ``choice_dtype``) in call order, while a list
        self.choices: Optional[List[Tuple[int, Optional[int], torch.Tensor]]] = None
        #: the smallest integer type that holds an expert's index
        self.choice_dtype = torch.uint8 if experts <= 256 else torch.int32

    def routed(self, layer: int, choices: torch.Tensor, counts: torch.Tensor) -> None:
        """MoE layer ``layer`` (its index among the MoE layers) routed the
        (N, K) ``choices``, ``counts`` (E,) tokens to each expert."""
        self.expert_tokens[layer] += counts
        if self.decoding:
            self.experts_hit[layer] += (counts > 0).sum()
        if self.choices is not None:
            self.choices.append((layer, self.slot, choices.to(self.choice_dtype)))

    def loads(self) -> Dict[str, float]:
        """Every count by name, read to the host (one sync)."""
        out: Dict[str, float] = {"decode_steps": self.decode_steps,
                                 "prefill_chunks": self.prefill_chunks,
                                 "prefill_tokens": self.prefill_tokens}
        hit = self.experts_hit.tolist()
        for layer, row in enumerate(self.expert_tokens.tolist()):
            out[f"moe{layer}.experts_hit"] = hit[layer]
            for expert, n in enumerate(row):
                out[f"moe{layer}.expert{expert}.tokens"] = n
        return out
