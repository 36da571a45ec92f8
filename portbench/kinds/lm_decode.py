"""Cells of LM decoding through the port's serving path (configuration kind
``lm_decode``): a layer-scheduled hybrid model (Jamba) served by
``repro_torch.serve.ContinuousBatcher``.

The system under test is the user's entry: ``repro_torch.configs.get_config``
for the configuration's ``arch``, its published keys (HF's names) applied
over it, ``models.init_params`` on the card from the seed, and a batcher of
``sessions`` slots of ``context.max_len`` positions whose admissions prefill
in chunks of ``context.prefill_chunk``.  Set-up submits every prompt, runs
one step (which admits them all, then decodes) and ``warmup_steps`` more.  A
step of the window is one batched greedy decode step of every row, each at
its own position (``ContinuousBatcher.step``: its one host sync is the new
tokens' copy); no request is admitted or retires in the window.

The answers are each row's logits at its last prompt position and at the
last step, and the tokens and expert choices that led there (the batcher's
``LMCounters`` keeps references to the router's device tensors).  The check
runs the reference over each row's prompt and fed tokens, with the routing
forced to the program's choices, on weights drawn again from the seed.

Traffic parameters: ``sessions``, ``prompt_min``, ``prompt_max``,
``prompt_multiple`` (prompt lengths log-uniform over the range, rounded
down), ``warmup_steps``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from time import perf_counter
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import lm_counts
from portbench.runtime import Phases, Window, release, sync

#: the sizes at which the CPU tests run this kind in seconds (with
#: ``SMALL_TRAFFIC``, ``tests/test_portbench_lm_decode.py``): a narrow model
#: in float32, whose program error is rounding, with the published expert
#: width, so that the control's e4m3 rounding meets down-projection weights
#: at their full-size scale (N(0, 1/14336), mostly e4m3 subnormals); short
#: prompts, but the cell's 32 sessions, over which ``logit_err`` takes its max
SMALL = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
         "vocab_size": 512, "mamba_dt_rank": 8,
         "context": {"dtype": "float32", "impl": "kernel", "prefill_chunk": 16,
                     "max_len": 128},
         "reference_block": 16}
SMALL_TRAFFIC = {"sessions": 32, "prompt_min": 16, "prompt_max": 64, "prompt_multiple": 4,
                 "warmup_steps": 2}

#: the configuration's keys (HF's names; ``n_layers`` the layers this card
#: runs of the published ``num_hidden_layers``) and the port's fields they set
FIELDS = {"n_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
          "intermediate_size": "d_ff", "vocab_size": "vocab", "rms_norm_eps": "norm_eps",
          "max_position_embeddings": "max_seq_len", "tie_word_embeddings": "tie_embeddings",
          "attn_layer_period": "attn_layer_period", "attn_layer_offset": "attn_layer_offset",
          "expert_layer_period": "expert_layer_period",
          "expert_layer_offset": "expert_layer_offset"}
MOE_FIELDS = {"num_experts": "num_experts", "num_experts_per_tok": "top_k",
              "intermediate_size": "d_ff_expert"}
SSM_FIELDS = {"mamba_d_state": "d_state", "mamba_d_conv": "d_conv", "mamba_expand": "expand",
              "mamba_dt_rank": "dt_rank"}
#: keys whose values the port's Jamba implements, and only those
FIXED = {"model_type": "jamba", "hidden_act": "silu", "mamba_conv_bias": True,
         "mamba_proj_bias": False, "sliding_window": None, "num_logits_to_keep": 1}


def control(config: Dict) -> Dict:
    """Every weight matrix rounded through float8_e4m3fn (no scale) and back
    to bf16 before the run: the model one precision below the
    configuration's bf16.  (The experts' alone move the logits by as little
    as 1.46x the program's own bf16 error, too close for any limit.)"""
    return {"control_fp8": True}


def round_to_fp8(tree) -> None:
    """Round every weight matrix of the parameter tree through
    float8_e4m3fn and back, in place."""
    for leaf in tree.values():
        if isinstance(leaf, dict):
            round_to_fp8(leaf)
        elif leaf.dim() >= 2:
            leaf.copy_(leaf.to(torch.float8_e4m3fn).to(leaf.dtype))


def model_config(config: Dict):
    """The port's configuration: ``get_config(arch)`` with the file's keys
    applied, in the context's dtype."""
    from repro_torch.configs import get_config

    for key, value in FIXED.items():
        if config.get(key) != value:
            raise ValueError(f"lm_decode: {key}={config.get(key)!r}; the port's "
                             f"{config['arch']} implements {value!r}")
    base = get_config(config["arch"])
    cfg = dataclasses.replace(
        base, **{field: config[key] for key, field in FIELDS.items()},
        head_dim=config["hidden_size"] // config["num_attention_heads"],
        moe=dataclasses.replace(base.moe, **{f: config[k] for k, f in MOE_FIELDS.items()}),
        ssm=dataclasses.replace(base.ssm, **{f: config[k] for k, f in SSM_FIELDS.items()}),
        dtype=config["context"]["dtype"])
    return cfg


def prompt_lengths(traffic: Dict, seed: int) -> List[int]:
    rng = np.random.default_rng(seed)
    lo, hi, m = traffic["prompt_min"], traffic["prompt_max"], traffic["prompt_multiple"]
    draw = np.exp(rng.uniform(math.log(lo), math.log(hi), traffic["sessions"]))
    return [max(m, int(n) // m * m) for n in draw]


def make_prompts(config: Dict, traffic: Dict, seed: int) -> List[np.ndarray]:
    """Each session's token ids, uniform over the vocabulary, from the seed."""
    lengths = prompt_lengths(traffic, seed)
    rng = np.random.default_rng([seed, 1])
    return [rng.integers(0, config["vocab_size"], n, dtype=np.int64) for n in lengths]


def make_weights(cfg, seed: int, device: str):
    from repro_torch.models import init_params

    return init_params(cfg, torch.Generator(device=device).manual_seed(seed))


def step_flops(config: Dict, traffic: Dict) -> float:
    return lm_counts.step_flops(config, traffic)


def step_products(config: Dict, traffic: Dict) -> List[Tuple[int, int, int, int]]:
    return []


@dataclass
class Answers:
    prompts: List[np.ndarray]
    fed: List[List[int]]              # each row's tokens after its prompt
    logits: torch.Tensor              # (rows, 2, vocab) f32: last prompt position, last step
    choices: List[List[torch.Tensor]]  # [row][MoE layer] (positions, K) on the host


class Job:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str, context: Dict):
        from repro_torch.serve import ContinuousBatcher

        self.device = device
        self.config = config
        self.phases = Phases(device)
        self.cfg = model_config(config)
        params = make_weights(self.cfg, seed, device)
        if config.get("control_fp8"):
            round_to_fp8(params)
        self.phases.mark("weights")
        self.prompts = make_prompts(config, traffic, seed)
        max_len = context["max_len"]
        self.batcher = ContinuousBatcher(self.cfg, params, max_slots=len(self.prompts),
                                         max_len=max_len, impl=context["impl"],
                                         prefill_chunk=context["prefill_chunk"],
                                         counters=True)
        del params
        self.batcher.counters.choices = []
        for prompt in self.prompts:
            self.batcher.submit(prompt, max_new=max_len - prompt.size)
        # steps that leave every request short of its length cap: after k steps
        # a request holds k + 1 tokens and retires at max_new of them
        self.steps_left = min(max_len - p.size for p in self.prompts) - 2
        self.emitted: List[List[Tuple[int, int]]] = []
        self._step()  # admits every prompt, then decodes once
        if [rid for rid, _tok in self.emitted[0]] != list(range(len(self.prompts))):
            raise RuntimeError("lm_decode: the batcher did not admit request i into slot i")
        self.phases.mark("prefill")
        for _ in range(traffic["warmup_steps"]):
            self._step()
        self.phases.mark("warmup")

    def _step(self) -> None:
        if self.steps_left <= 0:
            raise RuntimeError("lm_decode: a request would reach its length cap")
        self.emitted.append(self.batcher.step())
        self.steps_left -= 1

    def window(self, seconds: float) -> Window:
        sync(self.device)
        positions = list(self.batcher.pos)
        times: List[float] = []
        t0 = perf_counter()
        while not times or (perf_counter() - t0 < seconds and self.steps_left > 0):
            ts = perf_counter()
            self._step()
            times.append(perf_counter() - ts)
        t1 = perf_counter()
        dtype = self.cfg.dtype
        extra = {"lm_bytes": lm_counts.window_bytes(self.config, dtype, positions, len(times)),
                 "expert_bytes": lm_counts.expert_bytes(self.config, dtype)}
        return Window(steps=len(times), window_s=t1 - t0, step_times=times, extra=extra)

    def loads(self) -> Dict:
        return self.batcher.loads()

    def trace_ranges(self) -> None:
        pass  # the port opens its own spans (repro_torch.lm.*, repro_torch.serve.*)

    def answers(self) -> Answers:
        b = self.batcher
        rows = len(self.prompts)
        first = torch.stack([b.prompt_logits[s] for s in range(rows)]).argmax(-1).tolist()
        fed = [[first[s]] for s in range(rows)]
        for step in self.emitted[:-1]:
            for s, (_rid, tok) in enumerate(step):
                fed[s].append(tok)
        logits = torch.stack([torch.stack([b.prompt_logits[s], b.logits[s]])
                              for s in range(rows)]).float().cpu()
        n_moe = self.cfg.layer_count("moe")
        prefill = [[[] for _ in range(n_moe)] for _ in range(rows)]
        steps: List[List[torch.Tensor]] = [[] for _ in range(n_moe)]
        for layer, slot, picked in b.counters.choices:
            if slot is None:
                steps[layer].append(picked)
            else:
                prefill[slot][layer].append(picked)
        decoded = [torch.stack(s).cpu() for s in steps]  # (steps, rows, K)
        choices = [[torch.cat([torch.cat(prefill[s][j]).cpu(), decoded[j][:, s]])
                    for j in range(n_moe)] for s in range(rows)]
        return Answers(self.prompts, fed, logits, choices)

    def close(self) -> None:
        del self.batcher
        release(self.device)


def reference_weights(params, cfg) -> Dict:
    """The port's parameter tree (parts stacked per layer kind) as the
    reference's one dict a layer (views, in the weights' own dtype)."""
    stacked = params["layers"]
    layers = []
    for i, slots in enumerate(cfg.layer_slots()):
        lw = {"norm1": stacked["norm1"]["scale"][i], "norm2": stacked["norm2"]["scale"][i]}
        for part, name in (("attn", "attn"), ("ssm", "mamba"), ("moe", "moe"), ("mlp", "mlp")):
            if part in slots:
                lw[name] = {k: v[slots[part]] for k, v in stacked[part].items()}
        layers.append(lw)
    return {"embed": params["embed"], "lm_head": params["lm_head"],
            "final_norm": params["final_norm"]["scale"], "layers": layers}


def rms(t: torch.Tensor) -> torch.Tensor:
    return t.square().mean(-1).sqrt()


def check(config: Dict, traffic: Dict, seed: int, device: str, answers: Answers,
          reference) -> Tuple[Dict[str, float], int, List[str]]:
    """The reference over each row's prompt and fed tokens, routed as the
    program routed, on the weights drawn again from the seed (the stated
    bf16 ones, also for the control).  ``logit_err``: the largest, over rows
    and the two positions, of rms(logits - reference) / rms(reference) over
    the vocabulary.  ``rerouted_share``: the share of (position, MoE layer)
    at which the reference's own top-k differs from the program's choice.
    A row fails where either exceeds its limit."""
    cfg = model_config({**config, "control_fp8": False})
    params = make_weights(cfg, seed, device)
    rows = [torch.as_tensor(np.concatenate([p, f]), device=device)
            for p, f in zip(answers.prompts, answers.fed)]
    at = [[p.size - 1, p.size + len(f) - 1] for p, f in zip(answers.prompts, answers.fed)]
    choices = [[c.to(device) for c in row] for row in answers.choices]
    t0 = perf_counter()
    with torch.no_grad():
        want, differ, seen = reference.logits_at(reference_weights(params, cfg), rows, config,
                                                 choices, at, config["reference_block"])
    want, differ, seen = want.cpu(), differ.cpu(), seen.cpu()
    seconds = perf_counter() - t0
    del params, rows, choices
    release(device)
    per_pos = rms(answers.logits - want) / rms(want)                       # (rows, 2)
    per_row = per_pos.amax(-1)
    worst = float(per_row.max())
    if not math.isfinite(worst):
        worst = math.inf
    rerouted = float(differ.sum() / seen.sum())
    row_rerouted = differ / seen
    limits = config["limits"]
    failed = int(sum(not (float(e) <= limits["logit_err"] and float(r) <= limits["rerouted_share"])
                     for e, r in zip(per_row, row_rerouted)))
    maxabs = ((answers.logits - want).abs().amax(-1) / want.abs().amax(-1)).amax()
    notes = [f"check reference_s {seconds!r}",
             f"check rows {len(at)} positions {sum(a[1] + 1 for a in at)}",
             f"check logit_err prompt_end per row {[round(float(e), 6) for e in per_pos[:, 0]]}",
             f"check logit_err last_step per row {[round(float(e), 6) for e in per_pos[:, 1]]}",
             f"check rerouted_share per row {[round(float(r), 5) for r in row_rerouted]}",
             f"check logit_maxabs_err {float(maxabs)!r} (max|d| / max|ref|; not gated)"]
    return {"logit_err": worst, "rerouted_share": rerouted}, failed, notes
