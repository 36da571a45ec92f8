"""Cells of LM decoding of Granite 4.0-H through the port's serving path
(configuration kind ``lm_decode_granite``): Mamba-2 and attention layers by
``layer_types``, a MoE with a shared expert on every layer, served by
``repro_torch.serve.ContinuousBatcher``.

As ``lm_decode`` (whose prompts, set-up, steps and routing log this kind
takes over): ``repro_torch.configs.get_config`` for the configuration's
``arch`` with its published keys (HF's names) applied, ``init_params`` on
the card from the seed, a batcher of ``sessions`` slots of
``context.max_len`` positions whose admissions prefill in chunks of
``context.prefill_chunk``; set-up submits every prompt, runs one step
(admitting them all, then decoding) and ``warmup_steps`` more; a step of the
window is one batched greedy decode step of every row, with no admission or
retirement.

The answers are those of ``lm_decode`` (each row's logits at its last prompt
position and at the last step, its fed tokens and expert choices) and each
row's Mamba-2 state of the first and the last Mamba-2 layer after the last
step.  The check runs the reference over each row's prompt and fed tokens,
with the routing forced to the program's choices, on weights drawn again
from the seed, and compares ``logit_err`` and ``rerouted_share`` as
``lm_decode`` does, and ``state_err_first`` and ``state_err_last``: the
largest, over rows, of rms(state - reference) / rms(reference) in the first
and in the last Mamba-2 layer, each against a limit of its own (the last
layer's rounding is ~5x the first's).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from time import perf_counter
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import lm_counts_granite
from portbench.kinds import lm_decode
from portbench.kinds.lm_decode import make_prompts, round_to_fp8, rms
from portbench.runtime import Phases, Window, release, sync

#: the sizes at which the CPU tests run this kind in seconds (with
#: ``SMALL_TRAFFIC``, ``tests/test_portbench_lm_decode_granite.py``): a
#: narrow model in float32 with all 72 experts, top-10, of the published
#: expert width (the control's e4m3 rounding meets down-projection weights
#: at their full-size scale, and the top-10 gates carry the share of the
#: router's mass they carry at full size); Mamba-2 of 8 heads of 16, an SSD
#: chunk of 16 under prefill chunks of 24, so that state crosses both
SMALL = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
         "vocab_size": 512, "mamba_n_heads": 8, "mamba_d_head": 16,
         "mamba_d_state": 16, "mamba_chunk_size": 16,
         "context": {"dtype": "float32", "impl": "kernel", "prefill_chunk": 24,
                     "max_len": 128}}
SMALL_TRAFFIC = {"sessions": 16, "prompt_min": 16, "prompt_max": 64, "prompt_multiple": 4,
                 "warmup_steps": 2}

#: the configuration's keys (HF's names; ``n_layers`` the layers this card
#: runs of the published ``num_hidden_layers``) and the port's fields they set
FIELDS = {"n_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
          "vocab_size": "vocab", "rms_norm_eps": "norm_eps",
          "max_position_embeddings": "max_seq_len", "tie_word_embeddings": "tie_embeddings",
          "embedding_multiplier": "embedding_multiplier",
          "residual_multiplier": "residual_multiplier",
          "attention_multiplier": "attention_scale", "logits_scaling": "logits_scaling",
          "shared_intermediate_size": "shared_d_ff"}
MOE_FIELDS = {"num_local_experts": "num_experts", "num_experts_per_tok": "top_k",
              "intermediate_size": "d_ff_expert"}
SSM_FIELDS = {"mamba_d_state": "d_state", "mamba_d_conv": "d_conv",
              "mamba_n_heads": "n_heads", "mamba_d_head": "head_dim",
              "mamba_n_groups": "n_groups", "mamba_chunk_size": "chunk_size"}
#: keys whose values the port's Granite 4.0-H implements, and only those
FIXED = {"model_type": "granitemoehybrid", "hidden_act": "silu", "mamba_conv_bias": True,
         "mamba_proj_bias": False, "attention_bias": False,
         "position_embedding_type": "nope", "normalization_function": "rmsnorm"}


def control(config: Dict) -> Dict:
    """Every weight matrix rounded through float8_e4m3fn (no scale) and back
    to bf16 before the run, as ``lm_decode``'s control: the model one
    precision below the configuration's bf16."""
    return lm_decode.control(config)


def schedule(layer_types: List[str]) -> Tuple[int, int]:
    """(period, offset) of the attention layers in ``layer_types``, which
    must place them exactly every period layers from offset."""
    at = [i for i, kind in enumerate(layer_types) if kind == "attention"]
    period = at[1] - at[0] if len(at) > 1 else len(layer_types)
    if [i for i in range(len(layer_types)) if i % period == at[0]] != at:
        raise ValueError(f"lm_decode_granite: attention at {at} is not periodic")
    return period, at[0]


def model_config(config: Dict):
    """The port's configuration: ``get_config(arch)`` with the file's keys
    applied, its schedule read from ``layer_types``, in the context's dtype."""
    from repro_torch.configs import get_config

    for key, value in FIXED.items():
        if config.get(key) != value:
            raise ValueError(f"lm_decode_granite: {key}={config.get(key)!r}; the port's "
                             f"{config['arch']} implements {value!r}")
    if config["hidden_size"] * config["mamba_expand"] != (config["mamba_n_heads"]
                                                         * config["mamba_d_head"]):
        raise ValueError("lm_decode_granite: mamba_expand x hidden_size must be "
                         "mamba_n_heads x mamba_d_head")
    period, offset = schedule(config["layer_types"])
    base = get_config(config["arch"])
    return dataclasses.replace(
        base, **{field: config[key] for key, field in FIELDS.items()},
        head_dim=config["hidden_size"] // config["num_attention_heads"],
        attn_layer_period=period, attn_layer_offset=offset,
        moe=dataclasses.replace(base.moe, **{f: config[k] for k, f in MOE_FIELDS.items()}),
        ssm=dataclasses.replace(base.ssm, **{f: config[k] for k, f in SSM_FIELDS.items()}),
        dtype=config["context"]["dtype"])


def step_flops(config: Dict, traffic: Dict) -> float:
    return lm_counts_granite.step_flops(config, traffic)


def step_products(config: Dict, traffic: Dict) -> List[Tuple[int, int, int, int]]:
    return []


@dataclass
class Answers(lm_decode.Answers):
    states: List[torch.Tensor]  # [first, last Mamba-2 layer] (rows, H, P, N) f32 on the host


def mamba2_layers(cfg) -> Tuple[int, int]:
    """The first and the last Mamba-2 layer (their indices among all
    layers)."""
    at = [i for i in range(cfg.n_layers) if cfg.is_ssm_layer(i)]
    return at[0], at[-1]


class Job(lm_decode.Job):
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str, context: Dict):
        from repro_torch.models import init_params
        from repro_torch.serve import ContinuousBatcher

        self.device = device
        self.config = config
        self.phases = Phases(device)
        self.cfg = model_config(config)
        params = init_params(self.cfg, torch.Generator(device=device).manual_seed(seed))
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
        self.steps_left = min(max_len - p.size for p in self.prompts) - 2
        self.emitted: List[List[Tuple[int, int]]] = []
        self._step()  # admits every prompt, then decodes once
        if [rid for rid, _tok in self.emitted[0]] != list(range(len(self.prompts))):
            raise RuntimeError("lm_decode_granite: the batcher did not admit request i into "
                               "slot i")
        self.phases.mark("prefill")
        for _ in range(traffic["warmup_steps"]):
            self._step()
        self.phases.mark("warmup")

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
        dtype, rows = self.cfg.dtype, len(positions)
        extra = {"lm_bytes": lm_counts_granite.window_bytes(self.config, dtype, positions,
                                                            len(times)),
                 "expert_bytes": lm_counts_granite.expert_bytes(self.config, dtype),
                 "mamba2_step_bytes": lm_counts_granite.mamba2_step_bytes(self.config, dtype,
                                                                          rows),
                 "mamba2_layers": self.cfg.layer_count("ssm")}
        return Window(steps=len(times), window_s=t1 - t0, step_times=times, extra=extra)

    def answers(self) -> Answers:
        base = super().answers()
        slots = self.cfg.layer_slots()
        states = [self.batcher.cache["ssm"][slots[i]["ssm"]].cpu()
                  for i in mamba2_layers(self.cfg)]
        return Answers(**vars(base), states=states)


def reference_weights(params, cfg) -> Dict:
    """The port's parameter tree (parts stacked per layer kind) as the
    reference's one dict a layer (views, in the weights' own dtype)."""
    stacked = params["layers"]
    layers = []
    for i, slots in enumerate(cfg.layer_slots()):
        lw = {"norm1": stacked["norm1"]["scale"][i], "norm2": stacked["norm2"]["scale"][i]}
        for part, name in (("attn", "attn"), ("ssm", "mamba"), ("moe", "moe")):
            if part in slots:
                lw[name] = {k: v[slots[part]] for k, v in stacked[part].items()}
        layers.append(lw)
    return {"embed": params["embed"], "final_norm": params["final_norm"]["scale"],
            "layers": layers}


def _worst(values: torch.Tensor) -> float:
    worst = float(values.max())
    return worst if math.isfinite(worst) else math.inf


def check(config: Dict, traffic: Dict, seed: int, device: str, answers: Answers,
          reference) -> Tuple[Dict[str, float], int, List[str]]:
    """The reference over each row's prompt and fed tokens, routed as the
    program routed, on the weights drawn again from the seed (the stated
    bf16 ones, also for the control).  ``logit_err`` and ``rerouted_share``
    as ``lm_decode`` takes them; ``state_err_first`` and ``state_err_last``:
    the largest, over rows, of rms(state - reference) / rms(reference) over
    the (heads, head dim, state) of a row in the first and in the last
    Mamba-2 layer.  A row fails where any exceeds its limit."""
    from repro_torch.models import init_params

    cfg = model_config({**config, "control_fp8": False})
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    rows = [torch.as_tensor(np.concatenate([p, f]), device=device)
            for p, f in zip(answers.prompts, answers.fed)]
    at = [[p.size - 1, p.size + len(f) - 1] for p, f in zip(answers.prompts, answers.fed)]
    choices = [[c.to(device) for c in row] for row in answers.choices]
    layers = mamba2_layers(cfg)
    t0 = perf_counter()
    with torch.no_grad():
        want, differ, seen, states = reference.logits_at(
            reference_weights(params, cfg), rows, config, choices, at, layers)
    want, differ, seen = want.cpu(), differ.cpu(), seen.cpu()
    states = [s.cpu() for s in states]
    seconds = perf_counter() - t0
    del params, rows, choices
    release(device)
    per_pos = rms(answers.logits - want) / rms(want)                       # (rows, 2)
    per_row = per_pos.amax(-1)
    per_state = torch.stack([rms((got - ref).flatten(1)) / rms(ref.flatten(1))
                             for got, ref in zip(answers.states, states)], -1)  # (rows, 2)
    row_rerouted = differ / seen
    limits = config["limits"]
    failed = int(sum(not (float(e) <= limits["logit_err"]
                          and float(r) <= limits["rerouted_share"]
                          and float(s0) <= limits["state_err_first"]
                          and float(s1) <= limits["state_err_last"])
                     for e, r, (s0, s1) in zip(per_row, row_rerouted, per_state)))
    maxabs = ((answers.logits - want).abs().amax(-1) / want.abs().amax(-1)).amax()
    notes = [f"check reference_s {seconds!r}",
             f"check rows {len(at)} positions {sum(a[1] + 1 for a in at)}",
             f"check logit_err prompt_end per row {[round(float(e), 6) for e in per_pos[:, 0]]}",
             f"check logit_err last_step per row {[round(float(e), 6) for e in per_pos[:, 1]]}",
             f"check state_err layer {layers[0]} per row "
             f"{[round(float(e), 6) for e in per_state[:, 0]]}",
             f"check state_err layer {layers[1]} per row "
             f"{[round(float(e), 6) for e in per_state[:, 1]]}",
             f"check rerouted_share per row {[round(float(r), 5) for r in row_rerouted]}",
             f"check logit_maxabs_err {float(maxabs)!r} (max|d| / max|ref|; not gated)"]
    numbers = {"logit_err": _worst(per_row), "rerouted_share": float(differ.sum() / seen.sum()),
               "state_err_first": _worst(per_state[:, 0]),
               "state_err_last": _worst(per_state[:, 1])}
    return numbers, failed, notes
