"""jamba2-mini (AI21-Jamba2-Mini) on the port: the published configuration,
its layer schedule and parameter counts, and at ``reduced()`` size the port's
prefill and per-row decoding against the plain reference
(``tests/jamba_reference.py``), teacher-forced with the port's own expert
choices.  Also: chunked prefill, the dropless router, the caches per layer
kind, and the LM path's spans and counters."""
from __future__ import annotations

import dataclasses

import jamba_reference as ref
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve_demo
from repro_torch.models import init_params, param_shapes, prefill
from repro_torch.models.moe import moe_block
from repro_torch.models.transformer import _make_caches
from repro_torch.serve import ContinuousBatcher

#: the catalog's AI21-Jamba2-Mini (its config.json) against the port's fields
PUBLISHED = {
    "num_hidden_layers": ("n_layers", 32), "hidden_size": ("d_model", 4096),
    "num_attention_heads": ("n_heads", 32), "num_key_value_heads": ("n_kv_heads", 8),
    "intermediate_size": ("d_ff", 14336), "vocab_size": ("vocab", 65536),
    "rms_norm_eps": ("norm_eps", 1e-6), "max_position_embeddings": ("max_seq_len", 262144),
    "tie_word_embeddings": ("tie_embeddings", False), "hidden_act": ("act", "silu"),
    "attn_layer_period": ("attn_layer_period", 8), "attn_layer_offset": ("attn_layer_offset", 4),
    "expert_layer_period": ("expert_layer_period", 2),
    "expert_layer_offset": ("expert_layer_offset", 1),
    "num_experts": ("moe.num_experts", 16), "num_experts_per_tok": ("moe.top_k", 2),
    "mamba_d_state": ("ssm.d_state", 16), "mamba_d_conv": ("ssm.d_conv", 4),
    "mamba_expand": ("ssm.expand", 2), "mamba_dt_rank": ("ssm.dt_rank", 256),
}

#: f32 on both sides; the port sums in other orders than the reference
#: (grouped expert products, the scan's plain version, chunked prefill,
#: attention over the whole cache), so its logits agree to rounding: 1.8e-6
#: of max|logit| seen at 8 layers, and a wrong gate, norm or state moves them
#: by 1e-2 or more
LOGIT_TOL = 1e-4


def _field(cfg, dotted):
    for part in dotted.split("."):
        cfg = getattr(cfg, part)
    return cfg


def ref_config(cfg):
    """The reference's keys (HF's names) from a port config."""
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "mamba_d_state": cfg.ssm.d_state,
            "mamba_d_conv": cfg.ssm.d_conv,
            "mamba_dt_rank": cfg.ssm.resolved_dt_rank(cfg.d_model),
            "num_experts_per_tok": cfg.moe.top_k, "rms_norm_eps": cfg.norm_eps,
            "attn_layer_period": cfg.attn_layer_period,
            "attn_layer_offset": cfg.attn_layer_offset,
            "expert_layer_period": cfg.expert_layer_period,
            "expert_layer_offset": cfg.expert_layer_offset}


def ref_weights(params, cfg):
    """The port's parameter tree (parts stacked per layer kind) as the
    reference's one dict a layer, in f32."""
    stacked = params["layers"]
    layers = []
    for i, slots in enumerate(cfg.layer_slots()):
        lw = {"norm1": stacked["norm1"]["scale"][i].float(),
              "norm2": stacked["norm2"]["scale"][i].float()}
        for part, name in (("attn", "attn"), ("ssm", "mamba"), ("moe", "moe"), ("mlp", "mlp")):
            if part in slots:
                lw[name] = {k: v[slots[part]].float() for k, v in stacked[part].items()}
        layers.append(lw)
    return {"embed": params["embed"].float(), "lm_head": params["lm_head"].float(),
            "final_norm": params["final_norm"]["scale"].float(), "layers": layers}


def row_choices(choices, slot, n_moe):
    """One batch row's expert choices per MoE layer, (positions, K) each,
    from an ``LMCounters.choices`` log: its prefill's, then its row of each
    decode step's."""
    per = [[] for _ in range(n_moe)]
    for layer, tag, picked in choices:
        if tag == slot:
            per[layer].append(picked)
        elif tag is None:
            per[layer].append(picked[slot:slot + 1])
    return [torch.cat(p) for p in per]


@pytest.fixture(scope="module")
def small():
    cfg = get_config("jamba2-mini").reduced()
    return cfg, init_params(cfg, torch.Generator().manual_seed(0))


def test_config_is_the_published_one():
    cfg = get_config("jamba2-mini")
    for key, (name, value) in PUBLISHED.items():
        assert _field(cfg, name) == value, key
    assert cfg.moe.d_ff_expert == 14336 and cfg.resolved_head_dim == 128
    assert cfg.rope == "none" and cfg.norm == "rmsnorm" and cfg.gated_mlp
    assert not cfg.moe_renormalize and cfg.moe_dropless and cfg.ssm_inner_norms
    assert cfg.ssm.d_inner(cfg.d_model) == 8192


def test_schedule_places_attention_and_experts():
    cfg = get_config("jamba2-mini")
    assert [i for i in range(32) if cfg.is_attention_layer(i)] == [4, 12, 20, 28]
    assert [i for i in range(32) if cfg.is_ssm_layer(i)] == [
        i for i in range(32) if i % 8 != 4]
    assert [i for i in range(32) if cfg.is_moe_layer(i)] == list(range(1, 32, 2))
    assert [i for i in range(32) if cfg.is_mlp_layer(i)] == list(range(0, 32, 2))
    assert [cfg.layer_count(k) for k in ("attn", "ssm", "moe", "mlp")] == [4, 28, 16, 16]
    small = cfg.reduced()
    assert small.n_layers == 8 and [small.layer_kinds(i) for i in (1, 4)] == [
        ("ssm", "moe"), ("attn", "mlp")]


def test_parameter_counts_are_the_published_ones():
    cfg = get_config("jamba2-mini")
    assert cfg.param_count() == pytest.approx(51.6e9, rel=5e-3)
    assert cfg.active_param_count() == pytest.approx(12.1e9, rel=5e-3)
    shapes = param_shapes(cfg)["layers"]
    assert shapes["attn"]["wq"] == (4, 4096, 4096)
    assert shapes["ssm"]["in_proj"] == (28, 4096, 16384)
    assert shapes["ssm"]["dt_norm"] == (28, 256) and shapes["ssm"]["b_norm"] == (28, 16)
    assert shapes["moe"]["w_gate"] == (16, 16, 4096, 14336)
    assert shapes["mlp"]["w_down"] == (16, 14336, 4096)
    assert shapes["norm1"]["scale"] == (32, 4096)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_batched_prefill_and_decode_match_the_reference(small, impl):
    """Three slots of different prompt lengths, admitted in chunks of 16 and
    decoded together, each row at its own position; every row's logits at
    its last prompt position and at each decode step against the reference
    over the row's prompt and fed tokens, with the port's expert choices."""
    cfg, params = small
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (40, 23, 9)]
    b = ContinuousBatcher(cfg, params, max_slots=3, max_len=64, impl=impl, prefill_chunk=16,
                          counters=True)
    b.counters.choices = []
    rids = [b.submit(p, max_new=8) for p in prompts]
    logits = {rid: [] for rid in rids}
    fed = {rid: [] for rid in rids}
    for _ in range(5):
        b._admit()
        for slot in range(3):
            if not fed[rids[slot]]:
                logits[rids[slot]].append(b.prompt_logits[slot].clone())
        inputs = b.cur_tokens[:, 0].tolist()
        b.step()
        for slot in range(3):
            fed[rids[slot]].append(inputs[slot])
            logits[rids[slot]].append(b.logits[slot].clone())
    weights, rcfg = ref_weights(params, cfg), ref_config(cfg)
    for slot, rid in enumerate(rids):
        tokens = torch.as_tensor(np.concatenate([prompts[slot], fed[rid]]))
        forced = row_choices(b.counters.choices, slot, cfg.layer_count("moe"))
        assert [f.shape[0] for f in forced] == [tokens.numel()] * 4
        want, _own = ref.forward(weights, tokens, rcfg, forced)
        want = want[len(prompts[slot]) - 1:]
        got = torch.stack(logits[rid])
        assert float((got - want).abs().max() / want.abs().max()) < LOGIT_TOL


def test_chunked_prefill_matches_unchunked(small):
    cfg, params = small
    tokens = torch.randint(0, cfg.vocab, (2, 45), generator=torch.Generator().manual_seed(3))
    whole, c1 = prefill(params, {"tokens": tokens}, cfg, max_len=64)
    pieces, c2 = prefill(params, {"tokens": tokens}, cfg, max_len=64, chunk=7)
    scale = float(whole.abs().max())
    assert float((whole - pieces).abs().max()) < 1e-5 * scale
    for name in ("k", "v", "conv", "ssm"):
        a, b = c1["layers"][name], c2["layers"][name]
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max()), name
    assert c1["pos"] == c2["pos"] == 45


def _one_moe(cfg, params, x):
    layer = {k: v[0] for k, v in params["layers"]["moe"].items()}
    return layer, moe_block(layer, x, cfg)[0]


def _expert_sum(layer, x, cfg, renormalize):
    """Each token's top-k experts' MLPs weighted by their softmax gates,
    expert by expert, in f32."""
    probs = torch.softmax(x.float() @ layer["router"].float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :cfg.moe.top_k], idx[..., :cfg.moe.top_k]
    if renormalize:
        gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(cfg.moe.num_experts):
        h = torch.nn.functional.silu(x @ layer["w_gate"][e]) * (x @ layer["w_up"][e])
        out = out + ((idx == e) * gates).sum(-1, keepdim=True) * (h @ layer["w_down"][e])
    return out


def test_dropless_routing_drops_nothing_when_every_token_picks_one_expert(small):
    """64 tokens all route expert 0 first: at GShard's capacity (1.25) most of
    them would be dropped; dropless, every one gets its experts' output."""
    cfg, params = small
    layer = {k: v[0].clone() for k, v in params["layers"]["moe"].items()}
    x = torch.randn(1, 64, cfg.d_model, generator=torch.Generator().manual_seed(4))
    layer["router"][:, 0] = 0.0
    x[..., 0] = 1.0
    layer["router"][0, 0] = 50.0  # expert 0 first for every token
    out = moe_block(layer, x, cfg)[0]
    want = _expert_sum(layer, x, cfg, renormalize=False)
    assert float((out - want).abs().max()) < 1e-5 * float(want.abs().max())
    capped = dataclasses.replace(cfg, moe_dropless=False)
    dropped = moe_block(layer, x, capped)[0]
    assert float((dropped - want).abs().max()) > 0.1 * float(want.abs().max())


def test_gates_are_not_renormalised(small):
    cfg, params = small
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(6))
    layer, out = _one_moe(cfg, params, x)
    assert float((out - _expert_sum(layer, x, cfg, False)).abs().max()) < 1e-5
    renorm = moe_block(layer, x, dataclasses.replace(cfg, moe_renormalize=True))[0]
    assert float((renorm - _expert_sum(layer, x, cfg, True)).abs().max()) < 1e-5
    assert float((renorm - out).abs().max()) > 1e-2 * float(out.abs().max())


def test_caches_hold_each_kind_of_state_for_its_layers_only():
    jamba = get_config("jamba2-mini").reduced()
    caches = _make_caches(jamba, 3, 32, torch.float32, "cpu")
    assert caches["k"].shape == (1, 3, 32, 2, 16) and caches["v"].shape == caches["k"].shape
    assert caches["conv"].shape[0] == caches["ssm"].shape[0] == 7
    hymba = get_config("hymba-1.5b").reduced()
    caches = _make_caches(hymba, 3, 32, torch.float32, "cpu")
    assert {name: t.shape[0] for name, t in caches.items()} == {
        "k": 2, "v": 2, "conv": 2, "ssm": 2}


def test_spans_open_under_the_profiler_and_the_counters_count(small):
    cfg, params = small
    b = ContinuousBatcher(cfg, params, max_slots=2, max_len=64, prefill_chunk=8,
                          counters=True)
    for n in (20, 9):
        b.submit(np.arange(n) % cfg.vocab, max_new=10)
    before = b.loads()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            b.step()
    names = {e.name for e in prof.events()}
    for span in ("mamba", "attention", "moe", "mlp", "head"):
        assert f"repro_torch.lm.{span}" in names
    assert {"repro_torch.serve.prefill", "repro_torch.serve.step"} <= names
    loads = b.loads()
    assert before["decode_steps"] == 0 and loads["decode_steps"] == 3
    assert loads["prefill_chunks"] == 3 + 2 and loads["prefill_tokens"] == 29
    for layer in range(4):
        routed = sum(loads[f"moe{layer}.expert{e}.tokens"] for e in range(4))
        assert routed == 2 * (29 + 3 * 2)  # top-2 of every prompt and decoded token
        assert 3 * 2 <= loads[f"moe{layer}.experts_hit"] <= 3 * 4
    assert loads["pycollect_s"] >= 0.0


def test_the_batcher_counts_only_when_asked(small, monkeypatch):
    """Without ``counters`` no MoE layer gets a routing tap (the MoE
    decoders' decode steps gain no launches); ``loads()`` is the collector's."""
    from repro_torch.models import transformer

    cfg, params = small
    taps = []
    real = transformer.moe_block

    def watched(params, x, cfg, capacity_factor=1.25, dispatch_mode="einsum",
                route_tap=None):
        taps.append(route_tap)
        return real(params, x, cfg, capacity_factor, dispatch_mode, route_tap)

    monkeypatch.setattr(transformer, "moe_block", watched)
    b = ContinuousBatcher(cfg, params, max_slots=2, max_len=64, prefill_chunk=8)
    b.submit(np.arange(12) % cfg.vocab, max_new=4)
    b.step()
    assert b.counters is None and taps and not any(taps)
    assert set(b.loads()) == {"pycollect_s"}


def test_serve_demo_runs_the_reduced_model():
    cfg = get_config("jamba2-mini").reduced()
    out = serve_demo(cfg, batch=2, prompt_len=12, gen=4, device="cpu", log_fn=lambda *_: None)
    assert out.shape == (2, 4)
