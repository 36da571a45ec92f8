"""granite-4.0-h-small (IBM Granite 4.0-H Small) on the port: the published
configuration and its layer schedule, and at ``reduced()`` size the port's
forward pass, chunked prefill and per-row decoding against the plain
reference (``tests/granite_reference.py``), teacher-forced with the port's
own expert choices; the chunked SSD and the Mamba-2 decode step against the
recurrence; each multiplier and the shared expert; the benchmark's own
reference (``portbench/reference/lm_decode_granite.py``) against the test
reference; the LM path's spans.  On the card (``gpu``; this file imports no
jax): the decode kernel against its plain version at the published widths,
with the state updated in place, and one ``mamba2_step`` launch per Mamba-2
layer of a decode step.

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_granite.py
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import granite_reference as ref
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import launches, ops, reset_launches
from repro_torch.kernels.mamba2_step import state_step_ref
from repro_torch.models import (Mamba2Config, decode_step, forward, init_params, param_shapes,
                                 prefill)
from repro_torch.models import moe, transformer
from repro_torch.models.ssd import ssd_chunked
from repro_torch.models.transformer import _make_caches
from repro_torch.serve import ContinuousBatcher

ROOT = Path(__file__).resolve().parents[1]

#: config.json's ``layer_types`` as published (40 entries)
LAYER_TYPES = (["mamba"] * 5 + ["attention"] + ["mamba"] * 9 + ["attention"] + ["mamba"] * 9
               + ["attention"] + ["mamba"] * 9 + ["attention"] + ["mamba"] * 4)

#: the catalog's granite-4.0-h-small (its config.json) against the port's fields
PUBLISHED = {
    "num_hidden_layers": ("n_layers", 40), "hidden_size": ("d_model", 4096),
    "num_attention_heads": ("n_heads", 32), "num_key_value_heads": ("n_kv_heads", 8),
    "vocab_size": ("vocab", 100352), "rms_norm_eps": ("norm_eps", 1e-5),
    "max_position_embeddings": ("max_seq_len", 131072),
    "tie_word_embeddings": ("tie_embeddings", True), "hidden_act": ("act", "silu"),
    "num_local_experts": ("moe.num_experts", 72), "num_experts_per_tok": ("moe.top_k", 10),
    "intermediate_size": ("moe.d_ff_expert", 768),
    "shared_intermediate_size": ("shared_d_ff", 1536),
    "mamba_d_state": ("ssm.d_state", 128), "mamba_d_conv": ("ssm.d_conv", 4),
    "mamba_n_heads": ("ssm.n_heads", 128),
    "mamba_d_head": ("ssm.head_dim", 64), "mamba_n_groups": ("ssm.n_groups", 1),
    "mamba_chunk_size": ("ssm.chunk_size", 256),
    "embedding_multiplier": ("embedding_multiplier", 12),
    "residual_multiplier": ("residual_multiplier", 0.22),
    "attention_multiplier": ("attention_scale", 0.0078125),
    "logits_scaling": ("logits_scaling", 16),
}

#: f32 on both sides; the port sums in other orders than the reference (the
#: chunked SSD against the recurrence, grouped expert products, chunked
#: prefill, attention over the whole cache), so its logits agree to
#: rounding (about 1e-6 of max|logit| here), and a wrong gate, norm,
#: multiplier or state moves them by 1e-2 or more
LOGIT_TOL = 1e-4
STATE_TOL = 1e-4


def _field(cfg, dotted):
    for part in dotted.split("."):
        cfg = getattr(cfg, part)
    return cfg


def ref_config(cfg):
    """The reference's keys (HF's names) from a port config."""
    s = cfg.ssm
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "attention_multiplier": cfg.attention_scale,
            "mamba_n_heads": s.n_heads, "mamba_d_head": s.head_dim, "mamba_d_state": s.d_state,
            "mamba_n_groups": s.n_groups, "mamba_d_conv": s.d_conv,
            "mamba_chunk_size": s.chunk_size, "rms_norm_eps": cfg.norm_eps,
            "num_experts_per_tok": cfg.moe.top_k,
            "layer_types": ["attention" if cfg.is_attention_layer(i) else "mamba"
                            for i in range(cfg.n_layers)],
            "embedding_multiplier": cfg.embedding_multiplier,
            "residual_multiplier": cfg.residual_multiplier,
            "logits_scaling": cfg.logits_scaling}


def ref_weights(params, cfg):
    """The port's parameter tree (parts stacked per layer kind) as the
    reference's one dict a layer, in f32."""
    stacked = params["layers"]
    layers = []
    for i, slots in enumerate(cfg.layer_slots()):
        lw = {"norm1": stacked["norm1"]["scale"][i].float(),
              "norm2": stacked["norm2"]["scale"][i].float()}
        for part, name in (("attn", "attn"), ("ssm", "mamba"), ("moe", "moe")):
            if part in slots:
                lw[name] = {k: v[slots[part]].float() for k, v in stacked[part].items()}
        layers.append(lw)
    return {"embed": params["embed"].float(),
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


def random_norms(params, seed=1):
    """Norm scales drawn small and nonzero (the port draws 1-D leaves zero), so
    that a norm taken over the wrong channels shows."""
    g = torch.Generator().manual_seed(seed)
    for name in ("norm1", "norm2"):
        leaf = params["layers"][name]["scale"]
        leaf.copy_(0.2 * torch.randn(leaf.shape, generator=g))
    for name in ("norm", "conv_b", "dt_bias", "D"):
        leaf = params["layers"]["ssm"][name]
        leaf.add_(0.2 * torch.randn(leaf.shape, generator=g))
    return params


@pytest.fixture(scope="module")
def small():
    cfg = get_config("granite-4.0-h-small").reduced()
    return cfg, random_norms(init_params(cfg, torch.Generator().manual_seed(0)))


def forward_routed(params, tokens, cfg, monkeypatch, impl="kernel"):
    """The port's ``forward`` logits and each MoE layer's (B * S, K) choices."""
    got = []
    real = transformer.moe_block

    def tapped(p, x, c, capacity_factor=1.25, dispatch_mode="einsum", route_tap=None):
        return real(p, x, c, capacity_factor, dispatch_mode,
                    lambda idx, counts: got.append(idx))

    monkeypatch.setattr(transformer, "moe_block", tapped)
    logits, _aux = forward(params, {"tokens": tokens}, cfg, impl=impl)
    monkeypatch.setattr(transformer, "moe_block", real)
    return logits, got


def reference_error(params, cfg, tokens, logits, choices, rcfg=None):
    """max over rows of max|logits - reference| / max|reference|, the
    reference forced to ``choices``."""
    weights, rcfg = ref_weights(params, cfg), rcfg or ref_config(cfg)
    S = tokens.shape[1]
    worst = 0.0
    for b in range(tokens.shape[0]):
        forced = [c[b * S:(b + 1) * S] for c in choices]
        want, _own, _states = ref.forward(weights, tokens[b], rcfg, forced)
        worst = max(worst, float((logits[b] - want).abs().max() / want.abs().max()))
    return worst


def test_config_is_the_published_one():
    cfg = get_config("granite-4.0-h-small")
    for key, (name, value) in PUBLISHED.items():
        assert _field(cfg, name) == value, key
    assert cfg.resolved_head_dim == 128 and cfg.rope == "none" and cfg.norm == "rmsnorm"
    # the published mamba_expand 2: the heads span twice the hidden width
    assert isinstance(cfg.ssm, Mamba2Config) and cfg.ssm.d_inner == 2 * cfg.d_model
    assert cfg.moe_renormalize and cfg.moe_dropless and cfg.gated_mlp and cfg.d_ff == 0


def test_schedule_is_the_published_layer_types():
    cfg = get_config("granite-4.0-h-small")
    assert len(LAYER_TYPES) == 40 and LAYER_TYPES.count("attention") == 4
    assert ["attention" if cfg.is_attention_layer(i) else "mamba" for i in range(40)] \
        == LAYER_TYPES
    assert all(cfg.is_ssm_layer(i) == (t == "mamba") for i, t in enumerate(LAYER_TYPES))
    assert all(cfg.is_moe_layer(i) and not cfg.is_mlp_layer(i) for i in range(40))
    small = cfg.reduced()
    assert small.n_layers == 10 and [small.layer_kinds(i) for i in (4, 5)] == [
        ("ssm", "moe"), ("attn", "moe")]


def test_parameter_counts_and_shapes():
    cfg = get_config("granite-4.0-h-small")
    assert cfg.param_count() == pytest.approx(32.2e9, rel=5e-3)
    assert cfg.active_param_count() == pytest.approx(8.8e9, rel=5e-3)
    shapes = param_shapes(cfg)["layers"]
    assert shapes["ssm"]["in_proj"] == (36, 4096, 8192 + 8448 + 128)
    assert shapes["ssm"]["conv_w"] == (36, 4, 8448) and shapes["ssm"]["A_log"] == (36, 128)
    assert shapes["ssm"]["norm"] == (36, 8192) and shapes["ssm"]["out_proj"] == (36, 8192, 4096)
    assert shapes["moe"]["w_gate"] == (40, 72, 4096, 768)
    assert shapes["moe"]["shared_w_up"] == (40, 4096, 1536)
    assert shapes["attn"]["wk"] == (4, 4096, 1024)
    assert "lm_head" not in param_shapes(cfg)
    stage = dataclasses.replace(cfg, n_layers=10)
    assert stage.param_count() == pytest.approx(8.36e9, rel=5e-3)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_forward_matches_the_reference(small, impl, monkeypatch):
    cfg, params = small
    tokens = torch.randint(0, cfg.vocab, (2, 37), generator=torch.Generator().manual_seed(2))
    logits, choices = forward_routed(params, tokens, cfg, monkeypatch, impl)
    assert len(choices) == 10
    assert reference_error(params, cfg, tokens, logits, choices) < LOGIT_TOL


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_chunked_prefill_then_decode_matches_the_reference(small, impl):
    """Three slots of different prompt lengths, admitted in chunks of 20 (so
    chunks end mid SSD chunk of 16, and state crosses both) and decoded
    together, each row at its own position; every row's logits at its last
    prompt position and at each decode step, and its first and last Mamba-2
    layers' states, against the reference over the row's prompt and fed
    tokens, with the port's expert choices."""
    cfg, params = small
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (45, 23, 9)]
    b = ContinuousBatcher(cfg, params, max_slots=3, max_len=64, impl=impl, prefill_chunk=20,
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
        assert [f.shape[0] for f in forced] == [tokens.numel()] * 10
        want, _own, states = ref.forward(weights, tokens, rcfg, forced)
        want = want[len(prompts[slot]) - 1:]
        got = torch.stack(logits[rid])
        assert float((got - want).abs().max() / want.abs().max()) < LOGIT_TOL
        for j in (0, len(states) - 1):
            state = b.cache["ssm"][j, slot]
            assert float((state - states[j]).abs().max() / states[j].abs().max()) < STATE_TOL


def test_chunked_prefill_matches_unchunked(small):
    cfg, params = small
    tokens = torch.randint(0, cfg.vocab, (2, 45), generator=torch.Generator().manual_seed(3))
    whole, c1 = prefill(params, {"tokens": tokens}, cfg, max_len=64)
    pieces, c2 = prefill(params, {"tokens": tokens}, cfg, max_len=64, chunk=7)
    assert float((whole - pieces).abs().max()) < 1e-5 * float(whole.abs().max())
    for name in ("k", "v", "conv", "ssm"):
        a, b = c1["layers"][name], c2["layers"][name]
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max()), name


def _recurrence(x, dt, A, Bm, Cm, state):
    """The SSD recurrence position by position, in float64."""
    H = x.shape[2]
    G = Bm.shape[2]
    Bh = Bm.repeat_interleave(H // G, dim=2)
    Ch = Cm.repeat_interleave(H // G, dim=2)
    ys = []
    for t in range(x.shape[1]):
        state = torch.exp(dt[:, t] * A)[..., None, None] * state \
            + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None, :]
        ys.append((state @ Ch[:, t, :, :, None])[..., 0])
    return torch.stack(ys, 1), state


@pytest.mark.parametrize("S", [1, 8, 37])
def test_ssd_chunked_matches_the_recurrence(S):
    """Chunks of 8 over a length that is or is not a multiple of them, from a
    carried state, with two groups of B and C over four heads."""
    g = torch.Generator().manual_seed(S)
    B, H, P, N, G = 2, 4, 3, 5, 2
    x, Bm, Cm = (torch.randn(shape, generator=g, dtype=torch.float64)
                 for shape in ((B, S, H, P), (B, S, G, N), (B, S, G, N)))
    dt = torch.rand(B, S, H, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 2
    state = torch.randn(B, H, P, N, generator=g, dtype=torch.float64)
    y, last = ssd_chunked(x, dt, A, Bm, Cm, 8, state)
    y_want, last_want = _recurrence(x, dt, A, Bm, Cm, state)
    torch.testing.assert_close(y, y_want, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(last, last_want, rtol=1e-10, atol=1e-10)


def step_inputs(B=3, H=4, P=3, N=5, G=2, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)

    def u(*shape, scale=1.0):
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to(dtype)

    xbc, dt, z = u(B, 1, H * P + 2 * G * N), u(B, 1, H), u(B, 1, H * P)
    state = u(B, H, P, N).float()
    params = (u(H) - 2.0, torch.log(torch.arange(1, H + 1, dtype=torch.float32)).to(dtype),
              u(H) + 1.0, u(H * P, scale=0.3))
    return xbc, dt, z, state, params


def test_plain_state_step_matches_the_recurrence():
    """``ops.mamba2_state_step`` on the CPU (its plain version): the state
    updated in place as one step of the recurrence, written out here in
    float64, and y the gated RMSNorm of S C + D x."""
    xbc, dt, z, state, (dt_bias, A_log, D, norm) = step_inputs()
    B, H, P, N = state.shape
    G, eps = 2, 1e-5
    f = {k: t.double() for k, t in dict(xbc=xbc[:, 0], dt=dt[:, 0], z=z[:, 0], h=state,
                                         dt_bias=dt_bias, A_log=A_log, D=D, norm=norm).items()}
    x = f["xbc"][:, :H * P].reshape(B, H, P)
    Bm = f["xbc"][:, H * P:H * P + G * N].reshape(B, G, N).repeat_interleave(H // G, 1)
    Cm = f["xbc"][:, H * P + G * N:].reshape(B, G, N).repeat_interleave(H // G, 1)
    step = torch.nn.functional.softplus(f["dt"] + f["dt_bias"])
    h = torch.exp(step * -torch.exp(f["A_log"]))[..., None, None] * f["h"] \
        + (step[..., None] * x)[..., None] * Bm[:, :, None, :]
    y = ((h * Cm[:, :, None, :]).sum(-1) + f["D"][:, None] * x).reshape(B, H * P)
    y = y * torch.nn.functional.silu(f["z"])
    y = y / torch.sqrt(y.square().mean(-1, keepdim=True) + eps) * (1 + f["norm"])
    ptr = state.data_ptr()
    y_got, h_got = ops.mamba2_state_step(xbc, dt, z, state, dt_bias, A_log, D, norm, eps=eps)
    assert h_got is state and state.data_ptr() == ptr
    np.testing.assert_allclose(state.numpy(), h.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_got[:, 0].numpy(), y.numpy(), rtol=1e-5, atol=1e-5)


def _swap(args, i, t):
    return args[:i] + (t,) + args[i + 1:]


@pytest.mark.parametrize("bad,error,match", [
    (lambda a: _swap(a, 0, a[0][:, :, :-1]), ValueError, "do not fit"),
    (lambda a: _swap(a, 1, a[1][:, :, :-1]), ValueError, "dt"),
    (lambda a: _swap(a, 3, a[3].double()), TypeError, "f32"),
    (lambda a: _swap(a, 7, a[7].double()), TypeError, "dtypes"),
    (lambda a: _swap(a, 3, a[3][:, :, :, :-1]), ValueError, "do not fit"),
    (lambda a: _swap(a, 7, a[7][:-1]), ValueError, "norm"),
])
def test_state_step_rejects_bad_inputs(bad, error, match):
    xbc, dt, z, state, params = step_inputs()
    with pytest.raises(error, match=match):
        ops.mamba2_state_step(*bad((xbc, dt, z, state) + params))


@pytest.mark.parametrize("drop", ["shared_expert", "embedding_multiplier",
                                  "residual_multiplier", "attention_scale", "logits_scaling"])
def test_each_multiplier_and_the_shared_expert_counts(small, drop, monkeypatch):
    """The port with one part dropped (the shared expert left out, or a
    multiplier at its neutral value) against the whole reference: far
    outside the tolerance that the whole port meets."""
    cfg, params = small
    tokens = torch.randint(0, cfg.vocab, (2, 21), generator=torch.Generator().manual_seed(7))
    port_cfg = cfg
    if drop == "shared_expert":
        monkeypatch.setattr(moe, "_with_shared", lambda p, x, out, c: out)
    else:
        port_cfg = dataclasses.replace(cfg, **{drop: None if drop == "attention_scale"
                                               else 1.0})
    logits, choices = forward_routed(params, tokens, port_cfg, monkeypatch)
    assert reference_error(params, cfg, tokens, logits, choices) > 100 * LOGIT_TOL


def _bench_reference():
    path = ROOT / "portbench" / "reference" / "lm_decode_granite.py"
    spec = importlib.util.spec_from_file_location("_granite_bench_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_benchmark_reference_matches_the_sequential_reference(small, monkeypatch):
    """``portbench/reference/lm_decode_granite.py`` (the chunked SSD of the
    paper's listing, rows batched) against this file's reference (the
    recurrence, one sequence): the logits at the positions asked for, the
    rerouted pairs and the first and last Mamba-2 layers' final states."""
    bench = _bench_reference()
    cfg, params = small
    rcfg = ref_config(cfg)
    weights = ref_weights(params, cfg)
    g = torch.Generator().manual_seed(9)
    rows = [torch.randint(0, cfg.vocab, (n,), generator=g) for n in (37, 16, 5)]
    choices, want, states, rerouted = [], [], [], []
    at = [[r.numel() - 1, r.numel() // 2] for r in rows]
    for tokens, pos in zip(rows, at):
        _logits, own, _s = ref.forward(weights, tokens, rcfg)
        # layer 3 routed as the position before it was: the router disagrees
        forced = [torch.roll(c, 1, dims=0) if j == 3 else c for j, c in enumerate(own)]
        logits, own, st = ref.forward(weights, tokens, rcfg, forced)
        choices.append(forced)
        want.append(logits[pos])
        states.append((st[0], st[-1]))
        differ = [(o.sort(-1)[0] != f.sort(-1)[0]).any(-1) for o, f in zip(own, forced)]
        rerouted.append(sum(int(d.sum()) for d in differ[:-1]) + int(differ[-1][pos].sum()))
    got, differ, seen, got_states = bench.logits_at(weights, rows, rcfg, choices, at, (0, 9))
    torch.testing.assert_close(got, torch.stack(want), rtol=1e-4, atol=1e-5)
    assert seen.tolist() == [9 * r.numel() + 2 for r in rows]
    assert differ.tolist() == rerouted and min(rerouted) > 0
    for k in range(2):
        for b in range(3):
            torch.testing.assert_close(got_states[k][b], states[b][k], rtol=1e-4, atol=1e-5)


def test_caches_hold_the_mamba2_state_of_its_layers_only():
    cfg = get_config("granite-4.0-h-small").reduced()
    caches = _make_caches(cfg, 3, 32, torch.float32, "cpu")
    assert caches["k"].shape == (1, 3, 32, 2, 16)
    assert caches["conv"].shape == (9, 3, 3, 128 + 2 * 16)
    assert caches["ssm"].shape == (9, 3, 8, 16, 16) and caches["ssm"].dtype == torch.float32


def test_spans_open_under_the_profiler_and_the_counters_count(small):
    cfg, params = small
    b = ContinuousBatcher(cfg, params, max_slots=2, max_len=64, prefill_chunk=8,
                          counters=True)
    for n in (20, 9):
        b.submit(np.arange(n) % cfg.vocab, max_new=10)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            b.step()
    names = {e.name for e in prof.events()}
    for span in ("mamba2", "attention", "moe", "head"):
        assert f"repro_torch.lm.{span}" in names
    assert "repro_torch.lm.mamba" not in names and "repro_torch.lm.mlp" not in names
    loads = b.loads()
    assert loads["decode_steps"] == 3 and loads["prefill_tokens"] == 29
    for layer in range(10):
        routed = sum(loads[f"moe{layer}.expert{e}.tokens"] for e in range(4))
        assert routed == 2 * (29 + 3 * 2)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


#: kernel against plain version, relative to the largest plain value: both
#: keep f32 from the inputs through the norm and differ in the order of the
#: sums over n and the channels (and in expf, log1pf against torch's); y
#: rounds once to the activation dtype (bf16: 2**-8 of an element)
KERNEL_TOL = {torch.float32: {"y": 1e-5, "ssm": 1e-5}, torch.bfloat16: {"y": 8e-3, "ssm": 1e-5}}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B", [1, 5, 256])
def test_kernel_step_matches_plain_version(cuda_device, B, dtype):
    """At the published widths (128 heads of 64, N 128, one group): y and the
    state against the plain version; the state row written in place, the
    other rows of a stacked cache untouched; one launch."""
    cfg = get_config("granite-4.0-h-small")
    s = cfg.ssm
    H, P, N, G = s.n_heads, s.head_dim, s.d_state, s.n_groups
    xbc, dt, z, state, params = step_inputs(B, H, P, N, G, dtype, seed=B)
    xbc, dt, z = (t.to(cuda_device) for t in (xbc, dt, z))
    params = tuple(t.to(cuda_device) for t in params)
    layers, slot = 3, 1
    first = torch.randn((layers,) + tuple(state.shape), device=cuda_device)
    caches = {impl: first.clone() for impl in ("kernel", "plain")}
    ops.mamba2_state_step(xbc, dt, z, first[slot].clone(), *params)  # builds the kernels
    ys = {}
    for impl, cache in caches.items():
        row = cache[slot]
        ptr = row.data_ptr()
        reset_launches()
        step = ops.mamba2_state_step if impl == "kernel" else state_step_ref
        ys[impl], new = step(xbc, dt, z, row, *params, eps=cfg.norm_eps)
        torch.cuda.synchronize()
        assert new is row and row.data_ptr() == ptr
        assert launches["mamba2_step"] == (1 if impl == "kernel" else 0)
        others = [i for i in range(layers) if i != slot]
        assert torch.equal(cache[others], first[others])
    tol = KERNEL_TOL[dtype]
    for name, got, want in (("y", ys["kernel"], ys["plain"]),
                            ("ssm", caches["kernel"][slot], caches["plain"][slot])):
        err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
        assert err <= tol[name], (name, err)


@pytest.mark.gpu
def test_granite_decode_step_launches_once_per_mamba2_layer(cuda_device):
    """At the cell's 10 layers (one period: 9 Mamba-2, 1 attention), reduced
    width with kernel-sized heads (2 of 64, N 64): one ``mamba2_step`` per
    Mamba-2 layer a decode step, none in the prefill, and the same logits as
    the plain route to the f32 tolerance."""
    cfg = get_config("granite-4.0-h-small").reduced()
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, n_heads=2, head_dim=64,
                                                           d_state=64))
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    tokens = (torch.arange(60, device=cuda_device).reshape(3, 20) * 7) % cfg.vocab
    logits = {}
    for impl in ("kernel", "plain"):
        _, cache = prefill(params, {"tokens": tokens}, cfg, 32, impl=impl)
        reset_launches()
        logits[impl], _ = decode_step(params, tokens[:, -1:], cache, cfg, impl=impl)
        torch.cuda.synchronize()
        assert launches["mamba2_step"] == (9 if impl == "kernel" else 0)
        assert launches["mamba_step"] == 0
    err = (logits["kernel"] - logits["plain"]).abs().max() / logits["plain"].abs().max()
    assert err.item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_attention_kernel_takes_the_softmax_scale(cuda_device, dtype):
    """Granite's 1/128 in place of 1/sqrt(128), at its decode shape (32 q
    and 8 kv heads of 128, ragged offsets), against the plain version."""
    from repro_torch.kernels.flash_attention import flash_attention_ref

    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(4, 32, 1, 128, device=cuda_device, generator=g).to(dtype)
    k, v = (torch.randn(4, 8, 700, 128, device=cuda_device, generator=g).to(dtype)
            for _ in range(2))
    off = torch.tensor([0, 99, 400, 699], dtype=torch.int32, device=cuda_device)
    got = ops.flash_attention(q, k, v, q_offset=off, max_offset=699, scale=1 / 128)
    want = flash_attention_ref(q, k, v, True, None, off, scale=1 / 128)
    default = flash_attention_ref(q, k, v, True, None, off)
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert err <= (2e-2 if dtype == torch.bfloat16 else 1e-5)
    assert ((default.float() - want.float()).abs().max() / want.float().abs().max()) > 0.05
