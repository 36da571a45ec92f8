"""The port's gradient compression against the reference's
``tests/test_train_infra.py`` cases: the mean of dequantised stochastic
roundings converges to x, the scale equals the reference's bitwise, the
tree round trip is within one quantum and the wire type is int8 (4x fewer
bytes than f32)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.train.compress import quantize_int8 as ref_quantize_int8
from repro_torch.train.compress import (compress_tree, decompress_tree, dequantize_int8,
                                        quantize_int8)


def test_int8_stochastic_rounding_unbiased():
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 0.1, (512,)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    trials = 64
    acc = torch.zeros_like(x)
    for _ in range(trials):
        q, s = quantize_int8(x, gen)
        acc = acc + dequantize_int8(q, s)
    mean = acc / trials
    quantum = float(x.abs().max()) / 127.0
    assert float((mean - x).abs().max()) < 4 * quantum / np.sqrt(trials) + 1e-7


def test_scale_equals_reference_bitwise():
    for seed, shape in ((1, (64, 8)), (2, (16,)), (3, (3, 5, 7))):
        x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
        _, s = quantize_int8(torch.from_numpy(x), torch.Generator().manual_seed(0))
        _, ref_s = ref_quantize_int8(jnp.asarray(x), jax.random.PRNGKey(0))
        assert s.dtype == torch.float32
        assert s.numpy().tobytes() == np.asarray(ref_s, np.float32).tobytes()
    zero = quantize_int8(torch.zeros(4), torch.Generator().manual_seed(0))
    assert float(zero[1]) == 1.0 and not zero[0].any()


def test_roundtrip_error_bounded_by_quantum():
    tree = {"a": torch.from_numpy(np.random.default_rng(1).normal(size=(64, 8))
                                  .astype(np.float32)),
            "b": {"c": torch.from_numpy(np.random.default_rng(2).normal(size=(16,))
                                        .astype(np.float32))}}
    qs, scales = compress_tree(tree, torch.Generator().manual_seed(3))
    back = decompress_tree(qs, scales)
    for got, want in ((back["a"], tree["a"]), (back["b"]["c"], tree["b"]["c"])):
        quantum = float(want.abs().max()) / 127.0
        assert float((got - want).abs().max()) <= quantum + 1e-7


def test_compression_ratio():
    qs, scales = compress_tree({"w": torch.zeros(1024)}, torch.Generator().manual_seed(0))
    assert qs["w"].dtype == torch.int8
    assert qs["w"].element_size() * 4 == torch.zeros(1, dtype=torch.float32).element_size()
