"""The port's kernel wrappers against the reference's Pallas kernels.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU the port's wrappers run their kernels' plain PyTorch versions (the
reference runs its Pallas kernels in interpret mode).

Tolerances: 1e-4 at f32 and 2e-2 at bf16 are the reference's own
(``tests/test_kernels.py``): f32 sums in another order, bf16 keeps 8 bits of
mantissa.  GLM quantities are f32 elementwise: 1e-6 absolute.  The Hopper
kernels themselves are held against these plain versions on the card in
``tests/test_torch_gpu.py``.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import glm_fused as ref_glm_fused
from repro.kernels import matmul as ref_matmul
from repro_torch.kernels import build, launches, ops, reset_launches
from repro_torch.kernels.matmul import _CONFIGS, matmul_ref, split_plan

SHAPES = [(128, 128, 128), (256, 128, 384), (384, 256, 128), (100, 96, 60)]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _uniform(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax and a torch array (bf16 rounds identically
    from the same f32 in both)."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

class TestMatmul:
    @pytest.mark.parametrize("m,k,n", SHAPES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas(self, m, k, n, dtype):
        ja, ta = _pair(_uniform(m * 7 + k, (m, k)), dtype)
        jb, tb = _pair(_uniform(n * 11 + k, (k, n)), dtype)
        ref = ref_matmul(ja, jb, bm=128, bn=128, bk=64, interpret=True)
        got = ops.matmul(ta, tb)
        assert got.dtype == ta.dtype and tuple(got.shape) == (m, n)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype])

    @pytest.mark.parametrize("ta,tb", [(True, False), (False, True), (True, True)])
    def test_transposed_views(self, ta, tb):
        """ta/tb operands arrive as strided views, as the cuda backend
        passes them; the result is the product of the logical operands."""
        a = _uniform(1, (100, 96))
        b = _uniform(2, (96, 60))
        A = torch.from_numpy(np.ascontiguousarray(a.T)).mT if ta else torch.from_numpy(a)
        B = torch.from_numpy(np.ascontiguousarray(b.T)).mT if tb else torch.from_numpy(b)
        assert not (ta and A.is_contiguous())
        ref = ref_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
        np.testing.assert_allclose(ops.matmul(A, B).numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4)

    def test_f64_accumulates_in_f64(self):
        rng = np.random.default_rng(3)
        a, b = rng.standard_normal((100, 300)), rng.standard_normal((300, 60))
        got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-12, atol=1e-12)

    def test_input_checks(self):
        a = torch.zeros(4, 3)
        with pytest.raises(ValueError, match="2-D"):
            ops.matmul(torch.zeros(3), torch.zeros(3, 2))
        with pytest.raises(ValueError, match="inner dims"):
            ops.matmul(a, torch.zeros(4, 2))
        with pytest.raises(TypeError, match="dtypes"):
            ops.matmul(a, torch.zeros(3, 2, dtype=torch.float64))
        with pytest.raises(TypeError, match="dtypes"):
            ops.matmul(a.int(), torch.zeros(3, 2, dtype=torch.int32))
        with pytest.raises(ValueError, match="device"):
            ops.matmul(a.to("meta"), torch.zeros(3, 2, device="meta"))

    def test_cpu_takes_plain_version_without_launch(self):
        reset_launches()
        a, b = torch.ones(8, 4), torch.ones(4, 2)
        assert torch.equal(ops.matmul(a, b), matmul_ref(a, b))
        assert launches == {"matmul": 0, "glm_fused": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0, "mamba_scan": 0,
                            "mamba_scan_bwd": 0}

    @pytest.mark.parametrize("M,N,K", [
        (131072, 1, 256),      # X @ beta
        (256, 1, 131072),      # X^T (mu - y)
        (256, 256, 131072),    # X^T (w * X)
        (4096, 4096, 4096),    # a DGEMM tile
        (100, 60, 96), (1, 1, 1), (3, 300, 7),
    ])
    def test_split_plan_covers_k(self, M, N, K):
        config, k_chunk, splits = split_plan(M, N, K)
        bm, bn, bk = _CONFIGS[config]
        assert config == (1 if N <= 8 else 0)
        assert k_chunk % bk == 0 and splits >= 1
        assert (splits - 1) * k_chunk < K <= splits * k_chunk
        tiles = math.ceil(M / bm) * math.ceil(N / bn)
        if tiles < 264 and K > bk:
            assert splits > 1   # few output tiles: the contraction is split

    def test_library_path_is_keyed_by_sources(self):
        p = build.library_path("matmul")
        assert p == build.library_path("matmul")
        assert p.parent == build.BUILD_DIR and p.name.startswith("libmatmul-")
        assert build.library_path("glm_fused") != p


# ---------------------------------------------------------------------------
# glm_fused
# ---------------------------------------------------------------------------

class TestGLMFused:
    @pytest.mark.parametrize("n,d", [(128, 1), (256, 4), (100, 1), (64, 16)])
    def test_matches_pallas(self, n, d):
        z = _uniform(n + d, (n, d), lo=-4, hi=4)
        y = (np.random.default_rng(n * d).random((n, d)) > 0.5).astype(np.float32)
        ref = ref_glm_fused(jnp.asarray(z), jnp.asarray(y), bm=32, interpret=True)
        got = ops.glm_fused(torch.from_numpy(z), torch.from_numpy(y))
        for g, r in zip(got, ref):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)

    def test_newton_step_with_kernel(self):
        """One Newton iteration computed with the port's fused quantities
        matches the reference kernel's and the numpy GLM oracle (the spec is
        the reference's test_glm_newton_with_kernel)."""
        rng = np.random.default_rng(1)
        X = rng.standard_normal((256, 8))
        beta = rng.standard_normal((8, 1)) * 0.1
        y = (rng.random((256, 1)) > 0.5).astype(np.float64)
        z = X @ beta
        mu, c, w = ops.glm_fused(torch.from_numpy(z).float(),
                                 torch.from_numpy(y).float())
        _, rc, rw = ref_glm_fused(jnp.asarray(z, jnp.float32),
                                  jnp.asarray(y, jnp.float32), bm=64,
                                  interpret=True)
        np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=1e-6)
        np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=1e-6)
        g = X.T @ c.double().numpy()
        H = X.T @ (w.double().numpy() * X)
        mu_ref = 1 / (1 + np.exp(-z))
        np.testing.assert_allclose(g, X.T @ (mu_ref - y), atol=1e-5)
        np.testing.assert_allclose(H, X.T @ ((mu_ref * (1 - mu_ref)) * X), atol=1e-5)

    def test_input_checks(self):
        z = torch.zeros(8, 2)
        with pytest.raises(ValueError, match="one shape"):
            ops.glm_fused(z, torch.zeros(8, 3))
        with pytest.raises(ValueError, match="one shape"):
            ops.glm_fused(torch.zeros(8), torch.zeros(8))
        with pytest.raises(TypeError, match="dtypes"):
            ops.glm_fused(z, z.double())
        with pytest.raises(TypeError, match="dtypes"):
            ops.glm_fused(z.int(), z.int())
        with pytest.raises(ValueError, match="device"):
            ops.glm_fused(z.to("meta"), z.to("meta"))

    def test_f64_inputs_give_f32_outputs(self):
        z = torch.linspace(-30, 30, 64, dtype=torch.float64).reshape(32, 2)
        outs = ops.glm_fused(z, torch.zeros_like(z))
        assert all(o.dtype == torch.float32 for o in outs)
        torch.testing.assert_close(outs[0], torch.sigmoid(z.float()),
                                   atol=1e-6, rtol=0)
