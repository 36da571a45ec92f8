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
from repro_torch.kernels.matmul import (F64_TILES, SMS, a_kfast, choose_loader, matmul_ref,
                                        split_plan, tile, tma_loads, vector_loads)

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
            ops.matmul(a, torch.zeros(3, 2, device="meta"))  # two devices
        # a meta tensor (a dry run's: shapes, no data) takes the plain version
        out = ops.matmul(a.to("meta"), torch.zeros(3, 2, device="meta"))
        assert out.is_meta and tuple(out.shape) == (4, 2)

    def test_cpu_takes_plain_version_without_launch(self):
        reset_launches()
        a, b = torch.ones(8, 4), torch.ones(4, 2)
        assert torch.equal(ops.matmul(a, b), matmul_ref(a, b))
        assert launches == {"matmul": 0, "glm_fused": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0, "mamba_scan": 0,
                            "mamba_scan_bwd": 0, "mamba_step": 0, "mamba2_step": 0}

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16],
                             ids=str)
    @pytest.mark.parametrize("M,N,K,kfast", [
        (131072, 1, 256, True),      # X @ beta
        (256, 1, 131072, False),     # X^T (mu - y), A read as the view X.mT
        (256, 256, 131072, False),   # X^T (w * X)
        (4096, 4096, 4096, True),    # a DGEMM tile
        (100, 60, 96, True), (1, 1, 1, True), (3, 300, 7, False),
        (1024, 1024, 1024, True),    # a DGEMM tile of the 16 x 16 grid
        (256, 256, 1 << 21, False),  # X^T (w * X) at 4 row blocks
        (4096, 4096, 4096, False),   # a transposed view's DGEMM tile
        (131072, 40, 256, True),     # rSVD's A @ Omega
        (256, 40, 131072, False),    # rSVD's A^T Q
    ])
    def test_split_plan_covers_k(self, M, N, K, kfast, dtype):
        plan = split_plan(M, N, K, dtype, kfast)
        assert (plan.config, plan.bm, plan.bn, plan.bk) == tile(dtype, M, N, kfast)
        assert plan.config == (1 if N <= 8 else 0)
        assert plan.k_chunk % plan.bk == 0 and plan.splits >= 1
        assert (plan.splits - 1) * plan.k_chunk < K <= plan.splits * plan.k_chunk
        tiles = math.ceil(M / plan.bm) * math.ceil(N / plan.bn)
        wave = plan.wave
        assert wave == (132 if (dtype, plan.bm, plan.bn) == (torch.float64, 128, 128) else 264)
        if tiles <= wave // 2 and K > plan.bk:
            assert plan.splits > 1   # few output tiles: the contraction is split
        if plan.splits > 1:
            assert tiles * plan.splits <= wave   # ... into one wave of the tile's blocks
        # slices start on whole 16-byte runs of k, as the vector loader needs
        assert (plan.k_chunk * torch.empty(0, dtype=dtype).element_size()) % 16 == 0

    @pytest.mark.parametrize("dtype,kfast,bm", [
        (torch.float64, True, 32), (torch.float64, False, 64),
        (torch.float32, True, 32), (torch.float32, False, 128),
        (torch.bfloat16, True, 128), (torch.bfloat16, False, 128),
    ], ids=str)
    def test_skinny_tile_follows_the_unit_stride(self, dtype, kfast, bm):
        """N <= 8: a block holds 8 warps x 4 rows where A is read along k,
        and a warp's 32 x 16 bytes of m where it is read along m."""
        assert tile(dtype, 4096, 8, kfast) == (1, bm, 8, 32)
        assert tile(dtype, 4096, 9, kfast)[0] == 0

    @pytest.mark.parametrize("M,N,K,kfast,name", [
        (4096, 4096, 4096, True, "128x64"),       # dgemm-tile4096's products
        (1024, 1024, 1024, True, "128x64"),       # dgemm-tile1024's, split in two
        (4096, 4096, 4096, False, "128x128"),     # the same through a transposed A
        (256, 256, 1 << 18, False, "128x128"),    # X^T (w * X), 32 row blocks
        (256, 256, 1 << 21, False, "128x128"),    # ... 4 row blocks
        (131072, 40, 256, True, "128x64"),        # rSVD's A @ Omega: N of 40
        (256, 40, 131072, False, "128x64"),       # rSVD's A^T Q
        (64, 4096, 4096, False, "128x64"),        # a short output
        (100, 60, 96, True, "128x64"),
    ])
    def test_f64_wide_tile_follows_the_shape(self, M, N, K, kfast, name):
        """f64 with N > 8 takes its block tile from the shape and orientation
        alone: 128 x 128 where A is read along m and both output sides exceed
        64, else 128 x 64."""
        bm, bn, bk = F64_TILES[name][:3]
        assert tile(torch.float64, M, N, kfast) == (0, bm, bn, bk)
        assert split_plan(M, N, K, torch.float64, kfast)[:4] == (0, bm, bn, bk)

    @pytest.mark.parametrize("name", sorted(F64_TILES))
    def test_f64_tile_ring_fits_shared_memory(self, name):
        """A block's ring of (A, B) stages, aligned up to the 128-byte
        swizzle's 1024-byte period, with a full and an empty mbarrier a stage,
        fits the 227 KB of shared memory an H100 block may have, and the
        blocks a wave holds fit 132 SMs' 228 KB.  Every TMA box (16 f64 along
        the unit-stride axis, the 128 bytes the swizzle takes) holds whole
        1024-byte periods and at most 256 rows: A's tile, B's tile, or one
        slice of k."""
        bm, bn, bk, stages, per_sm = F64_TILES[name]
        ring = stages * (bm + bn) * bk * 8
        smem = ring + 1024 + 2 * stages * 8
        assert smem <= 232448 and per_sm * (smem + 1024) <= 233472
        assert split_plan(4096, 4096, 4096, torch.float64, bm != bn).wave == SMS * per_sm
        assert bk % 16 == 0
        for rows in (bm, bn, bk):
            assert rows <= 256 and rows * 128 % 1024 == 0

    def test_main_path_operands_take_the_vector_loader(self):
        X = torch.zeros(4096, 256, dtype=torch.float64)
        beta = torch.zeros(256, 1, dtype=torch.float64)
        r = torch.zeros(4096, 1, dtype=torch.float64)
        assert a_kfast(X) and not a_kfast(X.mT)
        assert vector_loads(X, beta)              # X @ beta
        assert vector_loads(X.mT, r)              # X^T (mu - y)
        assert vector_loads(X.mT, X)              # X^T (w * X)
        sq = torch.zeros(512, 512)
        assert vector_loads(sq, sq) and vector_loads(sq.mT, sq.mT)

    def test_misaligned_views_take_the_scalar_loader(self):
        X = torch.zeros(4096, 257, dtype=torch.float64)
        assert not vector_loads(X[:, 1:], X[:, :256])     # odd base, odd row stride
        n = 4096 * 256
        Y = torch.zeros(n + 2, dtype=torch.float64)
        assert Y.data_ptr() % 16 == 0
        Xo = Y[1:n + 1].view(4096, 256)                   # 8 bytes past an aligned base
        assert not vector_loads(Xo, torch.zeros(256, 16, dtype=torch.float64))
        assert not vector_loads(Xo.mT, torch.zeros(4096, 1, dtype=torch.float64))
        assert vector_loads(Y[2:].view(4096, 256), torch.zeros(256, 1, dtype=torch.float64))
        assert not vector_loads(torch.zeros(8, 8, dtype=torch.bfloat16),
                                torch.zeros(8, 8, dtype=torch.bfloat16))

    def test_tma_loads_follow_the_vector_rule(self):
        """f64 with N > 8 takes TMA where both operands are aligned as the
        16-byte copies need, through a transposed view too; not where a base
        is 8 bytes off, a leading stride is odd, N <= 8, the dtype is f32, or
        rows coincide (a broadcast).  An f64 product with N > 8 that TMA
        cannot take copies element by element."""
        X = torch.zeros(4096, 256, dtype=torch.float64)
        W = torch.zeros(256, 64, dtype=torch.float64)
        assert tma_loads(X, W) and tma_loads(X.mT, X) and tma_loads(W.mT, X.mT)
        assert choose_loader(X.mT, X) == "tma"
        n = 4096 * 256
        Y = torch.zeros(n + 2, dtype=torch.float64)
        assert Y.data_ptr() % 16 == 0
        Xo = Y[1:n + 1].view(4096, 256)                   # 8 bytes past an aligned base
        assert not tma_loads(Xo, W) and not tma_loads(Xo.mT, X) and not tma_loads(X.mT, Xo)
        assert choose_loader(Xo.mT, X) == "scalar"
        Z = torch.zeros(4096, 257, dtype=torch.float64)
        assert not tma_loads(Z[:, :256], W)               # odd leading stride
        assert not tma_loads(W.mT, Z[:, :256].mT)
        assert not tma_loads(X, torch.zeros(256, 8, dtype=torch.float64))   # N <= 8
        assert choose_loader(X, torch.zeros(256, 8, dtype=torch.float64)) == "vector"
        assert not tma_loads(X.float(), W.float())
        assert choose_loader(X.float(), W.float()) == "vector"
        row = torch.zeros(1, 256, dtype=torch.float64)
        assert vector_loads(row.expand(4096, 256), W)
        assert not tma_loads(row.expand(4096, 256), W)   # every row the same memory
        assert choose_loader(row.expand(4096, 256), W) == "scalar"
        assert tma_loads(row, W)                          # one row: its stride is not read

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
            ops.glm_fused(z, z.to("meta"))  # two devices
        # a meta tensor (a dry run's: shapes, no data) takes the plain version
        assert all(t.is_meta and t.shape == z.shape
                   for t in ops.glm_fused(z.to("meta"), z.to("meta")))

    def test_f64_inputs_give_f32_outputs(self):
        z = torch.linspace(-30, 30, 64, dtype=torch.float64).reshape(32, 2)
        outs = ops.glm_fused(z, torch.zeros_like(z))
        assert all(o.dtype == torch.float32 for o in outs)
        torch.testing.assert_close(outs[0], torch.sigmoid(z.float()),
                                   atol=1e-6, rtol=0)
