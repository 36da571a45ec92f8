"""Lineage checkpoints of the port's block runtime against the reference.

``ArrayContext.checkpoint`` snapshots blocks (off the device, numpy in the
archive) and rewrites their lineage to ``create:restore`` roots, and
``ArrayContext.restore`` rebuilds a context after driver loss with its
blocks back on the device, as ``tests/test_memory.py`` holds the
reference: replay depth cut by a checkpoint (and equal to the reference's),
bits that survive a node death, restore after driver loss, refusal on the
sim executor.  Either package reads the other's block checkpoints.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P

BACKENDS = ["numpy", "torch", "cuda"]


def _ctx(pkg, backend="numpy", k=4, **kw):
    kw.setdefault("dtype", "float64")
    if pkg is P:
        kw["device"] = "cpu"
    return pkg.ArrayContext(cluster=pkg.ClusterSpec(k, 2), node_grid=(k, 1),
                            backend=backend, seed=0, **kw)


def _newton_ckpt(ctx, ckdir, iters, ckpt=True):
    """Gradient steps on a 128 x 16 logistic problem, checkpointing beta, X
    and y after each; then node death under beta and its recovery."""
    X = ctx.random((128, 16), grid=(4, 1))
    y = ctx.uniform((128, 1), grid=(4, 1))
    beta = ctx.zeros((16, 1), grid=(1, 1))
    for _ in range(iters):
        mu = (X @ beta).sigmoid().compute()
        g = (X.T @ (mu - y)).compute()
        beta = (beta - 0.1 * g).compute()
        if ckpt:
            ctx.checkpoint([beta, X, y], dir=ckdir)
    ctx.flush()
    bits = beta.to_numpy().tobytes()
    ex = ctx.executor
    vid = beta.block((0, 0)).vid
    ex.fail_node(ex.memory.node_of[ex.resolve(vid)])
    replayed = ex.recover([vid])
    assert beta.to_numpy().tobytes() == bits
    return bits, replayed


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("pipeline", [False, True])
def test_checkpoint_truncates_replay_depth_like_reference(tmp_path, backend, pipeline):
    """With per-step checkpoints recovery replays the ops since the last
    checkpoint, whatever the iteration count; without them the replay walks
    the whole lineage.  Replay counts equal the reference's, and so do the
    bits on the numpy backend (torch sums in another order: 1e-12)."""
    got = {}
    for pkg in (R, P):
        for iters in (2, 5):
            for ckpt in (True, False):
                ctx = _ctx(pkg, "numpy" if pkg is R else backend, pipeline=pipeline)
                got[pkg, iters, ckpt] = _newton_ckpt(
                    ctx, str(tmp_path / f"{pkg.__name__}{iters}{ckpt}"), iters, ckpt)
    for key in [k for k in got if k[0] is P]:
        (bits, replayed), (bits_r, replayed_r) = got[key], got[(R,) + key[1:]]
        assert replayed == replayed_r, key
        a, b = (np.frombuffer(x, dtype=np.float64) for x in (bits, bits_r))
        assert (bits == bits_r if backend == "numpy"
                else np.abs(a - b).max() <= 1e-12 * np.abs(b).max()), key
    r2, r5 = got[P, 2, True][1], got[P, 5, True][1]
    u2, u5 = got[P, 2, False][1], got[P, 5, False][1]
    assert r2 == r5 and u5 > u2 > r5


@pytest.mark.parametrize("backend", BACKENDS)
def test_checkpoint_bits_survive_node_death(tmp_path, backend):
    ctx = _ctx(P, backend, k=2)
    X = ctx.random((64, 16), grid=(4, 1))
    ref = X.to_numpy()
    ctx.checkpoint([X], dir=str(tmp_path / "ck"))
    assert ctx.loads()["mem_checkpoints"] == 1
    assert ctx.executor.fail_node(0)  # some of X's row blocks lived on node 0
    ctx.executor.recover([X.block(i).vid for i in X.grid.iter_indices()])
    assert X.to_numpy().tobytes() == ref.tobytes()
    ex = ctx.executor
    assert {ex.lineage[ex.resolve(X.block(i).vid)].op
            for i in X.grid.iter_indices()} == {"create:restore"}


@pytest.mark.parametrize("backend", BACKENDS)
def test_restore_after_driver_loss(tmp_path, backend):
    ctx = _ctx(P, backend, k=2, pipeline=True)
    X = ctx.random((64, 16), grid=(4, 1))
    w = (X.T @ X).compute()
    ref_w, ref_X = w.to_numpy(), X.to_numpy()
    final = ctx.checkpoint([w, X], dir=str(tmp_path / "ck"))
    assert os.path.isdir(final)
    del ctx  # simulated driver loss: only the archive survives
    ctx2, (w2, X2) = P.ArrayContext.restore(str(tmp_path / "ck"))
    assert (ctx2.backend, ctx2.dtype, ctx2.device, ctx2.pipeline) == (
        backend, "float64", "cpu", True)
    assert w2.to_numpy().tobytes() == ref_w.tobytes()
    assert X2.to_numpy().tobytes() == ref_X.tobytes()
    if backend != "numpy":
        assert ctx2.executor.get(X2.block((0, 0)).vid).device.type == "cpu"
    # the restored context keeps computing on the restored arrays
    assert np.allclose((X2.T @ X2).compute().to_numpy(), ref_w)


@pytest.mark.parametrize("writer,reader", [(R, P), (P, R)])
def test_either_package_restores_the_others_checkpoint(tmp_path, writer, reader):
    ctx = _ctx(writer)
    X = ctx.random((48, 8), grid=(4, 1))
    g = (X.T @ X).compute()
    writer_bits = [a.to_numpy().tobytes() for a in (g, X)]
    ctx.checkpoint([g, X], dir=str(tmp_path / "ck"), step=7)
    kw = {"device": "cpu"} if reader is P else {}
    ctx2, arrays = reader.ArrayContext.restore(str(tmp_path / "ck"), **kw)
    assert [a.to_numpy().tobytes() for a in arrays] == writer_bits
    assert [list(a.placements().values()) for a in arrays] == [
        list(a.placements().values()) for a in (g, X)]


def test_checkpoint_rejects_sim_executor(tmp_path):
    sim = P.ArrayContext(cluster=P.ClusterSpec(2, 2), node_grid=(2, 1), backend="sim")
    X = sim.random((16, 16), grid=(2, 1))
    with pytest.raises(RuntimeError, match="sim"):
        sim.checkpoint([X], dir=str(tmp_path / "ck"))
