"""The comparison that decides ``correct``: it holds at small size on the
host, and it fails on the control and on each fault a cell can have, planted
under the timed path while the rest of the run goes as on the card.

Faults (the cells run on one card, so none has an exchange between cards
to leave out):

- ``unchanged``: a step returns its state unchanged (Newton: the step
  ``H^{-1} g`` is zero, so beta never moves; DGEMM: every tile product
  leaves its output as allocated, zeros);
- ``half``: half of the batch left out and the mean taken over the rest
  (every other block product reads twice, the others nothing);
- ``altered``: an answer altered where it is produced (one element of each
  block product moved by a millionth of the block's largest).
"""
from __future__ import annotations

import pytest
import torch

from conftest import run_small, small_cell

WORKLOADS = ["newton-q32", "newton-q4", "dgemm-tile4096", "dgemm-tile1024"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    result, lines = run_small(workload)
    assert result["correct"] and result["failed"] == 0
    assert lines[-len(result["checks"]):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in result["checks"].items()]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_reports_the_cells_per_layer_metrics(workload):
    """All but the kernels' roofline, which needs the card's trace."""
    result, _ = run_small(workload, trace=True)
    assert result["correct"]
    wanted = {entry["name"] for entry, _r in small_cell(workload).per_layer}
    assert set(result["metrics"]) == {n for n in wanted if not n.startswith("matmul_roofline")}
    assert 0 < result["device"]["window_s"] and result["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    """The port's float32 path in place of the configuration's float64."""
    result, _ = run_small(workload, control=True)
    assert not result["correct"]
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


def _plant(monkeypatch, fault, workload):
    import repro_torch.backend.cuda_backend as cb
    import repro_torch.glm.newton as newton

    real = cb.kernel_matmul
    calls = [0]

    if fault == "unchanged" and workload.startswith("newton"):
        real_step = newton._single_block_binary
        monkeypatch.setattr(newton, "_single_block_binary",
                            lambda ctx, op, A, B: real_step(ctx, op, A, B) * 0.0)
        return

    def broken(a, b):
        out = real(a, b)
        if fault == "unchanged":
            return torch.zeros_like(out)
        if fault == "half":
            calls[0] += 1
            return out * 2.0 if calls[0] % 2 else torch.zeros_like(out)
        out = out.clone()
        out.view(-1)[0] += 1e-6 * out.abs().max()
        return out

    monkeypatch.setattr(cb, "kernel_matmul", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    _plant(monkeypatch, fault, workload)
    result, _ = run_small(workload)
    assert not result["correct"], result["checks"]
    assert result["failed"] > 0
