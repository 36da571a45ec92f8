"""Operation and byte counts against hand arithmetic, and the products a
step makes against the ones the port dispatches."""
from __future__ import annotations

from time import perf_counter

import pytest

from conftest import ROOT, small_cell
from portbench import counts, harness

PEAKS = counts.load_peaks()


def test_published_peaks():
    assert PEAKS["flops_per_s"]["float64"] == 67e12
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12


def test_product_counts_by_hand():
    # (256 x 262144) @ (262144 x 256): X_i^T (w_i * X_i) at q = 32
    assert counts.product_flops(256, 262144, 256) == 2 * 256 * 262144 * 256
    assert counts.product_bytes(256, 262144, 256, "float64") == 8 * (
        256 * 262144 * 2 + 256 * 256)
    t, by = counts.product_bound_s(256, 262144, 256, "float64", PEAKS)
    assert by == "operations" and t == pytest.approx(34359738368 / 67e12)
    # (262144 x 256) @ (256 x 1): X_i beta reads X_i once, so bytes bound it
    t, by = counts.product_bound_s(262144, 256, 1, "float64", PEAKS)
    assert by == "bytes"
    assert t == pytest.approx(8 * (262144 * 256 + 256 + 262144) / 3.35e12)
    # a 4096^3 f64 tile: 2.05 ms of operations
    t, by = counts.product_bound_s(4096, 4096, 4096, "float64", PEAKS)
    assert by == "operations" and t == pytest.approx(2 * 4096 ** 3 / 67e12)
    assert counts.products_bound_s([(4096, 4096, 4096, 64)], "float64", PEAKS) == \
        pytest.approx(64 * 2 * 4096 ** 3 / 67e12)


@pytest.mark.parametrize("workload, products, flops", [
    ("newton-q32", [(262144, 256, 1, 32), (256, 262144, 1, 32), (256, 262144, 256, 32)],
     2 * 2 ** 23 * 256 ** 2 + 5 * 2 ** 23 * 256),
    ("newton-q4", [(2097152, 256, 1, 4), (256, 2097152, 1, 4), (256, 2097152, 256, 4)],
     2 * 2 ** 23 * 256 ** 2 + 5 * 2 ** 23 * 256),
    ("dgemm-tile4096", [(4096, 4096, 4096, 64)], 2 * 16384 ** 3),
    ("dgemm-tile1024", [(1024, 1024, 1024, 4096)], 2 * 16384 ** 3),
])
def test_step_counts_at_cell_size(workload, products, flops):
    cell = harness.resolve(ROOT, workload)
    assert cell.kind.step_products(cell.config, cell.traffic) == products
    assert cell.kind.step_flops(cell.config, cell.traffic) == flops


@pytest.mark.parametrize("workload", ["newton-q32", "newton-q4", "dgemm-tile4096",
                                      "dgemm-tile1024"])
def test_counted_products_are_the_ones_dispatched(workload, monkeypatch):
    """The window's 2-D block products, counted where the cuda backend
    hands them to the kernel wrapper, are the steps times the counted ones,
    and of the counted shapes."""
    import repro_torch.backend.cuda_backend as cb

    seen = []
    real = cb.kernel_matmul

    def counting(a, b):
        seen.append((a.shape[0], a.shape[1], b.shape[1]))
        return real(a, b)

    monkeypatch.setattr(cb, "kernel_matmul", counting)
    cell = small_cell(workload)
    products = cell.kind.step_products(cell.config, cell.traffic)
    marks = []
    real_window = cell.kind.Job.window

    def window(job, seconds):
        marks.append(len(seen))
        win = real_window(job, seconds)
        marks.append(len(seen))
        marks.append(win.steps)
        return win

    monkeypatch.setattr(cell.kind.Job, "window", window)
    result, _ = harness.run_cell(cell, 11, 0.3, False, "cpu", perf_counter(), PEAKS)
    assert result["correct"]
    start, end, steps = marks
    window_shapes = seen[start:end]
    assert len(window_shapes) == steps * sum(c for *_s, c in products)
    assert set(window_shapes) == {(m, k, n) for m, k, n, _c in products}
