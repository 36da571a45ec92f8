"""On the card: a traced run at small size reads device time, and its
shares stay shares."""
from __future__ import annotations

from time import perf_counter

import pytest

from conftest import small_cell
from portbench import harness
from portbench.counts import load_peaks


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["newton-q32", "dgemm-tile4096"])
def test_traced_run_on_the_card(workload, cuda_device):
    cell = small_cell(workload, n_rows=1 << 18, dim=2048)
    result, _ = harness.run_cell(cell, 2 ** 31 + 5, 1.0, True, cuda_device, perf_counter(),
                                 load_peaks())
    assert result["correct"]
    dev = result["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    assert dev["memory_peak_bytes"] > 0
    by_family = {name.split(".")[0]: m["value"] for name, m in result["metrics"].items()}
    for name in ("matmul_roofline", "step_mfu", "device_idle"):
        assert 0 < by_family[name] <= 105, name
    assert result["breakdown"]["device_ops"]
