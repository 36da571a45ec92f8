"""The trace arithmetic on hand-made spans: busy time as a union clipped to
the window, device time by kernel name, idle gaps named by the host."""
from __future__ import annotations

import pytest

from portbench.devtrace import DeviceTrace

WINDOW = (1_000, 11_000)
DEVICE = [
    ("void dmma_kernel<128>(MatArgs<double>)", 500, 2_000),   # starts before the window
    ("void splitk_reduce_kernel<double>(double const*)", 1_500, 3_000),  # overlaps
    ("Memcpy DtoH (Device -> Pageable)", 5_000, 6_000),
    ("void at::native::(anonymous namespace)::mul_kernel(float)", 9_000, 12_000),
]
HOST = [
    ("aten::item", 3_000, 5_000),
    ("aten::_local_scalar_dense", 3_500, 4_900),
    ("cudaLaunchKernel", 8_900, 9_000),
]


@pytest.fixture
def trace():
    return DeviceTrace(WINDOW, DEVICE, HOST)


def test_busy_is_the_clipped_union(trace):
    # [1000, 3000) + [5000, 6000) + [9000, 11000)
    assert trace.busy_s == pytest.approx(5_000 / 1e9)
    assert trace.window_s == pytest.approx(10_000 / 1e9)


def test_seconds_by_kernel_name(trace):
    assert trace.seconds_of(["dmma_kernel", "splitk_reduce_kernel"]) == \
        pytest.approx((1_000 + 1_500) / 1e9)
    assert trace.seconds_of(["sgemm_kernel"]) == 0.0


def test_gaps_and_their_host_labels(trace):
    assert trace.gaps() == [(3_000, 5_000), (6_000, 9_000)]
    bd = trace.breakdown()
    assert bd["idle_gaps"] == [["host in python (no torch operation) at +0.000 s", 3_000 / 1e9],
                               ["host in aten::_local_scalar_dense at +0.000 s", 2_000 / 1e9]]
    names = [name for name, _s in bd["device_ops"]]
    assert names[0] == "void at::native::::mul_kernel"
    assert "Memcpy DtoH (Device -> Pageable)" in names
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_no_device_events():
    trace = DeviceTrace(WINDOW, [], HOST)
    assert trace.busy_s == 0.0
    assert trace.gaps() == [WINDOW]
