"""The idle readers on hand-made traces: device idle put down to the
innermost of the port's spans, nesting and the window's edges, other host
events ignored, the collector counted for neither layer, and 0.0 where no
program span is open; the counters' readers on hand-made loads."""
from __future__ import annotations

import pytest

from portbench.devtrace import DeviceTrace
from portbench.harness import Observation, load_module, reader_path
from portbench.spans import idle_ns_by_layer, innermost

from conftest import ROOT

WINDOW = (1_000, 11_000)
#: busy [1000, 2000), [4000, 5000), [9000, 11000): idle [2000, 4000), [5000, 9000)
DEVICE = [("void dmma_kernel<128>(MatArgs<double>)", 500, 2_000),
          ("void at::native::mul_kernel(double)", 4_000, 5_000),
          ("void splitk_reduce_kernel<double>(double const*)", 9_000, 12_000)]


def reader(name):
    return load_module(reader_path(ROOT / "portbench", name))


def observe(host, steps=2, loads=None):
    return Observation(steps=steps, window_s=1e-5, step_times=[], extra={}, setup_s=0.0,
                       memory_peak_bytes=0, loads=loads or {}, launches={}, step_flops=0.0,
                       step_products=[], dtype="float64", peaks={},
                       trace=DeviceTrace(WINDOW, DEVICE, host))


def idle(host):
    obs = observe(host)
    return (reader("sched_idle_ms_per_step").read(obs),
            reader("drain_idle_ms_per_step.host").read(obs))


def test_idle_goes_to_the_innermost_span():
    host = [("repro_torch.exec.drain", 1_500, 4_500),
            ("repro_torch.backend.matmul", 2_500, 3_000),
            ("repro_torch.sched.lshs", 5_000, 9_000),
            ("repro_torch.exec.drain", 6_000, 7_000),
            ("repro_torch.backend.add", 6_500, 6_600)]
    # drain: [2000, 4000) 2000 ns + [6000, 7000) 1000 ns; sched: the rest of
    # [5000, 9000), 3000 ns; two steps
    assert idle(host) == (pytest.approx(3_000 / 1e6 / 2), pytest.approx(3_000 / 1e6 / 2))
    assert idle_ns_by_layer(DeviceTrace(WINDOW, DEVICE, host)) == {"sched": 3_000,
                                                                   "drain": 3_000}


def test_nesting_and_the_windows_edges():
    host = [("repro_torch.sched.replay", 0, 12_000),      # opens before, ends after
            ("repro_torch.exec.drain", 3_000, 20_000),    # outlasts its parent: cut
            ("repro_torch.backend.mul", 8_500, 9_500)]
    assert innermost(host) == [(0, 3_000, "repro_torch.sched.replay"),
                               (3_000, 8_500, "repro_torch.exec.drain"),
                               (8_500, 9_500, "repro_torch.backend.mul"),
                               (9_500, 12_000, "repro_torch.exec.drain")]
    # sched [2000, 3000); drain [3000, 4000) + [5000, 9000)
    assert idle_ns_by_layer(DeviceTrace(WINDOW, DEVICE, host)) == {"sched": 1_000,
                                                                   "drain": 5_000}


def test_other_host_events_are_ignored():
    host = [("repro_torch.sched.fingerprint", 2_000, 4_000),
            ("aten::mm", 2_500, 3_500),
            ("scheduler: ArrayContext.compute", 1_000, 10_000),
            ("cudaLaunchKernel", 3_000, 3_100)]
    assert idle_ns_by_layer(DeviceTrace(WINDOW, DEVICE, host)) == {"sched": 2_000,
                                                                   "drain": 0}


def test_the_collector_counts_for_neither():
    host = [("repro_torch.exec.drain", 1_000, 10_000),
            ("repro_torch.pycollect.gen2", 5_500, 8_500)]
    # drain [2000, 4000) + [5000, 5500) + [8500, 9000); the collector's 3000 ns nowhere
    assert idle_ns_by_layer(DeviceTrace(WINDOW, DEVICE, host)) == {"sched": 0,
                                                                   "drain": 3_000}


def test_zero_where_no_program_span():
    assert idle([("aten::item", 2_000, 4_000)]) == (0.0, 0.0)
    assert idle([]) == (0.0, 0.0)


def test_none_without_a_trace_or_steps():
    obs = observe([], steps=0)
    assert reader("sched_idle_ms_per_step").read(obs) is None
    obs = observe([])
    obs.trace = None
    assert reader("drain_idle_ms_per_step").read(obs) is None


@pytest.mark.parametrize("name, key", [("execute_ms_per_step", "execute_s"),
                                       ("pycollect_ms_per_step.host", "pycollect_s")])
def test_counter_readers(name, key):
    assert reader(name).read(observe([], loads={key: 0.5})) == pytest.approx(250.0)
    assert reader(name).read(observe([], loads={key: 0.0})) == 0.0
    assert reader(name).read(observe([], loads={"drain_s": 1.0})) is None  # an older port
    assert reader(name).read(observe([], steps=0, loads={key: 0.5})) is None
