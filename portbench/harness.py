"""The benchmark of the port: one cell, run once.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the names in ``BENCHMARK.json``:

- ``BENCHMARK.json`` names each configuration's file; the file's ``kind``
  names ``kinds/<kind>.py`` (the driver: inputs, set-up, the window, the
  comparison; it exports ``KIND_PROTOCOL``, and its ``Job`` has
  ``JOB_PROTOCOL``) and ``reference/<kind>.py`` (the plain PyTorch
  reference);
- a cell's ``traffic`` names ``traffic/<traffic>.json``, the parameters its
  kind reads;
- each metric, end to end or per layer, is ``metrics/<name>.py`` (or, for a
  name ``<family>.<variant>``, the family's file), whose ``read(obs)`` takes
  it from an ``Observation`` or returns None where there is nothing to read.

A run builds the cell's job (set-up), measures ``--seconds`` of whole steps
(under ``torch.profiler`` with ``--trace 1``), reads the card's memory peak,
frees the port's state, runs the reference on the same inputs, and prints
the numbers compared beside their limits and then one JSON result line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from time import perf_counter
from typing import Dict, Iterable, List, Optional, Tuple

PACKAGE = "portbench"
#: top-level modules that no run may load: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: what a kind's module exports, and the methods of its ``Job`` (README.md)
KIND_PROTOCOL = ("SMALL", "control", "step_flops", "step_products", "check", "Job")
JOB_PROTOCOL = ("window", "answers", "close", "loads", "trace_ranges")
#: kernel and build caches of the libraries the port may use, inside the
#: checkout (the port builds its own kernels under build/repro_torch)
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "cuda_cache"}


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    kind: object
    reference: object
    end_to_end: List[Tuple[Dict, object]]
    per_layer: List[Tuple[Dict, object]]


@dataclass
class Observation:
    """What a metric's reader may read about one run."""

    steps: int
    window_s: float
    step_times: List[float]
    extra: Dict
    setup_s: float
    memory_peak_bytes: int
    loads: Dict[str, float]
    launches: Dict[str, int]
    step_flops: float
    step_products: List[Tuple[int, int, int, int]]
    dtype: str
    peaks: Dict
    trace: Optional[object] = None
    notes: List[str] = field(default_factory=list)

    def note(self, line: str) -> None:
        self.notes.append(line)


def load_module(path: Path):
    """A module loaded from its file (names may hold ``-``)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    name = f"_{PACKAGE}_{path.parent.name}_{path.stem}".replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(root: Path, workload: str, overrides: Optional[Dict] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files loaded;
    ``overrides`` ({"config": {...}, "traffic": {...}}) replaces top-level
    keys (the tests' small sizes, the control's precision)."""
    spec = load_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = by_name[workload]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    bench = root / PACKAGE
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(bench / "traffic" / f"{entry['traffic']}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    kind_path = bench / "kinds" / f"{config['kind']}.py"
    kind = load_module(kind_path)
    missing = missing_protocol(kind)
    if missing:
        raise ImportError(f"{kind_path.relative_to(root)} lacks the kind protocol's "
                          f"{', '.join(missing)}")
    return Cell(
        name=workload, chips=entry["chips"], config=config, traffic=traffic, kind=kind,
        reference=load_module(bench / "reference" / f"{config['kind']}.py"),
        end_to_end=[(m, load_module(reader_path(bench, m["name"])))
                    for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[(m, load_module(reader_path(bench, m["name"])))
                   for m in spec["per_layer"] if _applies(m, workload)])


def missing_protocol(kind) -> List[str]:
    """The names of the kind protocol that the module ``kind`` lacks."""
    missing = [name for name in KIND_PROTOCOL if not hasattr(kind, name)]
    job = getattr(kind, "Job", None)
    if job is not None:
        missing += [f"Job.{name}" for name in JOB_PROTOCOL
                    if not callable(getattr(job, name, None))]
    return missing


def reader_path(bench: Path, name: str) -> Path:
    """``metrics/<name>.py``, or for ``<family>.<variant>`` without a file of
    its own the family's reader (one quantity reported under several names,
    each with its own cells and bound)."""
    own = bench / "metrics" / f"{name}.py"
    return own if own.is_file() else bench / "metrics" / f"{name.split('.', 1)[0]}.py"


def _numeric(d: Dict) -> Dict[str, float]:
    return {k: v for k, v in d.items() if isinstance(v, (int, float))}


def _delta(after: Dict, before: Dict) -> Dict[str, float]:
    return {k: v - before.get(k, 0) for k, v in _numeric(after).items()}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, peaks: Dict) -> Tuple[Dict, List[str]]:
    """Run ``cell`` once on ``device``.  Returns the result object and the
    lines for standard error (notes, then the numbers compared)."""
    import torch

    t_port = perf_counter()
    from repro_torch.kernels import ops

    from portbench.devtrace import WINDOW_RANGE, DeviceTrace

    cuda = device.startswith("cuda")
    t_job = perf_counter()
    job = cell.kind.Job(cell.config, cell.traffic, seed, device, cell.config["context"])
    setup_s = perf_counter() - t_start
    notes = [f"setup start {t_job - t_start!r}",  # all before the job: imports, the card's count
             f"setup import_port {t_job - t_port!r}"]
    notes += [f"setup {name} {s!r}" for name, s in job.phases.seconds.items()]
    dtrace = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        job.trace_ranges()
        with torch.profiler.profile(activities=activities) as prof:
            job.window(0.0)  # one step under the profiler first: its own start-up
            loads0, launches0 = _numeric(job.loads()), dict(ops.launches)
            with torch.profiler.record_function(WINDOW_RANGE):
                win = job.window(seconds)
        dtrace = DeviceTrace.from_profiler(prof)
        del prof
    else:
        loads0, launches0 = _numeric(job.loads()), dict(ops.launches)
        win = job.window(seconds)
    loads = _delta(job.loads(), loads0)
    launches = {k: v - launches0.get(k, 0) for k, v in ops.launches.items()}
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    answers = job.answers()
    job.close()
    del job

    obs = Observation(
        steps=win.steps, window_s=win.window_s, step_times=win.step_times, extra=win.extra,
        setup_s=setup_s, memory_peak_bytes=memory_peak, loads=loads, launches=launches,
        step_flops=cell.kind.step_flops(cell.config, cell.traffic),
        step_products=cell.kind.step_products(cell.config, cell.traffic),
        dtype=cell.config["context"]["dtype"], peaks=peaks, trace=dtrace, notes=notes)
    metrics = {}
    for entry, reader in (cell.per_layer if trace else cell.end_to_end):
        value = reader.read(obs)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    numbers, failed, check_notes = cell.kind.check(cell.config, cell.traffic, seed, device,
                                                   answers, cell.reference)
    obs.notes.extend(check_notes)
    limits = cell.config["limits"]
    correct = win.steps > 0 and all(numbers[k] <= limits[k] for k in limits)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": win.steps, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        if dtrace is None:
            obs.note("trace: the profile holds no window range")
        else:
            dev["busy_s"], dev["window_s"] = dtrace.busy_s, dtrace.window_s
            result["breakdown"] = dtrace.breakdown()
    result["checks"] = {k: {"value": _number(numbers[k]), "limit": limits[k]} for k in limits}
    lines = obs.notes + [f"check {k} {numbers[k]!r} limit {limits[k]!r}" for k in limits]
    return result, lines


def _number(value: float):
    """A number for the result line; one that is not finite as its name."""
    return value if math.isfinite(value) else repr(value)


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """Top-level names among ``names`` (``sys.modules`` by default) that no
    run may hold, compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the cell's control, as its kind's `control` sets it (the port's "
                        "own path one precision below the configuration's), which must come "
                        "out not correct; the benchmark's runs never pass it")
    return p.parse_args(argv)


def main(argv: Optional[List[str]], root: Path, t_start: float) -> int:
    args = _parse(argv)
    if not (root / "src" / "repro_torch").is_dir():
        print(f"portbench: no port under {root / 'src'}: nothing to measure", file=sys.stderr)
        return 2
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(root / "build" / PACKAGE / sub)
    cell = resolve(root, args.workload)
    if args.control:
        cell = resolve(root, args.workload, {"config": cell.kind.control(cell.config)})

    import torch

    t_check = perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 3
    from portbench.counts import load_peaks

    checked = perf_counter() - t_check
    result, lines = run_cell(cell, args.seed % 2 ** 63, args.seconds, bool(args.trace),
                             "cuda:0", t_start, load_peaks())
    lines.insert(0, f"setup card_check {checked!r}")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

