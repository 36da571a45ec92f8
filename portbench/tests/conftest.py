"""Helpers of the benchmark's CPU tests: the harness's run at small sizes
on the host (the port's kernels run their plain versions there)."""
from __future__ import annotations

import copy
import sys
from pathlib import Path
from time import perf_counter

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _path in (str(ROOT / "src"), str(ROOT)):
    if _path not in sys.path:
        sys.path.insert(0, _path)


def small_cell(workload: str, root: Path = ROOT, control: bool = False, **config):
    """The cell ``workload`` at its kind's small size (the kind's ``SMALL``,
    then ``config`` overrides); ``control`` applies the kind's ``control``."""
    from portbench import harness

    cell = harness.resolve(root, workload)
    over = {**cell.kind.SMALL, **config}
    if control:
        over.update(cell.kind.control({**cell.config, **over}))
    return harness.resolve(root, workload, {"config": copy.deepcopy(over)})


def run_small(workload: str, seed: int = 2 ** 31 + 7, seconds: float = 0.3,
              trace: bool = False, root: Path = ROOT, control: bool = False, **config):
    """One run of the cell on the host: the result object and its stderr
    lines."""
    from portbench import harness
    from portbench.counts import load_peaks

    cell = small_cell(workload, root, control, **config)
    return harness.run_cell(cell, seed, seconds, trace, "cpu", perf_counter(), load_peaks())


@pytest.fixture
def cuda_device():
    """The first card, or a skip where there is none (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
