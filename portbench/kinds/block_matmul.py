"""Cells of the block DGEMM (configuration kind ``block_matmul``).

The system under test is ``(A @ B).compute()`` on the port's square block
arrays, then ``flush()`` and a wait for the card: one step.  Each step
drops the previous product first, as a loop that consumes each product
would.  The answer judged is every block of the window's last product.

Traffic parameters: ``grid`` (g, the blocks along each side) and
``warmup_steps``.
"""
from __future__ import annotations

import math
from time import perf_counter
from typing import Dict, List, Tuple

import torch

from portbench.runtime import (Phases, Window, host_copy, layer_ranges, lower_precision,
                               make_context, release, reset_peak, sync)

#: the sizes at which the CPU tests run this kind in seconds
SMALL = {"dim": 256}


def control(config: Dict) -> Dict:
    """The port's own path one precision below the configuration's."""
    return lower_precision(config)


def make_inputs(config: Dict, seed: int, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """A, B ~ N(0, 1) (dim, dim), drawn on ``device`` from ``seed``."""
    dim = config["dim"]
    dtype = getattr(torch, config["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    A = torch.randn((dim, dim), generator=gen, dtype=dtype, device=device)
    B = torch.randn((dim, dim), generator=gen, dtype=dtype, device=device)
    return A, B


def tile(config: Dict, traffic: Dict) -> int:
    dim, g = config["dim"], traffic["grid"]
    if dim % g:
        raise ValueError(f"dim {dim} is not a multiple of grid {g}")
    return dim // g


def step_products(config: Dict, traffic: Dict) -> List[Tuple[int, int, int, int]]:
    """(m, k, n, count): g^3 tile products of (dim/g)^3."""
    b, g = tile(config, traffic), traffic["grid"]
    return [(b, b, b, g ** 3)]


def step_flops(config: Dict, traffic: Dict) -> float:
    return 2.0 * config["dim"] ** 3


class Job:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str, context: Dict):
        self.device = device
        self.phases = Phases(device)
        self.ctx = make_context(context, device)
        self.phases.mark("context")
        A, B = make_inputs(config, seed, device)
        self.phases.mark("inputs")
        Ah, Bh = host_copy(A), host_copy(B)
        del A, B
        release(device)
        reset_peak(device)
        self.phases.mark("to_host")
        g = traffic["grid"]
        tile(config, traffic)
        self.A = self.ctx.from_numpy(Ah, grid=(g, g))
        self.B = self.ctx.from_numpy(Bh, grid=(g, g))
        del Ah, Bh
        self.phases.mark("from_numpy")
        self.C = None
        for _ in range(traffic["warmup_steps"]):
            self._step()
        self.phases.mark("warmup")

    def _step(self) -> None:
        self.C = None
        self.C = (self.A @ self.B).compute()
        self.ctx.flush()
        sync(self.device)

    def window(self, seconds: float) -> Window:
        sync(self.device)
        times = []
        t0 = perf_counter()
        while not times or perf_counter() - t0 < seconds:
            ts = perf_counter()
            self._step()
            times.append(perf_counter() - ts)
        t1 = perf_counter()
        return Window(steps=len(times), window_s=t1 - t0, step_times=times)

    def loads(self) -> Dict:
        return self.ctx.loads()

    def trace_ranges(self) -> None:
        layer_ranges(self.ctx)

    def answers(self) -> Dict[Tuple[int, int], torch.Tensor]:
        """Every block of the last product, as the tensors on the card."""
        ex = self.ctx.executor
        return {idx: ex.get(self.C.block(idx).vid) for idx in self.C.grid.iter_indices()}

    def close(self) -> None:
        del self.C, self.A, self.B, self.ctx
        release(self.device)


def check(config: Dict, traffic: Dict, seed: int, device: str,
          blocks: Dict[Tuple[int, int], torch.Tensor],
          reference) -> Tuple[Dict[str, float], int, List[str]]:
    """``c_err``: max |C - C_ref| over every block, over max |C_ref|; C_ref
    from the reference on the same inputs, drawn again from the seed."""
    A, B = make_inputs(config, seed, device)
    g, b = traffic["grid"], tile(config, traffic)
    err = scale = 0.0
    for i, rows in reference.product_rows(A, B, g):
        scale = max(scale, float(rows.abs().max()))
        for j in range(g):
            got = blocks[(i, j)].to(rows.device)
            gap = float((got - rows[:, j * b:(j + 1) * b]).abs().max())
            err = max(err, gap if gap == gap else math.inf)  # NaN reads infinity
    del A, B
    release(device)
    c_err = err / scale
    failed = 0 if c_err <= config["limits"]["c_err"] else 1
    return {"c_err": c_err}, failed, [f"blocks compared {len(blocks)}, max |C_ref| {scale!r}"]
