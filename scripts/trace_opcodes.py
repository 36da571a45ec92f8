"""Python opcodes the flight recorder adds per dispatched op (RFC) on the
block runtime's host path: a deterministic measure of the tracer's cost,
free of the timing noise of a shared host.

    PYTHONPATH=src python scripts/trace_opcodes.py          # on the CPU, ~1 min

Runs the Newton loop's iteration body (``chip_smoke.py``'s passes: plan cache
and refcount GC on, 4 x 8 cluster, 32 row blocks, backend ``cuda`` on CPU
tensors, whose host path is the card's but for the kernel launches) once
untraced and once traced under ``sys.settrace`` opcode events, and prints
the opcodes per RFC of each, their ratio, and the functions that add most.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import FlightRecorder  # noqa: E402


def count(ctx, operands, rec):
    """Opcodes executed by one pass, total and by function."""
    total, per = [0], {}

    def local(frame, event, arg):
        if event == "opcode":
            total[0] += 1
            key = f"{Path(frame.f_code.co_filename).name}:{frame.f_code.co_name}"
            per[key] = per.get(key, 0) + 1
        return local

    def on_call(frame, event, arg):
        frame.f_trace_opcodes = True
        frame.f_trace_lines = False
        return local

    X, y, eye = operands
    if rec is None:
        cs._untrace(ctx)
    else:
        ctx._install_tracer(rec)
    ctx.reset_loads()

    def body():
        beta = ctx.zeros((cs.NEWTON["d"], 1), grid=(1, 1))
        for _ in range(cs.NEWTON["iters"]):
            beta = cs._newton_iteration(ctx, X, y, beta, eye)
        ctx.flush()

    sys.settrace(on_call)
    try:
        body()
    finally:
        sys.settrace(None)
    return total[0], per


def main():
    cs.sync = lambda: None
    cs.NEWTON.update(n=1 << 10)  # the host path does not depend on the rows
    ctx, operands = cs._newton_ctx("cuda", torch.device("cpu"))
    cs._newton_pass(ctx, operands)  # warm: plan and callable caches filled
    count(ctx, operands, FlightRecorder())
    traced, per_t = count(ctx, operands, FlightRecorder())
    untraced, per_u = count(ctx, operands, None)
    rfc = ctx.executor.stats.n_rfc
    print(f"RFCs per pass {rfc}; opcodes per RFC untraced {untraced / rfc:.1f}, "
          f"traced {traced / rfc:.1f}; ratio {traced / untraced:.4f}")
    added = sorted(((per_t.get(k, 0) - per_u.get(k, 0), k) for k in set(per_t) | set(per_u)),
                   reverse=True)
    for n, key in added[:8]:
        print(f"  +{n / rfc:6.1f} per RFC  {key}")


if __name__ == "__main__":
    main()
