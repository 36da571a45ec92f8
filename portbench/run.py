"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(``PYTHONPATH=src python -m portbench.run ...`` does the same.)  See
``portbench/README.md``.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# The bytecode of every module a run imports (torch's, the port's, the
# standard library's) is cached at a fixed place inside the checkout, so that
# only a checkout's first run compiles Python source.  Where site-packages
# carries no bytecode and the environment forbids writing it
# (PYTHONDONTWRITEBYTECODE), every run would otherwise compile torch afresh:
# about 9 of a 20 s set-up on the H100's host, and its most variable part.
sys.pycache_prefix = str(ROOT / "build" / "portbench" / "pycache")
sys.dont_write_bytecode = False


def main(argv=None) -> int:
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    from portbench import harness

    return harness.main(argv, ROOT, T_START)


if __name__ == "__main__":
    sys.exit(main())
