"""Run one cell of the port's benchmark once.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line (the result) last on
standard output, and the numbers compared for ``correct`` beside their
limits last on standard error.  Exits 2 without the cell's CUDA cards.
See ``bench_port/README.md``.
"""

import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from bench_port import harness
    harness.run_env(root)
    sys.exit(harness.main(t_start=T_START))
