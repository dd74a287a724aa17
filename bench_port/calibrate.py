"""The readings the check's limits are set from, for one cell at its own
size, in one process: the program's numbers over many seeds (each a short
window at the cell's load, then the check), the control's (the reference
in bfloat16 in the program's place) and those of each planted fault
(``faults.py``).

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 2] [--control 3] [--faults altered,half_batch,unchanged]

Prints one JSON line per reading: the seed, what ran ("program",
"control" or the fault), the units completed and the numbers.  Needs the
cell's CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from bench_port import faults, harness
    harness.run_env(root)
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=0,
                    help="read the control on the first N seeds")
    ap.add_argument("--faults", default="",
                    help="comma-separated faults, each on the first "
                         "three seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    arrays = harness.scene_arrays(cell)
    prog = harness.build_program(cell, arrays, dev)
    seeds = [int(s) for s in args.seeds.split(",")]
    kinds = [k for k in args.faults.split(",") if k]

    def reading(seed, kind):
        t0 = time.perf_counter()
        job_cls = harness.job_module(cell).Job
        if kind in ("program", "control"):
            job = job_cls(cell, prog, seed)
            job.warmup()
            times, _ = harness.timed_window(job, dev, args.seconds)
        else:
            with faults.fault(cell.workload["job"], kind):
                job = job_cls(cell, prog, seed)
                job.warmup()
                times, _ = harness.timed_window(job, dev, args.seconds)
        n = len(times)
        numbers = (job.control(n, arrays, dev) if kind == "control"
                   else job.check(n, arrays, dev))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "kind": kind, "units": n, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)

    for i, seed in enumerate(seeds):
        reading(seed, "program")
        if i < args.control:
            reading(seed, "control")
        if i < 3:
            for kind in kinds:
                reading(seed, kind)
    return 0


if __name__ == "__main__":
    sys.exit(main())
