"""The textured cell's map-unbound readings, which ``faults.py`` cannot
plant, and (for now) its traced frames read by every per-layer reader, in
one process on the cell's card.

    python3 bench_port/textured_readings.py --workload <cell> \\
        --seeds 1,2,3 --unbound bump,diffuse [--seconds 2] [--report]

For each seed and each kind of ``--unbound``, the program with no
material binding a ``tex_<kind>`` map (the reference keeps them): a short
window at the cell's load, then the cell's check, which must refuse it.
The program's and the control's readings are ``calibrate.py``'s.

``--report`` is temporary: four traced frames of the first seed read as
a run of the job ``frames``, so the readers that read only that job
(``spans.framed`` and the ``trace.job != "frames"`` gates) read the
textured cell too, with the host syncs of one frame, the device's busy
and window seconds and ``span_report.py``'s breakdown by span.  It goes
once those readers take every frames job and the cell is listed in them.

Prints one JSON line per reading.  Needs the cell's CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path


def unbound(prog, kind: str):
    """The program with no material binding a ``tex_<kind>`` map."""
    import torch
    mats = prog.scene.materials
    field = f"tex_{kind}"
    mats = dataclasses.replace(
        mats, **{field: torch.full_like(getattr(mats, field), -1)})
    return dataclasses.replace(
        prog, scene=dataclasses.replace(prog.scene, materials=mats))


def report(cell, prog, seed: int, dev) -> dict:
    """Four traced frames after a dropped one, read by every reader of
    ``metrics/`` as a frames run, and the frames' span breakdown."""
    from bench_port import harness, plugins, span_report, trace
    job = harness.job_module(cell).Job(cell, prog, seed)
    job.warmup()
    probe = job.sync_probe()
    syncs = trace.host_syncs(probe)
    port = trace.port_kernel_names(
        Path(sys.modules["prismarine_core_tpu_torch"].__file__).parent
        / "csrc")
    tr, _ = harness.traced_units(job, "frames", dev, port)
    tr.host_syncs = sum(syncs.values())
    names = sorted(p.stem for p in (plugins.HERE / "metrics").glob("*.py"))
    metrics = {n: harness.metric_reader(n)(tr) for n in names}
    return {"metrics": metrics, "host_syncs_by_source": dict(syncs),
            "busy_s": tr.busy_s, "window_s": tr.window_s,
            "breakdown": tr.breakdown(), "spans": span_report.report(tr)}


def main(argv=None) -> int:
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from bench_port import harness
    harness.run_env(root)
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--unbound", default="",
                    help="comma-separated map kinds, each unbound on "
                         "every seed")
    ap.add_argument("--report", action="store_true",
                    help="also trace four frames of the first seed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("textured_readings: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    arrays = harness.scene_arrays(cell)
    prog = harness.build_program(cell, arrays, dev)
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        for kind in (k for k in args.unbound.split(",") if k):
            t0 = time.perf_counter()
            job = harness.job_module(cell).Job(cell, unbound(prog, kind),
                                               seed)
            job.warmup()
            times, _ = harness.timed_window(job, dev, args.seconds)
            n = len(times)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, "units": n,
                              "failed": job.failed(n),
                              "numbers": job.check(n, arrays, dev),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    if args.report:
        print(json.dumps(dict(report(cell, prog, seeds[0], dev),
                              workload=args.workload, seed=seeds[0],
                              kind="traced")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
