"""Where a cell's traced frames go, by the program's spans.

    python3 bench_port/span_report.py --workload <cell> --seed <n>

from the root of a checkout, on the cell's card: set-up and the traced
frames as ``run.py --trace 1`` makes them (no window, no check), then one
JSON line: the device ms a frame launched inside each span name, the
frame's parts against the whole (``pc.camera`` + ``pc.bounce`` +
``pc.env`` + ``pc.image`` over ``pc.frame``), the spans entered a frame,
and the idle seconds of the traced window by the innermost span at each
idle stretch, alone and with the innermost host op there (the breakdown's
label).  Exits 2 without the cell's card.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

PARTS = ("pc.camera", "pc.bounce", "pc.env", "pc.image")
ROWS = 40


def report(tr) -> dict:
    """The span breakdown of a traced frames run (``trace.Trace``)."""
    from bench_port import spans
    names = sorted({n for n, _, _ in tr.host_ops if n.startswith("pc.")})
    launched = {n: spans.launched_ms_per_frame(tr, (n,)) for n in names}
    frame = launched.get(spans.FRAME) or 0.0
    parts = sum(launched.get(n) or 0.0 for n in PARTS)
    gaps = sorted(spans.idle_gaps(tr))
    mids = [0.5 * (lo + hi) for lo, hi in gaps]
    by_span, by_pair = collections.Counter(), collections.Counter()
    for (lo, hi), inner, label in zip(gaps, spans.innermost_spans(tr, mids),
                                      tr._host_labels(mids)):
        by_span[inner] += (hi - lo) * 1e-6
        by_pair[f"{inner} / {label}"] += (hi - lo) * 1e-6
    return {"frames": tr.n, "window_s": tr.window_s, "busy_s": tr.busy_s,
            "launched_ms": launched,
            "parts_ms": parts, "frame_ms": frame,
            "parts_rel": (parts - frame) / frame if frame else None,
            "entered": {n: len(spans.spans(tr, n)) / tr.n for n in names},
            "idle_s": dict(by_span.most_common()),
            "idle_s_by_host_op": dict(by_pair.most_common(ROWS))}


def main(argv=None) -> int:
    import torch
    from bench_port import harness, program, trace
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("span_report: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    arrays = harness.scene_arrays(cell)
    job = harness.job_module(cell).Job(
        cell, harness.build_program(cell, arrays, dev), args.seed)
    job.warmup()
    program.sync(dev)
    port = trace.port_kernel_names(
        Path(sys.modules["prismarine_core_tpu_torch"].__file__).parent
        / "csrc")
    tr, _ = harness.traced_units(job, cell.workload["job"], dev, port)
    print(json.dumps(dict(report(tr), workload=args.workload,
                          seed=args.seed)))
    return 0


if __name__ == "__main__":
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from bench_port import harness as _harness
    _harness.run_env(root)
    sys.exit(main())
