"""The benchmark harness: one run of one cell of ``BENCHMARK.json``.

A cell names a workload file (``workloads/<cell>.json``: its
configuration, its job, its sampling, its check), the workload names a
configuration file (``BENCHMARK.json``'s ``file`` of that configuration:
the scene, the camera, the ``RenderConfig`` and the train step's rates),
and every other part is a module found by name (``plugins.py``): the
scene generator, the sampler, the job (``jobs/frames.py``,
``jobs/train.py``) and each per-layer metric's reader.

Set-up (``setup_s``) runs from the process start to the first timed frame
or step: imports, the CUDA context, the scene arrays, the port's scene
with its BVH and packets, the kernels' library (built once per checkout
under ``build/torch_kernels/``), the job's warm-up.  After the window the
program's outputs are held against the plain reference (``reference/``),
and ``correct`` says whether every number compared is within its limit
(``compare.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import sys
import time
from pathlib import Path

import torch

from bench_port import plugins, program, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "prismarine_core_tpu")
#: units (frames or steps) traced after a dropped one
TRACED_UNITS = 4


class NoDevice(RuntimeError):
    """The cell's cards are not there."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    end_to_end: list          # the BENCHMARK.json entries this cell reports
    per_layer: list
    base: Path = HERE         # the folder its parts are found in


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, base: Path = HERE) -> Cell:
    """The cell's workload and configuration and the metrics it reports,
    found by name: ``BENCHMARK.json`` at ``root``, the workload file under
    ``base``/workloads, the configuration at its ``file``."""
    bench = load_json(root / "BENCHMARK.json")
    workload = load_json(base / "workloads" / f"{name}.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(root / conf["file"])
    if config["name"] != entry["config"] or \
            workload["config"] != entry["config"]:
        raise ValueError(f"{name}: the workload file, the configuration "
                         "file and BENCHMARK.json name different configs")
    return Cell(name, dict(workload, chips=entry["chips"]), config,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)], base)


def metric_reader(name: str, base: Path = HERE):
    """The ``read`` function of ``base``/metrics/<name>.py."""
    return plugins.load("metrics", name, base).read


def job_module(cell: Cell):
    """The module of the cell's job (``jobs/<job>.py``)."""
    return plugins.load("jobs", cell.workload["job"], cell.base)


def scene_arrays(cell: Cell) -> dict:
    """The configuration's input arrays, from the scene generator its
    ``scene`` block names (``scenes/<generator>.py``)."""
    spec = cell.config["scene"]
    return plugins.load("scenes", spec["generator"], cell.base).arrays(spec)


def build_program(cell: Cell, arrays: dict, dev) -> program.Program:
    """The system under test, built as the cell's job says (by default
    ``program.build``)."""
    build = getattr(job_module(cell), "build", program.build)
    return build(cell.config, arrays, dev)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"bench_port: {msg}", file=sys.stderr, flush=True)


# -- a run -----------------------------------------------------------------

def timed_window(job, dev, seconds: float):
    """Units (frames or steps) in a closed loop until ``seconds`` have
    passed; each ends in a device sync.  Returns (unit seconds, window
    seconds)."""
    times = []
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        job.unit(i)
        program.sync(dev)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        i += 1
        if t1 - start >= seconds:
            return times, t1 - start


@dataclasses.dataclass
class Recorder:
    """Keeps the arguments of the program's kernel calls while on."""
    on: bool = False

    def __post_init__(self):
        self.calls = {"bvh_walk": [], "sb_intersect": []}

    def wrap(self, name, fn):
        def run(*args, **kw):
            if self.on:
                self.calls[name].append((args, kw))
            return fn(*args, **kw)
        return run


def traced_units(job, job_name: str, dev, port_kernels):
    """``TRACED_UNITS`` units under the profiler after one dropped unit,
    each in a range of its own, the kernels' arguments of the last one
    kept, and (train) the backward's start marked."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from prismarine_core_tpu_torch.accel import packet, traverse
    rec = Recorder()
    saved = (traverse.bvh_walk, packet.sb_intersect, torch.autograd.grad)
    grad = torch.autograd.grad

    def marked_grad(*a, **kw):
        with torch.profiler.record_function(trace.BACKWARD_RANGE):
            return grad(*a, **kw)
    traverse.bvh_walk = rec.wrap("bvh_walk", saved[0])
    packet.sb_intersect = rec.wrap("sb_intersect", saved[1])
    torch.autograd.grad = marked_grad
    try:
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts, acc_events=True,
                     schedule=schedule(wait=0, warmup=1,
                                       active=TRACED_UNITS)) as prof:
            for i in range(TRACED_UNITS + 1):
                rec.on = i == TRACED_UNITS
                with torch.profiler.record_function(trace.UNIT_RANGE):
                    job.unit(i)
                    program.sync(dev)
                prof.step()
    finally:
        traverse.bvh_walk, packet.sb_intersect, torch.autograd.grad = saved
    tr = trace.read_profile(prof, job_name, port_kernels)
    tr.calls = rec.calls
    return tr, TRACED_UNITS + 1


def result_device(dev, chips: int, peak: int, tr=None) -> dict:
    if dev.type != "cuda":
        return {"platform": dev.type}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
           "count": chips, "memory_peak_bytes": peak}
    if tr is not None:
        out["busy_s"] = tr.busy_s
        out["window_s"] = tr.window_s
    return out


def run(cell_name: str, seed: int, seconds: float, traced: bool,
        t_start: float) -> dict:
    """One run of a cell on its card.  Raises NoDevice when the cell's
    cards are not there."""
    cell = load_cell(cell_name)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoDevice(f"{cell_name} needs {chips} CUDA device(s); "
                       f"{torch.cuda.device_count()} available")
    return measure(cell, torch.device("cuda", 0), seed, seconds, traced,
                   t_start)


def measure(cell: Cell, dev, seed: int, seconds: float, traced: bool,
            t_start: float) -> dict:
    """Set-up, the timed window (or the traced units), then the check.
    Returns the result: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
    ``check``, each number compared beside its limit."""
    arrays = scene_arrays(cell)
    prog = build_program(cell, arrays, dev)
    job = job_module(cell).Job(cell, prog, seed)
    job.warmup()
    program.sync(dev)
    gc.collect()
    gc.freeze()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    log(f"{cell.name} seed {seed}: set-up {setup_s:.3f} s")

    tr = None
    if traced:
        port = trace.port_kernel_names(
            Path(sys.modules["prismarine_core_tpu_torch"].__file__).parent
            / "csrc")
        syncs = None
        if hasattr(job, "sync_probe") and dev.type == "cuda":
            probe = job.sync_probe()
            program.sync(dev)
            sources = trace.host_syncs(probe)
            syncs = sum(sources.values())
            log(f"host syncs of one unit by source: {dict(sources)}")
            del probe
            program.sync(dev)
        tr, n = traced_units(job, cell.workload["job"], dev, port)
        tr.host_syncs = syncs
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"], cell.base)(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        times, window_s = timed_window(job, dev, seconds)
        n = len(times)
        values = dict(job.e2e(times, window_s), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    program.sync(dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0
    gc.unfreeze()
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded in the run: {found}")
    failed = job.failed(n)
    t_ref = time.perf_counter()
    log(f"{'traced' if traced else 'window'}: {n} units, "
        f"{t_ref - t_start - setup_s:.3f} s; peak {peak} bytes")

    job.free()
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = job.check(n, arrays, dev)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    limits = cell.workload["check"]["limits"]
    check = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and all(
        math.isfinite(v["value"]) and v["value"] <= v["limit"]
        for v in check.values())
    result = {"correct": correct, "attempted": n, "failed": failed,
              "metrics": metrics,
              "device": result_device(dev, cell.workload["chips"], peak, tr)}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["check"] = check
    return result


def check_lines(result: dict) -> list:
    return [f"check {k} {v['value']!r} limit {v['limit']!r}"
            for k, v in result["check"].items()]


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start)
    except NoDevice as e:
        print(f"bench_port: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"bench_port: modules loaded in the run: {found}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


def run_env(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout for anything the
    program or its libraries compile (the port's own kernels go to
    ``build/torch_kernels/``)."""
    cache = root / "build" / "bench_port_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


if __name__ == "__main__":
    sys.exit(main())
