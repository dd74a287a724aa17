"""The multi-process entry: the port's counterpart of the JAX package's
``__graft_entry__.py:dryrun_multihost``.

Every process initialises ``torch.distributed`` from the environment
(``COORDINATOR_ADDRESS`` = host:port of process 0, ``NUM_PROCESSES``,
``PROCESS_ID``), builds the global mesh over all processes' positions and
runs ``dryrun_multichip``'s work on it: the "pallas_sharded" textured hall
(soup a husk, planes and textures split over "model") and one sharded
train step on the cornell box, each held against the same work on a
one-process mesh of the same shape on its own first position.  Each
process prints one line.  On each of N hosts:

    COORDINATOR_ADDRESS=host0:8476 NUM_PROCESSES=N PROCESS_ID=i \
        python -m prismarine_core_tpu_torch.multihost

or, on one host, one process a card (each sees only its card):

    python -m prismarine_core_tpu_torch.multihost --processes 4

Positions are every CUDA card of the process; ``local_devices`` (for
example ``["cpu"] * 2``) runs elsewhere.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

from prismarine_core_tpu_torch import _build
from prismarine_core_tpu_torch.models.camera import Camera
from prismarine_core_tpu_torch.models.procedural import make_hall_scene
from prismarine_core_tpu_torch.models.scene import make_cornell_scene
from prismarine_core_tpu_torch.ops.sampling import (
    make_coherent_sample_arrays, make_sample_arrays)
from prismarine_core_tpu_torch.parallel import distributed
from prismarine_core_tpu_torch.parallel.mesh import (
    init_params, make_mesh, make_sharded_renderer, make_train_step)
from prismarine_core_tpu_torch.parallel.shard_intersect import (
    distribute_scene)
from prismarine_core_tpu_torch.utils.config import RenderConfig


def dryrun_multihost(local_devices=None, hall_tris: int = 100_000,
                     size: int = 256, bounces: int = 8,
                     texture_resolution: int = 256,
                     train_size: int = 32) -> dict:
    """Initialise from the environment, build the global mesh ("model"
    degree 4, 2 or 1 as the position count divides, as
    ``dryrun_multichip``) and run (1) the textured hall of ``hall_tris``
    target triangles at ``size`` x ``size`` and ``bounces`` bounces
    (``dryrun_multichip`` part 1's shape by default) and (2) one sharded
    train step on the cornell box at ``train_size`` squared and 2 bounces
    (part 2).  Each is run again on a one-process mesh of the same shape,
    every position this process's first: the frame must be bit-identical,
    the loss equal, each parameter within 1e-5 of its largest move (the
    gradient's sums in another order).  Returns this process's numbers
    and prints them on one line."""
    ctx = distributed.init_distributed(local_devices=local_devices)
    n = len(distributed.global_devices()[0])
    mp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    mesh = distributed.global_mesh(n, model_parallel=mp)
    dev = mesh.first
    alone = make_mesh(n, mp, devices=[dev] * n)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    hall = make_hall_scene(target_tris=hall_tris, textured=True,
                           texture_resolution=texture_resolution, device=dev)
    cfg = RenderConfig(width=size, height=size, spp=1, max_bounces=bounces,
                       intersector="pallas_sharded",
                       coherent_bounce_sampling=True)
    cam = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                         fov_y_deg=60.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    samples = make_coherent_sample_arrays(gen, cfg, block=(64, 64))
    frames = {}
    for name, m in (("global", mesh), ("one process", alone)):
        frames[name] = timed(lambda m=m: make_sharded_renderer(
            m, cfg.replace(mesh=m))(distribute_scene(hall, m), cam,
                                    *samples))
    img = frames["global"][0]
    if not bool(torch.isfinite(img).all()) or float(img.std()) <= 0.0:
        raise RuntimeError("degenerate sharded frame")
    if not torch.equal(img, frames["one process"][0]):
        raise RuntimeError("the frame differs from the one-process mesh's")

    tcfg = RenderConfig(width=train_size, height=train_size, spp=1,
                        max_bounces=2, intersector="pallas_sharded",
                        bvh_leaf_size=4)
    tcam = Camera.look_at(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                          fov_y_deg=50.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tsamples = make_sample_arrays(gen, tcfg.n_rays, tcfg.max_bounces)
    steps = {}
    for name, m in (("global", mesh), ("one process", alone)):
        c = tcfg.replace(mesh=m)
        scene = distribute_scene(make_cornell_scene(capacity=64, device=dev),
                                 m, shard_soup=False)
        target = make_sharded_renderer(m, c)(scene, tcam, *tsamples)
        params = init_params(scene)
        steps[name] = timed(lambda: make_train_step(m, c)(
            params, scene, tcam, *tsamples, target + 0.05))
    (new, loss), _ = steps["global"]
    (new1, loss1), _ = steps["one process"]
    if not bool(torch.isfinite(loss)) or float(loss) != float(loss1):
        raise RuntimeError(f"loss {float(loss)} vs one process "
                           f"{float(loss1)}")
    for k, v in new.items():
        move = float((new1[k] - params[k]).abs().max())
        if float((v - new1[k]).abs().max()) > 1e-5 * move:
            raise RuntimeError(f"{k} differs from the one-process step")
    dv0 = float((new["v0"] - params["v0"]).abs().sum())
    out = dict(rank=ctx.rank, processes=ctx.world_size, positions=n,
               mesh=mesh.shape, frame_mean=float(img.mean()),
               loss=float(loss), dv0=dv0,
               frame_s={k: v[1] for k, v in frames.items()},
               step_s={k: v[1] for k, v in steps.items()})
    print(f"dryrun_multihost: process {ctx.rank}/{ctx.world_size} over {n} "
          f"global positions, mesh {mesh.shape}, first position {dev}: "
          f"sharded textured frame {size}x{size}x{bounces}b mean "
          f"{out['frame_mean']:.6f} == one process's, "
          f"{out['frame_s']['global']:.3f} s (one process "
          f"{out['frame_s']['one process']:.3f} s, the first call of each "
          f"included); train step loss {out['loss']:.9g} == one process's, "
          f"|dv0| {dv0:.3g}, {out['step_s']['global']:.3f} s (one process "
          f"{out['step_s']['one process']:.3f} s) ok", flush=True)
    return out


def spawn(n: int, timeout: float = 1800.0) -> int:
    """Run the dry run in ``n`` local processes, process i on card i (each
    sees its card only), rank 0 the coordinator; returns the first
    non-zero exit code (0 when all passed)."""
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} processes need {n} cards, "
                           f"{torch.cuda.device_count()} found")
    _build.build()              # here, so that no two processes compile
    address = f"127.0.0.1:{distributed.free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "prismarine_core_tpu_torch.multihost"],
        env=dict(os.environ, COORDINATOR_ADDRESS=address,
                 NUM_PROCESSES=str(n), PROCESS_ID=str(i),
                 CUDA_VISIBLE_DEVICES=str(i))) for i in range(n)]
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return next((c for c in codes if c), 0) if len(codes) == n else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--processes", type=int, default=0,
                        help="spawn this many local processes, one a card "
                             "(default: this process, from the environment)")
    args = parser.parse_args(argv)
    if args.processes:
        return spawn(args.processes)
    dryrun_multihost()
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
