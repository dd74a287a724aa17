"""Full rebuild against topology-reusing refit, at bench scale.

The counterpart of ``examples/r5_refit_bench.py``: times ``build_bvh``
(Morton sort, topology, escape links, fix-point AABBs) against
``refit_bvh`` (leaf and fix-point AABB re-union over the frozen topology)
and ``build_packet_set`` on the hall's soup (~100k target triangles),
under both of the port's topologies: "karras" (the default, the JAX
package's only one) and "median".  This cost bounds an animated frame and
the in-loss rebuild of a "pallas_sharded" train step.

    python -m prismarine_core_tpu_torch.examples.r5_refit_bench \
        [n_tris] [--cpu]

Each call is timed by ``utils/profiling.time_fn``: after one warm call,
the mean of 5 calls, each between two CUDA events and followed by one
synchronize (on the CPU, the host clock).  The last line is the times as
JSON.
"""

from __future__ import annotations

import argparse
import json
import sys

from prismarine_core_tpu_torch.accel.lbvh import build_bvh, refit_bvh
from prismarine_core_tpu_torch.accel.packet import build_packet_set
from prismarine_core_tpu_torch.examples import NO_DEVICE
from prismarine_core_tpu_torch.models.procedural import make_hall_scene
from prismarine_core_tpu_torch.utils.device import resolve_device
from prismarine_core_tpu_torch.utils.profiling import time_fn

TOPOLOGIES = ("karras", "median")
REPS = 5
LEAF_SIZE = 4


def bench(soup, topology: str) -> dict:
    """The three calls' mean ms on ``soup`` under ``topology``
    (``time_fn``: a warm call, then REPS timed ones), printed as the
    JAX script prints them."""
    def build():
        return build_bvh(soup, leaf_size=LEAF_SIZE, topology=topology)
    bvh = build()
    times = {key: 1e3 * time_fn(fn, iters=REPS) for key, fn in (
        ("build_bvh_ms", build),
        ("refit_bvh_ms", lambda: refit_bvh(bvh, soup)),
        ("build_packet_set_ms", lambda: build_packet_set(bvh)))}
    for label, key in (("full build_bvh (sort+topology+AABBs)",
                        "build_bvh_ms"),
                       ("refit_bvh (frozen topology)", "refit_bvh_ms"),
                       ("build_packet_set (planes + block AABBs)",
                        "build_packet_set_ms")):
        print(f"  {label:<46s} {times[key]:9.2f} ms", flush=True)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m prismarine_core_tpu_torch.examples.r5_refit_bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("n_tris", type=int, nargs="?", default=100_000,
                    help="the hall's target triangle count")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"{ap.prog}: {e}; for this program, pass --cpu",
              file=sys.stderr)
        return NO_DEVICE

    soup = make_hall_scene(target_tris=args.n_tris, build_bvh=False,
                           device=device).triangles
    result = {"tris": int(soup.num_valid()), "device": str(device)}
    print(f"tris={result['tris']}", flush=True)
    for topology in TOPOLOGIES:
        print(f"topology={topology}", flush=True)
        result[topology] = bench(soup, topology)
    print(f"[refit] result {json.dumps(result)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
