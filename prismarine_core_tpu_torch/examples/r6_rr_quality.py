"""Matched-wall-clock quality A/B: Russian roulette against fixed 4 bounces.

The counterpart of ``examples/r6_rr_quality.py``, its configuration field
for field: bench.py's main configuration at 640x360 on the hall at 50,000
target triangles, 64x64 coherent bounce samples, with ``rr_start_bounce``
0 ("rr-off") and 2 ("rr-2").  RR cuts the deep bounces' live lanes at the
cost of termination variance (the 1/q reweighting); the honest basis for
the knob is time-to-quality: render for a fixed budget in each mode,
average the frames, and compare the per-pixel MSE against a long RR-free
reference.  Both modes render frame n from the same seed (common random
numbers sharpen the comparison); the seeds and the reference's size
follow ``quality`` (its docstring says where they depart from JAX's).

    python -m prismarine_core_tpu_torch.examples.r6_rr_quality \
        [budget_s] [n_ref] [--cpu]
"""

from __future__ import annotations

import sys

from prismarine_core_tpu_torch.examples import NO_DEVICE
from prismarine_core_tpu_torch.examples import quality as q
from prismarine_core_tpu_torch.render.integrator import render_with_samples
from prismarine_core_tpu_torch.utils.config import RenderConfig

TAG = "rrq"
#: the coherent bounce samples' pixel block
BLOCK = (64, 64)
#: both modes draw their measured frames from one seed range
SEED_RANGES = {"rr-off": q.MEASURED, "rr-2": q.MEASURED}


def configs(width: int = q.WIDTH, height: int = q.HEIGHT) -> dict:
    """The two modes' RenderConfigs (``examples/r6_rr_quality.py:33-40``)."""
    base = RenderConfig(width=width, height=height, spp=1, max_bounces=4,
                        intersector="pallas", bvh_leaf_size=4,
                        coherent_bounce_sampling=True,
                        pairs_per_step=8, stale_round_masks=True,
                        anyhit_strategy="single", cull_impl="pallas2",
                        closest_k=16, cull_window=8192, cull_pps=16)
    return {"rr-off": base, "rr-2": base.replace(rr_start_bounce=2)}


def frame(scene, camera, cfg, seed: int):
    """One frame of ``cfg`` from the coherent samples of ``seed``."""
    cam_s, bounce_s = q.study_samples(cfg, seed, scene.device, BLOCK)
    return render_with_samples(scene, camera, cfg, cam_s, bounce_s)


def main(argv=None, *, width: int = q.WIDTH, height: int = q.HEIGHT,
         target_tris: int = q.HALL_TRIS) -> int:
    args, device = q.study_args(
        "python -m prismarine_core_tpu_torch.examples.r6_rr_quality",
        __doc__.splitlines()[0], argv)
    if device is None:
        return NO_DEVICE
    scene, camera = q.study_scene(target_tris, device)
    modes = configs(width, height)
    print(f"[{TAG}] device={q.device_name(device)} budget={args.budget_s}s "
          f"ref_frames={args.n_ref or 'auto'}", flush=True)
    result = q.run_study(
        {name: (lambda seed, c=c: frame(scene, camera, c, seed))
         for name, c in modes.items()},
        SEED_RANGES, "rr-off", ("rr-2", "rr-off"), args.budget_s,
        args.n_ref)
    q.print_reference(TAG, result)
    for name, m in result["modes"].items():
        print(f"[{TAG}] {name:8s} frames={m['frames']:3d} "
              f"mean={m['mean']:.5f} MSE={m['mse']:.3e} {q.ref_term(result)} "
              f"({m['ms_per_frame']:.2f} ms/frame)", flush=True)
    q.print_result(TAG, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
