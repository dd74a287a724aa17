"""Matched-wall-clock quality A/B: coherent against independent sampling.

The counterpart of ``examples/coherent_quality_ab.py``, its configuration
field for field: 640x360 on the hall at 50,000 target triangles under
RenderConfig's "pallas" defaults (cull "pallas", any-hit "rounds") with
``stale_round_masks`` and ``pairs_per_step=8``.  Coherent bounce sampling
shares each ``block`` x ``block`` pixel block's bounce uniforms, which
makes a frame cheaper and correlates its pixels; whether the extra frames
win at equal wall clock is measured here: render for a fixed budget in
each mode, average the frames, and compare the per-pixel MSE against a
long independent-sampling reference.  The modes draw from different seed
ranges; the seeds and the reference's size follow ``quality`` (its
docstring says where they depart from JAX's).

    python -m prismarine_core_tpu_torch.examples.coherent_quality_ab \
        [budget_s] [n_ref] [block] [--cpu]
"""

from __future__ import annotations

import sys

from prismarine_core_tpu_torch.examples import NO_DEVICE
from prismarine_core_tpu_torch.examples import quality as q
from prismarine_core_tpu_torch.render.integrator import render_with_samples
from prismarine_core_tpu_torch.utils.config import RenderConfig

TAG = "qab"
MODES = ("coherent", "independent")
SEED_RANGES = {"coherent": q.MEASURED, "independent": q.MEASURED + 1}


def config(width: int = q.WIDTH, height: int = q.HEIGHT) -> RenderConfig:
    """The study's RenderConfig (``examples/coherent_quality_ab.py:37-39``)."""
    return RenderConfig(width=width, height=height, spp=1, max_bounces=4,
                        intersector="pallas", bvh_leaf_size=4,
                        pairs_per_step=8, stale_round_masks=True)


def mode_config(cfg: RenderConfig, mode: str) -> RenderConfig:
    return (cfg.replace(coherent_bounce_sampling=True) if mode == "coherent"
            else cfg)


def frame(scene, camera, cfg, mode: str, seed: int, block: int):
    """One frame of ``mode`` from the samples of ``seed``: ``block`` x
    ``block`` coherent bounce rows, or independent ones."""
    c = mode_config(cfg, mode)
    cam_s, bounce_s = q.study_samples(
        c, seed, scene.device, (block, block) if mode == "coherent" else None)
    return render_with_samples(scene, camera, c, cam_s, bounce_s)


def main(argv=None, *, width: int = q.WIDTH, height: int = q.HEIGHT,
         target_tris: int = q.HALL_TRIS) -> int:
    args, device = q.study_args(
        "python -m prismarine_core_tpu_torch.examples.coherent_quality_ab",
        __doc__.splitlines()[0], argv, block=True)
    if device is None:
        return NO_DEVICE
    scene, camera = q.study_scene(target_tris, device)
    cfg = config(width, height)
    print(f"[{TAG}] device={q.device_name(device)} budget={args.budget_s}s "
          f"ref_frames={args.n_ref or 'auto'} block={args.block}",
          flush=True)
    result = q.run_study(
        {mode: (lambda seed, mode=mode: frame(scene, camera, cfg, mode, seed,
                                              args.block))
         for mode in MODES},
        SEED_RANGES, "independent", MODES, args.budget_s, args.n_ref)
    result["block"] = args.block
    q.print_reference(TAG, result)
    for mode, m in result["modes"].items():
        print(f"[{TAG}] {mode:12s}: {m['frames']} frames in "
              f"{args.budget_s:.0f}s, MSE vs ref = {m['mse']:.3e} "
              f"{q.ref_term(result)} ({m['ms_per_frame']:.2f} ms/frame)",
              flush=True)
    q.print_result(TAG, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
