"""Inverse rendering: recover material albedos from a target image.

The counterpart of ``examples/inverse_rendering.py``, with its defaults:
render the cornell box once as the target, start from gray diffuse
albedos, and recover them by Adam on the image MSE.  The gradient flows
from the pixels through the "bvh" walk's differentiable re-evaluation and
the material lookup into the diffuse table.  ``torch.optim.Adam`` makes
optax.adam's update with the same defaults (b1 0.9, b2 0.999, eps 1e-8).
The sample arrays are fixed, so the objective is deterministic (at low spp
a re-sampled MSE is dominated by Monte-Carlo variance).

    python -m prismarine_core_tpu_torch.examples.inverse_rendering \
        [--steps 60] [--res 48] [--out inverse_result.png] [--cpu]

Exit 0 iff the final albedo L1 error is below 0.15.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from prismarine_core_tpu_torch.examples import NO_DEVICE
from prismarine_core_tpu_torch.models.camera import Camera
from prismarine_core_tpu_torch.models.scene import make_cornell_scene
from prismarine_core_tpu_torch.ops.sampling import make_sample_arrays
from prismarine_core_tpu_torch.render.integrator import render_with_samples
from prismarine_core_tpu_torch.utils.config import RenderConfig
from prismarine_core_tpu_torch.utils.device import resolve_device
from prismarine_core_tpu_torch.utils.image import save_png

LR = 5e-2
#: the final albedo L1 error below which the recovery counts as a success
L1_PASS = 0.15
#: the gray every material's diffuse RGB starts from
INIT_GRAY = 0.5


def setup(res: int, device):
    """(scene, camera, cfg) of the demo at ``res`` x ``res``: the cornell
    box, 2 spp, 2 bounces, RenderConfig's default "bvh" intersector."""
    cfg = RenderConfig(width=res, height=res, spp=2, max_bounces=2)
    camera = Camera.look_at(eye=(0, 0, 3.4), target=(0, 0, 0),
                            fov_y_deg=50, device=device)
    return make_cornell_scene(device=device), camera, cfg


def sample_arrays(cfg: RenderConfig, device, seed: int = 0):
    """The fixed (cam, bounce) uniforms of every step, from one seeded
    generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return make_sample_arrays(gen, cfg.n_rays, cfg.max_bounces,
                              device=device)


def gray_table(diffuse: torch.Tensor) -> torch.Tensor:
    """The starting table: ``diffuse`` with every RGB set to gray (alpha
    kept)."""
    init = diffuse.detach().clone()
    init[:, :3] = INIT_GRAY
    return init


def with_diffuse(scene, diffuse):
    """``scene`` with its material table's diffuse replaced."""
    return dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, diffuse=diffuse))


def albedo_l1(diffuse, true) -> float:
    """Mean absolute error of the diffuse RGB against the true table."""
    return float((diffuse.detach()[:, :3] - true[:, :3]).abs().mean())


def recover_albedo(scene, camera, cfg, cam_samples, bounce_samples, init,
                   steps: int, lr: float = LR, *, target, on_step=None):
    """Adam on the image MSE against ``target``, from the diffuse table
    ``init``, for ``steps`` steps.  ``on_step(i, loss, diffuse)`` runs
    after each update (``loss`` detached; ``diffuse.grad`` is that step's
    gradient).  Returns (f32[steps] losses, each at the parameters before
    its update, the final table)."""
    diffuse = init.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([diffuse], lr=lr)
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        img = render_with_samples(with_diffuse(scene, diffuse), camera, cfg,
                                  cam_samples, bounce_samples)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if on_step is not None:
            on_step(i, losses[-1], diffuse)
    return torch.stack(losses), diffuse.detach()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m prismarine_core_tpu_torch.examples."
             "inverse_rendering", description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--res", type=int, default=48)
    ap.add_argument("--out", default="inverse_result.png",
                    help="the PNG strip (target | recovered)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"{ap.prog}: {e}; for this program, pass --cpu",
              file=sys.stderr)
        return NO_DEVICE

    scene, camera, cfg = setup(args.res, device)
    cam_s, bounce_s = sample_arrays(cfg, device)
    with torch.no_grad():
        target = render_with_samples(scene, camera, cfg, cam_s, bounce_s)
    true = scene.materials.diffuse

    def report(i, loss, diffuse):
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {float(loss):.6f}  "
                  f"albedo L1 {albedo_l1(diffuse, true):.4f}",
                  file=sys.stderr)

    t0 = time.perf_counter()
    _, diffuse = recover_albedo(scene, camera, cfg, cam_s, bounce_s,
                                gray_table(true), args.steps, target=target,
                                on_step=report)
    print(f"optimized {args.steps} steps in "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    with torch.no_grad():
        final = render_with_samples(with_diffuse(scene, diffuse), camera,
                                    cfg, cam_s, bounce_s)
    strip = np.concatenate([target.cpu().numpy(), final.cpu().numpy()],
                           axis=1)
    save_png(args.out, strip)
    print(f"wrote {args.out} (target | recovered)", file=sys.stderr)

    err = albedo_l1(diffuse, true)
    print(f"final albedo L1 error: {err:.4f}", file=sys.stderr)
    return 0 if err < L1_PASS else 1


if __name__ == "__main__":
    sys.exit(main())
