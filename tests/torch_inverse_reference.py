"""Inverse rendering at the example's defaults under the JAX package and the
port, on the CPU, from the same sample draws: where each run's albedo error
ends, and which material and channel carry it.

The loop is ``examples/inverse_rendering.py:41-73`` (cornell, 48x48, 2 spp,
2 bounces, "bvh", ``optax.adam(5e-2)``, 60 steps) on the JAX side and
``prismarine_core_tpu_torch.examples.inverse_rendering.recover_albedo`` on
the port's.  Each draw of (cam, bounce) uniforms is one of:

- ``--jax-keys K ...``: ``make_sample_arrays(jax.random.key(K))`` (key 0 is
  the JAX script's draw);
- ``--torch-seeds S ...``: the port's ``sample_arrays`` from a CPU
  generator seeded S;
- ``--npz FILE``: arrays ``cam`` and ``bounce`` saved elsewhere
  (``chip_smoke.py`` phase 19a saves the card's draw, a CUDA generator
  seeded 0, as ``build/inverse_samples.npz``).

For each draw and package it prints the albedo L1 every 10 steps and the
per-material, per-channel error (recovered - true) at step 20 and at the
last step; for the port also the first step's gradient.

    JAX_PLATFORMS=cpu python -m tests.torch_inverse_reference \\
        [--jax-keys 0 1] [--torch-seeds 0] [--npz FILE] [--steps 60]
"""

import argparse
import dataclasses

import numpy as np

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
import jax
import jax.numpy as jnp
import optax
import torch

from prismarine_core_tpu.models.camera import Camera as JCamera
from prismarine_core_tpu.models.scene import make_cornell_scene as j_cornell
from prismarine_core_tpu.ops.sampling import make_sample_arrays
from prismarine_core_tpu.render.integrator import (
    render_with_samples as j_render)
from prismarine_core_tpu.utils.config import RenderConfig as JConfig
from prismarine_core_tpu_torch.examples import inverse_rendering as inv
from prismarine_core_tpu_torch.render.integrator import render_with_samples

RES = 48
#: the steps whose error tables are printed (and the last)
TABLE_STEP = 20


def jax_run(cam_s, bounce_s, steps):
    """The JAX script's loop on the given draw: the error table after each
    step."""
    cfg = JConfig(width=RES, height=RES, spp=2, max_bounces=2)
    cam = JCamera.look_at(eye=(0, 0, 3.4), target=(0, 0, 0), fov_y_deg=50)
    scene = j_cornell()
    true = scene.materials.diffuse

    def loss_fn(diffuse, cam_s, bounce_s, target):
        s = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, diffuse=diffuse))
        return jnp.mean((j_render(s, cam, cfg, cam_s, bounce_s)
                         - target) ** 2)

    opt = optax.adam(inv.LR)

    @jax.jit
    def step(diffuse, state, cam_s, bounce_s, target):
        g = jax.grad(loss_fn)(diffuse, cam_s, bounce_s, target)
        updates, state = opt.update(g, state)
        return optax.apply_updates(diffuse, updates), state

    cam_s, bounce_s = jnp.asarray(cam_s), jnp.asarray(bounce_s)
    target = jax.jit(lambda c, b: j_render(scene, cam, cfg, c, b))(
        cam_s, bounce_s)
    diffuse = true.at[:, :3].set(inv.INIT_GRAY)
    state = opt.init(diffuse)
    errs = []
    for _ in range(steps):
        diffuse, state = step(diffuse, state, cam_s, bounce_s, target)
        errs.append(np.asarray(diffuse[:, :3] - true[:, :3]))
    return errs


def port_run(cam_s, bounce_s, steps):
    """``recover_albedo`` on the given draw, on the CPU: (the error table
    after each step, the first step's gradient)."""
    scene, camera, cfg = inv.setup(RES, "cpu")
    cam_s = torch.tensor(np.asarray(cam_s, np.float32))
    bounce_s = torch.tensor(np.asarray(bounce_s, np.float32))
    with torch.no_grad():
        target = render_with_samples(scene, camera, cfg, cam_s, bounce_s)
    true = scene.materials.diffuse
    errs, grads = [], []

    def keep(i, loss, diffuse):
        errs.append((diffuse.detach()[:, :3] - true[:, :3]).numpy().copy())
        grads.append(diffuse.grad[:, :3].numpy().copy())

    inv.recover_albedo(scene, camera, cfg, cam_s, bounce_s,
                       inv.gray_table(true), steps, target=target,
                       on_step=keep)
    return errs, grads[0]


def by_material(table, fmt):
    return "; ".join(f"m{m} " + " ".join(format(v, fmt) for v in row)
                     for m, row in enumerate(table))


def report(label, errs, grad=None):
    steps = len(errs)
    l1 = [float(np.abs(e).mean()) for e in errs]
    marks = sorted({*range(0, steps, 10), steps - 1})
    print(f"{label}: albedo L1 " + " ".join(f"{i}:{l1[i]:.4f}"
                                            for i in marks), flush=True)
    for i in sorted({min(TABLE_STEP, steps - 1), steps - 1}):
        print(f"  step {i} error by material (r g b): "
              f"{by_material(errs[i], '+.4f')}", flush=True)
    if grad is not None:
        print(f"  step 0 gradient by material (r g b): "
              f"{by_material(grad, '+.2e')}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax-keys", type=int, nargs="*", default=[])
    ap.add_argument("--torch-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--npz", action="append", default=[])
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    cfg = inv.setup(RES, "cpu")[2]
    draws = []
    for k in args.jax_keys:
        cam_s, bounce_s = make_sample_arrays(jax.random.key(k), cfg.n_rays,
                                             cfg.max_bounces)
        draws.append((f"jax key {k}", np.asarray(cam_s),
                      np.asarray(bounce_s)))
    for s in args.torch_seeds:
        cam_s, bounce_s = inv.sample_arrays(cfg, torch.device("cpu"), s)
        draws.append((f"torch cpu seed {s}", cam_s.numpy(),
                      bounce_s.numpy()))
    for path in args.npz:
        with np.load(path) as f:
            draws.append((path, f["cam"], f["bounce"]))
    for label, cam_s, bounce_s in draws:
        report(f"[{label}] jax ", jax_run(cam_s, bounce_s, args.steps))
        report(f"[{label}] port", *port_run(cam_s, bounce_s, args.steps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
