"""The cases of tests/test_torch_multihost.py (no jax): the frames and the
train step that its worker processes run on meshes over two processes,
and the test on one process's mesh of the same shape (chip_smoke.py's
phase 17b runs the frames on the card).  Inputs are numpy arrays made
from a seed (``make_inputs``); ``device`` is where the scene is built
(the mesh's first position)."""

import numpy as np
import torch

from prismarine_core_tpu_torch.models.camera import Camera
from prismarine_core_tpu_torch.models.procedural import make_hall_scene
from prismarine_core_tpu_torch.models.scene import make_cornell_scene
from prismarine_core_tpu_torch.parallel.mesh import (
    init_params, make_sharded_renderer, make_train_step, shard_scene)
from prismarine_core_tpu_torch.parallel.shard_intersect import (
    distribute_scene)
from prismarine_core_tpu_torch.utils.config import RenderConfig

CPU = "cpu"
#: the global positions (process-major: 0, 1 of rank 0, 2, 3 of rank 1)
#: reordered so that each data row of a 2 x 2 mesh holds one position of
#: each process: the "model" axis crosses the processes
CROSSING = (0, 2, 1, 3)
#: tests/test_multihost.py's frames: the brute cornell box and the
#: textured hall (1,500 target triangles, 32^2 textures)
FRAME = dict(width=16, height=16, spp=1, max_bounces=2)
STEP_KW = dict(lr=0.05, lr_scale={"v0": 0.01, "v1": 0.01, "v2": 0.01})


def make_inputs(seed: int = 0) -> dict:
    """The frames' sample arrays (cam f32[R, 4], bounce f32[B, R, 11])."""
    rng = np.random.default_rng(seed)
    n = FRAME["width"] * FRAME["height"] * FRAME["spp"]
    return {"cam_s": rng.random((n, 4), dtype=np.float32),
            "bounce_s": rng.random((FRAME["max_bounces"], n, 11),
                                   dtype=np.float32)}


def _samples(inputs, device):
    return (torch.tensor(inputs["cam_s"], device=device),
            torch.tensor(inputs["bounce_s"], device=device))


def _cornell_cam(device):
    return Camera.look_at(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                          fov_y_deg=50.0, device=device)


def brute_frame(mesh, inputs, device=CPU):
    """The brute cornell box (capacity 64) with the rays over "data"."""
    cfg = RenderConfig(**FRAME, intersector="brute", tri_block=16)
    scene = shard_scene(make_cornell_scene(capacity=64, device=device), mesh)
    return make_sharded_renderer(mesh, cfg)(scene, _cornell_cam(device),
                                            *_samples(inputs, device))


def hall_frame(mesh, inputs, device=CPU):
    """The textured hall under "pallas_sharded": superblocks and textures
    split over "model", the soup a husk."""
    hall = make_hall_scene(target_tris=1500, textured=True,
                           texture_resolution=32, device=device)
    cfg = RenderConfig(**FRAME, intersector="pallas_sharded", mesh=mesh)
    cam = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                         fov_y_deg=60.0, device=device)
    return make_sharded_renderer(mesh, cfg)(distribute_scene(hall, mesh),
                                            cam, *_samples(inputs, device))


def train_step(mesh, inputs, device=CPU):
    """One "pallas_sharded" step on the cornell box (the BVH and the
    sharded packets rebuilt inside the loss) from the diffuse table
    halved toward the frame of the original scene: (start, params,
    loss)."""
    cfg = RenderConfig(**FRAME, intersector="pallas_sharded", mesh=mesh)
    scene = distribute_scene(make_cornell_scene(capacity=64, device=device),
                             mesh, shard_soup=False)
    cam, samples = _cornell_cam(device), _samples(inputs, device)
    target = make_sharded_renderer(mesh, cfg)(scene, cam, *samples)
    start = dict(init_params(scene))
    start["mat_diffuse"] = start["mat_diffuse"].clone()
    start["mat_diffuse"][:, :3] *= 0.5
    params, loss = make_train_step(mesh, cfg, **STEP_KW)(
        start, scene, cam, *samples, target)
    return start, params, loss
