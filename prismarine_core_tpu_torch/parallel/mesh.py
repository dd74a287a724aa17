"""The inverse-rendering training step, on one card.

The counterpart of ``prismarine_core_tpu.parallel.mesh``'s training half
(``make_train_step``, ``init_params``, ``shared_vertices``,
``init_shared_params``): parameters are the material diffuse table, the
light colours and the vertex positions (per corner, or one shared vertex
buffer); the loss is the MSE of the rendered image against a target; the
step is plain SGD (no optimizer state).  Gradients come from
``torch.autograd`` through the integrator, with every discrete decision
detached as in the JAX package: the packet query runs on detached inputs
and ``_reeval_hit`` re-evaluates each hit from the current geometry.

As in the JAX package, ``intersector="pallas"`` does not rebuild the BVH
or packet set inside the loss: after a vertex step the kernels intersect
the geometry the packet set was built from, and the re-evaluation uses
the new vertices.  Rebuild the scene (``Scene.with_bvh``) between steps
to follow the geometry.

``mesh`` is one device or None.  Sharding over several cards is ROADMAP
queue 1 item 14.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from prismarine_core_tpu_torch.render.integrator import render_with_samples
from prismarine_core_tpu_torch.utils.config import RenderConfig
from prismarine_core_tpu_torch.utils.math import take_rows

_MULTI = "ROADMAP queue 1 item 14, 'Multi-GPU'"


def _check_mesh(mesh) -> None:
    """``mesh``: None, a device (or its name), or a sequence of exactly
    one device; more devices raise."""
    if mesh is None or isinstance(mesh, (str, torch.device)):
        return
    n = len(mesh) if hasattr(mesh, "__len__") else None
    if n != 1:
        raise NotImplementedError(
            f"a mesh of {n} devices: the port's train step runs on one "
            f"card ({_MULTI})")


def apply_params(scene, params, vertex_faces=None):
    """``scene`` with the parameters in place of its diffuse table, light
    colours and vertex positions (``"verts"`` through ``vertex_faces``,
    or per corner ``"v0"`` and optionally ``"v1"``, ``"v2"``)."""
    mats = dataclasses.replace(scene.materials, diffuse=params["mat_diffuse"])
    lights = dataclasses.replace(scene.lights, color=params["light_color"])
    tri = scene.triangles
    if "verts" in params:
        v = params["verts"]
        faces = vertex_faces.long()
        tri = dataclasses.replace(tri, v0=take_rows(v, faces[:, 0]),
                                  v1=take_rows(v, faces[:, 1]),
                                  v2=take_rows(v, faces[:, 2]))
    else:
        tri = dataclasses.replace(tri, v0=params["v0"],
                                  v1=params.get("v1", tri.v1),
                                  v2=params.get("v2", tri.v2))
    return dataclasses.replace(scene, materials=mats, lights=lights,
                               triangles=tri)


def make_train_step(mesh, cfg: RenderConfig, lr: float = 5e-2,
                    shard_triangles: bool = False, lr_scale=None,
                    normalize_grads: bool = False, vertex_faces=None):
    """Inverse-rendering SGD step.  Returns fn(params, scene, camera,
    cam_s, bounce_s, target) -> (params, loss): ``params`` a dict of
    tensors (``init_params`` or ``init_shared_params``), the new params
    detached, ``loss`` a 0-d tensor (the loss before the step).

    ``lr_scale``: per-param multipliers of ``lr`` (vertex positions live
    on another scale than colours).  ``normalize_grads``: divide each
    gradient by its RMS (+1e-8) before the step, so ``lr`` is a distance
    in parameter space.  ``vertex_faces`` (i32[T,3], ``shared_vertices``):
    the shared-vertex parameterization.  ``shard_triangles`` exists for
    the JAX signature; on one card there is nothing to shard."""
    _check_mesh(mesh)
    del shard_triangles
    lr_scale = lr_scale or {}

    def loss_fn(params, scene, camera, cam_s, bounce_s, target):
        scene = apply_params(scene, params, vertex_faces)
        img = render_with_samples(scene, camera, cfg, cam_s, bounce_s)
        return torch.mean((img - target) ** 2)

    @torch.no_grad()
    def update(params, grads):
        """One SGD move of every parameter along its gradient."""
        new = {}
        for k, g in grads.items():
            if normalize_grads:
                g = g / (torch.sqrt(torch.mean(g * g)) + 1e-8)
            new[k] = params[k].detach() - lr * lr_scale.get(k, 1.0) * g
        return new

    def step(params, scene, camera, cam_s, bounce_s, target):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = loss_fn(leaves, scene, camera, cam_s, bounce_s, target)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return update(params, dict(zip(leaves, grads))), loss.detach()

    # the step's two halves, for callers that time or inspect them
    step.loss_fn, step.update = loss_fn, update
    return step


def init_params(scene):
    """Corner-mode parameters: all three vertex fields optimize."""
    return {
        "mat_diffuse": scene.materials.diffuse,
        "light_color": scene.lights.color,
        "v0": scene.triangles.v0,
        "v1": scene.triangles.v1,
        "v2": scene.triangles.v2,
    }


def shared_vertices(soup):
    """Deduplicate the corner soup into (verts f32[V,3], faces i32[T,3]) on
    the soup's device.  Shared vertices are bitwise-equal copies of one
    source vertex, so exact ``np.unique`` recovers the indexed mesh (on
    the host, once, at init)."""
    corners = np.concatenate([soup.v0.detach().cpu().numpy(),
                              soup.v1.detach().cpu().numpy(),
                              soup.v2.detach().cpu().numpy()], axis=0)
    verts, inv = np.unique(corners, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    t = soup.v0.shape[0]
    faces = np.stack([inv[:t], inv[t:2 * t], inv[2 * t:]], axis=1)
    dev = soup.v0.device
    return (torch.as_tensor(verts.astype(np.float32), device=dev),
            torch.as_tensor(faces.astype(np.int32), device=dev))


def init_shared_params(scene, verts):
    return {
        "mat_diffuse": scene.materials.diffuse,
        "light_color": scene.lights.color,
        "verts": verts,
    }
