"""The small scenes of tests/test_edge_gradients.py in the port, and their
finite-difference checks of ``render_with_edge_gradients``.

Imports no jax: ``tests/test_torch_edge_grad.py`` runs these cases on the
CPU with the JAX tests' own sample arrays, ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` on the card with arrays drawn from a seeded CPU
``torch.Generator`` (``torch_samples``).

Each case moves one vertex coordinate (or a whole triangle) by ``theta``
and compares autograd's d loss / d theta at 0 (the loss ``sum(img * W)``,
W a ramp from 0.5 to 1.5) with the central difference of the primal
render at +-eps (the loss summed in float32, as the JAX tests sum it),
under the JAX test's bound
``|g - fd| < rel * |fd| + abs``, after checking ``|fd| > min_fd`` (the
scene really moves radiance).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from prismarine_core_tpu_torch.models.camera import Camera
from prismarine_core_tpu_torch.models.geometry import TriangleSoup
from prismarine_core_tpu_torch.models.lights import SphereLights
from prismarine_core_tpu_torch.models.materials import MaterialTable
from prismarine_core_tpu_torch.models.scene import Scene
from prismarine_core_tpu_torch.models.textures import Environment
from prismarine_core_tpu_torch.ops.sampling import make_sample_arrays
from prismarine_core_tpu_torch.render.edge_grad import (
    env_sun_params, make_edge_sample_arrays, render_with_edge_gradients)
from prismarine_core_tpu_torch.render.integrator import render_with_samples
from prismarine_core_tpu_torch.utils.config import RenderConfig

#: the silhouette cases' camera
FRONT = dict(eye=(0.0, 0.0, 3.0), target=(0.0, 0.0, 0.0), fov_y_deg=45.0)
#: the shadow cases' camera: looking down at the ground from y = 1
DOWN = dict(eye=(0.0, 1.0, 0.0), target=(0.0, 0.0, 0.0),
            up=(0.0, 0.0, -1.0), fov_y_deg=40.0)
_BLACK = dict(diffuse=(0.0, 0.0, 0.0))


@dataclasses.dataclass(frozen=True)
class Case:
    """One FD case: the config knobs, the camera, the edge-sample count,
    the soup entries ``theta`` moves ((field, triangle, axis) triples),
    eps, the bound ``rel * |fd| + abs_`` and the least |fd|."""
    cfg: dict
    camera: dict
    n_edge: int
    moves: tuple
    eps: float
    rel: float
    abs_: float
    min_fd: float
    shadow_term: bool = False
    light_u: bool = False


_SIL = dict(width=32, height=32, spp=64, max_bounces=1, intersector="bvh")
_SHADOW = dict(width=32, height=32, spp=32, max_bounces=2,
               intersector="brute", tri_block=16, direct_light=True)
_BLOCKER = tuple((f, 2, 0) for f in ("v0", "v1", "v2"))

CASES = {
    # tests/test_edge_gradients.py:78-113, coord (vertex, axis)
    "sweep_v0_x": Case(_SIL, FRONT, 4096, (("v0", 0, 0),), 5e-2, 0.15,
                       1e-2, 1e-2),
    "sweep_v2_y": Case(_SIL, FRONT, 4096, (("v2", 0, 1),), 5e-2, 0.15,
                       1e-2, 1e-2),
    # :116-162, vertex 1 of the quad is tri0.v1 and tri1.v0
    "shared_edge": Case(_SIL, FRONT, 4096, (("v1", 0, 0), ("v0", 1, 0)),
                        5e-2, 0.2, 1e-2, 1e-2),
    # :165-192: the rigid translation, rendered without boundary terms
    "rigid_detached": Case(dict(_SIL, spp=16), FRONT, 0,
                           (("v0", 0, 0), ("v1", 0, 0), ("v2", 0, 0)),
                           5e-2, 0.0, 0.0, 1e-2),
    # :233-298
    "cast_shadow": Case(_SHADOW, DOWN, 4096, _BLOCKER, 4e-2, 0.25, 5e-2,
                        5e-2, shadow_term=True),
    # :380-441
    "fat_light": Case(_SHADOW, DOWN, 4096, _BLOCKER, 6e-2, 0.4, 5e-2, 5e-2,
                      shadow_term=True, light_u=True),
    # :444-504
    "two_lights": Case(_SHADOW, DOWN, 4096, _BLOCKER, 4e-2, 0.3, 5e-2, 5e-2,
                       shadow_term=True),
    # :301-377
    "env_sun": Case(dict(_SHADOW, direct_light=False, env_nee=True), DOWN,
                    16384, _BLOCKER, 4e-2, 0.3, 5e-2, 5e-2,
                    shadow_term=True),
}
#: the cases of the boundary-gradient FD checks on the card
CARD_CASES = ("sweep_v0_x", "sweep_v2_y", "shared_edge", "cast_shadow",
              "fat_light", "two_lights")


def _assemble(verts, faces, mat_ids, mats, lights, env, device):
    soup = TriangleSoup.from_arrays(np.asarray(verts, np.float32),
                                    np.asarray(faces, np.int32),
                                    mat_ids=np.asarray(mat_ids, np.int32),
                                    device=device)
    return Scene.assemble(soup, MaterialTable.build(mats, device=device),
                          lights, env, build_bvh=False)


def tri_scene(device, dx=0.0):
    """One emissive triangle on a black environment: radiance is an
    indicator of primary visibility, so the whole vertex gradient is the
    boundary term."""
    verts = [[-0.6 + dx, -0.5, 0.0], [0.7 + dx, -0.4, 0.0],
             [0.0 + dx, 0.6, 0.0]]
    return _assemble(verts, [[0, 1, 2]], [0],
                     [dict(_BLACK, emissive=(2.0, 1.0, 0.5))],
                     SphereLights.single((0.0, 5.0, 5.0), 0.1, (0, 0, 0),
                                         device=device),
                     Environment.constant((0, 0, 0), device=device), device)


def quad_scene(device):
    """Two triangles of a quad, one emissive and one black: the shared
    diagonal is a radiance discontinuity that appears twice in the edge
    list."""
    verts = [[-0.7, -0.7, 0.0], [0.7, -0.7, 0.0], [-0.7, 0.7, 0.0],
             [0.7, 0.7, 0.0]]
    return _assemble(verts, [[0, 1, 2], [1, 3, 2]], [0, 1],
                     [dict(_BLACK, emissive=(2.0, 1.0, 0.5)),
                      dict(_BLACK, emissive=(0.0, 0.0, 0.0))],
                     SphereLights.single((0.0, 5.0, 5.0), 0.1, (0, 0, 0),
                                         device=device),
                     Environment.constant((0, 0, 0), device=device), device)


def sun_sky():
    """The env-sun case's HDR sky: 0.05 everywhere, a 2x2-texel sun of
    12,000 near theta = 30 degrees, phi = 0."""
    sky = np.full((192, 384, 3), 0.05, np.float32)
    sky[31:33, 191:193] = 12000.0
    return sky


def shadow_scene(name, device):
    """A diffuse ground plane (normals +y) and one black blocker triangle
    above the camera, out of frame, between the light and the ground."""
    half = 4.0 if name == "env_sun" else 9.0
    ground = [[-half, 0, -half], [half, 0, -half], [half, 0, half],
              [-half, 0, half]]
    env = Environment.constant((0, 0, 0), device=device)
    lights = SphereLights.single((0.0, 8.0, 0.0),
                                 0.45 if name == "fat_light" else 0.15,
                                 (150.0, 150.0, 150.0), device=device)
    blocker = np.array([[-0.55, 2.0, -0.3], [0.25, 2.0, 0.45],
                        [-0.15, 2.0, -0.55]], np.float32)
    if name == "two_lights":
        lights = SphereLights(
            center=torch.tensor([[2.0, 8.0, 0.0], [-2.0, 8.0, 0.5]],
                                device=device),
            radius=torch.tensor([0.15, 0.15], device=device),
            color=torch.tensor([[150.0, 150.0, 150.0],
                                [120.0, 120.0, 150.0]], device=device))
    elif name == "env_sun":
        env = Environment.from_image(sun_sky(), device=device)
        lights = SphereLights.single((0.0, 50.0, 0.0), 0.1, (0, 0, 0),
                                     device=device)
        # 1.8 units toward the sun from the origin
        bc = 1.8 * env_sun_params(env)[0].cpu().numpy()
        blocker = (bc + np.array([[-0.45, 0, -0.25], [0.35, 0, 0.4],
                                  [-0.05, 0, -0.5]], np.float32)
                   ).astype(np.float32)
    return _assemble(np.concatenate([ground, blocker]),
                     [[0, 2, 1], [0, 3, 2], [4, 5, 6]], [0, 0, 1],
                     [dict(diffuse=(0.75, 0.75, 0.75)), _BLACK],
                     lights, env, device)


def base_scene(name, device):
    if name.startswith("sweep") or name == "rigid_detached":
        return tri_scene(device)
    if name == "shared_edge":
        return quad_scene(device)
    return shadow_scene(name, device)


def case_config(name, intersector=None) -> RenderConfig:
    kw = dict(CASES[name].cfg)
    if intersector:
        kw["intersector"] = intersector
    return RenderConfig(**kw)


def weights(cfg, device):
    return torch.linspace(0.5, 1.5, cfg.n_pixels * 3,
                          device=device).reshape(cfg.height, cfg.width, 3)


def moved(base, theta, moves, cfg):
    """``base`` with ``theta`` added to the soup entries of ``moves``
    (differentiable in theta), its BVH rebuilt under "bvh" and
    "pallas"."""
    soup = base.triangles
    fields = {}
    for f, tri, axis in moves:
        x = fields.get(f, getattr(soup, f))
        mask = torch.zeros_like(x)
        mask[tri, axis] = 1.0
        fields[f] = x + theta * mask
    scene = dataclasses.replace(
        base, triangles=dataclasses.replace(soup, **fields))
    if cfg.intersector == "brute":
        return scene
    frozen = dataclasses.replace(scene, triangles=dataclasses.replace(
        scene.triangles, **{f: x.detach() for f, x in fields.items()}))
    built = frozen.with_bvh()
    return dataclasses.replace(built, triangles=scene.triangles)


def fd_check(name, samples, intersector=None, edge_terms=True):
    """(g, fd) of case ``name``: autograd's d loss / d theta at 0 and the
    central difference at +-eps.  ``samples``: (cam, bounce, edge_u,
    edge_bounce, light_u or None) on the device to run on.
    ``edge_terms=False`` renders without the boundary terms (the detached
    estimator alone)."""
    case = CASES[name]
    cam_s, bounce_s, eu, ebs, light_u = samples
    dev = cam_s.device
    cfg = case_config(name, intersector)
    cam = Camera.look_at(**case.camera, device=dev)
    base = base_scene(name, dev)
    w = weights(cfg, dev)

    def loss(theta):
        scene = moved(base, theta, case.moves, cfg)
        if not edge_terms:
            return (render_with_samples(scene, cam, cfg, cam_s,
                                        bounce_s) * w).sum()
        img = render_with_edge_gradients(
            scene, cam, cfg, cam_s, bounce_s, eu, ebs,
            shadow_term=case.shadow_term, light_u=light_u)
        return (img * w).sum()

    theta = torch.zeros((), device=dev, requires_grad=True)
    (g,) = torch.autograd.grad(loss(theta), theta)
    with torch.no_grad():
        lp = float(loss(torch.tensor(case.eps, device=dev)).double())
        lm = float(loss(torch.tensor(-case.eps, device=dev)).double())
    return float(g), (lp - lm) / (2 * case.eps)


def within(name, g, fd) -> bool:
    """The JAX test's bound on (g, fd)."""
    case = CASES[name]
    return abs(g - fd) < case.rel * abs(fd) + case.abs_


def cos_rel(a, b):
    """(cosine, relative L2 of ``a`` against ``b``) over the tensors of the
    sequences ``a`` and ``b``, each concatenated, in float64."""
    a = torch.cat([x.reshape(-1) for x in a]).double()
    b = torch.cat([x.reshape(-1) for x in b]).double()
    return (float(torch.dot(a, b) / (a.norm() * b.norm() + 1e-300)),
            float((a - b).norm() / (b.norm() + 1e-300)))


def torch_samples(name, seed, device):
    """The case's sample arrays drawn from a CPU ``torch.Generator`` seeded
    with ``seed`` (so the card and the CPU get the same numbers), moved to
    ``device``: (cam, bounce, edge_u, edge_bounce, light_u or None)."""
    case = CASES[name]
    cfg = case_config(name)
    g = torch.Generator().manual_seed(seed)
    cam_s, bounce_s = make_sample_arrays(g, cfg.n_rays, cfg.max_bounces)
    eu, ebs = make_edge_sample_arrays(g, case.n_edge, cfg.max_bounces)
    light_u = (torch.rand((case.n_edge, 2), generator=g) if case.light_u
               else None)
    return tuple(None if x is None else x.to(device)
                 for x in (cam_s, bounce_s, eu, ebs, light_u))
