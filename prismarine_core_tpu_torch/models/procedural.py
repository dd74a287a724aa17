"""Procedural benchmark scenes: the colonnaded hall and the HDR sky.

The counterpart of ``prismarine_core_tpu.models.procedural``.  Geometry
and sky are built in numpy from the same seeds and formulas, so the
arrays equal the JAX package's exactly.  The textured hall variant is
ROADMAP queue 1, 'Textures and env NEE'.
"""

from __future__ import annotations

import numpy as np

from prismarine_core_tpu_torch.models.geometry import (
    TriangleSoup, make_box, merge_meshes)
from prismarine_core_tpu_torch.models.lights import SphereLights
from prismarine_core_tpu_torch.models.materials import MaterialTable
from prismarine_core_tpu_torch.models.scene import Scene
from prismarine_core_tpu_torch.models.textures import Environment
from prismarine_core_tpu_torch.utils.device import resolve_device


def _cylinder(center, radius, height, segments, mat_id):
    """Open cylinder shell (2*segments triangles)."""
    cx, cy, cz = center
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([cx + radius * np.cos(ang),
                     np.full(segments, cy),
                     cz + radius * np.sin(ang)], axis=1)
    top = ring + np.array([0, height, 0], np.float32)
    verts = np.concatenate([ring, top]).astype(np.float32)
    faces = []
    for i in range(segments):
        j = (i + 1) % segments
        faces.append([i, segments + i, segments + j])
        faces.append([i, segments + j, j])
    faces = np.asarray(faces, np.int64)
    return verts, faces, np.full(len(faces), mat_id, np.int32)


def _sphere_mesh(center, radius, rows, cols, mat_id):
    """UV sphere (2*rows*cols triangles)."""
    cx, cy, cz = center
    phi = np.linspace(0, np.pi, rows + 1)
    theta = np.linspace(0, 2 * np.pi, cols, endpoint=False)
    pp, tt = np.meshgrid(phi, theta, indexing="ij")
    verts = np.stack([
        cx + radius * np.sin(pp) * np.cos(tt),
        cy + radius * np.cos(pp),
        cz + radius * np.sin(pp) * np.sin(tt),
    ], axis=-1).reshape(-1, 3).astype(np.float32)
    faces = []
    for r in range(rows):
        for c in range(cols):
            c2 = (c + 1) % cols
            a = r * cols + c
            b = r * cols + c2
            d = (r + 1) * cols + c
            e = (r + 1) * cols + c2
            faces.append([a, d, e])
            faces.append([a, e, b])
    faces = np.asarray(faces, np.int64)
    return verts, faces, np.full(len(faces), mat_id, np.int32)


def make_hall_scene(target_tris: int = 100_000, seed: int = 0,
                    capacity: int | None = None, build_bvh: bool = True,
                    textured: bool = False, device=None) -> Scene:
    """Colonnaded hall: floor + walls, two rows of segmented columns,
    sphere clutter — scaled to roughly ``target_tris`` triangles.
    ``device`` None is the CUDA card."""
    if textured:
        raise NotImplementedError(
            "the textured hall is not ported yet (ROADMAP queue 1, "
            "'Textures and env NEE')")
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    parts = []

    hall_l, hall_w, hall_h = 24.0, 10.0, 6.0
    parts.append(make_box((-hall_l / 2, -0.2, -hall_w / 2),
                          (hall_l / 2, 0.0, hall_w / 2), mat_id=0))
    parts.append(make_box((-hall_l / 2, 0.0, -hall_w / 2 - 0.2),
                          (hall_l / 2, hall_h, -hall_w / 2), mat_id=1))
    parts.append(make_box((-hall_l / 2, 0.0, hall_w / 2),
                          (hall_l / 2, hall_h, hall_w / 2 + 0.2),
                          mat_id=1))

    n_cols = 16
    fixed = sum(len(p[1]) for p in parts)
    per_col = max((target_tris - fixed) * 6 // 10 // n_cols, 8)
    segments = max(per_col // 2, 4)
    xs = np.linspace(-hall_l / 2 + 2, hall_l / 2 - 2, n_cols // 2)
    for x in xs:
        for z in (-hall_w / 2 + 1.2, hall_w / 2 - 1.2):
            parts.append(_cylinder((x, 0.0, z), 0.45, hall_h - 1.0,
                                   segments, mat_id=2))
            parts.append(make_box((x - 0.7, hall_h - 1.0, z - 0.7),
                                  (x + 0.7, hall_h - 0.6, z + 0.7),
                                  mat_id=2))

    used = sum(len(p[1]) for p in parts)
    n_spheres = 12
    per_sphere = max((target_tris - used) // max(n_spheres, 1), 8)
    rows = max(int(np.sqrt(per_sphere / 2)), 2)
    for _ in range(n_spheres):
        c = (rng.uniform(-hall_l / 2 + 2, hall_l / 2 - 2),
             rng.uniform(0.4, 1.2),
             rng.uniform(-hall_w / 2 + 1.5, hall_w / 2 - 1.5))
        parts.append(_sphere_mesh(c, rng.uniform(0.3, 0.7), rows,
                                  2 * rows, mat_id=3 + int(rng.integers(3))))

    verts, faces, mids = merge_meshes(parts)
    soup = TriangleSoup.from_arrays(verts, faces, mat_ids=mids,
                                    capacity=capacity, device=device)
    mats = MaterialTable.build([
        {"diffuse": (0.55, 0.5, 0.45), "roughness": 0.6},        # floor
        {"diffuse": (0.6, 0.55, 0.5)},                           # walls
        {"diffuse": (0.7, 0.68, 0.62), "roughness": 0.4},        # columns
        {"diffuse": (0.7, 0.3, 0.25), "roughness": 0.3, "metallic": 0.1},
        {"diffuse": (0.3, 0.5, 0.7), "roughness": 0.2, "metallic": 0.6},
        {"diffuse": (0.8, 0.75, 0.3), "roughness": 0.1, "metallic": 0.9},
    ], device=device)
    return Scene.assemble(
        soup, mats, SphereLights.suns(device=device),
        Environment.constant((0.35, 0.45, 0.65), device=device),
        build_bvh=build_bvh)


def make_sky_environment(resolution: int = 256, sun_dir=(0.5, 0.6, 0.3),
                         turbidity: float = 2.5,
                         device=None) -> Environment:
    """Procedural HDR equirect sky (gradient + sun disc + horizon glow)
    through ``Environment.from_image``."""
    h, w = resolution, 2 * resolution
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    uu, vv = np.meshgrid(u, v)
    theta = np.pi * vv
    phi = 2 * np.pi * (uu - 0.5)
    d = np.stack([np.sin(theta) * np.cos(phi),
                  np.cos(theta),
                  np.sin(theta) * np.sin(phi)], axis=-1)
    sd = np.asarray(sun_dir, np.float64)
    sd = sd / np.linalg.norm(sd)
    cos_sun = np.clip((d * sd).sum(-1), -1, 1)
    elev = np.clip(d[..., 1], -1, 1)

    zenith = np.array([0.25, 0.45, 0.95])
    horizon = np.array([0.9, 0.8, 0.7])
    t = np.clip(elev, 0, 1) ** (1.0 / turbidity)
    sky = horizon[None, None] * (1 - t[..., None]) \
        + zenith[None, None] * t[..., None]
    sky *= np.clip(0.15 + 0.85 * np.clip(elev + 0.1, 0, 1) ** 0.5,
                   0.05, 1.0)[..., None]
    sun = np.exp((cos_sun - 1.0) * 2500.0)[..., None] * \
        np.array([80.0, 72.0, 60.0])
    glow = np.exp((cos_sun - 1.0) * 12.0)[..., None] * \
        np.array([1.2, 1.0, 0.7])
    img = (sky + sun + glow).astype(np.float32)
    return Environment.from_image(img, device=device)
