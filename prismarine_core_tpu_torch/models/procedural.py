"""Procedural benchmark scenes: the colonnaded hall, the teapot and the
HDR sky.

The counterpart of ``prismarine_core_tpu.models.procedural``.  Geometry,
textures and sky are built in numpy from the same seeds, formulas and
draw order, so the arrays equal the JAX package's exactly.
"""

from __future__ import annotations

import numpy as np

from prismarine_core_tpu_torch.models.geometry import (
    TriangleSoup, make_box, merge_meshes)
from prismarine_core_tpu_torch.models.lights import SphereLights
from prismarine_core_tpu_torch.models.materials import MaterialTable
from prismarine_core_tpu_torch.models.scene import Scene
from prismarine_core_tpu_torch.models.textures import (
    Environment, TextureStack)
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


def _procedural_textures(resolution: int = 512, seed: int = 7):
    """Deterministic diffuse + bump texture set of the textured hall
    (value-noise octaves, numpy): [checker floor, wall stone, column
    marble, tangent-space normal map]."""
    rng = np.random.default_rng(seed)
    n = resolution

    def fbm(octaves=5, base=8):
        acc = np.zeros((n, n))
        amp = 1.0
        for o in range(octaves):
            cells = base * (2 ** o)
            g = rng.standard_normal((cells + 1, cells + 1))
            g[-1, :] = g[0, :]
            g[:, -1] = g[:, 0]                   # tileable
            yy = np.linspace(0, cells, n, endpoint=False)
            y0 = yy.astype(int)
            fy = (yy - y0)[:, None]
            fx = (yy - y0)[None, :]
            a = g[np.ix_(y0, y0)]
            b = g[np.ix_(y0, y0 + 1)]
            c = g[np.ix_(y0 + 1, y0)]
            d = g[np.ix_(y0 + 1, y0 + 1)]
            acc += amp * ((a * (1 - fx) + b * fx) * (1 - fy)
                          + (c * (1 - fx) + d * fx) * fy)
            amp *= 0.5
        acc -= acc.min()
        return acc / max(acc.max(), 1e-6)

    y = np.arange(n)
    checker = ((y[:, None] // (n // 8) + y[None, :] // (n // 8)) % 2
               ).astype(np.float64)
    floor = (0.35 + 0.3 * checker + 0.2 * fbm())[..., None] \
        * np.array([1.0, 0.93, 0.82])
    wall = (0.45 + 0.4 * fbm(base=4))[..., None] \
        * np.array([0.95, 0.9, 0.85])
    marble = (0.5 + 0.45 * np.abs(
        np.sin(6.0 * np.pi * (y[None, :] / n + 0.6 * fbm(base=2)))
    ))[..., None] * np.array([0.9, 0.88, 0.85])

    height = fbm(base=6)
    dhdx = np.roll(height, -1, 1) - np.roll(height, 1, 1)
    dhdy = np.roll(height, -1, 0) - np.roll(height, 1, 0)
    nrm = np.stack([-dhdx * 4.0, -dhdy * 4.0, np.ones_like(height)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    bump = nrm * 0.5 + 0.5
    return [floor.astype(np.float32), wall.astype(np.float32),
            marble.astype(np.float32), bump.astype(np.float32)]


def make_hall_scene(target_tris: int = 100_000, seed: int = 0,
                    capacity: int | None = None, build_bvh: bool = True,
                    textured: bool = False, texture_resolution: int = 512,
                    pack_corners: bool = True, device=None) -> Scene:
    """Colonnaded hall: floor + walls, two rows of segmented columns,
    sphere clutter — scaled to roughly ``target_tris`` triangles.

    ``textured=True`` adds procedural diffuse and tangent-space bump
    textures (``texture_resolution`` square, corner-packed unless
    ``pack_corners`` is False) on floor, walls and columns, with oblique
    planar UVs.  ``device`` None is the CUDA card."""
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
    texcoords = None
    if textured:
        # oblique planar projection: non-degenerate uv derivatives on
        # every wall, floor and column orientation from one map
        texcoords = np.stack(
            [0.25 * (verts[:, 0] + 0.3 * verts[:, 2]),
             0.25 * (verts[:, 1] + 0.7 * verts[:, 2])],
            axis=1).astype(np.float32)
    soup = TriangleSoup.from_arrays(verts, faces, mat_ids=mids,
                                    texcoords=texcoords, capacity=capacity,
                                    device=device)
    bump = {"tex_bump": 3} if textured else {}

    def tex(i):
        return {"tex_diffuse": i, **bump} if textured else {}

    mats = MaterialTable.build([
        {"diffuse": (0.55, 0.5, 0.45), "roughness": 0.6, **tex(0)},  # floor
        {"diffuse": (0.6, 0.55, 0.5), **tex(1)},                     # walls
        {"diffuse": (0.7, 0.68, 0.62), "roughness": 0.4, **tex(2)},  # columns
        {"diffuse": (0.7, 0.3, 0.25), "roughness": 0.3, "metallic": 0.1},
        {"diffuse": (0.3, 0.5, 0.7), "roughness": 0.2, "metallic": 0.6},
        {"diffuse": (0.8, 0.75, 0.3), "roughness": 0.1, "metallic": 0.9},
    ], device=device)
    textures = None
    if textured:
        textures = TextureStack.from_images(
            _procedural_textures(texture_resolution),
            resolution=texture_resolution, device=device)
        if pack_corners:
            textures = textures.with_packed_corners()
    return Scene.assemble(
        soup, mats, SphereLights.suns(device=device),
        Environment.constant((0.35, 0.45, 0.65), device=device),
        textures=textures, build_bvh=build_bvh)


def make_teapot_scene(capacity: int | None = None, build_bvh: bool = True,
                      device=None) -> Scene:
    """Teapot-class single object on a ground plane: a surface of
    revolution body, lid knob, spout and handle (3,516 triangles) under
    the procedural sky.  ``device`` None is the CUDA card."""
    device = resolve_device(device)
    parts = []
    prof_t = np.linspace(0.0, 1.0, 24)
    radius = (0.45 + 1.45 * np.sin(np.pi * prof_t ** 0.8)
              * (1.0 - 0.35 * prof_t))
    height = 2.2 * prof_t
    segs = 64
    ang = np.linspace(0, 2 * np.pi, segs, endpoint=False)
    rings = [np.stack([r * np.cos(ang), np.full(segs, h),
                       r * np.sin(ang)], axis=1)
             for r, h in zip(radius, height)]
    verts = np.concatenate(rings).astype(np.float32)
    faces = []
    for i in range(len(rings) - 1):
        for c in range(segs):
            c2 = (c + 1) % segs
            a, b = i * segs + c, i * segs + c2
            d, e = (i + 1) * segs + c, (i + 1) * segs + c2
            faces.append([a, d, e])
            faces.append([a, e, b])
    parts.append((verts, np.asarray(faces, np.int64),
                  np.full(len(faces), 0, np.int32)))
    parts.append(_sphere_mesh((0.0, 2.35, 0.0), 0.22, 8, 16, 0))  # lid knob
    for k in range(6):                                             # spout
        t = k / 6.0
        parts.append(_cylinder((1.5 + 0.9 * t, 0.7 + 1.0 * t, 0.0),
                               0.16 - 0.08 * t, 0.25, 12, 0))
    for k in range(8):                                             # handle
        a = np.pi * (0.25 + 0.5 * k / 8.0)
        parts.append(_cylinder((-1.35 - 0.55 * np.sin(a),
                                1.15 + 0.75 * np.cos(a), 0.0),
                               0.1, 0.22, 10, 0))
    parts.append(make_box((-8, -0.2, -8), (8, 0.0, 8), mat_id=1))  # ground

    verts, faces, mids = merge_meshes(parts)
    soup = TriangleSoup.from_arrays(verts, faces, mat_ids=mids,
                                    capacity=capacity, device=device)
    mats = MaterialTable.build([
        {"diffuse": (0.75, 0.71, 0.68), "roughness": 0.15,
         "metallic": 0.7},
        {"diffuse": (0.5, 0.5, 0.52), "roughness": 0.7},
    ], device=device)
    return Scene.assemble(
        soup, mats, SphereLights.suns(device=device),
        make_sky_environment(resolution=128, device=device),
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
