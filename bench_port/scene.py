"""The benchmark's frozen scene inputs: the colonnaded hall, its materials,
the sun and the procedural HDR sky, as plain numpy arrays.

A frozen copy of the port's scene generator
(``prismarine_core_tpu_torch/models/procedural.py:make_hall_scene``,
``make_sky_environment``, ``models/geometry.py:make_box``,
``merge_meshes`` and ``models/lights.py:SphereLights.suns``): the same
seeds, formulas and draw order, so the arrays are equal to the port's
(``tests/test_bench_port_inputs.py``), but a later change to the port's
generator cannot move the benchmark's inputs.  Nothing here imports the
port or torch.  A generator of ``scenes/`` puts these parts together into
a configuration's arrays; the harness hands them to the port's
constructors, and the plain reference builds its own scene from them.
"""

from __future__ import annotations

import numpy as np


def make_box(lo, hi, mat_id=0):
    """Axis-aligned box as 12 outward triangles: (verts, faces, mat_ids)."""
    x0, y0, z0 = np.asarray(lo, np.float32)
    x1, y1, z1 = np.asarray(hi, np.float32)
    corners = np.asarray([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
    ], np.float32)
    quads = ((0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4), (3, 7, 6, 2),
             (0, 4, 7, 3), (1, 2, 6, 5))
    faces = []
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    faces = np.asarray(faces, np.int64)
    return corners, faces, np.full((len(faces),), mat_id, np.int32)


def _cylinder(center, radius, height, segments, mat_id):
    """Open cylinder shell (2 * segments triangles)."""
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
    """UV sphere (2 * rows * cols triangles)."""
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


def merge_meshes(parts):
    """Concatenate (verts, faces, mat_ids) triples into one indexed mesh."""
    verts, faces, mids = [], [], []
    off = 0
    for v, f, m in parts:
        verts.append(v)
        faces.append(np.asarray(f) + off)
        mids.append(m)
        off += len(v)
    return (np.concatenate(verts), np.concatenate(faces),
            np.concatenate(mids))


#: the hall's materials, by mat_id: floor, walls, columns and the three
#: sphere finishes (keys as the port's ``MaterialTable.build`` reads them;
#: a missing key takes its default: alpha 1, roughness 1e-4, metallic 0,
#: no emission, no transmission, ior 1)
HALL_MATERIALS = (
    {"diffuse": (0.55, 0.5, 0.45), "roughness": 0.6},
    {"diffuse": (0.6, 0.55, 0.5)},
    {"diffuse": (0.7, 0.68, 0.62), "roughness": 0.4},
    {"diffuse": (0.7, 0.3, 0.25), "roughness": 0.3, "metallic": 0.1},
    {"diffuse": (0.3, 0.5, 0.7), "roughness": 0.2, "metallic": 0.6},
    {"diffuse": (0.8, 0.75, 0.3), "roughness": 0.1, "metallic": 0.9},
)


def hall_mesh(target_tris: int = 100_000, seed: int = 0):
    """The hall's indexed mesh (verts f32[V,3], faces i64[T,3], mat_ids
    i32[T]): floor and walls, two rows of segmented columns with their
    capitals, and sphere clutter, scaled to about ``target_tris``
    triangles (100,000 gives 136,996)."""
    rng = np.random.default_rng(seed)
    parts = []
    hall_l, hall_w, hall_h = 24.0, 10.0, 6.0
    parts.append(make_box((-hall_l / 2, -0.2, -hall_w / 2),
                          (hall_l / 2, 0.0, hall_w / 2), mat_id=0))
    parts.append(make_box((-hall_l / 2, 0.0, -hall_w / 2 - 0.2),
                          (hall_l / 2, hall_h, -hall_w / 2), mat_id=1))
    parts.append(make_box((-hall_l / 2, 0.0, hall_w / 2),
                          (hall_l / 2, hall_h, hall_w / 2 + 0.2), mat_id=1))
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
    return merge_meshes(parts)


def material_arrays(materials):
    """The material records as arrays: diffuse f32[M,4] (rgb, alpha),
    specular f32[M,4] (y roughness, z metallic), emissive f32[M,3],
    transmission f32[M,3], ior f32[M]."""
    m = len(materials)
    out = {"diffuse": np.zeros((m, 4), np.float32),
           "specular": np.zeros((m, 4), np.float32),
           "emissive": np.zeros((m, 3), np.float32),
           "transmission": np.zeros((m, 3), np.float32),
           "ior": np.ones((m,), np.float32)}
    for i, d in enumerate(materials):
        out["diffuse"][i, :3] = d.get("diffuse", (0.0, 0.0, 0.0))
        out["diffuse"][i, 3] = d.get("alpha", 1.0)
        out["specular"][i, 1] = d.get("roughness", 0.0001)
        out["specular"][i, 2] = d.get("metallic", 0.0)
        out["emissive"][i] = d.get("emissive", (0.0, 0.0, 0.0))
        out["transmission"][i] = d.get("transmission", (0.0, 0.0, 0.0))
        out["ior"][i] = d.get("ior", 1.0)
    return out


def suns(directions=((0.3, 1.0, 0.1),), distance: float = 400.0,
         radius: float = 40.0,
         color=(150.0 * 255 / 255, 150.0 * 250 / 255, 150.0 * 244 / 255)):
    """Sphere suns: (center f32[L,3], radius f32[L], color f32[L,3])."""
    dirs = np.asarray(directions, np.float32)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    n = dirs.shape[0]
    col = np.broadcast_to(np.asarray(color, np.float32), (n, 3)).copy()
    return (dirs * np.float32(distance),
            np.full((n,), radius, np.float32), col)


def sky_image(resolution: int = 256, sun_dir=(0.5, 0.6, 0.3),
              turbidity: float = 2.5):
    """Procedural HDR equirect sky f32[resolution, 2 * resolution, 3]:
    gradient, sun disc and horizon glow."""
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
    return (sky + sun + glow).astype(np.float32)
