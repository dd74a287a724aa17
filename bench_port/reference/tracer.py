"""The plain reference path tracer and its inverse-rendering step.

An independent statement, in plain torch, of the light transport the
benchmark's configurations ask for: a pinhole camera, closest hits, smooth
shading normals, emission, the specular colour model with its diffuse /
glossy / pass-through coins, one next-event shadow ray to a sphere light,
and the equirect sky fetched at each path's miss.  Each pixel's path reads
only its own rows of the sample arrays, so any set of pixels can be traced
alone.  It supports exactly the features a configuration of this
benchmark turns on and refuses any other (``check_render``).

It builds everything from the benchmark's raw inputs (``bench_port/
scene.py``'s arrays): the per-corner triangles, its own smooth normals,
the material records, its own hit search (``hits.py``).  It imports
nothing of the program.  ``dtype`` sets the precision of every tensor:
float32 for the reference, bfloat16 for the control that must fail.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from bench_port.reference import hits
from bench_port.reference.hits import INF_DIST, PZERO, cross, dot

GAP = 2.0 * PZERO
#: the RenderConfig values the reference implements (any other value of
#: these fields is refused)
SUPPORTED = {"direct_light": True, "env_nee": False,
             "camera_360": False, "interlace": False, "dof": False,
             "rr_start_bounce": 0, "primary_tile_order": False}
#: sample slots of a bounce row
(S_ALPHA, S_SPEC, S_COS1, S_COS2, S_GLOSS, S_LIGHT1, S_LIGHT2, S_LIGHT,
 S_ENV1, S_ENV2, S_RR) = range(11)


def check_render(render: dict) -> None:
    """Refuse a configuration whose transport the reference does not
    implement."""
    for key, want in SUPPORTED.items():
        if render.get(key, want) != want:
            raise ValueError(f"the reference implements {key}={want!r}, "
                             f"not {render[key]!r}")


def length(v):
    return torch.sqrt(torch.clamp(dot(v, v), min=1e-30))


def normalize(v):
    return v / length(v)[..., None]


def smooth_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals of an indexed mesh (float32)."""
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    out = np.zeros_like(verts)
    for k in range(3):
        np.add.at(out, faces[:, k], fn)
    n = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(n, 1e-12)).astype(np.float32)


@dataclasses.dataclass
class Scene:
    v0: torch.Tensor          # [T,3] per-corner positions
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor          # [T,3] smooth normals at the corners
    n1: torch.Tensor
    n2: torch.Tensor
    mat: torch.Tensor         # i64[T]
    diffuse: torch.Tensor     # [M,4] rgb, alpha
    rough: torch.Tensor       # [M]
    metal: torch.Tensor       # [M]
    emissive: torch.Tensor    # [M,3]
    transmission: torch.Tensor  # [M,3]
    ior: torch.Tensor         # [M]
    light_center: torch.Tensor  # [L,3]
    light_radius: torch.Tensor  # [L]
    light_color: torch.Tensor   # [L,3]
    sky: torch.Tensor         # [h,w,3]
    sky_scale: torch.Tensor   # [3]


def build_scene(arrays: dict, device, dtype=torch.float32) -> Scene:
    """The reference's scene from the benchmark's raw arrays
    (``bench_port/scene.py:scene_arrays``)."""
    from bench_port.scene import material_arrays
    verts, faces = arrays["verts"], arrays["faces"]
    normals = smooth_normals(verts, faces)
    mats = material_arrays(arrays["materials"])

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device).to(
            dtype)
    corner = [faces[:, k] for k in range(3)]
    return Scene(
        v0=t(verts[corner[0]]), v1=t(verts[corner[1]]),
        v2=t(verts[corner[2]]),
        n0=t(normals[corner[0]]), n1=t(normals[corner[1]]),
        n2=t(normals[corner[2]]),
        mat=torch.as_tensor(arrays["mat_ids"].astype(np.int64),
                            device=device),
        diffuse=t(mats["diffuse"]), rough=t(mats["specular"][:, 1]),
        metal=t(mats["specular"][:, 2]), emissive=t(mats["emissive"]),
        transmission=t(mats["transmission"]), ior=t(mats["ior"]),
        light_center=t(arrays["light_center"]),
        light_radius=t(arrays["light_radius"]),
        light_color=t(arrays["light_color"]),
        sky=t(arrays["sky"]), sky_scale=t(arrays["sky_scale"]))


def camera_rays(camera: dict, render: dict, cam_s, pix, dtype):
    """Pinhole rays (o, d [P,3]) of pixels ``pix`` (row-major indices)
    with their camera rows ``cam_s`` [P,4] (jitter in 0:2)."""
    dev = cam_s.device
    w, h = render["width"], render["height"]

    def vec(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev).to(
            dtype)
    eye, target, up = vec(camera["eye"]), vec(camera["target"]), \
        vec(camera.get("up", (0.0, 1.0, 0.0)))
    fwd = normalize(target - eye)
    right = normalize(cross(fwd, normalize(up)))
    cup = cross(right, fwd)
    px = (pix % w).to(dtype)
    py = (pix // w).to(dtype)
    jitter = torch.clamp(cam_s[:, 0:2], 1e-5, 1.0 - 1e-5)
    u = (px + jitter[:, 0]) / w
    v = (py + jitter[:, 1]) / h
    fov = vec(camera["fov_y_deg"] * math.pi / 180.0)
    tan_half = torch.tan(fov * 0.5)
    sx = (u * 2.0 - 1.0) * tan_half * (w / h)
    sy = (1.0 - v * 2.0) * tan_half
    d = normalize(fwd + sx[:, None] * right + sy[:, None] * cup)
    return eye.expand(d.shape), d


def sky_radiance(scene: Scene, d):
    """Bilinear equirect lookup: u from atan2(z, x), v from the elevation
    atan2(y, |(x, z)|) (asin(y) of a unit vector, with a finite derivative
    at the poles); wrapping in u, clamped in v."""
    h, w, _ = scene.sky.shape
    u = torch.atan2(d[:, 2], d[:, 0]) / (2.0 * math.pi) + 0.5
    flat = torch.sqrt(torch.clamp(d[:, 0] * d[:, 0] + d[:, 2] * d[:, 2],
                                  min=1e-30))
    v = 0.5 - torch.atan2(d[:, 1], flat) / math.pi
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    img = scene.sky
    col = ((img[y0i, x0i] * (1 - fx) + img[y0i, x1i] * fx) * (1 - fy)
           + (img[y1i, x0i] * (1 - fx) + img[y1i, x1i] * fx) * fy)
    return col * scene.sky_scale


def _basis(n):
    third = 0.57735026
    ax = torch.abs(n[:, 0:1]) < third
    ay = torch.abs(n[:, 1:2]) < third
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    perp = torch.where(ax, eye[0].expand(n.shape),
                       torch.where(ay, eye[1].expand(n.shape),
                                   eye[2].expand(n.shape)))
    t = normalize(cross(n, perp))
    return t, cross(n, t)


def _cosine_dir(n, u1, u2):
    up = torch.sqrt(u1)[:, None]
    over = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))[:, None]
    around = (u2 * 2.0 * math.pi)[:, None]
    t, b = _basis(n)
    return normalize(n * up + t * torch.cos(around) * over
                     + b * torch.sin(around) * over)


def _sphere_point(u1, u2):
    up = u1 * 2.0 - 1.0
    over = torch.sqrt(torch.clamp(1.0 - up * up, min=0.0))
    around = u2 * 2.0 * math.pi
    return torch.stack([up, torch.cos(around) * over,
                        torch.sin(around) * over], dim=-1)


def _sphere_hit(o, d, center, radius):
    """Nearest t >= 0 of the ray on the sphere, or INF_DIST."""
    to = o - center
    b = 2.0 * dot(to, d)
    c = dot(to, to) - radius * radius
    disc = b * b - 4.0 * c
    sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    t1 = 0.5 * (-b - sq)
    t2 = 0.5 * (-b + sq)
    mn, mx = torch.minimum(t1, t2), torch.maximum(t1, t2)
    t = torch.where(mx >= 0.0, torch.where(mn >= 0.0, mn, mx), INF_DIST)
    return torch.where(disc > 0.0, t, INF_DIST)


def _reflect(d, n):
    return d - 2.0 * dot(d, n)[:, None] * n


def _refract(d, n, eta):
    cosi = dot(n, d)[:, None]
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    refr = eta * d - (eta * cosi + torch.sqrt(torch.where(k > 0.0, k, 1.0))
                      ) * n
    return torch.where(k <= 0.0, torch.zeros_like(d), refr)


def trace(scene: Scene, index, render: dict, o, d, bounce_s):
    """Radiance [P,3] of rays (o, d) through ``render["max_bounces"]``
    bounces with their bounce rows ``bounce_s`` [B,P,11].  ``index`` is
    the hit search's clusters; every hit it finds is re-evaluated on the
    scene's current vertices (differentiable in them, in the material
    table and in the light colours)."""
    check_render(render)
    dtype, dev = o.dtype, o.device
    p_n = o.shape[0]
    cfg_ior = render.get("ior", 1.4)
    min_tp = render.get("min_throughput", 1e-4)
    n_lights = scene.light_center.shape[0]
    beta = torch.ones((p_n, 3), dtype=dtype, device=dev)
    radiance = torch.zeros((p_n, 3), dtype=dtype, device=dev)
    alive = torch.ones((p_n,), dtype=torch.bool, device=dev)
    miss_dir = torch.zeros((p_n, 3), dtype=dtype, device=dev)
    miss_dir[:, 2] = 1.0
    miss_beta = torch.zeros((p_n, 3), dtype=dtype, device=dev)
    for b in range(render["max_bounces"]):
        u = bounce_s[b]
        cap = torch.where(alive, INF_DIST, 0.0).to(dtype)
        _, tri = hits.query(index, o, d, cap)
        hit = tri >= 0
        ti = torch.clamp(tri, min=0)
        tv0, tv1, tv2 = scene.v0[ti], scene.v1[ti], scene.v2[ti]
        t, bu, bv, _ = hits.moller_trumbore(o, d, tv0, tv1, tv2)
        t = torch.where(hit, t, INF_DIST)
        bu = torch.where(hit, bu, 0.0)
        bv = torch.where(hit, bv, 0.0)

        miss = alive & ~hit
        miss_dir = torch.where(miss[:, None], d, miss_dir)
        miss_beta = torch.where(miss[:, None], beta, miss_beta)
        on_surf = alive & hit

        w = (1.0 - bu - bv)[:, None]
        ns = normalize(w * scene.n0[ti] + bu[:, None] * scene.n1[ti]
                       + bv[:, None] * scene.n2[ti])
        ng = normalize(cross(tv1 - tv0, tv2 - tv0))
        ns = torch.where(torch.isfinite(ns).all(-1, keepdim=True), ns, ng)
        m = scene.mat[ti]
        albedo4 = scene.diffuse[m]
        albedo, alpha = albedo4[:, :3], albedo4[:, 3]
        rough, metal = scene.rough[m], scene.metal[m]
        p = o + t[:, None] * d
        n = torch.where((dot(ns, d) < 0.0)[:, None], ns, -ns)
        radiance = radiance + torch.where(on_surf[:, None],
                                          beta * scene.emissive[m], 0.0)

        cosmag = torch.clamp(torch.clamp(torch.abs(dot(d, n)), min=1e-6)
                             ** (cfg_ior - 1.0), 0.0, 1.0)[:, None]
        dielectric = 1.0 + (0.05 - 1.0) * cosmag
        sc = dielectric + (albedo - dielectric) * torch.sqrt(
            torch.clamp(metal, 0.0, 1.0))[:, None]
        spca = torch.clamp(length(sc), 0.0, 1.0)

        pass_through = u[:, S_ALPHA] < 1.0 - alpha
        choose_spec = ~pass_through & (u[:, S_SPEC] < spca)
        choose_diff = ~pass_through & ~choose_spec

        cos_dir = _cosine_dir(n, u[:, S_COS1], u[:, S_COS2])
        gloss = torch.clamp(rough * u[:, S_GLOSS], 0.0, 1.0)[:, None]
        mirror = _reflect(d, n)
        spec_dir = normalize(mirror + (cos_dir - mirror) * gloss)
        ior = scene.ior[m]
        eta = torch.where(dot(d, ns) < 0.0, 1.0 / ior, ior)[:, None]
        refr = _refract(d, n, eta)
        tir = (dot(refr, refr) < 1e-12)[:, None]
        pass_dir = torch.where(tir, mirror, normalize(
            torch.where(tir, torch.ones_like(refr), refr)))
        trans = scene.transmission[m]
        tint = torch.where((trans > 0.0).any(-1, keepdim=True), trans, 1.0)

        new_d = torch.where(pass_through[:, None], pass_dir,
                            torch.where(choose_spec[:, None], spec_dir,
                                        cos_dir))
        branch = torch.where(
            pass_through[:, None], tint,
            torch.where(choose_spec[:, None],
                        torch.clamp(sc / torch.clamp(spca, min=1e-6)[:, None],
                                    0.0, 1.0), albedo))
        new_beta = beta * branch
        new_o = p + new_d * GAP

        # next-event estimation toward one sphere light
        diffuse_beta = torch.where((on_surf & choose_diff)[:, None],
                                   beta * albedo, 0.0)
        li = torch.clamp((u[:, S_LIGHT] * n_lights).to(torch.int64), 0,
                         n_lights - 1)
        center = scene.light_center[li]
        radius = scene.light_radius[li]
        lcolor = scene.light_color[li] * float(n_lights)
        target = center + radius[:, None] * _sphere_point(
            u[:, S_LIGHT1], u[:, S_LIGHT2])
        ldir = normalize(target - p)
        dist = length(center - p)
        weight = 1.0 - torch.sqrt(torch.clamp(1.0 - torch.clamp(
            dot(ldir, n) * 2.0 * (radius / torch.clamp(dist, min=1e-6)) ** 2,
            0.0, 1.0), min=1e-12))
        shadow_o = p + ldir * GAP
        t_light = _sphere_hit(shadow_o, ldir, center, radius + GAP)
        need = ((dot(ns, ldir) >= 0.0) & (weight > 0.0)
                & (diffuse_beta > 0.0).any(-1))
        t_query = torch.where(need, t_light, 0.0)
        _, occ_tri = hits.query(index, shadow_o, ldir, t_query, any_hit=True)
        vis = need & (occ_tri < 0) & (t_light < INF_DIST)
        radiance = radiance + torch.where(
            vis[:, None], diffuse_beta * weight[:, None] * lcolor, 0.0)

        new_alive = on_surf & (length(new_beta) > min_tp)
        o = torch.where(on_surf[:, None], new_o, o)
        d = torch.where(on_surf[:, None], new_d, d)
        beta = torch.where(on_surf[:, None], new_beta, beta)
        alive = new_alive
    return radiance + miss_beta * sky_radiance(scene, miss_dir)


def pixel_lanes(render: dict, pix):
    """The lanes of pixels ``pix`` [P], one per sample: [spp*P] in the
    sample arrays' [spp, H, W] order."""
    spp, hw = render.get("spp", 1), render["width"] * render["height"]
    return (torch.arange(spp, device=pix.device)[:, None] * hw
            + pix[None]).reshape(-1)


def render_pixels(scene: Scene, index, camera: dict, render: dict, cam_s,
                  bounce_s, pix):
    """Radiance [P,3] of pixels ``pix``, each the mean of its ``spp``
    paths, from the sample rows of their lanes (``pixel_lanes``: cam_s
    [spp*P,4], bounce_s [B,spp*P,11]), in the scene's precision."""
    dtype = scene.v0.dtype
    spp = render.get("spp", 1)
    o, d = camera_rays(camera, render, cam_s.to(dtype), pix.repeat(spp),
                       dtype)
    radiance = trace(scene, index, render, o, d, bounce_s.to(dtype))
    return radiance.reshape(spp, -1, 3).mean(dim=0)


def scene_index(scene: Scene):
    """The hit search's clusters of the scene's current geometry."""
    return hits.build_index(scene.v0, scene.v1, scene.v2)


#: the train step's parameters, by the program's names
PARAMS = ("mat_diffuse", "light_color", "v0", "v1", "v2")


def initial_params(scene: Scene, diffuse_scale: float) -> dict:
    """The step's starting parameters: the diffuse table with its RGB
    scaled by ``diffuse_scale``, the light colours, the corner vertices."""
    diffuse = scene.diffuse.clone()
    diffuse[:, :3] = diffuse[:, :3] * diffuse_scale
    return {"mat_diffuse": diffuse, "light_color": scene.light_color.clone(),
            "v0": scene.v0.clone(), "v1": scene.v1.clone(),
            "v2": scene.v2.clone()}


def train_step(scene: Scene, index, camera: dict, render: dict, train: dict,
               params: dict, cam_s, bounce_s, target):
    """One inverse-rendering step over the whole frame: the image's MSE
    against ``target`` [H,W,3], its gradient in every parameter, and a
    normalised-SGD move (each gradient divided by its RMS + 1e-8 when
    ``train["normalize_grads"]``, times ``lr`` and the parameter's
    ``lr_scale``).  Returns (new params, loss, raw gradients)."""
    dtype = scene.v0.dtype
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    live = dataclasses.replace(scene, diffuse=leaves["mat_diffuse"],
                               light_color=leaves["light_color"],
                               v0=leaves["v0"], v1=leaves["v1"],
                               v2=leaves["v2"])
    w, h = render["width"], render["height"]
    pix = torch.arange(w * h, device=cam_s.device)
    img = render_pixels(live, index, camera, render, cam_s, bounce_s, pix)
    loss = torch.mean((img - target.reshape(-1, 3).to(dtype)) ** 2)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    new = {}
    with torch.no_grad():
        for k, g in grads.items():
            step = g
            if train.get("normalize_grads", False):
                step = g / (torch.sqrt(torch.mean(g * g)) + 1e-8)
            new[k] = params[k].detach() - train["lr"] * train.get(
                "lr_scale", {}).get(k, 1.0) * step
    return new, loss.detach(), grads
