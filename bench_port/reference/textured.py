"""The plain reference of the textured configurations: ``tracer.py``'s
path tracer with texture fetches and tangent-space normal mapping.

An independent statement, in plain torch, of the surface the upstream's
material pass gives a textured hit (ShadersSDK/raytracing/surface.comp:
102-195): the uv interpolated from the triangle's corner texcoords, a
bilinear fetch of each map the hit's material binds, the bump map's
tangent-space normal put in the frame of the triangle's tangent (from its
uv derivatives), the shading normal and the bitangent (their cross
product), the diffuse map multiplying the material's diffuse colour and
alpha, the emissive map its emission, and the specular map's G and B
channels scaling its roughness and metallic.  Everything else of the
transport, the camera, the hit search and the sky is ``tracer.py``'s and
``hits.py``'s.

The fetch is its own: each texture at its own size (GL_REPEAT: the uv
wrapped into [0, 1), texel centres at +0.5, the four texels wrapped), the
four texels read from the plain RGBA stack this module builds from the
benchmark's raw images, never from a corner-packed copy, so the
program's packing is checked too.  The tangent is computed once a
triangle.  It imports nothing of the program, and turns TF32 off
(``build_scene``).

Departures from the upstream, as the program makes them: no mip chain
(the upstream samples through GL samplers with their filtering); the hit
records stay float32 where the upstream packs its surface fields to fp16;
the tangent is not made orthogonal to the shading normal.  ``dtype`` sets
the precision of every tensor: float32 for the reference, bfloat16 for
the control that must fail.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench_port.reference import hits, tracer
from bench_port.reference.hits import INF_DIST, cross, dot
from bench_port.reference.tracer import (
    GAP, S_ALPHA, S_COS1, S_COS2, S_GLOSS, S_LIGHT, S_LIGHT1, S_LIGHT2,
    S_SPEC, length, normalize)

#: the texture kinds of a material, in the program's order
KINDS = ("tex_diffuse", "tex_specular", "tex_emissive", "tex_bump")
#: the filter the reference implements
FILTER = "bilinear"
#: the uv determinant below which the tangent's reciprocal is clamped
RCP_EPS = 1e-12


@dataclasses.dataclass
class Scene:
    base: tracer.Scene        # geometry, materials, lights, sky
    t0: torch.Tensor          # [T,2] texcoords at the corners
    t1: torch.Tensor
    t2: torch.Tensor
    tangent: torch.Tensor     # [T,3] unit tangent from the uv derivatives
    tex: torch.Tensor         # [N,H,W,4] RGBA, each texture top-left
    size: torch.Tensor        # i64[N,2] each texture's own (w, h)
    bound: dict               # kind -> i64[M] texture id, -1 = none


def check_render(render: dict) -> None:
    """Refuse a configuration whose transport the reference does not
    implement."""
    tracer.check_render(render)
    if render.get("texture_filter", FILTER) != FILTER:
        raise ValueError(f"the reference implements texture_filter="
                         f"{FILTER!r}, not {render['texture_filter']!r}")


def texture_stack(images):
    """(f32[N,H,W,4], i64[N,2]): the images (each f32[h,w,3|4]) as RGBA
    (alpha 1 where an image has none), each in the top-left corner of the largest one's
    frame, and each one's own (w, h)."""
    rgba = []
    for img in images:
        img = np.asarray(img, np.float32)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
        rgba.append(img)
    h = max(x.shape[0] for x in rgba)
    w = max(x.shape[1] for x in rgba)
    out = np.ones((len(rgba), h, w, 4), np.float32)
    for i, img in enumerate(rgba):
        out[i, :img.shape[0], :img.shape[1]] = img
    size = np.asarray([[x.shape[1], x.shape[0]] for x in rgba], np.int64)
    return out, size


def triangle_tangents(v0, v1, v2, t0, t1, t2):
    """[T,3] unit tangents: the surface direction along which u grows,
    (e1 dv2 - e2 dv1) / det of the edges e and the uv edges (du, dv),
    the determinant clamped away from 0 keeping its sign."""
    e1, e2 = v1 - v0, v2 - v0
    d1, d2 = t1 - t0, t2 - t0
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    eps = torch.full_like(det, RCP_EPS)
    det = torch.where(torch.abs(det) < RCP_EPS,
                      torch.where(det < 0, -eps, eps), det)
    return normalize((e1 * d2[:, 1:2] - e2 * d1[:, 1:2])
                     * (1.0 / det)[:, None])


def build_scene(arrays: dict, device, dtype=torch.float32) -> Scene:
    """The reference's textured scene from the benchmark's raw arrays
    (``scenes/hall_textured.py``): ``tracer.build_scene``'s, the corner
    texcoords of ``texcoords`` f32[V,2], the tangents, the RGBA stack of
    ``textures`` and each material's bindings."""
    # the reference's precision is its dtype's: no op of it in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = tracer.build_scene(arrays, device, dtype)
    faces, uv = arrays["faces"], arrays["texcoords"]

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device).to(
            dtype)
    t0, t1, t2 = (t(uv[faces[:, k]]) for k in range(3))
    tex, size = texture_stack(arrays["textures"])
    bound = {k: torch.as_tensor([m.get(k, -1) for m in arrays["materials"]],
                                dtype=torch.int64, device=device)
             for k in KINDS}
    return Scene(base=base, t0=t0, t1=t1, t2=t2,
                 tangent=triangle_tangents(base.v0, base.v1, base.v2,
                                           t0, t1, t2),
                 tex=t(tex), size=torch.as_tensor(size, device=device),
                 bound=bound)


def fetch(tex, size, tid, uv):
    """Bilinear fetch [P,4] of textures ``tid`` i64[P] (>= 0) of the stack
    ``tex`` [N,H,W,4] with sizes ``size`` i64[N,2] (``texture_stack``) at
    ``uv`` [P,2]: the uv wrapped into [0, 1), scaled to the texture's own
    size, texel centres at +0.5, the four texels around the point wrapped
    at that size, blended along x then y."""
    w = size[tid, 0]
    h = size[tid, 1]
    u = torch.remainder(uv[:, 0], 1.0)
    v = torch.remainder(uv[:, 1], 1.0)
    x = u * w.to(uv.dtype) - 0.5
    y = v * h.to(uv.dtype) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    y0i = torch.remainder(y0.to(torch.int64), h)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.remainder(y0i + 1, h)
    img = tex
    return ((img[tid, y0i, x0i] * (1 - fx) + img[tid, y0i, x1i] * fx)
            * (1 - fy)
            + (img[tid, y1i, x0i] * (1 - fx) + img[tid, y1i, x1i] * fx) * fy)


def surface(scene: Scene, ti, bu, bv, ns, mat):
    """The textured surface at hits on triangles ``ti`` with barycentrics
    (bu, bv), interpolated shading normals ``ns`` and materials ``mat``:
    (ns, albedo, alpha, rough, metal, emissive), each map applied where
    the material binds one."""
    base = scene.base
    w = (1.0 - bu - bv)[:, None]
    uv = w * scene.t0[ti] + bu[:, None] * scene.t1[ti] \
        + bv[:, None] * scene.t2[ti]
    albedo4 = base.diffuse[mat]
    rough, metal = base.rough[mat], base.metal[mat]
    emissive = base.emissive[mat]

    def texel(kind):
        tid = scene.bound[kind][mat]
        return tid >= 0, fetch(scene.tex, scene.size,
                               torch.clamp(tid, min=0), uv)
    if (scene.bound["tex_bump"] >= 0).any():
        has, btex = texel("tex_bump")
        tang = scene.tangent[ti]
        bitan = cross(ns, tang)
        nt = btex[:, :3] * 2.0 - 1.0
        mapped = normalize(tang * nt[:, 0:1] + bitan * nt[:, 1:2]
                           + ns * nt[:, 2:3])
        ns = torch.where(has[:, None], mapped, ns)
    if (scene.bound["tex_diffuse"] >= 0).any():
        has, tex = texel("tex_diffuse")
        albedo4 = torch.where(has[:, None], albedo4 * tex, albedo4)
    if (scene.bound["tex_emissive"] >= 0).any():
        has, etex = texel("tex_emissive")
        emissive = torch.where(has[:, None], emissive * etex[:, :3],
                               emissive)
    if (scene.bound["tex_specular"] >= 0).any():
        has, stex = texel("tex_specular")
        rough = torch.where(has, rough * stex[:, 1], rough)
        metal = torch.where(has, metal * stex[:, 2], metal)
    return ns, albedo4[:, :3], albedo4[:, 3], rough, metal, emissive


def trace(scene: Scene, index, render: dict, o, d, bounce_s):
    """Radiance [P,3] of rays (o, d) through ``render["max_bounces"]``
    bounces with their bounce rows ``bounce_s`` [B,P,11]: ``tracer.trace``
    with the textured surface (``surface``) at every hit; shading, the
    coins and the shadow ray's gate read the mapped shading normal."""
    check_render(render)
    base = scene.base
    dtype, dev = o.dtype, o.device
    p_n = o.shape[0]
    cfg_ior = render.get("ior", 1.4)
    min_tp = render.get("min_throughput", 1e-4)
    n_lights = base.light_center.shape[0]
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
        tv0, tv1, tv2 = base.v0[ti], base.v1[ti], base.v2[ti]
        t, bu, bv, _ = hits.moller_trumbore(o, d, tv0, tv1, tv2)
        t = torch.where(hit, t, INF_DIST)
        bu = torch.where(hit, bu, 0.0)
        bv = torch.where(hit, bv, 0.0)

        miss = alive & ~hit
        miss_dir = torch.where(miss[:, None], d, miss_dir)
        miss_beta = torch.where(miss[:, None], beta, miss_beta)
        on_surf = alive & hit

        w = (1.0 - bu - bv)[:, None]
        ns = normalize(w * base.n0[ti] + bu[:, None] * base.n1[ti]
                       + bv[:, None] * base.n2[ti])
        ng = normalize(cross(tv1 - tv0, tv2 - tv0))
        ns = torch.where(torch.isfinite(ns).all(-1, keepdim=True), ns, ng)
        m = base.mat[ti]
        ns, albedo, alpha, rough, metal, emissive = surface(
            scene, ti, bu, bv, ns, m)
        p = o + t[:, None] * d
        n = torch.where((dot(ns, d) < 0.0)[:, None], ns, -ns)
        radiance = radiance + torch.where(on_surf[:, None],
                                          beta * emissive, 0.0)

        cosmag = torch.clamp(torch.clamp(torch.abs(dot(d, n)), min=1e-6)
                             ** (cfg_ior - 1.0), 0.0, 1.0)[:, None]
        dielectric = 1.0 + (0.05 - 1.0) * cosmag
        sc = dielectric + (albedo - dielectric) * torch.sqrt(
            torch.clamp(metal, 0.0, 1.0))[:, None]
        spca = torch.clamp(length(sc), 0.0, 1.0)

        pass_through = u[:, S_ALPHA] < 1.0 - alpha
        choose_spec = ~pass_through & (u[:, S_SPEC] < spca)
        choose_diff = ~pass_through & ~choose_spec

        cos_dir = tracer._cosine_dir(n, u[:, S_COS1], u[:, S_COS2])
        gloss = torch.clamp(rough * u[:, S_GLOSS], 0.0, 1.0)[:, None]
        mirror = tracer._reflect(d, n)
        spec_dir = normalize(mirror + (cos_dir - mirror) * gloss)
        ior = base.ior[m]
        eta = torch.where(dot(d, ns) < 0.0, 1.0 / ior, ior)[:, None]
        refr = tracer._refract(d, n, eta)
        tir = (dot(refr, refr) < 1e-12)[:, None]
        pass_dir = torch.where(tir, mirror, normalize(
            torch.where(tir, torch.ones_like(refr), refr)))
        trans = base.transmission[m]
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
        center = base.light_center[li]
        radius = base.light_radius[li]
        lcolor = base.light_color[li] * float(n_lights)
        target = center + radius[:, None] * tracer._sphere_point(
            u[:, S_LIGHT1], u[:, S_LIGHT2])
        ldir = normalize(target - p)
        dist = length(center - p)
        weight = 1.0 - torch.sqrt(torch.clamp(1.0 - torch.clamp(
            dot(ldir, n) * 2.0 * (radius / torch.clamp(dist, min=1e-6)) ** 2,
            0.0, 1.0), min=1e-12))
        shadow_o = p + ldir * GAP
        t_light = tracer._sphere_hit(shadow_o, ldir, center, radius + GAP)
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
    return radiance + miss_beta * tracer.sky_radiance(base, miss_dir)


def render_pixels(scene: Scene, index, camera: dict, render: dict, cam_s,
                  bounce_s, pix):
    """Radiance [P,3] of pixels ``pix``, each the mean of its ``spp``
    paths, from the sample rows of their lanes (``tracer.pixel_lanes``),
    in the scene's precision."""
    dtype = scene.base.v0.dtype
    spp = render.get("spp", 1)
    o, d = tracer.camera_rays(camera, render, cam_s.to(dtype),
                              pix.repeat(spp), dtype)
    radiance = trace(scene, index, render, o, d, bounce_s.to(dtype))
    return radiance.reshape(spp, -1, 3).mean(dim=0)


def scene_index(scene: Scene):
    """The hit search's clusters of the scene's geometry."""
    return tracer.scene_index(scene.base)
