"""The path-tracing integrator: a Python loop over bounces with masked lanes.

The counterpart of ``prismarine_core_tpu.render.integrator``.  Every ray
keeps a fixed lane for the whole bounce budget and dead lanes are masked;
radiance accumulates per lane and reduces to pixels by a reshape-mean.

Light transport (as in the JAX package):
  * miss     -> radiance += beta * env(dir), fetched once after the loop
  * surface  -> radiance += beta * emissive
  * with prob 1 - alpha: pass through (refract, TIR falls back to mirror)
  * else with prob spca = |specular color|: glossy reflection
  * else: cosine diffuse bounce, plus one NEE shadow ray toward a sphere
    light chosen by the reserved uniform.

The port runs ``intersector="brute"`` (the oracle) and ``"pallas"`` (the
packet query on the hand-written kernels); ``check_supported`` raises for
knobs outside that slice.
"""

from __future__ import annotations

import torch

from prismarine_core_tpu_torch.models.camera import Camera, generate_rays
from prismarine_core_tpu_torch.ops import sampling as smp
from prismarine_core_tpu_torch.ops.intersect import (
    Hit, intersect_closest_brute, intersect_sphere, occluded_brute)
from prismarine_core_tpu_torch.utils import math as pm
from prismarine_core_tpu_torch.utils.config import (
    GAP, INF_DIST, RenderConfig, check_supported)


def _pallas_kwargs(cfg: RenderConfig, any_hit: bool) -> dict:
    """RenderConfig's packet-query knobs as ``_run_packet_pallas``
    kwargs."""
    kw = dict(cull_impl=(cfg.anyhit_cull_impl or cfg.cull_impl) if any_hit
              else cfg.cull_impl,
              sort_mode=cfg.sort_mode, kernel_form=cfg.kernel_form,
              near_frac=cfg.near_frac)
    strat = cfg.anyhit_strategy if any_hit else cfg.closest_strategy
    k = cfg.anyhit_k if any_hit else cfg.closest_k
    if strat:
        kw["strategy"] = strat
    if k:
        kw["k_round"] = k
    return kw


def closest_hit(scene, o, d, cfg: RenderConfig, t_cap=None,
                with_order: bool = False, order=None):
    """Closest hit through the configured intersector.  ``t_cap`` zeroes
    lanes whose result is unused (the packet query drops them);
    ``with_order`` also returns the packet query's coherence sort (None
    for "brute") for the same bounce's shadow query."""
    if cfg.intersector == "brute":
        hit, order = intersect_closest_brute(scene.triangles, o, d,
                                             block=cfg.tri_block), None
    elif cfg.intersector == "pallas":
        from prismarine_core_tpu_torch.accel import packet as pk
        if scene.packets is None:
            raise ValueError("scene.packets is None — build with "
                             "scene.with_bvh()")
        hit, order = pk.intersect_closest_pallas(
            scene.bvh, scene.packets, scene.triangles, o, d, t_cap=t_cap,
            return_order=True, order=order,
            **_pallas_kwargs(cfg, any_hit=False))
    else:
        check_supported(cfg)
        raise AssertionError("unreachable")
    return (hit, order) if with_order else hit


def occluded(scene, o, d, t_max, cfg: RenderConfig, order=None):
    """Any-hit query through the configured intersector."""
    if cfg.intersector == "brute":
        return occluded_brute(scene.triangles, o, d, t_max,
                              block=cfg.tri_block)
    if cfg.intersector == "pallas":
        from prismarine_core_tpu_torch.accel import packet as pk
        return pk.occluded_pallas(scene.bvh, scene.packets, scene.triangles,
                                  o, d, t_max, order=order,
                                  **_pallas_kwargs(cfg, any_hit=True))
    check_supported(cfg)
    raise AssertionError("unreachable")


def _interpolate_surface(scene, hit: Hit):
    """Per-ray surface fields at the hit (garbage where missed — callers
    mask): shading/geometric normals, material record.  Texture-less
    scenes only (the stub stack)."""
    if not getattr(scene.textures, "stub", False):
        raise NotImplementedError(
            "textured scenes are not ported yet (ROADMAP queue 1, "
            "'Textures and env NEE')")
    tri = torch.clamp(hit.tri, min=0).long()
    soup = scene.triangles
    w = (1.0 - hit.u - hit.v)[:, None]
    uu = hit.u[:, None]
    vv = hit.v[:, None]
    ns = pm.normalize(w * soup.n0[tri] + uu * soup.n1[tri]
                      + vv * soup.n2[tri])
    v0 = pm.take_rows(soup.v0, tri)
    ng = pm.normalize(pm.cross(pm.take_rows(soup.v1, tri) - v0,
                               pm.take_rows(soup.v2, tri) - v0))
    # geometric normal where the shading normal is degenerate
    ns = torch.where(torch.isfinite(ns).all(-1, keepdim=True), ns, ng)
    mat = scene.materials.lookup(soup.mat_id[tri].long())
    return dict(
        shading_normal=ns,
        geom_normal=ng,
        uv=torch.zeros((tri.shape[0], 2), dtype=torch.float32,
                       device=tri.device),
        albedo=mat.diffuse[:, :3],
        alpha=mat.diffuse[:, 3],
        roughness=mat.specular[:, 1],
        metallic=mat.specular[:, 2],
        emissive=mat.emissive[:, :3],
        transmission=mat.transmission[:, :3],
        ior=mat.ior,
    )


def _nee_contribution(scene, cfg: RenderConfig, p, n, ns_raw, diffuse_beta,
                      u, order=None):
    """Next-event estimation toward one uniformly chosen sphere light: a
    point inside the sphere, the reference's weight heuristic, the raw
    shading normal's gate, one shadow query.  Returns (contribution
    f32[R,3], NEE shadow lanes i32)."""
    n_lights = scene.lights.count
    li = torch.clamp((u[:, smp.S_RESERVED] * n_lights).to(torch.int32),
                     0, n_lights - 1).long()
    center = scene.lights.center[li]
    radius = scene.lights.radius[li]
    lcolor = pm.take_rows(scene.lights.color, li) * float(n_lights)

    sphere_pt = center + radius[:, None] * smp.uniform_sphere(
        u[:, smp.S_LIGHT1], u[:, smp.S_LIGHT2])
    ldir = pm.normalize(sphere_pt - p)
    dist = pm.length(center - p)
    weight = smp.light_sampling_weight(ldir, n, radius, dist)

    shadow_o = p + ldir * GAP
    t_light = intersect_sphere(shadow_o, ldir, center, radius + GAP)
    front = pm.dot(ns_raw, ldir) >= 0.0
    # lanes with no possible contribution get t_cap 0: the packet query
    # then gives them no pairs at all
    need = front & (weight > 0.0) & (diffuse_beta > 0.0).any(-1)
    t_query = torch.where(need, t_light, 0.0)
    occ = occluded(scene, shadow_o, ldir, t_query, cfg, order=order)
    vis = need & ~occ & (t_light < INF_DIST)
    contrib = torch.where(vis[:, None],
                          diffuse_beta * weight[:, None] * lcolor, 0.0)
    return contrib, need.sum(dtype=torch.int32)


def make_bounce_step(scene, cfg: RenderConfig):
    """The per-bounce step: (carry, u f32[R,11]) -> (carry, stats i32[5])."""

    def step(carry, u):
        o, d, beta, radiance, alive, miss_dir, miss_beta = carry
        t_cap = torch.where(alive, INF_DIST, 0.0)
        hit, order = closest_hit(scene, o, d, cfg, t_cap=t_cap,
                                 with_order=True)

        # deferred env pickup: record (direction, throughput) at the
        # miss, fetch once after the loop
        miss = alive & hit.missed
        miss_dir = torch.where(miss[:, None], d, miss_dir)
        miss_beta = torch.where(miss[:, None], beta, miss_beta)

        on_surf = alive & ~hit.missed
        surf = _interpolate_surface(scene, hit)
        p = o + hit.t[:, None] * d
        n = pm.faceforward(surf["shading_normal"], d)

        radiance = radiance + torch.where(on_surf[:, None],
                                          beta * surf["emissive"], 0.0)

        # specular color model
        cosmag = torch.clamp(
            torch.clamp(torch.abs(pm.dot(d, n)), min=1e-6)
            ** (cfg.ior - 1.0), 0.0, 1.0)
        dielectric = pm.mix(torch.ones_like(beta),
                            torch.full_like(beta, 0.05), cosmag[:, None])
        sc = pm.mix(dielectric, surf["albedo"],
                    torch.sqrt(torch.clamp(surf["metallic"], 0.0, 1.0)
                               )[:, None])
        spca = torch.clamp(pm.length(sc), 0.0, 1.0)

        # branch coins
        prom = 1.0 - surf["alpha"]
        pass_through = u[:, smp.S_ALPHA] < prom
        choose_spec = ~pass_through & (u[:, smp.S_SPEC] < spca)
        choose_diff = ~pass_through & ~choose_spec

        # continuation directions
        cos_dir = smp.cosine_hemisphere(n, u[:, smp.S_COS1],
                                        u[:, smp.S_COS2])
        gloss = torch.clamp(surf["roughness"] * u[:, smp.S_GLOSS],
                            0.0, 1.0)[:, None]
        spec_dir = pm.normalize(pm.mix(pm.reflect(d, n), cos_dir, gloss))

        # pass-through refracts (eta from entering / exiting); total
        # internal reflection falls back to the mirror direction
        entering = pm.dot(d, surf["shading_normal"]) < 0.0
        eta = torch.where(entering, 1.0 / surf["ior"], surf["ior"])
        refr = pm.refract(d, n, eta[:, None])
        tir = pm.dot(refr, refr) < 1e-12
        safe_refr = pm.normalize(torch.where(tir[:, None],
                                             torch.ones_like(refr), refr))
        pass_dir = torch.where(tir[:, None], pm.reflect(d, n), safe_refr)
        trans_tint = torch.where(
            (surf["transmission"] > 0.0).any(-1, keepdim=True),
            surf["transmission"], 1.0)

        new_d = torch.where(pass_through[:, None], pass_dir,
                            torch.where(choose_spec[:, None], spec_dir,
                                        cos_dir))
        branch_beta = torch.where(
            pass_through[:, None], trans_tint,
            torch.where(choose_spec[:, None],
                        torch.clamp(sc / torch.clamp(spca, min=1e-6)[:, None],
                                    0.0, 1.0),
                        surf["albedo"]))
        new_beta = beta * branch_beta
        new_o = p + new_d * GAP

        # NEE from the diffuse branch
        n_shadow = torch.zeros((), dtype=torch.int32, device=o.device)
        diffuse_beta = torch.where((on_surf & choose_diff)[:, None],
                                   beta * surf["albedo"], 0.0)
        if cfg.direct_light and scene.lights.count > 0:
            nee, n_shadow = _nee_contribution(
                scene, cfg, p, n, surf["shading_normal"], diffuse_beta, u,
                order=order)
            radiance = radiance + nee

        new_alive = on_surf & (pm.length(new_beta) > cfg.min_throughput)

        new_o = torch.where(on_surf[:, None], new_o, o)
        new_d = torch.where(on_surf[:, None], new_d, d)
        new_beta = torch.where(on_surf[:, None], new_beta, beta)
        stats = torch.stack([
            alive.sum(dtype=torch.int32),       # lanes entering the bounce
            on_surf.sum(dtype=torch.int32),     # surface interactions
            miss.sum(dtype=torch.int32),        # env terminations
            new_alive.sum(dtype=torch.int32),   # survivors
            n_shadow,                           # NEE shadow lanes
        ])
        return ((new_o, new_d, new_beta, radiance, new_alive, miss_dir,
                 miss_beta), stats)

    return step


def _env_pickup(scene, radiance, miss_dir, miss_beta):
    """The deferred miss-shading env fetch: one bilinear lookup for every
    lane (miss_beta is zero for lanes that never missed).  The JAX
    package also carries each miss's bsdf pdf here for env-NEE MIS, which
    the port does not run yet."""
    return radiance + miss_beta * scene.environment.sample(miss_dir)


def trace(scene, cfg: RenderConfig, o, d, bounce_samples):
    """Trace rays through ``cfg.max_bounces`` bounces.  o, d f32[R,3];
    bounce_samples f32[B,R,11].  Returns (radiance f32[R,3],
    stats i32[B,5])."""
    r = o.shape[0]
    dev = o.device
    carry = (
        o, d,
        torch.ones((r, 3), dtype=torch.float32, device=dev),
        torch.zeros((r, 3), dtype=torch.float32, device=dev),
        torch.ones((r,), dtype=torch.bool, device=dev),
        torch.nn.functional.pad(                              # miss d
            torch.ones((r, 1), device=dev), (2, 0)),
        torch.zeros((r, 3), dtype=torch.float32, device=dev),  # miss beta
    )
    step = make_bounce_step(scene, cfg)
    stats = []
    for b in range(bounce_samples.shape[0]):
        carry, st = step(carry, bounce_samples[b])
        stats.append(st)
    _, _, _, radiance, _, miss_dir, miss_beta = carry
    radiance = _env_pickup(scene, radiance, miss_dir, miss_beta)
    return radiance, torch.stack(stats)


def render_with_samples(scene, camera: Camera, cfg: RenderConfig,
                        cam_samples, bounce_samples,
                        with_stats: bool = False):
    """Deterministic render given explicit uniforms: linear-HDR image
    f32[H,W,3] (mean over spp).  ``with_stats=True`` also returns
    i32[bounces, 5] per-bounce lane counters [entering, surface,
    env-miss, surviving, NEE-shadow]."""
    check_supported(cfg)
    o, d = generate_rays(camera, cfg, cam_samples)
    radiance, stats = trace(scene, cfg, o, d, bounce_samples)
    img = radiance.reshape(cfg.spp, cfg.height, cfg.width, 3).mean(dim=0)
    return (img, stats) if with_stats else img


def render(scene, camera: Camera, cfg: RenderConfig,
           generator: torch.Generator) -> torch.Tensor:
    """Draw the frame's sample arrays from ``generator`` (on the scene's
    device) and render."""
    dev = scene.device
    if cfg.coherent_bounce_sampling:
        cam, bounce = smp.make_coherent_sample_arrays(generator, cfg,
                                                      device=dev)
    else:
        cam, bounce = smp.make_sample_arrays(generator, cfg.n_rays,
                                             cfg.max_bounces, device=dev)
    return render_with_samples(scene, camera, cfg, cam, bounce)
