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
    light chosen by the reserved uniform, and with ``cfg.env_nee`` one
    toward the environment (balance-heuristic MIS with the miss pickup).

Textured scenes modulate albedo, emissive and the specular terms by their
texture fetches and perturb the shading normal by the bump map.  With
``cfg.rr_start_bounce`` Russian roulette retires lanes from that bounce on
(survivors reweighted by 1/q); an ``active`` mask (interlacing) retires
lanes before the first bounce.

The port runs every intersector of the JAX package: ``"brute"`` (the
oracle; on a scene laid out by ``shard_scene(shard_triangles=True)`` over
the mesh's triangle ranges), ``"bvh"`` (the default: the skip-link walk,
``accel/traverse.py``), ``"packet"`` (the tile-frustum packet query),
``"pallas"`` (the packet query on the hand-written kernels, with every
knob) and ``"pallas_sharded"`` (the packet query over ``cfg.mesh``'s
superblock ranges, ``parallel/shard_intersect.py``, whose winning shard
carries the hit's surface fields to shading).  Under "pallas", ``trace``
peels bounce 0 off for ``primary_identity`` / ``primary_tile_order`` (no
coherence sort for the camera rays) and ``reuse_bounce_order`` (one sort
after bounce 0 for every later bounce); "pallas_sharded" ignores those
three flags, as the JAX package does.
"""

from __future__ import annotations

import math

import torch

from prismarine_core_tpu_torch.models.camera import (
    Camera, generate_rays, tile_order_active, tile_pixel_inv_perm,
    tile_pixel_perm)
from prismarine_core_tpu_torch.models.textures import (
    env_pdf, sample_env_direction)
from prismarine_core_tpu_torch.ops import sampling as smp
from prismarine_core_tpu_torch.ops.intersect import (
    Hit, intersect_closest_brute, occluded_brute)
from prismarine_core_tpu_torch.ops.shade import (
    Spec, nee_resolve, shade, shade_inputs)
from prismarine_core_tpu_torch.ops.surface import surface_fields, unit_or
from prismarine_core_tpu_torch.ops.texture import texture_fields, untextured
from prismarine_core_tpu_torch.utils import math as pm
from prismarine_core_tpu_torch.utils.config import (
    GAP, INF_DIST, RenderConfig, check_supported)
from prismarine_core_tpu_torch.utils.profiling import span, spanned


def _pallas_kwargs(cfg: RenderConfig, any_hit: bool) -> dict:
    """RenderConfig's packet-query knobs as ``_run_packet_pallas``
    kwargs."""
    kw = dict(cull_impl=(cfg.anyhit_cull_impl or cfg.cull_impl) if any_hit
              else cfg.cull_impl,
              sort_mode=cfg.sort_mode, recull=cfg.recull,
              kernel_form=cfg.kernel_form, near_frac=cfg.near_frac,
              stale_round_masks=cfg.stale_round_masks)
    strat = cfg.anyhit_strategy if any_hit else cfg.closest_strategy
    k = cfg.anyhit_k if any_hit else cfg.closest_k
    if strat:
        kw["strategy"] = strat
    if k:
        kw["k_round"] = k
    return kw


def _need_bvh(scene):
    if scene.bvh is None:
        raise ValueError(
            "cfg.intersector='bvh' but scene.bvh is None — build it "
            "with scene.with_bvh() (Scene.assemble does by default)")


def _need_packets(scene):
    if scene.packets is None:
        raise ValueError("scene.packets is None — build with "
                         "scene.with_bvh()")


@spanned("pc.query.closest")
def closest_hit(scene, o, d, cfg: RenderConfig, t_cap=None,
                with_order: bool = False, order=None,
                with_surface: bool = False):
    """Closest hit through the configured intersector.  ``t_cap`` zeroes
    lanes whose result is unused (the "pallas" queries drop them, and the
    "bvh" walk ends them before their first step; "packet", as in the JAX
    package, runs every lane to INF_DIST);
    ``with_order`` also returns the "pallas" queries' coherence sort (None
    for the others) for the same bounce's shadow query, and ``order``
    passes one in (a bounce's fixed order, or "identity");
    ``with_surface`` (with ``with_order``) also returns the
    "pallas_sharded" query's carried surface fields (None on the other
    intersectors, which shade from the soup)."""
    carried = None
    if cfg.intersector == "brute":
        if scene.shard_triangles:
            from prismarine_core_tpu_torch.parallel.mesh import (
                brute_closest_over_ranges)
            hit = brute_closest_over_ranges(scene, o, d, cfg.tri_block)
        else:
            hit = intersect_closest_brute(scene.triangles, o, d,
                                          block=cfg.tri_block)
        order = None
    elif cfg.intersector == "bvh":
        from prismarine_core_tpu_torch.accel.traverse import (
            intersect_closest_bvh)
        _need_bvh(scene)
        hit, order = intersect_closest_bvh(
            scene.bvh, scene.triangles, o, d, chunk=cfg.traverse_chunk,
            sort=cfg.sort_rays, t_cap=t_cap), None
    elif cfg.intersector == "packet":
        from prismarine_core_tpu_torch.accel import packet as pk
        _need_packets(scene)
        hit, order = pk.intersect_closest_packet(
            scene.bvh, scene.packets, scene.triangles, o, d), None
    elif cfg.intersector == "pallas":
        from prismarine_core_tpu_torch.accel import packet as pk
        _need_packets(scene)
        hit, order = pk.intersect_closest_pallas(
            scene.bvh, scene.packets, scene.triangles, o, d, t_cap=t_cap,
            return_order=True, order=order,
            **_pallas_kwargs(cfg, any_hit=False))
    elif cfg.intersector == "pallas_sharded" and cfg.mesh is not None:
        from prismarine_core_tpu_torch.parallel.shard_intersect import (
            sharded_intersect_closest)
        hit, carried, order = sharded_intersect_closest(
            cfg.mesh, scene.packets, o, d, t_cap=t_cap, return_surface=True,
            return_order=True, query_kw=_pallas_kwargs(cfg, any_hit=False))
    else:
        check_supported(cfg)
        raise AssertionError("unreachable")
    if with_order and with_surface:
        return hit, order, carried
    return (hit, order) if with_order else hit


@spanned("pc.query.shadow")
def occluded(scene, o, d, t_max, cfg: RenderConfig, order=None):
    """Any-hit query through the configured intersector."""
    if cfg.intersector == "brute":
        if scene.shard_triangles:
            from prismarine_core_tpu_torch.parallel.mesh import (
                brute_occluded_over_ranges)
            return brute_occluded_over_ranges(scene, o, d, t_max,
                                              cfg.tri_block)
        return occluded_brute(scene.triangles, o, d, t_max,
                              block=cfg.tri_block)
    if cfg.intersector == "bvh":
        from prismarine_core_tpu_torch.accel.traverse import occluded_bvh
        _need_bvh(scene)
        return occluded_bvh(scene.bvh, scene.triangles, o, d, t_max,
                            chunk=cfg.traverse_chunk, sort=cfg.sort_rays)
    if cfg.intersector == "packet":
        from prismarine_core_tpu_torch.accel import packet as pk
        _need_packets(scene)
        return pk.occluded_packet(scene.bvh, scene.packets, scene.triangles,
                                  o, d, t_max)
    if cfg.intersector == "pallas":
        from prismarine_core_tpu_torch.accel import packet as pk
        return pk.occluded_pallas(scene.bvh, scene.packets, scene.triangles,
                                  o, d, t_max, order=order,
                                  **_pallas_kwargs(cfg, any_hit=True))
    if cfg.intersector == "pallas_sharded" and cfg.mesh is not None:
        from prismarine_core_tpu_torch.parallel.shard_intersect import (
            sharded_occluded)
        return sharded_occluded(cfg.mesh, scene.packets, o, d, t_max,
                                order=order,
                                query_kw=_pallas_kwargs(cfg, any_hit=True))
    check_supported(cfg)
    raise AssertionError("unreachable")


@spanned("pc.surface")
def _interpolate_surface(scene, hit: Hit, cfg: RenderConfig, kinds=None,
                         carried: dict | None = None):
    """Per-ray surface fields at the hit (garbage where missed — callers
    mask): shading/geometric normals, uv, material record with its
    texture modulations.  ``kinds``: the materials' ``kinds_bound``
    (needed for a textured scene); a kind no material binds skips its
    whole fetch and filter chain, and the texture-less stub stack skips
    uv, the tangent frame and every fetch.  The fields at the hit come
    from the soup through ``ops/surface.py:surface_fields`` (one kernel
    launch on a CUDA card) or, with ``carried``, from the sharded query's
    interpolated fields (ns, ng, tang, uv, mat_id; the soup is a husk on
    a distributed scene).  The bound kinds' fetches and their use come
    from ``ops/texture.py:texture_fields`` (one kernel launch on a CUDA
    card), inside one span ``pc.texture.fetch``; its plain version runs
    each kind inside a span of its own, ``pc.texture.<kind>``."""
    if carried is not None:
        ng = pm.normalize(carried["ng"])
        ns = unit_or(carried["ns"], ng)
        uv = carried["uv"]
        mat = scene.materials.lookup(carried["mat_id"].long())
        tang = unit_or(carried["tang"], 0.0)
    else:
        ns, ng, uv, tang, mat = surface_fields(scene, hit, kinds)
    if getattr(scene.textures, "stub", False) or not any(kinds):
        ns, albedo4, emissive, rough, metal = untextured(ns, mat)
    else:
        with span("pc.texture.fetch"):
            ns, albedo4, emissive, rough, metal = texture_fields(
                scene.textures, cfg.texture_filter, kinds, ns, tang, uv, mat)
    return dict(
        shading_normal=ns,
        geom_normal=ng,
        uv=uv,
        albedo=albedo4[:, :3],
        alpha=albedo4[:, 3],
        roughness=rough,
        metallic=metal,
        emissive=emissive,
        transmission=mat.transmission[:, :3],
        ior=mat.ior,
    )


@spanned("pc.nee")
def _env_nee_contribution(scene, cfg: RenderConfig, p, n, diffuse_beta, u,
                          order=None):
    """NEE toward the environment's bright texels (``cfg.env_nee``): one
    direction from the luminance distribution, a shadow query to
    infinity, balance-heuristic weight pdf_env / (pdf_env + pdf_cos).
    The matching pdf_cos / (pdf_cos + pdf_env) weights the miss pickup
    of the next bounce (``_env_pickup``), so the sum stays unbiased.
    Returns (contribution f32[R,3], env shadow lanes i32)."""
    env = scene.environment
    ldir, pdf_e = sample_env_direction(env, u[:, smp.S_ENV1],
                                       u[:, smp.S_ENV2])
    cos_l = pm.dot(ldir, n)
    pdf_c = torch.clamp(cos_l, min=0.0) / math.pi
    w_mis = pdf_e / torch.clamp(pdf_e + pdf_c, min=1e-20)
    # gate on the faceforwarded normal the cosine lobe samples around
    need = (cos_l > 0.0) & (pdf_e > 0.0) & (diffuse_beta > 0.0).any(-1)
    shadow_o = p + ldir * GAP
    t_query = torch.where(need, INF_DIST, 0.0)
    occ = occluded(scene, shadow_o, ldir, t_query, cfg, order=order)
    env_l = env.sample(ldir)
    # f / pdf of the lambertian (albedo / pi * cos / pdf_env), MIS-weighted
    fac = (cos_l / math.pi) / torch.clamp(pdf_e, min=1e-20) * w_mis
    contrib = torch.where((need & ~occ)[:, None],
                          diffuse_beta * env_l * fac[:, None], 0.0)
    return contrib, need.sum(dtype=torch.int32)


def surface_kinds(scene):
    """The ``kinds`` argument of ``_interpolate_surface`` for ``scene``:
    None on the texture-less stub stack, else the materials'
    ``kinds_bound`` (one host sync)."""
    if getattr(scene.textures, "stub", False):
        return None
    with span("pc.sync.kinds"):
        return scene.materials.kinds_bound


def make_bounce_step(scene, cfg: RenderConfig, fixed_order=None):
    """The per-bounce step: (carry, u f32[R,11]) -> (carry, stats i32[5]).
    The carry is (o, d, beta, radiance, alive, prev_pdf, miss_dir,
    miss_beta, miss_pdf, bounce index); the two pdfs (the bsdf pdf of each
    lane's last continuation, and of its miss) feed env-NEE MIS and stay
    zero without ``cfg.env_nee``; the bounce index (a Python int) turns
    Russian roulette on.  ``fixed_order``: the closest query's ray order
    instead of its own coherence sort ("identity", or a (perm, inv_perm)
    of ``reuse_bounce_order``; "pallas" only)."""
    kinds = surface_kinds(scene)

    @spanned("pc.bounce")
    def step(carry, u):
        o, d, alive, bounce_i = carry[0], carry[1], carry[4], carry[9]
        t_cap = torch.where(alive, INF_DIST, 0.0)
        hit, order, carried = closest_hit(scene, o, d, cfg, t_cap=t_cap,
                                          with_order=True, order=fixed_order,
                                          with_surface=True)
        surf = _interpolate_surface(scene, hit, cfg, kinds, carried)
        # the miss record, the bsdf, the branch choice, the continuation,
        # the sphere-light NEE set-up, Russian roulette and the carry:
        # one kernel launch on a CUDA card (ops/shade.py)
        sh = shade(Spec.of(cfg, scene.lights.count, bounce_i),
                   *shade_inputs(carry, hit, surf, u, scene.lights))
        radiance, stats = sh.radiance, sh.counts
        if sh.factor is not None:
            with span("pc.nee"):
                occ = occluded(scene, sh.shadow_o, sh.ldir, sh.t_query, cfg,
                               order=order)
                radiance = nee_resolve(radiance, sh.factor, occ)
        if cfg.env_nee:
            env_nee, n_env_shadow = _env_nee_contribution(
                scene, cfg, sh.p, sh.n, sh.diffuse_beta, u, order=order)
            radiance = radiance + env_nee
            stats = torch.cat([stats[:4], (stats[4] + n_env_shadow)[None]])
        return ((sh.o, sh.d, sh.beta, radiance, sh.alive, sh.prev_pdf,
                 sh.miss_dir, sh.miss_beta, sh.miss_pdf, bounce_i + 1), stats)

    return step


@spanned("pc.env")
def _env_pickup(scene, cfg: RenderConfig, radiance, miss_dir, miss_beta,
                miss_pdf):
    """The deferred miss-shading env fetch: one bilinear lookup for every
    lane (miss_beta is zero for lanes that never missed).  Under
    ``cfg.env_nee`` the recorded bsdf pdf gives the miss its
    balance-heuristic weight against env NEE."""
    env = scene.environment.sample(miss_dir)
    if cfg.env_nee:
        pdf_e = env_pdf(scene.environment, miss_dir)
        w_miss = torch.where(
            miss_pdf > 0.0,
            miss_pdf / torch.clamp(miss_pdf + pdf_e, min=1e-20), 1.0)
        env = env * w_miss[:, None]
    return radiance + miss_beta * env


def initial_carry(o, d, active=None):
    """The bounce loop's carry for camera rays o, d f32[R,3]: unit
    throughput, no radiance, every lane alive (or the lanes of ``active``
    bool[R]), delta (zero) pdfs, bounce 0."""
    r = o.shape[0]
    dev = o.device
    return (
        o, d,
        torch.ones((r, 3), dtype=torch.float32, device=dev),
        torch.zeros((r, 3), dtype=torch.float32, device=dev),
        (torch.ones((r,), dtype=torch.bool, device=dev) if active is None
         else active),
        torch.zeros((r,), dtype=torch.float32, device=dev),   # prev pdf
        torch.nn.functional.pad(                              # miss d
            torch.ones((r, 1), device=dev), (2, 0)),
        torch.zeros((r, 3), dtype=torch.float32, device=dev),  # miss beta
        torch.zeros((r,), dtype=torch.float32, device=dev),   # miss pdf
        0,                                                     # bounce
    )


def interlace_mask(cfg: RenderConfig, stage, device=None) -> torch.Tensor:
    """Checkerboard pixel mask bool[H,W] of interlaced rendering: pixel
    (x, y) is active when (x + y) % 2 != stage % 2."""
    x = torch.arange(cfg.width, device=device)[None, :]
    y = torch.arange(cfg.height, device=device)[:, None]
    return ((x + y) % 2) != (stage % 2)


def trace(scene, cfg: RenderConfig, o, d, bounce_samples, active=None):
    """Trace rays through ``cfg.max_bounces`` bounces.  o, d f32[R,3];
    bounce_samples f32[B,R,11]; ``active`` bool[R] optionally masks lanes
    off from the start (interlacing; under "pallas" they query with
    t_cap 0, as dead lanes do).  Under "pallas", ``primary_identity`` (or
    an active ``primary_tile_order``) runs bounce 0 in the rays' own order
    and ``reuse_bounce_order`` sorts once after bounce 0 (``sort_mode``,
    every lane live) for every later bounce.  Returns (radiance f32[R,3],
    stats i32[B,5])."""
    carry = initial_carry(o, d, active)
    is_pallas = cfg.intersector == "pallas"
    primary_ident = is_pallas and (cfg.primary_identity
                                   or tile_order_active(cfg))
    reuse = is_pallas and cfg.reuse_bounce_order
    step = make_bounce_step(scene, cfg, fixed_order="identity"
                            if primary_ident else None)
    stats = []
    for b in range(bounce_samples.shape[0]):
        carry, st = step(carry, bounce_samples[b])
        stats.append(st)
        if b == 0 and (primary_ident or reuse) and bounce_samples.shape[0] > 1:
            # bounce 0 peeled off: later bounces sort their own rays, or
            # all reuse one sort of bounce 1's origins and directions
            order = None
            if reuse:
                from prismarine_core_tpu_torch.accel import packet as pk
                o1, d1 = carry[0].detach(), carry[1].detach()
                with span("pc.sort"):
                    order = pk._coherence_perm(
                        scene.bvh.lo[0].detach(), scene.bvh.hi[0].detach(),
                        o1, d1, torch.ones(o1.shape[0], device=o1.device),
                        cfg.sort_mode)
            step = make_bounce_step(scene, cfg, fixed_order=order)
    _, _, _, radiance, _, _, miss_dir, miss_beta, miss_pdf, _ = carry
    radiance = _env_pickup(scene, cfg, radiance, miss_dir, miss_beta,
                           miss_pdf)
    return radiance, torch.stack(stats)


def trace_radiance(scene, cfg: RenderConfig, o, d, bounce_samples,
                   active=None):
    """``trace``'s radiance alone."""
    return trace(scene, cfg, o, d, bounce_samples, active)[0]


@spanned("pc.camera")
def primary_rays(camera: Camera, cfg: RenderConfig, cam_samples,
                 interlace_stage=0):
    """The frame's camera rays in lane order and their live mask: (o, d
    f32[R,3], active bool[R] or None without ``cfg.interlace``).  With an
    active ``primary_tile_order`` the lanes are in 16x8-pixel-tile order,
    the interlace mask with them."""
    o, d = generate_rays(camera, cfg, cam_samples)
    if not cfg.interlace:
        return o, d, None
    mask = interlace_mask(cfg, interlace_stage, device=o.device).reshape(-1)
    if tile_order_active(cfg):
        mask = mask[tile_pixel_perm(cfg, o.device)]
    return o, d, mask.repeat(cfg.spp)


@spanned("pc.image")
def radiance_image(cfg: RenderConfig, radiance) -> torch.Tensor:
    """Lane-order radiance f32[R,3] of ``primary_rays``' lanes as the image
    f32[H,W,3] (mean over spp): an active ``primary_tile_order``'s lanes
    put back in pixel order first."""
    if tile_order_active(cfg):
        radiance = radiance.reshape(cfg.spp, -1, 3)[
            :, tile_pixel_inv_perm(cfg, radiance.device)]
    return radiance.reshape(cfg.spp, cfg.height, cfg.width, 3).mean(dim=0)


def render_with_samples(scene, camera: Camera, cfg: RenderConfig,
                        cam_samples, bounce_samples, interlace_stage=0,
                        with_stats: bool = False):
    """Deterministic render given explicit uniforms: linear-HDR image
    f32[H,W,3] (mean over spp).  With ``cfg.interlace`` the pixels of the
    inactive checkerboard parity of ``interlace_stage`` come back zero.
    ``with_stats=True`` also returns i32[bounces, 5] per-bounce lane
    counters [entering, surface, env-miss, surviving, NEE-shadow].  With
    an active ``primary_tile_order`` the lanes run in 16x8-pixel-tile
    order and the radiance is put back in pixel order once, at the end."""
    check_supported(cfg)
    with span("pc.frame"):
        o, d, active = primary_rays(camera, cfg, cam_samples,
                                    interlace_stage)
        radiance, stats = trace(scene, cfg, o, d, bounce_samples, active)
        img = radiance_image(cfg, radiance)
    return (img, stats) if with_stats else img


def render(scene, camera: Camera, cfg: RenderConfig,
           generator: torch.Generator, interlace_stage=0) -> torch.Tensor:
    """Draw the frame's sample arrays from ``generator`` (on the scene's
    device) and render."""
    dev = scene.device
    if cfg.coherent_bounce_sampling:
        cam, bounce = smp.make_coherent_sample_arrays(generator, cfg,
                                                      device=dev)
    else:
        cam, bounce = smp.make_sample_arrays(generator, cfg.n_rays,
                                             cfg.max_bounces, device=dev)
    return render_with_samples(scene, camera, cfg, cam, bounce,
                               interlace_stage)
