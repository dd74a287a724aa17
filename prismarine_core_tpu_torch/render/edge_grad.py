"""Edge-sampled visibility (boundary) gradients for primary rays.

The counterpart of ``prismarine_core_tpu.render.edge_grad``.  Autograd
through the detached-visibility estimator (``accel/traverse.py``,
``accel/packet.py``) differentiates only the *interior* term of the
rendering integral: the hit id is frozen, so a silhouette sweeping across
pixels has a derivative of exactly zero.  This module adds the *boundary*
term:

  dI_j/dtheta = interior
              + sum_edges INT_edge (L^- - L^+) (n_perp . dm/dtheta) dl

over the screen projection of every triangle edge (``m`` the
differentiable screen position of an edge point, ``n_perp`` the projected
edge's unit normal, ``L^+/-`` the radiance just off either side).  As in
the JAX package:

1. All ``3T`` soup edges are candidates (no silhouette detection): on an
   interior or hidden edge both side rays land on the same surface and the
   radiance difference vanishes.
2. ``B`` stratified draws on the length CDF of the edges (one cumsum, one
   ``searchsorted``), so the cost is ``B`` radiance pairs whatever the
   edge count.
3. Each draw adds ``w * (phi - phi.detach())`` with ``w`` detached and
   ``phi = n_perp . m(theta)``: the image's value is unchanged and reverse
   mode gains the boundary term in the vertex and camera gradients.

Both side rays share one row of path uniforms, so interior edges cancel
exactly.  The side paths, the receivers' hits and the visibility probes
run under ``torch.no_grad()`` through the configured intersector ("bvh":
the walk kernel; "pallas": the packet query's kernels); only the edge
points, their projections and the splat are on the autograd graph, and
every gather on it is ``take_rows`` (its backward is ``index_add_``).

Differences from the JAX package, all in rounding: the length CDFs are
summed in float64 and rounded once (the env CDF's rule, so the card and
the CPU agree), which moves a draw within an ulp of a CDF step to the
neighbouring edge; the edge multiplicity comes from ``torch.unique`` on
the six endpoint coordinates with -0.0 folded into +0.0 (XLA's sort and
``!=`` treat the two as one key).

Limitations (as in the JAX package): pinhole perspective only (no DOF or
360 camera), primary receivers only, edges crossing the near plane are
skipped.
"""

from __future__ import annotations

import math

import torch

from prismarine_core_tpu_torch.models.camera import Camera
from prismarine_core_tpu_torch.ops import sampling as smp
from prismarine_core_tpu_torch.ops.intersect import intersect_sphere
from prismarine_core_tpu_torch.ops.shade import specular_colour
from prismarine_core_tpu_torch.render.integrator import (
    _interpolate_surface, closest_hit, occluded, render_with_samples,
    surface_kinds, trace_radiance)
from prismarine_core_tpu_torch.utils import math as pm
from prismarine_core_tpu_torch.utils.config import (
    GAP, INF_DIST, SAMPLES_PER_BOUNCE, RenderConfig)

#: screen-space half-offset (pixels) between the two side rays
EDGE_DELTA_PX = 0.03

_NEAR = 1e-4


def project_to_screen(camera: Camera, cfg: RenderConfig, p):
    """Perspective-project world points f32[...,3] to continuous pixel
    coordinates f32[...,2] (origin top-left, +y down: the inverse of
    ``generate_rays``' pinhole branch).  Also returns the camera-z
    f32[...] for near-plane masking."""
    fwd, right, cup = camera.basis()
    rel = p - camera.eye
    z = pm.dot(rel, fwd)
    x = pm.dot(rel, right)
    y = pm.dot(rel, cup)
    zs = torch.where(torch.abs(z) < _NEAR, _NEAR, z)
    tan_half = torch.tan(camera.fov_y * 0.5)
    aspect = cfg.width / cfg.height
    sx = x / (zs * tan_half * aspect)
    sy = y / (zs * tan_half)
    px = (sx + 1.0) * 0.5 * cfg.width
    py = (1.0 - sy) * 0.5 * cfg.height
    return torch.stack([px, py], dim=-1), z


def rays_through_screen(camera: Camera, cfg: RenderConfig, s):
    """Pinhole rays (o, d) f32[N,3] through float pixel coords s f32[N,2]."""
    u = s[:, 0] / cfg.width
    v = s[:, 1] / cfg.height
    fwd, right, cup = camera.basis()
    tan_half = torch.tan(camera.fov_y * 0.5)
    aspect = cfg.width / cfg.height
    sx = (u * 2.0 - 1.0) * tan_half * aspect
    sy = (1.0 - v * 2.0) * tan_half
    d = pm.normalize(fwd + sx[:, None] * right + sy[:, None] * cup)
    return camera.eye.expand(d.shape), d


def make_edge_sample_arrays(generator: torch.Generator, n_edge_samples: int,
                            max_bounces: int, device=None):
    """Uniforms for one boundary-term evaluation: (edge_u f32[B]
    stratified in [0, 1), bounce f32[max_bounces, B, 11])."""
    device = device or generator.device
    strata = (torch.arange(n_edge_samples, dtype=torch.float32, device=device)
              + torch.rand((n_edge_samples,), generator=generator,
                           device=device))
    bounce = torch.rand((max_bounces, n_edge_samples, SAMPLES_PER_BOUNCE),
                        generator=generator, device=device)
    return strata / n_edge_samples, bounce


def _edge_multiplicity(ea, eb, evalid):
    """i32[E]: how many directed edges share each edge's unordered endpoint
    pair.  On a watertight mesh a silhouette edge appears once per
    adjacent triangle, and reversing it flips both n_perp and the radiance
    difference, so the copies add: each carries 1/multiplicity.  Shared
    vertices of a soup are bitwise copies of one source vertex, so the
    count is exact; -0.0 and +0.0 are one key, and invalid (padding) edges
    are keyed to +big so they only meet each other."""
    ea = ea + 0.0       # -0.0 -> +0.0
    eb = eb + 0.0
    swap = ((ea[:, 0] > eb[:, 0])
            | ((ea[:, 0] == eb[:, 0]) & (ea[:, 1] > eb[:, 1]))
            | ((ea[:, 0] == eb[:, 0]) & (ea[:, 1] == eb[:, 1])
               & (ea[:, 2] > eb[:, 2])))[:, None]
    keys = torch.cat([torch.where(swap, eb, ea), torch.where(swap, ea, eb)],
                     dim=1)
    keys = torch.where(evalid[:, None], keys, 3.0e38)
    _, inverse, counts = torch.unique(keys, dim=0, return_inverse=True,
                                      return_counts=True)
    return counts[inverse].to(torch.int32)


def _clip_to_rect(sa, seg, w, h, pad_px=1.0):
    """Liang-Barsky: the parameter range [t0, t1] of each screen segment
    inside the pad-expanded image rectangle (t1 < t0: fully outside), so
    huge near-plane projections do not starve real silhouettes of draws."""
    t0 = torch.zeros(sa.shape[0], dtype=torch.float32, device=sa.device)
    t1 = torch.ones(sa.shape[0], dtype=torch.float32, device=sa.device)
    for axis, lo_b, hi_b in ((0, -pad_px, w + pad_px),
                             (1, -pad_px, h + pad_px)):
        d = seg[:, axis]
        a = sa[:, axis]
        para = torch.abs(d) < 1e-9
        safe = torch.where(para, 1e-9, d)
        c1 = (lo_b - a) / safe
        c2 = (hi_b - a) / safe
        inside = (a >= lo_b) & (a <= hi_b)
        tlo = torch.where(para, torch.where(inside, 0.0, 1.0),
                          torch.minimum(c1, c2))
        thi = torch.where(para, torch.where(inside, 1.0, 0.0),
                          torch.maximum(c1, c2))
        t0 = torch.maximum(t0, tlo)
        t1 = torch.minimum(t1, thi)
    return torch.clamp(t0, 0.0, 1.0), torch.clamp(t1, 0.0, 1.0)


def _soup_edges(soup):
    """All 3T directed edges of the soup: (ea, eb f32[3T,3], valid)."""
    return (torch.cat([soup.v0, soup.v1, soup.v2]),
            torch.cat([soup.v1, soup.v2, soup.v0]), soup.valid.repeat(3))


def _draw_edges(w_len, edge_u):
    """Stratified inverse-CDF draws on the weights ``w_len`` f32[E]: (idx
    int64[B], fraction along the drawn edge's weight, total).  The CDF is
    summed in float64 and rounded once."""
    cdf = torch.cumsum(w_len.double(), 0).float()
    total = cdf[-1]
    targets = edge_u * total
    idx = torch.clamp(torch.searchsorted(cdf, targets, right=True), 0,
                      w_len.shape[0] - 1)
    prev = torch.where(idx > 0, cdf[torch.clamp(idx - 1, min=0)], 0.0)
    frac = torch.clamp((targets - prev)
                       / torch.clamp(w_len[idx], min=1e-12), 0.0, 1.0)
    return idx, frac, total


def _detached(camera: Camera) -> Camera:
    return Camera(eye=camera.eye.detach(), target=camera.target.detach(),
                  up=camera.up.detach(), fov_y=camera.fov_y.detach())


def _splat(cfg: RenderConfig, pix, contrib):
    """Scatter-add contrib f32[B,3] into an f32[H,W,3] image at the pixels
    ``pix`` i32[B,2] (clipped into the image; callers zero the weights of
    samples outside it)."""
    lin = (torch.clamp(pix[:, 1], 0, cfg.height - 1) * cfg.width
           + torch.clamp(pix[:, 0], 0, cfg.width - 1)).long()
    flat = torch.zeros((cfg.height * cfg.width, 3), dtype=contrib.dtype,
                       device=contrib.device).index_add(0, lin, contrib)
    return flat.reshape(cfg.height, cfg.width, 3)


def _attach(cfg, n_perp, m, weight, pix):
    """The value-zero term ``weight * (phi - phi.detach())`` with
    ``phi = n_perp . m``, splatted at ``pix``."""
    phi = n_perp[:, 0] * m[:, 0] + n_perp[:, 1] * m[:, 1]
    return _splat(cfg, pix, weight * (phi - phi.detach())[:, None])


def _in_image(cfg, pix):
    return ((pix[:, 0] >= 0) & (pix[:, 0] < cfg.width)
            & (pix[:, 1] >= 0) & (pix[:, 1] < cfg.height))


def edge_boundary_image(scene, camera: Camera, cfg: RenderConfig, edge_u,
                        bounce_samples, delta_px: float = EDGE_DELTA_PX):
    """Value-zero f32[H,W,3] image carrying the primary-silhouette
    boundary gradient.  Add it to a primal render of the same (scene,
    camera, cfg): the sum's value is unchanged and its gradient gains the
    silhouette term.  ``edge_u`` f32[B]: stratified uniforms on the global
    edge-length CDF; ``bounce_samples`` f32[bounces, B, 11]: path uniforms
    shared by both side rays."""
    assert not cfg.camera_360 and not cfg.dof, (
        "boundary term supports the pinhole perspective camera only")
    assert not cfg.interlace, (
        "boundary term is inconsistent with interlaced primal renders "
        "(gradient would splat onto masked-off parity pixels)")
    B = edge_u.shape[0]
    ea, eb, evalid = _soup_edges(scene.triangles)
    cam_sg = _detached(camera)
    with torch.no_grad():
        mult = _edge_multiplicity(ea, eb, evalid)
        sa, za = project_to_screen(cam_sg, cfg, ea)
        sb, zb = project_to_screen(cam_sg, cfg, eb)
        seg = sb - sa
        # clip each projected segment to the padded image rectangle
        tc0, tc1 = _clip_to_rect(sa, seg, cfg.width, cfg.height)
        use = evalid & (za > _NEAR) & (zb > _NEAR) & (tc1 > tc0)
        length = torch.linalg.norm(seg, dim=-1)
        # CDF weight: visible screen length, split across duplicate copies
        w_len = torch.where(use, length * torch.clamp(tc1 - tc0, min=0.0)
                            / torch.clamp(mult, min=1).float(), 0.0)
        idx, frac_c, total = _draw_edges(w_len, edge_u)
        # map the draw back to the unclipped [0, 1] edge parameterization
        frac = tc0[idx] + frac_c * (tc1[idx] - tc0[idx])
        seg_i = seg[idx]
        e_hat = seg_i / torch.clamp(length[idx], min=1e-12)[:, None]
        n_perp = torch.stack([-e_hat[:, 1], e_hat[:, 0]], dim=-1)

    # differentiable screen position of each sampled edge point
    sa_i, _ = project_to_screen(camera, cfg, pm.take_rows(ea, idx))
    sb_i, _ = project_to_screen(camera, cfg, pm.take_rows(eb, idx))
    m = sa_i + frac[:, None] * (sb_i - sa_i)

    with torch.no_grad():
        # radiance just off both sides
        m_sg = m.detach()
        o_p, d_p = rays_through_screen(cam_sg, cfg, m_sg + delta_px * n_perp)
        o_m, d_m = rays_through_screen(cam_sg, cfg, m_sg - delta_px * n_perp)
        L_p = trace_radiance(scene, cfg, o_p, d_p, bounce_samples)
        L_m = trace_radiance(scene, cfg, o_m, d_m, bounce_samples)
        pix = torch.floor(m_sg).to(torch.int32)
        ok = _in_image(cfg, pix) & (total > 0.0) & (w_len[idx] > 0.0)
        weight = (L_m - L_p) * (total / B) * ok[:, None].float()
    return _attach(cfg, n_perp, m, weight, pix)


def env_sun_params(env, frac: float = 0.25):
    """(sun direction f32[3], integrated radiance f32[3]) of the env map's
    bright region: texels with luminance >= frac * max form the "sun
    disc"; the direction is their luminance-weighted mean, the power the
    solid-angle integral of their radiance (the directional analogue of a
    sphere light's centre)."""
    h, w, _ = env.image.shape
    dev = env.image.device
    rgb = env.image * env.scale
    lum = torch.clamp(rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152
                      + rgb[..., 2] * 0.0722, min=0.0)
    sun = lum >= frac * lum.max()
    theta = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h \
        * math.pi
    phi = ((torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
           - 0.5) * (2.0 * math.pi)
    sin_t = torch.sin(theta)
    # equirect texel solid angle (as textures.sample_env_direction)
    domega = (2.0 * math.pi ** 2 / (h * w)) * sin_t[:, None]     # [h,1]
    dirs = torch.stack(
        [sin_t[:, None] * torch.cos(phi)[None, :],
         torch.cos(theta)[:, None].expand(h, w),
         sin_t[:, None] * torch.sin(phi)[None, :]], dim=-1)      # [h,w,3]
    wgt = torch.where(sun, lum * domega, 0.0)
    s = pm.normalize((dirs * wgt[..., None]).sum(dim=(0, 1)))
    power = (rgb * torch.where(sun, domega, 0.0)[..., None]).sum(dim=(0, 1))
    return s, power


def _shadow_edges(soup, edge_u):
    """Blocker edge draws on the 3D-length CDF split across copies:
    (ea, eb, idx, frac, w_len, total)."""
    ea, eb, evalid = _soup_edges(soup)
    with torch.no_grad():
        mult = _edge_multiplicity(ea, eb, evalid)
        len3 = torch.linalg.norm(eb - ea, dim=-1)
        w_len = torch.where(evalid, len3 / torch.clamp(mult, min=1), 0.0)
        idx, frac, total = _draw_edges(w_len, edge_u)
    return ea, eb, idx, frac, w_len, total


def _receiver_plane(soup, tri):
    """The frozen plane of each receiver triangle: (a vertex, unit
    normal)."""
    trix = torch.clamp(tri, min=0).long()
    v0 = pm.take_rows(soup.v0, trix)
    return v0, pm.normalize(pm.cross(pm.take_rows(soup.v1, trix) - v0,
                                     pm.take_rows(soup.v2, trix) - v0))


def _curve_normal(m_s, m_s2, dt_):
    """The screen tangent's length per unit edge parameter and the unit
    normal of the shadow curve from two of its points."""
    dm = m_s2 - m_s
    dm_len = torch.linalg.norm(dm, dim=-1)
    e_hat = dm / torch.clamp(dm_len, min=1e-12)[:, None]
    return dm_len / dt_, torch.stack([-e_hat[:, 1], e_hat[:, 0]], dim=-1)


def _camera_sees(scene, cam_sg, cfg, m_sg, r_pt, z_cam, p0, n_r):
    """Camera visibility of each receiver point: the camera ray through its
    pixel hits a surface at the projected distance (within 5%) and on the
    receiver's plane (any coplanar triangle: shadow curves crossing a
    mesh's interior edges land on the neighbour for about half their
    draws).  Returns (visible, the camera hit, the camera ray dirs)."""
    o_cam, d_cam = rays_through_screen(cam_sg, cfg, m_sg)
    hit = closest_hit(scene, o_cam, d_cam, cfg)
    same_pt = (torch.abs(hit.t - torch.linalg.norm(r_pt - o_cam, dim=-1))
               < 0.05 * torch.clamp(hit.t, min=1.0))
    cam_pt = o_cam + hit.t[:, None] * d_cam
    on_plane = (torch.abs(pm.dot(cam_pt - p0, n_r))
                < 0.02 * torch.clamp(hit.t, min=1.0))
    return ((hit.tri >= 0) & same_pt & on_plane & (z_cam > _NEAR), hit,
            d_cam)


def _plane_point(cam_sg, cfg, spix, p0, n_r):
    """Where the camera ray through pixel coords ``spix`` meets the
    receiver plane."""
    o_p, d_p = rays_through_screen(cam_sg, cfg, spix)
    dn = pm.dot(d_p, n_r)
    dn = torch.where(torch.abs(dn) < 1e-9, 1e-9, dn)
    return o_p + (pm.dot(p0 - o_p, n_r) / dn)[:, None] * d_p


def _diffuse_prob(scene, cfg, hit, d_cam):
    """The receiver's surface record, its faceforwarded normal and the
    integrator's probability of the diffuse branch there (alpha times one
    minus the specular color's length, ``ops/shade.py:specular_colour``)."""
    surf = _interpolate_surface(scene, hit, cfg, surface_kinds(scene))
    n_ff = pm.faceforward(surf["shading_normal"], d_cam)
    _, spca = specular_colour(d_cam, n_ff, surf["albedo"], surf["metallic"],
                              cfg.ior - 1.0)
    return surf, n_ff, surf["alpha"] * (1.0 - spca)


def shadow_boundary_image(scene, camera: Camera, cfg: RenderConfig, edge_u,
                          delta_px: float = 0.75, light_index: int = 0,
                          light_u=None):
    """Value-zero f32[H,W,3] image carrying the cast-shadow boundary
    gradient of one sphere light: the derivative of NEE visibility with
    respect to a blocker's vertices, which the primary-edge term cannot
    see (the blocker may have no screen silhouette at all).

    Light-space edge sampling: points z on blocker edges (3D-length CDF,
    1/multiplicity) are projected from a light point onto the receiver
    behind them (one detached closest hit) and the value-zero term is
    attached at the screen projection of that shadow-curve point,
    differentiable through z and the light.  The jump across the curve is
    probed: two receiver-plane points just off either side are
    shadow-tested toward the light (V^- - V^+ in {-1, 0, +1}), and its
    magnitude is the receiver's expected NEE contribution P(diffuse) *
    albedo * weight * light colour.

    ``light_index`` picks the sphere light; ``light_u`` f32[B,2]
    (optional) samples a point on the light sphere per draw (penumbra
    averaging for fat lights), None projects from the centre.  Primary
    receivers only; the jump magnitude is evaluated toward the centre."""
    soup = scene.triangles
    B = edge_u.shape[0]
    c = scene.lights.center[light_index]
    radius = scene.lights.radius[light_index]
    # the integrator picks one of L lights with probability 1/L and
    # weights by L: per light the expectation is its colour
    lcolor = scene.lights.color[light_index].detach()
    if light_u is None:
        lp = c.expand(B, 3)
    else:
        lp = c + radius * smp.uniform_sphere(light_u[:, 0], light_u[:, 1])
    ea, eb, idx, frac, w_len, total = _shadow_edges(soup, edge_u)
    ea_i, eb_i = pm.take_rows(ea, idx), pm.take_rows(eb, idx)
    z = ea_i + frac[:, None] * (eb_i - ea_i)
    dz = z - lp
    cam_sg = _detached(camera)
    c_sg, r_sg, lp_sg = c.detach(), radius.detach(), lp.detach()

    with torch.no_grad():
        # detached receiver behind the blocker, and its frozen plane
        dz_n = pm.normalize(dz)
        hit_r = closest_hit(scene, z + GAP * dz_n, dz_n, cfg)
        has_recv = hit_r.tri >= 0
        p0, n_r = _receiver_plane(soup, hit_r.tri)

    denom = pm.dot(dz, n_r)
    denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    s_par = pm.dot(p0 - lp, n_r) / denom
    r_pt = lp + s_par[:, None] * dz                              # diff.
    m_s, z_cam = project_to_screen(camera, cfg, r_pt)            # [B,2]

    with torch.no_grad():
        behind = s_par > 1.0 + 1e-4   # receiver beyond the blocker
        m_sg, r_sg_pt = m_s.detach(), r_pt.detach()
        # tangent from a second point a bit along the edge (backward
        # difference near t = 1: the product is invariant under the
        # n_perp flip, as the visibility jump flips with it)
        dt_ = 1e-3
        shift = torch.where(frac + dt_ <= 1.0, dt_, -dt_)
        z2 = ea_i + (frac + shift)[:, None] * (eb_i - ea_i)
        den2 = pm.dot(z2 - lp_sg, n_r)
        s2 = pm.dot(p0 - lp_sg, n_r) / torch.where(torch.abs(den2) < 1e-9,
                                                   1e-9, den2)
        m_s2, _ = project_to_screen(cam_sg, cfg,
                                    lp_sg + s2[:, None] * (z2 - lp_sg))
        dm_dt, n_perp = _curve_normal(m_sg, m_s2, dt_)

        cam_vis, hit_cam, d_cam = _camera_sees(scene, cam_sg, cfg, m_sg,
                                               r_sg_pt, z_cam, p0, n_r)

        def vis_at(pt):
            # probe toward the sampled light point: its shadow curve
            ldir = pm.normalize(lp_sg - pt)
            t_l = intersect_sphere(pt + ldir * GAP, ldir, c_sg[None, :],
                                   r_sg + GAP)
            t_q = torch.where(has_recv, t_l, 0.0)
            return ~occluded(scene, pt + ldir * GAP, ldir, t_q, cfg)

        v_plus = vis_at(_plane_point(cam_sg, cfg, m_sg + delta_px * n_perp,
                                     p0, n_r))
        v_minus = vis_at(_plane_point(cam_sg, cfg, m_sg - delta_px * n_perp,
                                      p0, n_r))
        jump = v_minus.float() - v_plus.float()

        # expected NEE magnitude at the receiver
        surf, n_ff, p_diff = _diffuse_prob(scene, cfg, hit_cam, d_cam)
        ldir_c = pm.normalize(c_sg[None, :] - r_sg_pt)
        dist = pm.length(c_sg[None, :] - r_sg_pt)
        w_light = smp.light_sampling_weight(ldir_c, n_ff, r_sg, dist)
        front = pm.dot(surf["shading_normal"], ldir_c) >= 0.0
        f_nee = (surf["albedo"] * lcolor[None, :]
                 * (p_diff * w_light * front)[:, None])
        f_nee = torch.where(torch.isfinite(f_nee), f_nee, 0.0)

        pix = torch.floor(m_sg).to(torch.int32)
        use = (has_recv & behind & cam_vis & _in_image(cfg, pix)
               & (total > 0.0) & (w_len[idx] > 0.0))
        weight = (jump[:, None] * f_nee
                  * (total * dm_dt / torch.clamp(w_len[idx], min=1e-12)
                     / B)[:, None] * use[:, None].float())
    return _attach(cfg, n_perp, m_s, weight, pix)


def env_shadow_boundary_image(scene, camera: Camera, cfg: RenderConfig,
                              edge_u, delta_px: float = 0.75,
                              sun_frac: float = 0.25):
    """Value-zero f32[H,W,3] image carrying the env-sun cast-shadow
    boundary gradient (``cfg.env_nee``), the directional counterpart of
    ``shadow_boundary_image``: blocker edge points z project along the
    fixed sun direction ``s`` (``env_sun_params``) onto the frozen
    receiver plane, r(theta) = z(theta) - u * s, differentiable through z
    only.  The jump magnitude is the env estimator's expectation across
    the curve, albedo * P(diffuse) * cos(n, s) / pi * the integrated sun
    radiance (the two strategies' MIS weights sum to 1).

    Approximations (as in the JAX package): the sun disc acts as its
    direction, primary receivers only, the rest of the sky keeps the
    detached estimator."""
    soup = scene.triangles
    B = edge_u.shape[0]
    with torch.no_grad():
        s_sun, power = env_sun_params(scene.environment, frac=sun_frac)
    ea, eb, idx, frac, w_len, total = _shadow_edges(soup, edge_u)
    ea_i, eb_i = pm.take_rows(ea, idx), pm.take_rows(eb, idx)
    z = ea_i + frac[:, None] * (eb_i - ea_i)
    cam_sg = _detached(camera)
    away = (-s_sun).expand(B, 3)

    with torch.no_grad():
        # detached receiver along -s
        hit_r = closest_hit(scene, z + GAP * away, away, cfg)
        has_recv = hit_r.tri >= 0
        p0, n_r = _receiver_plane(soup, hit_r.tri)
        sn = pm.dot(n_r, s_sun)
        sn = torch.where(torch.abs(sn) < 1e-9, 1e-9, sn)

    u_par = pm.dot(z - p0, n_r) / sn
    r_pt = z - u_par[:, None] * s_sun                            # diff.
    m_s, z_cam = project_to_screen(camera, cfg, r_pt)            # [B,2]

    with torch.no_grad():
        in_front_of_sun = u_par > 1e-4   # receiver behind the blocker
        m_sg, r_sg_pt = m_s.detach(), r_pt.detach()
        dt_ = 1e-3
        shift = torch.where(frac + dt_ <= 1.0, dt_, -dt_)
        z2 = ea_i + (frac + shift)[:, None] * (eb_i - ea_i)
        u2_ = pm.dot(z2 - p0, n_r) / sn
        m_s2, _ = project_to_screen(cam_sg, cfg,
                                    z2 - u2_[:, None] * s_sun)
        dm_dt, n_perp = _curve_normal(m_sg, m_s2, dt_)

        cam_vis, hit_cam, d_cam = _camera_sees(scene, cam_sg, cfg, m_sg,
                                               r_sg_pt, z_cam, p0, n_r)
        sdir = s_sun.expand(B, 3)

        def vis_at(pt):
            t_q = torch.where(has_recv, INF_DIST, 0.0)
            return ~occluded(scene, pt + sdir * GAP, sdir, t_q, cfg)

        v_plus = vis_at(_plane_point(cam_sg, cfg, m_sg + delta_px * n_perp,
                                     p0, n_r))
        v_minus = vis_at(_plane_point(cam_sg, cfg, m_sg - delta_px * n_perp,
                                      p0, n_r))
        jump = v_minus.float() - v_plus.float()

        # expected env-NEE magnitude at the receiver
        surf, n_ff, p_diff = _diffuse_prob(scene, cfg, hit_cam, d_cam)
        cos_l = pm.dot(n_ff, s_sun)
        f_sun = (surf["albedo"] * power[None, :]
                 * (p_diff * torch.clamp(cos_l, min=0.0) / math.pi
                    * (cos_l > 0.0))[:, None])
        f_sun = torch.where(torch.isfinite(f_sun), f_sun, 0.0)

        pix = torch.floor(m_sg).to(torch.int32)
        use = (has_recv & in_front_of_sun & cam_vis & _in_image(cfg, pix)
               & (total > 0.0) & (w_len[idx] > 0.0))
        weight = (jump[:, None] * f_sun
                  * (total * dm_dt / torch.clamp(w_len[idx], min=1e-12)
                     / B)[:, None] * use[:, None].float())
    return _attach(cfg, n_perp, m_s, weight, pix)


def boundary_images(scene, camera: Camera, cfg: RenderConfig, edge_u,
                    edge_bounce_samples, shadow_term: bool = False,
                    light_u=None):
    """The sum of the value-zero boundary images: the primary silhouettes
    and, with ``shadow_term``, one cast-shadow term per sphere light
    (under ``cfg.direct_light``) and the env-sun term (under
    ``cfg.env_nee``)."""
    img = edge_boundary_image(scene, camera, cfg, edge_u,
                              edge_bounce_samples)
    if shadow_term:
        if cfg.direct_light:
            for li in range(scene.lights.count):
                img = img + shadow_boundary_image(
                    scene, camera, cfg, edge_u, light_index=li,
                    light_u=light_u)
        if cfg.env_nee:
            img = img + env_shadow_boundary_image(scene, camera, cfg, edge_u)
    return img


def render_with_edge_gradients(scene, camera: Camera, cfg: RenderConfig,
                               cam_samples, bounce_samples, edge_u,
                               edge_bounce_samples, shadow_term: bool = False,
                               light_u=None):
    """Primal render plus the boundary-gradient attachments.  The value
    equals ``render_with_samples(...)`` exactly; reverse mode also
    differentiates silhouette motion with respect to the vertices and the
    camera.  ``shadow_term=True`` adds the cast-shadow terms (one per
    sphere light, ``light_u`` f32[B,2] optionally sampling the light
    spheres, and under ``cfg.env_nee`` the env-sun term)."""
    img = render_with_samples(scene, camera, cfg, cam_samples,
                              bounce_samples)
    return img + boundary_images(scene, camera, cfg, edge_u,
                                 edge_bounce_samples, shadow_term, light_u)
