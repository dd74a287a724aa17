"""The bounce loop's shading: the kernel wrappers and their plain versions.

``shade`` does a bounce's per-lane work between the surface at the hit and
the shadow query: the miss record, the hit point and the face-forwarded
normal, the emissive pickup, the specular colour model, the three branch
coins, the continuation directions, the throughput, the sphere-light NEE
set-up (the light pick, the point on the sphere, its weight, the sphere
test and the shadow ray), the env-NEE bsdf pdf, the throughput cut and
Russian roulette, and the masked carry update, with the bounce's five lane
counts.  ``nee_resolve`` adds the NEE factor of each lane whose shadow ray
is not occluded.  On CUDA tensors each launches a hand-written kernel
(``csrc/shade.cu``: ``shade_kernel``, ``nee_resolve_kernel``); on CPU
tensors each runs its plain version (``shade_plain``,
``nee_resolve_plain``), the torch code the bounce loop held before, which
the kernels compute bit for bit.  ``ops/dispatch.py`` chooses between
them, and a gradient through a kernel is the plain version's: its
``_Fused``'s backward runs the plain version again on the saved inputs and
differentiates it.

The plain version differs from that torch code in what a lane off a
surface hands the shadow queries: its own ray (o, d) as the shadow ray and
as the env-NEE point and normal, where the torch code handed them values
computed from the garbage surface of a missed or dead lane.  Its t_query
is 0 either way, so no query reads them; the kernel then reads nothing of
such a lane but what it copies through.

The kernels are the port's own: the JAX package shades in XLA, which fuses
the same elementwise work.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import typing

import torch

from prismarine_core_tpu_torch import _build
from prismarine_core_tpu_torch.ops import dispatch
from prismarine_core_tpu_torch.ops import sampling as smp
from prismarine_core_tpu_torch.ops.intersect import intersect_sphere
from prismarine_core_tpu_torch.utils import math as pm
from prismarine_core_tpu_torch.utils.config import GAP, INF_DIST
from prismarine_core_tpu_torch.utils.profiling import span

#: the tensors ``shade`` reads, in the order of the kernel's input
#: pointers (``csrc/shade.cu``: ``In``) and of the seam's inputs: the
#: carry, the hit, the surface's fields, the bounce's uniforms f32[R,11]
#: and the sphere-light table
INPUTS = ("o", "d", "beta", "radiance", "alive", "prev_pdf", "miss_dir",
          "miss_beta", "miss_pdf", "t", "tri", "ns", "albedo", "alpha",
          "roughness", "metallic", "emissive", "transmission", "ior", "u",
          "l_center", "l_radius", "l_color")
#: what ``shade`` gives, in the order of the kernel's output pointers
#: (``Out``): the next carry, the sphere-NEE shadow ray and factor (None
#: without sphere NEE), the env-NEE point, normal and diffuse throughput
#: (None without env NEE), the lane counts i32[5] (entering, surface,
#: env miss, surviving, NEE shadow lanes)
OUTPUTS = ("o", "d", "beta", "radiance", "alive", "prev_pdf", "miss_dir",
           "miss_beta", "miss_pdf", "shadow_o", "ldir", "t_query", "factor",
           "p", "n", "diffuse_beta", "counts")
Shaded = typing.NamedTuple("Shaded", [(k, typing.Any) for k in OUTPUTS])
#: outputs that are their input unchanged without env NEE (the pdfs)
_THROUGH = ("prev_pdf", "miss_pdf")

#: ``torch.pow(x, e)``'s CUDA routes for a Python float e (ATen: a fill
#: at 0, a copy at 1, sqrt, rsqrt and reciprocal at 0.5, -0.5 and -1,
#: then at e rounded to float32 x*x, x*x*x, 1/(x*x) in double at 2, 3
#: and -2, else powf); the kernel takes the same one
(POW_POWF, POW_ONE, POW_COPY, POW_SQRT, POW_RSQRT, POW_RECIP, POW_SQUARE,
 POW_CUBE, POW_INV_SQUARE) = range(9)
#: ``flags`` bits of the kernel: sphere NEE, env NEE, Russian roulette
F_NEE, F_ENV, F_RR = 1, 2, 4


@dataclasses.dataclass(frozen=True)
class Spec:
    """What a bounce's shading does beyond its tensors: sphere-light NEE
    (``cfg.direct_light`` and a light in the scene), env NEE, Russian
    roulette at this bounce, and the config's constants."""
    nee: bool
    env_nee: bool
    rr: bool
    ior_exp: float          # cfg.ior - 1.0, the exponent of cosmag
    min_throughput: float
    rr_min_q: float

    @staticmethod
    def of(cfg, n_lights: int, bounce_i: int) -> "Spec":
        return Spec(nee=bool(cfg.direct_light and n_lights > 0),
                    env_nee=bool(cfg.env_nee),
                    rr=0 < cfg.rr_start_bounce <= bounce_i,
                    ior_exp=cfg.ior - 1.0,
                    min_throughput=cfg.min_throughput,
                    rr_min_q=cfg.rr_min_q)


def pow_route(e: float):
    """(route, float32 exponent) of ``x ** e`` on a float32 CUDA tensor."""
    if e == 0.0:
        return POW_ONE, 0.0
    if e == 1.0:
        return POW_COPY, 1.0
    for v, route in ((0.5, POW_SQRT), (-0.5, POW_RSQRT), (-1.0, POW_RECIP)):
        if e == v:
            return route, v
    ef = float(torch.tensor(e, dtype=torch.float32))
    return {2.0: POW_SQUARE, 3.0: POW_CUBE, -2.0: POW_INV_SQUARE}.get(
        ef, POW_POWF), ef


# ------------------------------------------------------------ plain version


def _shade_plain(spec: Spec, o, d, beta, radiance, alive, prev_pdf,
                 miss_dir, miss_beta, miss_pdf, t, tri, ns, albedo, alpha,
                 roughness, metallic, emissive, transmission, ior, u,
                 l_center, l_radius, l_color):
    """``shade``'s outputs in torch, in ``OUTPUTS`` order, None for what
    ``spec`` leaves out and for the pdfs that pass through unchanged."""
    # deferred env pickup: record (direction, throughput, bsdf pdf) at the
    # miss, fetch once after the loop
    missed = tri < 0
    miss = alive & missed
    miss_dir = torch.where(miss[:, None], d, miss_dir)
    miss_beta = torch.where(miss[:, None], beta, miss_beta)
    new_miss_pdf = (torch.where(miss, prev_pdf, miss_pdf) if spec.env_nee
                    else None)

    on_surf = alive & ~missed
    p = o + t[:, None] * d
    n = pm.faceforward(ns, d)

    radiance = radiance + torch.where(on_surf[:, None], beta * emissive, 0.0)

    sc, spca = specular_colour(d, n, albedo, metallic, spec.ior_exp)

    # branch coins
    prom = 1.0 - alpha
    pass_through = u[:, smp.S_ALPHA] < prom
    choose_spec = ~pass_through & (u[:, smp.S_SPEC] < spca)
    choose_diff = ~pass_through & ~choose_spec

    # continuation directions
    cos_dir = smp.cosine_hemisphere(n, u[:, smp.S_COS1], u[:, smp.S_COS2])
    gloss = torch.clamp(roughness * u[:, smp.S_GLOSS], 0.0, 1.0)[:, None]
    spec_dir = pm.normalize(pm.mix(pm.reflect(d, n), cos_dir, gloss))

    # pass-through refracts (eta from entering / exiting); total internal
    # reflection falls back to the mirror direction
    entering = pm.dot(d, ns) < 0.0
    eta = torch.where(entering, 1.0 / ior, ior)
    refr = pm.refract(d, n, eta[:, None])
    tir = pm.dot(refr, refr) < 1e-12
    safe_refr = pm.normalize(torch.where(tir[:, None],
                                         torch.ones_like(refr), refr))
    pass_dir = torch.where(tir[:, None], pm.reflect(d, n), safe_refr)
    trans_tint = torch.where((transmission > 0.0).any(-1, keepdim=True),
                             transmission, 1.0)

    new_d = torch.where(pass_through[:, None], pass_dir,
                        torch.where(choose_spec[:, None], spec_dir, cos_dir))
    branch_beta = torch.where(
        pass_through[:, None], trans_tint,
        torch.where(choose_spec[:, None],
                    torch.clamp(sc / torch.clamp(spca, min=1e-6)[:, None],
                                0.0, 1.0),
                    albedo))
    new_beta = beta * branch_beta
    new_o = p + new_d * GAP

    # NEE from the diffuse branch
    n_shadow = torch.zeros((), dtype=torch.int32, device=o.device)
    diffuse_beta = torch.where((on_surf & choose_diff)[:, None],
                               beta * albedo, 0.0)
    shadow_o = ldir = t_query = factor = None
    if spec.nee:
        shadow_o, ldir, t_query, factor, need = _nee_setup(
            p, n, ns, diffuse_beta, u, l_center, l_radius, l_color)
        n_shadow = need.sum(dtype=torch.int32)
        # a lane off a surface hands the query its own ray (t_query 0)
        shadow_o = torch.where(on_surf[:, None], shadow_o, o)
        ldir = torch.where(on_surf[:, None], ldir, d)
    new_prev_pdf = None
    if spec.env_nee:
        # the continuation's bsdf pdf: cosine for diffuse lanes, 0 (a
        # delta) for specular and pass-through ones
        new_prev_pdf = torch.where(
            choose_diff & on_surf,
            torch.clamp(pm.dot(new_d, n), min=0.0) / math.pi, 0.0)

    new_alive = on_surf & (pm.length(new_beta) > spec.min_throughput)

    # Russian roulette: survive with probability q = clamp(max channel of
    # throughput, rr_min_q, 1), survivors reweighted by 1/q (unbiased)
    if spec.rr:
        q = torch.clamp(new_beta.amax(dim=-1), spec.rr_min_q, 1.0)
        survive = u[:, smp.S_RR] < q
        new_alive = new_alive & survive
        new_beta = torch.where(survive[:, None], new_beta / q[:, None],
                               new_beta)

    new_o = torch.where(on_surf[:, None], new_o, o)
    new_d = torch.where(on_surf[:, None], new_d, d)
    new_beta = torch.where(on_surf[:, None], new_beta, beta)
    counts = torch.stack([
        alive.sum(dtype=torch.int32),       # lanes entering the bounce
        on_surf.sum(dtype=torch.int32),     # surface interactions
        miss.sum(dtype=torch.int32),        # env terminations
        new_alive.sum(dtype=torch.int32),   # survivors
        n_shadow,                           # NEE shadow lanes
    ])
    env = ((torch.where(on_surf[:, None], p, o),
            torch.where(on_surf[:, None], n, d), diffuse_beta)
           if spec.env_nee else (None, None, None))
    return (new_o, new_d, new_beta, radiance, new_alive, new_prev_pdf,
            miss_dir, miss_beta, new_miss_pdf, shadow_o, ldir, t_query,
            factor, *env, counts)


def specular_colour(d, n, albedo, metallic, ior_exp: float):
    """The specular colour model at a hit, the bounce loop's and
    ``render/edge_grad.py:_diffuse_prob``'s: the dielectric reflectance
    from the cosine of ``d`` with the face-forwarded normal ``n`` raised
    to ``ior_exp`` (cfg.ior - 1), mixed toward the albedo by
    sqrt(metallic).
    Returns (sc f32[R,3], spca f32[R], its length clamped to [0, 1])."""
    cosmag = torch.clamp(
        torch.clamp(torch.abs(pm.dot(d, n)), min=1e-6) ** ior_exp, 0.0, 1.0)
    dielectric = pm.mix(torch.ones_like(d), torch.full_like(d, 0.05),
                        cosmag[:, None])
    sc = pm.mix(dielectric, albedo,
                torch.sqrt(torch.clamp(metallic, 0.0, 1.0))[:, None])
    return sc, torch.clamp(pm.length(sc), 0.0, 1.0)


def _nee_setup(p, n, ns_raw, diffuse_beta, u, center_t, radius_t, color_t):
    """Next-event estimation toward one uniformly chosen sphere light, up
    to its shadow query: a point inside the sphere, the reference's weight
    heuristic, the raw shading normal's gate.  Returns (shadow_o, ldir,
    t_query, factor, need): lanes with no possible contribution get
    t_query 0 (the packet query then gives them no pairs at all), and
    factor is the contribution of a lane whose shadow ray is not
    occluded."""
    n_lights = center_t.shape[0]
    li = torch.clamp((u[:, smp.S_RESERVED] * n_lights).to(torch.int32),
                     0, n_lights - 1).long()
    center = center_t[li]
    radius = radius_t[li]
    lcolor = pm.take_rows(color_t, li) * float(n_lights)

    sphere_pt = center + radius[:, None] * smp.uniform_sphere(
        u[:, smp.S_LIGHT1], u[:, smp.S_LIGHT2])
    ldir = pm.normalize(sphere_pt - p)
    dist = pm.length(center - p)
    weight = smp.light_sampling_weight(ldir, n, radius, dist)

    shadow_o = p + ldir * GAP
    t_light = intersect_sphere(shadow_o, ldir, center, radius + GAP)
    front = pm.dot(ns_raw, ldir) >= 0.0
    need = front & (weight > 0.0) & (diffuse_beta > 0.0).any(-1)
    t_query = torch.where(need, t_light, 0.0)
    factor = torch.where((need & (t_light < INF_DIST))[:, None],
                         diffuse_beta * weight[:, None] * lcolor, 0.0)
    return shadow_o, ldir, t_query, factor, need


def nee_resolve_plain(radiance, factor, occ):
    """radiance + the NEE factor of each lane whose shadow ray is not
    occluded (``occ`` bool[R])."""
    return radiance + torch.where(occ[:, None], 0.0, factor)


def _resolve_plain(*xs):
    return (nee_resolve_plain(*xs),)


def _complete(out, xs) -> Shaded:
    """``Shaded`` from a route's outputs: the pdfs that pass through
    unchanged are the inputs themselves."""
    out = dict(zip(OUTPUTS, out))
    for k in _THROUGH:
        if out[k] is None:
            out[k] = xs[INPUTS.index(k)]
    return Shaded(**out)


def shade_plain(spec: Spec, *xs) -> Shaded:
    """``shade``'s outputs from the torch code (``xs`` in ``INPUTS``
    order)."""
    return _complete(_shade_plain(spec, *xs), xs)


# ------------------------------------------------------------- the kernels


#: the surface's material fields, in the order of their row strides in
#: the kernel's integer arguments, with their widths (None: f32[R])
_MATERIAL = {"albedo": 3, "alpha": None, "roughness": None,
             "metallic": None, "emissive": 3, "transmission": 3, "ior": None}


def _field(t, r: int, dev, name: str, width):
    """(pointer, row stride in floats) of a surface field f32[R] (width
    None) or f32[R, width] with unit column stride."""
    shape = (r,) if width is None else (r, width)
    if (t.dtype != torch.float32 or t.device != dev
            or tuple(t.shape) != shape
            or (width is not None and t.stride(1) != 1)):
        raise ValueError(f"{name}: expected f32{list(shape)} with unit "
                         f"column stride on {dev}")
    return t.data_ptr(), t.stride(0)


def launch_shade(spec: Spec, *xs):
    """``_shade_plain``'s outputs from one launch of ``shade_kernel``, in
    new tensors of the plain version's shapes and dtypes.  No autograd:
    the caller is ``dispatch.fused``."""
    x = dict(zip(INPUTS, (v.detach() for v in xs)))
    dev = x["o"].device
    r = x["o"].shape[0]
    for k in ("o", "d", "beta", "radiance", "miss_dir", "miss_beta", "ns"):
        x[k] = x[k].contiguous()
        _build.check_tensor(x[k], torch.float32, (r, 3), k, dev)
    for k, dt in (("prev_pdf", torch.float32), ("miss_pdf", torch.float32),
                  ("t", torch.float32), ("alive", torch.bool),
                  ("tri", torch.int32)):
        x[k] = x[k].contiguous()
        _build.check_tensor(x[k], dt, (r,), k, dev)
    u = x["u"]
    if (u.dtype != torch.float32 or u.device != dev
            or tuple(u.shape) != (r, smp.SAMPLES_PER_BOUNCE)):
        raise ValueError(f"u: expected f32[{r}, "
                         f"{smp.SAMPLES_PER_BOUNCE}] on {dev}")
    if u.stride(1) != 1:
        u = x["u"] = u.contiguous()
    n_lights = x["l_center"].shape[0] if spec.nee else 0
    if spec.nee:
        for k, shape in (("l_center", (n_lights, 3)),
                         ("l_radius", (n_lights,)),
                         ("l_color", (n_lights, 3))):
            x[k] = x[k].contiguous()
            _build.check_tensor(x[k], torch.float32, shape, k, dev)
    flags = ((F_NEE if spec.nee else 0) | (F_ENV if spec.env_nee else 0)
             | (F_RR if spec.rr else 0))
    # the material fields at their row strides (the surface kernel's
    # [R,4] rows, or the textured path's own tensors)
    mats = {k: _field(x[k], r, dev, k, w) for k, w in _MATERIAL.items()}
    route, exp = pow_route(spec.ior_exp)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    outs = dict(o=empty(r, 3), d=empty(r, 3), beta=empty(r, 3),
                radiance=empty(r, 3), alive=empty(r, dtype=torch.bool),
                miss_dir=empty(r, 3), miss_beta=empty(r, 3),
                counts=empty(5, dtype=torch.int32))
    if spec.env_nee:
        outs.update(prev_pdf=empty(r), miss_pdf=empty(r), p=empty(r, 3),
                    n=empty(r, 3), diffuse_beta=empty(r, 3))
    if spec.nee:
        outs.update(shadow_o=empty(r, 3), ldir=empty(r, 3),
                    t_query=empty(r), factor=empty(r, 3))
    ins = (ctypes.c_void_p * len(INPUTS))(*(
        mats[k][0] if k in mats else x[k].data_ptr() for k in INPUTS))
    out_ptrs = (ctypes.c_void_p * len(OUTPUTS))(*(
        outs[k].data_ptr() if k in outs else None for k in OUTPUTS))
    ints = (ctypes.c_int * (4 + len(_MATERIAL) + 1))(
        r, n_lights, flags, route, *(mats[k][1] for k in _MATERIAL),
        u.stride(0))
    floats = (ctypes.c_float * 3)(exp, spec.min_throughput, spec.rr_min_q)
    if r:
        with span("pc.kernel.shade"):
            code = _build.library().shade_launch(
                ins, out_ptrs, ints, floats, _build.stream_ptr(dev))
        _build.check(code, "shade_launch")
    else:
        outs["counts"].zero_()
    return tuple(outs.get(k) for k in OUTPUTS)


def launch_nee_resolve(radiance, factor, occ):
    """``nee_resolve_plain``'s sum from one launch of
    ``nee_resolve_kernel``, into a new tensor (the one output of a
    tuple)."""
    radiance, factor = radiance.detach(), factor.detach()
    occ = occ.detach().contiguous()
    dev = radiance.device
    r = radiance.shape[0]
    for k, v in (("radiance", radiance), ("factor", factor)):
        _build.check_tensor(v, torch.float32, (r, 3), k, dev)
    _build.check_tensor(occ, torch.bool, (r,), "occ", dev)
    out = torch.empty((r, 3), dtype=torch.float32, device=dev)
    if r:
        with span("pc.kernel.nee_resolve"):
            code = _build.library().nee_resolve_launch(
                radiance.data_ptr(), factor.data_ptr(), occ.data_ptr(),
                out.data_ptr(), r, _build.stream_ptr(dev))
        _build.check(code, "nee_resolve_launch")
    return (out,)


def shade_inputs(carry, hit, surf, u, lights):
    """``INPUTS`` from the bounce loop's carry, the closest hit, the
    surface dict of ``_interpolate_surface``, the bounce's uniforms and
    the scene's ``SphereLights``."""
    (o, d, beta, radiance, alive, prev_pdf, miss_dir, miss_beta,
     miss_pdf) = carry[:9]
    return (o, d, beta, radiance, alive, prev_pdf, miss_dir, miss_beta,
            miss_pdf, hit.t, hit.tri, surf["shading_normal"],
            surf["albedo"], surf["alpha"], surf["roughness"],
            surf["metallic"], surf["emissive"], surf["transmission"],
            surf["ior"], u, lights.center, lights.radius, lights.color)


def shade(spec: Spec, *xs) -> Shaded:
    """The bounce's shading (``INPUTS`` -> ``Shaded``): on a CUDA card one
    launch of ``shade_kernel`` (``launch_shade``), whether or not a
    gradient flows through it; on CPU tensors ``shade_plain``."""
    return _complete(dispatch.fused(*dispatch.bind(
        launch_shade, _shade_plain, spec), *xs), xs)


def nee_resolve(radiance, factor, occ):
    """``nee_resolve_plain``'s sum: on a CUDA card one launch of
    ``nee_resolve_kernel``, whether or not a gradient flows through it."""
    return dispatch.fused(launch_nee_resolve, _resolve_plain, radiance,
                          factor, occ)[0]
