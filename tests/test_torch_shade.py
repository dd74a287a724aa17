"""The bounce loop's shading (``ops/shade.py``, ``csrc/shade.cu``).

On the CPU: the module imports without a card; ``make_bounce_step`` on
``shade_plain`` and ``nee_resolve_plain`` gives every bounce's carry and
counts bit for bit as the inline code did before the move (a copy of which
is kept here) over bounces 0-3 of the small hall under "bvh" and "pallas",
with Russian roulette, env NEE, no direct light, no light at all, an
interlace mask, glossy, metallic and transmissive materials and the
textured stack; the kernels' route through the seam (``ops/dispatch.py``,
the plain version standing in for each launch) gives the plain version's
outputs, leaves out of the graph what the plain version does not
differentiate, and gives a render's gradients as the plain route does.

On the card (``gpu``, skipped here): both kernels equal their plain
versions bit for bit on every output (the 1280x720 hall's bounces under
"bvh" and "pallas", and every case above at a smaller size, and random
lanes through every branch and every ``torch.pow`` route of cfg.ior),
each CUDA path launches the shading kernel once a bounce, whole frames
are bit-identical between the kernels and the plain versions, under
grad mode too, and a train step runs the kernels with the plain route's
loss.  This module imports no jax, so on a machine without the JAX
package:

    python -m pytest --noconftest tests/test_torch_shade.py -q
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from prismarine_core_tpu_torch.models.camera import Camera  # noqa: E402
from prismarine_core_tpu_torch.models.lights import SphereLights  # noqa: E402
from prismarine_core_tpu_torch.models.scene import make_cornell_scene  # noqa: E402
from prismarine_core_tpu_torch.ops import sampling as smp  # noqa: E402
from prismarine_core_tpu_torch.ops import shade as sh  # noqa: E402
from prismarine_core_tpu_torch.ops.intersect import intersect_sphere  # noqa: E402
from prismarine_core_tpu_torch.render import integrator as it  # noqa: E402
from prismarine_core_tpu_torch.utils import math as pm  # noqa: E402
from prismarine_core_tpu_torch.utils.config import (  # noqa: E402
    GAP, INF_DIST, RenderConfig)
from prismarine_core_tpu_torch.utils.profiling import counts, spanned  # noqa: E402
from test_torch_surface import seam  # noqa: E402

CPU = "cpu"
CARRY = ("o", "d", "beta", "radiance", "alive", "prev_pdf", "miss_dir",
         "miss_beta", "miss_pdf")


# ------------------------------------------- the bounce step before the move
# ``render/integrator.py``'s NEE and bounce step as they were before the
# shading moved into ``ops/shade.py``, kept verbatim as the reference of
# the move.


@spanned("pc.nee")
def old_nee_contribution(scene, cfg: RenderConfig, p, n, ns_raw, diffuse_beta,
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
    occ = it.occluded(scene, shadow_o, ldir, t_query, cfg, order=order)
    vis = need & ~occ & (t_light < INF_DIST)
    contrib = torch.where(vis[:, None],
                          diffuse_beta * weight[:, None] * lcolor, 0.0)
    return contrib, need.sum(dtype=torch.int32)



def old_make_bounce_step(scene, cfg: RenderConfig, fixed_order=None):
    """The per-bounce step: (carry, u f32[R,11]) -> (carry, stats i32[5]).
    The carry is (o, d, beta, radiance, alive, prev_pdf, miss_dir,
    miss_beta, miss_pdf, bounce index); the two pdfs (the bsdf pdf of each
    lane's last continuation, and of its miss) feed env-NEE MIS and stay
    zero without ``cfg.env_nee``; the bounce index (a Python int) turns
    Russian roulette on.  ``fixed_order``: the closest query's ray order
    instead of its own coherence sort ("identity", or a (perm, inv_perm)
    of ``reuse_bounce_order``; "pallas" only)."""
    kinds = it.surface_kinds(scene)

    @spanned("pc.bounce")
    def step(carry, u):
        (o, d, beta, radiance, alive, prev_pdf, miss_dir, miss_beta,
         miss_pdf, bounce_i) = carry
        t_cap = torch.where(alive, INF_DIST, 0.0)
        hit, order, carried = it.closest_hit(scene, o, d, cfg, t_cap=t_cap,
                                          with_order=True, order=fixed_order,
                                          with_surface=True)

        # deferred env pickup: record (direction, throughput, bsdf pdf)
        # at the miss, fetch once after the loop
        miss = alive & hit.missed
        miss_dir = torch.where(miss[:, None], d, miss_dir)
        miss_beta = torch.where(miss[:, None], beta, miss_beta)
        if cfg.env_nee:
            miss_pdf = torch.where(miss, prev_pdf, miss_pdf)

        on_surf = alive & ~hit.missed
        surf = it._interpolate_surface(scene, hit, cfg, kinds, carried)
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
            nee, n_shadow = old_nee_contribution(
                scene, cfg, p, n, surf["shading_normal"], diffuse_beta, u,
                order=order)
            radiance = radiance + nee
        if cfg.env_nee:
            env_nee, n_env_shadow = it._env_nee_contribution(
                scene, cfg, p, n, diffuse_beta, u, order=order)
            radiance = radiance + env_nee
            n_shadow = n_shadow + n_env_shadow
            # the continuation's bsdf pdf: cosine for diffuse lanes, 0
            # (a delta) for specular and pass-through ones
            prev_pdf = torch.where(
                choose_diff & on_surf,
                torch.clamp(pm.dot(new_d, n), min=0.0) / math.pi, 0.0)

        new_alive = on_surf & (pm.length(new_beta) > cfg.min_throughput)

        # Russian roulette from bounce cfg.rr_start_bounce on: survive with
        # probability q = clamp(max channel of throughput, rr_min_q, 1),
        # survivors reweighted by 1/q (unbiased)
        if 0 < cfg.rr_start_bounce <= bounce_i:
            q = torch.clamp(new_beta.amax(dim=-1), cfg.rr_min_q, 1.0)
            survive = u[:, smp.S_RR] < q
            new_alive = new_alive & survive
            new_beta = torch.where(survive[:, None], new_beta / q[:, None],
                                   new_beta)

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
        return ((new_o, new_d, new_beta, radiance, new_alive, prev_pdf,
                 miss_dir, miss_beta, miss_pdf, bounce_i + 1), stats)

    return step



# ------------------------------------------------------------------ helpers


def bits(t):
    """``t``'s values as integers, so NaNs and signed zeros compare by
    their bits."""
    t = t.detach().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    differ = (bits(a) != bits(b)).reshape(a.shape[:1] + (-1,)).any(-1)
    assert not bool(differ.any()), f"{what}: {int(differ.sum())} lanes differ"


def assert_same_outputs(got, want, what):
    for k, x, y in zip(sh.OUTPUTS, got, want):
        if x is None or y is None:
            assert x is None and y is None, f"{what} {k}"
        else:
            assert_same(x, y, f"{what} {k}")


def glassy(scene):
    """``scene`` with a pass-through material (alpha 0.4, tinted,
    ior 1.5), an untinted one of alpha 0.7 and ior 1.33, and a glossy
    metal: every branch of the bounce and total internal reflection."""
    m = scene.materials
    diffuse, specular = m.diffuse.clone(), m.specular.clone()
    transmission, ior = m.transmission.clone(), m.ior.clone()
    diffuse[0, 3], transmission[0, :3], ior[0] = 0.4, 0.8, 1.5
    diffuse[1, 3], ior[1] = 0.7, 1.33
    specular[2, 1:3] = torch.tensor([0.3, 0.9])
    return dataclasses.replace(scene, materials=dataclasses.replace(
        m, diffuse=diffuse, specular=specular, transmission=transmission,
        ior=ior))


def no_lights(scene, dev):
    return dataclasses.replace(scene, lights=SphereLights(
        center=torch.zeros((0, 3), device=dev),
        radius=torch.zeros((0,), device=dev),
        color=torch.zeros((0, 3), device=dev)))


def with_specular_maps(scene):
    """A textured scene whose materials also bind their diffuse map as the
    specular one (roughness and metallic then come from the fetch)."""
    m = scene.materials
    return dataclasses.replace(scene, materials=dataclasses.replace(
        m, tex_specular=m.tex_diffuse.clone()))


def hall(dev, textured=False, target_tris=3000):
    from prismarine_core_tpu_torch.models.procedural import (
        make_hall_scene, make_sky_environment)
    scene = make_hall_scene(target_tris=target_tris, textured=textured,
                            texture_resolution=32, device=dev)
    return dataclasses.replace(scene, environment=make_sky_environment(
        resolution=16, device=dev))


def hall_camera(dev):
    return Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                          fov_y_deg=60.0, device=dev)


#: the cases of the bounce: (scene kind, RenderConfig fields)
CASES = {
    "bvh": ("hall", {}),
    "pallas": ("hall", dict(intersector="pallas")),
    "rr": ("hall", dict(rr_start_bounce=1)),
    "env_nee": ("hall", dict(env_nee=True)),
    "no_direct_light": ("hall", dict(direct_light=False)),
    "no_lights": ("no_lights", {}),
    "interlace": ("hall", dict(interlace=True)),
    "glassy": ("glassy", dict(rr_start_bounce=2)),
    "textured": ("textured", {}),
    "cornell": ("cornell", dict(env_nee=True)),
}


def case_scene(kind, dev, target_tris=3000):
    if kind == "cornell":
        return make_cornell_scene(device=dev), Camera.look_at(
            eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0), fov_y_deg=50.0,
            device=dev)
    scene = hall(dev, textured=kind == "textured", target_tris=target_tris)
    if kind == "textured":
        scene = with_specular_maps(scene)
    elif kind == "glassy":
        scene = glassy(scene)
    elif kind == "no_lights":
        scene = no_lights(scene, dev)
    return scene, hall_camera(dev)


def case_cfg(fields, width, height):
    return RenderConfig(width=width, height=height, spp=1, max_bounces=4,
                        bvh_leaf_size=4, **{"intersector": "bvh", **fields})


def first_carry(scene, cam, cfg, seed, dev):
    cam_s, bounce_s = smp.make_sample_arrays(
        torch.Generator(device=dev).manual_seed(seed), cfg.n_rays,
        cfg.max_bounces, device=dev)
    o, d, active = it.primary_rays(cam, cfg, cam_s, interlace_stage=1)
    return it.initial_carry(o, d, active), bounce_s


def is_shading(launch):
    """Is ``launch`` the shading's or the NEE resolve's?"""
    return (launch is sh.launch_nee_resolve
            or getattr(launch, "func", None) is sh.launch_shade)


@contextlib.contextmanager
def recorded():
    """Each ``shade`` and ``nee_resolve`` launch of the bounce loop:
    (spec, inputs, outputs) and (inputs, output)."""
    seen = dict(shade=[], resolve=[])

    def pick(x, launch, plain, choose):
        run = choose(x, launch, plain)
        if not is_shading(launch):
            return run

        def record(*xs):
            out = run(*xs)
            if launch is sh.launch_nee_resolve:
                seen["resolve"].append((xs, out[0]))
            else:
                seen["shade"].append((launch.args[0], xs,
                                      sh._complete(out, xs)))
            return out
        return record
    with seam(pick):
        yield seen


def plain_shading(x, launch, plain, choose):
    """A ``seam`` choice: the shading on its plain versions."""
    return plain if is_shading(launch) else choose(x, launch, plain)


def plain_route():
    """The bounce loop's shading on the plain versions."""
    return seam(plain_shading)


def emulated(plain):
    """A kernel's launch stood in for by its plain version: the outputs
    without autograd."""
    def launch(*xs):
        with torch.no_grad():
            return plain(*(x.detach() for x in xs))
    return launch


def emulated_shading(x, launch, plain, choose):
    """A ``seam`` choice: the shading's launches, on any device, stood in
    for by their plain versions (through ``_Fused`` under grad)."""
    return emulated(plain) if is_shading(launch) else choose(x, launch,
                                                             plain)


def emulated_route():
    """The bounce loop's shading through the seam's launch route on any
    device, the plain version standing in for each kernel."""
    return seam(emulated_shading)


def emulated_shade(spec, *xs):
    """``sh.shade`` on the launch route on any device."""
    with emulated_route():
        return sh.shade(spec, *xs)


def random_lanes(r, seed, dev, layout="rows"):
    """``INPUTS`` of r random lanes: a tenth dead and a tenth missed,
    random materials with every branch taken (alpha, metallic, tinted and
    untinted transmission, ior 1-2.5 so that some pass-throughs reflect
    totally), shading normals on either side of the rays, a few NaN and
    infinite ones, two sphere lights.  ``layout`` "rows": the material
    fields are columns of [R,4] rows, as the surface kernel gives them;
    "strided": tensors of their own, the transmission a strided view."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g)
    d = pm.normalize(torch.randn((r, 3), generator=g))
    ns = pm.normalize(torch.randn((r, 3), generator=g))
    ns[:8] = torch.tensor([float("nan"), 0.0, 1.0])
    ns[8:16] = torch.tensor([float("inf"), 1.0, 0.0])
    rows = torch.rand((4, r, 4), generator=g)
    rows[0, :, 3] = torch.where(rnd(r) < 0.4, rnd(r), 1.0)       # alpha
    rows[2, :, :3] *= (rnd(r) < 0.2)[:, None]                    # emissive
    rows[3, :, :3] *= (rnd(r) < 0.5)[:, None]                    # tint
    tri = torch.randint(0, 100, (r,), generator=g, dtype=torch.int32)
    tri[rnd(r) < 0.1] = -1
    xs = dict(
        o=rnd(r, 3, lo=-5.0, hi=5.0), d=d, beta=rnd(r, 3),
        radiance=rnd(r, 3), alive=rnd(r) > 0.1, prev_pdf=rnd(r),
        miss_dir=pm.normalize(torch.randn((r, 3), generator=g)),
        miss_beta=rnd(r, 3), miss_pdf=rnd(r), t=rnd(r, lo=0.01, hi=20.0),
        tri=tri, ns=ns, ior=rnd(r, lo=1.0, hi=2.5),
        u=rnd(r, smp.SAMPLES_PER_BOUNCE),
        l_center=torch.tensor([[30.0, 80.0, 10.0], [-20.0, 40.0, 5.0]]),
        l_radius=torch.tensor([8.0, 3.0]),
        l_color=torch.tensor([[20.0, 19.0, 18.0], [5.0, 6.0, 7.0]]))
    xs = {k: v.to(dev) for k, v in xs.items()}
    diffuse, specular, emissive, trans = rows.to(dev).unbind(0)
    if layout == "rows":
        xs.update(albedo=diffuse[:, :3], alpha=diffuse[:, 3],
                  roughness=specular[:, 1], metallic=specular[:, 2],
                  emissive=emissive[:, :3], transmission=trans[:, :3])
    else:
        wide = torch.zeros((r, 5), device=dev)
        wide[:, 1:4] = trans[:, :3]
        xs.update(albedo=diffuse[:, :3].contiguous(),
                  alpha=diffuse[:, 3].contiguous(),
                  roughness=specular[:, 1].contiguous(),
                  metallic=specular[:, 2].contiguous(),
                  emissive=emissive[:, :3].contiguous(),
                  transmission=wide[:, 1:4])
    return tuple(xs[k] for k in sh.INPUTS)


SPECS = {
    "nee": sh.Spec(True, False, False, 0.4, 1e-4, 0.05),
    "nee_env_rr": sh.Spec(True, True, True, 0.4, 1e-4, 0.05),
    "env": sh.Spec(False, True, False, 0.4, 1e-4, 0.05),
    "bare": sh.Spec(False, False, False, 0.4, 1e-4, 0.05),
    "rr": sh.Spec(False, False, True, 0.4, 0.3, 0.2),
}


# ---------------------------------------------------------------- CPU


def test_module_imports_without_a_card():
    """ops/shade.py imports and runs its plain versions on CPU tensors
    without building or loading the kernel library."""
    from prismarine_core_tpu_torch import _build
    xs = random_lanes(64, 0, CPU)
    k0, k1 = counts["pc.kernel.shade"], counts["pc.kernel.nee_resolve"]
    spec = SPECS["nee_env_rr"]
    assert_same_outputs(sh.shade(spec, *xs), sh.shade_plain(spec, *xs),
                        "cpu")
    occ = torch.rand(64) < 0.5
    assert_same(sh.nee_resolve(xs[3], xs[3], occ),
                sh.nee_resolve_plain(xs[3], xs[3], occ), "resolve")
    assert counts["pc.kernel.shade"] == k0
    assert counts["pc.kernel.nee_resolve"] == k1
    assert _build.CSRC.joinpath("shade.cu").is_file()


def test_pow_routes():
    """``pow_route`` names torch's CUDA route for each exponent; the
    default cfg.ior takes powf at 0.4 rounded to float."""
    assert sh.pow_route(1.4 - 1.0) == (sh.POW_POWF,
                                       float(np.float32(1.4 - 1.0)))
    assert sh.pow_route(0.5)[0] == sh.POW_SQRT
    assert sh.pow_route(-0.5)[0] == sh.POW_RSQRT
    assert sh.pow_route(-1.0)[0] == sh.POW_RECIP
    assert sh.pow_route(0.0)[0] == sh.POW_ONE
    assert sh.pow_route(1.0)[0] == sh.POW_COPY
    assert sh.pow_route(2.0)[0] == sh.POW_SQUARE
    assert sh.pow_route(2.0000000001)[0] == sh.POW_SQUARE
    assert sh.pow_route(3.0)[0] == sh.POW_CUBE
    assert sh.pow_route(-2.0)[0] == sh.POW_INV_SQUARE


@pytest.mark.parametrize("case", sorted(CASES))
def test_bounces_same_as_before_the_move(case):
    """Bounces 0-3 of the small hall (the Cornell box with env NEE):
    ``make_bounce_step`` gives the carry and the counts of the step as it
    was before the shading moved into ``ops/shade.py``, bit for bit, from
    the same carry at every bounce."""
    kind, fields = CASES[case]
    scene, cam = case_scene(kind, CPU)
    cfg = case_cfg(fields, 24, 16)
    carry, bounce_s = first_carry(scene, cam, cfg, 5, CPU)
    new, old = it.make_bounce_step(scene, cfg), old_make_bounce_step(
        scene, cfg)
    hits = 0
    for b in range(cfg.max_bounces):
        c_new, st_new = new(carry, bounce_s[b])
        c_old, st_old = old(carry, bounce_s[b])
        for k, x, y in zip(CARRY, c_new, c_old):
            assert_same(x, y, f"{case} bounce {b} {k}")
        assert c_new[9] == c_old[9] == b + 1
        assert_same(st_new, st_old, f"{case} bounce {b} counts")
        hits += int(st_old[1])
        carry = c_old
    assert hits > 0


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("layout", ["rows", "strided"])
def test_function_route_gives_the_plain_outputs(spec, layout):
    """Random lanes through every branch: the seam's launch route (its
    ``_Fused`` under grad) with the plain version as the launch gives the
    plain version's outputs bit for bit,
    and exactly its outputs that require grad are differentiable (the
    others are not in the graph)."""
    spec = SPECS[spec]
    xs = random_lanes(500, 1, CPU, layout)
    grads = [x.clone().requires_grad_(x.is_floating_point() and k in (
        "o", "beta", "radiance", "ns", "albedo", "roughness", "ior",
        "l_color")) for k, x in zip(sh.INPUTS, xs)]
    with torch.enable_grad():
        want = sh.shade_plain(spec, *grads)
        got = emulated_shade(spec, *grads)
    assert_same_outputs(got, want, "fused")
    for k, x, y in zip(sh.OUTPUTS, got, want):
        if y is not None:
            assert x.requires_grad == y.requires_grad, k
    assert got.o.requires_grad and not got.alive.requires_grad
    assert not got.counts.requires_grad
    # an input that needs no gradient leaves its outputs out of the graph
    with torch.enable_grad():
        only_color = [x.clone().requires_grad_(k == "l_color")
                      for k, x in zip(sh.INPUTS, xs)]
        out = emulated_shade(spec, *only_color)
    assert not out.o.requires_grad and not out.beta.requires_grad
    assert not out.radiance.requires_grad
    assert (out.factor is not None) == spec.nee
    if spec.nee:
        assert out.factor.requires_grad


def _grad_render(route):
    scene0 = make_cornell_scene(device=CPU)
    cam = Camera.look_at(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                         fov_y_deg=50.0, device=CPU)
    cfg = RenderConfig(width=20, height=20, spp=1, max_bounces=4,
                       intersector="bvh", rr_start_bounce=2)
    cam_s, bounce_s = smp.make_sample_arrays(
        torch.Generator().manual_seed(4), cfg.n_rays, cfg.max_bounces,
        device=CPU)
    diffuse = scene0.materials.diffuse.clone().requires_grad_(True)
    color = scene0.lights.color.clone().requires_grad_(True)
    v0 = scene0.triangles.v0.clone().requires_grad_(True)
    scene = dataclasses.replace(
        scene0,
        materials=dataclasses.replace(scene0.materials, diffuse=diffuse),
        lights=dataclasses.replace(scene0.lights, color=color),
        triangles=dataclasses.replace(scene0.triangles, v0=v0))
    with torch.enable_grad(), route():
        img = it.render_with_samples(scene, cam, cfg, cam_s, bounce_s)
        loss = (img * img).mean()
        g = torch.autograd.grad(loss, (diffuse, color, v0))
    return loss.detach(), g


def test_render_gradients_through_the_function_route():
    """A render under grad through the seam's ``_Fused`` (the plain
    version standing in for the kernels) gives the plain route's loss bit
    for bit and its gradients of the materials, the light colour and a
    vertex field to a millionth (the backward sums a gradient's parts in
    another order)."""
    loss_p, g_p = _grad_render(contextlib.nullcontext)
    loss_f, g_f = _grad_render(emulated_route)
    assert_same(loss_f, loss_p, "loss")
    for a, b in zip(g_f, g_p):
        assert float(b.abs().max()) > 0
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6 * float(
            b.abs().max()))


def test_env_contribution_unchanged_by_the_masked_point():
    """Off a surface the plain version hands env NEE the lane's own ray
    as its point and normal: the env-NEE sum and count of a bounce are
    those of the garbage point the inline code gave (checked by the
    carries above); here, directly, a lane off a surface adds nothing."""
    scene, cam = case_scene("cornell", CPU)
    cfg = case_cfg(dict(env_nee=True), 16, 16)
    carry, bounce_s = first_carry(scene, cam, cfg, 9, CPU)
    carry, _ = it.make_bounce_step(scene, cfg)(carry, bounce_s[0])
    xs = sh.shade_inputs(carry, it.closest_hit(scene, carry[0], carry[1],
                                               cfg),
                         it._interpolate_surface(
                             scene, it.closest_hit(scene, carry[0],
                                                   carry[1], cfg), cfg),
                         bounce_s[1], scene.lights)
    out = sh.shade_plain(sh.Spec.of(cfg, scene.lights.count, 1), *xs)
    off = ~(carry[4] & (xs[sh.INPUTS.index("tri")] >= 0))
    assert bool(off.any())
    contrib, _ = it._env_nee_contribution(scene, cfg, out.p, out.n,
                                          out.diffuse_beta, bounce_s[1])
    assert torch.equal(contrib[off], torch.zeros_like(contrib[off]))


# ---------------------------------------------------------------- card


@pytest.fixture(scope="module")
def cuda_device():
    """The first CUDA card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def big_hall(cuda_device):
    """bench.py's hall (sky, sun, camera) on the card."""
    from prismarine_core_tpu_torch.models.procedural import (
        make_hall_scene, make_sky_environment)
    scene = make_hall_scene(target_tris=100_000, device=cuda_device)
    scene = dataclasses.replace(scene, environment=make_sky_environment(
        resolution=128, device=cuda_device))
    return scene, hall_camera(cuda_device)


def frame_cfg(intersector):
    return RenderConfig(width=1280, height=720, spp=1, max_bounces=4,
                        intersector=intersector, bvh_leaf_size=4,
                        coherent_bounce_sampling=True)


def frame_samples(cfg, dev, seed=7):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return smp.make_coherent_sample_arrays(gen, cfg, block=(64, 64))


def assert_recorded_plain(seen, what):
    """Each recorded launch's outputs equal the plain version's on the
    same inputs, bit for bit."""
    for b, (spec, xs, out) in enumerate(seen["shade"]):
        assert_same_outputs(out, sh.shade_plain(spec, *xs),
                            f"{what} bounce {b}")
    for b, (xs, out) in enumerate(seen["resolve"]):
        assert_same(out, sh.nee_resolve_plain(*xs), f"{what} resolve {b}")


@pytest.mark.gpu
@pytest.mark.parametrize("intersector", ["bvh", "pallas"])
def test_kernels_equal_plain_on_the_halls_bounces(big_hall, intersector):
    """The 1280x720 hall's bounces 1-4 under "bvh" and "pallas": every
    output of both kernels, missed and dead lanes included."""
    scene, cam = big_hall
    cfg = frame_cfg(intersector)
    k0, k1 = counts["pc.kernel.shade"], counts["pc.kernel.nee_resolve"]
    with recorded() as seen:
        it.render_with_samples(scene, cam, cfg,
                               *frame_samples(cfg, cam.eye.device))
    torch.cuda.synchronize()
    assert counts["pc.kernel.shade"] - k0 == 4
    assert counts["pc.kernel.nee_resolve"] - k1 == 4
    assert len(seen["shade"]) == len(seen["resolve"]) == 4
    assert_recorded_plain(seen, intersector)
    missed = [int((xs[sh.INPUTS.index("tri")] < 0).sum())
              for _, xs, _ in seen["shade"]]
    assert all(m > 0 for m in missed)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_equal_plain_on_the_cases(cuda_device, case):
    """Every case of the CPU test at 320x180 on the card (the hall at
    20,000 triangles): each bounce's outputs of both kernels."""
    kind, fields = CASES[case]
    scene, cam = case_scene(kind, cuda_device, target_tris=20_000)
    cfg = case_cfg(fields, 320, 180)
    carry, bounce_s = first_carry(scene, cam, cfg, 5, cuda_device)
    k0 = counts["pc.kernel.shade"]
    with recorded() as seen:
        it.trace(scene, cfg, carry[0], carry[1], bounce_s, carry[4]
                 if cfg.interlace else None)
    torch.cuda.synchronize()
    assert counts["pc.kernel.shade"] - k0 == cfg.max_bounces
    assert_recorded_plain(seen, case)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["rows", "strided"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_kernels_equal_plain_on_random_lanes(cuda_device, spec, layout):
    """200,000 random lanes through every branch, each set of flags, the
    material fields as columns of [R,4] rows (row stride 4) and as
    tensors of their own (row stride 1 or 3, and 5 for a strided view)."""
    spec = SPECS[spec]
    xs = random_lanes(200_000, 3, cuda_device, layout)
    got = sh.shade(spec, *xs)
    assert_same_outputs(got, sh.shade_plain(spec, *xs), "random")
    occ = torch.rand(200_000, device=cuda_device) < 0.5
    factor = xs[sh.INPUTS.index("beta")]
    assert_same(sh.nee_resolve(got.radiance, factor, occ),
                sh.nee_resolve_plain(got.radiance, factor, occ), "resolve")


@pytest.mark.gpu
@pytest.mark.parametrize("ior", [1.4, 1.5, 0.5, 0.0, 1.0, 2.0, 3.0, -1.0,
                                 1.25])
def test_kernel_takes_torchs_pow_route(cuda_device, ior):
    """cfg.ior sets the exponent of cosmag; each of torch.pow's routes
    (powf, sqrt, rsqrt, reciprocal, fill, copy, x*x, x*x*x, 1/(x*x)) gives
    the plain version's bits."""
    spec = dataclasses.replace(SPECS["nee_env_rr"], ior_exp=ior - 1.0)
    xs = random_lanes(100_000, 4, cuda_device)
    assert_same_outputs(sh.shade(spec, *xs), sh.shade_plain(spec, *xs),
                        f"ior {ior}")


@pytest.mark.gpu
@pytest.mark.parametrize("intersector", ["bvh", "pallas", "brute", "packet",
                                         "pallas_sharded"])
def test_one_shade_launch_a_bounce(cuda_device, intersector):
    """Every CUDA path launches the shading kernel once a bounce and the
    resolve once a bounce with a light (a Cornell frame)."""
    from prismarine_core_tpu_torch.parallel import shard_intersect as tsi
    from prismarine_core_tpu_torch.parallel.mesh import make_mesh
    scene, cam = case_scene("cornell", cuda_device)
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=4,
                       intersector=intersector)
    if intersector == "pallas_sharded":
        mesh = make_mesh(2, model_parallel=2, devices=[cuda_device] * 2)
        cfg = cfg.replace(mesh=mesh)
        scene = tsi.distribute_scene(scene, mesh)
    k0, k1, b0 = (counts["pc.kernel.shade"], counts["pc.kernel.nee_resolve"],
                  counts["pc.bounce"])
    img = it.render(scene, cam, cfg,
                    torch.Generator(device=cuda_device).manual_seed(1))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(img).all())
    assert counts["pc.bounce"] - b0 == 4
    assert counts["pc.kernel.shade"] - k0 == 4
    assert counts["pc.kernel.nee_resolve"] - k1 == 4


@pytest.mark.gpu
@pytest.mark.parametrize("intersector", ["bvh", "pallas"])
def test_frames_bit_identical_between_the_routes(big_hall, intersector):
    """A 1280x720 frame on the kernels, the same frame under grad mode
    with the light colour requiring grad (still the kernels, once a
    bounce) and the same frame on the plain versions: one image."""
    scene, cam = big_hall
    cfg = frame_cfg(intersector)
    samples = frame_samples(cfg, cam.eye.device, seed=11)
    img = it.render_with_samples(scene, cam, cfg, *samples)
    lights = dataclasses.replace(
        scene.lights, color=scene.lights.color.clone().requires_grad_(True))
    k0 = counts["pc.kernel.shade"]
    with torch.enable_grad():
        img_grad = it.render_with_samples(
            dataclasses.replace(scene, lights=lights), cam, cfg, *samples)
    assert img_grad.requires_grad
    assert counts["pc.kernel.shade"] - k0 == 4
    k0 = counts["pc.kernel.shade"]
    with plain_route():
        img_plain = it.render_with_samples(scene, cam, cfg, *samples)
    assert counts["pc.kernel.shade"] == k0
    assert torch.equal(bits(img), bits(img_plain))
    assert torch.equal(bits(img_grad), bits(img_plain))


@pytest.mark.gpu
def test_kernels_in_a_train_step(cuda_device):
    """The inverse-rendering step differentiates the shading through the
    kernels: one launch of each a bounce; the loss the plain route's bit
    for bit; each updated parameter the plain route's to within twice
    what two runs of the plain route differ by (the scatter-adds of the
    backward are atomic on the card) and a millionth of its size."""
    from prismarine_core_tpu_torch.parallel.mesh import (
        init_params, make_train_step)
    scene, cam = case_scene("cornell", cuda_device)
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=4,
                       intersector="bvh")
    cam_s, bounce_s = smp.make_sample_arrays(
        torch.Generator(device=cuda_device).manual_seed(2), cfg.n_rays,
        cfg.max_bounces)
    target = torch.zeros((32, 32, 3), device=cuda_device)
    step = make_train_step(None, cfg, lr=0.02)
    args = (scene, cam, cam_s, bounce_s, target)
    start = init_params(scene)
    k0, k1 = counts["pc.kernel.shade"], counts["pc.kernel.nee_resolve"]
    p_k, loss_k = step(start, *args)
    assert torch.isfinite(loss_k)
    assert counts["pc.kernel.shade"] - k0 == 4
    assert counts["pc.kernel.nee_resolve"] - k1 == 4
    k0 = counts["pc.kernel.shade"]
    with plain_route():
        p_a, loss_a = step(start, *args)
        p_b, _ = step(start, *args)
    assert counts["pc.kernel.shade"] == k0
    assert torch.equal(bits(loss_k), bits(loss_a))
    for k, a in p_a.items():
        spread = float((a - p_b[k]).abs().max())
        off = float((p_k[k] - a).abs().max())
        assert off <= 2 * spread + 1e-6 * float(a.abs().max()), k
        assert float((a - start[k]).abs().max()) > 0, k


@pytest.mark.gpu
def test_outputs_without_gradient_stay_out_of_the_graph(cuda_device):
    """Under grad with only the light colour requiring grad, the kernel's
    carry is not in the graph and the NEE factor is; with nothing
    requiring grad nothing is."""
    xs = random_lanes(10_000, 5, cuda_device)
    spec = SPECS["nee_env_rr"]
    color = [x.clone().requires_grad_(k == "l_color")
             for k, x in zip(sh.INPUTS, xs)]
    with torch.enable_grad():
        out = sh.shade(spec, *color)
        none = sh.shade(spec, *xs)
    assert out.factor.requires_grad
    for k in ("o", "d", "beta", "radiance", "alive", "counts", "p", "n",
              "diffuse_beta", "shadow_o", "ldir"):
        assert not getattr(out, k).requires_grad, k
    assert not any(getattr(none, k).requires_grad for k in sh.OUTPUTS
                   if getattr(none, k) is not None)
    assert_same_outputs(out, sh.shade_plain(spec, *xs), "under grad")
