"""Gradients of the port: autograd against finite differences, against
``jax.grad``, and through the packet query.

Mirrors tests/test_gradients.py on the port (cornell, brute, 24x24, 2
bounces, fixed sample arrays made by JAX): linear parameters (diffuse,
light colour, emissive) against central FD with rtol 2e-2 / atol 1e-3;
the vertex sweep with its match-rate bounds (FD-smooth coordinates must
match at >= 90%); camera-eye gradients finite and non-zero.

Against ``jax.grad`` on identical arrays (diffuse, emissive, light
colour, v0 at once): the two differ only by float32 rounding (XLA
contracts multiply-adds into FMAs and sums in another order), so each
gradient is held to 1e-4 of its largest entry.

Through the packet query (``intersector="pallas"``, the query detached,
``_reeval_hit`` differentiable): finite, and equal to the brute path's
gradient where both pick the same triangles, mirroring
tests/test_packet.py:test_packet_gradients; on a small hall, the frame's
gradients by both intersectors agree to 1e-3 of the largest entry (the
images agree on >= 98% of pixels, tests/test_torch_render.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.models.camera import Camera as JCamera  # noqa: E402
from prismarine_core_tpu.models.scene import (  # noqa: E402
    make_cornell_scene as j_cornell)
from prismarine_core_tpu.ops.sampling import make_sample_arrays  # noqa: E402
from prismarine_core_tpu.render.integrator import (  # noqa: E402
    render_with_samples as j_render)
from prismarine_core_tpu.utils.config import RenderConfig as JConfig  # noqa: E402
from prismarine_core_tpu_torch import interop  # noqa: E402
from prismarine_core_tpu_torch.accel import packet as tpk  # noqa: E402
from prismarine_core_tpu_torch.models import procedural as tproc  # noqa: E402
from prismarine_core_tpu_torch.models.camera import Camera  # noqa: E402
from prismarine_core_tpu_torch.models.scene import make_cornell_scene  # noqa: E402
from prismarine_core_tpu_torch.ops.intersect import (  # noqa: E402
    intersect_closest_brute)
from prismarine_core_tpu_torch.render.integrator import (  # noqa: E402
    render_with_samples)
from prismarine_core_tpu_torch.utils.config import RenderConfig  # noqa: E402
from tests.test_packet import _rand_rays  # noqa: E402
from tests.test_torch_render import BENCH_KNOBS, HALL  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"
CFG_KW = dict(width=24, height=24, spp=1, max_bounces=2, intersector="brute")
CFG = RenderConfig(**CFG_KW)
EYE, TARGET, FOV = (0.0, 0.0, 3.4), (0.0, 0.0, 0.0), 50.0
CAM = Camera.look_at(eye=EYE, target=TARGET, fov_y_deg=FOV, device=CPU)


def _samples(cfg_kw, seed=0):
    cam_s, bounce_s = make_sample_arrays(
        jax.random.key(seed), JConfig(**cfg_kw).n_rays, cfg_kw["max_bounces"])
    return cam_s, bounce_s


CAM_S, BOUNCE_S = (torch.tensor(np.asarray(x)) for x in _samples(CFG_KW))
W = torch.linspace(0.5, 1.5, CFG.n_pixels * 3).reshape(CFG.height,
                                                       CFG.width, 3)

#: parameter name -> (group, field) of the Scene
PARAMS = {"diffuse": ("materials", "diffuse"),
          "emissive": ("materials", "emissive"),
          "light_color": ("lights", "color"),
          "v0": ("triangles", "v0")}


def _put(scene, **values):
    """``scene`` with the named parameters (keys of PARAMS) replaced."""
    groups = {}
    for name, x in values.items():
        g, f = PARAMS[name]
        groups.setdefault(g, {})[f] = x
    return dataclasses.replace(scene, **{
        g: dataclasses.replace(getattr(scene, g), **fs)
        for g, fs in groups.items()})


def _get(scene, name):
    g, f = PARAMS[name]
    return getattr(getattr(scene, g), f)


def _loss(scene, camera=CAM):
    img = render_with_samples(scene, camera, CFG, CAM_S, BOUNCE_S)
    return (img * W).sum()


def _grad(scene, name):
    x = _get(scene, name).clone().requires_grad_(True)
    (g,) = torch.autograd.grad(_loss(_put(scene, **{name: x})), x)
    return g


@pytest.mark.parametrize("param", ["diffuse", "light_color", "emissive"])
def test_grad_matches_fd_linear_params(param):
    """Albedo / light / emissive gradients (no visibility dependence); RGB
    channels only (alpha feeds the pass-through coin, a discrete
    decision the detached estimator gives derivative 0)."""
    scene = make_cornell_scene(device=CPU)
    x0 = _get(scene, param)
    g = _grad(scene, param).numpy()
    rng = np.random.default_rng(0)
    eps = 1e-2
    for _ in range(6):
        idx = (int(rng.integers(0, x0.shape[0])),
               int(rng.integers(0, min(3, x0.shape[1]))))
        xp, xm = x0.clone(), x0.clone()
        xp[idx] += eps
        xm[idx] -= eps
        with torch.no_grad():
            fd = (float(_loss(_put(scene, **{param: xp})))
                  - float(_loss(_put(scene, **{param: xm})))) / (2 * eps)
        np.testing.assert_allclose(g[idx], fd, rtol=2e-2, atol=1e-3,
                                   err_msg=f"{param}[{idx}]")


def test_grad_matches_fd_vertices():
    """Vertex gradients through the hit re-evaluation, FD sweep with a
    match rate (tests/test_gradients.py:92-168): coordinates whose
    central FD agrees across two epsilons must match autograd within 10%
    at >= 90%; the FD loss accumulates in float64."""
    scene = make_cornell_scene(device=CPU)
    x0 = scene.triangles.v0
    g = _grad(scene, "v0").numpy()
    w64 = W.double().numpy()

    def f64(x):
        with torch.no_grad():
            img = render_with_samples(_put(scene, v0=x), CAM, CFG, CAM_S,
                                      BOUNCE_S)
        return float((img.double().numpy() * w64).sum())

    def fd_at(idx, e):
        xp, xm = x0.clone(), x0.clone()
        xp[idx] += e
        xm[idx] -= e
        return (f64(xp) - f64(xm)) / (2 * e)

    eps = 5e-4
    rng = np.random.default_rng(1)
    probed = smooth = matched = 0
    mismatches = []
    for tri in rng.permutation(int(scene.triangles.num_valid())):
        if probed >= 40:
            break
        for axis in range(3):
            idx = (int(tri), axis)
            if abs(g[idx]) < 1e-2:
                continue
            probed += 1
            fd1, fd2 = fd_at(idx, eps), fd_at(idx, eps / 4)
            if abs(fd1 - fd2) > 0.1 * (abs(fd1) + abs(fd2)) + 1e-2:
                continue                 # a silhouette crossed within eps
            smooth += 1
            if abs(g[idx] - fd2) / (abs(fd2) + 1e-2) < 0.10:
                matched += 1
            else:
                mismatches.append((idx, float(g[idx]), fd2))
    assert probed >= 20, f"only {probed} coordinates had |g| >= 1e-2"
    assert smooth >= 15, f"only {smooth}/{probed} coordinates were smooth"
    assert matched / smooth >= 0.9, (matched, smooth, mismatches[:5])


def test_grad_camera_params():
    scene = make_cornell_scene(device=CPU)
    eye = CAM.eye.clone().requires_grad_(True)
    cam = dataclasses.replace(CAM, eye=eye)
    img = render_with_samples(scene, cam, CFG, CAM_S, BOUNCE_S)
    (g,) = torch.autograd.grad(img.sum(), eye)
    assert bool(torch.isfinite(g).all()) and bool((g.abs() > 0).any())


def test_grads_match_jax():
    """Port autograd against ``jax.grad`` for diffuse, emissive, light
    colour and v0 (and the camera eye) on identical arrays."""
    jscene = j_cornell()
    jcam = JCamera.look_at(eye=EYE, target=TARGET, fov_y_deg=FOV)
    cam_s, bounce_s = _samples(CFG_KW)
    w = jnp.asarray(W.numpy())

    def jf(diffuse, emissive, color, v0, eye):
        s = dataclasses.replace(
            jscene,
            materials=dataclasses.replace(jscene.materials, diffuse=diffuse,
                                          emissive=emissive),
            lights=dataclasses.replace(jscene.lights, color=color),
            triangles=dataclasses.replace(jscene.triangles, v0=v0))
        cam = dataclasses.replace(jcam, eye=eye)
        return jnp.sum(j_render(s, cam, JConfig(**CFG_KW), cam_s, bounce_s)
                       * w)

    jargs = (jscene.materials.diffuse, jscene.materials.emissive,
             jscene.lights.color, jscene.triangles.v0, jcam.eye)
    gj = jax.grad(jf, argnums=tuple(range(5)))(*jargs)

    scene = make_cornell_scene(device=CPU)
    leaves = [_get(scene, n).clone().requires_grad_(True) for n in PARAMS]
    eye = CAM.eye.clone().requires_grad_(True)
    loss = _loss(_put(scene, **dict(zip(PARAMS, leaves))),
                 dataclasses.replace(CAM, eye=eye))
    gt = torch.autograd.grad(loss, leaves + [eye])
    for name, a, b in zip(list(PARAMS) + ["eye"], gt, gj):
        a, b = a.numpy(), np.asarray(b)
        err = np.abs(a - b).max() / np.abs(b).max()
        print(f"{name}: max |port - jax| / max |jax| = {err:.3g}")
        assert np.isfinite(a).all() and np.abs(b).max() > 0
        assert err <= 1e-4, (name, err)


def test_packet_gradients():
    """Gradients through the packet query: finite, and equal to the brute
    query's where both pick the same triangle (random soup, rays as
    tests/test_packet.py:test_packet_gradients)."""
    from prismarine_core_tpu.models.materials import MaterialTable
    from prismarine_core_tpu.models.scene import Scene as JScene
    from tests.test_bvh import _random_soup
    from tests.test_torch_scene import jax_scene_arrays
    js = JScene.assemble(_random_soup(300, capacity=384, seed=8),
                         MaterialTable.build([{}]))
    ts = interop.scene_from_numpy(jax_scene_arrays(js), device=CPU)
    o, d = (torch.tensor(np.asarray(x)) for x in _rand_rays(512, seed=9))

    def grad_of(query):
        v0 = ts.triangles.v0.clone().requires_grad_(True)
        soup = dataclasses.replace(ts.triangles, v0=v0)
        hit = query(soup)
        (g,) = torch.autograd.grad(
            torch.where(hit.tri >= 0, hit.t, 0.0).sum(), v0)
        return hit.tri, g

    tri_p, g_p = grad_of(lambda s: tpk.intersect_closest_pallas(
        ts.bvh, ts.packets, s, o, d))
    tri_b, g_b = grad_of(lambda s: intersect_closest_brute(s, o, d,
                                                           block=64))
    assert bool(torch.isfinite(g_p).all())
    assert int((tri_p >= 0).sum()) > 20
    assert torch.equal(tri_p, tri_b)
    np.testing.assert_allclose(g_p.numpy(), g_b.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert float(g_p.abs().max()) > 0


def test_packet_frame_gradients_match_brute():
    """A frame's gradients (diffuse, light colour, v0) through the packet
    query equal the brute path's to 1e-3 of the largest entry (small
    hall, bench knobs, 32x24, 2 bounces)."""
    scene = tproc.make_hall_scene(target_tris=3000, device=CPU)
    cam = Camera.look_at(HALL["eye"], HALL["target"], fov_y_deg=HALL["fov"],
                         device=CPU)
    kw = dict(width=32, height=24, spp=1, max_bounces=2)
    cam_s, bounce_s = (torch.tensor(np.asarray(x))
                       for x in _samples(dict(kw, intersector="brute"), 3))
    names = ("diffuse", "light_color", "v0")

    def grads(cfg):
        leaves = [_get(scene, n).clone().requires_grad_(True) for n in names]
        img = render_with_samples(_put(scene, **dict(zip(names, leaves))),
                                  cam, cfg, cam_s, bounce_s)
        return torch.autograd.grad(img.square().mean(), leaves)

    g_pallas = grads(RenderConfig(**kw, **BENCH_KNOBS))
    g_brute = grads(RenderConfig(**kw, intersector="brute"))
    for name, a, b in zip(names, g_pallas, g_brute):
        a, b = a.numpy(), b.numpy()
        err = np.abs(a - b).max() / np.abs(b).max()
        print(f"{name}: max |pallas - brute| / max |brute| = {err:.3g}")
        assert np.isfinite(a).all() and np.abs(b).max() > 0
        assert err <= 1e-3, (name, err)
