"""The port's boundary (edge-sampled) gradients against the JAX package's
``render/edge_grad.py``, and the finite-difference cases of
tests/test_edge_gradients.py in the port, on the CPU.

Against JAX, on shared inputs (scenes from one set of numpy arrays, JAX-made
sample arrays through ``interop.samples_from_numpy``):

- ``project_to_screen`` / ``rays_through_screen``: pixel coords within
  atol 1e-4 px, camera-z and rays within 1e-5, plus the inverse property
  (tests/test_edge_gradients.py:53-65, atol 1e-3 px).
- ``_edge_multiplicity``: equal ints on the cornell box (watertight), a
  soup with padding, and a soup with -0.0 / +0.0 copies of a vertex.
- ``_clip_to_rect`` within atol 1e-6; ``env_sun_params`` within rtol 1e-5.
- The three boundary images on one small scene (ground, an out-of-frame
  blocker, a small visible triangle, a sphere light sampled by
  ``light_u``, the sun sky, env NEE, "bvh"): each exactly zero in value,
  and its gradients with respect to v0, v1, v2 and the camera eye within
  relative L2 1e-3 of ``jax.grad``'s (measured <= 1.5e-4: XLA's FMA
  contraction and summation order).  The port sums the length CDFs in
  float64 and rounds once, XLA in float32: the draws that land on another
  edge are counted and must be at most 4 of 2,048 per term.  The slice as
  a whole: ``render_with_edge_gradients``' value equals the port's
  ``render_with_samples`` exactly and JAX's render by the image criterion
  of tests/test_torch_render.py (>= 98% of pixels ``isclose(rtol=1e-3,
  atol=1e-3)``, the mean within 0.5%: env NEE's texel draws and FMA
  contraction move a few pixels), and its
  gradients equal the sum of JAX's four parts (the primal and the three
  boundary images) within relative L2 1e-3.

The FD mirrors (tests/test_edge_gradients.py:53-504) run the port alone on
the JAX tests' own sample arrays (the same keys), under the same bounds
(``tests/torch_edge_cases.py``; the losses summed in float32, as there).  The
env-sun mirror averages 8 keys and stays red; a further test shows why
(the env-sun term is exact for its point-sun model, within 3%).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.models.camera import Camera as JCamera  # noqa: E402
from prismarine_core_tpu.models.geometry import TriangleSoup as JSoup  # noqa: E402
from prismarine_core_tpu.models.lights import SphereLights as JLights  # noqa: E402
from prismarine_core_tpu.models.materials import MaterialTable as JMats  # noqa: E402
from prismarine_core_tpu.models import procedural as jproc  # noqa: E402
from prismarine_core_tpu.models.scene import Scene as JScene  # noqa: E402
from prismarine_core_tpu.models.textures import Environment as JEnv  # noqa: E402
from prismarine_core_tpu.ops.sampling import (  # noqa: E402
    make_sample_arrays as j_samples)
from prismarine_core_tpu.render import edge_grad as jeg  # noqa: E402
from prismarine_core_tpu.render.integrator import (  # noqa: E402
    render_with_samples as j_render)
from prismarine_core_tpu.utils.config import RenderConfig as JConfig  # noqa: E402
from prismarine_core_tpu_torch import interop  # noqa: E402
from prismarine_core_tpu_torch.models.camera import Camera  # noqa: E402
from prismarine_core_tpu_torch.models import procedural as tproc  # noqa: E402
from prismarine_core_tpu_torch.models.geometry import TriangleSoup  # noqa: E402
from prismarine_core_tpu_torch.models.lights import SphereLights  # noqa: E402
from prismarine_core_tpu_torch.models.materials import MaterialTable  # noqa: E402
from prismarine_core_tpu_torch.models.scene import Scene  # noqa: E402
from prismarine_core_tpu_torch.models.scene import make_cornell_scene  # noqa: E402
from prismarine_core_tpu_torch.models.textures import Environment  # noqa: E402
from prismarine_core_tpu_torch.render import edge_grad as teg  # noqa: E402
from prismarine_core_tpu_torch.render.integrator import (  # noqa: E402
    render_with_samples)
from prismarine_core_tpu_torch.utils import math as pm  # noqa: E402
from prismarine_core_tpu_torch.utils.config import RenderConfig  # noqa: E402
from tests import torch_edge_cases as ec  # noqa: E402
from tests.test_torch_render import BENCH_KNOBS  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"


def _cams(**kw):
    jcam = JCamera.look_at(**kw)
    return jcam, interop.camera_from_numpy(
        {k: np.asarray(getattr(jcam, k)) for k in interop.CAMERA_KEYS},
        device=CPU)


def _t(x):
    return torch.tensor(np.asarray(x))


# --- primitives ----------------------------------------------------------

def test_camera_and_samples_cross_over():
    """``interop.camera_from_numpy`` carries a JAX camera's fields exactly
    and raises on a missing field; ``samples_from_numpy`` carries JAX-made
    edge sample arrays exactly."""
    jcam, tcam = _cams(**ec.DOWN)
    for k in interop.CAMERA_KEYS:
        np.testing.assert_array_equal(getattr(tcam, k).numpy(),
                                      np.asarray(getattr(jcam, k)))
    with pytest.raises(KeyError):
        interop.camera_from_numpy({"eye": np.zeros(3)}, device=CPU)
    eu, ebs = jeg.make_edge_sample_arrays(jax.random.key(4), 64, 2)
    teu, tebs = interop.samples_from_numpy(eu, ebs, device=CPU)
    assert teu.dtype == torch.float32 and tebs.shape == (2, 64, 11)
    np.testing.assert_array_equal(teu.numpy(), np.asarray(eu))
    np.testing.assert_array_equal(tebs.numpy(), np.asarray(ebs))


def test_projection_matches_jax():
    """Pixel coords within atol 1e-4 px and camera-z within 1e-5 of JAX's on
    1,000 seeded points in front of the camera; rays through 1,000 seeded
    pixel coords within 1e-5."""
    cfg_kw = dict(width=64, height=48, spp=1, max_bounces=1)
    jcam, tcam = _cams(eye=(0.3, 0.2, 3.0), target=(0.0, 0.1, 0.0),
                       fov_y_deg=50.0)
    rng = np.random.default_rng(0)
    p = rng.uniform(-1.5, 1.5, (1000, 3)).astype(np.float32)
    s_ref, z_ref = jeg.project_to_screen(jcam, JConfig(**cfg_kw), p)
    s, z = teg.project_to_screen(tcam, RenderConfig(**cfg_kw), _t(p))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-4)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-5)
    pix = (rng.uniform(0, 1, (1000, 2)) * [64, 48]).astype(np.float32)
    o_ref, d_ref = jeg.rays_through_screen(jcam, JConfig(**cfg_kw), pix)
    o, d = teg.rays_through_screen(tcam, RenderConfig(**cfg_kw), _t(pix))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-5)


def test_project_inverts_raygen():
    """tests/test_edge_gradients.py:53-65: a ray through screen point s,
    marched to t = 2.7, projects back to s (atol 1e-3), in front of the
    camera."""
    cfg = RenderConfig(width=64, height=48, spp=1, max_bounces=1)
    cam = Camera.look_at(**ec.FRONT, device=CPU)
    s = torch.tensor([[3.2, 7.9], [63.0, 0.5], [10.0, 47.5], [31.5, 23.5]])
    o, d = teg.rays_through_screen(cam, cfg, s)
    s2, z = teg.project_to_screen(cam, cfg, o + 2.7 * d)
    np.testing.assert_allclose(s2.numpy(), s.numpy(), atol=1e-3)
    assert bool((z > 0).all())


def _signed_zero_soup():
    """Two triangles sharing an edge, one of them holding the shared
    vertex with -0.0 coordinates, plus padding rows."""
    v = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                  [-0.0, -0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, -0.0]],
                 np.float32)
    return v, np.array([[0, 1, 2], [3, 4, 5]], np.int32), 4


def _multiplicity_inputs(name):
    """(v0, v1, v2, valid) numpy arrays of the named soup."""
    if name == "cornell":
        tri = make_cornell_scene(device=CPU).triangles
        return tuple(x.numpy() for x in (tri.v0, tri.v1, tri.v2, tri.valid))
    if name == "padded":
        v = np.array([[-0.7, -0.7, 0.0], [0.7, -0.7, 0.0], [-0.7, 0.7, 0.0],
                      [0.7, 0.7, 0.0]], np.float32)
        tri = JSoup.from_arrays(v, np.array([[0, 1, 2], [1, 3, 2]],
                                            np.int32), capacity=7)
    else:
        v, f, cap = _signed_zero_soup()
        tri = JSoup.from_arrays(v, f, capacity=cap)
    return tuple(np.asarray(x) for x in (tri.v0, tri.v1, tri.v2, tri.valid))


@pytest.mark.parametrize("name", ["cornell", "padded", "signed_zero"])
def test_edge_multiplicity_matches_jax(name):
    """Equal ints to JAX's on every directed edge; the cornell box's
    interior edges count 2, the -0.0 copy of a vertex meets its +0.0
    twin."""
    v0, v1, v2, valid = _multiplicity_inputs(name)
    ea, eb = (np.concatenate(x) for x in ((v0, v1, v2), (v1, v2, v0)))
    ev = np.concatenate([valid] * 3)
    ref = np.asarray(jeg._edge_multiplicity(ea, eb, ev))
    got = teg._edge_multiplicity(_t(ea), _t(eb), _t(ev)).numpy()
    np.testing.assert_array_equal(got, ref)
    if name == "cornell":
        assert (got[ev] == 2).mean() > 0.5
    if name == "signed_zero":
        assert got[0] == 2 and got[1] == 2     # the shared edge


def test_clip_to_rect_matches_jax():
    """Liang-Barsky ranges within atol 1e-6 of JAX's on seeded segments,
    axis-parallel ones (inside and outside the rectangle) included."""
    rng = np.random.default_rng(1)
    sa = rng.uniform(-40, 80, (500, 2)).astype(np.float32)
    seg = rng.uniform(-60, 60, (500, 2)).astype(np.float32)
    seg[:40, 0] = 0.0
    seg[40:80, 1] = 0.0
    sa[60:70, 1] = -5.0                       # parallel, outside
    ref = jeg._clip_to_rect(sa, seg, 32, 24)
    got = teg._clip_to_rect(_t(sa), _t(seg), 32, 24)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("sky", ["sun", "bench"])
def test_env_sun_params_matches_jax(sky):
    """Sun direction and power within rtol 1e-5 of JAX's, on the env-sun
    test's sky and the bench sky."""
    if sky == "sun":
        je, te = JEnv.from_image(ec.sun_sky()), Environment.from_image(
            ec.sun_sky(), device=CPU)
    else:
        je = jproc.make_sky_environment(resolution=128)
        te = tproc.make_sky_environment(resolution=128, device=CPU)
    for a, b in zip(teg.env_sun_params(te), jeg.env_sun_params(je)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def test_make_edge_sample_arrays():
    """Shapes f32[B] and f32[bounces, B, 11]; edge_u stratified (draw i in
    [i/B, (i+1)/B)); the same generator seed gives the same arrays."""
    g = torch.Generator().manual_seed(3)
    eu, ebs = teg.make_edge_sample_arrays(g, 1000, 3)
    assert eu.shape == (1000,) and ebs.shape == (3, 1000, 11)
    i = torch.arange(1000)
    assert bool(((eu * 1000 >= i) & (eu * 1000 < i + 1)).all())
    assert bool(((ebs >= 0) & (ebs < 1)).all())
    eu2, ebs2 = teg.make_edge_sample_arrays(
        torch.Generator().manual_seed(3), 1000, 3)
    assert torch.equal(eu, eu2) and torch.equal(ebs, ebs2)


# --- the three boundary images and the slice, against jax.grad -----------

B = 2048
_KW = dict(width=24, height=24, spp=4, max_bounces=2, direct_light=True,
           env_nee=True, intersector="bvh")
_LIGHT = dict(center=(0.5, 8.0, 0.3), radius=0.3, color=(150.0, 150.0, 150.0))
_MATS = [dict(diffuse=(0.75, 0.75, 0.75)), dict(diffuse=(0.0, 0.0, 0.0)),
         dict(diffuse=(0.8, 0.3, 0.2))]
TERMS = ("edge", "shadow", "env")
LEAVES = ("v0", "v1", "v2", "eye")


def _combo_arrays():
    """A ground (normals +y), the env-sun test's out-of-frame blocker and a
    small visible triangle above the ground: every term is non-zero."""
    s = np.asarray(jeg.env_sun_params(JEnv.from_image(ec.sun_sky()))[0])
    blocker = 1.8 * s + np.array([[-0.45, 0, -0.25], [0.35, 0, 0.4],
                                  [-0.05, 0, -0.5]])
    verts = np.concatenate([
        [[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]], blocker,
        [[-0.15, 0.3, -0.1], [0.2, 0.3, 0.05], [0.0, 0.3, 0.2]]]
    ).astype(np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [7, 9, 8]], np.int32)
    return verts, faces, np.array([0, 0, 1, 2], np.int32)


@pytest.fixture(scope="module")
def combo():
    verts, faces, mids = _combo_arrays()
    jscene = JScene.assemble(JSoup.from_arrays(verts, faces, mat_ids=mids),
                             JMats.build(_MATS), JLights.single(**_LIGHT),
                             JEnv.from_image(ec.sun_sky()))
    tscene = Scene.assemble(
        TriangleSoup.from_arrays(verts, faces, mat_ids=mids, device=CPU),
        MaterialTable.build(_MATS, device=CPU),
        SphereLights.single(**_LIGHT, device=CPU),
        Environment.from_image(ec.sun_sky(), device=CPU))
    jcam, tcam = _cams(**ec.DOWN)
    jcfg = JConfig(**_KW)
    cam_s, bounce_s = j_samples(jax.random.key(0), jcfg.n_rays, 2)
    eu, ebs = jeg.make_edge_sample_arrays(jax.random.key(5), B, 2)
    light_u = jax.random.uniform(jax.random.key(9), (B, 2))
    w = np.linspace(0.5, 1.5, 24 * 24 * 3, dtype=np.float32).reshape(
        24, 24, 3)

    def parts(v0, v1, v2, eye):
        sc = dataclasses.replace(jscene, triangles=dataclasses.replace(
            jscene.triangles, v0=v0, v1=v1, v2=v2)).with_bvh()
        cam = dataclasses.replace(jcam, eye=eye)
        imgs = (jeg.edge_boundary_image(sc, cam, jcfg, eu, ebs),
                jeg.shadow_boundary_image(sc, cam, jcfg, eu,
                                          light_u=light_u),
                jeg.env_shadow_boundary_image(sc, cam, jcfg, eu),
                j_render(sc, cam, jcfg, cam_s, bounce_s))
        return jnp.stack([jnp.sum(x * w) for x in imgs])

    tri = jscene.triangles
    jac = jax.jit(jax.jacrev(parts, argnums=(0, 1, 2, 3)))(
        tri.v0, tri.v1, tri.v2, jcam.eye)
    return dict(
        tscene=tscene, tcam=tcam, cfg=RenderConfig(**_KW), w=_t(w),
        jac=[np.asarray(x) for x in jac],
        jax_img=np.asarray(j_render(jscene, jcam, jcfg, cam_s, bounce_s)),
        samples=interop.samples_from_numpy(cam_s, bounce_s, eu, ebs, light_u,
                                           device=CPU))


def _port_grads(combo, fn):
    """fn(scene, camera) -> image; returns (image, grads of sum(img * w)
    with respect to LEAVES, zeros where unused)."""
    sc, cam = combo["tscene"], combo["tcam"]
    leaves = [getattr(sc.triangles, k).clone().requires_grad_(True)
              for k in LEAVES[:3]] + [cam.eye.clone().requires_grad_(True)]
    scene = dataclasses.replace(sc, triangles=dataclasses.replace(
        sc.triangles, **dict(zip(LEAVES[:3], leaves[:3]))))
    img = fn(scene, dataclasses.replace(cam, eye=leaves[3]))
    grads = torch.autograd.grad((img * combo["w"]).sum(), leaves,
                                allow_unused=True)
    return img.detach(), [torch.zeros_like(x) if g is None else g
                          for x, g in zip(leaves, grads)]


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize("term", TERMS)
def test_boundary_image_matches_jax_grad(combo, term):
    """Value exactly zero; gradients with respect to v0, v1, v2 and eye
    within relative L2 1e-3 of jax.grad's, at least one of them non-zero."""
    cfg = combo["cfg"]
    _, _, eu, ebs, light_u = combo["samples"]
    fn = {"edge": lambda s, c: teg.edge_boundary_image(s, c, cfg, eu, ebs),
          "shadow": lambda s, c: teg.shadow_boundary_image(
              s, c, cfg, eu, light_u=light_u),
          "env": lambda s, c: teg.env_shadow_boundary_image(s, c, cfg, eu)}
    img, grads = _port_grads(combo, fn[term])
    assert float(img.abs().max()) == 0.0
    k = TERMS.index(term)
    refs = [combo["jac"][j][k] for j in range(4)]
    assert max(np.abs(r).max() for r in refs) > 1.0
    for name, g, ref in zip(LEAVES, grads, refs):
        assert np.isfinite(g.numpy()).all()
        assert _rel_l2(g.numpy(), ref) <= 1e-3, (term, name)


def test_cdf_draws_match_jax(combo):
    """The draws of each length CDF (the port's float64 sum rounded once
    against XLA's float32 cumsum on the same weights) pick the same edge
    for all but at most 4 of 2,048 uniforms."""
    scene, cfg, cam = combo["tscene"], combo["cfg"], combo["tcam"]
    eu = combo["samples"][2]
    ea, eb, evalid = teg._soup_edges(scene.triangles)
    mult = teg._edge_multiplicity(ea, eb, evalid)
    sa, za = teg.project_to_screen(cam, cfg, ea)
    sb, zb = teg.project_to_screen(cam, cfg, eb)
    tc0, tc1 = teg._clip_to_rect(sa, sb - sa, cfg.width, cfg.height)
    use = evalid & (za > teg._NEAR) & (zb > teg._NEAR) & (tc1 > tc0)
    screen = torch.where(use, torch.linalg.norm(sb - sa, dim=-1)
                         * (tc1 - tc0) / mult.float(), 0.0)
    len3 = torch.where(evalid, torch.linalg.norm(eb - ea, dim=-1)
                       / mult.float(), 0.0)
    for w_len in (screen, len3):
        idx = teg._draw_edges(w_len, eu)[0].numpy()
        cdf = jnp.cumsum(jnp.asarray(w_len.numpy()))
        ref = np.asarray(jnp.clip(jnp.searchsorted(
            cdf, jnp.asarray(eu.numpy()) * cdf[-1], side="right"),
            0, w_len.shape[0] - 1))
        assert int((idx != ref).sum()) <= 4


def test_slice_matches_jax(combo):
    """``render_with_edge_gradients`` with every term: its value equals the
    port's ``render_with_samples`` exactly and JAX's render by the image
    criterion; its gradients equal the sum of JAX's four parts within
    relative L2 1e-3."""
    cfg = combo["cfg"]
    cam_s, bounce_s, eu, ebs, light_u = combo["samples"]
    img, grads = _port_grads(combo, lambda s, c: (
        teg.render_with_edge_gradients(s, c, cfg, cam_s, bounce_s, eu, ebs,
                                       shadow_term=True, light_u=light_u)))
    primal = render_with_samples(combo["tscene"], combo["tcam"], cfg, cam_s,
                                 bounce_s)
    assert torch.equal(img, primal)
    a, b = img.numpy(), combo["jax_img"]
    assert np.isclose(a, b, rtol=1e-3, atol=1e-3).all(-1).mean() >= 0.98
    assert abs(a.mean() - b.mean()) <= 5e-3 * abs(b.mean())
    for j, (name, g) in enumerate(zip(LEAVES, grads)):
        ref = combo["jac"][j].sum(axis=0)
        assert _rel_l2(g.numpy(), ref) <= 1e-3, name


# --- the FD cases of tests/test_edge_gradients.py, on the port ----------

def _jax_samples(name, cam_key=0, edge_key=None):
    """The JAX test's sample arrays for case ``name`` (cam/bounce key 0,
    edge key 7 on the silhouette cases and 5 on the shadow cases, light_u
    key 9), as port tensors."""
    case = ec.CASES[name]
    cfg = ec.case_config(name)
    if edge_key is None:
        edge_key = 7 if cfg.intersector == "bvh" else 5
    cam_s, bounce_s = j_samples(jax.random.key(cam_key), cfg.n_rays,
                                cfg.max_bounces)
    eu, ebs = jeg.make_edge_sample_arrays(jax.random.key(edge_key),
                                          max(case.n_edge, 1),
                                          cfg.max_bounces)
    out = interop.samples_from_numpy(cam_s, bounce_s, eu, ebs, device=CPU)
    light_u = (interop.samples_from_numpy(
        jax.random.uniform(jax.random.key(9), (case.n_edge, 2)),
        device=CPU)[0] if case.light_u else None)
    return out + (light_u,)


def _assert_fd(name, samples=None):
    g, fd = ec.fd_check(name, samples or _jax_samples(name))
    assert abs(fd) > ec.CASES[name].min_fd, f"{name}: fd {fd}"
    assert ec.within(name, g, fd), f"{name}: gradient {g} vs FD {fd}"


def test_boundary_image_value_is_zero():
    """tests/test_edge_gradients.py:68-75."""
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=1,
                       intersector="bvh")
    eu, ebs = interop.samples_from_numpy(*jeg.make_edge_sample_arrays(
        jax.random.key(1), 512, 1), device=CPU)
    scene = ec.tri_scene(CPU).with_bvh()
    cam = Camera.look_at(**ec.FRONT, device=CPU)
    img = teg.edge_boundary_image(scene, cam, cfg, eu, ebs)
    assert float(img.abs().max()) == 0.0


@pytest.mark.parametrize("name", ["sweep_v0_x", "sweep_v2_y"])
def test_silhouette_sweep_matches_fd(name):
    """tests/test_edge_gradients.py:78-113: |g - fd| < 0.15 |fd| + 1e-2."""
    _assert_fd(name)


def test_shared_edge_not_double_counted():
    """tests/test_edge_gradients.py:116-162: |g - fd| < 0.2 |fd| + 1e-2
    (2x would be the shared diagonal counted twice)."""
    _assert_fd("shared_edge")


def test_detached_estimator_alone_misses_the_sweep():
    """tests/test_edge_gradients.py:165-192: without the boundary terms
    the rigid translation's gradient is < 0.05 |fd|."""
    g, fd = ec.fd_check("rigid_detached", _jax_samples("rigid_detached"),
                        edge_terms=False)
    assert abs(fd) > 1e-2
    assert abs(g) < 0.05 * abs(fd), (g, fd)


def test_inverse_rendering_recovers_vertex_offset():
    """tests/test_edge_gradients.py:195-230: 18 SGD steps (lr 1.2, fresh
    2,048 edge samples each, from the JAX test's key chain) pull a
    triangle translated by 0.35 to below 0.4 of that offset."""
    cfg = RenderConfig(width=24, height=24, spp=16, max_bounces=1,
                       intersector="bvh")
    cam = Camera.look_at(**ec.FRONT, device=CPU)
    cam_s, bounce_s = interop.samples_from_numpy(
        *j_samples(jax.random.key(3), cfg.n_rays, 1), device=CPU)
    base = ec.tri_scene(CPU)
    target = render_with_samples(base.with_bvh(), cam, cfg, cam_s, bounce_s)
    moves = ec.CASES["rigid_detached"].moves
    theta, key = 0.35, jax.random.key(11)
    for _ in range(18):
        key, sub = jax.random.split(key)
        eu, ebs = interop.samples_from_numpy(
            *jeg.make_edge_sample_arrays(sub, 2048, 1), device=CPU)
        th = torch.tensor(theta, requires_grad=True)
        img = teg.render_with_edge_gradients(
            ec.moved(base, th, moves, cfg), cam, cfg, cam_s, bounce_s, eu,
            ebs)
        (g,) = torch.autograd.grad(((img - target) ** 2).mean(), th)
        theta -= 1.2 * float(g)
    assert abs(theta) < 0.4 * 0.35, theta


def test_cast_shadow_silhouette_matches_fd():
    """tests/test_edge_gradients.py:233-298: |g - fd| < 0.25 |fd| + 5e-2."""
    _assert_fd("cast_shadow")


#: the env-sun mirror's keys: cam/bounce key k, edge key 5 + k
ENV_SUN_KEYS = 8


@pytest.mark.xfail(strict=True, reason=(
    "the env-sun term is biased on this scene in both packages (its "
    "point-sun model): ROADMAP queue 3"))
def test_env_sun_cast_shadow_matches_fd():
    """tests/test_edge_gradients.py:301-377, averaged: the JAX test is red
    on its one key (gradient -580 against FD -324, in both packages), so
    this mirror averages the gradient and the FD slope over 8 keys (cam
    key k, edge key 5 + k) and holds the means to the JAX test's bound
    |g - fd| < 0.3 |fd| + 5e-2.  It fails, and is marked a strict xfail
    so that a fix of the term shows as an XPASS failure: the gradient is
    -578 to -628 on every key while the FD slope averages about -385, so
    the env-sun term overestimates this scene's slope about 1.6x in both
    packages (the port's gradient equals JAX's, -580.27, on the JAX
    test's key).  It is a bias of the term's point-sun model, not
    variance: the next test holds the term to that model."""
    env = Environment.from_image(ec.sun_sky(), device=CPU)
    assert float(teg.env_sun_params(env)[0][1]) > 0.8
    gs, fds = zip(*(ec.fd_check("env_sun", _jax_samples("env_sun", k, 5 + k))
                    for k in range(ENV_SUN_KEYS)))
    g, fd = float(np.mean(gs)), float(np.mean(fds))
    assert abs(fd) > 5e-2, fds
    assert ec.within("env_sun", g, fd), (
        f"mean gradient {g} vs mean FD {fd} over {ENV_SUN_KEYS} keys: "
        f"{gs} / {fds}")


def test_env_sun_term_is_exact_for_a_point_sun():
    """Why the env-sun mirror above is red.  The env-sun term treats the
    sun disc as its central direction, a hard shadow.  On the env-sun scene
    its gradient (``env_shadow_boundary_image`` alone, the mean over the 8
    edge keys of the mirror) equals, within 3%, the derivative of that
    model computed without sampling: the line integral, over the screen
    outline of the blocker's shadow cast along the sun direction onto the
    ground, of W times the term's own jump magnitude (at each pixel
    centre) times the outline's normal speed.  The primal's FD slope is
    lower because its sun is a disc (a bilinear blob ~3 texels wide), and
    near the frame border the soft and the hard shadow move differently;
    the test's ramp W makes the slope a small difference of large leading-
    and trailing-edge terms, which that amplifies."""
    cfg = ec.case_config("env_sun")
    cam = Camera.look_at(**ec.DOWN, device=CPU)
    scene = ec.shadow_scene("env_sun", CPU)
    w = ec.weights(cfg, CPU)
    gs = []
    for k in range(ENV_SUN_KEYS):
        eu = _jax_samples("env_sun", 0, 5 + k)[2]
        theta = torch.zeros((), requires_grad=True)
        img = teg.env_shadow_boundary_image(
            ec.moved(scene, theta, ec.CASES["env_sun"].moves, cfg), cam, cfg,
            eu)
        gs.append(float(torch.autograd.grad((img * w).sum(), theta)[0]))
    with torch.no_grad():
        # W times the term's jump magnitude at each pixel centre
        h, wd = cfg.height, cfg.width
        pix = torch.stack(torch.meshgrid(torch.arange(wd) + 0.5,
                                         torch.arange(h) + 0.5,
                                         indexing="xy"), -1).reshape(-1, 2)
        o, d = teg.rays_through_screen(cam, cfg, pix)
        hit = teg.closest_hit(scene, o, d, cfg)
        surf, n_ff, p_diff = teg._diffuse_prob(scene, cfg, hit, d)
        s, power = teg.env_sun_params(scene.environment)
        f = (surf["albedo"] * power * (p_diff * torch.clamp(
            pm.dot(n_ff, s), min=0.0) / np.pi)[:, None])
        wf = (w.reshape(-1, 3) * f).sum(-1).reshape(h, wd).double().numpy()
        # the shadow triangle on the ground y = 0, on the screen, and its
        # screen velocity per unit theta (the ground maps affinely)
        tri = scene.triangles
        v = torch.stack([tri.v0[2], tri.v1[2], tri.v2[2]])
        shadow = v - (v[:, 1:2] / s[1]) * s
        t0, t1 = (teg.project_to_screen(cam, cfg, shadow + dx)[0].double()
                  .numpy() for dx in (0.0, torch.tensor([1.0, 0.0, 0.0])))
    vel = (t1 - t0).mean(0)
    e1, e2 = t0[1] - t0[0], t0[2] - t0[0]
    orient = np.sign(e1[0] * e2[1] - e1[1] * e2[0])
    model, m = 0.0, 200_000
    for a, b in ((t0[0], t0[1]), (t0[1], t0[2]), (t0[2], t0[0])):
        edge = b - a
        length = float(np.hypot(*edge))
        normal = orient * np.array([edge[1], -edge[0]]) / length
        p = a + ((np.arange(m) + 0.5) / m)[:, None] * edge
        ok = (p[:, 0] >= 0) & (p[:, 0] < wd) & (p[:, 1] >= 0) & (p[:, 1] < h)
        model -= (wf[p[ok, 1].astype(int), p[ok, 0].astype(int)].sum()
                  * length / m * float(normal @ vel))
    assert abs(np.mean(gs) - model) < 0.03 * abs(model), (gs, model)


def test_fat_light_shadow_fd_tolerance():
    """tests/test_edge_gradients.py:380-441 (light_u sampling the light):
    |g - fd| < 0.4 |fd| + 5e-2."""
    _assert_fd("fat_light")


def test_two_lights_shadow_terms_sum():
    """tests/test_edge_gradients.py:444-504: |g - fd| < 0.3 |fd| + 5e-2."""
    _assert_fd("two_lights")


def test_cornell_boundary_terms_run_on_pallas():
    """The boundary terms through the packet query: on the cornell box
    ("pallas", 16x16) the value is exactly zero and the vertex gradient
    is finite, non-zero, and within relative L2 1e-2 of the "bvh" one (the
    two queries tie-break differently on a few lanes)."""
    scene = make_cornell_scene(device=CPU)
    _, cam = _cams(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                   fov_y_deg=50.0)
    g = torch.Generator().manual_seed(2)
    eu, ebs = teg.make_edge_sample_arrays(g, 1024, 2)
    out = {}
    for inter in ("pallas", "bvh"):
        cfg = RenderConfig(width=16, height=16, spp=1, max_bounces=2,
                           **dict(BENCH_KNOBS, intersector=inter))
        v0 = scene.triangles.v0.clone().requires_grad_(True)
        sc = dataclasses.replace(scene, triangles=dataclasses.replace(
            scene.triangles, v0=v0))
        img = teg.boundary_images(sc, cam, cfg, eu, ebs, shadow_term=True)
        assert float(img.detach().abs().max()) == 0.0
        (out[inter],) = torch.autograd.grad(img.sum(), v0)
    assert bool(torch.isfinite(out["pallas"]).all())
    assert float(out["pallas"].abs().max()) > 0.0
    assert _rel_l2(out["pallas"].numpy(), out["bvh"].numpy()) <= 1e-2
