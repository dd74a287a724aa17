"""The port's texture stack, texture fetches and textured frames against
the JAX package's, on the CPU.

- ``from_images`` and ``with_packed_corners`` build the same arrays bit for
  bit (numpy on both sides), and so does the textured hall (uv, material
  ids and bindings, texture data, sizes and quads).
- ``sample_bilinear`` and ``sample_bicubic``, unpacked and packed, agree
  with JAX to atol 1e-5 on >= 99.9% of 4,096 seeded lanes (uv in [-2, 3),
  ids in [-1, N)); a lane off that bound is counted and must lie within
  1e-3 of a texel boundary of some tap (XLA contracts ``u * w - 0.5`` into
  an FMA, so a lane an ulp from an integer may floor to its neighbour).
- Packed and unpacked fetches are equal exactly in the port (the same
  texels in the same formula).
- Frames: the textured small hall on "brute", "pallas" and "pallas" with
  "bicubic", and the quad scene with each texture kind, meet
  tests/test_torch_render.py's image criterion against JAX on the same
  sample arrays: >= 98% of pixels ``isclose(rtol=1e-3, atol=1e-3)``, the
  mean within 0.5%, per-bounce lane counters within 0.5%.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.models import procedural as jproc  # noqa: E402
from prismarine_core_tpu.models import textures as jtex  # noqa: E402
from prismarine_core_tpu.models.geometry import (  # noqa: E402
    TriangleSoup as JSoup, make_quad)
from prismarine_core_tpu.models.lights import SphereLights as JLights  # noqa: E402
from prismarine_core_tpu.models.materials import (  # noqa: E402
    MaterialTable as JMaterials)
from prismarine_core_tpu.models.scene import Scene as JScene  # noqa: E402
from prismarine_core_tpu_torch import interop  # noqa: E402
from prismarine_core_tpu_torch.models import procedural as tproc  # noqa: E402
from prismarine_core_tpu_torch.models import textures as ttex  # noqa: E402
from tests.test_torch_render import (  # noqa: E402
    BENCH_KNOBS, CPU, HALL, _independent, assert_image_parity, render_both)
from tests.test_torch_scene import (  # noqa: E402
    assert_dataclass_equal, jax_scene_arrays)

torch.set_num_threads(1)


def _images(rng):
    """Textures of several shapes: square RGB, non-square RGBA, a gray
    2-D image, and one over the cap of 32."""
    return [rng.uniform(0, 1, (8, 8, 3)).astype(np.float32),
            rng.uniform(0, 1, (16, 32, 4)).astype(np.float32),
            rng.uniform(0, 1, (17, 23)).astype(np.float32),
            rng.uniform(0, 1, (40, 70, 3)).astype(np.float32)]


def _stacks(packed: bool):
    imgs = _images(np.random.default_rng(9))
    js = jtex.TextureStack.from_images(imgs, resolution=32)
    ts = ttex.TextureStack.from_images(imgs, resolution=32, device=CPU)
    if packed:
        js, ts = js.with_packed_corners(), ts.with_packed_corners()
    return js, ts


def _assert_stack_equal(ts, js):
    for f in ("data", "sizes", "quad"):
        a, b = getattr(ts, f), getattr(js, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)


def test_from_images_and_packed_corners_equal_jax():
    """Native sizes (the 70-wide image capped to 32 by a box factor of 3:
    23 x 13), padding and the corner-packed quads, bit for bit."""
    for packed in (False, True):
        js, ts = _stacks(packed)
        _assert_stack_equal(ts, js)
    np.testing.assert_array_equal(
        ts.sizes.numpy(), [[8, 8], [32, 16], [23, 17], [23, 13]])
    # a stack with no size table packs at the full stack dims
    flat = ttex.TextureStack(data=ts.data).with_packed_corners()
    jflat = jtex.TextureStack(data=js.data).with_packed_corners()
    np.testing.assert_array_equal(flat.quad.numpy(), np.asarray(jflat.quad))


def _boundary(uv, wh, tol=1e-3):
    """Lanes within ``tol`` texels of a bilinear floor boundary."""
    x = np.mod(uv, 1.0) * wh - 0.5
    return (np.abs(x - np.round(x)) < tol).any(-1)


def _bicubic_boundary(uv, wh, tol=1e-3):
    """Lanes within ``tol`` texels of a floor boundary of the bicubic
    fetch: its own floor of uv * size, or a floor of one of its four
    bilinear taps (their coordinates in float64)."""
    tc = uv.astype(np.float64) * wh
    near = (np.abs(tc - np.round(tc)) < tol).any(-1)
    f = np.mod(tc, 1.0)
    base = np.floor(tc)
    s = np.stack([(k - f) ** 3 for k in (1.0, 2.0, 3.0, 4.0)], -1)
    x = s[..., 0]
    y = s[..., 1] - 4.0 * x
    z = s[..., 2] - 4.0 * s[..., 1] + 6.0 * x
    ww = 6.0 - x - y - z
    taps = [(base + y / (x + y)) / wh, (base + 1.0 + ww / (z + ww)) / wh]
    for tx in taps:
        for ty in taps:
            near |= _boundary(np.stack([tx[:, 0], ty[:, 1]], -1), wh, tol)
    return near


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
def test_fetch_matches_jax(filt, packed):
    """4,096 seeded lanes, uv in [-2, 3) (negative uv wrap by floored
    modulo), ids in [-1, N): atol 1e-5 on >= 99.9% of lanes, the rest
    only at texel boundaries; id -1 returns white exactly."""
    js, ts = _stacks(packed)
    rng = np.random.default_rng(4)
    n = ts.count
    tid = rng.integers(-1, n, 4096).astype(np.int32)
    uv = rng.uniform(-2, 3, (4096, 2)).astype(np.float32)
    jf = getattr(jtex, f"sample_{filt}")
    tf = getattr(ttex, f"sample_{filt}")
    ref = np.asarray(jf(js, jnp.asarray(tid), jnp.asarray(uv)))
    got = tf(ts, torch.tensor(tid), torch.tensor(uv)).numpy()
    off = np.abs(got - ref).max(-1) > 1e-5
    wh = ts.sizes.numpy()[np.clip(tid, 0, n - 1)].astype(np.float32)
    near = (_bicubic_boundary if filt == "bicubic" else _boundary)(uv, wh)
    print(f"{filt} packed={packed}: {off.sum()} of {len(off)} lanes off "
          f"atol 1e-5 ({(off & near).sum()} at texel boundaries)")
    assert off.mean() <= 1e-3
    assert not (off & ~near).any()
    assert (got[tid < 0] == 1.0).all()
    assert np.isfinite(got).all()


@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
def test_packed_equals_unpacked(filt):
    """One row gather of the corner quad gives exactly the four texels'
    result."""
    _, ts = _stacks(False)
    _, tp = _stacks(True)
    rng = np.random.default_rng(3)
    tid = torch.tensor(rng.integers(-1, ts.count, 2000).astype(np.int32))
    uv = torch.tensor(rng.uniform(-2, 3, (2000, 2)).astype(np.float32))
    fn = getattr(ttex, f"sample_{filt}")
    assert torch.equal(fn(ts, tid, uv), fn(tp, tid, uv))


@pytest.fixture(scope="module")
def textured_halls():
    return (jproc.make_hall_scene(target_tris=3000, textured=True,
                                  texture_resolution=64),
            tproc.make_hall_scene(target_tris=3000, textured=True,
                                  texture_resolution=64, device=CPU))


def test_textured_hall_equals_jax(textured_halls):
    """The port's textured hall: soup (oblique uv), materials (diffuse
    0/1/2 and bump 3 on floor, walls and columns), texture data, sizes
    and quads equal to the JAX package's bit for bit."""
    jh, th = textured_halls
    for g in ("triangles", "materials", "lights", "environment", "bvh",
              "packets"):
        assert_dataclass_equal(getattr(th, g), getattr(jh, g), g)
    _assert_stack_equal(th.textures, jh.textures)
    assert not th.textures.stub and th.textures.quad is not None
    assert th.materials.kinds_bound == (True, False, False, True)
    uv = th.triangles.t0.numpy()
    assert (uv < 0).any() and (uv > 1).any()      # wrap both ways


@pytest.mark.parametrize("knobs", [
    dict(intersector="brute"), BENCH_KNOBS,
    dict(BENCH_KNOBS, texture_filter="bicubic")],
    ids=["brute", "pallas", "pallas-bicubic"])
def test_textured_small_hall_matches_jax(textured_halls, knobs):
    """The textured small hall (3,000 tris, 64^2 textures) at 32x24 and 2
    bounces; the port renders the JAX scene carried over by interop, so
    both packages fetch from identical texture arrays."""
    jh, _ = textured_halls
    th = interop.scene_from_numpy(jax_scene_arrays(jh), device=CPU)
    cfg_kw = dict(width=32, height=24, spp=1, max_bounces=2, **knobs)
    (img, st), (ref, rst) = render_both(jh, th, **HALL, cfg_kw=cfg_kw,
                                        samples=_independent)
    assert img.mean() > 1e-2
    assert_image_parity(img, ref, st, rst)


def _quad_scene(tex_slot, img):
    """A lit quad facing the camera with planar uv; ``tex_slot`` binds
    texture 0 (as tests/test_textures.py builds it), in JAX."""
    verts, faces, mids = make_quad((-1, -1, 0), (1, -1, 0), (1, 1, 0),
                                   (-1, 1, 0), mat_id=0)
    uvs = ((verts[:, :2] + 1.0) * 0.5).astype(np.float32)
    tris = JSoup.from_arrays(verts, faces, mat_ids=mids, texcoords=uvs)
    mat = {"diffuse": (0.6, 0.6, 0.6), "roughness": 0.4, "metallic": 0.3,
           "emissive": (0.05, 0.05, 0.05)}
    if tex_slot:
        mat[tex_slot] = 0
    return JScene.assemble(
        tris, JMaterials.build([mat]),
        JLights.single(center=(0.8, 0.8, 2.0), radius=0.2,
                       color=(30.0, 30.0, 30.0)),
        jtex.Environment.constant((0.2, 0.2, 0.25)),
        jtex.TextureStack.from_images([img], resolution=32),
        build_bvh=False)


@pytest.mark.parametrize("slot", ["tex_diffuse", "tex_specular",
                                  "tex_emissive", "tex_bump"])
def test_each_texture_kind_changes_the_image(slot):
    """Each of the four texture kinds changes the port's image (max pixel
    change > 1e-3 against the untextured quad, as
    tests/test_textures.py:67 holds JAX), and the textured image meets
    the image criterion against JAX."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0.0, 1.0, (16, 16, 4)).astype(np.float32)
    if slot == "tex_bump":
        n = rng.normal(size=(16, 16, 3)).astype(np.float32)
        n[..., 2] = np.abs(n[..., 2]) + 0.5
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        img[..., :3] = n * 0.5 + 0.5
    eye = dict(eye=(0.0, 0.0, 2.5), target=(0.0, 0.0, 0.0), fov=60.0)
    cfg_kw = dict(width=24, height=24, spp=2, max_bounces=2,
                  intersector="brute")
    frames = {}
    for s in (None, slot):
        js = _quad_scene(s, img)
        ts = interop.scene_from_numpy(jax_scene_arrays(js), device=CPU)
        frames[s] = render_both(js, ts, **eye, cfg_kw=cfg_kw,
                                samples=_independent)
    (img_t, st), (ref, rst) = frames[slot]
    assert np.isfinite(img_t).all()
    assert np.abs(frames[None][0][0] - img_t).max() > 1e-3
    assert_image_parity(img_t, ref, st, rst)


def test_bicubic_properties():
    """The port's bicubic fetch interpolates a constant exactly (rtol
    1e-5), stays in [0, 1] (to 1e-4) on a checker where it differs from
    bilinear by > 0.01, and returns white for id -1."""
    const = ttex.TextureStack(data=torch.full((1, 8, 8, 4), 0.37))
    g = torch.Generator().manual_seed(1)
    uv = torch.rand((64, 2), generator=g)
    tid = torch.zeros((64,), dtype=torch.int32)
    np.testing.assert_allclose(ttex.sample_bicubic(const, tid, uv).numpy(),
                               0.37, rtol=1e-5)
    checker = np.indices((8, 8)).sum(axis=0) % 2
    data = np.ones((1, 8, 8, 4), np.float32) * checker[None, :, :, None]
    stack = ttex.TextureStack(data=torch.tensor(data))
    bil = ttex.sample_bilinear(stack, tid, uv).numpy()
    bic = ttex.sample_bicubic(stack, tid, uv).numpy()
    assert np.abs(bil - bic).max() > 0.01
    assert bic.min() >= -1e-4 and bic.max() <= 1.0 + 1e-4
    neg = ttex.sample_bicubic(stack, torch.full((4,), -1, dtype=torch.int32),
                              uv[:4])
    assert (neg == 1.0).all()


def test_interop_marks_only_the_white_stack_stub():
    """A single all-white texture with no size table crosses as the stub
    stack; a JAX ``from_images`` stack (with sizes) does not, even when
    white, and keeps its arrays."""
    js = jtex.TextureStack.from_images([np.ones((4, 4, 3), np.float32)])
    arrays = jax_scene_arrays(dataclasses.replace(
        jproc.make_hall_scene(target_tris=2000, build_bvh=False),
        textures=js))
    assert not interop.scene_from_numpy(arrays, device=CPU).textures.stub
    del arrays["textures.sizes"]
    assert interop.scene_from_numpy(arrays, device=CPU).textures.stub
