"""The integrator's packet-path flags in the port against the JAX package,
on the CPU: ``reuse_bounce_order`` (tests/test_packet.py:114),
``primary_identity`` (:242, its three configurations) and
``primary_tile_order`` (:334, lane-constant and coherent samples), each
frame against JAX's frame of the same flags and against the port's own
frame without them; the 16x8 tile lane order's constants; and
"pallas_sharded", which accepts the three flags and ignores them, as the
JAX package does (its ``trace`` peels bounce 0 off under "pallas" alone).

Tolerances: the JAX tests' own (atol 1e-4 against the frame without the
flag: any ray order gives the same hits but on coplanar-edge ties; 1e-5 for
the tile order on lane-constant samples), and against JAX
tests/test_torch_render.py's image criterion (>= 98% of pixels
``isclose(rtol=1e-3, atol=1e-3)``, the mean within 0.5%: XLA on the CPU
contracts multiply-adds into FMAs where torch does not; on lane-constant
samples the pixel half of it, the mean's place taken by the scanline
frames' differing pixels, see that test).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.models import camera as jcamera  # noqa: E402
from prismarine_core_tpu.models.scene import (  # noqa: E402
    make_cornell_scene as j_cornell)
from prismarine_core_tpu.ops import sampling as jsmp  # noqa: E402
from prismarine_core_tpu.render import integrator as jint  # noqa: E402
from prismarine_core_tpu.utils.config import RenderConfig as JConfig  # noqa: E402
from prismarine_core_tpu_torch.models import camera as tcamera  # noqa: E402
from prismarine_core_tpu_torch.models import procedural as tproc  # noqa: E402
from prismarine_core_tpu_torch.models.scene import make_cornell_scene  # noqa: E402
from prismarine_core_tpu_torch.ops import sampling as tsmp  # noqa: E402
from prismarine_core_tpu_torch.parallel import shard_intersect as tsi  # noqa: E402
from prismarine_core_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, make_sharded_renderer)
from prismarine_core_tpu_torch.render import integrator as tint  # noqa: E402
from prismarine_core_tpu_torch.utils.config import RenderConfig  # noqa: E402
from tests.test_torch_render import (  # noqa: E402
    CORNELL, HALL, assert_image_parity)

torch.set_num_threads(1)
CPU = "cpu"
CAM = tcamera.Camera.look_at(eye=CORNELL["eye"], target=CORNELL["target"],
                             fov_y_deg=CORNELL["fov"], device=CPU)
JCAM = jcamera.Camera.look_at(eye=CORNELL["eye"], target=CORNELL["target"],
                              fov_y_deg=CORNELL["fov"])
#: the frame of tests/test_packet.py:114 and :242
FRAME = dict(width=24, height=24, spp=1, max_bounces=3, intersector="pallas")


@pytest.fixture(scope="module")
def scenes():
    return j_cornell(), make_cornell_scene(device=CPU)


def _frames(scenes, cfg_kw, samples, flags):
    """(port frame with ``flags``, port frame without, JAX frame with), numpy;
    ``samples`` JAX arrays given to both packages."""
    js, ts = scenes
    cam_s, bounce_s = samples
    tc, bc = (torch.tensor(np.asarray(x)) for x in samples)
    cfg = RenderConfig(**cfg_kw)
    img = tint.render_with_samples(ts, CAM, cfg.replace(**flags), tc, bc)
    ref = tint.render_with_samples(ts, CAM, cfg, tc, bc)
    jimg = jint.render_with_samples(js, JCAM, JConfig(**cfg_kw, **flags),
                                    cam_s, bounce_s)
    return img.numpy(), ref.numpy(), np.asarray(jimg)


def _key0(cfg_kw):
    cfg = JConfig(**cfg_kw)
    return jsmp.make_sample_arrays(jax.random.key(0), cfg.n_rays,
                                   cfg.max_bounces)


def test_reuse_bounce_order_frame(scenes):
    img, ref, jimg = _frames(scenes, FRAME, _key0(FRAME),
                             dict(reuse_bounce_order=True))
    np.testing.assert_allclose(img, ref, atol=1e-4)
    assert_image_parity(img, jimg)
    assert img.mean() > 1e-2


@pytest.mark.parametrize("extra", [
    dict(), dict(cull_impl="pallas2", pairs_per_step=4), dict(max_bounces=1),
], ids=["default", "pallas2", "one-bounce"])
def test_primary_identity_frame(scenes, extra):
    cfg_kw = dict(FRAME, **extra)
    img, ref, jimg = _frames(scenes, cfg_kw, _key0(cfg_kw),
                             dict(primary_identity=True))
    np.testing.assert_allclose(img, ref, atol=1e-4)
    assert_image_parity(img, jimg)


#: the frame of tests/test_packet.py:334 (whole 16x8 tiles)
TILE_FRAME = dict(FRAME, width=32)


def test_tile_pixel_perm_equals_jax():
    for w, h in ((32, 24), (64, 16)):
        cfg = RenderConfig(width=w, height=h, intersector="pallas",
                           primary_tile_order=True)
        jcfg = JConfig(width=w, height=h, intersector="pallas",
                       primary_tile_order=True)
        perm = tcamera.tile_pixel_perm(cfg, CPU)
        inv = tcamera.tile_pixel_inv_perm(cfg, CPU)
        np.testing.assert_array_equal(
            perm.numpy(), np.asarray(jcamera.tile_pixel_perm(jcfg)))
        np.testing.assert_array_equal(
            inv.numpy(), np.asarray(jcamera.tile_pixel_inv_perm(jcfg)))
        assert torch.equal(perm[inv], torch.arange(w * h))
        # lanes 0..127: the first 16x8 rect of the frame
        first = perm[:128]
        assert set((first % w).tolist()) == set(range(16))
        assert set((first // w).tolist()) == set(range(8))
    for kw in (dict(width=40), dict(height=20), dict(intersector="bvh"),
               dict(intersector="pallas_sharded")):
        cfg = RenderConfig(**dict(TILE_FRAME, primary_tile_order=True, **kw))
        assert not tcamera.tile_order_active(cfg)
        assert tcamera.tile_order_active(cfg) == jcamera.tile_order_active(
            JConfig(**cfg.__dict__))


def test_primary_tile_order_lane_constant_frame(scenes):
    """tests/test_packet.py:334's first half: lane-constant samples.  Every
    camera ray then passes through its pixel's centre, and a few of those
    centres lie on a triangle edge, where one FMA contraction flips the
    hit: JAX is held by the pixel criterion (>= 98% of pixels) and every
    pixel off JAX's tile-order frame must be off JAX's scanline frame in
    the port's scanline frame too (the tile order adds no difference; a
    flipped pixel moves this 768-pixel frame's mean by ~0.05%, so the mean
    is not compared)."""
    js, _ = scenes
    cfg = JConfig(**TILE_FRAME)
    samples = (jnp.full((cfg.n_rays, 4), 0.5),
               jnp.full((cfg.max_bounces, cfg.n_rays, 11), 0.37))
    img, ref, jimg = _frames(scenes, TILE_FRAME, samples,
                             dict(primary_tile_order=True))
    np.testing.assert_allclose(img, ref, atol=1e-5)
    jref = np.asarray(jint.render_with_samples(js, JCAM, cfg, *samples))
    off = ~np.isclose(img, jimg, rtol=1e-3, atol=1e-3).all(axis=-1)
    off_scan = ~np.isclose(ref, jref, rtol=1e-3, atol=1e-3).all(axis=-1)
    print(f"{int(off.sum())} of {off.size} pixels off JAX's tile-order "
          f"frame, {int(off_scan.sum())} off its scanline frame")
    assert off.mean() <= 0.02
    assert not (off & ~off_scan).any()
    assert np.isfinite(img).all() and img.mean() > 1e-2


def test_primary_tile_order_coherent_frame(scenes):
    """tests/test_packet.py:334's second half: coherent samples, their
    block ids following the lanes' pixels (JAX's arrays in both packages);
    and the port's own coherent arrays: lane p of the tile order carries
    the bounce uniforms of its pixel's block, as the scanline arrays of
    the same generator do at that pixel."""
    js, ts = scenes
    flags = dict(primary_tile_order=True, coherent_bounce_sampling=True)
    jcfg = JConfig(**TILE_FRAME, **flags)
    cs, bs = jsmp.make_coherent_sample_arrays(jax.random.key(1), jcfg,
                                              block=(8, 16))
    img, _, jimg = _frames(scenes, TILE_FRAME, (cs, bs), flags)
    assert np.isfinite(img).all() and img.mean() > 1e-2
    assert_image_parity(img, jimg)

    cfg = RenderConfig(**TILE_FRAME, **flags)
    c_t, b_t = tsmp.make_coherent_sample_arrays(
        torch.Generator().manual_seed(3), cfg, block=(8, 16))
    c_s, b_s = tsmp.make_coherent_sample_arrays(
        torch.Generator().manual_seed(3), cfg.replace(
            primary_tile_order=False), block=(8, 16))
    perm = tcamera.tile_pixel_perm(cfg, CPU)
    assert torch.equal(c_t, c_s)                  # per lane, independent
    assert torch.equal(b_t, b_s[:, perm])
    img_t = tint.render_with_samples(ts, CAM, cfg, c_t, b_t)
    assert torch.isfinite(img_t).all() and float(img_t.mean()) > 1e-2


def test_tile_order_equals_scanline_with_moved_samples(scenes):
    """Independent samples: the tile-order frame equals the scanline frame
    whose lane p takes tile lane ``tile_pixel_inv_perm[p]``'s camera and
    bounce uniforms (every pixel then sees the same numbers; only the
    lanes' grouping into ray tiles differs), interlaced stage 1 too."""
    _, ts = scenes
    cfg = RenderConfig(**dict(TILE_FRAME, max_bounces=2))
    gen = torch.Generator().manual_seed(5)
    cs, bs = tsmp.make_sample_arrays(gen, cfg.n_rays, cfg.max_bounces)
    inv = tcamera.tile_pixel_inv_perm(cfg, CPU)
    for extra in (dict(), dict(interlace=True)):
        c = cfg.replace(**extra)
        img = tint.render_with_samples(ts, CAM, c.replace(
            primary_tile_order=True), cs, bs, interlace_stage=1)
        ref = tint.render_with_samples(ts, CAM, c, cs[inv], bs[:, inv],
                                       interlace_stage=1)
        np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=1e-4)
        assert float(ref.mean()) > 1e-2


@pytest.mark.parametrize("flag", ["primary_identity", "primary_tile_order",
                                  "reuse_bounce_order"])
def test_sharded_accepts_and_ignores_primary_flags(flag):
    """"pallas_sharded" on a 1x2 CPU mesh with "xla" and "group": each flag
    is accepted and changes nothing (bit for bit), and the frame is the
    single device's "pallas" frame of the same knobs (without the flag,
    which "pallas" would act on)."""
    scene = tproc.make_hall_scene(target_tris=3000, device=CPU)
    cam = tcamera.Camera.look_at(eye=HALL["eye"], target=HALL["target"],
                                 fov_y_deg=HALL["fov"], device=CPU)
    cfg = RenderConfig(width=64, height=32, spp=1, max_bounces=2,
                       intersector="pallas", cull_impl="xla",
                       sort_mode="group")
    assert cfg.n_rays >= 2048                     # "group" applies
    cs, bs = tsmp.make_sample_arrays(torch.Generator().manual_seed(2),
                                     cfg.n_rays, cfg.max_bounces)
    ref = tint.render_with_samples(scene, cam, cfg, cs, bs)
    mesh = make_mesh(2, model_parallel=2, devices=[CPU] * 2)
    dscene = tsi.distribute_scene(scene, mesh)
    cfg_sh = cfg.replace(intersector="pallas_sharded", mesh=mesh)
    img = tint.render_with_samples(dscene, cam, cfg_sh.replace(**{flag: True}),
                                   cs, bs)
    assert torch.equal(img, tint.render_with_samples(dscene, cam, cfg_sh, cs,
                                                     bs))
    same = float(np.all(img.numpy() == ref.numpy(), axis=-1).mean())
    print(f"{flag}: {same:.4f} of pixels bit-identical to one device")
    assert_image_parity(img.numpy(), ref.numpy())
    assert same >= 0.99


@pytest.mark.parametrize("interlace", [False, True],
                         ids=["full", "interlaced"])
def test_sharded_renderer_tile_order_frame(scenes, interlace):
    """``make_sharded_renderer`` on a 2x1 CPU mesh under "pallas" with the
    tile order: each data row traces its chunk of the tile-order lanes (and
    of the interlace mask in that order), and the gathered radiance is put
    back in pixel order before the image, so the frame is the single
    device's (atol 1e-4, as test_packet.py's ray-order tolerance)."""
    _, ts = scenes
    cfg = RenderConfig(**dict(TILE_FRAME, max_bounces=2,
                              primary_tile_order=True, interlace=interlace))
    assert tcamera.tile_order_active(cfg)
    cs, bs = tsmp.make_sample_arrays(torch.Generator().manual_seed(6),
                                     cfg.n_rays, cfg.max_bounces)
    ref = tint.render_with_samples(ts, CAM, cfg, cs, bs)
    mesh = make_mesh(2, devices=[CPU] * 2)
    img = make_sharded_renderer(mesh, cfg)(ts, CAM, cs, bs)
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=1e-4)
    assert float(ref.mean()) > 1e-2
