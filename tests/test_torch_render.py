"""Whole-frame parity: the port's ``render_with_samples`` against the JAX
package's on the same (JAX-made) sample arrays, for the "brute" and
"pallas" intersectors, plus the numpy oracle once for the brute path.

Image criterion (tests/test_packet.py:440-442): >= 98% of pixels
``isclose(rtol=1e-3, atol=1e-3)`` and the image mean within 0.5%; the
per-bounce lane counters within 0.5%.  Pixels may differ where a 1-ulp
difference (XLA on the CPU contracts multiply-adds into FMAs, torch does
not) flips a hit at a triangle edge or a branch coin.

The bench frame's own configuration at a small size is in
tests/test_torch_slice.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402

from prismarine_core_tpu.models import procedural as jproc  # noqa: E402
from prismarine_core_tpu.models.camera import Camera as JCamera  # noqa: E402
from prismarine_core_tpu.models.scene import (  # noqa: E402
    make_cornell_scene as j_cornell)
from prismarine_core_tpu.ops.sampling import make_sample_arrays  # noqa: E402
from prismarine_core_tpu.render import integrator as jint  # noqa: E402
from prismarine_core_tpu.utils.config import RenderConfig as JConfig  # noqa: E402
from prismarine_core_tpu_torch.models import procedural as tproc  # noqa: E402
from prismarine_core_tpu_torch.models.camera import Camera  # noqa: E402
from prismarine_core_tpu_torch.models.scene import make_cornell_scene  # noqa: E402
from prismarine_core_tpu_torch.render import integrator as tint  # noqa: E402
from prismarine_core_tpu_torch.utils.config import RenderConfig  # noqa: E402

torch.set_num_threads(1)
#: the port's constructors default to the card; these tests run on the CPU
CPU = "cpu"

#: the pallas knobs of bench.py's main configuration
BENCH_KNOBS = dict(intersector="pallas", bvh_leaf_size=4,
                   pairs_per_step=8, stale_round_masks=True,
                   anyhit_strategy="single", cull_impl="pallas2",
                   closest_k=16, cull_window=8192, cull_pps=16)


def assert_image_parity(img, ref, stats=None, ref_stats=None):
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-3).all(axis=-1)
    print(f"pixel parity {close.mean():.4f}, mean {img.mean():.6f} vs "
          f"{ref.mean():.6f}")
    assert np.isfinite(img).all()
    assert close.mean() >= 0.98, f"pixel parity {close.mean()}"
    assert abs(img.mean() - ref.mean()) <= 5e-3 * abs(ref.mean())
    if stats is not None:
        print("stats", stats.tolist(), "vs", ref_stats.tolist())
        np.testing.assert_allclose(stats, ref_stats, rtol=5e-3, atol=1)


def render_both(jscene, tscene, eye, target, fov, cfg_kw, samples):
    """Render one frame in both packages; returns numpy (img, stats)
    pairs (port first)."""
    jcfg, tcfg = JConfig(**cfg_kw), RenderConfig(**cfg_kw)
    cam_s, bounce_s = samples(jcfg)
    jimg, jst = jint.render_with_samples(
        jscene, JCamera.look_at(eye=eye, target=target, fov_y_deg=fov),
        jcfg, cam_s, bounce_s, with_stats=True)
    timg, tst = tint.render_with_samples(
        tscene, Camera.look_at(eye=eye, target=target, fov_y_deg=fov,
                               device=CPU), tcfg,
        torch.tensor(np.asarray(cam_s)), torch.tensor(np.asarray(bounce_s)),
        with_stats=True)
    return ((timg.numpy(), tst.numpy()),
            (np.asarray(jimg), np.asarray(jst)))


def _independent(cfg):
    return make_sample_arrays(jax.random.key(3), cfg.n_rays,
                              cfg.max_bounces)


CORNELL = dict(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0), fov=50.0)
HALL = dict(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0), fov=60.0)


@pytest.mark.parametrize("knobs", [dict(intersector="brute"),
                                   dict(intersector="bvh"), BENCH_KNOBS],
                         ids=["brute", "bvh", "pallas"])
def test_cornell_matches_jax(knobs):
    cfg_kw = dict(width=32, height=32, spp=1, max_bounces=3, **knobs)
    (img, st), (ref, rst) = render_both(
        j_cornell(), make_cornell_scene(device=CPU), **CORNELL,
        cfg_kw=cfg_kw, samples=_independent)
    assert img.mean() > 1e-2
    assert_image_parity(img, ref, st, rst)


@pytest.fixture(scope="module")
def small_halls():
    return (jproc.make_hall_scene(target_tris=3000),
            tproc.make_hall_scene(target_tris=3000, device=CPU))


@pytest.mark.parametrize("knobs", [dict(intersector="brute"),
                                   dict(intersector="bvh"), BENCH_KNOBS],
                         ids=["brute", "bvh", "pallas"])
def test_small_hall_matches_jax(small_halls, knobs):
    cfg_kw = dict(width=32, height=24, spp=1, max_bounces=2, **knobs)
    (img, st), (ref, rst) = render_both(*small_halls, **HALL,
                                        cfg_kw=cfg_kw, samples=_independent)
    assert img.mean() > 1e-2
    assert_image_parity(img, ref, st, rst)


def test_brute_matches_numpy_oracle():
    """The port against reference/cpu_reference.py, as
    tests/test_forward_vs_oracle.py holds the JAX package."""
    from prismarine_core_tpu.reference.cpu_reference import render_reference
    cfg_kw = dict(width=24, height=24, spp=1, max_bounces=3,
                  intersector="brute")
    cam_s, bounce_s = _independent(JConfig(**cfg_kw))
    scene = make_cornell_scene(device=CPU)
    cam = Camera.look_at(eye=CORNELL["eye"], target=CORNELL["target"],
                         fov_y_deg=CORNELL["fov"], device=CPU)
    img = tint.render_with_samples(
        scene, cam, RenderConfig(**cfg_kw), torch.tensor(np.asarray(cam_s)),
        torch.tensor(np.asarray(bounce_s))).numpy()
    ref = render_reference(scene, cam, RenderConfig(**cfg_kw),
                           np.asarray(cam_s), np.asarray(bounce_s))
    diff = np.abs(img - ref)
    bad = (diff.max(axis=-1) > 1e-3).mean()
    assert bad < 0.01, f"{bad:.2%} of pixels mismatch the oracle"
    assert float(np.median(diff)) < 1e-4
    assert img.mean() > 1e-3


def test_render_entry_point_and_unported_knobs():
    """``render`` draws its samples from a torch.Generator; the knobs the
    port once refused run and give the default frame (up to tie lanes),
    and a value no package defines raises ValueError."""
    scene = make_cornell_scene(device=CPU)
    cam = Camera.look_at(eye=CORNELL["eye"], target=CORNELL["target"],
                         fov_y_deg=CORNELL["fov"], device=CPU)
    cfg = RenderConfig(width=16, height=16, max_bounces=2,
                       coherent_bounce_sampling=True, **BENCH_KNOBS)
    a = tint.render(scene, cam, cfg, torch.Generator().manual_seed(1))
    b = tint.render(scene, cam, cfg, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert a.shape == (16, 16, 3) and a.mean() > 1e-2
    for knob in (dict(reuse_bounce_order=True), dict(primary_identity=True),
                 dict(primary_tile_order=True), dict(sort_mode="group"),
                 dict(cull_impl="xla"),
                 dict(near_frac=0.5), dict(intersector="packet")):
        img = tint.render(scene, cam, cfg.replace(**knob),
                          torch.Generator().manual_seed(1))
        if "primary_tile_order" in knob:
            # lanes take other pixels' samples: another frame of the scene
            assert torch.isfinite(img).all() and img.mean() > 1e-2
        else:
            assert_image_parity(img.numpy(), a.numpy())
    with pytest.raises(ValueError):            # no such kernel form
        tint.render(scene, cam, cfg.replace(kernel_form="mt3"),
                    torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="cfg.mesh"):  # no mesh to shard on
        tint.render(scene, cam, cfg.replace(intersector="pallas_sharded"),
                    torch.Generator().manual_seed(1))
    with pytest.raises(ValueError):            # no such intersector
        tint.render(scene, cam, cfg.replace(intersector="octree"),
                    torch.Generator().manual_seed(1))
    with pytest.raises(ValueError):            # no such sort
        tint.render(scene, cam, cfg.replace(sort_mode="radix"),
                    torch.Generator().manual_seed(1))
