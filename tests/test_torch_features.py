"""The port's remaining integrator and camera features against the JAX
package: Russian roulette, interlacing, depth of field, the 360 camera and
``trace_radiance`` (mirrors tests/test_features.py:20-102 and
tests/test_transport.py:139-200).

Frames: the 16x16 cornell box on the same (JAX-made) sample arrays, on
"bvh" (each feature alone) and on "pallas" (JAX in interpret mode; two
frames that combine the features, to keep the interpret-mode compiles
few).  Image criterion as tests/test_torch_render.py: >= 98% of pixels
``isclose(rtol=1e-3, atol=1e-3)`` and the mean within 0.5%.  The
per-bounce lane counters must be equal, except where Russian roulette's
coin lies within 4 ulps of its survival probability q (q is a product of
floats that XLA and torch round apart by an ulp): such lanes are counted
and may move the counters of their bounce and the later ones by one each.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.models.camera import Camera as JCamera  # noqa: E402
from prismarine_core_tpu.models.camera import (  # noqa: E402
    generate_rays as j_generate_rays)
from prismarine_core_tpu.models.scene import (  # noqa: E402
    make_cornell_scene as j_cornell)
from prismarine_core_tpu.ops.sampling import make_sample_arrays  # noqa: E402
from prismarine_core_tpu.render import integrator as jint  # noqa: E402
from prismarine_core_tpu.utils.config import RenderConfig as JConfig  # noqa: E402
from prismarine_core_tpu_torch.models.camera import (  # noqa: E402
    Camera, generate_rays)
from prismarine_core_tpu_torch.models.scene import (  # noqa: E402
    make_cornell_scene)
from prismarine_core_tpu_torch.ops import sampling as ts  # noqa: E402
from prismarine_core_tpu_torch.render import integrator as tint  # noqa: E402
from prismarine_core_tpu_torch.utils.config import RenderConfig  # noqa: E402
from tests.test_torch_render import BENCH_KNOBS  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"
EYE, TARGET, FOV = (0.0, 0.0, 3.4), (0.0, 0.0, 0.0), 50.0


def _cams():
    return (JCamera.look_at(eye=EYE, target=TARGET, fov_y_deg=FOV),
            Camera.look_at(eye=EYE, target=TARGET, fov_y_deg=FOV,
                           device=CPU))


@pytest.fixture(scope="module")
def cornells():
    return j_cornell(), make_cornell_scene(device=CPU)


@pytest.mark.parametrize("w,h", [(4, 4), (16, 9), (7, 5)])
def test_interlace_mask_matches_jax(w, h):
    cfg = RenderConfig(width=w, height=h)
    m = [tint.interlace_mask(cfg, s).numpy() for s in range(3)]
    for s in range(3):
        np.testing.assert_array_equal(
            m[s], np.asarray(jint.interlace_mask(JConfig(width=w, height=h),
                                                 s)))
    assert (m[0] ^ m[1]).all() and np.array_equal(m[0], m[2])


def test_dof_and_360_rays_match_jax():
    """Thin-lens and equirect camera rays on the same samples: within
    2e-6 of JAX's (origins and unit directions of scale ~1-4; XLA's and
    torch's sqrt, sin and cos and XLA's contracted multiply-adds round
    apart by an ulp or two a stage), with the lens offsets varying and
    the panorama covering both hemispheres (tests/test_features.py)."""
    cam_s = np.random.default_rng(0).random((64, 4)).astype(np.float32)
    jcam, tcam = _cams()
    for kw in (dict(dof=True), dict(dof=True, dof_focus_radius=3.4,
                                    dof_focal_radius=0.2),
               dict(camera_360=True)):
        oj, dj = j_generate_rays(jcam, JConfig(width=8, height=8, **kw),
                                 jnp.asarray(cam_s))
        ot, dt = generate_rays(tcam, RenderConfig(width=8, height=8, **kw),
                               torch.tensor(cam_s))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                                   atol=2e-6)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                                   atol=2e-6)
        if kw.get("dof"):
            assert ot.numpy().std(axis=0).max() > 0
        else:
            assert dt[:, 2].min() < -0.5 and dt[:, 2].max() > 0.5


def _rr_near(scene, cfg, o, d, bounce_s, active):
    """Lanes whose RR coin lies within 4 ulps of q, per bounce: the step
    without RR gives each lane's pre-roulette throughput and liveness,
    then the step with RR advances the carry."""
    step = tint.make_bounce_step(scene, cfg)
    step_norr = tint.make_bounce_step(scene, cfg.replace(rr_start_bounce=0))
    carry = tint.initial_carry(o, d, active)
    near = []
    for b in range(bounce_s.shape[0]):
        nxt, _ = step_norr(carry, bounce_s[b])
        q = torch.clamp(nxt[2].amax(dim=-1), cfg.rr_min_q, 1.0)
        u = bounce_s[b][:, ts.S_RR]
        close = (u - q).abs() <= 4 * torch.tensor(np.spacing(q.numpy()))
        on = nxt[4] & (b >= cfg.rr_start_bounce > 0)
        near.append(int((close & on).sum()))
        carry, _ = step(carry, bounce_s[b])
    return np.array(near)


def _render_pair(cornells, cfg_kw, stage=0, key=3):
    """The frame of ``cfg_kw`` in both packages on one JAX-made sample
    set; returns port (img, stats), JAX (img, stats) and the RR near-coin
    lanes per bounce."""
    (js, tsc), (jcam, tcam) = cornells, _cams()
    jcfg, tcfg = JConfig(**cfg_kw), RenderConfig(**cfg_kw)
    cam_s, bounce_s = make_sample_arrays(jax.random.key(key), jcfg.n_rays,
                                         jcfg.max_bounces)
    jimg, jst = jint.render_with_samples(js, jcam, jcfg, cam_s, bounce_s,
                                         stage, with_stats=True)
    tc, tb = torch.tensor(np.asarray(cam_s)), torch.tensor(
        np.asarray(bounce_s))
    timg, tst = tint.render_with_samples(tsc, tcam, tcfg, tc, tb, stage,
                                         with_stats=True)
    near = np.zeros(jcfg.max_bounces, int)
    if tcfg.rr_start_bounce > 0:
        o, d = generate_rays(tcam, tcfg, tc)
        active = (tint.interlace_mask(tcfg, stage).reshape(-1)
                  .repeat(tcfg.spp) if tcfg.interlace else None)
        near = _rr_near(tsc, tcfg, o, d, tb, active)
    return ((timg.numpy(), tst.numpy()), (np.asarray(jimg), np.asarray(jst)),
            near)


def _assert_frame_parity(port, ref, near):
    (img, st), (rimg, rst) = port, ref
    close = np.isclose(img, rimg, rtol=1e-3, atol=1e-3).all(axis=-1)
    print(f"pixel parity {close.mean():.4f}, mean {img.mean():.6f} vs "
          f"{rimg.mean():.6f}; stats {st.tolist()} vs {rst.tolist()}; "
          f"RR near-coin lanes per bounce {near.tolist()}")
    assert np.isfinite(img).all()
    assert close.mean() >= 0.98, f"pixel parity {close.mean()}"
    assert abs(img.mean() - rimg.mean()) <= 5e-3 * abs(rimg.mean())
    allowed = np.cumsum(near)[:, None]
    assert (np.abs(st.astype(np.int64) - rst) <= allowed).all()


BASE = dict(width=16, height=16, spp=1, max_bounces=4)
FEATURES = {"default": (dict(), 0),
            "rr": (dict(rr_start_bounce=2), 0),
            "interlace0": (dict(interlace=True), 0),
            "interlace1": (dict(interlace=True), 1),
            "dof": (dict(dof=True, dof_focus_radius=3.4,
                         dof_focal_radius=0.1), 0),
            "360": (dict(camera_360=True), 0)}


@pytest.mark.parametrize("feature", list(FEATURES))
def test_bvh_frames_match_jax(cornells, feature):
    kw, stage = FEATURES[feature]
    port, ref, near = _render_pair(cornells, dict(BASE, intersector="bvh",
                                                  **kw), stage)
    assert port[0].mean() > (1e-3 if feature == "360" else 1e-2)
    _assert_frame_parity(port, ref, near)
    if feature.startswith("interlace"):
        m = tint.interlace_mask(RenderConfig(**BASE), stage).numpy()
        assert (port[0][~m] == 0).all() and (port[0][m] != 0).any()


#: the "pallas" frames, each combining features (2 bounces, RR on the
#: second; one frame on the lens, one on the panorama)
PALLAS = {"rr-interlace0-dof": (dict(rr_start_bounce=1, interlace=True,
                                     dof=True, dof_focus_radius=3.4,
                                     dof_focal_radius=0.1), 0),
          "rr-interlace1-360": (dict(rr_start_bounce=1, interlace=True,
                                     camera_360=True), 1)}


@pytest.mark.parametrize("combo", list(PALLAS))
def test_pallas_frames_match_jax(cornells, combo):
    kw, stage = PALLAS[combo]
    port, ref, near = _render_pair(
        cornells, dict(BASE, max_bounces=2, **BENCH_KNOBS, **kw), stage)
    assert port[0].max() > 0
    _assert_frame_parity(port, ref, near)
    m = tint.interlace_mask(RenderConfig(**BASE), stage).numpy()
    assert (port[0][~m] == 0).all()


@pytest.mark.parametrize("intersector", ["bvh", "brute"])
def test_interlace_stages_sum_to_full_frame(cornells, intersector):
    """Each lane is traced alone, so stage 0 plus stage 1 is the full
    frame bit for bit, and each stage's other parity is exactly 0."""
    _, tsc = cornells
    _, tcam = _cams()
    cfg = RenderConfig(**BASE, intersector=intersector)
    cam_s, bounce_s = ts.make_sample_arrays(torch.Generator().manual_seed(5),
                                            cfg.n_rays, cfg.max_bounces)
    full = tint.render_with_samples(tsc, tcam, cfg, cam_s, bounce_s)
    icfg = cfg.replace(interlace=True)
    parts = [tint.render_with_samples(tsc, tcam, icfg, cam_s, bounce_s, s)
             for s in (0, 1)]
    for s, part in enumerate(parts):
        m = tint.interlace_mask(cfg, s)
        assert bool((part[~m] == 0).all())
    assert torch.equal(parts[0] + parts[1], full)


def _avg(scene, cam, cfg, maker, n=24):
    acc, st_acc = 0.0, 0
    for s in range(n):
        cam_s, bounce_s = maker(torch.Generator().manual_seed(s))
        img, st = tint.render_with_samples(scene, cam, cfg, cam_s, bounce_s,
                                           with_stats=True)
        acc, st_acc = acc + img, st_acc + st.numpy()
    return (acc / n).numpy(), st_acc / n


def test_russian_roulette_unbiased(cornells):
    """RR from bounce 2 on "bvh" with the port's generator: the 24-frame
    mean within 5% + 0.01 of the frames without RR, and the last bounce
    enters with under 0.9 of the lanes (tests/test_transport.py)."""
    _, tsc = cornells
    _, tcam = _cams()
    cfg = RenderConfig(**BASE, intersector="bvh")
    rr = cfg.replace(rr_start_bounce=2)

    def maker(c):
        return lambda g: ts.make_sample_arrays(g, c.n_rays, c.max_bounces)
    ref, ref_st = _avg(tsc, tcam, cfg, maker(cfg))
    img, rr_st = _avg(tsc, tcam, rr, maker(rr))
    assert np.isfinite(img).all()
    print(f"means {ref.mean():.4f} vs RR {img.mean():.4f}; lanes entering "
          f"the last bounce {ref_st[-1, 0]} vs {rr_st[-1, 0]}")
    assert abs(ref.mean() - img.mean()) < 0.05 * ref.mean() + 0.01
    assert rr_st[-1, 0] < 0.9 * ref_st[-1, 0]
    assert (rr_st[:2] == ref_st[:2]).all()   # no roulette before bounce 2


def test_coherent_sampling_unbiased(cornells):
    """Coherent (4x4-block) bounce samples on "bvh" with the port's
    generator leave the frame mean unbiased (tests/test_transport.py).
    A 16x16 frame holds only 16 such blocks, so one frame's mean varies
    by ~0.065: the means of 64 frames of each kind must agree within 4
    standard errors of their difference, from the frames' own spread."""
    _, tsc = cornells
    _, tcam = _cams()
    cfg = RenderConfig(**dict(BASE, max_bounces=3), intersector="bvh")

    def means(maker, n=64):
        return np.array([float(tint.render_with_samples(
            tsc, tcam, cfg, *maker(torch.Generator().manual_seed(s))).mean())
            for s in range(n)])
    ind = means(lambda g: ts.make_sample_arrays(g, cfg.n_rays,
                                                cfg.max_bounces))
    coh = means(lambda g: ts.make_coherent_sample_arrays(g, cfg,
                                                         block=(4, 4)))
    se = np.sqrt(ind.var(ddof=1) / ind.size + coh.var(ddof=1) / coh.size)
    print(f"means {ind.mean():.4f} vs coherent {coh.mean():.4f}, standard "
          f"error of the difference {se:.4f}")
    assert abs(ind.mean() - coh.mean()) < 4 * se


def test_trace_radiance_is_trace(cornells):
    _, tsc = cornells
    _, tcam = _cams()
    cfg = RenderConfig(**BASE, rr_start_bounce=1)
    cam_s, bounce_s = ts.make_sample_arrays(torch.Generator().manual_seed(2),
                                            cfg.n_rays, cfg.max_bounces)
    o, d = generate_rays(tcam, cfg, cam_s)
    active = torch.rand(cfg.n_rays, generator=torch.Generator()
                        .manual_seed(3)) < 0.7
    for act in (None, active):
        rad, _ = tint.trace(tsc, cfg, o, d, bounce_s, act)
        assert torch.equal(tint.trace_radiance(tsc, cfg, o, d, bounce_s, act),
                           rad)
    assert bool((rad[~active] == 0).all())


def test_default_config_renders_on_the_cpu():
    """``RenderConfig()``'s intersector is "bvh", and the port renders it
    on the CPU when the caller asks for the CPU."""
    assert RenderConfig().intersector == "bvh"
    scene = make_cornell_scene(device=CPU)
    _, cam = _cams()
    img = tint.render(scene, cam, RenderConfig(width=16, height=16),
                      torch.Generator().manual_seed(0))
    assert img.shape == (16, 16, 3)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 1e-2
    with pytest.raises(ValueError):          # no BVH built
        tint.render(scene.__class__(**{**scene.__dict__, "bvh": None}), cam,
                    RenderConfig(width=16, height=16),
                    torch.Generator().manual_seed(0))
