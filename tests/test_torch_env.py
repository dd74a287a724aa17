"""The port's environment importance sampling and env NEE against the JAX
package's, on the CPU.

- ``_env_texel_probs``: equal to JAX's at rtol 1e-5 (the bench sky and a
  small sun sky).
- ``sample_env_direction`` and ``env_pdf`` on 65,536 seeded lanes of the
  bench sky (128 x 256 texels).  The CDF is a float32 sum of 32,768
  probabilities that XLA and torch round differently (by an ulp), so a
  u1 within an ulp of a CDF step picks the neighbouring texel: counted,
  not excluded.  Texels agree on >= 99% of lanes (one ulp of float32 at
  each of 32,768 steps moves ~0.3% of uniform u1 across a step), and
  every lane where they differ has u1 within 2 ulps of a CDF step;
  directions agree to 1e-3 (a quarter of a texel's 2 pi / 256) on
  >= 99.9% of lanes (a step inside a row moves the direction little);
  pdfs agree to rtol 1e-4 on every lane whose texel agrees; ``env_pdf``
  agrees to rtol 1e-4 on every lane of one set of directions.
- Mirrors of tests/test_env_sampling.py in the port: pdf self-consistency
  (> 97% of lanes within 1e-3), importance-sampled integration against
  texel quadrature (within 5%, 200,000 samples), and env NEE on the ground
  quad under the sun sky: unbiased against ``env_nee=False`` over 10
  ``torch.Generator`` seeds (means within max(5 sem, 5%)) and its
  variance below a third.
- The bench slice (tests/test_torch_slice.py's 27,748-triangle hall with
  the sky, 64x48, 4 bounces, coherent samples) with ``env_nee=True``, port
  against JAX: tests/test_torch_render.py's image criterion (>= 98% of
  pixels ``isclose(rtol=1e-3, atol=1e-3)``, mean within 0.5%), the lane
  counters (NEE-shadow column included) within 0.5%, and four pair
  compactions per bounce (closest rounds 1 and 2, sun and env shadow).
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
from prismarine_core_tpu.ops.sampling import (  # noqa: E402
    make_coherent_sample_arrays)
from prismarine_core_tpu_torch.models import procedural as tproc  # noqa: E402
from prismarine_core_tpu_torch.models import textures as ttex  # noqa: E402
from prismarine_core_tpu_torch.models.camera import Camera  # noqa: E402
from prismarine_core_tpu_torch.models.geometry import (  # noqa: E402
    TriangleSoup, make_quad)
from prismarine_core_tpu_torch.models.lights import SphereLights  # noqa: E402
from prismarine_core_tpu_torch.models.materials import MaterialTable  # noqa: E402
from prismarine_core_tpu_torch.models.scene import Scene  # noqa: E402
from prismarine_core_tpu_torch.ops import sampling as smp  # noqa: E402
from prismarine_core_tpu_torch.render import integrator as tint  # noqa: E402
from prismarine_core_tpu_torch.utils.config import RenderConfig  # noqa: E402
from prismarine_core_tpu_torch.utils.profiling import counts  # noqa: E402
from tests.test_torch_render import (  # noqa: E402
    BENCH_KNOBS, CPU, HALL, assert_image_parity, render_both)

torch.set_num_threads(1)

SUN = dict(resolution=32, sun_dir=(0.3, 0.8, 0.2))
LUM = np.asarray([0.2126, 0.7152, 0.0722], np.float32)


@pytest.fixture(scope="module")
def skies():
    return (jproc.make_sky_environment(resolution=128),
            tproc.make_sky_environment(resolution=128, device=CPU))


def test_env_texel_probs_match_jax(skies):
    """The tent-filtered luminance x sin(theta) distribution: rtol 1e-5
    on every texel, for the bench sky and a small sun sky."""
    for je, te in (skies, (jproc.make_sky_environment(**SUN),
                           tproc.make_sky_environment(**SUN, device=CPU))):
        ref = np.asarray(jtex._env_texel_probs(je))
        got = ttex._env_texel_probs(te).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
        assert abs(float(got.sum(dtype=np.float64)) - 1.0) < 1e-5


def test_sample_env_direction_matches_jax(skies):
    """65,536 seeded lanes: texels agree on >= 99% (the rest are u1
    within 2 ulps of a CDF step, counted), directions within 1e-3 on
    >= 99.9%, pdfs at rtol 1e-4 wherever the texel agrees; ``env_pdf``
    at rtol 1e-4 on every lane."""
    je, te = skies
    u = np.random.default_rng(0).random((65536, 2), dtype=np.float32)
    dj, pj = jtex.sample_env_direction(je, jnp.asarray(u[:, 0]),
                                       jnp.asarray(u[:, 1]))
    dt, pt = ttex.sample_env_direction(te, torch.tensor(u[:, 0]),
                                       torch.tensor(u[:, 1]))
    dj, pj, dt, pt = map(np.asarray, (dj, pj, dt.numpy(), pt.numpy()))

    def texel(probs, cumsum):
        return np.searchsorted(cumsum(probs.reshape(-1)), u[:, 0],
                               side="left")
    idx_j = texel(np.asarray(jtex._env_texel_probs(je)),
                  lambda p: np.asarray(jnp.cumsum(jnp.asarray(p))))
    idx_t = texel(ttex._env_texel_probs(te).numpy(),
                  lambda p: np.cumsum(p, dtype=np.float64).astype(
                      np.float32))
    same = idx_j == idx_t
    close = np.abs(dt - dj).max(-1) <= 1e-3
    # a lane whose texel differs has u1 within 2 ulps of a CDF step
    cdf_j = np.asarray(jnp.cumsum(jnp.asarray(
        jtex._env_texel_probs(je).reshape(-1))))
    hi = cdf_j[np.minimum(idx_j, len(cdf_j) - 1)]
    lo = cdf_j[np.maximum(idx_j - 1, 0)]
    gap = np.minimum(np.abs(u[:, 0] - hi), np.abs(u[:, 0] - lo))
    print(f"texels differ on {(~same).sum()} of {len(same)} lanes "
          f"(largest gap to a CDF step {gap[~same].max(initial=0):.3g}); "
          f"directions off 1e-3 on {(~close).sum()}")
    assert same.mean() >= 0.99
    assert (gap[~same] <= 2.4e-7).all()
    assert close.mean() >= 0.999
    np.testing.assert_allclose(np.linalg.norm(dt, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(pt[same], pj[same], rtol=1e-4)
    np.testing.assert_allclose(
        ttex.env_pdf(te, torch.tensor(dj)).numpy(),
        np.asarray(jtex.env_pdf(je, jnp.asarray(dj))), rtol=1e-4)


def _sun_env():
    return tproc.make_sky_environment(**SUN, device=CPU)


def test_env_sample_pdf_consistency():
    """Directions are unit (atol 1e-5) and env_pdf maps > 97% of 4,096
    samples back to their own pdf within 1e-3 (in-texel jitter lands a
    few one texel over)."""
    env = _sun_env()
    g = torch.Generator().manual_seed(3)
    u = torch.rand((4096, 2), generator=g)
    d, pdf = ttex.sample_env_direction(env, u[:, 0], u[:, 1])
    np.testing.assert_allclose(d.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    ratio = (ttex.env_pdf(env, d) / pdf).numpy()
    assert np.mean(np.abs(ratio - 1.0) < 1e-3) > 0.97


def test_env_importance_integration_matches_quadrature():
    """E[lum(d) / pdf(d)] over 200,000 samples equals the map's luminance
    integrated over the sphere by texel quadrature, within 5%."""
    env = _sun_env()
    h, w, _ = env.image.shape
    lum_img = (env.image * env.scale).numpy() @ LUM
    theta = (np.arange(h) + 0.5) / h * np.pi
    d_omega = (2.0 * np.pi / w) * (np.pi / h) * np.sin(theta)[:, None]
    quadrature = float((lum_img * d_omega).sum())
    g = torch.Generator().manual_seed(11)
    u = torch.rand((200_000, 2), generator=g)
    d, pdf = ttex.sample_env_direction(env, u[:, 0], u[:, 1])
    est = float(((env.sample(d).numpy() @ LUM) / pdf.numpy()).mean())
    assert abs(est - quadrature) / quadrature < 0.05, (est, quadrature)


def _ground_scene():
    """A diffuse ground quad lit only by the sun sky (the light is
    black): the worst case for cosine sampling alone."""
    q = make_quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8), mat_id=0)
    tris = TriangleSoup.from_arrays(q[0], q[1], mat_ids=q[2], device=CPU)
    mats = MaterialTable.build([{"diffuse": (0.8, 0.7, 0.6)}], device=CPU)
    lights = SphereLights.single(center=(0, 60.0, 0), radius=0.1,
                                 color=(0.0, 0.0, 0.0), device=CPU)
    return Scene.assemble(tris, mats, lights, _sun_env(), build_bvh=False)


def test_env_nee_variance_drop_and_unbiasedness():
    """Over 10 seeds at 24x24 and 2 bounces on "brute": the env-NEE mean
    equals the cosine-only mean within max(5 sem, 5%), and its variance
    over the ground pixels is below a third of cosine-only's."""
    scene = _ground_scene()
    cam = Camera.look_at(eye=(0.0, 3.0, 6.0), target=(0.0, 0.0, 0.0),
                         fov_y_deg=45.0, device=CPU)
    base = RenderConfig(width=24, height=24, spp=1, max_bounces=2,
                        intersector="brute", direct_light=False)

    def run(cfg):
        imgs = []
        for s in range(10):
            g = torch.Generator().manual_seed(s)
            cam_s, bounce_s = smp.make_sample_arrays(g, cfg.n_rays,
                                                     cfg.max_bounces,
                                                     device=CPU)
            imgs.append(tint.render_with_samples(scene, cam, cfg, cam_s,
                                                 bounce_s).numpy())
        return np.stack(imgs)

    off = run(base)
    on = run(base.replace(env_nee=True))
    ground = off.mean(axis=(0, 3)) > 0.0
    ground &= on.var(axis=0).mean(-1) + off.var(axis=0).mean(-1) > 0
    v_off = float(off.var(axis=0).mean(-1)[ground].mean())
    v_on = float(on.var(axis=0).mean(-1)[ground].mean())
    assert v_on < v_off / 3.0, (v_on, v_off)
    m_off, m_on = float(off.mean()), float(on.mean())
    sem = (off.mean(axis=(1, 2, 3)).std() / np.sqrt(len(off))
           + on.mean(axis=(1, 2, 3)).std() / np.sqrt(len(on)))
    assert abs(m_on - m_off) < max(5 * sem, 0.05 * m_off), (m_on, m_off)


def test_env_nee_bench_slice_matches_jax():
    jscene = jproc.make_hall_scene(target_tris=20000)
    jscene = dataclasses.replace(
        jscene, environment=jproc.make_sky_environment(resolution=128))
    tscene = tproc.make_hall_scene(target_tris=20000, device=CPU)
    tscene = dataclasses.replace(
        tscene, environment=tproc.make_sky_environment(resolution=128,
                                                       device=CPU))
    assert int(tscene.triangles.num_valid()) == 27748
    cfg_kw = dict(width=64, height=48, spp=1, max_bounces=4, env_nee=True,
                  coherent_bounce_sampling=True, **BENCH_KNOBS)
    syncs0 = counts["pc.sync.compact"]
    (img, st), (ref, rst) = render_both(
        jscene, tscene, **HALL, cfg_kw=cfg_kw,
        samples=lambda cfg: make_coherent_sample_arrays(
            jax.random.key(0), cfg, block=(8, 16)))
    assert counts["pc.sync.compact"] - syncs0 == 4 * 4
    assert img.mean() > 1e-2
    assert_image_parity(img, ref, st, rst)
