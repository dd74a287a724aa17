"""The pair intersector's "mt2" and "mxu" forms against the JAX package.

* ``mxu_planes_from_planes`` and the full 16-column kernel ray matrix
  against JAX's on the same packet set and rays.  Exact except where a
  cross product is involved (the mxu coefficients and the ray matrix's
  c = (o - center) x d columns): XLA on the CPU contracts multiply-adds
  into FMAs where torch rounds each product, so those are held to 1 ulp
  of the products' scale (ROADMAP queue 3).
* "mt2" is "mt" bit for bit (plain versions, and the query).
* The port's "mt2" and "mxu" queries against JAX's
  ``_run_packet_pallas(kernel_form=...)`` (Pallas in interpret mode), for
  "two_round" (K=2, so round 2 runs) and "single", with the bounds of
  tests/test_packet.py:398-411: hit parity > 99.5%, slot parity > 99%
  where both hit, t within rtol 1e-3 / atol 1e-4 for the same winner and
  rtol 1e-2 / atol 1e-3 for different winners (equally near surfaces).
  The determinant form reorders the f32 arithmetic, so hit decisions may
  flip exactly at triangle edges; those lanes are counted and printed.
* Image parity under ``kernel_form="mxu"`` against JAX and against the
  port's "mt" (hall, 2000 triangles, 48x32, 3 bounces, mirroring
  tests/test_packet.py:414-442): >= 98% of pixels isclose(rtol=1e-3,
  atol=1e-3), mean within 0.5%.
* The config accepts the three forms and raises for any other.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.accel import packet as jpk  # noqa: E402
from prismarine_core_tpu.models import procedural as jproc  # noqa: E402
from prismarine_core_tpu.ops import pallas_intersect as jpi  # noqa: E402
from prismarine_core_tpu_torch.accel import packet as tpk  # noqa: E402
from prismarine_core_tpu_torch.models.camera import Camera  # noqa: E402
from prismarine_core_tpu_torch.models import procedural as tproc  # noqa: E402
from prismarine_core_tpu_torch.ops import cull  # noqa: E402
from prismarine_core_tpu_torch.ops import sb_intersect as si  # noqa: E402
from prismarine_core_tpu_torch.render import integrator as tint  # noqa: E402
from prismarine_core_tpu_torch.utils.config import (  # noqa: E402
    KERNEL_FORMS, RenderConfig, check_query_knobs, check_supported)
from tests.test_packet import _rand_rays  # noqa: E402
from tests.test_torch_query import SCENES, _agree  # noqa: E402
from tests.test_torch_render import (  # noqa: E402
    HALL, assert_image_parity, render_both)

torch.set_num_threads(1)
F32_EPS = float(np.finfo(np.float32).eps)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module", params=sorted(SCENES))
def scenes(request):
    from prismarine_core_tpu_torch import interop
    from tests.test_torch_scene import jax_scene_arrays
    make_scene, make_rays = SCENES[request.param]
    js = make_scene()
    ts = interop.scene_from_numpy(jax_scene_arrays(js), device="cpu")
    assert js.packets.n_superblocks > 2
    return js, ts, make_rays()


def test_mxu_planes_match_jax(scenes):
    js, ts, _ = scenes
    center = 0.5 * (js.bvh.lo[0] + js.bvh.hi[0])
    ref = np.asarray(jpi.mxu_planes_from_planes(js.packets.planes, center))
    got = si.mxu_planes_from_planes(ts.packets.planes, _t(center)).numpy()
    assert got.shape == ref.shape == (js.packets.n_superblocks + 1, 16, 4096)
    # invalid slots and the sentinel superblock: all-zero columns
    valid = np.asarray(js.packets.planes)[:, si.TC_VALID] > 0.5
    lanes = np.repeat(valid.reshape(valid.shape[0], 8, 1, 128), 4, axis=2)
    dead = ~lanes.reshape(valid.shape[0], 1, 4096).repeat(16, axis=1)
    assert (got[dead] == 0).all() and (ref[dead] == 0).all()
    assert dead[-1].all() and not dead[0].all()
    # 1 ulp per contractible stage at the coefficients' scale: products of
    # two coordinates (cross products), three of them for -v0.n
    planes = np.asarray(js.packets.planes)
    mag = max(np.abs(planes[:, :9]).max(), 1.0) + np.abs(center).max()
    err = np.abs(got.astype(np.float64) - ref)
    assert err.max() <= 2 * 3 * mag ** 3 * F32_EPS, err.max()
    assert (got == ref).mean() > 0.9


def test_ray_matrix_all_columns_match_jax():
    """All 16 columns of the kernel ray matrix, including the "mxu"
    form's constant and c columns, equal JAX's (c within 1 ulp of
    |o - center| |d|); dead padding rows and the sentinel tile keep the
    constant and c at 0."""
    from tests.test_torch_query import _soup_scene
    js = _soup_scene()
    o, d = _rand_rays(1000, seed=24)             # not a multiple of 128
    rng = np.random.default_rng(7)
    t_cap = np.where(rng.random(1000) < 0.6, 1e4, 0.0).astype(np.float32)
    lo, hi = js.bvh.lo[0], js.bvh.hi[0]
    rj, _, _ = jpk._sorted_rays_matrix(lo, hi, o, d, jnp.asarray(t_cap))
    rt, _, _ = tpk._sorted_rays_matrix(*(_t(x) for x in (lo, hi, o, d)),
                                       torch.tensor(t_cap))
    rj, rt = np.asarray(rj), rt.numpy()
    assert rt.shape == rj.shape == (9 * 128, 16)
    c = slice(si.RC_CX, si.RC_CX + 3)
    exact = [k for k in range(16) if k not in range(si.RC_CX, si.RC_CX + 3)]
    np.testing.assert_array_equal(rt[:, exact], rj[:, exact])
    scale = (np.linalg.norm(rj[:, 0:3] - np.asarray(0.5 * (lo + hi)), axis=1)
             * np.linalg.norm(rj[:, 3:6], axis=1))[:, None]
    assert (np.abs(rt[:, c] - rj[:, c]) <= scale * F32_EPS).all()
    assert (rt[:1000, si.RC_ONE] == 1.0).all()
    assert (rt[1000:, si.RC_ONE] == 0.0).all() and (rt[1000:, c] == 0).all()


def _query_inputs(js, ts, o, d, seed=5):
    rng = np.random.default_rng(seed)
    t_cap = np.where(rng.random(o.shape[0]) < 0.8, 1e4, 0.0).astype(
        np.float32)
    lo, hi = js.bvh.lo[0], js.bvh.hi[0]
    jargs = (lo, hi, js.packets, o, d, jnp.asarray(t_cap))
    targs = (_t(lo), _t(hi), ts.packets, _t(o), _t(d), torch.tensor(t_cap))
    return jargs, targs, t_cap


def test_mt2_plain_equals_mt_plain(scenes):
    """"mt2" computes the "mt" function: the wrappers on CPU tensors (the
    plain version) and the whole query agree bit for bit."""
    js, ts, (o, d) = scenes
    _, targs, _ = _query_inputs(js, ts, o, d)
    lo, hi, ps, to, td, tc = targs
    rays, _, _ = tpk._sorted_rays_matrix(lo, hi, to, td, tc)
    nt = rays.shape[0] // 128 - 1
    n_live = tpk._live_tile_bound(rays[:nt * 128, si.RC_TCAP].reshape(nt,
                                                                     128))
    tn = cull.block_cull(rays, cull.box_rows_from_blocks(ps.sb_lo, ps.sb_hi),
                         n_live)[:, :ps.n_superblocks]
    pt, psb, n_real = tpk.compact_pairs(tn < 1e4)
    pm = cull.pair_cull(pt, psb, n_real, rays,
                        cull.sb_box_table(ps.block_lo, ps.block_hi))
    a = si.sb_intersect(pt, psb, pm, n_real, rays, ps.planes)
    b = si.sb_intersect_mt2(pt, psb, pm, n_real, rays, ps.planes)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert bool((a[1] >= 0).any())
    for strategy in ("two_round", "single"):
        tm, sm, _ = tpk._run_packet_pallas(*targs, kernel_form="mt",
                                           strategy=strategy, k_round=2)
        t2, s2, _ = tpk._run_packet_pallas(*targs, kernel_form="mt2",
                                           strategy=strategy, k_round=2)
        assert torch.equal(sm, s2) and torch.equal(tm, t2)


def _hit_t(js, slot, o, d):
    """t of each lane's slot by the JAX package's brute Moller-Trumbore
    (INF where no slot)."""
    from prismarine_core_tpu.ops.intersect import moller_trumbore
    tri = np.asarray(js.bvh.orig)[np.maximum(slot, 0)]
    v = [np.asarray(x)[tri] for x in (js.triangles.v0, js.triangles.v1,
                                      js.triangles.v2)]
    t = np.asarray(moller_trumbore(o, d, *(jnp.asarray(x) for x in v))[0])
    return np.where(slot >= 0, t, np.inf)


def _form_bounds(s_ref, t_ref, s_got, t_got, name):
    """tests/test_packet.py:398-411."""
    agree_hit = (s_ref >= 0) == (s_got >= 0)
    both = (s_ref >= 0) & (s_got >= 0)
    same = s_ref[both] == s_got[both]
    print(f"{name}: hit parity {agree_hit.mean():.5f} "
          f"({int((~agree_hit).sum())} lanes), slot parity "
          f"{same.mean():.5f} ({int((~same).sum())} lanes)")
    assert agree_hit.mean() > 0.995, agree_hit.mean()
    assert same.mean() > 0.99, same.mean()
    np.testing.assert_allclose(t_got[both][same], t_ref[both][same],
                               rtol=1e-3, atol=1e-4)
    if (~same).any():
        np.testing.assert_allclose(t_got[both][~same], t_ref[both][~same],
                                   rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("strategy", ["two_round", "single"])
@pytest.mark.parametrize("form", ["mt2", "mxu"])
def test_query_form_matches_jax(scenes, form, strategy):
    js, ts, (o, d) = scenes
    jargs, targs, t_cap = _query_inputs(js, ts, o, d)
    kw = dict(strategy=strategy, k_round=2)
    tj, sj, _ = jpk._run_packet_pallas(*jargs, kernel_form=form,
                                       cull_impl="pallas2", **kw)
    kw["cull_impl"] = "pallas2"
    _, st, _ = tpk._run_packet_pallas(*targs, kernel_form=form, **kw)
    _, sm, _ = tpk._run_packet_pallas(*targs, kernel_form="mt", **kw)
    sj, st, sm = np.asarray(sj), st.numpy(), sm.numpy()
    assert (st[t_cap == 0] == -1).all()
    assert (sj >= 0).sum() > o.shape[0] // 10
    t_got = _hit_t(js, st, o, d)
    _form_bounds(sj, np.asarray(tj), st, t_got, f"{form} vs JAX")
    _form_bounds(sm, _hit_t(js, sm, o, d), st, t_got, f"{form} vs port mt")
    if form == "mt2":
        _agree("mt2 vs JAX slot", st, sj)
        np.testing.assert_array_equal(st, sm)


def test_mxu_image_parity():
    """The integrator under ``kernel_form="mxu"``: against JAX's "mxu"
    frame and against the port's "mt" frame."""
    jscene = jproc.make_hall_scene(target_tris=2000)
    tscene = tproc.make_hall_scene(target_tris=2000, device="cpu")
    kw = dict(width=48, height=32, spp=1, max_bounces=3,
              intersector="pallas", cull_impl="pallas2", pairs_per_step=4,
              anyhit_strategy="single")

    def samples(cfg):
        return (jnp.full((cfg.n_rays, 4), 0.5),
                jnp.full((cfg.max_bounces, cfg.n_rays, 11), 0.37))

    (img, st), (ref, rst) = render_both(
        jscene, tscene, **HALL, cfg_kw=dict(kw, kernel_form="mxu"),
        samples=samples)
    assert img.mean() > 1e-2
    assert_image_parity(img, ref, st, rst)
    cfg = RenderConfig(**kw)
    img_mt = tint.render_with_samples(
        tscene, Camera.look_at(HALL["eye"], HALL["target"],
                               fov_y_deg=HALL["fov"], device="cpu"),
        cfg, *(_t(x) for x in samples(cfg))).numpy()
    assert_image_parity(img, img_mt)


def test_config_kernel_forms():
    assert KERNEL_FORMS == ("mt", "mt2", "mxu")
    for form in KERNEL_FORMS:
        check_query_knobs(kernel_form=form)
        check_supported(RenderConfig(intersector="pallas", cull_impl="pallas2",
                                     anyhit_strategy="single",
                                     kernel_form=form))
    for bad in ("mt3", "MXU", ""):
        with pytest.raises(ValueError):
            check_query_knobs(kernel_form=bad)
