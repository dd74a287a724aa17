"""The port's ``intersector="packet"`` query against the JAX package's, on
the CPU (tests/test_packet.py:25-90).

The JAX query culls each 128-ray tile's frustum (the intervals of its
rays' origins and inverse directions, its largest cap) against every block
box (``_interval_overlap``) and loops the Moller-Trumbore of each
overlapping block over the tile; the port computes that table
(``tile_block_overlap``) and runs the overlapping blocks through
``sb_intersect`` in one "single" pass.

* The overlap table equal to JAX's bit for bit (min/max and single
  products only), dead padding lanes of the last tile included.
* Closest hits and occlusion on the cases of tests/test_packet.py:25-50:
  the triangle equal to the brute-force one's (the port's and JAX's) and to
  JAX's "packet" query's, but on lanes counted as ties (the two triangles'
  t equal) or edge lanes (within 1e-5 of an edge in barycentrics: the
  kernel tests on precomputed edges, ``moller_trumbore`` forms them per
  test); t within rtol 1e-5 of brute's, as there.
* The kernel's t of "packet" equal to the "pallas" "single" query's (the
  default cull) at t_cap INF_DIST on every lane (slots only on tie lanes)
  and to "pallas2" "single"'s: the same Moller-Trumbore, on a superset of
  the latter's pairs.
* The frame of tests/test_packet.py:52 against JAX's "packet" frame
  (tests/test_torch_render.py's image criterion) and the port's "bvh"
  frame (that test's own: under 0.5% of pixels off by more than 1e-3).
* The vertex gradient of tests/test_packet.py:75 against JAX's, rtol 1e-4
  (the same ``moller_trumbore`` re-evaluation; FMA contraction on the JAX
  side).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.accel import packet as jpk  # noqa: E402
from prismarine_core_tpu.models import procedural as jproc  # noqa: E402
from prismarine_core_tpu.models.materials import MaterialTable  # noqa: E402
from prismarine_core_tpu.models.scene import Scene as JScene  # noqa: E402
from prismarine_core_tpu.ops.intersect import (  # noqa: E402
    intersect_closest_brute as j_brute)
from prismarine_core_tpu.ops.sampling import make_sample_arrays  # noqa: E402
from prismarine_core_tpu_torch import interop  # noqa: E402
from prismarine_core_tpu_torch.accel import packet as tpk  # noqa: E402
from prismarine_core_tpu_torch.ops import dispatch  # noqa: E402
from prismarine_core_tpu_torch.ops import intersect as tix  # noqa: E402
from prismarine_core_tpu_torch.ops import sb_intersect as si  # noqa: E402
from prismarine_core_tpu_torch.utils.config import INF_DIST  # noqa: E402
from tests.test_bvh import _random_soup  # noqa: E402
from tests.test_packet import _rand_rays  # noqa: E402
from tests.test_torch_query import _hall_rays  # noqa: E402
from tests.test_torch_render import (  # noqa: E402
    HALL, assert_image_parity, render_both)
from tests.test_torch_scene import jax_scene_arrays  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"


def _scenes(js):
    return js, interop.scene_from_numpy(jax_scene_arrays(js), device=CPU)


def _soup(n_tris, capacity, seed):
    """The JAX test's soup as a (JAX, port) scene pair."""
    return _scenes(JScene.assemble(_random_soup(n_tris, capacity=capacity,
                                                seed=seed),
                                   MaterialTable.build([{}])))


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("case", ["hall3000", "soup1000"])
def test_interval_overlap_equals_jax(case):
    if case == "hall3000":
        js, ts = _scenes(jproc.make_hall_scene(target_tris=3000))
        o, d = _hall_rays(2000, seed=23)
    else:
        js, ts = _soup(1000, 1007, 2)
        o, d = _rand_rays(333, seed=1)
    r = o.shape[0]
    rng = np.random.default_rng(3)
    t_cap = jnp.asarray(np.where(rng.random(r) < 0.7, rng.uniform(1, 30, r),
                                 0.0).astype(np.float32))
    lo, hi = js.bvh.lo[0], js.bvh.hi[0]
    # the JAX query's tiles, as _packet_core builds them
    os_, ds, tcs, _, _ = jpk._sort_pad_rays(lo, hi, o, d, t_cap)
    nt = os_.shape[0] // 128
    ot, tct = os_.reshape(nt, 128, 3), tcs.reshape(nt, 128)
    inv = jpk._safe_inv(ds.reshape(nt, 128, 3))
    ref = np.asarray(jpk._interval_overlap(
        ot.min(axis=1)[:, None], ot.max(axis=1)[:, None],
        inv.min(axis=1)[:, None], inv.max(axis=1)[:, None],
        js.packets.block_lo[None], js.packets.block_hi[None],
        tct.max(axis=1)[:, None]))
    rays, _, _ = tpk._sorted_rays_matrix(*(_t(x) for x in (lo, hi, o, d,
                                                           t_cap)))
    ps = ts.packets
    got = tpk.tile_block_overlap(rays, ps.block_lo, ps.block_hi, chunk=3)
    assert got.shape == (nt, ps.n_blocks)
    np.testing.assert_array_equal(got.numpy(), ref)
    print(f"{case}: {int(got.sum())} of {got.numel()} (tile, block) "
          "entries overlap")
    # random rays' tiles span every direction: their frusta take it all
    assert 0 < int(got.sum()) < got.numel() or case == "soup1000"


def _other_lanes_are_ties_or_edges(ts, o, d, tri, tri_ref):
    """Lanes whose triangle differs from the reference's: each a tie (the
    two triangles' t equal) or an edge lane (within 1e-5 of an edge of
    either in barycentrics).  Returns their count."""
    lanes = np.nonzero(tri != tri_ref)[0]
    if lanes.size == 0:
        return 0
    soup = ts.triangles
    oo, dd = _t(o)[lanes], _t(d)[lanes]
    tv, edge = [], []
    for tr in (tri[lanes], tri_ref[lanes]):
        ix = torch.tensor(np.maximum(tr, 0), dtype=torch.long)
        t, u, v, ok = tix.moller_trumbore(oo, dd, soup.v0[ix], soup.v1[ix],
                                          soup.v2[ix])
        tv.append(torch.where(torch.tensor(tr >= 0) & ok, t, INF_DIST))
        edge.append(torch.minimum(torch.minimum(u, v), 1 - u - v).abs()
                    < 1e-5)
    ok = (tv[0] == tv[1]) | edge[0] | edge[1]
    print(f"{lanes.size} lanes on another triangle: t {tv[0].tolist()} vs "
          f"{tv[1].tolist()}")
    assert bool(ok.all())
    return int(lanes.size)


@pytest.mark.parametrize("n_tris,r", [(50, 64), (300, 512), (1000, 333)])
def test_packet_closest_matches_brute_and_jax(n_tris, r):
    js, ts = _soup(n_tris, n_tris + 7, 2)
    o, d = _rand_rays(r, seed=1)
    hj = jpk.intersect_closest_packet(js.bvh, js.packets, js.triangles, o, d)
    hb = j_brute(js.triangles, o, d, block=64)
    ht = tpk.intersect_closest_packet(ts.bvh, ts.packets, ts.triangles,
                                      _t(o), _t(d))
    htb = tix.intersect_closest_brute(ts.triangles, _t(o), _t(d), block=64)
    tri = ht.tri.numpy()
    np.testing.assert_array_equal(np.asarray(hj.tri), np.asarray(hb.tri))
    n = sum(_other_lanes_are_ties_or_edges(ts, np.asarray(o), np.asarray(d),
                                           tri, ref)
            for ref in (htb.tri.numpy(), np.asarray(hj.tri)))
    assert n <= 2 * (r // 1000 + 1)
    m = (tri >= 0) & (tri == htb.tri.numpy())
    print(f"{int(m.sum())} of {r} lanes hit")
    assert m.any() or n_tris < 100
    np.testing.assert_allclose(ht.t.numpy()[m], htb.t.numpy()[m], rtol=1e-5)
    np.testing.assert_allclose(ht.t.numpy()[m], np.asarray(hj.t)[m],
                               rtol=1e-5)


def test_packet_occlusion_matches_brute_and_jax():
    js, ts = _soup(400, 512, 4)
    o, d = _rand_rays(300, seed=5)
    rng = np.random.default_rng(6)
    t_max = rng.uniform(0.5, 20, (300,)).astype(np.float32)
    oj = np.asarray(jpk.occluded_packet(js.bvh, js.packets, js.triangles, o,
                                        d, jnp.asarray(t_max)))
    ot = tpk.occluded_packet(ts.bvh, ts.packets, ts.triangles, _t(o), _t(d),
                             torch.tensor(t_max)).numpy()
    ob = tix.occluded_brute(ts.triangles, _t(o), _t(d), torch.tensor(t_max),
                            block=64).numpy()
    np.testing.assert_array_equal(ot, ob)
    np.testing.assert_array_equal(ot, oj)
    assert 0 < ot.sum() < ot.size


def test_packet_kernel_t_equals_pallas_single():
    """On the hall: the "packet" query's kernel t equals the "pallas"
    "single" query's (the default cull, block masks) bit for bit at t_cap
    INF_DIST (slots only on tie lanes), and "pallas2" "single"'s too, from
    a superset of the latter's pairs (the frustum is conservative)."""
    js, ts = _scenes(jproc.make_hall_scene(target_tris=3000))
    o, d = (_t(x) for x in _hall_rays(2048, seed=23))
    args = tpk._detached(ts.bvh, ts.packets, o, d,
                         torch.full((2048,), INF_DIST))
    pairs = {}
    choose = dispatch.choose

    def recording(x, launch, plain):
        run = choose(x, launch, plain)
        if launch is not si.launch_sb_intersect:
            return run

        def rec(*a):
            pairs.setdefault(name, []).append(
                (int(a[3]), int(si.live_counts(a[2], a[3]).sum())))
            return run(*a)
        return rec
    dispatch.choose = recording
    try:
        name = "packet"
        t_p, s_p = tpk._run_packet(*args)
        name = "pallas single"
        t_s, s_s, _ = tpk._run_packet_pallas(*args, strategy="single",
                                             cull_impl="pallas")
        name = "pallas2 single"
        t_2, _, _ = tpk._run_packet_pallas(*args, strategy="single",
                                           cull_impl="pallas2")
    finally:
        dispatch.choose = choose
    print(f"(pairs, live sub-blocks): {pairs}")
    assert torch.equal(t_p, t_s) and torch.equal(t_p, t_2)
    assert int((s_p != s_s).sum()) <= 3
    (pp, lp), = pairs["packet"]
    (ps_, ls), = pairs["pallas2 single"]
    assert pp >= ps_ and lp >= ls and int((s_p >= 0).sum()) > 1000


def test_packet_render_matches_jax_and_bvh():
    """tests/test_packet.py:52: the hall of 3,000 triangles, 32x24, 2
    bounces, against JAX's "packet" frame and the port's "bvh" frame."""
    js = jproc.make_hall_scene(target_tris=3000)
    _, ts = _scenes(js)
    cfg_kw = dict(width=32, height=24, spp=1, max_bounces=2,
                  intersector="packet")

    def samples(cfg):
        return make_sample_arrays(jax.random.key(0), cfg.n_rays,
                                  cfg.max_bounces)
    (img, st), (ref, rst) = render_both(js, ts, **HALL, cfg_kw=cfg_kw,
                                        samples=samples)
    assert_image_parity(img, ref, st, rst)
    (img_b, _), _ = render_both(js, ts, **HALL, cfg_kw=dict(
        cfg_kw, intersector="bvh"), samples=samples)
    diff = np.abs(img - img_b)
    assert (diff.max(axis=-1) > 1e-3).mean() < 0.005
    assert img.mean() > 1e-2


def test_packet_gradients_match_jax():
    """tests/test_packet.py:75: d/dv0 of the summed hit distances."""
    js, ts = _soup(100, 128, 8)
    o, d = _rand_rays(64, seed=9)

    def f_jax(v0):
        s2 = dataclasses.replace(js.triangles, v0=v0)
        hit = jpk.intersect_closest_packet(js.bvh, js.packets, s2, o, d)
        return jnp.where(hit.tri >= 0, hit.t, 0.0).sum()
    g_j = np.asarray(jax.grad(f_jax)(js.triangles.v0))

    v0 = ts.triangles.v0.clone().requires_grad_(True)
    soup = dataclasses.replace(ts.triangles, v0=v0)
    hit = tpk.intersect_closest_packet(ts.bvh, ts.packets, soup, _t(o), _t(d))
    torch.where(hit.tri >= 0, hit.t, 0.0).sum().backward()
    g_t = v0.grad.numpy()
    assert np.isfinite(g_t).all() and np.abs(g_t).sum() > 0
    np.testing.assert_allclose(g_t, g_j, rtol=1e-4, atol=1e-6)
