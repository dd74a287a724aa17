"""The packet query's remaining knobs in the port against the JAX package,
on the CPU: ``cull_impl="xla"`` (with "rounds"), ``sort_mode`` "packed"
and "group", ``near_frac`` under "pallas" and "pallas2", and
``order="identity"`` (the variants of tests/test_packet.py:144-160 and
:272), and the coherence sort's permutations.

* Queries, on the 3,000-triangle random soup (3 superblocks) and the
  3,000-triangle hall (4 superblocks) with 2,048 rays and ``k_round=2``,
  so that "two_round"'s round 2 and the later rounds of "rounds" run (the
  JAX test's 700-triangle soup is one superblock, where every strategy
  runs "single"; its "rounds" k 4 would run "single" here too): the
  triangle equal to JAX's on all but 0.1% of lanes (counted: ties, or
  1-ulp edge decisions, since XLA on the CPU contracts multiply-adds into
  FMAs where torch does not), t within 2 ulps of the first-order scale of
  one rounding in t's numerator and in det, over |det|
  (tests/test_torch_parallel.py's bound), occlusion on all but 0.1%; and
  each variant's t bit for bit equal to the port's own "pallas2" query on
  every lane (the variants re-schedule the same tests), its occlusion
  identical.  ``near_frac`` only selects round 1 of a closest query, so
  its variants run the closest query alone.
* Permutations: "packed" and "full" equal to JAX's bit for bit; "group"
  counted by the groups whose rank differs (at most 1e-3 of them: a 16-lane
  centroid may round differently in another summation order), and its
  fallback to "full" below 2,048 rays or off a multiple of 16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.accel import packet as jpk  # noqa: E402
from prismarine_core_tpu.models import procedural as jproc  # noqa: E402
from prismarine_core_tpu.models.camera import Camera as JCamera  # noqa: E402
from prismarine_core_tpu.models.camera import generate_rays  # noqa: E402
from prismarine_core_tpu.utils.config import RenderConfig as JConfig  # noqa: E402
from prismarine_core_tpu_torch import interop  # noqa: E402
from prismarine_core_tpu_torch.accel import packet as tpk  # noqa: E402
from prismarine_core_tpu_torch.ops import dispatch  # noqa: E402
from prismarine_core_tpu_torch.ops import sb_intersect as si  # noqa: E402
from prismarine_core_tpu_torch.utils.config import INF_DIST  # noqa: E402
from tests.test_packet import _rand_rays  # noqa: E402
from tests.test_torch_parallel import _t_scale  # noqa: E402
from tests.test_torch_query import _hall_rays, _soup_scene  # noqa: E402
from tests.test_torch_scene import jax_scene_arrays  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"
R = 2048
#: lanes that may differ from JAX's (ties and 1-ulp edge decisions)
LANES = R // 1000 + 1

SCENES = {
    "soup3000": (_soup_scene, lambda: _rand_rays(R, seed=22)),
    "hall3000": (lambda: jproc.make_hall_scene(target_tris=3000),
                 lambda: _hall_rays(R, seed=23)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    """(JAX scene, the port's crossed-over scene, o, d, t_cap, t_max (numpy),
    the port's "pallas2" closest hit and occlusion at k_round 2)."""
    make_scene, make_rays = SCENES[request.param]
    js = make_scene()
    ts = interop.scene_from_numpy(jax_scene_arrays(js), device=CPU)
    assert js.packets.n_superblocks > 2
    o, d = (np.asarray(x) for x in make_rays())
    rng = np.random.default_rng(5)
    t_cap = np.where(rng.random(R) < 0.8, 1e4, 0.0).astype(np.float32)
    t_max = np.where(rng.random(R) < 0.8, rng.uniform(0.5, 20, R),
                     0.0).astype(np.float32)
    targs = (ts.bvh, ts.packets, ts.triangles, torch.tensor(o),
             torch.tensor(d))
    kw = dict(cull_impl="pallas2", k_round=2)
    ref = tpk.intersect_closest_pallas(*targs, t_cap=torch.tensor(t_cap),
                                       **kw)
    occ = tpk.occluded_pallas(*targs, torch.tensor(t_max), **kw)
    return js, ts, o, d, t_cap, t_max, ref, occ


#: the variants of tests/test_packet.py:144-160 and :272 the port lacked
VARIANTS = {
    "xla": dict(cull_impl="xla"),
    "xla-rounds": dict(cull_impl="xla", strategy="rounds"),
    "packed": dict(cull_impl="pallas", sort_mode="packed"),
    "group": dict(cull_impl="pallas", sort_mode="group"),
    **{f"near{nf}-{impl}": dict(cull_impl=impl, near_frac=nf)
       for impl in ("pallas", "pallas2") for nf in (0.25, 0.4, 0.5)},
    "identity": dict(cull_impl="pallas2", order="identity"),
}


def _t_ulps(js, tri, o, d, t_j, t_t):
    """Largest |t_t - t_j| in ulps of the t scale of the lanes' triangles."""
    scale = np.maximum(np.abs(t_j), _t_scale(js, tri, o, d, t_j))
    return float((np.abs(t_t.astype(np.float64) - t_j)
                  / np.spacing(scale.astype(np.float32))).max())


@pytest.mark.parametrize("name", list(VARIANTS))
def test_query_variant_matches_jax(scene, name):
    js, ts, o, d, t_cap, t_max, ref, occ_ref = scene
    kw = dict(VARIANTS[name], k_round=2)
    jargs = (js.bvh, js.packets, js.triangles, jnp.asarray(o), jnp.asarray(d))
    targs = (ts.bvh, ts.packets, ts.triangles, torch.tensor(o),
             torch.tensor(d))
    alive = t_cap > 0

    hj = jpk.intersect_closest_pallas(*jargs, t_cap=jnp.asarray(t_cap), **kw)
    ht = tpk.intersect_closest_pallas(*targs, t_cap=torch.tensor(t_cap), **kw)
    tri_j, tri_t = np.asarray(hj.tri), ht.tri.numpy()
    assert (tri_t[~alive] == -1).all()
    assert (tri_j >= 0).sum() > R // 20
    n_other = int((tri_j != tri_t).sum())
    print(f"{name}: {n_other} of {R} lanes on another triangle than JAX's")
    assert n_other <= LANES
    both = (tri_j >= 0) & (tri_t >= 0)
    ulps = _t_ulps(js, tri_j[both], o[both], d[both], np.asarray(hj.t)[both],
                   ht.t.numpy()[both])
    print(f"{name}: t max error {ulps:.3f} ulp of the scale")
    assert ulps <= 2.0

    # the port's own "pallas2" query: the same tests, re-scheduled
    assert torch.equal(ht.t, ref.t)
    ties = int((ht.tri != ref.tri).sum())
    print(f"{name}: {ties} tie lanes against the port's pallas2")
    assert ties <= LANES
    if "near_frac" in kw:
        return

    occ_j = np.asarray(jpk.occluded_pallas(*jargs, jnp.asarray(t_max), **kw))
    occ_t = tpk.occluded_pallas(*targs, torch.tensor(t_max), **kw)
    assert not occ_t.numpy()[t_max == 0].any()
    assert int((occ_j != occ_t.numpy()).sum()) <= LANES
    assert torch.equal(occ_t, occ_ref)


def test_near_frac_changes_round_one(scene):
    """``near_frac`` really selects round 1 by distance: its round-1 pair
    list differs from the K nearest ones, a larger fraction runs no fewer
    pairs in round 1, and a fraction of 1 runs every candidate in round 1
    and leaves round 2 empty (the counts of the recorded sb_intersect
    calls)."""
    _, ts, o, d, t_cap, *_ = scene
    targs = (ts.bvh, ts.packets, ts.triangles, torch.tensor(o),
             torch.tensor(d))
    calls = []
    choose = dispatch.choose

    def recording(x, launch, plain):
        run = choose(x, launch, plain)
        if launch is not si.launch_sb_intersect:
            return run

        def rec(*args):
            calls.append(int(args[3]))
            return run(*args)
        return rec
    dispatch.choose = recording
    try:
        round1 = {}
        for nf in (0.0, 0.25, 0.5, 1.0):
            calls.clear()
            tpk.intersect_closest_pallas(*targs, t_cap=torch.tensor(t_cap),
                                         cull_impl="pallas2", k_round=2,
                                         near_frac=nf)
            assert len(calls) == 2
            round1[nf] = tuple(calls)
    finally:
        dispatch.choose = choose
    print("(round-1, round-2) pairs by near_frac", round1)
    assert round1[0.25][0] <= round1[0.5][0] <= round1[1.0][0]
    assert round1[1.0][1] == 0
    assert round1[0.25][0] != round1[0.0][0]


def _perm_inputs(r, rays):
    """Root box of the soup, r rays ("random", "hall", or the 64x64 camera
    rays of the hall: many equal keys) and caps with 40% of lanes dead."""
    js = _soup_scene()
    if rays == "camera":
        hall = jproc.make_hall_scene(target_tris=3000)
        cfg = JConfig(width=64, height=r // 64)
        o, d = generate_rays(
            JCamera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                            fov_y_deg=60.0), cfg, jnp.full((r, 4), 0.5))
        lo, hi = hall.bvh.lo[0], hall.bvh.hi[0]
    else:
        o, d = (_rand_rays if rays == "random" else _hall_rays)(r, seed=24)
        lo, hi = js.bvh.lo[0], js.bvh.hi[0]
    rng = np.random.default_rng(7)
    t_cap = np.where(rng.random(r) < 0.6, 1e4, 0.0).astype(np.float32)
    jin = (lo, hi, o, d, jnp.asarray(t_cap))
    tin = tuple(torch.tensor(np.asarray(x)) for x in jin)
    return jin, tin


@pytest.mark.parametrize("r,rays", [(1000, "random"), (2048, "hall"),
                                    (4096, "camera")])
@pytest.mark.parametrize("mode", ["full", "packed"])
def test_sort_perm_equals_jax(r, rays, mode):
    """"full" and "packed" (one sort of the key's top bits over the ray
    index) give the JAX permutation and its inverse bit for bit."""
    jin, tin = _perm_inputs(r, rays)
    pj, ij = jpk._coherence_perm(*jin, mode)
    pt, it = tpk._coherence_perm(*tin, mode)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert torch.equal(pt[it], torch.arange(r))
    if mode == "packed":
        # within a bin of the key's top bits, rays keep their order
        keys = tpk._ray_sort_keys(*tin)
        bits = (r - 1).bit_length()
        assert torch.all((keys[pt] >> bits).diff() >= 0)


@pytest.mark.parametrize("r,rays", [(2048, "hall"), (8192, "random"),
                                    (4096, "camera")])
def test_group_perm_matches_jax(r, rays):
    """"group" sorts 16-ray groups by their live centroid's key: the groups
    stay whole, and the group order equals JAX's but on at most 1e-3 of
    the groups (counted)."""
    jin, tin = _perm_inputs(r, rays)
    pj, ij = jpk._coherence_perm(*jin, "group")
    pt, it = tpk._coherence_perm(*tin, "group")
    pt, pj = pt.numpy(), np.asarray(pj)
    groups = pt.reshape(-1, 16)
    np.testing.assert_array_equal(groups - groups[:, :1], np.arange(16)[None]
                                  .repeat(groups.shape[0], 0))
    assert (groups[:, 0] % 16 == 0).all()
    n_diff = int((pt[::16] != pj[::16]).sum())
    print(f"group: {n_diff} of {r // 16} groups ranked differently")
    assert n_diff <= max(1, r // 16 // 1000)
    np.testing.assert_array_equal(pt[it.numpy()], np.arange(r))


@pytest.mark.parametrize("r", [1000, 2040])
def test_group_falls_back_to_full(r):
    """Below 2,048 rays, or off a multiple of 16, "group" is "full"."""
    jin, tin = _perm_inputs(r, "random")
    full = tpk._coherence_perm(*tin, "full")
    group = tpk._coherence_perm(*tin, "group")
    assert all(map(torch.equal, full, group))
    np.testing.assert_array_equal(
        group[0].numpy(), np.asarray(jpk._coherence_perm(*jin, "group")[0]))


def test_identity_order_skips_the_sort():
    """``order="identity"``: the ray matrix holds the rays in the caller's
    order (the sorted matrix's rows, unpermuted), the string comes back
    for the shadow query, and the query's t equals the sorted query's."""
    js = _soup_scene()
    ts = interop.scene_from_numpy(jax_scene_arrays(js), device=CPU)
    o, d = (torch.tensor(np.asarray(x)) for x in _rand_rays(1000, seed=24))
    t_cap = torch.full((1000,), INF_DIST)
    lo, hi = ts.bvh.lo[0], ts.bvh.hi[0]
    rays_s, (perm, inv), _ = tpk._sorted_rays_matrix(lo, hi, o, d, t_cap)
    rays_i, order, n = tpk._sorted_rays_matrix(lo, hi, o, d, t_cap,
                                               "identity")
    assert order == "identity" and n == 1000
    assert torch.equal(rays_i[:1000], rays_s[:1000][inv])
    assert torch.equal(rays_i[1000:], rays_s[1000:])
    rj, _, _ = jpk._sorted_rays_matrix(*(jnp.asarray(x.numpy()) for x in
                                         (lo, hi, o, d, t_cap)),
                                       order="identity")
    cols = [0, 1, 2, 3, 4, 5, 6, 8, 9, 10]
    np.testing.assert_array_equal(rays_i.numpy()[:, cols],
                                  np.asarray(rj)[:, cols])
    args = (ts.bvh, ts.packets, ts.triangles, o, d)
    hit, order = tpk.intersect_closest_pallas(*args, return_order=True,
                                              order="identity")
    assert order == "identity"
    assert torch.equal(hit.t, tpk.intersect_closest_pallas(*args).t)
    with pytest.raises(ValueError):
        tpk.intersect_closest_pallas(*args, order="scanline")
