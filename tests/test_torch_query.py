"""The port's packet query (``cull_impl="pallas2"``) against the JAX
query on an identical scene, BVH and packet set (crossed over with
``interop.scene_from_numpy``).

"two_round" is forced with ``k_round=2`` on scenes with more than two
superblocks (so round 2 really runs), and "single" runs too.  Hit
triangle ids and occlusion flags must agree on >= 99.9% of lanes (the
differing lanes are counted and printed: ties between bit-equal t, or
1-ulp edge decisions, since XLA on the CPU contracts multiply-adds into
FMAs where torch does not); where both hit, t within rtol 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.accel import packet as jpk  # noqa: E402
from prismarine_core_tpu.models import procedural as jproc  # noqa: E402
from prismarine_core_tpu.models.materials import MaterialTable  # noqa: E402
from prismarine_core_tpu.models.scene import Scene as JScene  # noqa: E402
from prismarine_core_tpu_torch import interop  # noqa: E402
from prismarine_core_tpu_torch.accel import packet as tpk  # noqa: E402
from tests.test_bvh import _random_soup  # noqa: E402
from tests.test_packet import _rand_rays  # noqa: E402
from tests.test_torch_scene import jax_scene_arrays  # noqa: E402

torch.set_num_threads(1)


def _soup_scene():
    soup = _random_soup(3000, capacity=3005, seed=21)
    return JScene.assemble(soup, MaterialTable.build([{}]))


def _hall_rays(r, seed):
    """Rays from inside the hall toward random points on its surfaces."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-10, 10, r), rng.uniform(0.3, 5.0, r),
                  rng.uniform(-4, 4, r)], -1).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


SCENES = {
    "soup": (_soup_scene, lambda: _rand_rays(2048, seed=22)),
    "hall": (lambda: jproc.make_hall_scene(target_tris=3000),
             lambda: _hall_rays(2048, seed=23)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scenes(request):
    make_scene, make_rays = SCENES[request.param]
    js = make_scene()
    ts = interop.scene_from_numpy(jax_scene_arrays(js), device="cpu")
    assert js.packets.n_superblocks > 2
    return js, ts, make_rays()


def _agree(name, a, b):
    n_diff = int((a != b).sum())
    print(f"{name}: {n_diff} of {a.size} lanes differ")
    assert n_diff <= a.size // 1000


KNOBS = [dict(strategy="two_round", k_round=2), dict(strategy="single"),
         dict(closest_k_default=True)]


@pytest.mark.parametrize("kw", KNOBS, ids=["two_round-k2", "single",
                                           "default"])
def test_closest_query_matches_jax(scenes, kw):
    js, ts, (o, d) = scenes
    kw = {} if kw.get("closest_k_default") else kw
    r = o.shape[0]
    rng = np.random.default_rng(5)
    alive = rng.random(r) < 0.8
    t_cap = np.where(alive, 1e4, 0.0).astype(np.float32)
    hj = jpk.intersect_closest_pallas(
        js.bvh, js.packets, js.triangles, o, d, t_cap=jnp.asarray(t_cap),
        cull_impl="pallas2", **kw)
    ht = tpk.intersect_closest_pallas(
        ts.bvh, ts.packets, ts.triangles, torch.tensor(np.asarray(o)),
        torch.tensor(np.asarray(d)), t_cap=torch.tensor(t_cap),
        cull_impl="pallas2", **kw)
    tri_j, tri_t = np.asarray(hj.tri), ht.tri.numpy()
    assert (tri_t[~alive] == -1).all()
    assert (tri_j >= 0).sum() > r // 10
    _agree("closest tri", tri_t, tri_j)
    both = (tri_j >= 0) & (tri_t >= 0)
    np.testing.assert_allclose(ht.t.numpy()[both], np.asarray(hj.t)[both],
                               rtol=1e-3)


@pytest.mark.parametrize("kw", KNOBS[:2], ids=["two_round-k2", "single"])
def test_occluded_query_matches_jax(scenes, kw):
    js, ts, (o, d) = scenes
    r = o.shape[0]
    rng = np.random.default_rng(6)
    t_max = np.where(rng.random(r) < 0.8, rng.uniform(0.5, 20, r),
                     0.0).astype(np.float32)
    occ_j = np.asarray(jpk.occluded_pallas(
        js.bvh, js.packets, js.triangles, o, d, jnp.asarray(t_max),
        cull_impl="pallas2", **kw))
    occ_t = tpk.occluded_pallas(
        ts.bvh, ts.packets, ts.triangles, torch.tensor(np.asarray(o)),
        torch.tensor(np.asarray(d)), torch.tensor(t_max), cull_impl="pallas2",
        **kw).numpy()
    assert not occ_t[t_max == 0].any()
    assert occ_j.sum() > r // 10
    _agree("occluded", occ_t, occ_j)


def test_order_reuse_and_unported_knobs(scenes):
    """A shadow query may reuse the closest query's sort; the knobs the
    port once refused ("xla", "packed", near_frac) run and give the
    default query's t bit for bit (slots on tie lanes), and a value no
    package defines raises ValueError."""
    _, ts, (o, d) = scenes
    o, d = torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d))
    hit, order = tpk.intersect_closest_pallas(
        ts.bvh, ts.packets, ts.triangles, o, d, return_order=True)
    t_max = torch.full((o.shape[0],), 20.0)
    a = tpk.occluded_pallas(ts.bvh, ts.packets, ts.triangles, o, d, t_max,
                            order=order, strategy="single")
    b = tpk.occluded_pallas(ts.bvh, ts.packets, ts.triangles, o, d, t_max,
                            strategy="single")
    assert torch.equal(a, b)
    for knob in (dict(near_frac=0.5), dict(cull_impl="xla"),
                 dict(sort_mode="packed")):
        h = tpk.intersect_closest_pallas(ts.bvh, ts.packets, ts.triangles,
                                         o, d, **knob)
        assert torch.equal(h.t, hit.t)
        _agree(f"{knob} tri", h.tri.numpy(), hit.tri.numpy())
    for bad in (dict(kernel_form="mt3"), dict(sort_mode="bitonic"),
                dict(cull_impl="cuda")):
        with pytest.raises(ValueError):        # no package has them
            tpk.intersect_closest_pallas(ts.bvh, ts.packets, ts.triangles, o,
                                         d, **bad)
    # the any-hit default, "rounds" (tests/test_torch_rounds.py), gives
    # the "single" occlusion
    assert torch.equal(tpk.occluded_pallas(ts.bvh, ts.packets,
                                           ts.triangles, o, d, t_max), b)


def test_sorted_ray_matrix_matches_jax():
    """Coherence sort (int64 keys, dead lanes last), the kernel ray matrix
    and its dead-ray / sentinel padding equal the JAX package's in every
    column the kernels read."""
    js = _soup_scene()
    o, d = _rand_rays(1000, seed=24)             # not a multiple of 128
    rng = np.random.default_rng(7)
    t_cap = np.where(rng.random(1000) < 0.6, 1e4, 0.0).astype(np.float32)
    lo, hi = js.bvh.lo[0], js.bvh.hi[0]
    rj, (pj, ij), _ = jpk._sorted_rays_matrix(lo, hi, o, d,
                                             jnp.asarray(t_cap))
    rt, (pt, it), n = tpk._sorted_rays_matrix(
        *(torch.tensor(np.asarray(x)) for x in (lo, hi, o, d)),
        torch.tensor(t_cap))
    assert n == 1000
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    cols = [0, 1, 2, 3, 4, 5, 6, 8, 9, 10]
    np.testing.assert_array_equal(rt.numpy()[:, cols], np.asarray(rj)[:, cols])
    keys_j = np.asarray(jpk._ray_sort_keys(lo, hi, o, d, jnp.asarray(t_cap)))
    keys_t = tpk._ray_sort_keys(
        *(torch.tensor(np.asarray(x)) for x in (lo, hi, o, d)),
        torch.tensor(t_cap)).numpy()
    np.testing.assert_array_equal(keys_t, keys_j.astype(np.int64))
    assert (keys_t[t_cap == 0] >= 1 << 31).all()
