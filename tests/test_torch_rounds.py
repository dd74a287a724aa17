"""The packet query's "rounds" strategy (the any-hit default) against the
JAX query on an identical scene, BVH and packet set.

The hall of 27,748 triangles has 32 superblocks, so with K = 8 a query
runs up to four rounds.  Against the JAX "rounds" query (its Pallas
kernels in interpret mode): hit triangle ids and occlusion flags agree on
>= 99.9% of lanes (the differing lanes counted and printed: ties between
bit-equal t, or 1-ulp edge decisions, since XLA on the CPU contracts
multiply-adds into FMAs where torch does not), and t within rtol 1e-3
where both hit (the bound of tests/test_torch_query.py).  Within the port
the strategies compute one function: "rounds" gives bit-identical t to
"two_round" (other triangles only on equal-t lanes, counted) and the
same occlusion as "single", and ``stale_round_masks`` changes nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.accel import packet as jpk  # noqa: E402
from prismarine_core_tpu.models import procedural as jproc  # noqa: E402
from prismarine_core_tpu_torch import interop  # noqa: E402
from prismarine_core_tpu_torch.accel import packet as tpk  # noqa: E402
from prismarine_core_tpu_torch.models.scene import (  # noqa: E402
    make_cornell_scene)
from prismarine_core_tpu_torch.utils.profiling import counts  # noqa: E402
from tests.test_torch_query import _agree, _hall_rays  # noqa: E402
from tests.test_torch_scene import jax_scene_arrays  # noqa: E402

torch.set_num_threads(1)
K = 8
R = 1024


@pytest.fixture(scope="module")
def hall():
    js = jproc.make_hall_scene(target_tris=20000)
    ts = interop.scene_from_numpy(jax_scene_arrays(js), device="cpu")
    assert ts.packets.n_superblocks > 3 * K          # four rounds
    o, d = _hall_rays(R, seed=31)
    rng = np.random.default_rng(8)
    t_cap = np.where(rng.random(R) < 0.8, 1e4, 0.0).astype(np.float32)
    t_max = np.where(rng.random(R) < 0.8, rng.uniform(0.5, 20, R),
                     0.0).astype(np.float32)
    return js, ts, o, d, t_cap, t_max


def _port_query(hall, any_hit, **kw):
    """The port's query on the hall's rays: (Hit or occlusion flags, the
    pair compactions it ran)."""
    _, ts, o, d, t_cap, t_max = hall
    args = (ts.bvh, ts.packets, ts.triangles, torch.tensor(np.asarray(o)),
            torch.tensor(np.asarray(d)))
    before = counts["pc.sync.compact"]
    if any_hit:
        out = tpk.occluded_pallas(*args, torch.tensor(t_max), k_round=K,
                                  cull_impl="pallas2", **kw)
    else:
        out = tpk.intersect_closest_pallas(*args, t_cap=torch.tensor(t_cap),
                                           k_round=K, cull_impl="pallas2",
                                           **kw)
    return out, counts["pc.sync.compact"] - before


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
def test_rounds_closest_matches_jax(hall, stale):
    js, _, o, d, t_cap, _ = hall
    hj = jpk.intersect_closest_pallas(
        js.bvh, js.packets, js.triangles, o, d, t_cap=jnp.asarray(t_cap),
        cull_impl="pallas2", strategy="rounds", k_round=K,
        stale_round_masks=stale)
    ht, rounds = _port_query(hall, False, strategy="rounds",
                             stale_round_masks=stale)
    print(f"closest: {rounds} rounds")
    assert rounds >= 3                 # later rounds really run
    tri_j, tri_t = np.asarray(hj.tri), ht.tri.numpy()
    assert (tri_t[t_cap == 0] == -1).all()
    assert (tri_j >= 0).sum() > R // 10
    _agree("rounds closest tri", tri_t, tri_j)
    both = (tri_j >= 0) & (tri_t >= 0)
    np.testing.assert_allclose(ht.t.numpy()[both], np.asarray(hj.t)[both],
                               rtol=1e-3)


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
def test_rounds_anyhit_matches_jax(hall, stale):
    js, _, o, d, _, t_max = hall
    occ_j = np.asarray(jpk.occluded_pallas(
        js.bvh, js.packets, js.triangles, o, d, jnp.asarray(t_max),
        cull_impl="pallas2", strategy="rounds", k_round=K,
        stale_round_masks=stale))
    # "rounds" is the any-hit default of both packages
    occ_t, rounds = _port_query(hall, True, stale_round_masks=stale)
    print(f"any-hit: {rounds} rounds")
    occ_t = occ_t.numpy()
    assert not occ_t[t_max == 0].any()
    assert occ_j.sum() > R // 10
    _agree("rounds occluded", occ_t, occ_j)


def test_rounds_equals_two_round_and_single(hall):
    """One function under every strategy: closest t bit-identical to
    "two_round" (a differing triangle only on an equal-t lane, counted),
    occlusion identical to "single", and stale masks change nothing."""
    fresh, _ = _port_query(hall, False, strategy="rounds")
    stale, _ = _port_query(hall, False, strategy="rounds",
                           stale_round_masks=True)
    two, _ = _port_query(hall, False, strategy="two_round")
    assert torch.equal(fresh.t, two.t)
    ties = int((fresh.tri != two.tri).sum())
    print(f"rounds vs two_round: {ties} tie lanes of {R}")
    assert ties <= R // 100
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(fresh, f), getattr(stale, f))

    occ, _ = _port_query(hall, True, strategy="rounds")
    occ_stale, _ = _port_query(hall, True, stale_round_masks=True)
    single, _ = _port_query(hall, True, strategy="single")
    assert torch.equal(occ, single) and torch.equal(occ, occ_stale)


def test_rounds_stop_and_small_scenes(hall):
    """A query whose lanes are all dead runs round 0 and stops at the
    first empty round; a scene of at most K superblocks runs "single";
    an unknown strategy raises."""
    _, ts, o, d, _, _ = hall
    to, td = torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d))
    before = counts["pc.sync.compact"]
    occ = tpk.occluded_pallas(ts.bvh, ts.packets, ts.triangles, to, td,
                              torch.zeros(R), k_round=K)
    assert not occ.any()
    assert counts["pc.sync.compact"] - before == 2

    cb = make_cornell_scene(device="cpu")
    assert cb.packets.n_superblocks <= K
    o2 = torch.zeros((64, 3))
    d2 = torch.nn.functional.normalize(torch.randn(
        (64, 3), generator=torch.Generator().manual_seed(0)), dim=-1)
    t_max = torch.full((64,), 5.0)
    a = tpk.occluded_pallas(cb.bvh, cb.packets, cb.triangles, o2, d2, t_max)
    b = tpk.occluded_pallas(cb.bvh, cb.packets, cb.triangles, o2, d2, t_max,
                            strategy="single")
    assert torch.equal(a, b) and a.any()
    with pytest.raises(ValueError):
        tpk.occluded_pallas(cb.bvh, cb.packets, cb.triangles, o2, d2, t_max,
                            strategy="three_round")
