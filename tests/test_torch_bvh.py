"""The port's BVH build, refit and walk against the JAX package
(mirrors tests/test_bvh.py).

Arrays are built in the same float operations from the same numpy soups,
so ``build_bvh`` (both topologies) and ``refit_bvh`` must give JAX's
arrays bit for bit, and ``traversal_stats`` its integers.  Queries: the
walk's float t differs from JAX's by the FMA contraction of XLA on the CPU
(tests/test_torch_primitives.py: 1 ulp a contractible stage at the
numerator's scale over |det|, two stages), and a lane may then take the
other of two triangles whose t lie within that bound: such lanes are
ties, counted and held to the bound.  Against the port's own brute
intersector (the same torch formula, bit for bit) a different triangle
is allowed only at a bit-equal t.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.accel import lbvh as jlbvh  # noqa: E402
from prismarine_core_tpu.accel import traverse as jtr  # noqa: E402
from prismarine_core_tpu.models import procedural as jproc  # noqa: E402
from prismarine_core_tpu_torch.accel import traverse as ttr  # noqa: E402
from prismarine_core_tpu_torch.accel.lbvh import (  # noqa: E402
    build_bvh, refit_bvh)
from prismarine_core_tpu_torch.models import procedural as tproc  # noqa: E402
from prismarine_core_tpu_torch.ops.intersect import (  # noqa: E402
    intersect_closest_brute, moller_trumbore, occluded_brute)
from tests.test_bvh import _random_soup  # noqa: E402
from tests.test_torch_primitives import assert_ulp  # noqa: E402
from tests.test_torch_scene import (  # noqa: E402
    assert_dataclass_equal, port_soup)

torch.set_num_threads(1)
CPU = "cpu"
TOPOLOGIES = ("karras", "median")


@functools.lru_cache(maxsize=None)
def _hall_soup():
    return jproc.make_hall_scene(target_tris=4000, build_bvh=False).triangles


def _soup(case):
    if case == "hall":
        return _hall_soup()
    n, cap, seed = case
    return _random_soup(n, capacity=cap, seed=seed)


#: one capacity for the random soups, so JAX compiles each build once
SOUPS = [(300, 384, 3), (100, 384, 0), "hall"]
SOUP_IDS = ["300", "100-padded", "hall"]


def _rays(r, seed, lo=-8.0, hi=8.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _aimed_rays(jsoup, r, seed):
    """Rays from the box [-8, 8]^3 toward random triangles' centroids
    (plus noise), so most of them hit."""
    rng = np.random.default_rng(seed)
    valid = np.flatnonzero(np.asarray(jsoup.valid))
    c = (np.asarray(jsoup.v0) + np.asarray(jsoup.v1)
         + np.asarray(jsoup.v2))[rng.choice(valid, r)] / 3.0
    o = rng.uniform(-8, 8, (r, 3)).astype(np.float32)
    aim = c + rng.normal(0, 0.2, (r, 3))
    d = (aim - o) / np.linalg.norm(aim - o, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _hall_rays(r, seed):
    """Rays inside the small hall (as tests/test_bvh.py aims them)."""
    o, d = _rays(r, seed, -10.0, 10.0)
    o = (o * np.float32([1.0, 0.25, 0.4]) + np.float32([0.0, 2.0, 0.0]))
    return o.astype(np.float32), d


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("case", SOUPS, ids=SOUP_IDS)
def test_build_bvh_matches_jax(case, topology):
    jsoup = _soup(case)
    jb = jlbvh.build_bvh(jsoup, leaf_size=4, topology=topology)
    tb = build_bvh(port_soup(jsoup), leaf_size=4, topology=topology)
    assert_dataclass_equal(tb, jb, "bvh")
    assert (tb.n_leaves, tb.leaf_size, tb.first_leaf) == (
        jb.n_leaves, jb.leaf_size, jb.first_leaf)


def test_unknown_topology_raises():
    with pytest.raises(ValueError):
        build_bvh(port_soup(_soup((100, 384, 0))), topology="sah")


def _perturbed(jsoup, seed=8, scale=0.15):
    rng = np.random.default_rng(seed)
    jit = jnp.asarray(rng.normal(0, scale, np.asarray(jsoup.v0).shape)
                      .astype(np.float32))
    return dataclasses.replace(jsoup, v0=jsoup.v0 + jit, v1=jsoup.v1 + jit,
                               v2=jsoup.v2 + jit)


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("case", [(200, 384, 7), "hall"],
                         ids=["200", "hall"])
def test_refit_matches_jax(case, topology):
    """Refit after a vertex perturbation: JAX's arrays bit for bit, the
    topology untouched, and the refit walk equal to the brute query on
    the moved soup (ties at bit-equal t only)."""
    jsoup = _soup(case)
    jb = jlbvh.build_bvh(jsoup, leaf_size=4, topology=topology)
    tb = build_bvh(port_soup(jsoup), leaf_size=4, topology=topology)
    jsoup2 = _perturbed(jsoup)
    jr = jlbvh.refit_bvh(jb, jsoup2)
    tsoup2 = port_soup(jsoup2)
    tr = refit_bvh(tb, tsoup2)
    assert_dataclass_equal(tr, jr, "refit")
    for f in ("left", "skip", "orig"):
        assert torch.equal(getattr(tr, f), getattr(tb, f))
    o, d = (torch.tensor(x) for x in _rays(256, 9))
    _assert_brute_equal(ttr.intersect_closest_bvh(tr, tsoup2, o, d),
                        intersect_closest_brute(tsoup2, o, d, block=64))


def test_scene_with_refit_matches_jax():
    """``Scene.with_refit`` after the small hall's vertices moved: the BVH
    and the packet view rebuilt from it equal JAX's bit for bit; and
    ``Scene.with_bvh`` takes the topology."""
    js = jproc.make_hall_scene(target_tris=4000)
    ts = tproc.make_hall_scene(target_tris=4000, device=CPU)
    js = dataclasses.replace(js, triangles=_perturbed(js.triangles, 3,
                                                      0.02))
    ts = dataclasses.replace(ts, triangles=port_soup(js.triangles))
    jr, tr = js.with_refit(), ts.with_refit()
    assert_dataclass_equal(tr.bvh, jr.bvh, "bvh")
    assert_dataclass_equal(tr.packets, jr.packets, "packets")
    with pytest.raises(ValueError):
        dataclasses.replace(ts, bvh=None).with_refit()
    tm = ts.with_bvh(4, topology="median")
    assert_dataclass_equal(tm.bvh, jlbvh.build_bvh(js.triangles, 4,
                                                   topology="median"),
                           "median bvh")


def _assert_brute_equal(hv, hb):
    """Port walk against port brute: the same triangle, or a bit-equal t
    (a tie, counted); t equal bit for bit."""
    diff = hv.tri != hb.tri
    print(f"walk vs brute: {int(diff.sum())} tie lanes of {diff.numel()}")
    assert torch.equal(hv.t, hb.t)
    assert int(diff.sum()) <= max(1, diff.numel() // 100)


def _tri_t(soup_np, tri, o, d):
    """The port's Moller-Trumbore t of triangle ``tri`` per lane."""
    v = [torch.tensor(x[np.maximum(tri, 0)]) for x in soup_np]
    t, _, _, _ = moller_trumbore(torch.tensor(o), torch.tensor(d), *v)
    return t.numpy()


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("case", [(300, 384, 3), "hall"],
                         ids=["300", "hall"])
def test_queries_match_jax_and_brute(case, topology):
    jsoup = _soup(case)
    tsoup = port_soup(jsoup)
    jb = jlbvh.build_bvh(jsoup, leaf_size=4, topology=topology)
    tb = build_bvh(tsoup, leaf_size=4, topology=topology)
    o, d = _hall_rays(512, 2) if case == "hall" else _aimed_rays(jsoup,
                                                                 512, 2)
    to, td = torch.tensor(o), torch.tensor(d)

    hv = ttr.intersect_closest_bvh(tb, tsoup, to, td)
    _assert_brute_equal(hv, intersect_closest_brute(tsoup, to, td, block=64))
    hj = jtr.intersect_closest_bvh(jb, jsoup, jnp.asarray(o), jnp.asarray(d))
    tri_t, tri_j = hv.tri.numpy(), np.asarray(hj.tri)
    assert int((tri_t >= 0).sum()) > 50
    np.testing.assert_array_equal(tri_t >= 0, tri_j >= 0)
    # the bound: 2 ulps at the numerator's scale over |det| (coordinates
    # of magnitude <= 16 here: products <= 256)
    soup_np = [np.asarray(x) for x in (jsoup.v0, jsoup.v1, jsoup.v2)]
    v0, v1, v2 = (x[np.maximum(tri_t, 0)] for x in soup_np)
    det = np.abs(np.einsum("ij,ij->i", v1 - v0, np.cross(d, v2 - v0)))
    scale = 256.0 / np.maximum(det, 1e-6)
    hit = tri_t >= 0
    assert_ulp(hv.t.numpy()[hit], np.asarray(hj.t)[hit], scale[hit],
               n_ulp=2.0)
    ties = tri_t != tri_j
    print(f"port vs JAX: {int(ties.sum())} tie lanes of {hit.sum()} hits")
    assert int(ties.sum()) <= max(1, hit.sum() // 100)
    if ties.any():          # the other triangle's t is within the bound
        assert_ulp(_tri_t(soup_np, tri_j[ties], o[ties], d[ties]),
                   hv.t.numpy()[ties], scale[ties], n_ulp=2.0)

    rng = np.random.default_rng(4)
    t_max = rng.uniform(0.5, 20.0, 512).astype(np.float32)
    ov = ttr.occluded_bvh(tb, tsoup, to, td, torch.tensor(t_max))
    ob = occluded_brute(tsoup, to, td, torch.tensor(t_max), block=64)
    oj = np.asarray(jtr.occluded_bvh(jb, jsoup, jnp.asarray(o),
                                     jnp.asarray(d), jnp.asarray(t_max)))
    assert torch.equal(ov, ob)
    assert int((ov.numpy() != oj).sum()) <= 1


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_walk_forms_equal(topology, any_hit):
    """``_traverse`` (single-phase) == ``_traverse2`` (the kernel's plain
    version) == the sorted and the chunked runs, on (t, slot) exactly,
    with caps below, at and beyond the hits."""
    jsoup = _soup("hall")
    tb = build_bvh(port_soup(jsoup), leaf_size=4, topology=topology)
    o, d = (torch.tensor(x) for x in _hall_rays(384, 5))
    rng = np.random.default_rng(6)
    t_cap = torch.tensor(np.where(rng.random(384) < 0.2, 0.0,
                                  rng.uniform(0.5, 30.0, 384))
                         .astype(np.float32))
    ref = ttr._traverse2(tb, o, d, t_cap, any_hit)
    one = ttr._traverse(tb, o, d, t_cap, any_hit)
    assert int((ref[1] >= 0).sum()) > 30
    for got in (one[:2], ttr._run_traversal(tb, o, d, t_cap, any_hit),
                ttr._run_traversal(tb, o, d, t_cap, any_hit, sort=True),
                ttr._run_traversal(tb, o, d, t_cap, any_hit, chunk=128),
                ttr._run_traversal(tb, o, d, t_cap, any_hit, chunk=128,
                                   sort=True)):
        assert torch.equal(got[0], ref[0])
        assert torch.equal(got[1].long(), ref[1])
    if not any_hit:
        assert torch.equal(one[2], ref[2]) and torch.equal(one[3], ref[3])


def test_sort_keys_match_jax():
    jsoup = _soup("hall")
    jb = jlbvh.build_bvh(jsoup, leaf_size=4)
    tb = build_bvh(port_soup(jsoup), leaf_size=4)
    o, d = _hall_rays(1000, 7)
    kj = np.asarray(jax.jit(jtr._ray_sort_keys)(jb, jnp.asarray(o),
                                                jnp.asarray(d)))
    kt = ttr._ray_sort_keys(tb, torch.tensor(o), torch.tensor(d)).numpy()
    np.testing.assert_array_equal(kt, kj.astype(np.int64))


def test_traversal_stats_match_jax_and_karras_beats_median():
    """``traversal_stats`` equals JAX's integers for both topologies, and
    karras cuts the steps of the median split by over 10% on the small
    hall (tests/test_bvh.py:test_karras_beats_median_splits)."""
    jsoup = _soup("hall")
    tsoup = port_soup(jsoup)
    o, d = _hall_rays(512, 9)
    stats = {}
    for topo in TOPOLOGIES:
        jb = jlbvh.build_bvh(jsoup, leaf_size=4, topology=topo)
        tb = build_bvh(tsoup, leaf_size=4, topology=topo)
        sj = jtr.traversal_stats(jb, jnp.asarray(o), jnp.asarray(d))
        st = ttr.traversal_stats(tb, torch.tensor(o), torch.tensor(d))
        print(topo, st)
        assert st == sj
        assert all(isinstance(v, int) for v in st.values())
        stats[topo] = st
    caps = torch.full((512,), 3.0)
    assert ttr.traversal_stats(tb, torch.tensor(o), torch.tensor(d), caps)[
        "steps"] < stats["median"]["steps"]
    assert stats["karras"]["steps"] < 0.9 * stats["median"]["steps"]


def test_gradients_match_jax():
    """Vertex, origin and direction gradients through the walk's
    re-evaluation of the chosen triangle, against jax.grad: rtol 1e-4 of
    each entry plus 1e-5 of the largest (the FMA ulps above, through one
    division by det)."""
    jsoup = _soup((300, 384, 3))
    tsoup = port_soup(jsoup)
    jb = jlbvh.build_bvh(jsoup, leaf_size=4)
    tb = build_bvh(tsoup, leaf_size=4)
    o, d = _aimed_rays(jsoup, 256, 12)
    rng = np.random.default_rng(13)
    w = rng.uniform(0.5, 1.5, (3, 256)).astype(np.float32)

    def jloss(v0, v1, v2, o, d):
        s = dataclasses.replace(jsoup, v0=v0, v1=v1, v2=v2)
        h = jtr.intersect_closest_bvh(jb, s, o, d)
        m = h.tri >= 0
        return jnp.sum(jnp.where(m, w[0] * h.t + w[1] * h.u + w[2] * h.v,
                                 0.0))

    gj = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        jsoup.v0, jsoup.v1, jsoup.v2, jnp.asarray(o), jnp.asarray(d))
    leaves = [x.clone().requires_grad_(True) for x in
              (tsoup.v0, tsoup.v1, tsoup.v2, torch.tensor(o),
               torch.tensor(d))]
    s = dataclasses.replace(tsoup, v0=leaves[0], v1=leaves[1], v2=leaves[2])
    h = ttr.intersect_closest_bvh(tb, s, leaves[3], leaves[4])
    tw = torch.tensor(w)
    loss = torch.where(h.tri >= 0, tw[0] * h.t + tw[1] * h.u + tw[2] * h.v,
                       0.0).sum()
    gt = torch.autograd.grad(loss, leaves)
    assert int((h.tri >= 0).sum()) > 30
    for name, a, b in zip(("v0", "v1", "v2", "o", "d"), gt, gj):
        b = np.asarray(b)
        assert np.isfinite(a.numpy()).all()
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
