"""The BVH walk kernel's memory layout and schedule, on the CPU.

``csrc/bvh_walk.cu`` reads the BVH as packed records
(``ops/bvh_walk.py:pack_nodes``, ``pack_slots``) and walks it with
persistent warps that refill idle lanes from a global ray counter.  No
CUDA kernel runs here, so ``emulate_walk`` below is the kernel written out
in torch, step for step: the warps' refill loop (chunks of 32 rays from
one counter, a dead lane answered at once), each lane's box steps over
the node records until it is parked at a leaf or done, the parked lanes'
K-wide leaf tests over the slot records, and the end of a ray, with the
kernel's operation order.  It must give (t, slot) bit for bit equal to
the plain walk (``bvh_walk_plain``, the kernel's reference), the node
steps and leaf visits of ``traversal_stats``, and every ray answered once;
against the JAX package's ``_traverse2`` the tolerance is
tests/test_torch_bvh.py's: 2 ulps of t at the numerator's scale over
|det| (XLA's FMA contraction on the CPU), and lanes that take another
triangle within that bound (ties) or flip at the cap edge are counted and
held to 1% of the lanes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.accel import lbvh as jlbvh  # noqa: E402
from prismarine_core_tpu.accel import traverse as jtr  # noqa: E402
from prismarine_core_tpu.models import scene as jscene  # noqa: E402
from prismarine_core_tpu_torch.accel import traverse as ttr  # noqa: E402
from prismarine_core_tpu_torch.accel.lbvh import (  # noqa: E402
    build_bvh, refit_bvh)
from prismarine_core_tpu_torch.models import scene as tscene  # noqa: E402
from prismarine_core_tpu_torch.ops import bvh_walk as bw  # noqa: E402
from prismarine_core_tpu_torch.ops.intersect import (  # noqa: E402
    moller_trumbore)
from prismarine_core_tpu_torch.utils.config import (  # noqa: E402
    INF_DIST, PZERO)
from tests.test_torch_bvh import (  # noqa: E402
    _aimed_rays, _hall_rays, _soup)
from tests.test_torch_primitives import assert_ulp  # noqa: E402
from tests.test_torch_scene import port_soup  # noqa: E402

torch.set_num_threads(1)
TOPOLOGIES = ("karras", "median")
#: the walk's scenes: the small hall and a random soup
SCENES = ("hall", (300, 384, 3))
SCENE_IDS = ("hall", "300")
#: rays a cap group, and the cap groups: INF_DIST, dead lanes (cap 0)
#: among INF_DIST ones, short caps, caps above INF_DIST (the plain walk's
#: quirk)
GROUP = 96
CAPS = ("inf", "dead", "short", "beyond-inf")
#: the kernel's warp width and the rays a warp takes from the counter
WARP, CHUNK = 32, 32


def _case(scene, topology):
    """(JAX soup, JAX BVH, port BVH, o, d, t_cap, group) for one scene."""
    jsoup = _soup(scene)
    jb = jlbvh.build_bvh(jsoup, leaf_size=4, topology=topology)
    tb = build_bvh(port_soup(jsoup), leaf_size=4, topology=topology)
    r = GROUP * len(CAPS)
    o, d = _hall_rays(r, 12) if scene == "hall" else _aimed_rays(jsoup, r,
                                                                 12)
    rng = np.random.default_rng(13)
    caps = {"inf": np.full(GROUP, INF_DIST),
            "dead": np.where(rng.random(GROUP) < 0.5, 0.0, INF_DIST),
            "short": rng.uniform(0.5, 6.0, GROUP),
            "beyond-inf": np.full(GROUP, 2.0 * INF_DIST)}
    t_cap = np.concatenate([caps[c] for c in CAPS]).astype(np.float32)
    group = np.repeat(np.arange(len(CAPS)), GROUP)
    return jsoup, jb, tb, o, d, t_cap, group


def emulate_walk(nodes, slots, o, d, t_cap, any_hit, n_nodes, leaf_size,
                 n_warps=3):
    """``csrc/bvh_walk.cu`` in torch: ``n_warps`` persistent warps over the
    packed records.  Each round, every warp that has not exited refills
    (the kernel's loop, per lane in Python), then all lanes run their box
    steps until parked or done, the parked lanes their leaf tests, and the
    done lanes write their ray (one interleaving of the warps the kernel
    allows).  Returns (t, slot, steps, leaf_visits, writes per ray)."""
    nf, sf = nodes.view(torch.float32), slots.view(torch.float32)
    r = o.shape[0]
    lanes = n_warps * WARP
    out_t = torch.full((r,), float("nan"))
    out_slot = torch.full((r,), -2, dtype=torch.int32)
    writes = torch.zeros((r,), dtype=torch.int64)
    ray = torch.full((lanes,), -1, dtype=torch.int64)
    node = torch.full((lanes,), n_nodes, dtype=torch.int64)
    best = torch.zeros((lanes,))
    bslot = torch.full((lanes,), -1, dtype=torch.int64)
    lo_, ld_, liv = (torch.zeros((lanes, 3)) for _ in range(3))
    inv_d = bw.guarded_inv(d)
    counter = 0
    pool, pool_end = [0] * n_warps, [0] * n_warps
    drained, exited = [False] * n_warps, [False] * n_warps
    steps = leaf_visits = 0

    def write(i, t, s):
        out_t[i], out_slot[i] = t, s
        writes[i] += 1

    while not all(exited):
        for w in range(n_warps):
            if exited[w]:
                continue
            while True:                               # the refill loop
                idle = [j for j in range(w * WARP, (w + 1) * WARP)
                        if ray[j] < 0]
                if not idle:
                    break
                if pool[w] == pool_end[w]:
                    if drained[w]:
                        break
                    base, counter = counter, counter + CHUNK
                    if base >= r:
                        drained[w] = True
                        break
                    pool[w], pool_end[w] = base, min(base + CHUNK, r)
                for rank, j in enumerate(idle[:pool_end[w] - pool[w]]):
                    i = pool[w] + rank
                    if t_cap[i] <= PZERO:             # dead: out at once
                        write(i, t_cap[i], -1)
                    else:
                        ray[j], node[j], bslot[j] = i, 0, -1
                        best[j] = t_cap[i]
                        lo_[j], ld_[j], liv[j] = o[i], d[i], inv_d[i]
                pool[w] = min(pool[w] + len(idle), pool_end[w])
            if not bool((ray[w * WARP:(w + 1) * WARP] >= 0).any()):
                exited[w] = True

        # box steps until parked or done
        leaf_slot = torch.full((lanes,), -1, dtype=torch.int64)
        walking = node < n_nodes
        while bool(walking.any()):
            j = torch.nonzero(walking)[:, 0]
            rec, irec = nf[node[j]], nodes[node[j]]
            t0 = (rec[:, 0:3] - lo_[j]) * liv[j]
            t1 = (rec[:, 4:7] - lo_[j]) * liv[j]
            mn, mx = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tn = torch.maximum(torch.maximum(mn[:, 0], mn[:, 1]), mn[:, 2])
            tf = torch.minimum(torch.minimum(mx[:, 0], mx[:, 1]), mx[:, 2])
            hit = ((tf >= torch.maximum(tn, torch.tensor(PZERO)))
                   & (tn < best[j]))
            link, skip = irec[:, 3].long(), irec[:, 7].long()
            node[j] = torch.where(hit & (link >= 0), link, skip)
            park = hit & (link < 0)
            leaf_slot[j[park]] = ~link[park]
            walking[j] = ~park & (node[j] < n_nodes)
            steps += j.numel()

        # the parked lanes' leaf tests
        j = torch.nonzero(leaf_slot >= 0)[:, 0]
        if j.numel():
            leaf_visits += j.numel()
            s = leaf_slot[j, None] + torch.arange(leaf_size)[None, :]
            tt, _, _, _ = moller_trumbore(lo_[j, None], ld_[j, None],
                                          sf[s, 0:3], sf[s, 4:7],
                                          sf[s, 8:11])
            c = torch.where((slots[s, 3] >= 0) & (tt < best[j, None]), tt,
                            INF_DIST)
            cmin = torch.full((j.numel(),), INF_DIST)
            cj = torch.full((j.numel(),), -1, dtype=torch.int64)
            for k in range(leaf_size):                # first minimum
                take = (cj < 0) | (c[:, k] < cmin)
                cmin = torch.where(take, c[:, k], cmin)
                cj = torch.where(take, k, cj)
            better = cmin < best[j]
            best[j] = torch.where(better, cmin, best[j])
            bslot[j] = torch.where(better, leaf_slot[j] + cj, bslot[j])
            if any_hit:
                node[j] = torch.where(bslot[j] >= 0, n_nodes, node[j])

        # the end of each done lane's ray (the plain walk's quirk first)
        for jj in torch.nonzero((ray >= 0) & (node >= n_nodes))[:, 0]:
            if INF_DIST < best[jj]:
                best[jj], bslot[jj] = INF_DIST, 0
            write(int(ray[jj]), best[jj], int(bslot[jj]))
            ray[jj] = -1
    return out_t, out_slot, steps, leaf_visits, writes


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("scene", SCENES, ids=SCENE_IDS)
def test_records_round_trip(scene, topology):
    """pack_nodes / pack_slots hold every field of the BVH bit for bit:
    lo, hi, skip and the vertices as float bits, left as the link of an
    internal node, a leaf's first slot as ~link, orig."""
    tb = build_bvh(port_soup(_soup(scene)), leaf_size=4, topology=topology)
    nodes, slots = bw.pack_nodes(tb), bw.pack_slots(tb)
    assert nodes.dtype == slots.dtype == torch.int32
    assert nodes.shape == (tb.n_nodes, bw.NODE_WORDS)
    assert slots.shape == (tb.tv0.shape[0], bw.SLOT_WORDS)
    nf, sf = nodes.view(torch.float32), slots.view(torch.float32)
    assert torch.equal(nf[:, 0:3], tb.lo) and torch.equal(nf[:, 4:7], tb.hi)
    assert torch.equal(nodes[:, 7], tb.skip)
    link = nodes[:, 3]
    fl = tb.first_leaf
    assert torch.equal(link[:fl], tb.left[:fl])
    assert bool((link[:fl] >= 0).all()) and bool((tb.left[fl:] == -1).all())
    leaves = torch.arange(tb.n_leaves, dtype=torch.int32)
    assert torch.equal(~link[fl:], leaves * tb.leaf_size)
    assert torch.equal(torch.where(link >= 0, link, -1), tb.left)
    for col, v in ((0, tb.tv0), (4, tb.tv1), (8, tb.tv2)):
        assert torch.equal(sf[:, col:col + 3], v)
    assert torch.equal(slots[:, 3], tb.orig)
    assert bool((slots[:, 7] == 0).all()) and bool((slots[:, 11] == 0).all())


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("scene", SCENES, ids=SCENE_IDS)
def test_walk_emulation_equals_plain_and_jax(scene, topology, any_hit):
    """The kernel's walk over the records (``emulate_walk``) == the plain
    walk on (t, slot) exactly for every cap group, every ray answered
    once, the walk's node steps and leaf visits those of
    traversal_stats on the live lanes; against JAX's ``_traverse2`` within
    the ulp bound."""
    jsoup, jb, tb, o, d, t_cap, group = _case(scene, topology)
    to, td, tc = (torch.tensor(x) for x in (o, d, t_cap))
    nodes, slots = bw.pack_nodes(tb), bw.pack_slots(tb)
    t, slot, steps, leaf_visits, writes = emulate_walk(
        nodes, slots, to, td, tc, any_hit, tb.n_nodes, tb.leaf_size)
    assert bool((writes == 1).all()), "a ray answered other than once"
    tp, sp, _, _ = bw.bvh_walk_plain(tb, to, td, tc, any_hit)
    for g, cap in enumerate(CAPS):
        m = torch.tensor(group == g)
        assert torch.equal(t[m], tp[m]), f"t differs ({cap} caps)"
        assert torch.equal(slot[m].long(), sp[m]), f"slot differs ({cap})"
    dead = tc <= PZERO
    assert int(dead.sum()) > 10
    assert torch.equal(t[dead].view(torch.int32), tc[dead].view(torch.int32))
    assert bool((slot[dead] == -1).all())
    assert int((slot[~dead] >= 0).sum()) > 30
    live = ~dead
    stats = ttr.traversal_stats(tb, to[live], td[live], tc[live], any_hit)
    assert (steps, leaf_visits) == (stats["steps"], stats["leaf_visits"])

    # against JAX: the same tree, its walk under XLA's FMA contraction
    jt, js, _, _ = jax.jit(jtr._traverse2, static_argnums=4)(
        jb, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_cap), any_hit)
    jt, js = np.asarray(jt), np.asarray(js)
    sn, tn = slot.numpy(), t.numpy()
    assert np.array_equal(tn[dead.numpy()], jt[dead.numpy()])
    both = (sn >= 0) & (js >= 0)
    flips = int(((sn >= 0) != (js >= 0)).sum())
    ties = both & (sn != js)
    print(f"emulation vs JAX: {flips} hit/miss flips, {int(ties.sum())} "
          f"tie lanes of {int(both.sum())} joint hits")
    assert flips + int(ties.sum()) <= max(1, sn.size // 100)
    soup_np = [np.asarray(x) for x in (jb.tv0, jb.tv1, jb.tv2)]
    v0, v1, v2 = (x[np.maximum(sn, 0)] for x in soup_np)
    det = np.abs(np.einsum("ij,ij->i", v1 - v0, np.cross(d, v2 - v0)))
    scale = 256.0 / np.maximum(det, 1e-6)
    same = both & (sn == js)
    if not any_hit:
        assert_ulp(tn[same], jt[same], scale[same], n_ulp=2.0)
    miss = (sn < 0) & (js < 0)
    assert np.array_equal(tn[miss], jt[miss])


def test_walk_records_cache_sees_refit_and_writes():
    """``walk_records`` reuses a BVH's records while its tensors stand,
    also through a detached copy of the BVH (a new object each query),
    and packs anew after ``refit_bvh`` on moved vertices and after an
    in-place write to a source tensor."""
    jsoup = _soup((300, 384, 3))
    soup = port_soup(jsoup)
    tb = build_bvh(soup, leaf_size=4)
    first = bw.walk_records(tb)
    detached = type(tb)(**{f.name: getattr(tb, f.name).detach()
                           for f in dataclasses.fields(tb)})
    assert bw.walk_records(detached)[0] is first[0]
    moved = dataclasses.replace(soup, v0=soup.v0 + 0.25, v1=soup.v1 + 0.25,
                                v2=soup.v2 + 0.25)
    tr = refit_bvh(tb, moved)
    nodes, slots = bw.walk_records(tr)
    assert torch.equal(nodes, bw.pack_nodes(tr))
    assert torch.equal(slots, bw.pack_slots(tr))
    assert not torch.equal(nodes, first[0])
    tb.tv0.add_(1.0)
    again = bw.walk_records(tb)
    assert again[1] is not first[1]
    assert torch.equal(again[1], bw.pack_slots(tb))
    with torch.inference_mode():
        frozen = type(tb)(**{f.name: getattr(tb, f.name).clone()
                             for f in dataclasses.fields(tb)})
    assert torch.equal(bw.walk_records(frozen)[0], bw.pack_nodes(tb))


def test_cornell_closest_bvh_uncapped_matches_jax():
    """``intersect_closest_bvh(..., t_cap=None)`` (every lane to INF_DIST,
    the JAX package's query) against JAX's on the cornell box: the same
    hit/miss, t within tests/test_torch_bvh.py's ulp bound, ties counted;
    an explicit all-INF_DIST cap gives the same hit bit for bit."""
    js = jscene.make_cornell_scene()
    ts = tscene.make_cornell_scene(device="cpu")
    rng = np.random.default_rng(17)
    o = rng.uniform(-0.9, 0.9, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    to, td = torch.tensor(o), torch.tensor(d)
    hv = ttr.intersect_closest_bvh(ts.bvh, ts.triangles, to, td)
    hc = ttr.intersect_closest_bvh(ts.bvh, ts.triangles, to, td,
                                   t_cap=torch.full((512,), INF_DIST))
    assert torch.equal(hv.t, hc.t) and torch.equal(hv.tri, hc.tri)
    hj = jtr.intersect_closest_bvh(js.bvh, js.triangles, jnp.asarray(o),
                                   jnp.asarray(d))
    tri_t, tri_j = hv.tri.numpy(), np.asarray(hj.tri)
    assert int((tri_t >= 0).sum()) > 400
    np.testing.assert_array_equal(tri_t >= 0, tri_j >= 0)
    soup_np = [np.asarray(x) for x in (js.triangles.v0, js.triangles.v1,
                                       js.triangles.v2)]
    v0, v1, v2 = (x[np.maximum(tri_t, 0)] for x in soup_np)
    det = np.abs(np.einsum("ij,ij->i", v1 - v0, np.cross(d, v2 - v0)))
    scale = 16.0 / np.maximum(det, 1e-6)
    hit = tri_t >= 0
    assert_ulp(hv.t.numpy()[hit], np.asarray(hj.t)[hit], scale[hit],
               n_ulp=2.0)
    ties = tri_t != tri_j
    print(f"port vs JAX: {int(ties.sum())} tie lanes of {hit.sum()} hits")
    assert int(ties.sum()) <= max(1, hit.sum() // 100)


def test_dead_lanes_change_no_pixel(monkeypatch):
    """The "bvh" frame with the bounce's cap (dead lanes at 0, ended
    before their first step) equals the frame whose closest queries run
    every lane to INF_DIST, bit for bit, on a cornell frame whose later
    bounces have dead lanes."""
    from prismarine_core_tpu_torch.models.camera import Camera
    from prismarine_core_tpu_torch.ops.sampling import make_sample_arrays
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    scene = tscene.make_cornell_scene(device="cpu")
    cam = Camera.look_at(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                         fov_y_deg=50.0, device="cpu")
    cfg = RenderConfig(width=16, height=16, max_bounces=4)
    assert cfg.intersector == "bvh"
    samples = make_sample_arrays(torch.Generator().manual_seed(5),
                                 cfg.n_rays, cfg.max_bounces)
    caps = []
    walk = ttr.intersect_closest_bvh

    def recording(*args, t_cap=None, **kw):
        caps.append(t_cap)
        return walk(*args, t_cap=t_cap, **kw)
    monkeypatch.setattr(ttr, "intersect_closest_bvh", recording)
    img, stats = render_with_samples(scene, cam, cfg, *samples,
                                     with_stats=True)
    assert len(caps) == cfg.max_bounces
    assert int((caps[-1] == 0).sum()) > 0, "no dead lane at the last bounce"
    monkeypatch.setattr(ttr, "intersect_closest_bvh",
                        lambda *args, t_cap=None, **kw: walk(*args, **kw))
    ref, ref_stats = render_with_samples(scene, cam, cfg, *samples,
                                         with_stats=True)
    assert torch.equal(img, ref) and torch.equal(stats, ref_stats)
