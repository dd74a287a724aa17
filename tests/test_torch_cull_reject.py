"""The cull kernels' tile-level reject in plain torch (``tile_ray_bounds``,
``tile_reject``), held against the plain versions ``block_cull_plain`` and
``pair_cull_plain``:

* conservative: no rejected (tile, box) entry has a ray that passes (the
  kernels test the others with the plain slab formula, so they then equal
  the plain versions, which tests/test_torch_gpu.py checks on the card);
* on coherent tiles the reject settles most failing entries;
* on tiles of one repeated ray the reject decides exactly as the slab
  test;
* on the same edge cases the plain versions equal the JAX package's
  Pallas kernels.

Inputs: a small procedural hall (its superblock and block boxes, plus
extra boxes: point boxes at +-EMPTY_BOX, flat and tiny boxes, boxes
holding the ray origins, and a count that is no multiple of 128, so
``box_rows_from_blocks`` pads inverted lanes) against camera rays, bounce
rays, shadow rays to one point, unsorted rays whose tiles straddle
octants, directions with components below 1e-12 and of +-0.0, dead lanes
(t_cap 0 and -0.0), tiny caps and round-2 caps (tightened to a closest
hit).  The CUDA kernels run the same cases in tests/test_torch_gpu.py.
Only the tests against the JAX package's Pallas kernels import jax,
inside their bodies, so tests/test_torch_gpu.py can import the case
functions on a machine without it.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from prismarine_core_tpu_torch.accel import packet as pk  # noqa: E402
from prismarine_core_tpu_torch.accel.lbvh import EMPTY_BOX  # noqa: E402
from prismarine_core_tpu_torch.models.camera import (  # noqa: E402
    Camera, generate_rays)
from prismarine_core_tpu_torch.models.procedural import (  # noqa: E402
    make_hall_scene)
from prismarine_core_tpu_torch.ops import cull  # noqa: E402
from prismarine_core_tpu_torch.ops.intersect import (  # noqa: E402
    intersect_closest_brute)
from prismarine_core_tpu_torch.utils.config import (  # noqa: E402
    INF_DIST, RenderConfig)
from prismarine_core_tpu_torch.utils.math import safe_rcp  # noqa: E402

torch.set_num_threads(1)
TILE = 128
W, H = 64, 48                      # 3,072 camera rays: 24 tiles


@functools.lru_cache(maxsize=2)
def _hall(dev):
    """A small hall (32 superblocks, 256 blocks) and its camera's primary
    rays and closest hits."""
    scene = make_hall_scene(target_tris=20000, device=dev)
    cam = Camera.look_at((-10.0, 2.2, 0.0), (6.0, 1.6, 0.0), fov_y_deg=60.0,
                         device=dev)
    cfg = RenderConfig(width=W, height=H, spp=1)
    o, d = generate_rays(cam, cfg, torch.full((W * H, 4), 0.5, device=dev))
    hit = intersect_closest_brute(scene.triangles, o, d)
    return scene, o.contiguous(), d, hit


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _extra_boxes(rng, eye, dev):
    """80 boxes (lo, hi) f32[80, 3]: random and flat boxes in the hall,
    tiny ones, boxes around the eye, and point boxes at +-EMPTY_BOX."""
    c = rng.uniform((-12, 0, -5), (12, 6, 5), (80, 3))
    half = rng.uniform(0.05, 2.0, (80, 3))
    half[10:20, rng.integers(0, 3, 10)] = 0.0              # flat
    half[20:30] = rng.uniform(0.0, 1e-6, (10, 3))          # tiny
    c[30:36] = eye + rng.uniform(-0.3, 0.3, (6, 3))        # the eye inside
    lo, hi = c - half, c + half
    lo[36:42] = hi[36:42] = EMPTY_BOX                      # empty blocks
    lo[42:45] = hi[42:45] = -EMPTY_BOX
    lo[45:47], hi[45:47] = -EMPTY_BOX, EMPTY_BOX           # everything
    return (torch.tensor(lo.astype(np.float32), device=dev),
            torch.tensor(hi.astype(np.float32), device=dev))


def make_case(name, dev="cpu"):
    """One case's inputs on ``dev``: the ray matrix, box row sets
    (superblocks, blocks, extra boxes), superblock box tables (the hall's,
    the extra boxes') and the coherent flag."""
    scene, o, d, hit = _hall(dev)
    rng = np.random.default_rng(sum(map(ord, name)))
    r = o.shape[0]
    live_t = torch.full((r,), INF_DIST, device=dev)
    order = None
    p = o + hit.t[:, None] * d                              # primary hits
    missed = hit.tri < 0
    if name == "camera":
        t_cap = live_t
    elif name == "bounce":
        n = torch.tensor(_unit(rng.normal(size=(r, 3))).astype(np.float32),
                         device=dev)
        o = p - 1e-3 * d
        d = torch.where((n * d).sum(-1, keepdim=True) > 0, -n, n)
        t_cap = torch.where(missed, 0.0, INF_DIST)
    elif name == "shadow":
        light = torch.tensor([0.0, 5.5, 0.3], device=dev)
        o = p - 1e-3 * d
        to = light - o
        dist = to.norm(dim=-1)
        d = to / dist[:, None]
        t_cap = torch.where(missed, 0.0, dist * (1.0 - 1e-3))
    elif name == "octants":                    # unsorted: mixed octants
        o = torch.tensor(rng.uniform((-11, 0.1, -4.5), (11, 5.9, 4.5),
                                     (r, 3)).astype(np.float32), device=dev)
        d = torch.tensor(_unit(rng.normal(size=(r, 3))).astype(np.float32),
                         device=dev)
        t_cap = live_t
        ident = torch.arange(r, device=dev)
        order = (ident, ident)
    elif name == "tiny-d":
        d = d.clone()
        lanes = torch.arange(r, device=dev)
        for a, vals in ((1, (1e-13, -1e-13, 0.0, -0.0)), (2, (0.0, -0.0))):
            for i, v in enumerate(vals):
                d[(lanes // 256) % (2 * len(vals)) == i, a] = v
        t_cap = live_t
    elif name == "dead":
        u = rng.random(r)
        t_cap = torch.tensor(np.where(u < 0.3, 0.0, np.where(
            u < 0.5, -0.0, INF_DIST)).astype(np.float32), device=dev)
    elif name == "caps":                      # round 2: caps at the hits
        u = torch.tensor(rng.random(r).astype(np.float32), device=dev)
        t_cap = torch.minimum(live_t, hit.t)
        t_cap = torch.where(u < 0.1, 1e-6, t_cap)
        t_cap = torch.where((u >= 0.1) & (u < 0.15), 1e-30, t_cap)
        t_cap = torch.where((u >= 0.15) & (u < 0.2), 0.0, t_cap)
    else:
        raise ValueError(name)
    bvh, ps = scene.bvh, scene.packets
    rays, _, _ = pk._sorted_rays_matrix(bvh.lo[0], bvh.hi[0], o, d, t_cap,
                                        order)
    elo, ehi = _extra_boxes(rng, np.array([-10.0, 2.2, 0.0]), dev)
    return dict(
        rays=rays,
        rows={"sb": cull.box_rows_from_blocks(ps.sb_lo, ps.sb_hi),
              "block": cull.box_rows_from_blocks(ps.block_lo, ps.block_hi),
              "extra": cull.box_rows_from_blocks(elo[:77], ehi[:77])},
        tables={"sb": cull.sb_box_table(ps.block_lo, ps.block_hi),
                "extra": cull.sb_box_table(elo, ehi)},
        coherent=name in ("camera", "shadow", "tiny-d", "dead", "caps"),
        seed=sum(map(ord, name)))


CASES = ["camera", "bounce", "shadow", "octants", "tiny-d", "dead", "caps"]


def n_live_of(rays):
    nt = rays.shape[0] // TILE - 1
    return pk._live_tile_bound(rays[:nt * TILE, 6].reshape(nt, TILE))


def pair_lists(case, table):
    """(pair_tile, pair_sb) of a tile-major list: the superblock cull's
    candidates plus 300 random (tile, superblock) pairs, the sentinel
    superblock included."""
    rays = case["rays"]
    rng = np.random.default_rng(case["seed"] + len(table))
    dev = rays.device
    nt = rays.shape[0] // TILE - 1
    nsb = case["tables"][table].shape[0] - 1
    sb_rows = (case["rows"]["sb"] if table == "sb" else
               case["rows"]["extra"])[:, :nsb].contiguous()
    mask = cull.block_cull_plain(rays, sb_rows, nt) < INF_DIST
    pt, psb = (x.cpu().numpy() for x in torch.nonzero(mask, as_tuple=True))
    pt = np.concatenate([pt, rng.integers(0, nt + 1, 300)])
    psb = np.concatenate([psb, rng.integers(0, nsb + 1, 300)])
    o = np.argsort(pt, kind="stable")
    return (torch.tensor(pt[o].astype(np.int32), device=dev),
            torch.tensor(psb[o].astype(np.int32), device=dev))


@pytest.fixture(scope="module", params=CASES)
def case(request):
    return make_case(request.param)


def test_reject_is_conservative(case):
    """No rejected (tile, box) entry has a passing ray, at both levels;
    on coherent tiles the reject settles most failing entries."""
    rays = case["rays"]
    nt = rays.shape[0] // TILE - 1
    for name, rows in case["rows"].items():
        passes = cull.block_cull_plain(rays, rows, nt) < INF_DIST
        rej = cull.block_cull_rejects(rays, rows, nt)
        assert not bool((rej & passes).any()), name
        live = cull.tile_ray_bounds(rays[:nt * TILE]).tc_max > 0
        failing = ~passes & live[:, None]
        share = float(rej[failing].float().mean())
        if case["coherent"] and name != "extra":
            assert share > 0.5, (name, share)
    for name, table in case["tables"].items():
        pt, psb = pair_lists(case, name)
        n = torch.tensor(pt.shape[0], dtype=torch.int32)
        surv = cull.pair_cull_survivors(pt, psb, n, rays, table)
        bits = cull.pair_cull_plain(pt, psb, n, rays, table)
        kept = (surv.int() << torch.arange(8, dtype=torch.int32)).sum(
            1, dtype=torch.int32)
        assert torch.equal(bits & ~kept, torch.zeros_like(bits)), name
        if case["coherent"]:
            assert float(surv.float().mean()) < 0.9, name


def one_ray_tiles(seed, dev="cpu"):
    """A ray matrix of 64 tiles, each one random ray repeated 128 times
    (some with direction components of 1e-13, +-0.0), and 2,048 boxes
    around the rays' paths near their origins and their caps."""
    rng = np.random.default_rng(seed)
    nt = 64
    o = rng.uniform(-5, 5, (nt, 3))
    d = _unit(rng.normal(size=(nt, 3)))
    d[8:16, 0] = 1e-13
    d[16:24, 1] = -0.0
    d[24:32, 2] = 0.0
    d = d.astype(np.float32)
    tc = rng.uniform(0.5, 20.0, nt)
    rays = torch.zeros(((nt + 1) * TILE, 16), device=dev)
    rows = torch.tensor(np.repeat(np.concatenate(
        [o, d, tc[:, None]], 1), TILE, 0).astype(np.float32), device=dev)
    rays[:nt * TILE, 0:7] = rows
    rays[:nt * TILE, 8:11] = safe_rcp(rows[:, 3:6])
    t = rng.choice(nt, 2048)
    s = np.where(rng.random(2048) < 0.5, tc[t], 0.0) + rng.normal(0, 0.3,
                                                                  2048)
    c = o[t] + s[:, None] * d[t] + rng.normal(0, 0.2, (2048, 3))
    half = rng.uniform(0.0, 0.4, (2048, 3))
    lo, hi = (torch.tensor(x.astype(np.float32), device=dev)
              for x in (c - half, c + half))
    return rays, cull.box_rows_from_blocks(lo, hi)


def test_reject_is_exact_on_one_ray_tiles():
    """With one ray in a tile its bounds are that ray's values, so on the
    tiles whose three axes take part the reject rejects exactly the boxes
    the ray fails: the corners are the ray's own rounded slab distances."""
    rays, rows = one_ray_tiles(1)
    nt = rays.shape[0] // TILE - 1
    fails = cull.block_cull_plain(rays, rows, nt) == INF_DIST
    rej = cull.block_cull_rejects(rays, rows, nt)
    b = cull.tile_ray_bounds(rays[:nt * TILE])
    takes = ((b.iv_lo > 0) | (b.iv_hi < 0)).all(1)
    assert bool(takes.all())
    assert torch.equal(rej, fails)
    assert 0.2 < float(fails.float().mean()) < 0.995


def _tile(o, d, tc):
    """A 128-row ray matrix tile from per-lane (o, d, t_cap) (lists are
    repeated over the lanes)."""
    rays = torch.zeros((TILE, 16))
    rays[:, 0:3] = torch.tensor(o, dtype=torch.float32)
    rays[:, 3:6] = torch.tensor(d, dtype=torch.float32)
    rays[:, 6] = torch.tensor(tc, dtype=torch.float32)
    rays[:, 8:11] = 1.0 / rays[:, 3:6]
    return rays


def test_tile_ray_bounds_fold_live_lanes_only():
    o = [[float(i), -i, 2 * i] for i in range(TILE)]
    d = [[1.0, 2.0, -4.0]] * TILE
    tc = [5.0 if i % 3 else 0.0 for i in range(TILE)]
    tc[1] = -0.0
    tc[2] = float("nan")
    rays = _tile(o, d, tc)
    rays[3, 0] = float("inf")                      # a dead lane's garbage
    b = cull.tile_ray_bounds(rays)
    live = torch.tensor([t > 0 for t in tc])
    assert torch.equal(b.o_lo[0], rays[live, 0:3].amin(0))
    assert torch.equal(b.o_hi[0], rays[live, 0:3].amax(0))
    assert torch.equal(b.iv_lo[0], torch.tensor([1.0, 0.5, -0.25]))
    assert float(b.tc_max[0]) == 5.0 and bool(b.finite[0])
    rays[4, 1] = float("nan")                      # a live lane's NaN
    assert not bool(cull.tile_ray_bounds(rays).finite[0])
    rays[:, 6] = 0.0
    assert float(cull.tile_ray_bounds(rays).tc_max[0]) == 0.0


def test_tile_reject_hand_cases():
    """Rays along +x from the plane x = 0, y, z in [0, 1], t_cap 10:
    boxes behind, beside and beyond the cap are rejected; boxes in reach,
    holding the origins, or inverted are not; a tile with a non-finite
    lane rejects nothing and one with no live lane everything."""
    rng = np.random.default_rng(0)
    o = np.concatenate([np.zeros((TILE, 1)), rng.random((TILE, 2))], 1)
    d = _unit(np.concatenate([np.ones((TILE, 1)),
                              rng.uniform(1e-4, 1e-3, (TILE, 2))], 1))
    rays = _tile(o.tolist(), d.tolist(), [10.0] * TILE)
    boxes = {  # name: (lo, hi, rejected)
        "behind": ((-3, 0, 0), (-2, 1, 1), True),
        "beside": ((2, 5, 0), (3, 6, 1), True),
        "beyond": ((11, 0, 0), (12, 1, 1), True),
        "ahead": ((2, 0.2, 0.2), (3, 0.4, 0.4), False),
        "origin": ((-0.1, 0.4, 0.4), (0.1, 0.6, 0.6), False),
        "point": ((EMPTY_BOX,) * 3, (EMPTY_BOX,) * 3, True),
        "inverted": ((EMPTY_BOX,) * 3, (-EMPTY_BOX,) * 3, False),
    }
    lo = torch.tensor([b[0] for b in boxes.values()],
                      dtype=torch.float32)[None]
    hi = torch.tensor([b[1] for b in boxes.values()],
                      dtype=torch.float32)[None]
    want = torch.tensor([[b[2] for b in boxes.values()]])
    assert torch.equal(cull.tile_reject(cull.tile_ray_bounds(rays), lo, hi),
                       want)
    bad = rays.clone()
    bad[7, 9] = float("inf")
    assert not bool(cull.tile_reject(cull.tile_ray_bounds(bad), lo,
                                     hi).any())
    bad[:, 6] = 0.0
    assert bool(cull.tile_reject(cull.tile_ray_bounds(bad), lo, hi).all())


def _aligned(pt, psb, nsb, cpps):
    """A tile-major pair list with each tile's run padded to a multiple of
    ``cpps`` with the sentinel superblock (the JAX pair kernel's layout)."""
    out_t, out_s = [], []
    for t in np.unique(pt):
        sbs = list(psb[pt == t]) + [nsb] * (-int((pt == t).sum()) % cpps)
        out_t += [t] * len(sbs)
        out_s += sbs
    return (torch.tensor(out_t, dtype=torch.int32),
            torch.tensor(out_s, dtype=torch.int32))


def test_block_cull_plain_matches_pallas_on_edge_cases(case):
    """The plain block cull (the CPU branch of ``block_cull``) equals the
    JAX package's Pallas kernel, in interpret mode, on the edge-case rays
    and boxes (jax is imported here only)."""
    import tests.conftest  # noqa: F401  (pins JAX to the CPU)
    import jax.numpy as jnp
    from prismarine_core_tpu.ops import pallas_cull as jcull
    rays = case["rays"]
    n_live = n_live_of(rays)
    for rows in (case["rows"]["sb"], case["rows"]["extra"]):
        ref = np.asarray(jcull.pallas_block_cull(
            jnp.asarray(rays.numpy()), jnp.asarray(rows.numpy()),
            jnp.int32(int(n_live))))
        got = cull.block_cull(rays, rows, n_live).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("table", ["sb", "extra"])
def test_pair_cull_plain_matches_pallas_on_edge_cases(case, table):
    """The plain pair cull (the CPU branch of ``pair_cull``) equals the JAX
    package's Pallas kernel, in interpret mode, on the edge-case rays and
    each box table's pair list (padded to the kernel's tile alignment)."""
    import tests.conftest  # noqa: F401  (pins JAX to the CPU)
    import jax.numpy as jnp
    from prismarine_core_tpu.ops import pallas_cull as jcull
    cpps = 8
    rays, sbbox = case["rays"], case["tables"][table]
    pt, psb = _aligned(*(x.numpy() for x in pair_lists(case, table)),
                       sbbox.shape[0] - 1, cpps)
    for n_real in (pt.shape[0], pt.shape[0] - 5):
        ref = np.asarray(jcull.pallas_pair_cull(
            jnp.asarray(pt.numpy()), jnp.asarray(psb.numpy()),
            jnp.int32(n_real), jnp.asarray(rays.numpy()),
            jnp.asarray(sbbox.numpy()), cpps=cpps))
        got = cull.pair_cull(pt, psb, torch.tensor(n_real, dtype=torch.int32),
                             rays, sbbox).numpy()
        np.testing.assert_array_equal(got, ref)
        assert (got != 0).any()
