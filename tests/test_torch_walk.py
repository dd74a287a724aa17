"""The pair intersectors' balanced walk in plain torch (work units, 64-bit
keys folded with ``scatter_reduce("amin")``; for "mt2" the stages of two
sub-blocks of one tile, each chain folded in list order; decode) against
the plain versions ``sb_intersect_plain`` and ``sb_intersect_mxu_plain``,
bit for bit, on inputs built to stress the tie rule and the work split:

* duplicated triangles (the same plane values in many slots, in one
  sub-block, across sub-blocks and across superblocks), so that many
  (pair, k, lane) give bit-equal t for one ray;
* a prior-seeded second pass over the same list (every winner's t equals
  the prior's) and over a shorter ``n_real``;
* ``n_real`` below the list length, masks of 0, empty tiles, one tile
  holding every superblock, dead rays with t_cap 0 and -0.0;
* tiles that each hold an odd number of live sub-blocks, and tiles that
  each hold exactly one ("mt2": a lone stage at every tile's end);
* units of ``WALK_UNIT`` live sub-blocks (the CUDA walk's) and of 3
  (units that start and end inside pairs and tiles).

The JAX kernels are held against the plain versions by
tests/test_torch_kernels.py and tests/test_torch_kernel_forms.py; the
CUDA walk against the plain versions on these same inputs by
tests/test_torch_gpu.py.  This module imports no jax.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from prismarine_core_tpu_torch.accel import packet as pk  # noqa: E402
from prismarine_core_tpu_torch.accel.lbvh import build_bvh  # noqa: E402
from prismarine_core_tpu_torch.models.geometry import TriangleSoup  # noqa: E402
from prismarine_core_tpu_torch.ops import cull  # noqa: E402
from prismarine_core_tpu_torch.ops import sb_intersect as si  # noqa: E402
from prismarine_core_tpu_torch.utils.config import INF_DIST  # noqa: E402

torch.set_num_threads(1)
TILE, SB_LANES = 128, 1024


def _tie_planes(rng, nsb, n_templates=6, invalid_frac=0.05):
    """Planes f32[nsb+1, 16, 1024] whose slots are copies of a few large
    tilted triangles across z in [1, 6]: every slot holding one template
    gives the same t, bit for bit, for any ray."""
    base = np.array([[-30.0, -30.0], [60.0, -30.0], [-30.0, 60.0]])
    temp = []
    for _ in range(n_templates):
        z = rng.uniform(1.0, 6.0)
        tilt = rng.uniform(-0.05, 0.05, 2)
        v = np.concatenate([base, (z + base @ tilt)[:, None]], axis=1)
        temp.append(v.astype(np.float32))
    pick = rng.integers(0, n_templates, nsb * SB_LANES)
    v = np.stack([temp[i] for i in pick])                   # [S, 3, 3]
    v0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    valid = (rng.random(nsb * SB_LANES) >= invalid_frac).astype(np.float32)
    rows = np.zeros((16, nsb * SB_LANES), np.float32)
    rows[0:3], rows[3:6], rows[6:9], rows[9] = v0.T, e1.T, e2.T, valid
    planes = np.zeros((nsb + 1, 16, SB_LANES), np.float32)
    planes[:nsb] = rows.reshape(16, nsb, SB_LANES).transpose(1, 0, 2)
    return torch.tensor(planes)


def _tie_rays(rng, n, dev):
    """Rays from below the templates, up and slightly off the z axis; the
    ray matrix as the query builds it, then some dead rows with t_cap 0
    and -0.0."""
    o = np.concatenate([rng.uniform(-3, 3, (n, 2)), np.full((n, 1), -5.0)],
                       axis=1).astype(np.float32)
    d = np.concatenate([rng.uniform(-0.2, 0.2, (n, 2)), np.ones((n, 1))],
                       axis=1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    lo = torch.tensor([-30.0, -30.0, -6.0], device=dev)
    hi = torch.tensor([30.0, 30.0, 8.0], device=dev)
    rays, _, _ = pk._sorted_rays_matrix(
        lo, hi, torch.tensor(o, device=dev), torch.tensor(d, device=dev),
        torch.full((n,), INF_DIST, device=dev))
    dead = torch.tensor(rng.choice(n, n // 8, replace=False), device=dev)
    rays[dead[0::2], 6] = 0.0
    rays[dead[1::2], 6] = -0.0
    return rays, 0.5 * (lo + hi)


def _pair_list(rng, layout, nt, nsb):
    """A tile-major pair list (pair_tile, pair_sb, pair_mask) over nt
    tiles and nsb superblocks."""
    if layout == "one-tile":                  # tile 1 holds every sb
        pt = np.full(nsb, 1)
        psb = rng.permutation(nsb)
        pm = np.full(nsb, 0xFF)
    elif layout in ("odd", "single"):
        # every tile holds an odd number of live sub-blocks / exactly one
        keep = rng.random((nt, nsb)) < 0.6
        keep[np.arange(nt), rng.integers(0, nsb, nt)] = True
        pt, psb = np.nonzero(keep)
        pm = rng.integers(0, 256, len(pt))
        pm[rng.random(len(pt)) < 0.15] = 0
        for t in range(nt):
            run = np.nonzero(pt == t)[0]
            psb[run] = rng.permutation(psb[run])
            if layout == "single":
                pm[run] = 0
                pm[rng.choice(run)] = 1 << rng.integers(0, 8)
            elif sum(bin(m).count("1") for m in pm[run]) % 2 == 0:
                pm[run[-1]] ^= 1 << rng.integers(0, 8)   # odd count
    else:
        keep = (rng.random((nt, nsb)) < (1.0 if layout == "dense" else 0.4))
        if layout == "sparse":
            keep[0] = False                    # empty tiles
            keep[nt - 1] = False
        pt, psb = np.nonzero(keep)
        for t in range(nt):                    # any superblock order
            run = pt == t
            psb[run] = rng.permutation(psb[run])
        pm = rng.integers(0, 256, len(pt))
        pm[rng.random(len(pt)) < 0.15] = 0     # pairs with no live block
    return [torch.tensor(np.asarray(x, np.int32)) for x in (pt, psb, pm)]


def tie_case(layout, seed, dev="cpu"):
    """Inputs of one tie/imbalance case on ``dev``: rays, planes, mxu
    coefficient planes and the pair list."""
    rng = np.random.default_rng(seed)
    nt, nsb = 4, 5
    rays, center = _tie_rays(rng, nt * TILE - 37, dev)
    planes = _tie_planes(rng, nsb).to(dev)
    coef = si.mxu_planes_from_planes(planes, center)
    pt, psb, pm = (x.to(dev) for x in _pair_list(rng, layout, nt, nsb))
    return dict(rays=rays, planes=planes, coef=coef, pt=pt, psb=psb, pm=pm)


def bvh_case(seed, dev="cpu"):
    """Random small triangles through the port's own BVH, packet set,
    cull and compaction (the query's round-1 inputs)."""
    rng = np.random.default_rng(seed)
    n_tris, r = 2000, 1024
    centers = rng.uniform(-5, 5, (n_tris, 3)).astype(np.float32)
    verts = np.concatenate([centers + rng.normal(0, 0.3, (n_tris, 3))
                            for _ in range(3)]).astype(np.float32)
    faces = np.stack([np.arange(n_tris) + k * n_tris for k in range(3)], 1)
    soup = TriangleSoup.from_arrays(verts, faces, capacity=n_tris + 5,
                                    device=dev)
    bvh = build_bvh(soup, leaf_size=4)
    ps = pk.build_packet_set(bvh)
    o = torch.tensor(rng.uniform(-8, 8, (r, 3)).astype(np.float32),
                     device=dev)
    d = torch.tensor(rng.normal(size=(r, 3)).astype(np.float32), device=dev)
    d = d / d.norm(dim=1, keepdim=True)
    t_cap = torch.where(torch.tensor(rng.random(r) < 0.8, device=dev),
                        INF_DIST, 0.0)
    rays, _, _ = pk._sorted_rays_matrix(bvh.lo[0], bvh.hi[0], o, d, t_cap)
    nt = rays.shape[0] // TILE - 1
    tn = cull.block_cull(rays, cull.box_rows_from_blocks(ps.sb_lo, ps.sb_hi),
                         pk._live_tile_bound(rays[:nt * TILE, 6]
                                             .reshape(nt, TILE)))
    pt, psb, n_real = pk.compact_pairs(tn[:, :ps.n_superblocks] < INF_DIST)
    pm = cull.pair_cull(pt, psb, n_real, rays,
                        cull.sb_box_table(ps.block_lo, ps.block_hi))
    coef = si.mxu_planes_from_planes(ps.planes, 0.5 * (bvh.lo[0] + bvh.hi[0]))
    return dict(rays=rays, planes=ps.planes, coef=coef, pt=pt, psb=psb,
                pm=pm)


LAYOUTS = ["dense", "sparse", "one-tile", "odd", "single", "bvh"]


def make_case(layout, dev="cpu"):
    return bvh_case(7, dev) if layout == "bvh" else tie_case(layout, 3, dev)


def passes(case):
    """The (n_real, prior-from-pass) sequence each case runs: round 1 over
    the whole list, a prior-seeded pass over the same list (equal t
    everywhere the prior hit), a prior-seeded pass over n_real = L - 3."""
    n = case["pt"].shape[0]
    return [(n, None), (n, 0), (max(n - 3, 0), 0)]


def plain(form, case, n_real, prior):
    """The plain version of ``form`` ("mt2" computes the "mt" function)."""
    mxu = form == "mxu"
    fn = si.sb_intersect_mxu_plain if mxu else si.sb_intersect_plain
    pl = case["coef"] if mxu else case["planes"]
    n = torch.as_tensor(n_real, dtype=torch.int32,
                        device=case["rays"].device)
    return fn(case["pt"], case["psb"], case["pm"], n, case["rays"], pl,
              prior)


@pytest.mark.parametrize("unit", [si.WALK_UNIT, 3])
@pytest.mark.parametrize("form", ["mt", "mxu", "mt2"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_walk_emulation_equals_plain(layout, form, unit):
    case = make_case(layout)
    pl = case["coef"] if form == "mxu" else case["planes"]
    first = None
    n_ties = 0
    for n_real, prior_of in passes(case):
        prior = None if prior_of is None else first
        ref = plain(form, case, n_real, prior)
        got = si.sb_walk_emulation(form, case["pt"], case["psb"], case["pm"],
                                   torch.tensor(n_real, dtype=torch.int32),
                                   case["rays"], pl, prior, unit=unit)
        assert torch.equal(got[0], ref[0]), "t differs"
        assert torch.equal(got[1], ref[1]), "slot differs"
        if first is None:
            first = ref
            assert bool((ref[1] >= 0).any())
            if layout != "bvh":
                # the tie inputs really tie: the winner's plane values
                # recur at a later live slot of the same ray's run
                n_ties = _count_ties(case, ref)
                assert n_ties > 0
        else:
            # a pass seeded with its own result keeps it: no test beats
            # it, and an equal t never replaces the prior
            assert torch.equal(got[0], first[0])
            assert torch.equal(got[1], first[1])
    # dead rows keep their t_cap, 0 or -0.0, bit for bit
    dead = case["rays"][:, 6] <= 0
    t0 = case["rays"][:, 6][dead]
    assert torch.equal(first[0][dead].view(torch.int32),
                       t0.view(torch.int32))
    assert bool((first[1][dead] == -1).all())


def _count_ties(case, out):
    """Rows whose winning slot's triangle occurs at another slot of a
    live sub-block of the same tile's run (so another (pair, k, lane)
    gave the same t)."""
    planes, pt, psb, pm = case["planes"], case["pt"], case["psb"], case["pm"]
    n = 0
    slot = out[1]
    for row in torch.nonzero(slot >= 0)[:, 0][:64].tolist():
        s = int(slot[row])
        tri = planes[s // SB_LANES, :10, s % SB_LANES]
        tile = row // TILE
        for p in torch.nonzero(pt == tile)[:, 0].tolist():
            sb = int(psb[p])
            same = (planes[sb, :10] == tri[:, None]).all(0)
            live = ((int(pm[p]) >> (torch.arange(SB_LANES) // 128)) & 1) == 1
            hits = torch.nonzero(same & live)[:, 0] + sb * SB_LANES
            if bool((hits != s).any()):
                n += 1
                break
    return n


@pytest.mark.parametrize("unit", [si.WALK_UNIT, 3])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mt2_stages_cover_each_live_subblock_once(layout, unit):
    """The "mt2" walk's stages (``walk_stages``) hold every live sub-block
    of the real pairs once, in list order; a stage is one or two
    consecutive sub-blocks of one unit and one ray tile, chain 0 then
    chain 1, and is lone only where the next sub-block lies in another
    unit or tile (or there is none)."""
    case = make_case(layout)
    pt, pm = case["pt"].tolist(), case["pm"].tolist()
    for n_real, _ in passes(case):
        items, chain, stage = si.walk_stages(case["pt"], case["pm"],
                                             torch.tensor(n_real), unit)
        live = [(p, k) for p in range(n_real) for k in range(8)
                if pm[p] >> k & 1]
        assert [tuple(x) for x in items.tolist()] == live
        tile = [pt[p] for p, _ in live]
        stages = {}
        for i, s in enumerate(stage.tolist()):
            stages.setdefault(s, []).append(i)
        assert sorted(stages) == list(range(len(stages)))
        for s, members in stages.items():
            assert members == list(range(members[0], members[0]
                                         + len(members)))
            assert len(members) in (1, 2)
            assert chain[members].tolist() == list(range(len(members)))
            first, last = members[0], members[-1]
            assert tile[first] == tile[last]
            assert first // unit == last // unit
            if len(members) == 1 and last + 1 < len(live):
                assert ((last + 1) // unit != last // unit
                        or tile[last + 1] != tile[last])
        lone = [len(m) == 1 for m in stages.values()]
        if layout == "single" and n_real == len(pt):
            assert all(lone)            # one live sub-block per tile
        if layout == "odd" and n_real == len(pt):
            assert sum(lone) >= len(set(tile))  # one per tile at least


def test_work_units_cover_the_live_subblocks():
    """Units of C cover every live sub-block of the real pairs once, in
    list order; pairs at or beyond n_real and zero masks hold none."""
    pm = torch.tensor([0b1011, 0, 0xFF, 0b1, 0, 0b110, 0xFF],
                      dtype=torch.int32)
    csum, unit_pair = si.work_units(pm, torch.tensor(6), unit=3)
    assert csum.tolist() == [3, 3, 11, 12, 12, 14, 14]
    assert unit_pair.tolist() == [0, 2, 2, 2, 5]
    csum, unit_pair = si.work_units(pm, torch.tensor(0), unit=3)
    assert csum.tolist() == [0] * 7 and unit_pair.numel() == 0


def test_keys_round_trip():
    """keys_init then keys_decode with no tests returns the prior or
    (t_cap, -1) bit for bit, -0.0, 0, NaN and inf included."""
    rays = torch.zeros((256, 16))
    rays[:6, 6] = torch.tensor([0.0, -0.0, 2.5, float("nan"), float("inf"),
                                -1.0])
    ts = torch.zeros(3, dtype=torch.int32)
    for prior in (None, (rays[:, 6].clone(),
                         torch.arange(256, dtype=torch.int32))):
        keys = si.keys_init(rays, prior)
        assert int(keys[0]) == 0 and int(keys[1]) == 0 and int(keys[3]) == 0
        t, slot = si.keys_decode(keys, rays, prior, ts,
                                 torch.zeros(1, dtype=torch.int32))
        assert torch.equal(t.view(torch.int32),
                           rays[:, 6].contiguous().view(torch.int32))
        assert torch.equal(slot, torch.full((256,), -1, dtype=torch.int32)
                           if prior is None else prior[1])
