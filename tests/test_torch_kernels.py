"""The three packet-query kernels: the port's plain versions against the
JAX Pallas kernels (interpret mode on the CPU) on identical inputs.  (The
CUDA kernels are held against the plain versions on the card by
tests/test_torch_gpu.py.)

Inputs mirror tests/test_packet.py (``test_pallas_matches_brute``,
``test_pallas_dead_lanes_culled``, ``test_pairs_per_step_bit_identical``):
the JAX tests' random soups and rays, the JAX package's own ray matrix,
box tables and pair lists.  Criteria:
  * block cull and pair cull: exactly equal;
  * pair intersector: the port's t equals a numpy float32 evaluation of
    the kernel's formula for the winning slot bit for bit.  Against JAX,
    where both pick the same slot, t is within 1 ulp per contractible
    stage (two: a cross product, then a dot product) at the scale of the
    numerator's terms over |det| — XLA on the CPU contracts multiply-adds
    into FMAs where torch rounds each product, and 1/det scales that
    rounding.  A different slot on at most 0.1% of lanes (counted and
    printed: a tie or a 1-ulp edge decision); where both still hit, t
    within rtol 1e-3 (equally-near surfaces, tests/test_packet.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.accel import packet as jpk  # noqa: E402
from prismarine_core_tpu.accel.lbvh import build_bvh as j_build_bvh  # noqa: E402
from prismarine_core_tpu.ops import pallas_cull as jcull  # noqa: E402
from prismarine_core_tpu_torch.ops import cull, sb_intersect  # noqa: E402
from tests.test_bvh import _random_soup  # noqa: E402
from tests.test_packet import _rand_rays  # noqa: E402

torch.set_num_threads(1)
INF_DIST = 10000.0
TILE = 128


def _setup(n_tris, r, seed, live_frac=1.0, t_far=1e4):
    """JAX-built query inputs as numpy: ray matrix (coherence-sorted,
    dead-padded, sentinel tile), packet set, superblock cull rows."""
    soup = _random_soup(n_tris, capacity=n_tris + 5, seed=seed)
    bvh = j_build_bvh(soup, leaf_size=4)
    ps = jpk.build_packet_set(bvh)
    o, d = _rand_rays(r, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    alive = rng.random(r) < live_frac
    t_cap = jnp.asarray(np.where(alive, t_far, 0.0).astype(np.float32))
    rays, _, _ = jpk._sorted_rays_matrix(bvh.lo[0], bvh.hi[0], o, d, t_cap)
    return dict(rays=np.asarray(rays), planes=np.asarray(ps.planes),
                sb_rows=np.asarray(jcull.box_rows_from_blocks(ps.sb_lo,
                                                              ps.sb_hi)),
                blk_rows=np.asarray(jcull.box_rows_from_blocks(
                    ps.block_lo, ps.block_hi)),
                sbbox=np.asarray(jcull.sb_box_table(ps.block_lo,
                                                    ps.block_hi)),
                nsb=ps.n_superblocks, nt=rays.shape[0] // TILE - 1)


def _live_bound(rays, nt):
    tc = rays[:nt * TILE, 6].reshape(nt, TILE)
    live = (tc > 0).any(1)
    return int(np.max(np.where(live, np.arange(1, nt + 1), 0)))


def _aligned_pairs(mask, nsb, align):
    """Tile-major pair list of a [nt, nsb] mask, each tile's run padded
    to a multiple of ``align`` with sentinel superblocks (the layout the
    JAX kernels need for more than one pair per step)."""
    pt, psb = [], []
    for t in range(mask.shape[0]):
        sbs = list(np.nonzero(mask[t])[0])
        sbs += [nsb] * ((-len(sbs)) % align)
        pt += [t] * len(sbs)
        psb += sbs
    return np.asarray(pt, np.int32), np.asarray(psb, np.int32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _n(x):
    return torch.tensor(x, dtype=torch.int32)


CASES = [dict(n_tris=300, r=512, seed=11), dict(n_tris=1000, r=200, seed=11),
         dict(n_tris=500, r=1024, seed=31, live_frac=0.4),
         dict(n_tris=900, r=1024, seed=41, t_far=25.0)]
IDS = ["300x512", "1000x200", "dead-lanes", "short-caps"]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    return _setup(**request.param)


def test_block_cull_plain_matches_pallas(case):
    rays, nt = case["rays"], case["nt"]
    for rows in (case["sb_rows"], case["blk_rows"]):
        for n_live in (_live_bound(rays, nt), max(nt - 1, 0)):
            ref = np.asarray(jcull.pallas_block_cull(
                jnp.asarray(rays), jnp.asarray(rows), jnp.int32(n_live)))
            got = cull.block_cull(_t(rays), _t(rows), _n(n_live)).numpy()
            np.testing.assert_array_equal(got, ref)
            assert (got < INF_DIST).any()


@pytest.mark.parametrize("cpps", [8, 16])
def test_pair_cull_plain_matches_pallas(case, cpps):
    rays, nt, nsb = case["rays"], case["nt"], case["nsb"]
    tn = np.asarray(jcull.pallas_block_cull(
        jnp.asarray(rays), jnp.asarray(case["sb_rows"]),
        jnp.int32(nt)))[:, :nsb]
    pt, psb = _aligned_pairs(tn < INF_DIST, nsb, cpps)
    for n_real in (len(pt), max(len(pt) - 5, 0)):
        ref = np.asarray(jcull.pallas_pair_cull(
            jnp.asarray(pt), jnp.asarray(psb), jnp.int32(n_real),
            jnp.asarray(rays), jnp.asarray(case["sbbox"]), cpps=cpps))
        got = cull.pair_cull(_t(pt), _t(psb), _n(n_real), _t(rays),
                             _t(case["sbbox"])).numpy()
        np.testing.assert_array_equal(got, ref)
        assert (got != 0).any()


def _pairs_with_masks(case, align):
    rays, nt, nsb = case["rays"], case["nt"], case["nsb"]
    tn = np.asarray(jcull.pallas_block_cull(
        jnp.asarray(rays), jnp.asarray(case["sb_rows"]),
        jnp.int32(nt)))[:, :nsb]
    pt, psb = _aligned_pairs(tn < INF_DIST, nsb, max(align, 8))
    pm = np.asarray(jcull.pallas_pair_cull(
        jnp.asarray(pt), jnp.asarray(psb), jnp.int32(len(pt)),
        jnp.asarray(rays), jnp.asarray(case["sbbox"]),
        cpps=max(align, 8)))
    return pt, psb, pm


def _winner_t(rays, planes, slot):
    """(t, numerator scale / |det|) of each row's winning slot, t in
    unfused float32 with the kernel's operation order."""
    sb, lane = slot // 1024, slot % 1024
    tri = planes[sb, :, lane]                          # [n, 16]
    v0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    o, d = rays[:, 0:3], rays[:, 3:6]
    px = d[:, 1] * e2[:, 2] - d[:, 2] * e2[:, 1]
    py = d[:, 2] * e2[:, 0] - d[:, 0] * e2[:, 2]
    pz = d[:, 0] * e2[:, 1] - d[:, 1] * e2[:, 0]
    det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
    inv = np.float32(1.0) / np.where(np.abs(det) < np.float32(1e-10),
                                     np.float32(1e-10), det)
    s = o - v0
    qx = s[:, 1] * e1[:, 2] - s[:, 2] * e1[:, 1]
    qy = s[:, 2] * e1[:, 0] - s[:, 0] * e1[:, 2]
    qz = s[:, 0] * e1[:, 1] - s[:, 1] * e1[:, 0]
    t = (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * inv
    norm = np.linalg.norm
    scale = (norm(e2, axis=1) * norm(s, axis=1) * norm(e1, axis=1)
             / np.maximum(np.abs(det), 1e-30))
    return t, scale


def _compare_hits(t_got, s_got, t_ref, s_ref, rays, planes):
    same = s_got == s_ref
    n_diff = int((~same).sum())
    print(f"sb_intersect: {n_diff} of {len(s_ref)} lanes pick another "
          "slot")
    assert n_diff <= len(s_ref) // 1000 + 1
    miss = same & (s_got < 0)
    np.testing.assert_array_equal(t_got[miss], t_ref[miss])
    hit = same & (s_got >= 0)
    t_np, scale = _winner_t(rays[hit], planes, s_got[hit])
    np.testing.assert_array_equal(t_got[hit], t_np)
    mag = np.maximum(np.abs(t_ref[hit]), scale).astype(np.float32)
    err = (np.abs(t_got[hit].astype(np.float64) - t_ref[hit])
           / np.spacing(mag))
    assert err.max() <= 2.0, f"max error {err.max():.2f} ulp"
    both = ~same & (s_got >= 0) & (s_ref >= 0)
    np.testing.assert_allclose(t_got[both], t_ref[both], rtol=1e-3)


@pytest.mark.parametrize("pps", [1, 4])
def test_sb_intersect_plain_matches_pallas(case, pps):
    rays, nt, nsb = case["rays"], case["nt"], case["nsb"]
    pt, psb, pm = _pairs_with_masks(case, pps)
    n_real = len(pt)
    out1 = jpk._run_kernel(jnp.asarray(pt), jnp.asarray(psb),
                           jnp.asarray(pm), jnp.int32(n_real),
                           jnp.asarray(rays), jnp.asarray(case["planes"]),
                           nt, nsb, 1024, pairs_per_step=pps)
    t_ref = np.asarray(out1[:, 0])
    s_ref = np.asarray(jax.lax.bitcast_convert_type(out1[:, 1], jnp.int32))
    t_got, s_got = sb_intersect.sb_intersect(
        _t(pt), _t(psb), _t(pm), _n(n_real), _t(rays), _t(case["planes"]))
    t_got, s_got = t_got.numpy(), s_got.numpy()
    assert (s_ref >= 0).any()
    _compare_hits(t_got, s_got, t_ref, s_ref, rays, case["planes"])

    # a second round seeded from the first (prior), over half the pairs
    half = len(pt) // 2
    out2 = jpk._run_kernel(jnp.asarray(pt), jnp.asarray(psb),
                           jnp.asarray(pm), jnp.int32(half),
                           jnp.asarray(rays), jnp.asarray(case["planes"]),
                           nt, nsb, 1024, prior=out1, pairs_per_step=pps)
    t2_got, s2_got = sb_intersect.sb_intersect(
        _t(pt), _t(psb), _t(pm), _n(half), _t(rays), _t(case["planes"]),
        prior=(torch.tensor(t_got), torch.tensor(s_got)))
    _compare_hits(t2_got.numpy(), s2_got.numpy(), np.asarray(out2[:, 0]),
                  np.asarray(jax.lax.bitcast_convert_type(out2[:, 1],
                                                          jnp.int32)),
                  rays, case["planes"])
