"""The port's block-granular packet cull (``cull_impl="pallas"``, the
reference's default) against the JAX package, on the CPU.

* The tables: ``ops/cull.py:derive_pair_tables`` and
  ``accel/packet.py:_tables_with_cap`` / ``_per_ray_tile_overlap`` equal
  the JAX functions bit for bit on the same inputs (the JAX block cull in
  Pallas interpret mode, as its own tests run it).
* Two identities the port's query rests on, bit for bit: the "sb" recull
  computed as ``block_cull(...) < INF_DIST`` over superblock rows is
  ``_per_ray_tile_overlap``; ``pair_cull`` is the JAX package's
  ``_block_masks`` (the "rounds" refresh).
* Every ``cull_impl="pallas"`` variant of tests/test_packet.py:144-160
  (recull "sb", "tn" and "kernel", "single", "rounds" with and without
  ``stale_round_masks``) on the size of that test (700 triangles, 2,048
  rays: one superblock, so every strategy runs "single") and on the
  3,000-triangle hall (4 superblocks, K = 2, so round 2 and later rounds
  run): the triangle equal to JAX's on all but 0.1% of lanes (counted:
  ties or 1-ulp edge decisions, since XLA on the CPU contracts
  multiply-adds into FMAs where torch does not), t within 2 ulps of the
  first-order scale of one rounding in t's numerator and in det, over
  |det| (tests/test_torch_parallel.py's bound), occlusion on all but 0.1%;
  and each variant's t bit for bit equal to the port's own "pallas2" on
  every lane, its occlusion identical.
* ``RenderConfig(intersector="pallas")`` with no cull knob renders in
  both packages (tests/test_torch_render.py's image criterion), and the
  mixes of the two culls through ``anyhit_cull_impl`` and the recull
  modes give the port's default frame.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.accel import packet as jpk  # noqa: E402
from prismarine_core_tpu.models import procedural as jproc  # noqa: E402
from prismarine_core_tpu.models.camera import Camera as JCamera  # noqa: E402
from prismarine_core_tpu.models.materials import MaterialTable  # noqa: E402
from prismarine_core_tpu.models.scene import Scene as JScene  # noqa: E402
from prismarine_core_tpu.models.scene import (  # noqa: E402
    make_cornell_scene as j_cornell)
from prismarine_core_tpu.ops import pallas_cull as jcull  # noqa: E402
from prismarine_core_tpu.ops.sampling import make_sample_arrays  # noqa: E402
from prismarine_core_tpu.render import integrator as jint  # noqa: E402
from prismarine_core_tpu.utils.config import RenderConfig as JConfig  # noqa: E402
from prismarine_core_tpu_torch import interop  # noqa: E402
from prismarine_core_tpu_torch.accel import packet as tpk  # noqa: E402
from prismarine_core_tpu_torch.models.camera import Camera  # noqa: E402
from prismarine_core_tpu_torch.models.scene import make_cornell_scene  # noqa: E402
from prismarine_core_tpu_torch.ops import cull  # noqa: E402
from prismarine_core_tpu_torch.ops.sb_intersect import RC_TCAP, SB, TILE  # noqa: E402
from prismarine_core_tpu_torch.render import integrator as tint  # noqa: E402
from prismarine_core_tpu_torch.utils.config import (  # noqa: E402
    INF_DIST, RenderConfig)
from tests.test_bvh import _random_soup  # noqa: E402
from tests.test_packet import _rand_rays  # noqa: E402
from tests.test_torch_parallel import _t_scale  # noqa: E402
from tests.test_torch_query import _hall_rays  # noqa: E402
from tests.test_torch_render import CORNELL, assert_image_parity  # noqa: E402
from tests.test_torch_scene import jax_scene_arrays  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"
R = 2048


def _soup700():
    soup = _random_soup(700, capacity=709, seed=21)
    return JScene.assemble(soup, MaterialTable.build([{}]))


#: scene, its rays, and the k_round every variant runs with there
SCENES = {
    "soup700": (_soup700, lambda: _rand_rays(R, seed=22), None),
    "hall3000": (lambda: jproc.make_hall_scene(target_tris=3000),
                 lambda: _hall_rays(R, seed=23), 2),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    """(JAX scene, the port's crossed-over scene, o, d (numpy), k_round)."""
    make_scene, make_rays, k_round = SCENES[request.param]
    js = make_scene()
    ts = interop.scene_from_numpy(jax_scene_arrays(js), device=CPU)
    o, d = (np.asarray(x) for x in make_rays())
    return js, ts, o, d, k_round


@pytest.fixture(scope="module")
def hall_rays():
    """The hall's kernel ray matrix (the port's coherence sort), its block
    and superblock boxes, and caps tightened as a round 1 leaves them
    (30% of the lanes dead, the rest capped in 0.5..20)."""
    js = jproc.make_hall_scene(target_tris=3000)
    ts = interop.scene_from_numpy(jax_scene_arrays(js), device=CPU)
    o, d = (torch.tensor(np.asarray(x)) for x in _hall_rays(R, seed=23))
    ps = ts.packets
    rays, _, _ = tpk._sorted_rays_matrix(ts.bvh.lo[0], ts.bvh.hi[0], o, d,
                                         torch.full((R,), INF_DIST))
    nt = rays.shape[0] // TILE - 1
    rng = np.random.default_rng(8)
    tct2 = torch.tensor(np.where(rng.random((nt, TILE)) < 0.3, 0.0,
                                 rng.uniform(0.5, 20, (nt, TILE)))
                        .astype(np.float32))
    return ps, rays, tct2


def _tiles(rays, tct):
    """(ot, inv, tct) of the ray matrix's tiles: the JAX package's view."""
    nt = rays.shape[0] // TILE - 1
    body = rays[:nt * TILE]
    return (body[:, 0:3].reshape(nt, TILE, 3),
            body[:, 8:11].reshape(nt, TILE, 3), tct)


def _with_caps(rays, tct):
    out = rays.clone()
    out[:tct.numel(), RC_TCAP] = tct.reshape(-1)
    return out


def test_block_tables_equal_jax(hall_rays):
    """The block cull at block granularity (plain version vs the JAX
    kernel in interpret mode), ``derive_pair_tables`` on it and
    ``_tables_with_cap`` under the round-1 caps, bit for bit."""
    ps, rays, tct2 = hall_rays
    nsb = ps.n_superblocks
    rows = cull.box_rows_from_blocks(ps.block_lo, ps.block_hi)
    assert rows.shape[1] == 128 and ps.n_blocks == 32
    nt = rays.shape[0] // TILE - 1
    tn = cull.block_cull(rays, rows, torch.tensor(nt, dtype=torch.int32))
    tn_j = np.asarray(jcull.pallas_block_cull(jnp.asarray(rays.numpy()),
                                              jnp.asarray(rows.numpy()),
                                              jnp.int32(nt)))
    np.testing.assert_array_equal(tn.numpy(), tn_j)
    assert 0 < int((tn < INF_DIST).sum()) < tn.numel()

    got = cull.derive_pair_tables(tn, nsb)
    ref = jcull.derive_pair_tables(jnp.asarray(tn_j), nsb, SB)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert 0 < int(got[0].sum()) < got[0].numel()

    cap = tct2.amax(dim=1)
    got = tpk._tables_with_cap(tn, cap, nsb)
    ref = jpk._tables_with_cap(jnp.asarray(tn_j), jnp.asarray(cap.numpy()),
                               nsb)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("boxes", ["superblocks", "blocks"])
def test_per_ray_tile_overlap_equal_jax(hall_rays, boxes):
    """``_per_ray_tile_overlap`` (with its entry distances) bit for bit,
    over the superblock boxes and the block boxes, at the round-1 caps."""
    ps, rays, tct2 = hall_rays
    lo, hi = ((ps.sb_lo, ps.sb_hi) if boxes == "superblocks"
              else (ps.block_lo, ps.block_hi))
    ot, inv, tct = _tiles(rays, tct2)
    got = tpk._per_ray_tile_overlap(ot, inv, tct, lo, hi, return_tn=True)
    ref = jpk._per_ray_tile_overlap(*(jnp.asarray(x.numpy()) for x in
                                      (ot, inv, tct, lo, hi)),
                                    return_tn=True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert 0 < int(got[0].sum()) < got[0].numel()


def test_sb_recull_through_block_cull(hall_rays):
    """Round 2's "sb" recull as the port runs it, ``block_cull`` over the
    superblock rows with the round-1 caps and the live-tile bound, equals
    ``_per_ray_tile_overlap`` bit for bit."""
    ps, rays, tct2 = hall_rays
    nsb = ps.n_superblocks
    tn2 = cull.block_cull(_with_caps(rays, tct2),
                          cull.box_rows_from_blocks(ps.sb_lo, ps.sb_hi),
                          tpk._live_tile_bound(tct2))[:, :nsb]
    want = tpk._per_ray_tile_overlap(*_tiles(rays, tct2), ps.sb_lo,
                                     ps.sb_hi)
    assert torch.equal(tn2 < INF_DIST, want)
    assert 0 < int(want.sum()) < want.numel()


def test_pair_cull_equals_jax_block_masks(hall_rays):
    """``pair_cull`` under tightened caps (the "rounds" refresh) is the JAX
    package's ``_block_masks`` over the same pair list, bit for bit."""
    ps, rays, tct2 = hall_rays
    nsb = ps.n_superblocks
    nt = tct2.shape[0]
    tn = cull.block_cull(rays, cull.box_rows_from_blocks(ps.sb_lo, ps.sb_hi),
                         torch.tensor(nt, dtype=torch.int32))[:, :nsb]
    pt, psb, n_real = tpk.compact_pairs(tn < INF_DIST)
    pm = cull.pair_cull(pt, psb, n_real, _with_caps(rays, tct2),
                        cull.sb_box_table(ps.block_lo, ps.block_hi))
    ref = jpk._block_masks(*(jnp.asarray(x.numpy()) for x in
                             _tiles(rays, tct2)),
                           jnp.asarray(pt.numpy()), jnp.asarray(psb.numpy()),
                           jnp.int32(int(n_real)),
                           jnp.asarray(ps.block_lo.numpy()),
                           jnp.asarray(ps.block_hi.numpy()))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(ref))
    assert int(n_real) > 0 and int((pm > 0).sum()) > 0
    assert int((pm != 0xFF).sum()) > 0       # the caps clear some blocks


#: the "pallas" variants of tests/test_packet.py:144-160
VARIANTS = {
    "sb": dict(),
    "tn": dict(recull="tn"),
    "kernel": dict(recull="kernel"),
    "single": dict(strategy="single"),
    "rounds-k4": dict(strategy="rounds", k_round=4),
    "rounds-k4-stale": dict(strategy="rounds", k_round=4,
                            stale_round_masks=True),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_pallas_variants_match_jax_and_pallas2(scene, name):
    js, ts, o, d, k_round = scene
    kw = dict(VARIANTS[name], cull_impl="pallas")
    if k_round is not None:
        kw["k_round"] = k_round
    rng = np.random.default_rng(5)
    alive = rng.random(R) < 0.8
    t_cap = np.where(alive, 1e4, 0.0).astype(np.float32)
    t_max = np.where(rng.random(R) < 0.8, rng.uniform(0.5, 20, R),
                     0.0).astype(np.float32)
    jargs = (js.bvh, js.packets, js.triangles, jnp.asarray(o), jnp.asarray(d))
    targs = (ts.bvh, ts.packets, ts.triangles, torch.tensor(o),
             torch.tensor(d))

    hj = jpk.intersect_closest_pallas(*jargs, t_cap=jnp.asarray(t_cap), **kw)
    ht = tpk.intersect_closest_pallas(*targs, t_cap=torch.tensor(t_cap), **kw)
    tri_j, tri_t = np.asarray(hj.tri), ht.tri.numpy()
    t_j, t_t = np.asarray(hj.t), ht.t.numpy()
    assert (tri_t[~alive] == -1).all()
    assert (tri_j >= 0).sum() > R // 20
    same = tri_j == tri_t
    print(f"{name}: {int((~same).sum())} of {R} lanes on another triangle")
    assert int((~same).sum()) <= R // 1000 + 1
    both = (tri_j >= 0) & (tri_t >= 0)
    if both.any():
        scale = np.maximum(np.abs(t_j[both]), _t_scale(
            js, tri_j[both], o[both], d[both], t_j[both]))
        err = np.abs(t_t[both].astype(np.float64) - t_j[both]) / np.spacing(
            scale.astype(np.float32))
        print(f"{name}: t max error {err.max():.3f} ulp of the scale")
        assert err.max() <= 2.0

    occ_j = np.asarray(jpk.occluded_pallas(*jargs, jnp.asarray(t_max), **kw))
    occ_t = tpk.occluded_pallas(*targs, torch.tensor(t_max), **kw).numpy()
    assert not occ_t[t_max == 0].any()
    assert int((occ_j != occ_t).sum()) <= R // 1000 + 1

    # the port's own two-level cull: t bit for bit, the same occlusion
    kw2 = dict(kw, cull_impl="pallas2")
    kw2.pop("recull", None)
    h2 = tpk.intersect_closest_pallas(*targs, t_cap=torch.tensor(t_cap), **kw2)
    assert torch.equal(ht.t, h2.t)
    ties = int((ht.tri != h2.tri).sum())
    print(f"{name}: {ties} tie lanes against pallas2")
    assert ties <= R // 1000 + 1
    assert np.array_equal(occ_t, tpk.occluded_pallas(
        *targs, torch.tensor(t_max), **kw2).numpy())


def _cornell_frame(cfg_kw, jax_too=False):
    cam_s, bounce_s = make_sample_arrays(jax.random.key(3),
                                         JConfig(**cfg_kw).n_rays,
                                         cfg_kw["max_bounces"])
    cam = Camera.look_at(eye=CORNELL["eye"], target=CORNELL["target"],
                         fov_y_deg=CORNELL["fov"], device=CPU)
    img = tint.render_with_samples(
        make_cornell_scene(device=CPU), cam, RenderConfig(**cfg_kw),
        torch.tensor(np.asarray(cam_s)), torch.tensor(np.asarray(bounce_s)))
    if not jax_too:
        return img.numpy()
    jimg = jint.render_with_samples(
        j_cornell(), JCamera.look_at(eye=CORNELL["eye"],
                                     target=CORNELL["target"],
                                     fov_y_deg=CORNELL["fov"]),
        JConfig(**cfg_kw), cam_s, bounce_s)
    return img.numpy(), np.asarray(jimg)


FRAME = dict(width=24, height=24, spp=1, max_bounces=3, intersector="pallas")


def test_default_pallas_frame_matches_jax():
    """``RenderConfig(intersector="pallas")`` with its defaults (the
    block-granular cull, "two_round" K 8, any-hit "rounds") in both
    packages."""
    assert RenderConfig().cull_impl == JConfig().cull_impl == "pallas"
    img, ref = _cornell_frame(FRAME, jax_too=True)
    assert img.mean() > 1e-2
    assert_image_parity(img, ref)


@pytest.mark.parametrize("knobs", [
    dict(anyhit_cull_impl="pallas2"),
    dict(cull_impl="pallas2", anyhit_cull_impl="pallas"),
    dict(recull="kernel"),
    dict(recull="tn", stale_round_masks=True),
], ids=["anyhit-pallas2", "closest-pallas2", "kernel", "tn-stale"])
def test_cull_mixes_give_the_default_frame(knobs):
    """The two culls mixed through ``anyhit_cull_impl``, and the recull
    modes, render the default frame: every query's t is the same bit for
    bit, so the image is too but on tie lanes."""
    ref = _cornell_frame(FRAME)
    img = _cornell_frame(dict(FRAME, **knobs))
    assert_image_parity(img, ref)
    same = np.all(img == ref, axis=-1).mean()
    print(f"{knobs}: {same:.4f} of pixels bit-identical")
    assert same >= 0.99
