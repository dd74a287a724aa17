"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (and nvcc to build the kernels) and
skips without one.  The module imports no jax, so it runs on a machine
without the JAX package; skip the JAX test harness there:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

The kernels are built with -fmad=false and use their plain versions'
operation order, so every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from prismarine_core_tpu_torch.accel import packet as pk  # noqa: E402
from prismarine_core_tpu_torch.accel.lbvh import build_bvh  # noqa: E402
from prismarine_core_tpu_torch.models.geometry import TriangleSoup  # noqa: E402
from prismarine_core_tpu_torch.ops import cull, dispatch  # noqa: E402
from prismarine_core_tpu_torch.ops import sb_intersect as si  # noqa: E402
from prismarine_core_tpu_torch.utils.config import INF_DIST  # noqa: E402
from prismarine_core_tpu_torch.utils.profiling import counts  # noqa: E402

TILE = 128


@pytest.fixture
def cuda_device():
    """The first CUDA card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _scene(n_tris, seed, dev):
    """Random small triangles (as tests/test_bvh.py builds them), their
    BVH and packet set on ``dev``."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, (n_tris, 3)).astype(np.float32)
    verts = np.concatenate([centers + rng.normal(0, 0.3, (n_tris, 3))
                            for _ in range(3)]).astype(np.float32)
    faces = np.stack([np.arange(n_tris) + k * n_tris for k in range(3)], 1)
    soup = TriangleSoup.from_arrays(verts, faces, capacity=n_tris + 5,
                                    device=dev)
    bvh = build_bvh(soup, leaf_size=4)
    return soup, bvh, pk.build_packet_set(bvh)


def _rays(r, seed, dev, live_frac=1.0, t_far=INF_DIST):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_cap = np.where(rng.random(r) < live_frac, t_far, 0.0)
    return (torch.tensor(o, device=dev), torch.tensor(d, device=dev),
            torch.tensor(t_cap.astype(np.float32), device=dev))


CASES = [dict(n_tris=300, r=512, seed=11), dict(n_tris=3000, r=2048, seed=21),
         dict(n_tris=500, r=1024, seed=31, live_frac=0.4),
         dict(n_tris=900, r=1024, seed=41, t_far=25.0)]
IDS = ["300x512", "3000x2048", "dead-lanes", "short-caps"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernels_equal_plain(cuda_device, case):
    """Each kernel equals its plain version exactly, on the inputs the
    query gives it (round 1 and a prior-seeded second pass)."""
    dev = cuda_device
    _, bvh, ps = _scene(case["n_tris"], case["seed"], dev)
    o, d, t_cap = _rays(case["r"], case["seed"] + 1, dev,
                        case.get("live_frac", 1.0),
                        case.get("t_far", INF_DIST))
    rays, _, _ = pk._sorted_rays_matrix(bvh.lo[0], bvh.hi[0], o, d, t_cap)
    nt = rays.shape[0] // TILE - 1
    n_live = pk._live_tile_bound(rays[:nt * TILE, 6].reshape(nt, TILE))
    sb_rows = cull.box_rows_from_blocks(ps.sb_lo, ps.sb_hi)
    sbbox = cull.sb_box_table(ps.block_lo, ps.block_hi)

    tn = cull.block_cull(rays, sb_rows, n_live)
    assert torch.equal(tn, cull.block_cull_plain(rays, sb_rows, n_live))
    pt, psb, n_real = pk.compact_pairs(tn[:, :ps.n_superblocks] < INF_DIST)
    assert int(n_real) > 0
    pm = cull.pair_cull(pt, psb, n_real, rays, sbbox)
    assert torch.equal(pm, cull.pair_cull_plain(pt, psb, n_real, rays,
                                                sbbox))
    assert bool((pm != 0).any())

    out = si.sb_intersect(pt, psb, pm, n_real, rays, ps.planes)
    ref = si.sb_intersect_plain(pt, psb, pm, n_real, rays, ps.planes)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert bool((out[1] >= 0).any())
    half = (n_real // 2).to(torch.int32)
    out2 = si.sb_intersect(pt, psb, pm, half, rays, ps.planes, prior=out)
    ref2 = si.sb_intersect_plain(pt, psb, pm, half, rays, ps.planes,
                                 prior=out)
    assert all(torch.equal(a, b) for a, b in zip(out2, ref2))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_forms_equal_plain(cuda_device, case):
    """"mt2" equals "mt" and the plain version exactly; "mxu" equals its
    plain version exactly on the coefficient planes (round 1 and a
    prior-seeded second pass)."""
    dev = cuda_device
    _, bvh, ps = _scene(case["n_tris"], case["seed"], dev)
    o, d, t_cap = _rays(case["r"], case["seed"] + 1, dev,
                        case.get("live_frac", 1.0),
                        case.get("t_far", INF_DIST))
    rays, _, _ = pk._sorted_rays_matrix(bvh.lo[0], bvh.hi[0], o, d, t_cap)
    nt = rays.shape[0] // TILE - 1
    n_live = pk._live_tile_bound(rays[:nt * TILE, 6].reshape(nt, TILE))
    tn = cull.block_cull(rays, cull.box_rows_from_blocks(ps.sb_lo, ps.sb_hi),
                         n_live)
    pt, psb, n_real = pk.compact_pairs(tn[:, :ps.n_superblocks] < INF_DIST)
    pm = cull.pair_cull(pt, psb, n_real, rays,
                        cull.sb_box_table(ps.block_lo, ps.block_hi))
    coef = si.mxu_planes_from_planes(ps.planes, 0.5 * (bvh.lo[0] + bvh.hi[0]))
    prior = None                      # the second pass starts from the first
    for n in (n_real, (n_real // 2).to(torch.int32)):
        mt = si.sb_intersect(pt, psb, pm, n, rays, ps.planes, prior=prior)
        mt2 = si.sb_intersect_mt2(pt, psb, pm, n, rays, ps.planes, prior=prior)
        ref = si.sb_intersect_plain(pt, psb, pm, n, rays, ps.planes,
                                    prior=prior)
        assert all(torch.equal(a, b) for a, b in zip(mt2, mt))
        assert all(torch.equal(a, b) for a, b in zip(mt2, ref))
        mxu = si.sb_intersect_mxu(pt, psb, pm, n, rays, coef, prior=prior)
        ref = si.sb_intersect_mxu_plain(pt, psb, pm, n, rays, coef,
                                        prior=prior)
        assert all(torch.equal(a, b) for a, b in zip(mxu, ref))
        assert bool((mxu[1] >= 0).any())
        prior = mt
    grad = rays.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        si.sb_intersect_mxu(pt, psb, pm, n_real, grad, coef)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["mt", "mxu", "mt2"])
@pytest.mark.parametrize("layout", ["dense", "sparse", "one-tile", "odd",
                                    "single", "bvh"])
def test_walk_ties_and_imbalance_equal_plain(cuda_device, layout, form):
    """The tie and imbalance cases of tests/test_torch_walk.py through the
    kernels: equal to the plain versions exactly in every pass (round 1,
    a prior-seeded pass over the same list, one over n_real = L - 3); on
    "odd" and "single" the "mt2" walk runs lone stages at tile ends."""
    from test_torch_walk import make_case, passes, plain
    case = make_case(layout, cuda_device)
    kernel = {"mt": si.sb_intersect, "mt2": si.sb_intersect_mt2,
              "mxu": si.sb_intersect_mxu}[form]
    pl = case["coef"] if form == "mxu" else case["planes"]
    first = None
    for n_real, prior_of in passes(case):
        prior = None if prior_of is None else first
        n = torch.tensor(n_real, dtype=torch.int32, device=cuda_device)
        got = kernel(case["pt"], case["psb"], case["pm"], n, case["rays"],
                     pl, prior)
        ref = plain(form, case, n_real, prior)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        first = got if first is None else first
    assert bool((first[1] >= 0).any())


@pytest.mark.gpu
def test_backward_on_the_card(cuda_device, request):
    """One backward through a "mxu" frame on the card: finite, non-zero
    gradients, the mxu kernel launched, and within 1e-3 of the largest
    entry of the same gradients with the plain versions in the kernels'
    place (the same hits; the card's scatter-adds sum in no fixed
    order)."""
    from prismarine_core_tpu_torch.models.camera import Camera
    from prismarine_core_tpu_torch.models.scene import make_cornell_scene
    from prismarine_core_tpu_torch.parallel.mesh import (
        apply_params, init_params)
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=2,
                       intersector="pallas", cull_impl="pallas2",
                       anyhit_strategy="single", kernel_form="mxu")
    rng = np.random.default_rng(5)
    cam_s = rng.random((cfg.n_rays, 4), dtype=np.float32)
    bounce_s = rng.random((2, cfg.n_rays, 11), dtype=np.float32)

    dev = cuda_device
    scene = make_cornell_scene(device=dev)
    cam = Camera.look_at((0.0, 0.0, 3.4), (0.0, 0.0, 0.0), fov_y_deg=50.0,
                         device=dev)

    def grads():
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in init_params(scene).items()}
        img = render_with_samples(apply_params(scene, leaves), cam, cfg,
                                  torch.tensor(cam_s, device=dev),
                                  torch.tensor(bounce_s, device=dev))
        g = torch.autograd.grad(img.square().mean(), list(leaves.values()))
        return dict(zip(leaves, g))

    launches = counts["pc.kernel.sb_intersect_mxu"]
    g_kernels = grads()
    assert counts["pc.kernel.sb_intersect_mxu"] > launches
    request.getfixturevalue("plain_versions")
    g_plain = grads()
    for k, a in g_kernels.items():
        b = g_plain[k]
        assert bool(torch.isfinite(a).all()) and bool((a != 0).any()), k
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-3, (k, err)


@pytest.mark.gpu
def test_entry_points_default_to_the_card(cuda_device):
    """Every constructor given no device builds on the card."""
    from prismarine_core_tpu_torch import interop
    from prismarine_core_tpu_torch.models import procedural
    from prismarine_core_tpu_torch.models.camera import Camera
    from prismarine_core_tpu_torch.models.lights import SphereLights
    from prismarine_core_tpu_torch.models.materials import MaterialTable
    from prismarine_core_tpu_torch.models.scene import make_cornell_scene
    from prismarine_core_tpu_torch.models.textures import (
        Environment, TextureStack)
    cornell = make_cornell_scene()
    built = {
        "make_cornell_scene": cornell.triangles.v0,
        "make_hall_scene": procedural.make_hall_scene(2000).packets.planes,
        "make_sky_environment": procedural.make_sky_environment(16).image,
        "Camera.look_at": Camera.look_at((0, 0, 1), (0, 0, 0)).eye,
        "TriangleSoup.from_arrays": TriangleSoup.from_arrays(
            np.eye(3, dtype=np.float32), np.array([[0, 1, 2]])).v0,
        "MaterialTable.build": MaterialTable.build([{}]).diffuse,
        "SphereLights.suns": SphereLights.suns().color,
        "SphereLights.single": SphereLights.single((0, 0, 0), 1.0,
                                                   (1, 1, 1)).color,
        "TextureStack.empty": TextureStack.empty(4).data,
        "Environment.constant": Environment.constant().image,
        "Environment.from_image": Environment.from_image(
            np.ones((2, 4, 3), np.float32)).image,
        "interop.scene_from_numpy": interop.scene_from_numpy(
            interop.scene_to_numpy(cornell)).triangles.v0,
        "interop.params_from_numpy": interop.params_from_numpy(
            {"light_color": np.ones((1, 3), np.float32)})["light_color"],
    }
    for name, t in built.items():
        assert t.device.type == "cuda", name


@pytest.fixture
def plain_versions(monkeypatch):
    """Run every kernel wrapper on its plain version: the seam's choice
    (``ops/dispatch.py``) replaced."""
    monkeypatch.setattr(dispatch, "choose", lambda x, launch, plain: plain)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["two_round", "single"])
def test_query_equal_plain(cuda_device, strategy, request):
    """Both queries give the same hits on the kernels as on the plain
    versions ("two_round" with K=2 so that round 2 runs)."""
    dev = cuda_device
    soup, bvh, ps = _scene(3000, 21, dev)
    assert ps.n_superblocks > 2
    o, d, t_cap = _rays(4096, 22, dev, live_frac=0.8)
    kw = dict(strategy=strategy, k_round=2)

    def run():
        hit = pk.intersect_closest_pallas(bvh, ps, soup, o, d, t_cap=t_cap,
                                          **kw)
        occ = pk.occluded_pallas(bvh, ps, soup, o, d, 0.5 * t_cap, **kw)
        return hit, occ

    launches = counts["pc.kernel.sb_intersect"]
    hit, occ = run()
    assert counts["pc.kernel.sb_intersect"] > launches
    request.getfixturevalue("plain_versions")
    hit_p, occ_p = run()
    assert torch.equal(hit.tri, hit_p.tri) and torch.equal(hit.t, hit_p.t)
    assert torch.equal(occ, occ_p)
    assert bool((hit.tri >= 0).any()) and bool(occ.any())


@pytest.mark.gpu
def test_wrappers_reject_mixed_devices(cuda_device):
    """A kernel wrapper raises on an argument that is not on the card
    (no silent fallback to the plain version)."""
    dev = cuda_device
    _, bvh, ps = _scene(300, 11, dev)
    o, d, t_cap = _rays(256, 12, dev)
    rays, _, _ = pk._sorted_rays_matrix(bvh.lo[0], bvh.hi[0], o, d, t_cap)
    sb_rows = cull.box_rows_from_blocks(ps.sb_lo, ps.sb_hi)
    n_live = torch.tensor(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        cull.block_cull(rays, sb_rows.cpu(), n_live)
    with pytest.raises(TypeError):
        cull.block_cull(rays, sb_rows, n_live.long())


def _cull_case(name, dev):
    from test_torch_cull_reject import make_case
    return make_case(name, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["camera", "bounce", "shadow", "octants",
                                  "tiny-d", "dead", "caps"])
def test_cull_kernels_equal_plain_on_edge_cases(cuda_device, name):
    """The edge cases of tests/test_torch_cull_reject.py through both cull
    kernels: equal to the plain versions exactly (every box set, n_live and
    n_live - 2, n_real = L and L - 5); on the coherent cases the plain
    emulation of the reject settles some entries, so the kernels' reject
    path ran."""
    from test_torch_cull_reject import n_live_of, pair_lists
    case = _cull_case(name, cuda_device)
    rays = case["rays"]
    n_live = n_live_of(rays)
    for rows in case["rows"].values():
        for n in (n_live, torch.clamp(n_live - 2, min=0)):
            got = cull.block_cull(rays, rows, n)
            assert torch.equal(got, cull.block_cull_plain(rays, rows, n))
        if case["coherent"]:
            assert bool(cull.block_cull_rejects(rays, rows, n_live)[
                :int(n_live)].any())
    for tname, table in case["tables"].items():
        pt, psb = pair_lists(case, tname)
        for n_real in (pt.shape[0], pt.shape[0] - 5):
            n = torch.tensor(n_real, dtype=torch.int32, device=cuda_device)
            got = cull.pair_cull(pt, psb, n, rays, table)
            assert torch.equal(got, cull.pair_cull_plain(pt, psb, n, rays,
                                                         table))
        if case["coherent"]:
            surv = cull.pair_cull_survivors(pt, psb, n, rays, table)
            assert float(surv.float().mean()) < 1.0


@pytest.mark.gpu
def test_block_cull_one_ray_tiles_equal_plain(cuda_device):
    """Tiles of one repeated ray, where the reject is exactly the slab
    test, through the block-cull kernel: equal to the plain version."""
    from test_torch_cull_reject import one_ray_tiles
    rays, rows = one_ray_tiles(1, cuda_device)
    n = torch.tensor(rays.shape[0] // TILE - 1, dtype=torch.int32,
                     device=cuda_device)
    assert torch.equal(cull.block_cull(rays, rows, n),
                       cull.block_cull_plain(rays, rows, n))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["camera", "bounce", "shadow"])
def test_cull_kernels_equal_plain_on_round_two(cuda_device, name):
    """Round-2 inputs: the caps tightened by a round-1 result (K = 2
    nearest superblocks per tile, through the kernels), then both cull
    kernels on the tightened rays, equal to the plain versions."""
    from test_torch_cull_reject import n_live_of
    dev = cuda_device
    case = _cull_case(name, dev)
    rays = case["rays"]
    nt = rays.shape[0] // TILE - 1
    sb_rows, sbbox = case["rows"]["sb"], case["tables"]["sb"]
    nsb = sbbox.shape[0] - 1
    tn = cull.block_cull(rays, sb_rows, n_live_of(rays))[:, :nsb]
    tn_sorted, sb_sorted = torch.sort(tn, dim=1, stable=True)
    ok = tn_sorted[:, :2] < INF_DIST
    pt, psb, n_real = pk.compact_pairs(ok, sb_sorted[:, :2])
    pm = cull.pair_cull(pt, psb, n_real, rays, sbbox)
    from test_torch_cull_reject import _hall
    planes = _hall(dev)[0].packets.planes
    best1 = si.sb_intersect(pt, psb, pm, n_real, rays, planes)[0]
    rays2 = rays.clone()
    rays2[:nt * TILE, 6] = torch.minimum(rays[:nt * TILE, 6],
                                         best1[:nt * TILE])
    assert bool((rays2[:, 6] < rays[:, 6]).any())
    n_live2 = n_live_of(rays2)
    tn2 = cull.block_cull(rays2, sb_rows, n_live2)
    assert torch.equal(tn2, cull.block_cull_plain(rays2, sb_rows, n_live2))
    pt2, psb2, n_real2 = pk.compact_pairs(tn2[:, :nsb] < INF_DIST)
    pm2 = cull.pair_cull(pt2, psb2, n_real2, rays2, sbbox)
    assert torch.equal(pm2, cull.pair_cull_plain(pt2, psb2, n_real2, rays2,
                                                 sbbox))


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["two_round", "single", "rounds",
                                      "rounds-stale"])
@pytest.mark.parametrize("name", ["camera", "bounce", "shadow"])
def test_hall_query_equal_plain(cuda_device, name, strategy, request):
    """The packet query on the small hall's camera, bounce and shadow rays
    ("two_round" with K = 2, so that the prior-seeded round 2 runs,
    "rounds" with K = 2, so that many prior-seeded rounds run on
    cap-tightened (or, stale, round-0) pair culls, and "single"; closest
    and any-hit): the same hits on the kernels as on the plain
    versions."""
    from test_torch_cull_reject import _hall
    dev = cuda_device
    scene, o, d, hit = _hall(dev)
    if name != "camera":
        p = o + hit.t[:, None] * d - 1e-3 * d
        if name == "bounce":
            g = torch.Generator(device="cpu").manual_seed(3)
            n = torch.randn((o.shape[0], 3), generator=g).to(dev)
            d = n / n.norm(dim=1, keepdim=True)
        else:
            to = torch.tensor([0.0, 5.5, 0.3], device=dev) - p
            d = to / to.norm(dim=1, keepdim=True)
        o = p
    t_cap = torch.where(hit.tri >= 0, INF_DIST, 0.0)
    bvh, ps, soup = scene.bvh, scene.packets, scene.triangles
    kw = dict(strategy=strategy.split("-")[0], k_round=2,
              stale_round_masks=strategy.endswith("-stale"),
              cull_impl="pallas2")

    def run():
        h = pk.intersect_closest_pallas(bvh, ps, soup, o, d, t_cap=t_cap,
                                        **kw)
        return h, pk.occluded_pallas(bvh, ps, soup, o, d, 0.5 * t_cap, **kw)

    launches = (counts["pc.kernel.block_cull"], counts["pc.kernel.pair_cull"])
    h, occ = run()
    assert counts["pc.kernel.block_cull"] > launches[0]
    assert counts["pc.kernel.pair_cull"] > launches[1]
    request.getfixturevalue("plain_versions")
    h_p, occ_p = run()
    assert torch.equal(h.tri, h_p.tri) and torch.equal(h.t, h_p.t)
    assert torch.equal(occ, occ_p)
    assert bool((h.tri >= 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("knobs", [
    dict(), dict(recull="kernel"), dict(recull="tn"),
    dict(strategy="single"), dict(strategy="rounds"),
    dict(strategy="rounds", stale_round_masks=True)],
    ids=["sb", "kernel", "tn", "single", "rounds", "rounds-stale"])
def test_default_cull_query_equal_plain(cuda_device, knobs, request):
    """The default cull ("pallas": block_cull over the block rows, the
    masks from its table) on the small hall's bounce rays, K = 2: the same
    hits on the kernels as on the plain versions, t bit for bit equal to
    "pallas2"'s, the same occlusion; pair_cull only in the refreshed
    rounds of "rounds"."""
    from test_torch_cull_reject import _hall
    dev = cuda_device
    scene, o, d, hit = _hall(dev)
    g = torch.Generator(device="cpu").manual_seed(3)
    n = torch.randn((o.shape[0], 3), generator=g).to(dev)
    o, d = o + hit.t[:, None] * d - 1e-3 * d, n / n.norm(dim=1, keepdim=True)
    t_cap = torch.where(hit.tri >= 0, INF_DIST, 0.0)
    bvh, ps, soup = scene.bvh, scene.packets, scene.triangles

    def run(**kw):
        kw = dict(knobs, k_round=2, **kw)
        h = pk.intersect_closest_pallas(bvh, ps, soup, o, d, t_cap=t_cap,
                                        **kw)
        return h, pk.occluded_pallas(bvh, ps, soup, o, d, 0.5 * t_cap, **kw)

    launches = (counts["pc.kernel.block_cull"], counts["pc.kernel.pair_cull"])
    h, occ = run()
    assert counts["pc.kernel.block_cull"] > launches[0]
    # the any-hit query takes "rounds" unless a strategy is given
    refresh = knobs.get("strategy", "rounds") == "rounds" and not knobs.get(
        "stale_round_masks")
    assert (counts["pc.kernel.pair_cull"] > launches[1]) == refresh
    h2, occ2 = run(cull_impl="pallas2")
    assert torch.equal(h.t, h2.t) and torch.equal(occ, occ2)
    request.getfixturevalue("plain_versions")
    h_p, occ_p = run()
    assert torch.equal(h.tri, h_p.tri) and torch.equal(h.t, h_p.t)
    assert torch.equal(occ, occ_p)
    assert bool((h.tri >= 0).any())


def _bench_hall(dev, textured):
    """The hall of 27,748 triangles (32 superblocks, so both rounds of the
    closest query run) with the bench sky; ``textured``: 64^2 diffuse and
    bump textures, corner-packed."""
    import dataclasses
    from prismarine_core_tpu_torch.models import procedural
    scene = procedural.make_hall_scene(target_tris=20000, textured=textured,
                                       texture_resolution=64, device=dev)
    return dataclasses.replace(
        scene, environment=procedural.make_sky_environment(128, device=dev))


def _bench_frame(dev, scene, **knobs):
    """A 64x48 frame of bench.py's main configuration (4 bounces, coherent
    samples of seed 0) with ``knobs``; returns (image, stats)."""
    from prismarine_core_tpu_torch.models.camera import Camera
    from prismarine_core_tpu_torch.ops.sampling import (
        make_coherent_sample_arrays)
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    cfg = RenderConfig(width=64, height=48, spp=1, max_bounces=4,
                       intersector="pallas", coherent_bounce_sampling=True,
                       anyhit_strategy="single", cull_impl="pallas2",
                       closest_k=16, **knobs)
    cam = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                         fov_y_deg=60.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cam_s, bounce_s = make_coherent_sample_arrays(gen, cfg, block=(8, 16))
    return render_with_samples(scene, cam, cfg, cam_s, bounce_s,
                               with_stats=True)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["textured", "env_nee",
                                  "textured-bicubic"])
def test_frame_equal_plain(cuda_device, case, request):
    """The textured frame (bilinear and bicubic fetches on the card) and
    the env-NEE frame (four queries a bounce) on the kernels equal their
    plain-version frames bit for bit, with the kernels launched."""
    dev = cuda_device
    scene = _bench_hall(dev, textured=case.startswith("textured"))
    knobs = dict(env_nee=case == "env_nee")
    if case.endswith("bicubic"):
        knobs["texture_filter"] = "bicubic"
    launches = counts["pc.kernel.sb_intersect"]
    syncs = counts["pc.sync.compact"]
    img, stats = _bench_frame(dev, scene, **knobs)
    assert counts["pc.kernel.sb_intersect"] - launches == (
        16 if knobs["env_nee"] else 12)
    assert counts["pc.sync.compact"] - syncs == (
        16 if knobs["env_nee"] else 12)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 1e-2
    request.getfixturevalue("plain_versions")
    img_p, stats_p = _bench_frame(dev, scene, **knobs)
    assert torch.equal(img, img_p) and torch.equal(stats, stats_p)


@pytest.mark.gpu
def test_env_shadow_query_inputs_equal_plain(cuda_device, monkeypatch):
    """The env shadow query of a bounce-1 step (every cap INF_DIST, rays
    aimed at the sky's bright texels): both culls and the "mt" walk equal
    their plain versions exactly on the inputs the step gives them."""
    from prismarine_core_tpu_torch.models.camera import (
        Camera, generate_rays)
    from prismarine_core_tpu_torch.ops.sampling import (
        make_coherent_sample_arrays)
    from prismarine_core_tpu_torch.render.integrator import (
        initial_carry, make_bounce_step)
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    dev = cuda_device
    scene = _bench_hall(dev, textured=False)
    cfg = RenderConfig(width=64, height=48, spp=1, max_bounces=2,
                       intersector="pallas", coherent_bounce_sampling=True,
                       anyhit_strategy="single", cull_impl="pallas2",
                       closest_k=16, env_nee=True)
    cam = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                         fov_y_deg=60.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    cam_s, bounce_s = make_coherent_sample_arrays(gen, cfg, block=(8, 16))
    step = make_bounce_step(scene, cfg)
    carry, _ = step(initial_carry(*generate_rays(cam, cfg, cam_s)),
                    bounce_s[0])
    calls = {"block_cull": [], "pair_cull": [], "sb_intersect": []}
    names = {cull.launch_block_cull: "block_cull",
             cull.launch_pair_cull: "pair_cull",
             si.launch_sb_intersect: "sb_intersect"}
    choose = dispatch.choose

    def recording(x, launch, plain):
        run = choose(x, launch, plain)
        if launch not in names:
            return run

        def rec(*args):
            calls[names[launch]].append(args)
            return run(*args)
        return rec
    monkeypatch.setattr(dispatch, "choose", recording)
    step(carry, bounce_s[1])
    monkeypatch.setattr(dispatch, "choose", choose)
    # closest rounds 1 and 2, sun shadow, env shadow
    assert [len(v) for v in calls.values()] == [4, 4, 4]
    bargs, pargs, sargs = (calls[k][3] for k in calls)
    assert bool((bargs[0][:, 6] == INF_DIST).any())
    assert torch.equal(cull.block_cull(*bargs), cull.block_cull_plain(*bargs))
    assert torch.equal(cull.pair_cull(*pargs), cull.pair_cull_plain(*pargs))
    assert int(pargs[2]) > 0
    out = si.sb_intersect(*sargs)
    ref = si.sb_intersect_plain(*sargs)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def _hall_rays(r, seed, dev, live_frac=1.0):
    """(o, d, t_cap) of ``r`` rays inside the small hall."""
    o, d, t_cap = _rays(r, seed, dev, live_frac)
    o = o * torch.tensor([1.0, 0.25, 0.4], device=dev) + torch.tensor(
        [0.0, 2.0, 0.0], device=dev)
    return o.contiguous(), d, t_cap


def _walk_case(case, dev):
    """(bvh, o, d, t_cap) of one edge case of the BVH walk."""
    from prismarine_core_tpu_torch.models import procedural
    if case.startswith("hall"):
        scene = procedural.make_hall_scene(target_tris=3000, device=dev)
        bvh = build_bvh(scene.triangles, leaf_size=4,
                        topology=case.split("-")[1])
        return (bvh, *_hall_rays(4096, 51, dev))
    if case == "one-tri":
        soup = TriangleSoup.from_arrays(
            np.float32([[-1, -1, 0], [1, -1, 0], [0, 1, 0]]), [[0, 1, 2]],
            device=dev)
        bvh = build_bvh(soup, leaf_size=4)
        o, d, t_cap = _rays(512, 52, dev)
        d = torch.where(torch.arange(512, device=dev)[:, None] % 2 == 0,
                        -o / o.norm(dim=-1, keepdim=True), d)   # aimed
        return bvh, o, d.contiguous(), t_cap
    n_tris = 10 if case == "padded" else 300
    soup, bvh, _ = _scene(n_tris, 53, dev)
    o, d, t_cap = _rays(1024, 54, dev,
                        live_frac=0.5 if case == "t-cap-0" else 1.0)
    if case == "zero-dir":
        # axis-aligned directions (+-0 components), and components below
        # the 1e-12 guard
        axes = torch.cat([torch.eye(3), -torch.eye(3)]).to(dev)
        d[:600] = axes.repeat(100, 1)
        d[600:700, 1] = 1e-13
        d[700:800, 2] = -0.0
    elif case == "inside-box":
        c = (soup.v0 + soup.v1 + soup.v2)[:n_tris] / 3.0
        o = c[torch.arange(o.shape[0], device=dev) % n_tris].contiguous()
    elif case == "short-caps":
        t_cap = torch.full_like(t_cap, 3.0)
    elif case == "beyond-inf":
        t_cap = torch.full_like(t_cap, 2.0 * INF_DIST)
    return bvh, o, d, t_cap


WALK_CASES = ["random", "zero-dir", "t-cap-0", "inside-box", "padded",
              "one-tri", "short-caps", "beyond-inf", "hall-karras",
              "hall-median"]


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("case", WALK_CASES)
def test_bvh_walk_equal_plain(cuda_device, case, any_hit):
    """The BVH walk kernel equals its plain version (the lockstep walk)
    on (t, slot) exactly, one launch counted."""
    from prismarine_core_tpu_torch.ops import bvh_walk as bw
    bvh, o, d, t_cap = _walk_case(case, cuda_device)
    launches = counts["pc.kernel.bvh_walk"]
    t, slot = bw.bvh_walk(bvh, o, d, t_cap, any_hit)
    torch.cuda.synchronize()
    assert counts["pc.kernel.bvh_walk"] == launches + 1
    tp, slot_p, _, _ = bw.bvh_walk_plain(bvh, o, d, t_cap, any_hit)
    assert torch.equal(t, tp) and torch.equal(slot.long(), slot_p)
    if case not in ("t-cap-0", "beyond-inf"):
        assert int((slot >= 0).sum()) > 0


def _walk_equal_plain(bvh, o, d, t_cap, any_hit):
    """One walk kernel launch == the plain walk on (t, slot) exactly."""
    from prismarine_core_tpu_torch.ops import bvh_walk as bw
    launches = counts["pc.kernel.bvh_walk"]
    t, slot = bw.bvh_walk(bvh, o, d, t_cap, any_hit)
    torch.cuda.synchronize()
    assert counts["pc.kernel.bvh_walk"] == launches + (1 if o.shape[0] else 0)
    tp, slot_p, _, _ = bw.bvh_walk_plain(bvh, o, d, t_cap, any_hit)
    assert torch.equal(t, tp) and torch.equal(slot.long(), slot_p)
    return t, slot


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_bvh_walk_after_refit_equal_plain(cuda_device, any_hit):
    """The walk on ``Scene.with_refit`` after the vertices moved equals the
    plain walk on the refit BVH: the kernel's packed records of the old
    BVH (packed and kept by the first call) are not reused."""
    from prismarine_core_tpu_torch.models import procedural
    dev = cuda_device
    scene = procedural.make_hall_scene(target_tris=3000, device=dev)
    o, d, t_cap = _hall_rays(4096, 51, dev)
    t0, _ = _walk_equal_plain(scene.bvh, o, d, t_cap, any_hit)
    g = torch.Generator(device=dev).manual_seed(3)
    jit = 0.3 * torch.randn(scene.triangles.v0.shape, generator=g,
                            device=dev)
    moved = dataclasses.replace(scene.triangles, v0=scene.triangles.v0 + jit,
                                v1=scene.triangles.v1 + jit,
                                v2=scene.triangles.v2 + jit)
    refit = dataclasses.replace(scene, triangles=moved).with_refit()
    t1, _ = _walk_equal_plain(refit.bvh, o, d, t_cap, any_hit)
    assert not torch.equal(t0, t1)
    # an in-place write to the walked BVH's vertices is seen as well
    refit.bvh.tv0.add_(0.05)
    _walk_equal_plain(refit.bvh, o, d, t_cap, any_hit)


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_bvh_walk_dead_lanes_equal_plain(cuda_device, any_hit):
    """A batch whose dead lanes (cap 0 and -0.0, 90% of them) end before
    their first step: (t_cap, -1) bit for bit, the live lanes as the
    plain walk."""
    bvh, o, d, t_cap = _walk_case("hall-karras", cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    u = torch.rand(t_cap.shape, generator=g, device=cuda_device)
    t_cap = torch.where(u < 0.45, 0.0, torch.where(u < 0.9, -0.0, t_cap))
    t, slot = _walk_equal_plain(bvh, o, d, t_cap, any_hit)
    dead = u < 0.9
    assert torch.equal(t[dead].view(torch.int32),
                       t_cap[dead].view(torch.int32))
    assert bool((slot[dead] == -1).all()) and int((slot >= 0).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("knobs", [dict(chunk=1024), dict(sort=True),
                                   dict(chunk=512, sort=True)],
                         ids=["chunked", "sorted", "sorted-chunked"])
def test_bvh_walk_chunked_sorted_equal_plain(cuda_device, knobs, any_hit):
    """``_run_traversal`` in chunks (``traverse_chunk``) and on
    coherence-sorted rays (``sort_rays``) on the kernel equals the plain
    walk on the whole batch, one launch a chunk."""
    from prismarine_core_tpu_torch.accel import traverse as tr
    from prismarine_core_tpu_torch.ops import bvh_walk as bw
    bvh, o, d, t_cap = _walk_case("hall-median", cuda_device)
    t_cap = torch.where(torch.arange(t_cap.shape[0], device=cuda_device)
                        % 3 == 0, 0.0, t_cap)
    launches = counts["pc.kernel.bvh_walk"]
    t, slot = tr._run_traversal(bvh, o, d, t_cap, any_hit, **knobs)
    torch.cuda.synchronize()
    assert counts["pc.kernel.bvh_walk"] - launches == o.shape[0] // knobs.get(
        "chunk", o.shape[0])
    tp, slot_p, _, _ = bw.bvh_walk_plain(bvh, o, d, t_cap, any_hit)
    assert torch.equal(t, tp) and torch.equal(slot.long(), slot_p)


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("n_rays", [0, 1, 31, 33, 127, 129, 4099, 524_291])
def test_bvh_walk_ragged_counts_equal_plain(cuda_device, n_rays, any_hit):
    """Ray counts that are no multiple of the warp (32) or the block
    (128), none at all, and more rays than the card holds lanes (every
    lane refilled many times) equal the plain walk."""
    from prismarine_core_tpu_torch.models import procedural
    dev = cuda_device
    scene = procedural.make_hall_scene(target_tris=3000, device=dev)
    o, d, t_cap = (x[:n_rays].contiguous() for x in _hall_rays(
        max(n_rays, 1), 55, dev, live_frac=0.8))
    t, slot = _walk_equal_plain(scene.bvh, o, d, t_cap, any_hit)
    assert t.shape == slot.shape == (n_rays,)
    if n_rays > 4096:
        assert int((slot >= 0).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("knobs", [dict(), dict(sort_rays=True,
                                                traverse_chunk=1024)],
                         ids=["default", "sorted-chunked"])
def test_bvh_cornell_frame_equal_plain(cuda_device, knobs, request):
    """The "bvh" cornell frame on the walk kernel (8 launches: a closest
    and a shadow query a bounce, one chunk each at 64x64 = 4,096 rays
    unless chunked) equals its plain-version frame bit for bit."""
    from prismarine_core_tpu_torch.models.camera import Camera
    from prismarine_core_tpu_torch.models.scene import make_cornell_scene
    from prismarine_core_tpu_torch.ops.sampling import make_sample_arrays
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    dev = cuda_device
    scene = make_cornell_scene(device=dev)
    cam = Camera.look_at(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                         fov_y_deg=50.0, device=dev)
    cfg = RenderConfig(width=64, height=64, max_bounces=4, **knobs)
    assert cfg.intersector == "bvh"
    samples = make_sample_arrays(torch.Generator(device=dev).manual_seed(0),
                                 cfg.n_rays, cfg.max_bounces)
    launches = counts["pc.kernel.bvh_walk"]
    img, stats = render_with_samples(scene, cam, cfg, *samples,
                                     with_stats=True)
    n = counts["pc.kernel.bvh_walk"] - launches
    assert n == 8 * (4 if knobs else 1)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 1e-2

    request.getfixturevalue("plain_versions")
    img_p, stats_p = render_with_samples(scene, cam, cfg, *samples,
                                         with_stats=True)
    assert counts["pc.kernel.bvh_walk"] - launches == n
    assert torch.equal(img, img_p) and torch.equal(stats, stats_p)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sweep_v0_x", "sweep_v2_y", "shared_edge",
                                  "cast_shadow", "fat_light", "two_lights"])
def test_edge_gradient_fd_on_card(cuda_device, name):
    """The finite-difference cases of tests/test_edge_gradients.py on the
    card under "bvh" (the walk kernel), on sample arrays of a CPU
    generator seeded 0 (tests/torch_edge_cases.py), under the JAX tests'
    bounds."""
    # pytest puts this file's directory on sys.path ("tests" may name
    # another installed package)
    import torch_edge_cases as ec
    g, fd = ec.fd_check(name, ec.torch_samples(name, 0, cuda_device),
                        intersector="bvh")
    assert abs(fd) > ec.CASES[name].min_fd, fd
    assert ec.within(name, g, fd), (g, fd)


@pytest.mark.gpu
def test_edge_gradients_equal_plain_walk(cuda_device, request):
    """A 64x48 ``render_with_edge_gradients`` of the small hall (env NEE,
    every boundary term, 8,192 edge samples, "bvh"): its value equals
    ``render_with_samples`` exactly, and its vertex gradient on the walk
    kernel matches the one on the walk's plain version up to the order of
    the backward's atomic adds (relative L2 <= 1e-5, cosine >= 0.99999)."""
    import torch_edge_cases as ec
    from prismarine_core_tpu_torch.models.camera import Camera
    from prismarine_core_tpu_torch.ops.sampling import make_sample_arrays
    from prismarine_core_tpu_torch.parallel.mesh import (
        apply_params, init_params)
    from prismarine_core_tpu_torch.render.edge_grad import (
        make_edge_sample_arrays, render_with_edge_gradients)
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    dev = cuda_device
    scene = _bench_hall(dev, textured=False)
    cam = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                         fov_y_deg=60.0, device=dev)
    cfg = RenderConfig(width=64, height=48, max_bounces=4, env_nee=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    cam_s, bounce_s = make_sample_arrays(gen, cfg.n_rays, cfg.max_bounces)
    eu, ebs = make_edge_sample_arrays(gen, 8192, cfg.max_bounces)
    w = torch.rand((48, 64, 3), generator=gen, device=dev)

    def grads():
        params = {k: v.detach().clone().requires_grad_(k in ("v0", "v1",
                                                              "v2"))
                  for k, v in init_params(scene).items()}
        img = render_with_edge_gradients(
            apply_params(scene, params), cam, cfg, cam_s, bounce_s, eu, ebs,
            shadow_term=True)
        return img.detach(), torch.autograd.grad(
            (img * w).sum(), [params[k] for k in ("v0", "v1", "v2")])

    launches = counts["pc.kernel.bvh_walk"]
    img, g = grads()
    assert counts["pc.kernel.bvh_walk"] - launches == 44
    assert torch.equal(img, render_with_samples(scene, cam, cfg, cam_s,
                                                bounce_s))

    request.getfixturevalue("plain_versions")
    img_p, g_p = grads()
    assert torch.equal(img, img_p)
    assert all(bool(torch.isfinite(x).all()) for x in g)
    assert sum(int((x != 0).sum()) for x in g) > 0
    cos, rel = ec.cos_rel(g, g_p)
    assert rel <= 1e-5 and cos >= 0.99999, (cos, rel)


@pytest.mark.gpu
def test_image_writers_take_card_tensors(cuda_device, tmp_path):
    """PNG, HDR and NPY written from a tensor on the card hold what the
    same image writes from the host."""
    from prismarine_core_tpu_torch.utils import image
    g = torch.Generator(device=cuda_device).manual_seed(0)
    img = 3.0 * torch.rand((24, 40, 3), generator=g, device=cuda_device)
    host = img.cpu().numpy()
    for name, write in (("png", image.save_png), ("hdr", image.save_hdr),
                        ("npy", image.save_npy)):
        write(str(tmp_path / f"card.{name}"), img)
        write(str(tmp_path / f"host.{name}"), host)
        assert ((tmp_path / f"card.{name}").read_bytes()
                == (tmp_path / f"host.{name}").read_bytes()), name
    np.testing.assert_array_equal(np.load(tmp_path / "card.npy"), host)


def _card_mesh(dev, n, mp):
    """A mesh of ``n`` positions that all name the card."""
    from prismarine_core_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(n, model_parallel=mp, devices=[dev] * n)


@pytest.mark.gpu
@pytest.mark.parametrize("mp", [2, 3])
def test_sharded_query_on_a_card_mesh(cuda_device, mp):
    """The sharded query on a 1 x mp mesh of the card (each shard on its
    own superblock range, mp 3 padding the last) against the same query
    on the plain versions (a CPU mesh) bit for bit, and against the
    single-device query on the card: the triangle on all but counted tie
    lanes, t equal where the triangle is, occlusion equal."""
    from prismarine_core_tpu_torch.parallel import shard_intersect as tsi
    from prismarine_core_tpu_torch.parallel.mesh import to_device
    soup, bvh, ps = _scene(3000, 21, cuda_device)
    o, d, t_cap = _rays(2048, 22, cuda_device, t_far=25.0)
    mesh = _card_mesh(cuda_device, mp, mp)
    sp = tsi.shard_packets(tsi.build_sharded_packets(bvh, mp), mesh)
    launches = counts["pc.kernel.sb_intersect"]
    hit = tsi.sharded_intersect_closest(mesh, sp, o, d)
    occ = tsi.sharded_occluded(mesh, sp, o, d, t_cap)
    assert counts["pc.kernel.sb_intersect"] - launches >= 2 * mp
    cpu = torch.device("cpu")
    cmesh = _card_mesh(cpu, mp, mp)
    csp = tsi.shard_packets(tsi.build_sharded_packets(to_device(bvh, cpu),
                                                      mp), cmesh)
    chit = tsi.sharded_intersect_closest(cmesh, csp, o.cpu(), d.cpu())
    assert torch.equal(hit.tri.cpu(), chit.tri)
    assert torch.equal(hit.t.cpu(), chit.t)
    assert torch.equal(occ.cpu(), tsi.sharded_occluded(
        cmesh, csp, o.cpu(), d.cpu(), t_cap.cpu()))
    ref = pk.intersect_closest_pallas(bvh, ps, soup, o, d)
    same = hit.tri == ref.tri
    assert int((~same).sum()) <= 2
    assert torch.equal(hit.t[same], ref.t[same])
    assert torch.equal(occ, pk.occluded_pallas(bvh, ps, soup, o, d, t_cap))


@pytest.mark.gpu
def test_sharded_frame_and_train_step_on_a_card_mesh(cuda_device):
    """A "pallas_sharded" cornell frame on a 1 x 2 mesh of the card equal
    to the single-device "pallas" frame bit for bit; the sharded train
    step (the BVH rebuilt inside the loss) moves v0, v1 and v2 and
    launches the walk."""
    from prismarine_core_tpu_torch.models.camera import Camera
    from prismarine_core_tpu_torch.models.scene import make_cornell_scene
    from prismarine_core_tpu_torch.parallel import shard_intersect as tsi
    from prismarine_core_tpu_torch.parallel.mesh import (
        init_params, make_train_step)
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    dev = cuda_device
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=3,
                       intersector="pallas", cull_impl="pallas2")
    rng = np.random.default_rng(6)
    cam_s = torch.tensor(rng.random((cfg.n_rays, 4), dtype=np.float32),
                         device=dev)
    bounce_s = torch.tensor(rng.random((3, cfg.n_rays, 11),
                                       dtype=np.float32), device=dev)
    scene = make_cornell_scene(device=dev)
    cam = Camera.look_at((0.0, 0.0, 3.4), (0.0, 0.0, 0.0), fov_y_deg=50.0,
                         device=dev)
    ref = render_with_samples(scene, cam, cfg, cam_s, bounce_s)
    mesh = _card_mesh(dev, 2, 2)
    cfg_sh = cfg.replace(intersector="pallas_sharded", mesh=mesh)
    img = render_with_samples(tsi.distribute_scene(scene, mesh), cam, cfg_sh,
                              cam_s, bounce_s)
    assert torch.equal(img, ref)

    step = make_train_step(mesh, cfg_sh.replace(kernel_form="mxu"))
    dscene = tsi.distribute_scene(scene, mesh, shard_soup=False)
    params = init_params(dscene)
    launches = counts["pc.kernel.sb_intersect_mxu"]
    new, loss = step(params, dscene, cam, cam_s, bounce_s, ref + 0.05)
    assert counts["pc.kernel.sb_intersect_mxu"] > launches
    assert bool(torch.isfinite(loss))
    for k in ("v0", "v1", "v2"):
        dv = new[k] - params[k]
        assert bool(torch.isfinite(dv).all()) and bool((dv != 0).any()), k
