"""The port's device mesh (``parallel/mesh.py``, ``parallel/shard_intersect.py``,
the sharded texture fetch) on the CPU, against itself on one device and
against the JAX package's mesh.

The port's mesh is ``make_mesh(8, model_parallel=..., devices=["cpu"] *
8)``, the JAX package's the 8-device virtual CPU mesh of tests/conftest.py.

* Mirrors of every test of tests/test_parallel.py (the same scenes, sizes
  and criteria, the port's mesh against the port on one device).  Where
  the JAX test bounds the sharded image against the single-device one by
  a tolerance, the port's must be equal bit for bit: one device and the
  mesh run the same float operations per ray (the brute ranges' and the
  sharded query's reduce take the lowest range / shard on ties, and the
  winning shard's carried surface is the soup's, formula for formula).
* Port against JAX:
  - ``build_sharded_packets``: every array bit for bit at mp 2, 3 and 4;
  - the sharded closest and any-hit query (mp 3: a padded shard): the
    triangle exact on all but 0.1% of lanes (counted: ties or 1-ulp edge
    decisions), t where both pick the same triangle within 2 ulps of the
    first-order scale of one rounding in t's numerator and in det, over
    |det| (as tests/test_torch_kernels.py bounds the kernels: XLA on the
    CPU contracts multiply-adds into FMAs, torch does not; the
    re-evaluation's det rounding counts here too), occlusion on all but
    0.1% of lanes;
  - ``_sharded_texel_rows`` bit for bit (each id is owned by one shard;
    the sum is the gather);
  - a 32x32 "pallas_sharded" cornell frame and the textured small hall's
    sharded frame against JAX's sharded frames by tests/test_torch_render.py's
    image criterion (>= 98% of pixels ``isclose(rtol=1e-3, atol=1e-3)``,
    the mean within 0.5%);
  - ``make_sharded_renderer`` and one "pallas_sharded" ``make_train_step``
    step (the loss within rtol 1e-5, every update within 1e-4 of its
    largest move).
  JAX's own textured test holds its sharded frame to its single-device
  one at atol 1e-5 and misses by 1.3e-5: its sharded textures equal its
  unsharded ones bit for bit, so the gap is the carried surface under
  XLA's FMA contraction (ROADMAP queue 3); the port's carried surface
  equals its soup-gathered one bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.models import procedural as jproc  # noqa: E402
from prismarine_core_tpu.models import textures as jtex  # noqa: E402
from prismarine_core_tpu.models.camera import Camera as JCamera  # noqa: E402
from prismarine_core_tpu.models.materials import MaterialTable as JMats  # noqa: E402
from prismarine_core_tpu.models.scene import Scene as JScene  # noqa: E402
from prismarine_core_tpu.models.scene import (  # noqa: E402
    make_cornell_scene as j_cornell)
from prismarine_core_tpu.ops.sampling import make_sample_arrays  # noqa: E402
from prismarine_core_tpu.parallel import mesh as jmesh  # noqa: E402
from prismarine_core_tpu.parallel import shard_intersect as jsi  # noqa: E402
from prismarine_core_tpu.render.integrator import (  # noqa: E402
    render_with_samples as j_render)
from prismarine_core_tpu.utils.config import RenderConfig as JConfig  # noqa: E402
from prismarine_core_tpu_torch import interop  # noqa: E402
from prismarine_core_tpu_torch.accel import packet as tpk  # noqa: E402
from prismarine_core_tpu_torch.accel.lbvh import build_bvh  # noqa: E402
from prismarine_core_tpu_torch.models import procedural as tproc  # noqa: E402
from prismarine_core_tpu_torch.models import textures as ttex  # noqa: E402
from prismarine_core_tpu_torch.models.camera import Camera  # noqa: E402
from prismarine_core_tpu_torch.models.geometry import TriangleSoup  # noqa: E402
from prismarine_core_tpu_torch.models.lights import SphereLights  # noqa: E402
from prismarine_core_tpu_torch.models.materials import MaterialTable  # noqa: E402
from prismarine_core_tpu_torch.models.scene import (  # noqa: E402
    Scene, make_cornell_scene)
from prismarine_core_tpu_torch.models.textures import Environment  # noqa: E402
from prismarine_core_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from prismarine_core_tpu_torch.parallel import shard_intersect as tsi  # noqa: E402
from prismarine_core_tpu_torch.parallel.mesh import (  # noqa: E402
    MeshArray, init_params, init_shared_params, make_mesh,
    make_sharded_renderer, make_train_step, shard_scene, shared_vertices)
from prismarine_core_tpu_torch.render.integrator import (  # noqa: E402
    render_with_samples)
from prismarine_core_tpu_torch.utils.config import RenderConfig  # noqa: E402
from tests.test_bvh import _random_soup  # noqa: E402
from tests.test_torch_render import (  # noqa: E402
    CORNELL, HALL, assert_image_parity)
from tests.test_torch_scene import jax_scene_arrays  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"
CAM = Camera.look_at(eye=CORNELL["eye"], target=CORNELL["target"],
                     fov_y_deg=CORNELL["fov"], device=CPU)
JCAM = JCamera.look_at(eye=CORNELL["eye"], target=CORNELL["target"],
                       fov_y_deg=CORNELL["fov"])
#: "pallas" with RenderConfig's default cull, as the mirrored tests run it
PALLAS = dict(intersector="pallas")


def _mesh(mp):
    return make_mesh(8, model_parallel=mp, devices=[CPU] * 8)


def _samples(cfg, seed):
    """The sample arrays of the mirrored JAX test: ``make_sample_arrays(
    jax.random.key(seed), ...)``, as tensors."""
    return tuple(_t(x) for x in make_sample_arrays(
        jax.random.key(seed), cfg.n_rays, cfg.max_bounces))


def _t(x):
    return torch.tensor(np.asarray(x))


def _leaves(obj):
    """Every tensor and MeshArray of a scene (the port's tree leaves)."""
    if isinstance(obj, (torch.Tensor, MeshArray)):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, tmesh.Mesh):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))


def _per_device(x):
    """Bytes of ``x`` on one device (``addressable_shards[0]``)."""
    return x.shard(0).nbytes if isinstance(x, MeshArray) else x.nbytes


# ------------------------------------------------- mirrors of test_parallel


def test_sharded_render_matches_single():
    mesh = _mesh(1)
    cfg = RenderConfig(width=16, height=16, spp=2, max_bounces=2,
                       intersector="brute", tri_block=16)
    scene = make_cornell_scene(capacity=64, device=CPU)
    cam_s, bounce_s = _samples(cfg, 0)
    single = render_with_samples(scene, CAM, cfg, cam_s, bounce_s)
    sharded = make_sharded_renderer(mesh, cfg)(shard_scene(scene, mesh),
                                               CAM, cam_s, bounce_s)
    assert sharded.device == mesh.first
    assert torch.equal(sharded, single)
    assert float(single.mean()) > 1e-2


def test_triangle_sharded_render_matches():
    mesh = _mesh(2)
    cfg = RenderConfig(width=16, height=16, spp=1, max_bounces=2,
                       intersector="brute", tri_block=16)
    scene = make_cornell_scene(capacity=64, device=CPU)
    cam_s, bounce_s = _samples(cfg, 1)
    single = render_with_samples(scene, CAM, cfg, cam_s, bounce_s)
    renderer = make_sharded_renderer(mesh, cfg)
    sharded = renderer(shard_scene(scene, mesh, shard_triangles=True), CAM,
                       cam_s, bounce_s)
    assert torch.equal(sharded, single)
    # make_sharded_renderer's own shard_triangles splits the same way
    assert torch.equal(make_sharded_renderer(mesh, cfg, shard_triangles=True)(
        scene, CAM, cam_s, bounce_s), single)


def test_train_step_reduces_loss():
    """(a) the sharded gradient matches finite differences on a material
    entry, (b) normalized-SGD steps descend (tests/test_parallel.py)."""
    mesh = _mesh(2)
    cfg = RenderConfig(width=12, height=12, spp=1, max_bounces=2,
                       intersector="brute", tri_block=16)
    scene = shard_scene(make_cornell_scene(capacity=64, device=CPU), mesh,
                        shard_triangles=True)
    cam_s, bounce_s = _samples(cfg, 3)
    renderer = make_sharded_renderer(mesh, cfg)
    target = renderer(scene, CAM, cam_s, bounce_s)
    mats = dataclasses.replace(scene.materials,
                               diffuse=scene.materials.diffuse * 0.5)
    scene_p = dataclasses.replace(scene, materials=mats)

    def loss_at(params):
        sc = tmesh.apply_params(scene_p, params)
        return torch.mean((renderer(sc, CAM, cam_s, bounce_s) - target) ** 2)

    params = init_params(scene_p)
    leaf = params["mat_diffuse"].detach().requires_grad_(True)
    g = torch.autograd.grad(loss_at({**params, "mat_diffuse": leaf}),
                            leaf)[0][1, 0]
    eps = 1e-3
    bumped = params["mat_diffuse"].clone()
    bumped[1, 0] += eps
    with torch.no_grad():
        fd = (float(loss_at({**params, "mat_diffuse": bumped}))
              - float(loss_at(params))) / eps
    assert abs(float(g) - fd) < 0.05 * abs(fd) + 1e-4, (float(g), fd)

    kw = dict(lr=0.02, normalize_grads=True,
              lr_scale={"v0": 0.01, "v1": 0.01, "v2": 0.01,
                        "light_color": 0.1})
    step = make_train_step(mesh, cfg, **kw)
    # the mesh's step is the single-device step: rows only split the rays
    one = make_train_step(None, cfg, **kw)(
        params, dataclasses.replace(scene_p, mesh=None,
                                    shard_triangles=False),
        CAM, cam_s, bounce_s, target)
    losses = []
    for _ in range(10):
        params, loss = step(params, scene_p, CAM, cam_s, bounce_s, target)
        if not losses:
            assert float(loss) == float(one[1])
            for k, v in params.items():
                torch.testing.assert_close(v, one[0][k], rtol=1e-5,
                                           atol=1e-7)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.95, losses


def test_render_stats():
    cfg = RenderConfig(width=8, height=8, spp=1, max_bounces=3,
                       intersector="brute", tri_block=16)
    scene = make_cornell_scene(capacity=64, device=CPU)
    img, stats = render_with_samples(scene, CAM, cfg, *_samples(cfg, 0),
                                     with_stats=True)
    assert stats.shape == (3, 5)
    assert int(stats[0, 0]) == 64
    assert bool((stats[:, 3] <= stats[:, 0]).all())


@pytest.fixture(scope="module")
def soup_3000():
    """tests/test_parallel.py's 3,000-triangle random soup (4 superblocks),
    its BVH and packet set (built by the JAX package, crossed over), and
    512 random rays."""
    js = JScene.assemble(_random_soup(3000, capacity=3072, seed=21),
                         JMats.build([{}]))
    ts = interop.scene_from_numpy(jax_scene_arrays(js), device=CPU)
    rng = np.random.default_rng(22)
    o = rng.uniform(-8, 8, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.5, 20, (512,)).astype(np.float32)
    return js, ts, o, d, t_max


def test_sharded_pallas_intersector_matches_single_device(soup_3000):
    """The sharded query (mp 4, rays over 2 data rows) equals the
    single-device query: the triangle on every lane but counted ties, t
    bit for bit where the triangle is the same, occlusion exactly."""
    _, ts, o, d, t_max = soup_3000
    o, d, t_max = torch.tensor(o), torch.tensor(d), torch.tensor(t_max)
    mesh = _mesh(4)
    sp = tsi.shard_packets(tsi.build_sharded_packets(ts.bvh, mp=4), mesh)
    ref = tpk.intersect_closest_pallas(ts.bvh, ts.packets, ts.triangles,
                                       o, d)
    got = tsi.sharded_intersect_closest(mesh, sp, o, d)
    same = got.tri == ref.tri
    print(f"sharded vs single: {int((~same).sum())} tie lanes of "
          f"{same.numel()}")
    assert int((~same).sum()) <= 1
    assert torch.equal(got.t[same], ref.t[same])
    assert torch.equal(got.t[~same], ref.t[~same])        # ties: equal t
    assert float((ref.tri >= 0).float().mean()) > 0.2
    occ_ref = tpk.occluded_pallas(ts.bvh, ts.packets, ts.triangles, o, d,
                                  t_max)
    assert torch.equal(tsi.sharded_occluded(mesh, sp, o, d, t_max), occ_ref)


@pytest.fixture(scope="module")
def cornell_frame():
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=3, **PALLAS)
    scene = make_cornell_scene(device=CPU)
    cam_s, bounce_s = _samples(cfg, 0)
    return cfg, scene, cam_s, bounce_s, render_with_samples(
        scene, CAM, cfg, cam_s, bounce_s)


def test_sharded_full_frame_production_path_matches_single_device(
        cornell_frame):
    cfg, scene, cam_s, bounce_s, ref = cornell_frame
    mesh = _mesh(2)
    dscene = tsi.distribute_scene(scene, mesh)
    assert dscene.bvh is None and dscene.triangles.capacity == 8
    assert dscene.device == mesh.first
    cfg_sh = cfg.replace(intersector="pallas_sharded", mesh=mesh)
    img = render_with_samples(dscene, CAM, cfg_sh, cam_s, bounce_s)
    assert torch.equal(img, ref)
    assert float(ref.mean()) > 1e-2


def test_sharded_packets_memory_scales_one_over_mp():
    soup = tproc_soup(3000, 3072, 5)
    bvh = build_bvh(soup, leaf_size=4)
    mp = 4
    mesh = _mesh(mp)
    sp = tsi.shard_packets(tsi.build_sharded_packets(bvh, mp=mp), mesh)
    leaves = [sp.planes, sp.tv0, sp.tv1, sp.tv2, sp.orig, sp.sb_lo,
              sp.sb_hi, sp.block_lo, sp.block_hi]
    total = sum(x.nbytes for x in leaves)
    per_dev = sum(x.shard(0).nbytes for x in leaves)
    assert per_dev <= total / mp + 1024, (per_dev, total, mp)
    for x in leaves:
        piece = x.shard(0)
        assert piece.shape[0] * mp == x.shape[0]
        # a copy of its own, not a view that keeps the whole alive
        assert piece.untyped_storage().nbytes() == piece.nbytes


def tproc_soup(n_tris, capacity, seed):
    """tests/test_bvh.py's random soup in the port."""
    js = _random_soup(n_tris, capacity=capacity, seed=seed)
    return TriangleSoup(**{f.name: _t(getattr(js, f.name))
                           for f in dataclasses.fields(js)})


def _pallas_sharded_setup(mp, seed):
    mesh = _mesh(mp)
    cfg = RenderConfig(width=16, height=16, spp=1, max_bounces=2,
                       intersector="pallas_sharded", mesh=mesh)
    scene = tsi.distribute_scene(make_cornell_scene(capacity=64, device=CPU),
                                 mesh, shard_soup=False)
    cam_s, bounce_s = _samples(cfg, seed)
    return mesh, cfg, scene, cam_s, bounce_s


def test_production_train_step_vertex_grads_flow():
    mesh, cfg, scene, cam_s, bounce_s = _pallas_sharded_setup(2, 0)
    # build_bvh keeps tv0..2 in the graph of the soup's v0..2: each
    # triangle of the soup (padding included) lands in one slot
    soup = scene.triangles
    v0 = soup.v0.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(
        build_bvh(dataclasses.replace(soup, v0=v0)).tv0.sum(), v0)
    assert torch.equal(g, torch.ones_like(g))
    target = make_sharded_renderer(mesh, cfg)(scene, CAM, cam_s, bounce_s)
    step = make_train_step(mesh, cfg)
    params = init_params(scene)
    params2, loss = step(params, scene, CAM, cam_s, bounce_s, target + 0.05)
    assert np.isfinite(float(loss))
    assert float((params2["mat_diffuse"] - params["mat_diffuse"]).abs()
                 .sum()) > 0.0
    for k in ("v0", "v1", "v2"):
        dv = float((params2[k] - params[k]).abs().sum())
        assert dv > 0.0 and np.isfinite(dv), f"no {k} gradient"


@pytest.mark.parametrize("intersector", ["brute", "pallas_sharded"])
def test_v2_gradient_matches_fd(intersector):
    """The loss differentiates w.r.t. v2 (tests/test_parallel.py's FD
    protocol: smooth coordinates by FD eps-consistency, each within 15%)."""
    if intersector == "pallas_sharded":
        mesh, cfg, scene, cam_s, bounce_s = _pallas_sharded_setup(2, 2)
    else:
        mesh = _mesh(2)
        cfg = RenderConfig(width=16, height=16, spp=1, max_bounces=2,
                           intersector="brute", tri_block=16)
        scene = shard_scene(make_cornell_scene(capacity=64, device=CPU),
                            mesh)
        cam_s, bounce_s = _samples(cfg, 2)
    renderer = make_sharded_renderer(mesh, cfg)
    target = renderer(scene, CAM, cam_s, bounce_s)

    def loss_at(params):
        sc = tmesh.apply_params(scene, params)
        if intersector == "pallas_sharded":
            sc = tmesh.rebuild_sharded(sc, cfg)
        img = renderer(sc, CAM, cam_s, bounce_s)
        return torch.mean((img - target * 0.9) ** 2)

    params = init_params(scene)
    leaf = params["v2"].detach().requires_grad_(True)
    g = torch.autograd.grad(loss_at({**params, "v2": leaf}), leaf)[0].numpy()

    @torch.no_grad()
    def fd_at(idx, e):
        hi, lo = params["v2"].clone(), params["v2"].clone()
        hi[idx] += e
        lo[idx] -= e
        return (float(loss_at({**params, "v2": hi}))
                - float(loss_at({**params, "v2": lo}))) / (2 * e)

    rng = np.random.default_rng(7)
    smooth = matched = 0
    for tri in rng.permutation(g.shape[0]):
        if smooth >= 3:
            break
        for axis in range(3):
            if abs(g[tri, axis]) < 1e-4:
                continue
            f1 = fd_at((int(tri), axis), 5e-4)
            f2 = fd_at((int(tri), axis), 1e-3)
            if abs(f1 - f2) > 0.25 * max(abs(f1), abs(f2), 1e-6):
                continue        # silhouette within eps: skip
            smooth += 1
            if abs(g[tri, axis] - f1) < 0.15 * abs(f1) + 1e-6:
                matched += 1
    assert smooth >= 1, "no smooth v2 coordinate found to probe"
    assert matched == smooth, (matched, smooth)


def test_shared_vertex_rotation_recovery():
    def panel_scene(angle):
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        quad = np.array([[-0.8, -0.8, 0], [0.8, -0.8, 0],
                         [0.8, 0.8, 0], [-0.8, 0.8, 0]], np.float32)
        tris = TriangleSoup.from_arrays(
            quad @ rot.T, np.array([[0, 1, 2], [0, 2, 3]], np.int32),
            mat_ids=np.zeros(2, np.int32), device=CPU)
        mats = MaterialTable.build([{"diffuse": (0.8, 0.7, 0.6)}],
                                   device=CPU)
        lights = SphereLights.single(center=(2.0, 3.0, 3.0), radius=0.2,
                                     color=(40.0, 40.0, 40.0), device=CPU)
        env = Environment.constant((0.05, 0.05, 0.08), device=CPU)
        return Scene.assemble(tris, mats, lights, env, build_bvh=False)

    mesh = _mesh(1)
    cfg = RenderConfig(width=16, height=16, spp=4, max_bounces=2,
                       intersector="brute", tri_block=16)
    cam_s, bounce_s = _samples(cfg, 4)
    target = make_sharded_renderer(mesh, cfg)(panel_scene(0.0), CAM, cam_s,
                                              bounce_s)
    start = panel_scene(0.35)
    verts0, faces = shared_vertices(start.triangles)
    assert verts0.shape[0] in (4, 5)
    step = make_train_step(mesh, cfg, lr=0.01, normalize_grads=True,
                           lr_scale={"mat_diffuse": 0.0,
                                     "light_color": 0.0},
                           vertex_faces=faces)
    params = init_shared_params(start, verts0)

    def angle_err(p):
        v = p["verts"]
        f = faces.long()
        a, b, c = v[f[0, 0]], v[f[0, 1]], v[f[0, 2]]
        n = torch.linalg.cross(b - a, c - a)
        n = n / torch.linalg.norm(n)
        return float(torch.arccos(torch.clamp(n[2].abs(), 0.0, 1.0)))

    a0 = angle_err(params)
    assert a0 > 0.3
    for _ in range(40):
        params, loss = step(params, start, CAM, cam_s, bounce_s, target)
    a1 = angle_err(params)
    assert np.isfinite(float(loss))
    assert a1 < 0.55 * a0, (a0, a1)


def test_distributed_scene_total_memory_scales():
    scene = tproc.make_hall_scene(target_tris=12_000, device=CPU)
    single_total = sum(x.nbytes for x in _leaves(
        dataclasses.replace(scene, bvh=None)))
    mp = 4
    dscene = tsi.distribute_scene(scene, _mesh(mp))
    leaves = list(_leaves(dscene))
    per_dev = sum(map(_per_device, leaves))
    assert per_dev < 0.5 * single_total, (per_dev, single_total)
    sharded = sum(x.shard(0).nbytes for x in leaves
                  if isinstance(x, MeshArray) and x.spec == "model")
    assert per_dev - sharded < 0.1 * single_total, (per_dev, single_total)


@pytest.fixture(scope="module")
def textured_small_hall():
    """tests/test_parallel.py's textured hall (2,000 tris, 32^2 textures),
    built by the JAX package and crossed over, its camera, the config at
    32x24 and 2 bounces and JAX's sample arrays."""
    js = jproc.make_hall_scene(target_tris=2000, textured=True,
                               texture_resolution=32)
    ts = interop.scene_from_numpy(jax_scene_arrays(js), device=CPU)
    kw = dict(width=32, height=24, spp=1, max_bounces=2, **PALLAS)
    cam_s, bounce_s = make_sample_arrays(jax.random.key(0),
                                         JConfig(**kw).n_rays, 2)
    return js, ts, kw, cam_s, bounce_s


def test_sharded_textures_match_and_scale(textured_small_hall):
    """Textures split over "model": per-device texture bytes ~1/mp of
    the stack, and the sharded textured frame equal to the single-device
    one bit for bit (one shard owns each id, so the sum is the fetch)."""
    _, scene, kw, cam_s, bounce_s = textured_small_hall
    cam = Camera.look_at(eye=HALL["eye"], target=HALL["target"],
                         fov_y_deg=HALL["fov"], device=CPU)
    cfg = RenderConfig(**kw)
    cam_s, bounce_s = _t(cam_s), _t(bounce_s)
    ref = render_with_samples(scene, cam, cfg, cam_s, bounce_s)
    mp = 2
    mesh = _mesh(mp)
    dscene = tsi.distribute_scene(scene, mesh)
    tex = dscene.textures
    assert tex.mesh is mesh
    for arr in (tex.data, tex.quad):
        assert arr.shard(0).nbytes * mp <= arr.nbytes + 1024
    img = render_with_samples(dscene, cam, cfg.replace(
        intersector="pallas_sharded", mesh=mesh), cam_s, bounce_s)
    assert torch.equal(img, ref)


def test_sharded_production_knobs_match_single_device(cornell_frame):
    """The sharded path forwards the single-device knobs (K,
    strategies, stale masks) to each shard's query."""
    _, scene, _, _, _ = cornell_frame
    knobs = dict(PALLAS, cull_impl="pallas2", pairs_per_step=8, closest_k=16,
                 cull_window=2048,
                 cull_pps=16, stale_round_masks=True,
                 anyhit_strategy="single")
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=2, **knobs)
    cam_s, bounce_s = _samples(cfg, 0)
    ref = render_with_samples(scene, CAM, cfg, cam_s, bounce_s)
    mesh = _mesh(2)
    img = render_with_samples(
        tsi.distribute_scene(scene, mesh), CAM,
        cfg.replace(intersector="pallas_sharded", mesh=mesh), cam_s,
        bounce_s)
    assert torch.equal(img, ref)


# ------------------------------------------------------ port against JAX


@pytest.mark.parametrize("mp", [2, 3, 4])
def test_build_sharded_packets_equal_jax(mp):
    """Every array of the shard layout bit for bit, the padding (EMPTY_BOX
    boxes, zero planes, ids -1) included: the hall of 3,000 tris has 4
    superblocks, so mp 3 pads 2."""
    js = jproc.make_hall_scene(target_tris=3000)
    ts = interop.scene_from_numpy(jax_scene_arrays(js), device=CPU)
    jsp = jsi.build_sharded_packets(js.bvh, mp, soup=js.triangles)
    tsp = tsi.build_sharded_packets(ts.bvh, mp, soup=ts.triangles)
    assert tsp.n_superblocks % mp == 0
    for f in dataclasses.fields(tsp):
        got, ref = getattr(tsp, f.name).numpy(), np.asarray(getattr(jsp,
                                                                    f.name))
        assert got.shape == ref.shape and got.dtype == ref.dtype, f.name
        np.testing.assert_array_equal(got, ref, err_msg=f.name)
    empty = tsi.build_sharded_packets(ts.bvh, mp)       # no soup: zeros
    assert not bool(empty.n0.any()) and not bool(empty.mat_id.any())


def _t_scale(js, tri, o, d, t):
    """(|e2| |o - v0| |e1| + |t| |e1| |d| |e2|) / |det| of each lane's
    triangle: the first-order scale of one rounding in t's numerator and
    in det (t = num / det), in which an ulp of FMA contraction shows."""
    v0, v1, v2 = (np.asarray(x)[tri] for x in (
        js.triangles.v0, js.triangles.v1, js.triangles.v2))
    e1, e2 = v1 - v0, v2 - v0
    det = np.einsum("ij,ij->i", e1, np.cross(d, e2))
    n = np.linalg.norm
    return (n(e2, axis=1) * n(e1, axis=1)
            * (n(o - v0, axis=1) + np.abs(t) * n(d, axis=1))
            / np.maximum(np.abs(det), 1e-30))


def test_sharded_query_matches_jax(soup_3000):
    """The port's sharded closest and any-hit query against the JAX
    package's, both over 3 model shards (4 superblocks padded to 6) and 2
    data rows."""
    js, ts, o, d, t_max = soup_3000
    r = o.shape[0]
    jm = jmesh.make_mesh(6, model_parallel=3)
    jsp = jsi.shard_packets(jsi.build_sharded_packets(js.bvh, mp=3), jm)
    # jitted: eager shard_map re-traces the interpret-mode kernels per call
    jhit, jocc = jax.jit(lambda sp, o, d, t_max: (
        jsi.sharded_intersect_closest(jm, sp, o, d),
        jsi.sharded_occluded(jm, sp, o, d, t_max)))(
            jsp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    jocc = np.asarray(jocc)
    tm = make_mesh(6, model_parallel=3, devices=[CPU] * 6)
    tsp = tsi.shard_packets(tsi.build_sharded_packets(ts.bvh, mp=3), tm)
    thit = tsi.sharded_intersect_closest(tm, tsp, torch.tensor(o),
                                         torch.tensor(d))
    tocc = tsi.sharded_occluded(tm, tsp, torch.tensor(o), torch.tensor(d),
                                torch.tensor(t_max)).numpy()
    jtri, ttri = np.asarray(jhit.tri), thit.tri.numpy()
    same = jtri == ttri
    n_occ = int((jocc != tocc).sum())
    print(f"sharded query vs JAX: {int((~same).sum())} of {r} lanes on "
          f"another triangle, {n_occ} on occlusion")
    assert int((~same).sum()) <= r // 1000 + 1
    assert n_occ <= r // 1000 + 1
    hit = same & (ttri >= 0)
    assert hit.mean() > 0.2
    jt, tt = np.asarray(jhit.t)[hit], thit.t.numpy()[hit]
    mag = np.maximum(np.abs(jt), _t_scale(js, ttri[hit], o[hit], d[hit],
                                          jt))
    err = np.abs(tt.astype(np.float64) - jt) / np.spacing(
        mag.astype(np.float32))
    print(f"t: max error {err.max():.3f} ulp of the scale")
    assert err.max() <= 2.0, f"max error {err.max():.2f} ulp"
    np.testing.assert_array_equal(thit.t.numpy()[same & (ttri < 0)],
                                  np.asarray(jhit.t)[same & (ttri < 0)])


def test_sharded_texel_rows_equal_jax():
    """One row gather from a stack split 2 ways (3 textures padded with
    white to 4), rows over 4 data rows, bit for bit."""
    rng = np.random.default_rng(3)
    stack = rng.uniform(0, 1, (3, 8, 8, 16)).astype(np.float32)
    padded = np.concatenate([stack, np.ones((1, 8, 8, 16), np.float32)])
    tid = rng.integers(0, 3, 512).astype(np.int32)
    y = rng.integers(0, 8, 512).astype(np.int32)
    x = rng.integers(0, 8, 512).astype(np.int32)
    jm = jmesh.make_mesh(8, model_parallel=2)
    from jax.sharding import NamedSharding, PartitionSpec as P
    jarr = jax.device_put(jnp.asarray(padded), NamedSharding(jm, P("model")))
    ref = np.asarray(jtex._sharded_texel_rows(jm, jarr, jnp.asarray(tid),
                                              jnp.asarray(y), jnp.asarray(x)))
    tm = _mesh(2)
    got = ttex._sharded_texel_rows(tm, MeshArray(torch.tensor(padded), tm,
                                                 "model"),
                                   torch.tensor(tid).long(), torch.tensor(y),
                                   torch.tensor(x))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, stack[tid, y, x])


def test_sharded_cornell_frame_matches_jax():
    """A 32x32 "pallas_sharded" cornell frame (mesh 4 x 2) against the JAX
    package's sharded frame on JAX's sample arrays."""
    kw = dict(width=32, height=32, spp=1, max_bounces=3, **PALLAS)
    cam_s, bounce_s = make_sample_arrays(jax.random.key(0),
                                         JConfig(**kw).n_rays, 3)
    jm = jmesh.make_mesh(8, model_parallel=2)
    jcfg = JConfig(**{**kw, "intersector": "pallas_sharded", "mesh": jm})
    jimg = np.asarray(jmesh.make_sharded_renderer(jm, jcfg)(
        jsi.distribute_scene(j_cornell(), jm), JCAM, cam_s, bounce_s))
    tm = _mesh(2)
    timg = render_with_samples(
        tsi.distribute_scene(make_cornell_scene(device=CPU), tm), CAM,
        RenderConfig(**{**kw, "intersector": "pallas_sharded", "mesh": tm}),
        _t(cam_s), _t(bounce_s)).numpy()
    assert timg.mean() > 1e-2
    assert_image_parity(timg, jimg)


def test_sharded_renderer_and_train_step_match_jax():
    """``make_sharded_renderer`` and one ``make_train_step`` step under
    "pallas_sharded" on a 4 x 2 mesh (the BVH and the sharded packets
    rebuilt inside the loss), port against JAX from one start (the
    diffuse table halved) and JAX's target: the image by the image
    criterion, the loss within rtol 1e-5 (float32 rounding of one image)
    and every update within 1e-4 of its largest move, as
    tests/test_torch_train.py holds the single-device step."""
    kw = dict(width=16, height=16, spp=1, max_bounces=2, cull_impl="pallas2",
              intersector="pallas_sharded")
    step_kw = dict(lr=0.05, lr_scale={"v0": 0.01, "v1": 0.01, "v2": 0.01})
    jm = jmesh.make_mesh(8, model_parallel=2)
    jcfg = JConfig(**kw, mesh=jm)
    cam_s, bounce_s = make_sample_arrays(jax.random.key(0), jcfg.n_rays, 2)
    jscene = jsi.distribute_scene(j_cornell(capacity=64), jm,
                                  shard_soup=False)
    jtarget = jmesh.make_sharded_renderer(jm, jcfg)(jscene, JCAM, cam_s,
                                                    bounce_s)
    start = {k: np.array(v) for k, v in jmesh.init_params(jscene).items()}
    start["mat_diffuse"][:, :3] *= 0.5
    jp, jloss = jmesh.make_train_step(jm, jcfg, **step_kw)(
        {k: jnp.asarray(v) for k, v in start.items()}, jscene, JCAM, cam_s,
        bounce_s, jtarget)

    tm = _mesh(2)
    tcfg = RenderConfig(**kw, mesh=tm)
    tscene = tsi.distribute_scene(make_cornell_scene(capacity=64,
                                                     device=CPU), tm,
                                  shard_soup=False)
    cam_s, bounce_s = _t(cam_s), _t(bounce_s)
    timg = make_sharded_renderer(tm, tcfg)(tscene, CAM, cam_s, bounce_s)
    assert_image_parity(timg.numpy(), np.asarray(jtarget))
    tp, tloss = make_train_step(tm, tcfg, **step_kw)(
        interop.params_from_numpy(start, device=CPU), tscene, CAM, cam_s,
        bounce_s, _t(jtarget))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k, v in start.items():
        move = np.abs(np.asarray(jp[k]) - v).max()
        err = np.abs(tp[k].numpy() - np.asarray(jp[k])).max()
        print(f"{k}: step {move:.3g}, |port - jax| {err:.3g}")
        assert move > 0 and err <= 1e-4 * move, (k, move, err)


def test_sharded_textured_frame_matches_jax(textured_small_hall):
    """The textured small hall's "pallas_sharded" frame (mesh 4 x 2,
    textures split over "model") against the JAX package's sharded
    frame on the same sample arrays."""
    js, ts, kw, cam_s, bounce_s = textured_small_hall
    jm = jmesh.make_mesh(8, model_parallel=2)
    jimg = np.asarray(j_render(
        jsi.distribute_scene(js, jm),
        JCamera.look_at(eye=HALL["eye"], target=HALL["target"],
                        fov_y_deg=HALL["fov"]),
        JConfig(**{**kw, "intersector": "pallas_sharded", "mesh": jm}),
        cam_s, bounce_s))
    tm = _mesh(2)
    cam = Camera.look_at(eye=HALL["eye"], target=HALL["target"],
                         fov_y_deg=HALL["fov"], device=CPU)
    timg = render_with_samples(
        tsi.distribute_scene(ts, tm), cam,
        RenderConfig(**{**kw, "intersector": "pallas_sharded", "mesh": tm}),
        _t(cam_s), _t(bounce_s)).numpy()
    assert timg.mean() > 1e-2
    assert_image_parity(timg, jimg)


def test_mesh_defaults_to_the_card_and_config_needs_a_mesh():
    """``make_mesh()`` takes the CUDA cards and raises without one; a
    "pallas_sharded" config without a mesh raises ValueError; the mesh's
    layout is JAX's (row-major, ``devices[:n]``)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    with pytest.raises(ValueError, match="cfg.mesh"):
        render_with_samples(make_cornell_scene(device=CPU), CAM,
                            RenderConfig(width=4, height=4, max_bounces=1,
                                         intersector="pallas_sharded"),
                            *_samples(RenderConfig(width=4, height=4,
                                                   max_bounces=1), 0))
    with pytest.raises(ValueError):
        make_mesh(6, model_parallel=4, devices=[CPU] * 8)
    jm = jmesh.make_mesh(8, model_parallel=4)
    tm = make_mesh(8, model_parallel=4,
                   devices=[f"cpu:{i}" for i in range(8)])
    assert tm.shape == dict(jm.shape)
    assert [[d.index for d in row] for row in tm.devices] == \
        [[d.id for d in row] for row in jm.devices]
