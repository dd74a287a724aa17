"""The surface at the hit (``ops/surface.py``, ``csrc/surface.cu``).

On the CPU: the module imports without a card; ``_interpolate_surface``
gives the same fields as the code it held before the move into
``surface_fields_plain`` (a copy of which is kept here); under grad with a
soup or material tensor that requires grad, a render's gradients are the
ones that code gives; the kernel's route through the seam
(``ops/dispatch.py``, the kernel's torch emulation standing in for its
launch) gives the plain version's fields and gradients bit for bit, alone
and through a whole render; the packed
records (their layout, read as the kernel reads them, and their rebuild
after an in-place edit).

On the card (``gpu``, skipped here): the kernel equals the plain version
bit for bit on every field (the hall's hits at every bounce under "bvh"
and "pallas", missed lanes, a one-row material table, a non-finite shading
normal, a textured scene with uv and tangent), whole frames are
bit-identical between the kernel and the plain version, under grad mode
too, and a train step runs the kernel once a bounce with the plain
version's loss and update.  This module imports no jax, so on a machine
without the JAX package:

    python -m pytest --noconftest tests/test_torch_surface.py -q
"""

import contextlib
import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from prismarine_core_tpu_torch.models.camera import Camera  # noqa: E402
from prismarine_core_tpu_torch.models.geometry import TriangleSoup  # noqa: E402
from prismarine_core_tpu_torch.models.materials import (  # noqa: E402
    _ARRAY_FIELDS, MaterialTable)
from prismarine_core_tpu_torch.models.scene import make_cornell_scene  # noqa: E402
from prismarine_core_tpu_torch.models.textures import (  # noqa: E402
    sample_bicubic, sample_bilinear)
from prismarine_core_tpu_torch.ops import dispatch  # noqa: E402
from prismarine_core_tpu_torch.ops import surface as sf  # noqa: E402
from prismarine_core_tpu_torch.ops.intersect import Hit  # noqa: E402
from prismarine_core_tpu_torch.ops.sampling import make_sample_arrays  # noqa: E402
from prismarine_core_tpu_torch.render import integrator as it  # noqa: E402
from prismarine_core_tpu_torch.utils import math as pm  # noqa: E402
from prismarine_core_tpu_torch.utils.config import RenderConfig  # noqa: E402
from prismarine_core_tpu_torch.utils.profiling import counts, spanned  # noqa: E402

CPU = "cpu"
FIELD_NAMES = ("ns", "ng", "uv", "tang") + tuple(f"mat.{f}"
                                                 for f in _ARRAY_FIELDS)
DICT_FIELDS = ("shading_normal", "geom_normal", "uv", "albedo", "alpha",
               "roughness", "metallic", "emissive", "transmission", "ior")


@spanned("pc.surface")
def old_interpolate_surface(scene, hit, cfg, kinds=None):
    """``render/integrator.py:_interpolate_surface``'s soup branch as it
    was before the surface moved into ``ops/surface.py``, kept verbatim as
    the reference of the move."""
    tri = torch.clamp(hit.tri, min=0).long()
    soup = scene.triangles
    w = (1.0 - hit.u - hit.v)[:, None]
    uu = hit.u[:, None]
    vv = hit.v[:, None]
    ns = pm.normalize(w * soup.n0[tri] + uu * soup.n1[tri]
                      + vv * soup.n2[tri])
    v0 = pm.take_rows(soup.v0, tri)
    e1 = pm.take_rows(soup.v1, tri) - v0
    e2 = pm.take_rows(soup.v2, tri) - v0
    ng = pm.normalize(pm.cross(e1, e2))
    ns = torch.where(torch.isfinite(ns).all(-1, keepdim=True), ns, ng)
    mat = scene.materials.lookup(soup.mat_id[tri].long())
    albedo4 = mat.diffuse
    rough, metal = mat.specular[:, 1], mat.specular[:, 2]
    emissive = mat.emissive[:, :3]
    if getattr(scene.textures, "stub", False):
        uv = torch.zeros((tri.shape[0], 2), dtype=torch.float32,
                         device=tri.device)
    else:
        sample_tex = (sample_bicubic if cfg.texture_filter == "bicubic"
                      else sample_bilinear)
        stack = scene.textures
        t0 = pm.take_rows(soup.t0, tri)
        t1 = pm.take_rows(soup.t1, tri)
        t2 = pm.take_rows(soup.t2, tri)
        uv = w * t0 + uu * t1 + vv * t2
        if kinds[3]:
            duv1 = t1 - t0
            duv2 = t2 - t0
            det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
            rdet = pm.safe_rcp(det_uv)[:, None]
            tang = pm.normalize((e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2])
                                * rdet)
            btex = sample_tex(stack, mat.tex_bump, uv)
            bitan = pm.cross(ns, tang)
            nt = btex[:, :3] * 2.0 - 1.0
            n_mapped = pm.normalize(tang * nt[:, 0:1] + bitan * nt[:, 1:2]
                                    + ns * nt[:, 2:3])
            ns = torch.where((mat.tex_bump >= 0)[:, None], n_mapped, ns)
        if kinds[0]:
            tex = sample_tex(stack, mat.tex_diffuse, uv)
            albedo4 = torch.where((mat.tex_diffuse >= 0)[:, None],
                                  albedo4 * tex, albedo4)
        if kinds[2]:
            etex = sample_tex(stack, mat.tex_emissive, uv)
            emissive = torch.where((mat.tex_emissive >= 0)[:, None],
                                   emissive * etex[:, :3], emissive)
        if kinds[1]:
            has_stex = mat.tex_specular >= 0
            stex = sample_tex(stack, mat.tex_specular, uv)
            rough = torch.where(has_stex, rough * stex[:, 1], rough)
            metal = torch.where(has_stex, metal * stex[:, 2], metal)
    return dict(shading_normal=ns, geom_normal=ng, uv=uv,
                albedo=albedo4[:, :3], alpha=albedo4[:, 3],
                roughness=rough, metallic=metal, emissive=emissive,
                transmission=mat.transmission[:, :3], ior=mat.ior)


def bits(t):
    """``t``'s values as integers, so NaNs compare by their bits."""
    t = t.detach().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert a.stride() == b.stride(), what
    assert torch.equal(bits(a), bits(b)), what


def flat_fields(fields):
    ns, ng, uv, tang, mat = fields
    return (ns, ng, uv, tang) + tuple(getattr(mat, f) for f in _ARRAY_FIELDS)


def assert_same_fields(a, b, what=""):
    for name, x, y in zip(FIELD_NAMES, flat_fields(a), flat_fields(b)):
        if x is None or y is None:
            assert x is None and y is None, f"{what} {name}"
        else:
            assert_same(x, y, f"{what} {name}")


def random_soup(n_tris, seed, dev, n_mats=4, bad_normals=0):
    """Random triangles with random per-vertex normals and texcoords;
    the first ``bad_normals`` triangles get a NaN or infinite shading
    normal at one corner."""
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-3, 3, (3 * n_tris, 3)).astype(np.float32)
    normals = rng.normal(size=(3 * n_tris, 3)).astype(np.float32)
    for k in range(bad_normals):
        normals[3 * k] = (np.nan, 0.0, 1.0) if k % 2 else (np.inf, 1.0, 0.0)
    tex = rng.uniform(0, 1, (3 * n_tris, 2)).astype(np.float32)
    tex[3:6] = tex[3]                      # one triangle with no uv area
    faces = np.arange(3 * n_tris).reshape(n_tris, 3)
    return TriangleSoup.from_arrays(
        verts, faces, normals=normals, texcoords=tex,
        mat_ids=rng.integers(0, n_mats, n_tris).astype(np.int32),
        device=dev)


def random_materials(n_mats, seed, dev):
    rng = np.random.default_rng(seed)
    return MaterialTable.build(
        [dict(diffuse=tuple(rng.uniform(0, 1, 3)), alpha=rng.uniform(),
              roughness=rng.uniform(), metallic=rng.uniform(),
              emissive=tuple(rng.uniform(0, 2, 3)),
              transmission=tuple(rng.uniform(0, 1, 3)),
              ior=rng.uniform(1, 2), tex_diffuse=int(i % 3) - 1,
              tex_bump=int(i % 2) - 1, tex_specular=-1, tex_emissive=i)
         for i in range(n_mats)], device=dev)


def synthetic(n_tris, n_rays, seed, dev, n_mats=4, bad_normals=0,
              textured=False):
    """(scene, hit): random triangles and materials, hits on random
    triangles at random barycentrics, a quarter of them missed."""
    scene = types.SimpleNamespace(
        triangles=random_soup(n_tris, seed, dev, n_mats, bad_normals),
        materials=random_materials(n_mats, seed + 1, dev),
        textures=types.SimpleNamespace(stub=not textured))
    g = torch.Generator().manual_seed(seed)
    tri = torch.randint(0, n_tris, (n_rays,), generator=g, dtype=torch.int32)
    tri[:bad_normals] = torch.arange(bad_normals, dtype=torch.int32)
    tri = torch.where(torch.rand(n_rays, generator=g) < 0.25, -1, tri)
    u, v = torch.rand(n_rays, generator=g), torch.rand(n_rays, generator=g)
    u, v = torch.where(tri >= 0, u, 0.0), torch.where(tri >= 0, v, 0.0)
    hit = Hit(t=torch.full((n_rays,), 1.0), tri=tri.to(torch.int32), u=u,
              v=v)
    return scene, Hit(**{k: getattr(hit, k).to(dev) for k in
                         ("t", "tri", "u", "v")})


# ---------------------------------------------------------------- CPU


def test_module_imports_without_a_card():
    """ops/surface.py imports and runs its plain version on CPU tensors
    without building or loading the kernel library."""
    from prismarine_core_tpu_torch import _build
    scene, hit = synthetic(8, 16, 0, CPU)
    before = counts["pc.kernel.surface"]
    assert_same_fields(sf.surface_fields(scene, hit),
                       sf.surface_fields_plain(scene, hit))
    assert counts["pc.kernel.surface"] == before
    assert callable(sf.surface_fields) and _build.CSRC.joinpath(
        "surface.cu").is_file()


def _cpu_scene(kind):
    from prismarine_core_tpu_torch.models.procedural import make_hall_scene
    if kind == "stub":
        return make_cornell_scene(device=CPU)
    return make_hall_scene(target_tris=3000, textured=True,
                           texture_resolution=32, build_bvh=False,
                           device=CPU)


def _cpu_hits(scene, n, seed):
    """Closest hits ("brute") of rays from inside the scene's box."""
    rng = np.random.default_rng(seed)
    lo = scene.triangles.v0.detach().amin(0).numpy()
    hi = scene.triangles.v0.detach().amax(0).numpy()
    o = rng.uniform(lo + 0.3 * (hi - lo), hi - 0.3 * (hi - lo), (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cfg = RenderConfig(width=4, height=4, intersector="brute")
    return it.closest_hit(scene, torch.tensor(o, dtype=torch.float32),
                          torch.tensor(d, dtype=torch.float32), cfg)


@pytest.mark.parametrize("kind", ["stub", "textured", "textured-bicubic",
                                  "non-finite-normals"])
def test_interpolate_surface_same_as_before_the_move(kind):
    """On the CPU, ``_interpolate_surface`` returns the fields the inline
    code gave (kept above) bit for bit, layouts included."""
    if kind == "non-finite-normals":
        scene, hit = synthetic(40, 300, 3, CPU, bad_normals=6)
    else:
        scene = _cpu_scene(kind.split("-")[0])
        hit = _cpu_hits(scene, 256, 1)
        assert (hit.tri < 0).any() or kind != "stub"
    cfg = RenderConfig(width=4, height=4, texture_filter=(
        "bicubic" if kind.endswith("bicubic") else "bilinear"))
    kinds = (None if getattr(scene.textures, "stub", False)
             else scene.materials.kinds_bound)
    if kind.startswith("textured"):
        assert kinds[0] and kinds[3]
    new = it._interpolate_surface(scene, hit, cfg, kinds)
    old = old_interpolate_surface(scene, hit, cfg, kinds)
    assert list(new) == list(old) == list(DICT_FIELDS)
    for name in DICT_FIELDS:
        assert_same(new[name], old[name], name)


def _grad_case(param):
    """A 16x16 2-bounce cornell render's sample arrays and the scene with
    ``param`` (a soup or material field) requiring grad."""
    scene = make_cornell_scene(device=CPU)
    cfg = RenderConfig(width=16, height=16, spp=1, max_bounces=2,
                       intersector="brute")
    cam = Camera.look_at(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                         fov_y_deg=50.0, device=CPU)
    cam_s, bounce_s = make_sample_arrays(torch.Generator().manual_seed(5),
                                         cfg.n_rays, cfg.max_bounces)
    group, field = param.split(".")
    leaf = getattr(getattr(scene, group), field).clone().requires_grad_(True)
    scene = dataclasses.replace(scene, **{group: dataclasses.replace(
        getattr(scene, group), **{field: leaf})})
    return scene, cam, cfg, cam_s, bounce_s, leaf


@contextlib.contextmanager
def seam(pick):
    """Every kernel wrapper's choice at the seam (``ops/dispatch.py``)
    made by ``pick(x, launch, plain, choose)`` in the block, ``choose``
    the seam's own."""
    choose = dispatch.choose
    dispatch.choose = lambda x, launch, plain: pick(x, launch, plain, choose)
    try:
        yield
    finally:
        dispatch.choose = choose


def is_surface(launch):
    return getattr(launch, "func", None) is sf.launch_surface


def emulated_surface(x, launch, plain, choose):
    """A ``seam`` choice: the surface's launch, on any device, stood in for
    by the kernel's torch emulation (``emulated_launch``)."""
    if is_surface(launch):
        return functools.partial(emulated_launch, *launch.args)
    return choose(x, launch, plain)


def plain_surface(x, launch, plain, choose):
    """A ``seam`` choice: the surface on its plain version."""
    return plain if is_surface(launch) else choose(x, launch, plain)


@contextlib.contextmanager
def old_surface():
    saved = it._interpolate_surface

    def run(scene, hit, cfg, kinds=None, carried=None):
        assert carried is None
        return old_interpolate_surface(scene, hit, cfg, kinds)
    it._interpolate_surface = run
    try:
        yield
    finally:
        it._interpolate_surface = saved


@pytest.mark.parametrize("param", ["triangles.v0", "triangles.n1",
                                   "materials.diffuse", "materials.emissive"])
def test_gradients_are_the_torch_paths(param):
    """Under grad with a soup or material tensor that requires grad, the
    gradient of a render's sum is the one the inline torch code gives,
    bit for bit, and the kernel's counter does not move."""
    scene, cam, cfg, cam_s, bounce_s, leaf = _grad_case(param)
    before = counts["pc.kernel.surface"]
    img = it.render_with_samples(scene, cam, cfg, cam_s, bounce_s)
    (grad,) = torch.autograd.grad(img.sum(), [leaf])
    assert counts["pc.kernel.surface"] == before
    with old_surface():
        img_old = it.render_with_samples(scene, cam, cfg, cam_s, bounce_s)
        (grad_old,) = torch.autograd.grad(img_old.sum(), [leaf])
    assert torch.equal(bits(img), bits(img_old))
    assert torch.equal(bits(grad), bits(grad_old))
    assert grad.abs().sum() > 0


def emulated_launch(stub, kinds, *xs):
    """``csrc/surface.cu``'s outputs as ``emulate_kernel`` computes them
    from the seam's tensors (``sf._tensors``), each in a tensor of its
    own: the surface's launch on the CPU."""
    n = len(sf._SOUP_FIELDS)
    scene = types.SimpleNamespace(
        triangles=types.SimpleNamespace(**dict(zip(sf._SOUP_FIELDS, xs))),
        materials=MaterialTable(*xs[n:-3]),
        textures=types.SimpleNamespace(stub=stub))
    hit = Hit(None, *xs[-3:])
    ns, ng, uv, tang, mat = emulate_kernel(scene, hit, kinds)
    return (ns, ng, uv.clone(), tang,
            *(getattr(mat, f).clone() for f in _ARRAY_FIELDS))


@pytest.mark.parametrize("case", ["no-grad-mode", "nothing-requires-grad",
                                  "v0", "n2", "t1", "diffuse", "ior",
                                  "hit.u", "hit.v", "vertices"])
def test_kernel_rule(case):
    """The kernel serves the surface whatever the grad state: its route
    through the seam (here with the kernel's torch emulation as the
    launch) gives the plain version's fields, each differentiable exactly
    where the plain version's is (on a stub and on a textured scene; the
    texture ids and the stub's zero uv never), and, where read tensors
    require grad under grad mode ("vertices": all three of the soup's),
    the plain version's gradient of a weighted sum of every field, bit
    for bit (the backward differentiates the plain version run again).
    On CPU tensors ``surface_fields`` is the plain version and launches
    nothing."""
    for textured in (False, True):
        scene, hit = synthetic(30, 200, 2, CPU, textured=textured)
        kinds = (True, False, True, True)
        soup, mats = scene.triangles, scene.materials
        targets = {"v0": [soup.v0], "n2": [soup.n2], "t1": [soup.t1],
                   "diffuse": [mats.diffuse], "ior": [mats.ior],
                   "hit.u": [hit.u], "hit.v": [hit.v],
                   "vertices": [soup.v0, soup.v1, soup.v2],
                   "no-grad-mode": [soup.v0]}.get(case, [])
        for target in targets:
            target.requires_grad_(True)
        before = counts["pc.kernel.surface"]
        with (torch.no_grad() if case == "no-grad-mode"
              else contextlib.nullcontext()):
            with seam(emulated_surface):
                got = sf.surface_fields(scene, hit, kinds)
            plain = sf.surface_fields_plain(scene, hit, kinds)
            on_cpu = sf.surface_fields(scene, hit, kinds)
        assert counts["pc.kernel.surface"] == before
        assert_same_fields(on_cpu, plain, "CPU")
        for name, x, y in zip(FIELD_NAMES, flat_fields(got),
                              flat_fields(plain)):
            if y is None:
                assert x is None, name
                continue
            assert torch.equal(bits(x), bits(y)), name
            # differentiable where the plain version's output is, and only
            # there (no shading downstream of the others is differentiated)
            assert x.requires_grad == y.requires_grad, (textured, name)
        assert not any(getattr(got[4], f).requires_grad
                       for f in _ARRAY_FIELDS[5:])
        assert textured or not got[2].requires_grad
    flows = bool(targets) and case != "no-grad-mode"
    assert got[0].requires_grad == (flows and case not in ("t1", "diffuse",
                                                           "ior"))
    if not flows:
        return
    gen = torch.Generator().manual_seed(9)

    def weighted(fields):
        return sum((x * torch.rand(x.shape, generator=gen)).sum()
                   for x in flat_fields(fields)
                   if x is not None and x.is_floating_point())
    g_got = torch.autograd.grad(weighted(got), targets)
    gen.manual_seed(9)
    g_plain = torch.autograd.grad(weighted(plain), targets)
    for a, b in zip(g_got, g_plain):
        assert torch.equal(bits(a), bits(b))
        assert b.abs().sum() > 0


@pytest.mark.parametrize("param", ["triangles.v0", "triangles.n1",
                                   "materials.diffuse", "materials.emissive"])
def test_render_gradients_through_the_kernels_route(param):
    """A render whose every surface takes the kernel's route through the
    seam (the kernel's torch emulation as the launch) gives the plain
    render's image and the gradient of its sum bit for bit."""
    scene, cam, cfg, cam_s, bounce_s, leaf = _grad_case(param)
    img = it.render_with_samples(scene, cam, cfg, cam_s, bounce_s)
    (grad,) = torch.autograd.grad(img.sum(), [leaf])
    with seam(emulated_surface):
        img_k = it.render_with_samples(scene, cam, cfg, cam_s, bounce_s)
        (grad_k,) = torch.autograd.grad(img_k.sum(), [leaf])
    assert img_k.grad_fn is not None
    assert torch.equal(bits(img_k), bits(img))
    assert torch.equal(bits(grad_k), bits(grad))
    assert grad.abs().sum() > 0


def emulate_kernel(scene, hit, kinds=None):
    """``csrc/surface.cu`` in torch: each lane's fields read from the
    packed records at the kernel's word offsets, with its arithmetic."""
    soup_r, uv_r, mat_r = sf.surface_records(scene)
    tri = torch.clamp(hit.tri, min=0).long()
    rec = soup_r[tri]
    v0, v1, v2 = rec[:, 0:3], rec[:, 4:7], rec[:, 8:11]
    n0, n1, n2 = rec[:, 12:15], rec[:, 16:19], rec[:, 20:23]
    u, v = hit.u[:, None], hit.v[:, None]
    w = (1.0 - u) - v
    ns = pm.normalize((w * n0 + u * n1) + v * n2)
    e1, e2 = v1 - v0, v2 - v0
    ng = pm.normalize(pm.cross(e1, e2))
    ns = torch.where(torch.isfinite(ns).all(-1, keepdim=True), ns, ng)
    m = mat_r[rec[:, 3].contiguous().view(torch.int32).long()]
    ids = m[:, 17:21].contiguous().view(torch.int32)
    mat = MaterialTable(m[:, 0:4], m[:, 4:8], m[:, 8:12], m[:, 12:16],
                        m[:, 16].contiguous(),
                        *(ids[:, k].contiguous() for k in range(4)))
    uv = torch.zeros((tri.shape[0], 2))
    tang = None
    if not sf._stub(scene):
        c = uv_r[tri]
        t0, t1, t2 = c[:, 0:2], c[:, 2:4], c[:, 4:6]
        uv = (w * t0 + u * t1) + v * t2
        if kinds[3]:
            d1, d2 = t1 - t0, t2 - t0
            det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
            tang = pm.normalize((e1 * d2[:, 1:2] - e2 * d1[:, 1:2])
                                * pm.safe_rcp(det)[:, None])
    return ns, ng, uv, tang, mat


@pytest.mark.parametrize("case", ["stub", "one-material", "non-finite",
                                  "textured", "textured-bump"])
def test_records_read_as_the_kernel_reads_them(case):
    """The packed records, read at the kernel's offsets with its
    arithmetic, give the plain version's fields bit for bit (misses,
    a one-row table, non-finite normals, uv and tangent)."""
    scene, hit = synthetic(
        60, 500, 4, CPU, n_mats=1 if case == "one-material" else 5,
        bad_normals=8 if case == "non-finite" else 0,
        textured=case.startswith("textured"))
    kinds = (True, False, True, case == "textured-bump")
    plain = sf.surface_fields_plain(scene, hit, kinds)
    assert (hit.tri < 0).any()
    if case == "textured-bump":
        assert plain[3] is not None
    got = emulate_kernel(scene, hit, kinds)
    for name, x, y in zip(FIELD_NAMES, flat_fields(got), flat_fields(plain)):
        if y is None:
            assert x is None, name
        else:
            assert torch.equal(bits(x), bits(y)), name
    if case == "non-finite":
        bad = (hit.tri >= 0) & (hit.tri < 8)
        assert bad.any() and torch.equal(plain[0][bad], plain[1][bad])


def test_records_rebuilt_after_in_place_edit():
    """The records are reused while the soup is unchanged and packed anew
    after an in-place edit of ``soup.v0`` (its version counter)."""
    scene, _ = synthetic(10, 4, 6, CPU)
    first = sf.surface_records(scene)
    assert sf.surface_records(scene)[0] is first[0]
    with torch.no_grad():
        scene.triangles.v0[3] += 1.0
    again = sf.surface_records(scene)
    assert again[0] is not first[0]
    assert torch.equal(again[0][3, 0:3], scene.triangles.v0[3])
    assert torch.equal(again[0][3, 0:3], first[0][3, 0:3] + 1.0)
    with torch.no_grad():
        scene.materials.ior[0] = 3.0
    assert sf.surface_records(scene)[2][0, 16] == 3.0


# ---------------------------------------------------------------- card


@pytest.fixture(scope="module")
def cuda_device():
    """The first CUDA card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def hall(cuda_device):
    """bench.py's hall (sky, sun, camera) on the card."""
    from prismarine_core_tpu_torch.models.procedural import (
        make_hall_scene, make_sky_environment)
    scene = make_hall_scene(target_tris=100_000, device=cuda_device)
    scene = dataclasses.replace(scene, environment=make_sky_environment(
        resolution=128, device=cuda_device))
    cam = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                         fov_y_deg=60.0, device=cuda_device)
    return scene, cam


def frame_cfg(intersector):
    return RenderConfig(width=1280, height=720, spp=1, max_bounces=4,
                        intersector=intersector, bvh_leaf_size=4,
                        coherent_bounce_sampling=True)


def frame_samples(cfg, dev, seed=7):
    from prismarine_core_tpu_torch.ops.sampling import (
        make_coherent_sample_arrays)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return make_coherent_sample_arrays(gen, cfg, block=(64, 64))


@contextlib.contextmanager
def compared_bounces():
    """Each surface launch of the bounce loop, its hit and fields with the
    plain version's fields on the same inputs beside them."""
    seen = []

    def pick(x, launch, plain, choose):
        run = choose(x, launch, plain)
        if not is_surface(launch):
            return run

        def recorded(*xs):
            out = run(*xs)
            seen.append((Hit(None, *xs[-3:]), sf._fields(out),
                         sf._fields(plain(*xs))))
            return out
        return recorded
    with seam(pick):
        yield seen


@pytest.mark.gpu
@pytest.mark.parametrize("intersector", ["bvh", "pallas"])
def test_kernel_equals_plain_on_the_halls_bounces(hall, intersector):
    """The hall's hits at bounces 1-4 of a 1280x720 frame under the "bvh"
    and the "pallas" query, missed and dead lanes included."""
    scene, cam = hall
    cfg = frame_cfg(intersector)
    before = counts["pc.kernel.surface"]
    with compared_bounces() as seen:
        it.render_with_samples(scene, cam, cfg,
                               *frame_samples(cfg, cam.eye.device))
    torch.cuda.synchronize()
    assert len(seen) == 4 and counts["pc.kernel.surface"] - before == 4
    for b, (hit, got, plain) in enumerate(seen):
        assert_same_fields(got, plain, f"bounce {b + 1}")
    assert any(bool((hit.tri < 0).any()) for hit, _, _ in seen)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one-material", "non-finite-normals",
                                  "textured-bump", "textured"])
def test_kernel_equals_plain_on_synthetic_hits(cuda_device, case):
    """Random hits with a quarter missed: a one-row material table,
    NaN and infinite shading normals (the geometric-normal fallback), a
    textured scene with and without a bump map bound (uv, tangent)."""
    scene, hit = synthetic(
        5000, 200_000, 8, cuda_device,
        n_mats=1 if case == "one-material" else 6,
        bad_normals=64 if case == "non-finite-normals" else 0,
        textured=case.startswith("textured"))
    kinds = (True, False, False, case == "textured-bump")
    before = counts["pc.kernel.surface"]
    got = sf.surface_fields(scene, hit, kinds)
    torch.cuda.synchronize()
    assert counts["pc.kernel.surface"] - before == 1
    plain = sf.surface_fields_plain(scene, hit, kinds)
    assert_same_fields(got, plain, case)
    if case == "non-finite-normals":
        bad = (hit.tri >= 0) & (hit.tri < 64)
        assert bad.any() and torch.equal(got[0][bad], got[1][bad])


@pytest.mark.gpu
def test_kernel_equals_plain_on_the_textured_hall(cuda_device):
    """bench.py's textured hall (diffuse and bump maps bound): every
    bounce's fields, uv and tangent included."""
    from prismarine_core_tpu_torch.models.procedural import make_hall_scene
    scene = make_hall_scene(target_tris=20_000, textured=True,
                            texture_resolution=128, device=cuda_device)
    kinds = scene.materials.kinds_bound
    assert kinds[0] and kinds[3]
    cam = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                         fov_y_deg=60.0, device=cuda_device)
    cfg = RenderConfig(width=320, height=180, spp=1, max_bounces=4,
                       intersector="bvh", bvh_leaf_size=4)
    with compared_bounces() as seen:
        it.render_with_samples(scene, cam, cfg, *make_sample_arrays(
            torch.Generator(device=cuda_device).manual_seed(3), cfg.n_rays,
            cfg.max_bounces))
    assert len(seen) == 4
    for b, (_, got, plain) in enumerate(seen):
        assert got[3] is not None
        assert_same_fields(got, plain, f"textured bounce {b + 1}")


@pytest.mark.gpu
@pytest.mark.parametrize("intersector", ["bvh", "pallas"])
def test_frames_bit_identical_between_the_paths(hall, intersector):
    """A 1280x720 frame on the kernel, the same frame under grad mode with
    ``soup.v0`` requiring grad (still the kernel, once a bounce) and the
    same frame with the bounce loop's surface on the plain version: the
    same image bit for bit."""
    scene, cam = hall
    cfg = frame_cfg(intersector)
    samples = frame_samples(cfg, cam.eye.device, seed=11)
    k0, s0 = counts["pc.kernel.surface"], counts["pc.surface"]
    img = it.render_with_samples(scene, cam, cfg, *samples)
    torch.cuda.synchronize()
    assert counts["pc.kernel.surface"] - k0 == 4
    assert counts["pc.surface"] - s0 == 4
    soup = scene.triangles
    grad_scene = dataclasses.replace(scene, triangles=dataclasses.replace(
        soup, v0=soup.v0.clone().requires_grad_(True)))
    k0 = counts["pc.kernel.surface"]
    with torch.enable_grad():
        img_grad = it.render_with_samples(grad_scene, cam, cfg, *samples)
    assert img_grad.requires_grad
    assert counts["pc.kernel.surface"] - k0 == 4
    k0 = counts["pc.kernel.surface"]
    with seam(plain_surface):
        img_plain = it.render_with_samples(scene, cam, cfg, *samples)
    assert counts["pc.kernel.surface"] == k0
    assert torch.equal(bits(img), bits(img_plain))
    assert torch.equal(bits(img_grad), bits(img_plain))


@pytest.mark.gpu
def test_kernel_in_a_train_step(cuda_device):
    """The inverse-rendering step differentiates the surface through the
    kernel: one launch a bounce; the loss the plain route's bit for bit;
    each updated parameter the plain route's to within twice what two
    runs of the plain route differ by (the scatter-adds of the backward
    are atomic on the card) and a millionth of its size."""
    from prismarine_core_tpu_torch.parallel.mesh import (
        init_params, make_train_step)
    scene = make_cornell_scene(device=cuda_device)
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=4,
                       intersector="bvh")
    cam = Camera.look_at(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                         fov_y_deg=50.0, device=cuda_device)
    cam_s, bounce_s = make_sample_arrays(
        torch.Generator(device=cuda_device).manual_seed(2), cfg.n_rays,
        cfg.max_bounces)
    target = torch.zeros((32, 32, 3), device=cuda_device)
    step = make_train_step(None, cfg, lr=0.02)
    args = (scene, cam, cam_s, bounce_s, target)
    start = init_params(scene)
    k0, s0 = counts["pc.kernel.surface"], counts["pc.surface"]
    p_k, loss_k = step(start, *args)
    assert torch.isfinite(loss_k)
    assert counts["pc.kernel.surface"] - k0 == 4
    assert counts["pc.surface"] - s0 == 4
    k0 = counts["pc.kernel.surface"]
    with seam(plain_surface):
        p_a, loss_a = step(start, *args)
        p_b, _ = step(start, *args)
    assert counts["pc.kernel.surface"] == k0
    assert torch.equal(bits(loss_k), bits(loss_a))
    for k, a in p_a.items():
        spread = float((a - p_b[k]).abs().max())
        off = float((p_k[k] - a).abs().max())
        assert off <= 2 * spread + 1e-6 * float(a.abs().max()), k
        assert float((a - start[k]).abs().max()) > 0, k
