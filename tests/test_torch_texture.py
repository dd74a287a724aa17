"""The texture maps at the hit (``ops/texture.py``, ``csrc/texture.cu``).

On the CPU: the module imports without a card and ``texture_fields`` runs
its plain version there; ``texture_plain`` gives the fields of the chain
it replaces (a verbatim copy of ``_interpolate_surface``'s texture code is
kept here) bit for bit, with and without a size table and corner quads,
with negative and out-of-range ids, uv outside [0, 1) either side, for
every subset of the four kinds, and on the small textured hall under both
filters; the kernel's corner quads are packed once for a stack without
them; the kernel's route through the seam
(``ops/dispatch.py``, a torch emulation of the kernel's arithmetic on the
quads standing in for its launch) gives the plain version's fields and
gradients bit for bit; the bicubic filter and a stack split over a mesh
never reach the launch.

On the card (``gpu``, skipped here): the kernel equals ``texture_plain``
bit for bit at every lane, missed lanes included, on stacks with and
without quads and sizes and on every bounce of a textured frame; a
gradient through ``texture_fields`` equals the plain version's; the kernel
runs once a bounce on the textured hall (and on the carried surface of an
unsharded stack), and never on the stub stack, under the bicubic filter or
on a sharded stack.  This module imports no jax, so on a machine without
the JAX package:

    python -m pytest --noconftest tests/test_torch_texture.py -q
"""

import contextlib
import dataclasses
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from prismarine_core_tpu_torch.models.camera import Camera  # noqa: E402
from prismarine_core_tpu_torch.models.textures import (  # noqa: E402
    TextureStack, sample_bicubic, sample_bilinear)
from prismarine_core_tpu_torch.ops import dispatch  # noqa: E402
from prismarine_core_tpu_torch.ops import texture as tx  # noqa: E402
from prismarine_core_tpu_torch.ops.sampling import make_sample_arrays  # noqa: E402
from prismarine_core_tpu_torch.ops.surface import surface_fields  # noqa: E402
from prismarine_core_tpu_torch.render import integrator as it  # noqa: E402
from prismarine_core_tpu_torch.utils import math as pm  # noqa: E402
from prismarine_core_tpu_torch.utils.config import RenderConfig  # noqa: E402
from prismarine_core_tpu_torch.utils.profiling import counts  # noqa: E402

CPU = "cpu"
#: every non-empty subset of the kinds (diffuse, specular, emissive, bump),
#: as ``kinds_bound`` gives them
SUBSETS = [k for k in itertools.product((False, True), repeat=4) if any(k)]
SUBSET_IDS = ["".join(n for n, b in zip("DSEB", k) if b) for k in SUBSETS]
#: the stack's layouts: dense texels filling the stack (no size table),
#: with a size table, and with the corner-packed quads too
LAYOUTS = ("dense", "sized", "quad")
FIELDS = ("ns", "albedo", "emissive", "roughness", "metallic")


def old_chain(stack, cfg, kinds, ns, tang, uv, mat):
    """``render/integrator.py:_interpolate_surface``'s texture code as it
    was before it moved into ``ops/texture.py``, kept verbatim (less its
    spans) as the reference of the move."""
    albedo4 = mat.diffuse
    rough, metal = mat.specular[:, 1], mat.specular[:, 2]
    emissive = mat.emissive[:, :3]
    sample_tex = (sample_bicubic if cfg.texture_filter == "bicubic"
                  else sample_bilinear)
    if kinds[3]:
        btex = sample_tex(stack, mat.tex_bump, uv)
        bitan = pm.cross(ns, tang)
        nt = btex[:, :3] * 2.0 - 1.0
        n_mapped = pm.normalize(tang * nt[:, 0:1]
                                + bitan * nt[:, 1:2]
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
    return ns, albedo4, emissive, rough, metal


def bits(t):
    """``t``'s values as integers, so NaNs compare by their bits."""
    t = t.detach().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(a, b, what, strides=True):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert not strides or a.stride() == b.stride(), what
    assert torch.equal(bits(a), bits(b)), what


def assert_same_fields(got, want, what="", strides=True):
    for name, a, b in zip(FIELDS, got, want, strict=True):
        assert_same(a, b, f"{what} {name}", strides)


def random_stack(layout, dev, seed=11):
    """Three textures of seeded random RGBA at their own sizes (32x32,
    16x24, 8x8) in ``layout`` (``LAYOUTS``); without a size table each
    fills the stack (the padding is white)."""
    rng = np.random.default_rng(seed)
    images = [rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
              for h, w in ((32, 32), (16, 24), (8, 8))]
    stack = TextureStack.from_images(images, device=dev)
    if layout == "dense":
        stack = dataclasses.replace(stack, sizes=None)
    elif layout == "quad":
        stack = stack.with_packed_corners()
    return stack


#: uv values on the seams, texel centres and edges, and just off them
EDGES = (0.0, 1.0, -1.0, 2.0, -2.5, 0.5 / 32, -0.5 / 32, 1.0 - 1e-7,
         -1e-9, 1e-9, 0.5, 1.0 / 24, 1.0 / 16, -7.0 / 8)


def random_fields(n, n_tex, dev, seed=3):
    """(ns, tang, uv, mat) at ``n`` random hits: unit normals and
    tangents, uv far outside [0, 1) either side and on ``EDGES``, the
    material's rows, and texture ids from -3 to two past the stack (a
    quarter of them negative, the ones past the stack clamped by the
    fetch)."""
    g = torch.Generator().manual_seed(seed)

    def unit():
        v = torch.randn((n, 3), generator=g)
        return v / v.norm(dim=-1, keepdim=True)
    uv = torch.rand((n, 2), generator=g) * 12.0 - 6.0
    e = torch.tensor(EDGES)
    k = min(n, len(EDGES) ** 2)
    uv[:k] = torch.stack(torch.meshgrid(e, e, indexing="ij"),
                         -1).reshape(-1, 2)[:k]

    def ids():
        t = torch.randint(0, n_tex + 2, (n,), generator=g, dtype=torch.int32)
        neg = torch.randint(-3, 0, (n,), generator=g, dtype=torch.int32)
        return torch.where(torch.rand(n, generator=g) < 0.25, neg, t)
    mat = types.SimpleNamespace(
        diffuse=torch.rand((n, 4), generator=g),
        specular=torch.rand((n, 4), generator=g),
        emissive=torch.rand((n, 4), generator=g) * 2.0,
        tex_diffuse=ids(), tex_specular=ids(), tex_emissive=ids(),
        tex_bump=ids())
    mat = types.SimpleNamespace(**{k: v.to(dev) for k, v in
                                   vars(mat).items()})
    return unit().to(dev), unit().to(dev), uv.to(dev), mat


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


def is_texture(launch):
    return getattr(launch, "func", None) is tx.launch_texture


def emulate_kernel(kinds, sized, packed, *xs):
    """``csrc/texture.cu`` in torch: each lane's fields with the kernel's
    arithmetic, its four texels read from one row of the stack's corner
    quads (``with_packed_corners``), remainders as fmod plus the divisor;
    new tensors of the launch's shapes."""
    ns, tang, uv, mat, stack = tx._inputs(kinds, sized, packed,
                                          [x.detach() for x in xs])
    n, h, w, _ = stack.data.shape
    rows = stack.with_packed_corners().quad.reshape(-1, 16)

    def wrap(a, b):
        r = torch.fmod(a, b)
        return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)

    def fetch(ids):
        tid = torch.clamp(ids, 0, n - 1).long()
        if stack.sizes is None:
            wi = torch.full(tid.shape, w, dtype=torch.int32)
            hi = torch.full(tid.shape, h, dtype=torch.int32)
        else:
            wi, hi = stack.sizes[tid, 0], stack.sizes[tid, 1]
        x = wrap(uv[:, 0], torch.tensor(1.0)) * wi.float() - 0.5
        y = wrap(uv[:, 1], torch.tensor(1.0)) * hi.float() - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        x0i, y0i = wrap(x0.int(), wi), wrap(y0.int(), hi)
        q = rows[(tid * h + y0i.long()) * w + x0i.long()]
        fx, fy = (x - x0)[:, None], (y - y0)[:, None]
        gx, gy = 1.0 - fx, 1.0 - fy
        return ((q[:, 0:4] * gx + q[:, 4:8] * fx) * gy
                + (q[:, 8:12] * gx + q[:, 12:16] * fx) * fy)
    outs = [None] * 5
    if kinds[3]:
        c = fetch(mat.tex_bump)
        nt = c[:, :3] * 2.0 - 1.0
        b = torch.stack([ns[:, 1] * tang[:, 2] - ns[:, 2] * tang[:, 1],
                         ns[:, 2] * tang[:, 0] - ns[:, 0] * tang[:, 2],
                         ns[:, 0] * tang[:, 1] - ns[:, 1] * tang[:, 0]], -1)
        v = (tang * nt[:, 0:1] + b * nt[:, 1:2]) + ns * nt[:, 2:3]
        dd = (v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2]
        mapped = v / torch.sqrt(torch.clamp(dd, min=1e-30))[:, None]
        outs[0] = torch.where((mat.tex_bump >= 0)[:, None], mapped, ns)
    if kinds[0]:
        c = fetch(mat.tex_diffuse)
        outs[1] = torch.where((mat.tex_diffuse >= 0)[:, None],
                              mat.diffuse * c, mat.diffuse)
    if kinds[2]:
        c = fetch(mat.tex_emissive)
        e = mat.emissive[:, :3].contiguous()
        outs[2] = torch.where((mat.tex_emissive >= 0)[:, None],
                              e * c[:, :3], e)
    if kinds[1]:
        c = fetch(mat.tex_specular)
        has = mat.tex_specular >= 0
        sp = mat.specular
        outs[3] = torch.where(has, sp[:, 1] * c[:, 1], sp[:, 1])
        outs[4] = torch.where(has, sp[:, 2] * c[:, 2], sp[:, 2])
    return tuple(outs)


def emulated_texture(x, launch, plain, choose):
    """A ``seam`` choice: the texture launch, on any device, stood in for
    by the kernel's torch emulation (``emulate_kernel``), counted as the
    launch's span counts it."""
    if is_texture(launch):
        def run(*xs):
            counts["emulated texture"] += 1
            return emulate_kernel(*launch.args, *xs)
        return run
    return choose(x, launch, plain)


def plain_texture(x, launch, plain, choose):
    """A ``seam`` choice: the texture maps on their plain version."""
    return plain if is_texture(launch) else choose(x, launch, plain)


CHAIN_CFG = RenderConfig(width=4, height=4)

# ---------------------------------------------------------------- CPU


def test_module_imports_without_a_card():
    """ops/texture.py imports and runs its plain version on CPU tensors
    without building or loading the kernel library."""
    from prismarine_core_tpu_torch import _build
    stack = random_stack("quad", CPU)
    ns, tang, uv, mat = random_fields(64, stack.count, CPU)
    kinds = (True, True, True, True)
    before = counts["pc.kernel.texture"]
    got = tx.texture_fields(stack, "bilinear", kinds, ns, tang, uv, mat)
    assert counts["pc.kernel.texture"] == before
    assert_same_fields(got, old_chain(stack, CHAIN_CFG, kinds, ns, tang, uv,
                                      mat))
    assert _build.CSRC.joinpath("texture.cu").is_file()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kinds", SUBSETS, ids=SUBSET_IDS)
def test_texture_plain_is_the_chain_it_replaces(kinds, layout):
    """``texture_plain`` and ``texture_fields`` on the CPU give the old
    chain's fields bit for bit, layouts included, and open one
    ``pc.texture.<kind>`` span for each bound kind and none for another:
    negative ids, ids past the stack, uv far outside [0, 1) and on its
    seams."""
    stack = random_stack(layout, CPU)
    ns, tang, uv, mat = random_fields(3000, stack.count, CPU)
    want = old_chain(stack, CHAIN_CFG, kinds, ns, tang, uv, mat)
    before = dict(counts)
    got = tx.texture_plain(stack, "bilinear", kinds, ns, tang, uv, mat)
    spans = {k: v - before.get(k, 0) for k, v in counts.items()
             if k.startswith("pc.texture.") and v != before.get(k, 0)}
    assert spans == {f"pc.texture.{n}": 1 for n, b in zip(
        ("diffuse", "specular", "emissive", "bump"), kinds) if b}
    assert_same_fields(got, want, "texture_plain")
    assert_same_fields(tx.texture_fields(stack, "bilinear", kinds, ns, tang,
                                         uv, mat), want, "texture_fields")
    assert (mat.tex_bump < 0).any() and (mat.tex_bump > 2).any()


def _small_textured_hall():
    from prismarine_core_tpu_torch.models.procedural import make_hall_scene
    return make_hall_scene(target_tris=3000, textured=True,
                           texture_resolution=32, build_bvh=False,
                           device=CPU)


def _hall_hits(scene, n, seed):
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


@pytest.mark.parametrize("texture_filter", ["bilinear", "bicubic"])
def test_texture_plain_on_the_small_textured_hall(texture_filter):
    """The small textured hall's hits (missed lanes included), its
    diffuse and bump maps bound: ``texture_plain`` and ``texture_fields``
    give the old chain's fields bit for bit under both filters, and the
    bicubic filter never reaches the launch."""
    scene = _small_textured_hall()
    hit = _hall_hits(scene, 400, 2)
    kinds = scene.materials.kinds_bound
    assert kinds[0] and kinds[3] and (hit.tri < 0).any()
    ns, _, uv, tang, mat = surface_fields(scene, hit, kinds)
    cfg = RenderConfig(width=4, height=4, texture_filter=texture_filter)
    want = old_chain(scene.textures, cfg, kinds, ns, tang, uv, mat)
    assert_same_fields(tx.texture_plain(scene.textures, texture_filter,
                                        kinds, ns, tang, uv, mat), want)
    before = counts["emulated texture"]
    with seam(emulated_texture):
        got = tx.texture_fields(scene.textures, texture_filter, kinds, ns,
                                tang, uv, mat)
    bilinear = texture_filter == "bilinear"
    assert counts["emulated texture"] - before == int(bilinear)
    assert_same_fields(got, want, strides=not bilinear)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kinds", [(True, True, True, True),
                                   (False, True, False, True),
                                   (True, False, True, False)],
                         ids=["DSEB", "SB", "DE"])
def test_kernel_route_through_the_seam(kinds, layout):
    """The kernel's route through the seam, its torch emulation as the
    launch: the plain version's fields bit for bit, each differentiable
    exactly where the plain version's is, and the plain version's
    gradient of a weighted sum of the fields with respect to ns, the
    tangent, uv, the material's rows and the texels (the backward
    differentiates the plain version run again)."""
    stack = random_stack(layout, CPU)
    ns, tang, uv, mat = random_fields(2000, stack.count, CPU)
    data = stack.data.clone().requires_grad_(True)
    stack = dataclasses.replace(stack, data=data)
    leaves = [ns, tang, uv, mat.diffuse, mat.specular, mat.emissive]
    for t in leaves:
        t.requires_grad_(True)
    before = counts["emulated texture"]
    with seam(emulated_texture):
        got = tx.texture_fields(stack, "bilinear", kinds, ns, tang, uv, mat)
    assert counts["emulated texture"] - before == 1
    want = tx.texture_plain(stack, "bilinear", kinds, ns, tang, uv, mat)
    assert_same_fields(got, want, strides=False)
    for name, a, b in zip(FIELDS, got, want):
        assert a.requires_grad == b.requires_grad, name
    gen = torch.Generator().manual_seed(9)
    weights = [torch.rand(x.shape, generator=gen) for x in want]

    def weighted(fields):
        return sum((x * wt).sum() for x, wt in zip(fields, weights))
    wanted = leaves + [data]
    g_got = torch.autograd.grad(weighted(got), wanted, allow_unused=True)
    g_want = torch.autograd.grad(weighted(want), wanted, allow_unused=True)
    for a, b in zip(g_got, g_want):
        assert (a is None) == (b is None)
        if b is not None:
            assert torch.equal(bits(a), bits(b))
    # the texels' gradient flows where the fetch reads them (the quads,
    # built from them once, hold none)
    assert (g_want[-1] is None) == (layout == "quad")
    assert layout == "quad" or g_want[-1].abs().sum() > 0


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kinds", SUBSETS, ids=SUBSET_IDS)
def test_emulated_kernel_is_the_plain_version(kinds, layout):
    """The kernel's arithmetic (``emulate_kernel``: one quad row a fetch,
    fmod-based wrap) gives ``texture_plain``'s fields bit for bit on
    every subset of the kinds and every layout: the quads hold the dense
    texels' values, and fmod plus the divisor is ``torch.remainder``."""
    stack = random_stack(layout, CPU)
    ns, tang, uv, mat = random_fields(3000, stack.count, CPU, seed=5)
    xs = tx._tensors(stack, ns, tang, uv, mat, kinds)
    args = (kinds, stack.sizes is not None, stack.quad is not None)
    got = emulate_kernel(*args, *xs)
    want = tx._texture_plain(*args, *xs)
    for name, a, b in zip(FIELDS, got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            assert_same(a, b, name, strides=False)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_quads_packed_once_for_a_stack_without_them(layout):
    """The kernel's quads (``_quads_of``): the stack's own where it has
    them; else ``with_packed_corners``' packed at the first call, kept
    while the texels are unchanged, and packed anew after an in-place
    edit of them."""
    stack = random_stack(layout, CPU)
    first = tx._quads_of(stack)
    if layout == "quad":
        assert first is stack.quad
        return
    assert torch.equal(bits(first), bits(stack.with_packed_corners().quad))
    assert tx._quads_of(stack) is first
    with torch.no_grad():
        stack.data[0, 0, 0, 0] += 1.0
    again = tx._quads_of(stack)
    assert again is not first and again[0, 0, 0, 0] == first[0, 0, 0, 0] + 1


def test_sharded_stack_keeps_the_plain_version():
    """A stack split over a mesh (two CPU devices on the "model" axis)
    fetches shard by shard through ``texture_plain`` and never reaches
    the launch: the single-device fields bit for bit."""
    from prismarine_core_tpu_torch.parallel.mesh import make_mesh
    from prismarine_core_tpu_torch.parallel.shard_intersect import (
        distribute_scene)
    from prismarine_core_tpu_torch.models.procedural import make_hall_scene
    scene = make_hall_scene(target_tris=3000, textured=True,
                            texture_resolution=32, device=CPU)
    mesh = make_mesh(2, model_parallel=2, devices=[CPU] * 2)
    dscene = distribute_scene(scene, mesh, shard_soup=False)
    assert dscene.textures.mesh is not None
    hit = _hall_hits(scene, 300, 4)
    kinds = scene.materials.kinds_bound
    ns, _, uv, tang, mat = surface_fields(scene, hit, kinds)
    want = tx.texture_plain(scene.textures, "bilinear", kinds, ns, tang, uv,
                            mat)
    before = counts["emulated texture"]
    with seam(emulated_texture):
        got = tx.texture_fields(dscene.textures, "bilinear", kinds, ns,
                                tang, uv, mat)
    assert counts["emulated texture"] == before
    assert_same_fields(got, want)


# ---------------------------------------------------------------- card


@pytest.fixture(scope="module")
def cuda_device():
    """The first CUDA card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kinds", SUBSETS, ids=SUBSET_IDS)
def test_kernel_equals_plain_on_random_fetches(cuda_device, kinds, layout):
    """200,000 random lanes (negative ids, ids past the stack, uv far
    outside [0, 1) and on its seams): the kernel's fields are
    ``texture_plain``'s bit for bit, from one launch."""
    stack = random_stack(layout, cuda_device)
    ns, tang, uv, mat = random_fields(200_000, stack.count, cuda_device)
    before = counts["pc.kernel.texture"]
    got = tx.texture_fields(stack, "bilinear", kinds, ns, tang, uv, mat)
    torch.cuda.synchronize()
    assert counts["pc.kernel.texture"] - before == 1
    want = tx.texture_plain(stack, "bilinear", kinds, ns, tang, uv, mat)
    assert_same_fields(got, want, layout, strides=False)


@pytest.fixture(scope="module")
def textured_hall(cuda_device):
    """bench.py's textured hall at 20,000 triangles and 128^2 maps, with
    a specular and an emissive binding added to two materials, a camera
    and a 320x180 4-bounce configuration."""
    from prismarine_core_tpu_torch.models.procedural import make_hall_scene
    scene = make_hall_scene(target_tris=20_000, textured=True,
                            texture_resolution=128, device=cuda_device)
    mats = scene.materials
    spec, emis = mats.tex_specular.clone(), mats.tex_emissive.clone()
    spec[0], emis[1] = 0, 1
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        mats, tex_specular=spec, tex_emissive=emis))
    cam = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                         fov_y_deg=60.0, device=cuda_device)
    cfg = RenderConfig(width=320, height=180, spp=1, max_bounces=4,
                       intersector="bvh", bvh_leaf_size=4)
    samples = make_sample_arrays(
        torch.Generator(device=cuda_device).manual_seed(3), cfg.n_rays,
        cfg.max_bounces)
    return scene, cam, cfg, samples


@contextlib.contextmanager
def compared_launches():
    """Each texture launch's fields with the plain version's on the same
    inputs beside them."""
    seen = []

    def pick(x, launch, plain, choose):
        run = choose(x, launch, plain)
        if not is_texture(launch):
            return run

        def recorded(*xs):
            out = run(*xs)
            seen.append((xs, out, plain(*xs)))
            return out
        return recorded
    with seam(pick):
        yield seen


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["quad", "sized", "dense"])
def test_kernel_equals_plain_on_the_textured_halls_bounces(textured_hall,
                                                           layout):
    """Every bounce of a textured frame (missed and dead lanes included;
    the hall's corner-packed stack, the same without its quads, and
    without its size table too): the kernel's fields are the plain
    version's bit for bit, and the frame is the plain frame's."""
    scene, cam, cfg, samples = textured_hall
    stack = scene.textures
    if layout != "quad":
        stack = dataclasses.replace(stack, quad=None)
    if layout == "dense":
        stack = dataclasses.replace(stack, sizes=None)
    scene = dataclasses.replace(scene, textures=stack)
    assert scene.materials.kinds_bound == (True, True, True, True)
    with compared_launches() as seen:
        img = it.render_with_samples(scene, cam, cfg, *samples)
    torch.cuda.synchronize()
    assert len(seen) == cfg.max_bounces
    for b, (xs, got, want) in enumerate(seen):
        assert xs[0].shape[0] == cfg.n_rays
        for name, a, w in zip(FIELDS, got, want):
            assert_same(a, w, f"bounce {b + 1} {name}", strides=False)
    with seam(plain_texture):
        img_plain = it.render_with_samples(scene, cam, cfg, *samples)
    assert torch.equal(bits(img), bits(img_plain))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["quad", "dense"])
def test_gradient_through_the_kernel_is_the_plains(cuda_device, layout):
    """A gradient through ``texture_fields`` on the card (the kernel in
    the forward, once) with respect to ns, the tangent, uv, the material's
    rows and the texels equals the plain version's bit for bit."""
    stack = random_stack(layout, cuda_device)
    data = stack.data.clone().requires_grad_(True)
    stack = dataclasses.replace(stack, data=data)
    ns, tang, uv, mat = random_fields(50_000, stack.count, cuda_device)
    leaves = [ns, tang, uv, mat.diffuse, mat.specular, mat.emissive, data]
    for t in leaves:
        t.requires_grad_(True)
    kinds = (True, True, True, True)
    before = counts["pc.kernel.texture"]
    got = tx.texture_fields(stack, "bilinear", kinds, ns, tang, uv, mat)
    assert counts["pc.kernel.texture"] - before == 1
    want = tx.texture_plain(stack, "bilinear", kinds, ns, tang, uv, mat)
    assert_same_fields(got, want, strides=False)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    weights = [torch.rand(x.shape, generator=gen, device=cuda_device)
               for x in want]

    def weighted(fields):
        return sum((x * wt).sum() for x, wt in zip(fields, weights))
    g_got = torch.autograd.grad(weighted(got), leaves, allow_unused=True)
    g_want = torch.autograd.grad(weighted(want), leaves, allow_unused=True)
    # the texels' gradient flows where the fetch reads them (the quads,
    # built from them once, hold none)
    assert (g_want[-1] is None) == (layout == "quad")
    for x, a, b in zip(("ns", "tang", "uv", "diffuse", "specular",
                        "emissive", "data"), g_got, g_want):
        assert (a is None) == (b is None), x
        if b is None:
            continue
        if x == "data":
            # the texels' gradient scatter-adds with atomics on the card
            assert torch.allclose(a, b, rtol=1e-5, atol=1e-6), x
        else:
            assert torch.equal(bits(a), bits(b)), x


def _mesh_scene(scene, shard_textures):
    from prismarine_core_tpu_torch.parallel.mesh import make_mesh
    from prismarine_core_tpu_torch.parallel.shard_intersect import (
        distribute_scene)
    dev = scene.triangles.v0.device
    mesh = make_mesh(2, model_parallel=2, devices=[dev] * 2)
    return distribute_scene(scene, mesh, shard_textures=shard_textures), mesh


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["textured", "stub", "bicubic", "sharded",
                                  "carried"])
def test_kernel_launches_once_a_bounce(textured_hall, case):
    """``counts["pc.kernel.texture"]``: once a bounce on the textured
    hall, as many as ``pc.surface`` spans, and on the carried surface of
    an unsharded stack ("pallas_sharded", textures whole); never on the
    stub stack, under the bicubic filter, or on a stack split over the
    mesh.  Each frame equals the one with the plain version."""
    from prismarine_core_tpu_torch.models.textures import TextureStack as TS
    scene, cam, cfg, samples = textured_hall
    if case == "stub":
        scene = dataclasses.replace(scene, textures=TS.empty(
            device=cam.eye.device))
        mats = scene.materials
        scene = dataclasses.replace(scene, materials=dataclasses.replace(
            mats, **{f: torch.full_like(getattr(mats, f), -1) for f in
                     ("tex_diffuse", "tex_specular", "tex_emissive",
                      "tex_bump")}))
    elif case == "bicubic":
        cfg = cfg.replace(texture_filter="bicubic")
    elif case in ("sharded", "carried"):
        scene, mesh = _mesh_scene(scene, shard_textures=case == "sharded")
        cfg = cfg.replace(intersector="pallas_sharded", mesh=mesh)
    k0, s0, f0 = (counts["pc.kernel.texture"], counts["pc.surface"],
                  counts["pc.texture.fetch"])
    img = it.render_with_samples(scene, cam, cfg, *samples)
    torch.cuda.synchronize()
    launches = counts["pc.kernel.texture"] - k0
    assert counts["pc.surface"] - s0 == cfg.max_bounces
    fetches = counts["pc.texture.fetch"] - f0
    engaged = case in ("textured", "carried")
    assert launches == (cfg.max_bounces if engaged else 0)
    assert fetches == (0 if case == "stub" else cfg.max_bounces)
    with seam(plain_texture):
        img_plain = it.render_with_samples(scene, cam, cfg, *samples)
    assert torch.equal(bits(img), bits(img_plain))
