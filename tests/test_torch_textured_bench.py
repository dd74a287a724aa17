"""The textured PBR hall of the port's benchmark on the CPU, at a small
size: its frozen inputs equal the port's generator, the plain reference's
fetch, tangent and normal mapping equal the port's, a textured frame of
the port equals the reference (and does not with a map kind unbound in
the program alone), the ``pc.texture.fetch`` span and, on the plain
chain inside it, the ``pc.texture.<kind>`` spans open once a bounce for
each bound kind and never on the untextured hall, the new readers read
them, and the cell runs correct through the harness.

The module imports no jax:

    python -m pytest --noconftest tests/test_torch_textured_bench.py -q
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import (  # noqa: E402
    compare, harness, plugins, program, sampling, scene as bscene,
    texture_maps, trace as btrace)
from bench_port.reference import textured, tracer  # noqa: E402
from bench_port.textured_readings import unbound  # noqa: E402
from prismarine_core_tpu_torch.models.geometry import (  # noqa: E402
    TriangleSoup)
from prismarine_core_tpu_torch.models.textures import (  # noqa: E402
    TextureStack, sample_bilinear)
from prismarine_core_tpu_torch.ops.intersect import Hit  # noqa: E402
from prismarine_core_tpu_torch.render import integrator  # noqa: E402
from prismarine_core_tpu_torch.utils import profiling  # noqa: E402

# the CPU frames are thousands of small ops: one thread runs them fastest
torch.set_num_threads(1)

CPU = torch.device("cpu")
CELL = "hall720-bvh-textured.frames"
SEED = 2 ** 31 + 1907
#: the cell at a size a CPU test holds: a few thousand triangles, 32x32
#: maps, 48x32 pixels, 2 spp, 3 bounces
RENDER = {"width": 48, "height": 32, "spp": 2, "max_bounces": 3}
SCENE = {"target_tris": 3000, "sky_resolution": 16, "texture_resolution": 32}


def small_cell():
    """The cell's workload and configuration at the small size."""
    workload = harness.load_json(harness.HERE / "workloads" / f"{CELL}.json")
    config = harness.load_json(
        harness.HERE / "configs" / f"{workload['config']}.json")
    config["render"].update(RENDER)
    config["scene"].update(SCENE)
    return harness.Cell(CELL, dict(workload, chips=1), config, [], [])


def random_maps(arrays, seed=5):
    """The arrays with every map replaced by seeded uniform texels."""
    rng = np.random.default_rng(seed)
    return dict(arrays, textures=[
        rng.uniform(0.0, 1.0, img.shape).astype(np.float32)
        for img in arrays["textures"]])


@pytest.fixture(scope="module")
def small_hall():
    """(cell, arrays with seeded random maps) of the small cell."""
    cell = small_cell()
    return cell, random_maps(harness.scene_arrays(cell))


# -- the frozen inputs ------------------------------------------------------

def test_frozen_texcoords_and_maps_equal_port():
    """The generator's texcoords are the port's textured hall's, per
    corner, and its noise, albedo and normal-map formulas draw the port's
    maps on the same seed."""
    from prismarine_core_tpu_torch.models.procedural import (
        _procedural_textures, make_hall_scene)
    port = make_hall_scene(target_tris=3000, build_bvh=False, textured=True,
                           texture_resolution=32, device="cpu")
    verts, faces, mids = bscene.hall_mesh(3000, 0)
    soup = TriangleSoup.from_arrays(
        verts, faces, mat_ids=mids,
        texcoords=texture_maps.hall_texcoords(verts), device="cpu")
    for f in ("t0", "t1", "t2"):
        assert torch.equal(getattr(soup, f), getattr(port.triangles, f)), f
    for mine, want in zip(texture_maps.procedural_textures(32, 7),
                          _procedural_textures(32, 7), strict=True):
        assert np.array_equal(mine, want)


def test_pbr_set():
    """Six materials, each binding its own diffuse, specular and bump map;
    the specular maps' G and B in [0.3, 1], R 1; the bump maps unit
    normals facing out of the surface; the same seed, the same maps."""
    images, bindings = texture_maps.pbr_set(32, 0)
    assert len(images) == 18 and len(bindings) == 6
    assert all(img.shape == (32, 32, 3) and img.dtype == np.float32
               for img in images)
    ids = sorted(i for b in bindings for i in b.values())
    assert ids == list(range(18))
    for b in bindings:
        assert set(b) == set(texture_maps.KINDS)
        spec, bump = images[b["tex_specular"]], images[b["tex_bump"]]
        assert np.all(spec[..., 0] == 1.0)
        assert spec[..., 1:].min() >= 0.3 - 1e-6
        assert spec[..., 1:].max() <= 1.0 + 1e-6
        n = bump * 2.0 - 1.0
        assert np.allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)
        assert n[..., 2].min() > 0.0
    again, _ = texture_maps.pbr_set(32, 0)
    assert all(np.array_equal(a, b) for a, b in zip(images, again))
    other, _ = texture_maps.pbr_set(32, 1)
    assert not np.array_equal(images[0], other[0])


# -- the reference's surface against the port's ---------------------------

def fetch_stack(packed):
    """A stack of three textures at their own sizes (32x32, 24x16, 8x8) of
    seeded random RGBA, the port's (packed or not) and the reference's."""
    rng = np.random.default_rng(11)
    images = [rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
              for h, w in ((32, 32), (16, 24), (8, 8))]
    stack = TextureStack.from_images(images, device="cpu")
    if packed:
        stack = stack.with_packed_corners()
    tex, size = textured.texture_stack(images)
    return stack, torch.as_tensor(tex), torch.as_tensor(size)


@pytest.mark.parametrize("packed", [False, True], ids=["data", "quad"])
def test_reference_fetch_equals_port(packed):
    """Bit for bit the port's ``sample_bilinear`` on its ``data`` and its
    corner-packed ``quad`` paths: uv far outside [0, 1] either side, on
    the texel centres and edges, and on the wrap seams."""
    stack, tex, size = fetch_stack(packed)
    g = torch.Generator().manual_seed(3)
    n = 4000
    tid = torch.randint(0, 3, (n,), generator=g, dtype=torch.int32)
    uv = torch.rand((n, 2), generator=g) * 10.0 - 5.0
    edges = torch.tensor([0.0, 1.0, -1.0, 0.5 / 32, -0.5 / 32, 1.0 - 1e-7,
                          -1e-7, 2.0 + 1.0 / 16, 31.5 / 32, -3.0])
    k = edges.shape[0]
    uv[:k * k, 0] = edges.repeat_interleave(k)
    uv[:k * k, 1] = edges.repeat(k)
    got = textured.fetch(tex, size, tid.long(), uv)
    want = sample_bilinear(stack, tid, uv)
    assert torch.equal(got, want)


def test_reference_tangent_and_normal_mapping_equal_port(small_hall):
    """At hits on random triangles at random barycentrics of the small
    hall (the floor given an emission and an emissive map besides), the
    reference's tangent equals the port's field at the hit and its mapped
    shading normal, albedo, roughness, metallic and emission equal the
    port's surface, within 1e-6."""
    cell, arrays = small_hall
    arrays = dict(arrays, materials=(
        dict(arrays["materials"][0], emissive=(2.0, 1.0, 0.5),
             tex_emissive=4),) + arrays["materials"][1:])
    prog = harness.build_program(cell, arrays, CPU)
    ref = textured.build_scene(arrays, CPU)
    g = torch.Generator().manual_seed(9)
    n_tris = ref.base.v0.shape[0]
    r = 3000
    tri = torch.randint(0, n_tris, (r,), generator=g, dtype=torch.int32)
    u = torch.rand(r, generator=g)
    v = torch.rand(r, generator=g) * (1.0 - u)
    hit = Hit(t=torch.ones(r), tri=tri, u=u, v=v)
    kinds = integrator.surface_kinds(prog.scene)
    assert kinds == (True, True, True, True)
    from prismarine_core_tpu_torch.ops.surface import surface_fields_plain
    _, _, _, tang, _ = surface_fields_plain(prog.scene, hit, kinds)
    port = integrator._interpolate_surface(prog.scene, hit, prog.cfg, kinds)

    ti = tri.long()
    assert torch.allclose(ref.tangent[ti], tang, rtol=0, atol=1e-6)
    w = (1.0 - u - v)[:, None]
    ns = tracer.normalize(w * ref.base.n0[ti] + u[:, None] * ref.base.n1[ti]
                          + v[:, None] * ref.base.n2[ti])
    mapped, albedo, alpha, rough, metal, emissive = textured.surface(
        ref, ti, u, v, ns, ref.base.mat[ti])
    for name, mine in (("shading_normal", mapped), ("albedo", albedo),
                       ("alpha", alpha), ("roughness", rough),
                       ("metallic", metal), ("emissive", emissive)):
        assert torch.allclose(mine, port[name], rtol=0, atol=1e-6), name
    # the maps do work here: the mapped normal is not the smooth one, the
    # floor's emission not its material's
    assert (tracer.length(mapped - ns) > 1e-2).float().mean() > 0.5
    floor = ref.base.mat[ti] == 0
    assert floor.any()
    assert not torch.allclose(emissive[floor],
                              ref.base.emissive[0].expand(
                                  int(floor.sum()), 3))


# -- frames ----------------------------------------------------------------

def frame_numbers(cell, arrays, prog, seed=SEED):
    """The check's numbers of one whole frame: the port's image against
    the reference's radiance at every pixel."""
    render = cell.config["render"]
    gen = sampling.generator(CPU, seed, sampling.WINDOW, 0)
    cam_s, bounce_s = sampling.frame_samples(cell.workload["sampling"],
                                             render, gen, CPU)
    img = integrator.render_with_samples(prog.scene, prog.camera, prog.cfg,
                                         cam_s, bounce_s)
    ref = textured.build_scene(arrays, CPU)
    pix = torch.arange(render["width"] * render["height"])
    lanes = tracer.pixel_lanes(render, pix)
    want = textured.render_pixels(ref, textured.scene_index(ref),
                                  cell.config["camera"], render,
                                  cam_s[lanes], bounce_s[:, lanes], pix)
    return compare.frames_numbers(img.reshape(-1, 3), want)


@pytest.mark.parametrize("packed", [False, True], ids=["data", "quad"])
def test_textured_frame_equals_reference(small_hall, packed):
    """A whole 48x32 frame of the port at 2 spp and 3 bounces, its stack
    packed (as the job builds it) or not (the same maps put into the
    built program unpacked), against the reference at every pixel: within
    the cell's per-channel tolerance on no fewer pixels than the cell's
    limit asks."""
    cell, arrays = small_hall
    prog = harness.build_program(cell, arrays, CPU)
    assert prog.scene.textures.quad is not None
    if not packed:
        stack = TextureStack.from_images(
            arrays["textures"],
            resolution=cell.config["scene"]["texture_resolution"],
            device=CPU)
        prog = dataclasses.replace(prog, scene=dataclasses.replace(
            prog.scene, textures=stack))
        assert prog.scene.textures.quad is None
    numbers = frame_numbers(cell, arrays, prog)
    assert numbers["mismatch_share"] <= \
        cell.workload["check"]["limits"]["mismatch_share"], numbers


@pytest.mark.parametrize("kind", ["bump", "diffuse"])
def test_frame_with_a_map_unbound_fails(small_hall, kind):
    """The same comparison with the program's bump (or diffuse) maps
    unbound, the reference's kept: well over the limit."""
    cell, arrays = small_hall
    prog = unbound(harness.build_program(cell, arrays, CPU), kind)
    numbers = frame_numbers(cell, arrays, prog)
    assert numbers["mismatch_share"] > \
        5 * cell.workload["check"]["limits"]["mismatch_share"], numbers


# -- spans ------------------------------------------------------------------

def span_counts(prog):
    """The span entries of one frame of ``prog`` (``profiling.counts``)."""
    cfg = prog.cfg
    gen = torch.Generator().manual_seed(1)
    cam_s = torch.rand((cfg.n_rays, 4), generator=gen)
    bounce_s = torch.rand((cfg.max_bounces, cfg.n_rays, 11), generator=gen)
    before = dict(profiling.counts)
    integrator.render_with_samples(prog.scene, prog.camera, cfg, cam_s,
                                   bounce_s)
    return {k: v - before.get(k, 0) for k, v in profiling.counts.items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize("emissive", [False, True],
                         ids=["pbr", "with_emissive"])
def test_texture_spans_once_a_bounce_for_each_bound_kind(small_hall,
                                                         emissive):
    """A textured frame opens ``pc.texture.fetch`` once a bounce and, on
    the CPU's plain chain inside it, ``pc.texture.<kind>`` once a bounce
    for each kind a material binds and never for another; the untextured
    hall opens none; the textured frame's declared host syncs are the
    untextured one's plus the one ``pc.sync.kinds``."""
    cell, arrays = small_hall
    if emissive:
        arrays = dict(arrays, materials=tuple(
            dict(m, tex_emissive=0) if i == 0 else m
            for i, m in enumerate(arrays["materials"])))
    prog = harness.build_program(cell, arrays, CPU)
    small = dataclasses.replace(prog.cfg, width=16, height=8)
    got = span_counts(dataclasses.replace(prog, cfg=small))
    bounces = small.max_bounces
    bound = {"diffuse", "specular", "bump"} | ({"emissive"} if emissive
                                              else set())
    assert {k: v for k, v in got.items() if k.startswith("pc.texture.")} \
        == {f"pc.texture.{k}": bounces for k in bound | {"fetch"}}
    assert got["pc.surface"] == bounces

    plain = program.build(cell.config, plugins.load("scenes", "hall").arrays(
        cell.config["scene"]), CPU)
    assert plain.scene.textures.stub
    base = span_counts(dataclasses.replace(plain, cfg=small))
    assert not any(k.startswith("pc.texture.") for k in base)
    assert got.get("pc.sync.kinds") == 1 and "pc.sync.kinds" not in base

    def syncs(c):
        return sum(v for k, v in c.items() if k.startswith("pc.sync."))
    assert syncs(got) == syncs(base) + 1


def synthetic_trace(host_ops, launches):
    """A traced frames run of one unit, 0-1000 us, with these main-thread
    host ops and launches."""
    return btrace.Trace(job="textured", units=[(0.0, 1000.0)], ops=[],
                        port_kernels=frozenset(), launches=launches,
                        host_ops=host_ops)


def test_texture_readers():
    """``texture_ms.frame`` and ``texture_launches.frame`` read the
    launches inside the ``pc.texture.*`` spans (the profiler's own events
    left out) of a run of any job, and nothing without them."""
    ms = harness.metric_reader("texture_ms.frame")
    launches = harness.metric_reader("texture_launches.frame")
    host = [("pc.frame", 0.0, 900.0), ("pc.surface", 100.0, 300.0),
            ("pc.texture.bump", 110.0, 150.0), ("aten::mul", 120.0, 121.0),
            ("aten::index_select", 130.0, 131.0),
            ("Buffer Flush", 131.0, 132.0),
            ("pc.texture.diffuse", 160.0, 200.0), ("aten::mul", 170.0, 171.0),
            ("aten::add", 250.0, 251.0)]
    launched = [(120.0, 40.0), (130.0, 60.0), (131.0, 60.0), (170.0, 30.0),
                (250.0, 500.0)]
    tr = synthetic_trace(host, launched)
    assert ms(tr) == pytest.approx(0.13)
    assert launches(tr) == 3.0
    bare = [e for e in host if not e[0].startswith("pc.texture.")]
    for tr in (synthetic_trace(bare, launched),
               synthetic_trace([e for e in host if e[0] != "pc.frame"],
                               launched)):
        assert ms(tr) is None and launches(tr) is None


# -- the cell ---------------------------------------------------------------

def test_cell_resolves_and_runs_correct():
    """The cell as ``BENCHMARK.json`` lists it: one chip, its job's own
    build, the frame metrics and the two texture readers; a short run
    through the harness at the small size, in a process of its own (the
    harness refuses a run whose process has JAX loaded), is correct."""
    listed = harness.load_cell(CELL)
    assert listed.workload["chips"] == 1
    assert listed.workload["job"] == "textured"
    assert {m["name"] for m in listed.end_to_end} == {
        "frame_ms", "frame_ms_p95", "setup_s"}
    assert {"texture_ms.frame", "texture_launches.frame"} <= {
        m["name"] for m in listed.per_layer}
    assert hasattr(harness.job_module(listed), "build")
    code = ("import json, sys, time\n"
            "sys.path[:0] = [%r, %r]\n"
            "import test_torch_textured_bench as t\n"
            "from bench_port import harness\n"
            "r = harness.measure(t.small_cell(), t.CPU, t.SEED, 0.1, False,\n"
            "                    time.perf_counter())\n"
            "print(json.dumps(r))" % (str(ROOT), str(ROOT / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True, result
    assert result["failed"] == 0


def test_new_modules_import_nothing_of_jax_or_the_port():
    """The generator and the reference load neither JAX, the JAX package
    nor the port."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from bench_port import texture_maps, plugins\n"
            "from bench_port.reference import textured\n"
            "plugins.load('scenes', 'hall_textured')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert not set(eval(out)) & {"jax", "jaxlib", "prismarine_core_tpu",
                                 "prismarine_core_tpu_torch"}
