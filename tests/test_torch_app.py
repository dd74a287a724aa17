"""The port's application layer against the JAX package's, on the CPU.

Image writers (``tonemap`` equal, the HDR file byte-identical, the PNG's
pixels identical), profiling helpers, the soup helpers ``from_corners`` /
``concatenate`` (exact) and ``transformed`` (rtol/atol 1e-6), the
sun-plane and teapot scenes (every array, the BVH and the packet set
bit-identical), the native OBJ parser (the same C++ source: exact), the
OBJ and glTF loaders (soups and material tables exact, node-transformed
arrays within 1e-6), checkpoints (2 + 2 frames through save/load
bit-identical to 4 straight), the progressive renderer (the accumulator,
weights and image within 1 ulp of JAX's on the same frames, and equal bit
for bit to sequential ``render_with_samples`` on a cloned generator), and
the CLI (subprocesses on the CPU whose .npy equals the renderer's
snapshot; every packet-path flag of the JAX CLI renders, its image
within the image gate of the default flags' image).
"""

import dataclasses
import json
import os
import struct
import subprocess
import sys
import types
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu import native as jnative  # noqa: E402
from prismarine_core_tpu.models import geometry as jgeo  # noqa: E402
from prismarine_core_tpu.models import gltf_loader as jgltf  # noqa: E402
from prismarine_core_tpu.models import obj_loader as jobj  # noqa: E402
from prismarine_core_tpu.models import procedural as jproc  # noqa: E402
from prismarine_core_tpu.models import scene as jscene  # noqa: E402
from prismarine_core_tpu.render import pipeline as jpipe  # noqa: E402
from prismarine_core_tpu.utils import config as jconfig  # noqa: E402
from prismarine_core_tpu.utils import image as jimage  # noqa: E402
from prismarine_core_tpu_torch import interop, native  # noqa: E402
from prismarine_core_tpu_torch.models import geometry as tgeo  # noqa: E402
from prismarine_core_tpu_torch.models import gltf_loader as tgltf  # noqa: E402
from prismarine_core_tpu_torch.models import obj_loader as tobj  # noqa: E402
from prismarine_core_tpu_torch.models import procedural as tproc  # noqa: E402
from prismarine_core_tpu_torch.models import scene as tscene  # noqa: E402
from prismarine_core_tpu_torch.models.camera import Camera  # noqa: E402
from prismarine_core_tpu_torch.ops.sampling import (  # noqa: E402
    make_sample_arrays)
from prismarine_core_tpu_torch.render import pipeline as tpipe  # noqa: E402
from prismarine_core_tpu_torch.render.integrator import (  # noqa: E402
    render_with_samples)
from prismarine_core_tpu_torch.utils import checkpoint  # noqa: E402
from prismarine_core_tpu_torch.utils import image as timage  # noqa: E402
from prismarine_core_tpu_torch.utils import profiling  # noqa: E402
from prismarine_core_tpu_torch.utils.config import RenderConfig  # noqa: E402
from tests.test_gltf import _make_gltf  # noqa: E402
from tests.test_io_scene import _write_obj  # noqa: E402
from tests.test_torch_render import assert_image_parity  # noqa: E402
from tests.test_torch_scene import (  # noqa: E402
    assert_dataclass_equal, jax_scene_arrays)

torch.set_num_threads(1)
CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
SOUP_FIELDS = [f.name for f in dataclasses.fields(tgeo.TriangleSoup)]


def _hdr_image(seed=0, shape=(12, 20, 3)):
    """Radiance across decades, with black, saturated and tiny pixels."""
    rng = np.random.default_rng(seed)
    img = (rng.uniform(0, 1, shape) ** 3 * 40).astype(np.float32)
    img[0, 0] = 0.0
    img[0, 1] = 1e-31
    img[1, :3] = (5.0, 0.5, 0.0)
    return img


def _png_pixels(data: bytes) -> np.ndarray:
    """The RGB pixels of an 8-bit, filter-0 RGB PNG (the port's own
    layout), read without an image library."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == \
            zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    assert (depth, ctype, interlace) == (8, 2, 0)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (rows[:, 0] == 0).all()               # filter 0 on every row
    return rows[:, 1:].reshape(h, w, 3)


def test_image_writers_match_jax(tmp_path):
    img = _hdr_image()
    np.testing.assert_array_equal(timage.tonemap(img, 1.7),
                                  jimage.tonemap(img, 1.7))
    timage.save_hdr(str(tmp_path / "t.hdr"), torch.tensor(img))
    jimage.save_hdr(str(tmp_path / "j.hdr"), img)
    assert ((tmp_path / "t.hdr").read_bytes()
            == (tmp_path / "j.hdr").read_bytes())
    np.testing.assert_array_equal(timage.load_hdr(str(tmp_path / "t.hdr")),
                                  jimage.load_hdr(str(tmp_path / "j.hdr")))
    timage.save_png(str(tmp_path / "t.png"), img)
    port_px = _png_pixels((tmp_path / "t.png").read_bytes())
    np.testing.assert_array_equal(port_px, jimage.tonemap(img))
    timage.save_npy(str(tmp_path / "t.npy"), torch.tensor(img))
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), img)
    try:
        from PIL import Image
    except ImportError:
        return                   # the decoder's cross-check needs Pillow
    jimage.save_png(str(tmp_path / "j.png"), img)
    with Image.open(tmp_path / "t.png") as a, \
            Image.open(tmp_path / "j.png") as b:
        assert a.mode == b.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_profiling_helpers(tmp_path):
    x = torch.ones(8)
    assert profiling.time_fn(torch.add, x, x, warmup=1, iters=2) > 0
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("pc.test"):
            torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert "pc.test" in {e.get("name") for e in events["traceEvents"]}


def test_time_fn_calls_and_waits_for_dataclass_results():
    """``time_fn``: ``warmup`` + ``iters`` calls, each result waited for,
    the tensors of a dataclass result (a BVH, a packet set) included."""
    @dataclasses.dataclass
    class Boxes:
        lo: torch.Tensor
        hi: tuple
        n: int

    calls = []

    def build():
        calls.append(1)
        return Boxes(torch.zeros(3), (torch.ones(2), {"k": torch.ones(1)}),
                     3)

    assert [t.numel() for t in profiling._tensors(build())] == [3, 2, 1]
    calls.clear()
    assert profiling.time_fn(build, warmup=2, iters=3) > 0
    assert len(calls) == 5
    profiling.wait_for(build())          # CPU tensors: nothing to wait for


def _jsoup(seed, n=7, capacity=9):
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(n + 2, 3)).astype(np.float32)
    faces = np.stack([np.arange(n), np.arange(n) + 1, np.arange(n) + 2], 1)
    uv = rng.random((n + 2, 2)).astype(np.float32)
    return jgeo.TriangleSoup.from_arrays(
        verts, faces, texcoords=uv, mat_ids=np.arange(n) % 3,
        capacity=capacity)


def _assert_soup(port, ref, close=()):
    for f in SOUP_FIELDS:
        got, want = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert got.shape == want.shape, f
        if f in close:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)


def test_soup_helpers_match_jax():
    rng = np.random.default_rng(1)
    n = 5
    corners = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(6)]
    corners += [rng.random((n, 2)).astype(np.float32) for _ in range(3)]
    mids = rng.integers(0, 4, n).astype(np.int32)
    _assert_soup(tgeo.TriangleSoup.from_corners(*corners, mids, capacity=8,
                                                device=CPU),
                 jgeo.TriangleSoup.from_corners(*corners, mids, capacity=8))

    ja, jb = _jsoup(2), _jsoup(3, n=4, capacity=4)
    ta, tb = (tgeo.TriangleSoup(**{f: torch.tensor(np.asarray(getattr(s, f)))
                                   for f in SOUP_FIELDS}) for s in (ja, jb))
    _assert_soup(tgeo.TriangleSoup.concatenate([ta, tb]),
                 jgeo.TriangleSoup.concatenate([ja, jb]))

    c, s = np.cos(0.7), np.sin(0.7)
    m = np.array([[2 * c, -s, 0, 1.5], [2 * s, c, 0, -0.5],
                  [0, 0, 0.5, 3.0], [0, 0, 0, 1]])
    _assert_soup(ta.transformed(m), ja.transformed(jnp.asarray(m)),
                 close=("v0", "v1", "v2", "n0", "n1", "n2"))


@pytest.mark.parametrize("name", ["sunplane", "teapot"])
def test_scene_arrays_match_jax(name):
    """Every array of the scene, its BVH and packet set, bit for bit."""
    if name == "sunplane":
        js = jscene.make_sun_plane_scene()
        ts = tscene.make_sun_plane_scene(device=CPU)
    else:
        js = jproc.make_teapot_scene()
        ts = tproc.make_teapot_scene(device=CPU)
    want, got = jax_scene_arrays(js), interop.scene_to_numpy(ts)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype),
                                      err_msg=k)


def test_native_parser_matches_jax(tmp_path, monkeypatch):
    path = os.path.abspath(_write_obj(tmp_path))
    got = native.parse_obj_native(path)
    want = jnative.parse_obj_native(path)
    if want is None:
        pytest.skip("the JAX package's native parser did not build")
    assert native.library_path().parent == ROOT / "build" / "torch_native"
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k

    # a required native parse raises when the library is unavailable;
    # the default falls back to the Python parser
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SRC", tmp_path / "missing.cc")
    with pytest.raises(RuntimeError, match="native parser"):
        tobj.load_obj(path, use_native=True, device=CPU)
    assert native.get_lib() is None
    soup, _, _ = tobj.load_obj(path, device=CPU)
    assert int(soup.num_valid()) == 3


def _assert_tables(port, ref):
    soup, mats, tex = port
    jsoup, jmats, jtex = ref
    _assert_soup(soup, jsoup)
    assert_dataclass_equal(mats, jmats, "materials")
    np.testing.assert_array_equal(tex.data.numpy(), np.asarray(jtex.data))


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
def test_load_obj_matches_jax(tmp_path, use_native):
    path = str(_write_obj(tmp_path))
    ref = jobj.load_obj(path, scale=2.0, capacity=5, use_native=use_native)
    _assert_tables(tobj.load_obj(path, scale=2.0, capacity=5,
                                 use_native=use_native, device=CPU), ref)
    empty = tmp_path / "empty.obj"
    empty.write_text("v 0 0 0\n")
    with pytest.raises(ValueError, match="no faces"):
        tobj.load_obj(str(empty), use_native=use_native, device=CPU)


def _posed_gltf(tmp_path):
    """tests/test_gltf.py's quad under a parent node (TRS with a rotation
    and a non-uniform scale) and a child node (matrix)."""
    p = _make_gltf(tmp_path)
    g = json.loads(p.read_text())
    q = np.array([0.2, 0.5, -0.1, 0.8])
    q /= np.linalg.norm(q)
    m = np.eye(4)
    m[:3, 3] = (0.5, -1.0, 2.0)
    m[0, 1] = 0.3
    g["nodes"] = [{"rotation": q.tolist(), "scale": [1.5, 0.5, 2.0],
                   "translation": [1.0, 2.0, 3.0], "children": [1]},
                  {"mesh": 0, "matrix": m.T.reshape(-1).tolist()}]
    out = tmp_path / "posed.gltf"
    out.write_text(json.dumps(g))
    return out


@pytest.mark.parametrize("kind", ["gltf", "glb", "posed"])
def test_load_gltf_matches_jax(tmp_path, kind):
    path = str(_posed_gltf(tmp_path) if kind == "posed"
               else _make_gltf(tmp_path, glb=kind == "glb"))
    soup, mats, tex = tgltf.load_gltf(path, scale=2.0, device=CPU)
    jsoup, jmats, jtex = jgltf.load_gltf(path, scale=2.0)
    _assert_soup(soup, jsoup, close=("v0", "v1", "v2", "n0", "n1", "n2"))
    assert_dataclass_equal(mats, jmats, "materials")
    np.testing.assert_array_equal(tex.data.numpy(), np.asarray(jtex.data))


# -- the progressive renderer ----------------------------------------------

H, W = 6, 8


def _fake_frames(n, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.random((H, W, 3)) * 2).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("lock", [0, 4])
@pytest.mark.parametrize("interlace", [False, True])
def test_pipeline_accumulation_matches_jax(monkeypatch, interlace, lock):
    """Both renderers fed the same frames: accumulator, weights and image
    within 1 ulp (rtol 1e-6), through a camera move's clear."""
    frames = _fake_frames(7)
    calls = {"jax": 0, "port": 0}

    def fake(key, wrap):
        def render(scene, camera, cfg, rng, interlace_stage=0):
            f = frames[calls[key]]
            calls[key] += 1
            return wrap(f)
        return render
    monkeypatch.setattr(jpipe, "render", fake("jax", jnp.asarray))
    monkeypatch.setattr(tpipe, "render", fake("port", torch.tensor))
    kw = dict(width=W, height=H, interlace=interlace, samples_lock=lock)
    jr = jpipe.ProgressiveRenderer(None, None,
                                   jconfig.RenderConfig(**kw), seed=0)
    tr = tpipe.ProgressiveRenderer(types.SimpleNamespace(device=CPU), None,
                                   RenderConfig(**kw), seed=0)
    for i in range(7):
        if i == 4:                      # a camera move clears both
            jr.camera = "moved"
            tr.camera = "moved"
            assert tr.sample_count == 0 and not tr._accum.any()
        ji, ti = jr.step(), tr.step()
        for a, b in ((ti, ji), (tr._accum, jr._accum),
                     (tr._weight, jr._weight)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=0)
    np.testing.assert_allclose(tr.snapshot(), jr.snapshot(), rtol=1e-6)
    assert tr.sample_count == jr.sample_count == 3


PALLAS = dict(intersector="pallas", cull_impl="pallas2")


def _cornell_renderer(seed=5, **knobs):
    scene = tscene.make_cornell_scene(device=CPU)
    cam = Camera.look_at(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                         device=CPU)
    cfg = RenderConfig(width=12, height=10, max_bounces=2, **knobs)
    return tpipe.ProgressiveRenderer(scene, cam, cfg, seed=seed)


def test_pipeline_real_frames_and_checkpoint(tmp_path):
    """The real renderer equals sequential render_with_samples on a clone
    of its generator bit for bit, and 2 + 2 frames through save/load into
    a fresh renderer equal 4 straight frames bit for bit."""
    r = _cornell_renderer(**PALLAS)
    g = torch.Generator().manual_seed(0)
    g.set_state(r._generator.get_state())
    frames = [render_with_samples(
        r.scene, r.camera, r.cfg,
        *make_sample_arrays(g, r.cfg.n_rays, r.cfg.max_bounces, device=CPU))
        for _ in range(4)]
    img = r.render_frames(4)
    assert torch.equal(r._accum, frames[0] + frames[1] + frames[2]
                       + frames[3])
    assert torch.equal(img, r._accum / 4.0)
    assert float(img.mean()) > 1e-2

    half = _cornell_renderer(**PALLAS)
    half.render_frames(2)
    checkpoint.save_renderer(str(tmp_path / "ckpt"), half)
    resumed = _cornell_renderer(seed=99, **PALLAS)
    checkpoint.load_renderer(str(tmp_path / "ckpt"), resumed)
    assert resumed._n_frames == 2
    resumed.render_frames(2)
    assert torch.equal(resumed._accum, r._accum)
    assert np.array_equal(resumed.snapshot(), r.snapshot())

    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": np.int64(7)}}
    checkpoint.save_pytree(str(tmp_path / "tree.npz"), tree)
    back = checkpoint.load_pytree(str(tmp_path / "tree.npz"), tree)
    assert torch.equal(back["a"], tree["a"]) and int(back["b"]["c"]) == 7
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_pytree(str(tmp_path / "tree"),
                               {"a": torch.zeros(3), "b": {"c": 0}})


# -- the CLI ------------------------------------------------------------------

CLI_BASE = ["--scene", "cornell", "--res", "16x16", "--frames", "2",
            "--depth", "2", "--seed", "4"]


@pytest.mark.parametrize("intersector", ["pallas", "bvh"])
def test_cli_writes_the_renderers_image(tmp_path, intersector):
    """The CLI on the CPU (the default "pallas", so the any-hit queries
    take "rounds"; and "bvh") writes PNG, HDR and NPY, and the NPY is the
    ProgressiveRenderer's snapshot of the same seed."""
    out = tmp_path / "r.png"
    res = subprocess.run(
        [sys.executable, "-m", "prismarine_core_tpu_torch.cli", *CLI_BASE,
         "--device", "cpu", "--intersector", intersector, "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    npy = np.load(tmp_path / "r.npy")
    assert (tmp_path / "r.hdr").exists()
    assert _png_pixels(out.read_bytes()).shape == (16, 16, 3)

    scene = tscene.make_cornell_scene(device=CPU)
    cam = Camera.look_at(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                         fov_y_deg=60.0, device=CPU)
    cfg = RenderConfig(width=16, height=16, max_bounces=2,
                       intersector=intersector, cull_impl="pallas2",
                       closest_k=16, cull_window=8192, cull_pps=16,
                       pairs_per_step=8)
    r = tpipe.ProgressiveRenderer(scene, cam, cfg, seed=4)
    r.render_frames(2)
    np.testing.assert_array_equal(npy, r.snapshot())
    assert npy.mean() > 1e-2


@pytest.fixture(scope="module")
def default_cli_npy(tmp_path_factory):
    """The NPY of the CLI's default flags on CLI_BASE."""
    from prismarine_core_tpu_torch import cli
    out = tmp_path_factory.mktemp("cli_default") / "r.png"
    cli.main(CLI_BASE + ["--device", "cpu", "--out", str(out)])
    return np.load(out.with_suffix(".npy"))


@pytest.mark.parametrize("flags", [
    ["--intersector", "packet"],
    ["--sort-mode", "packed"],
    ["--sort-mode", "group"],
    ["--cull-impl", "pallas"],
    ["--cull-impl", "xla"],
    ["--reuse-order"],
], ids=["packet", "packed", "group", "cull-pallas", "cull-xla",
        "reuse-order"])
def test_cli_packet_flags_render(tmp_path, default_cli_npy, flags):
    """Every packet-path flag of the JAX CLI renders in the port, and its
    NPY passes the image gate (tests/test_torch_render.py's criterion)
    against the default flags' NPY: each flag re-schedules the same ray
    tests ("packet" runs another cull before the same kernel)."""
    from prismarine_core_tpu_torch import cli
    out = tmp_path / "r.png"
    assert cli.main(CLI_BASE + ["--device", "cpu", "--out", str(out)]
                    + flags) == 0
    npy = np.load(tmp_path / "r.npy")
    assert npy.mean() > 1e-2
    assert_image_parity(npy, default_cli_npy)


def test_cli_without_a_card_names_it(capsys, monkeypatch):
    """No --device and no card: exit 2 with the "no CUDA device" error,
    never a CPU run."""
    from prismarine_core_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(CLI_BASE)
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
