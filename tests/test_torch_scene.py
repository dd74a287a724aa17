"""Port scene model and acceleration build against the JAX package.

The procedural scenes are numpy on the same seeds, so every array must be
equal; ``build_bvh`` and ``build_packet_set`` must give the same node
arrays, slot order and packet planes bit for bit.  Also: the numpy
interop round-trips, and importing the port leaves jax unloaded.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402

from prismarine_core_tpu.accel.lbvh import build_bvh as j_build_bvh  # noqa: E402
from prismarine_core_tpu.accel.packet import (  # noqa: E402
    build_packet_set as j_build_packet_set)
from prismarine_core_tpu.models import procedural as jproc  # noqa: E402
from prismarine_core_tpu_torch import interop  # noqa: E402
from prismarine_core_tpu_torch.accel.lbvh import build_bvh  # noqa: E402
from prismarine_core_tpu_torch.accel.packet import build_packet_set  # noqa: E402
from prismarine_core_tpu_torch.models import procedural as tproc  # noqa: E402
from prismarine_core_tpu_torch.models.geometry import TriangleSoup  # noqa: E402
from tests.test_bvh import _random_soup  # noqa: E402

torch.set_num_threads(1)
#: the port's constructors default to the card; these tests run on the CPU
CPU = "cpu"

GROUPS = ("triangles", "materials", "lights", "environment", "bvh",
          "packets")


def jax_scene_arrays(scene) -> dict:
    """A JAX Scene's array leaves as numpy, keyed "group.field" (the
    input format of ``interop.scene_from_numpy``)."""
    out = {}
    for g in GROUPS:
        obj = getattr(scene, g)
        if obj is None:
            continue
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, jax.Array):
                out[f"{g}.{f.name}"] = np.asarray(v)
    for f in ("data", "sizes", "quad"):
        v = getattr(scene.textures, f)
        if v is not None:
            out[f"textures.{f}"] = np.asarray(v)
    return out


def port_soup(jsoup) -> TriangleSoup:
    """The port's soup holding a JAX soup's arrays."""
    return TriangleSoup(**{f.name: torch.tensor(
        np.asarray(getattr(jsoup, f.name)))
        for f in dataclasses.fields(jsoup)})


def assert_dataclass_equal(port_obj, jax_obj, name):
    for f in dataclasses.fields(port_obj):
        if f.name == "stub":
            continue
        got = getattr(port_obj, f.name).numpy()
        ref = np.asarray(getattr(jax_obj, f.name))
        assert got.shape == ref.shape, f"{name}.{f.name} shape"
        np.testing.assert_array_equal(got, ref.astype(got.dtype),
                                      err_msg=f"{name}.{f.name}")


@pytest.fixture(scope="module")
def halls():
    return (jproc.make_hall_scene(target_tris=3000),
            tproc.make_hall_scene(target_tris=3000, device=CPU))


def test_hall_and_sky_arrays_equal(halls):
    jh, th = halls
    for g in ("triangles", "materials", "lights", "environment"):
        assert_dataclass_equal(getattr(th, g), getattr(jh, g), g)
    assert_dataclass_equal(tproc.make_sky_environment(resolution=32,
                                                      device=CPU),
                           jproc.make_sky_environment(resolution=32), "sky")


def test_hall_bvh_and_packets_equal(halls):
    jh, th = halls
    assert_dataclass_equal(th.bvh, jh.bvh, "bvh")
    assert_dataclass_equal(th.packets, jh.packets, "packets")


@pytest.mark.parametrize("n_tris,capacity,seed", [
    (100, 128, 0), (10, 64, 0), (300, 384, 3), (200, 256, 5),
    (1000, 1005, 11)])
def test_build_bvh_matches_jax(n_tris, capacity, seed):
    jsoup = _random_soup(n_tris, capacity=capacity, seed=seed)
    jb = j_build_bvh(jsoup, leaf_size=4)
    tb = build_bvh(port_soup(jsoup), leaf_size=4)
    assert_dataclass_equal(tb, jb, "bvh")
    assert_dataclass_equal(build_packet_set(tb), j_build_packet_set(jb),
                           "packets")


def test_interop_round_trip(halls):
    """The stub hall and a JAX textured hall (texture data, native sizes,
    corner quads) cross over and back exactly; an unknown array raises."""
    jh, _ = halls
    jt = jproc.make_hall_scene(target_tris=3000, textured=True,
                               texture_resolution=32)
    for jscene, stub in ((jh, True), (jt, False)):
        arrays = jax_scene_arrays(jscene)
        scene = interop.scene_from_numpy(arrays, device=CPU)
        back = interop.scene_to_numpy(scene)
        assert set(back) == set(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert scene.textures.stub == stub
    assert {"textures.sizes", "textures.quad"} <= set(arrays)
    with pytest.raises(KeyError):
        interop.scene_from_numpy({**arrays, "textures.mips": arrays[
            "textures.data"]}, device=CPU)


def test_entry_points_need_a_card_by_default(monkeypatch):
    """``device=None`` means the CUDA card: without one every constructor
    raises, naming ``device="cpu"``, and never builds on the CPU by
    itself."""
    from prismarine_core_tpu_torch.models.camera import Camera
    from prismarine_core_tpu_torch.models.lights import SphereLights
    from prismarine_core_tpu_torch.models.materials import MaterialTable
    from prismarine_core_tpu_torch.models.scene import make_cornell_scene
    from prismarine_core_tpu_torch.models.textures import (
        Environment, TextureStack)
    from prismarine_core_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cpu_arrays = interop.scene_to_numpy(make_cornell_scene(device=CPU))
    calls = {
        "make_cornell_scene": make_cornell_scene,
        "make_hall_scene": lambda: tproc.make_hall_scene(2000),
        "make_sky_environment": lambda: tproc.make_sky_environment(16),
        "Camera.look_at": lambda: Camera.look_at((0, 0, 1), (0, 0, 0)),
        "TriangleSoup.from_arrays": lambda: TriangleSoup.from_arrays(
            np.eye(3, dtype=np.float32), np.array([[0, 1, 2]])),
        "MaterialTable.build": lambda: MaterialTable.build([{}]),
        "SphereLights.suns": SphereLights.suns,
        "SphereLights.single": lambda: SphereLights.single(
            (0, 0, 0), 1.0, (1, 1, 1)),
        "TextureStack.empty": TextureStack.empty,
        "Environment.constant": Environment.constant,
        "Environment.from_image": lambda: Environment.from_image(
            np.ones((2, 4, 3), np.float32)),
        "interop.scene_from_numpy": lambda: interop.scene_from_numpy(
            cpu_arrays),
        "interop.params_from_numpy": lambda: interop.params_from_numpy(
            {"light_color": np.ones((1, 3), np.float32)}),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def test_import_leaves_jax_out():
    """Every module of the port (found by ``pkgutil.walk_packages``, so a
    module added later is covered too) imports without jax, the JAX
    package, triton or Pillow (the card's machine has no Pillow: the
    loaders import it only to decode a texture)."""
    code = ("import importlib, pkgutil, sys\n"
            "import prismarine_core_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    pkg.__path__, pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "assert 'prismarine_core_tpu_torch.render.edge_grad' in names\n"
            "assert 'prismarine_core_tpu_torch.cli' in names\n"
            "assert len(names) >= 38, names\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'prismarine_core_tpu', 'triton', 'PIL')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # chip_smoke.py and the card's shared test cases import lazily: read
    # their import statements
    root = Path(__file__).resolve().parents[1]
    for path in (root / "chip_smoke.py", root / "tests/torch_edge_cases.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module])
                for m in mods:
                    top = (m or "").split(".")[0]
                    assert top not in ("jax", "prismarine_core_tpu"), (
                        path.name, m)
