"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "prismarine_core_tpu"}
FILES = sorted(p for p in harness.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    (harness.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "prismarine_core_tpu_torch" not in top_level_imports(path)
    text = path.read_text()
    assert "_plain" not in text


def test_loaded_modules():
    """The modules a run loads (the port included), in a fresh process."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from bench_port import harness, trace, roofline, faults\n"
            "from bench_port.reference import tracer\n"
            "import prismarine_core_tpu_torch.parallel.mesh\n"
            "import prismarine_core_tpu_torch.render.integrator\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert not set(eval(out)) & FORBIDDEN
