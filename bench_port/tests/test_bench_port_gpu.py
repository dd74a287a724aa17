"""On the card: one short run of each cell prints a correct result line
of the contract's shape.  ``python -m pytest bench_port/tests -q -m gpu``
on a machine with an H100."""

import json
import subprocess
import sys

import pytest
import torch

from bench_port import harness

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    proc = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, proc.stderr[-2000:]
    assert result["device"]["platform"] == "gpu"
    assert "setup_s" in result["metrics"]
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
