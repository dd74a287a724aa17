"""The command without a card, and in a directory with nothing but the
benchmark."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from bench_port import harness

ARGS = ["--workload", "hall720-bvh.frames", "--seed", "2147483653",
        "--seconds", "1", "--trace", "0"]


def run_cmd(cwd):
    return subprocess.run([sys.executable, "bench_port/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_no_card_exits_nonzero(no_card):
    proc = run_cmd(harness.ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run_cmd(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == "" or "correct" not in proc.stdout


def test_contract_paths():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert c["file"].startswith("bench_port/")
