"""The port's multi-process mesh (``parallel/distributed.py``): the mirror of
tests/test_multihost.py.

Two worker processes (tests/torch_multihost_worker.py), each with two CPU
positions, initialise ``torch.distributed`` over gloo from the environment
``dryrun_multihost`` reads (a free port on localhost, so that this file and
the JAX one may run at once), and on the global mesh render:

* tests/test_multihost.py's two frames on its layout (process-major
  rows): the brute cornell box on a 4 x 1 mesh and the textured hall under
  "pallas_sharded" on a 2 x 2 mesh;
* the same hall on a 2 x 2 mesh whose "model" axis crosses the processes
  (each row's shards gathered over its process group);
* one "pallas_sharded" train step on that mesh;
* ``multihost.dryrun_multihost`` at a small size.

Criteria: both processes' means agree within 1e-6 (the JAX test's), and
every frame is bit-identical to the same frame on one process's mesh of
the same shape (``make_mesh(4, mp, devices=["cpu"] * 4)``; that mesh is
held against JAX by tests/test_torch_parallel.py); the train step's loss
equals the one-process step's and every parameter is within 1e-6 of its
largest move of the one-process step's (float sums of the gradient in
another order).  Each worker has a 300 s timeout and no card.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from prismarine_core_tpu_torch.parallel import distributed  # noqa: E402
from prismarine_core_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from tests.torch_multihost_cases import (  # noqa: E402
    brute_frame, hall_frame, make_inputs, train_step)

ROOT = Path(__file__).resolve().parents[1]
N_PROC = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Run the two workers once; returns (their outputs, the directory
    holding what they saved, the inputs)."""
    out = tmp_path_factory.mktemp("multihost")
    inputs = make_inputs(0)
    np.savez(out / "inputs.npz", **inputs)
    port = distributed.free_port()
    procs = []
    for rank in range(N_PROC):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES=str(N_PROC), PROCESS_ID=str(rank),
                   CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2",
                   PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_multihost_worker.py"),
             str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs, out, inputs


def _means(logs, name):
    return [float(next(line.split()[3] for line in log.splitlines()
                       if line.startswith(f"RESULT {name} ")))
            for log in logs]


@pytest.mark.parametrize("name,frame,mp", [
    ("brute", brute_frame, 1), ("hall", hall_frame, 2),
    ("hall_crossing", hall_frame, 2)])
def test_two_process_frames(run, name, frame, mp):
    logs, out, inputs = run
    means = _means(logs, name)
    assert abs(means[0] - means[1]) < 1e-6
    assert means[0] > 1e-3
    ref = frame(make_mesh(4, mp, devices=["cpu"] * 4), inputs).numpy()
    for rank in range(N_PROC):
        np.testing.assert_array_equal(np.load(out / f"{name}_{rank}.npy"),
                                      ref)


def test_two_process_train_step(run):
    _, out, inputs = run
    start, params, loss = train_step(make_mesh(4, 2, devices=["cpu"] * 4),
                                     inputs)
    for rank in range(N_PROC):
        assert float(np.load(out / f"loss_{rank}.npy")[0]) == float(loss)
        for k, v in params.items():
            got = np.load(out / f"param_{k}_{rank}.npy")
            move = float((v - start[k]).abs().max())
            err = float(np.abs(got - v.numpy()).max())
            print(f"rank {rank} {k}: step {move:.3g}, |two processes - "
                  f"one| {err:.3g}")
            assert move > 0 and err <= 1e-6 * move, (k, move, err)


def test_dryrun_multihost_runs(run):
    logs, _, _ = run
    for rank, log in enumerate(logs):
        assert "[distributed] rank" in log and "gloo (CPU positions)" in log
        assert any(line.startswith(f"dryrun_multihost: process {rank}/2 "
                                   "over 4 global positions")
                   and line.endswith("ok") for line in log.splitlines()), \
            log[-2000:]
