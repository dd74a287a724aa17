"""One process of tests/test_torch_multihost.py (no jax; run as a script).

    python tests/torch_multihost_worker.py OUT_DIR

with ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID`` set.
Two CPU positions a process.  It reads the sample arrays and the train
target from ``OUT_DIR/inputs.npz``, renders the frames of
tests/test_multihost.py on the global mesh and a "pallas_sharded" frame
on a mesh whose "model" axis crosses the processes, takes one train step
across processes, then runs ``multihost.dryrun_multihost`` at a small
size; it saves each result as ``OUT_DIR/<name>_<rank>.npy`` and prints a
``RESULT <name> <rank> <mean>`` line for each frame.
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from prismarine_core_tpu_torch import multihost  # noqa: E402
from prismarine_core_tpu_torch.parallel import distributed  # noqa: E402
from tests.torch_multihost_cases import (  # noqa: E402
    CROSSING, brute_frame, hall_frame, train_step)

torch.set_num_threads(2)


def main(out: Path) -> None:
    ctx = distributed.init_distributed(local_devices=["cpu"] * 2)
    inputs = dict(np.load(out / "inputs.npz"))

    def save(name, x, mean=True):
        x = x.detach().numpy() if isinstance(x, torch.Tensor) else x
        np.save(out / f"{name}_{ctx.rank}.npy", x)
        if mean:
            print(f"RESULT {name} {ctx.rank} {float(x.mean()):.9f}",
                  flush=True)

    # the two frames of tests/test_multihost.py on the JAX layout
    # (process-major rows), then the sharded hall with "model" across
    # the processes
    save("brute", brute_frame(distributed.global_mesh(4, 1), inputs))
    save("hall", hall_frame(distributed.global_mesh(4, 2), inputs))
    crossing = distributed.global_mesh(4, 2, order=CROSSING)
    assert all(row == (0, 1) for row in crossing.ranks), crossing.ranks
    save("hall_crossing", hall_frame(crossing, inputs))
    _, params, loss = train_step(crossing, inputs)
    save("loss", np.asarray([float(loss)]), mean=False)
    for k, v in params.items():
        save(f"param_{k}", v, mean=False)
    multihost.dryrun_multihost(local_devices=["cpu"] * 2, hall_tris=1500,
                               size=16, bounces=2, texture_resolution=32,
                               train_size=16)
    distributed.shutdown()


if __name__ == "__main__":
    main(Path(sys.argv[1]))
