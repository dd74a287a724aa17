"""The example programs of the port: the counterparts of ``examples/``.

Each module keeps the file name of its JAX counterpart and runs as
``python -m prismarine_core_tpu_torch.examples.<name>``:

- ``inverse_rendering``: the cornell box's albedos recovered with Adam;
- ``r6_rr_quality``: Russian roulette against fixed 4 bounces at equal
  wall clock;
- ``coherent_quality_ab``: coherent against independent bounce sampling
  at equal wall clock (both on the loop of ``quality``);
- ``r5_refit_bench``: ``build_bvh`` against ``refit_bvh`` and
  ``build_packet_set``.

Every program runs on the CUDA card by default and on the CPU only with
``--cpu`` (``utils/device.resolve_device``'s rule); with neither it
prints why and exits 2.  Each has a ``main(argv=None) -> int``.
"""

from __future__ import annotations

#: the exit code of a program asked to run on a card that is not there
NO_DEVICE = 2
