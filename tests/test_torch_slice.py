"""The bench frame's slice at a small size: bench.py's main configuration
(pallas intersector, two-level cull, two_round K=16 closest queries,
"single" any-hit NEE queries, HDR sky, coherent bounce samples) on a hall
of 27,748 triangles — 32 superblocks, more than K, so both rounds of the
closest query really run — at 64x48 and 4 bounces, port against JAX on
the same coherent sample arrays.

Criteria as tests/test_torch_render.py: >= 98% of pixels
``isclose(rtol=1e-3, atol=1e-3)``, image mean within 0.5%, per-bounce
lane counters within 0.5%.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402

from prismarine_core_tpu.models import procedural as jproc  # noqa: E402
from prismarine_core_tpu.ops.sampling import (  # noqa: E402
    make_coherent_sample_arrays)
from prismarine_core_tpu_torch.models import procedural as tproc  # noqa: E402
from prismarine_core_tpu_torch.utils.profiling import counts  # noqa: E402
from tests.test_torch_render import (  # noqa: E402
    BENCH_KNOBS, HALL, assert_image_parity, render_both)

torch.set_num_threads(1)


def test_bench_slice_matches_jax():
    jscene = jproc.make_hall_scene(target_tris=20000)
    jscene = dataclasses.replace(
        jscene, environment=jproc.make_sky_environment(resolution=128))
    tscene = tproc.make_hall_scene(target_tris=20000, device="cpu")
    tscene = dataclasses.replace(
        tscene, environment=tproc.make_sky_environment(resolution=128,
                                                       device="cpu"))
    assert int(tscene.triangles.num_valid()) == 27748
    assert tscene.packets.n_superblocks == 32

    cfg_kw = dict(width=64, height=48, spp=1, max_bounces=4,
                  coherent_bounce_sampling=True, **BENCH_KNOBS)
    syncs0 = counts["pc.sync.compact"]
    (img, st), (ref, rst) = render_both(
        jscene, tscene, **HALL, cfg_kw=cfg_kw,
        samples=lambda cfg: make_coherent_sample_arrays(
            jax.random.key(0), cfg, block=(8, 16)))
    # one compaction per round: 2 per closest query, 1 per shadow query
    assert counts["pc.sync.compact"] - syncs0 == 4 * 3
    assert img.mean() > 1e-2
    assert_image_parity(img, ref, st, rst)
