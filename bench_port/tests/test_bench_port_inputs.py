"""The frozen yardstick equals the port's generators on the same seed:
the hall's arrays and materials, the sun, the sky, both sample layouts,
and the walk counter."""

import numpy as np
import pytest
import torch

from bench_port import roofline, sampling, scene as bscene

CPU = torch.device("cpu")


@pytest.mark.parametrize("target_tris", [3000, 100_000])
def test_hall_equals_port(target_tris):
    from prismarine_core_tpu_torch.models.geometry import TriangleSoup
    from prismarine_core_tpu_torch.models.procedural import make_hall_scene
    port = make_hall_scene(target_tris=target_tris, build_bvh=False,
                           device="cpu")
    verts, faces, mids = bscene.hall_mesh(target_tris, 0)
    soup = TriangleSoup.from_arrays(verts, faces, mat_ids=mids, device="cpu")
    if target_tris == 100_000:
        assert soup.capacity == 136_996
    for f in ("v0", "v1", "v2", "n0", "n1", "n2", "mat_id", "valid"):
        assert torch.equal(getattr(soup, f), getattr(port.triangles, f)), f
    mats = bscene.material_arrays(bscene.HALL_MATERIALS)
    assert np.array_equal(mats["diffuse"], port.materials.diffuse.numpy())
    assert np.array_equal(mats["specular"], port.materials.specular.numpy())
    assert np.array_equal(mats["ior"], port.materials.ior.numpy())
    center, radius, color = bscene.suns()
    assert np.array_equal(center, port.lights.center.numpy())
    assert np.array_equal(radius, port.lights.radius.numpy())
    assert np.array_equal(color, port.lights.color.numpy())


def test_sky_equals_port():
    from prismarine_core_tpu_torch.models.procedural import (
        make_sky_environment)
    env = make_sky_environment(resolution=128, device="cpu")
    assert np.array_equal(bscene.sky_image(128), env.image.numpy())


@pytest.mark.parametrize("spp", [1, 4])
def test_samples_equal_port(spp):
    from prismarine_core_tpu_torch.ops.sampling import (
        make_coherent_sample_arrays, make_sample_arrays)
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    cfg = RenderConfig(width=160, height=90, spp=spp, max_bounces=4)
    render = {"width": 160, "height": 90, "spp": spp, "max_bounces": 4}
    seed = sampling.stream_seed(2 ** 31 + 17, sampling.WINDOW, 5)
    mine = sampling.frame_samples({"kind": "coherent", "block": [64, 64]},
                                  render, torch.Generator().manual_seed(seed),
                                  CPU)
    port = make_coherent_sample_arrays(torch.Generator().manual_seed(seed),
                                       cfg, block=(64, 64), device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(mine, port))
    mine = sampling.frame_samples({"kind": "independent"}, render,
                                  torch.Generator().manual_seed(seed), CPU)
    port = make_sample_arrays(torch.Generator().manual_seed(seed),
                              cfg.n_rays, 4, device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(mine, port))


def test_stream_seeds():
    big = 2 ** 31 + 5
    assert sampling.stream_seed(big, 0, 1) == sampling.stream_seed(big, 0, 1)
    seeds = {sampling.stream_seed(s, st, i) for s in (0, 1, big, -big)
             for st in range(5) for i in range(3)}
    assert len(seeds) == 4 * 5 * 3
    assert all(0 <= s < 2 ** 63 for s in seeds)


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_counter_equals_port(any_hit):
    from prismarine_core_tpu_torch.accel.traverse import traversal_stats
    from prismarine_core_tpu_torch.models.procedural import make_hall_scene
    scene = make_hall_scene(target_tris=3000, device="cpu")
    g = torch.Generator().manual_seed(3)
    o = torch.rand((500, 3), generator=g) * torch.tensor([20.0, 4.0, 8.0]) \
        - torch.tensor([10.0, -0.5, 4.0])
    d = torch.nn.functional.normalize(torch.randn((500, 3), generator=g),
                                      dim=-1)
    cap = torch.where(torch.rand(500, generator=g) < 0.2, 0.0, 10000.0)
    live = cap > roofline.PZERO
    want = traversal_stats(scene.bvh, o[live], d[live], cap[live],
                           any_hit=any_hit)
    assert roofline.walk_counts(scene.bvh, o[live], d[live], cap[live],
                                any_hit) == want
