#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: the bench frame on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device   — the card's name; nvidia-smi's name and power limit;
  2. build    — nvcc builds prismarine_core_tpu_torch/csrc/*.cu into
                build/torch_kernels/ (timed);
  3. kernels  — each CUDA kernel against its plain PyTorch version on the
                card, on the full hall with 1280x720 bounce-0 and bounce-1
                rays at the main path's shapes: block cull, pair cull
                masks and intersector (t, slot) must be equal exactly;
                kernel and plain times by CUDA events after a warm-up;
  4. frame    — render_with_samples(..., with_stats=True) at bench.py's
                main configuration, with every kernel's launch counter
                set to 0 before and read after (each must be > 0 and at
                most 12 = 2 per closest query + 1 per shadow query over
                4 bounces); then 3 timed frames, one sync each: ms/frame,
                live rays, Mrays/s, host syncs per frame, peak memory;
  5. parity   — the same frame with the plain versions in the kernels'
                place: the image must meet the CPU image test's bound.

The last lines are the kernel table as JSON, nvidia-smi's line, and
``{"ok": true, "device": {...}}``.  Nothing falls back to the CPU.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import linecache
import subprocess
import sys
import time
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent
W, H, BOUNCES = 1280, 720, 4
#: sanity band of the frame's mean radiance (the full frame's mean is
#: 0.29-0.35 over sample seeds 0-3 on an H100)
MEAN_BAND = (0.2, 0.4)
KERNELS = ("block_cull", "pair_cull", "sb_intersect")
MAX_LAUNCHES = 2 * BOUNCES + BOUNCES     # per frame, each kernel


def log(msg=""):
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    """Fail the run (non-zero exit) when a check does not hold."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over ``reps`` launches (CUDA events, after
    one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_setup(dev, target_tris=100_000):
    """Scene, camera and config of bench.py's main metric, on ``dev``."""
    from prismarine_core_tpu_torch.models.camera import Camera
    from prismarine_core_tpu_torch.models.procedural import (
        make_hall_scene, make_sky_environment)
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=BOUNCES,
                       intersector="pallas", bvh_leaf_size=4,
                       coherent_bounce_sampling=True, pairs_per_step=8,
                       stale_round_masks=True, anyhit_strategy="single",
                       cull_impl="pallas2", closest_k=16,
                       cull_window=8192, cull_pps=16)
    scene = make_hall_scene(target_tris=target_tris, device=dev)
    scene = dataclasses.replace(
        scene, environment=make_sky_environment(resolution=128, device=dev))
    cam = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                         fov_y_deg=60.0, device=dev)
    return scene, cam, cfg


def phase_kernels(scene, cam, cfg, dev):
    """Every kernel against its plain version on the card at the main
    path's shapes (round 1 of the closest query, bounces 0 and 1)."""
    import torch
    from prismarine_core_tpu_torch.accel import packet as pk
    from prismarine_core_tpu_torch.models.camera import generate_rays
    from prismarine_core_tpu_torch.ops import cull, sb_intersect as si
    from prismarine_core_tpu_torch.ops.sampling import (
        make_coherent_sample_arrays)
    from prismarine_core_tpu_torch.render.integrator import make_bounce_step
    from prismarine_core_tpu_torch.utils.config import INF_DIST

    gen = torch.Generator(device=dev).manual_seed(1)
    cam_s, bounce_s = make_coherent_sample_arrays(gen, cfg, block=(64, 64))
    o, d = generate_rays(cam, cfg, cam_s)
    r = o.shape[0]
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    carry = (o, d, torch.ones((r, 3), device=dev),
             torch.zeros((r, 3), device=dev), alive,
             torch.zeros((r, 3), device=dev), torch.zeros((r, 3), device=dev))
    carry1, _ = make_bounce_step(scene, cfg)(carry, bounce_s[0])
    ray_sets = {"bounce0": (o, d, alive),
                "bounce1": (carry1[0], carry1[1], carry1[4])}

    ps = scene.packets
    nsb = ps.n_superblocks
    sb_rows = cull.box_rows_from_blocks(ps.sb_lo, ps.sb_hi)
    sbbox = cull.sb_box_table(ps.block_lo, ps.block_hi)
    rows = {}
    for name, (o_, d_, alive_) in ray_sets.items():
        t_cap = torch.where(alive_, INF_DIST, 0.0)
        rays, _, _ = pk._sorted_rays_matrix(scene.bvh.lo[0],
                                            scene.bvh.hi[0], o_, d_, t_cap)
        nt = rays.shape[0] // 128 - 1
        n_live = pk._live_tile_bound(rays[:nt * 128, 6].reshape(nt, 128))
        tn = cull.block_cull(rays, sb_rows, n_live)
        tn_p = cull.block_cull_plain(rays, sb_rows, n_live)
        bc_err = (tn - tn_p).abs().max().item()
        require(torch.equal(tn, tn_p), f"{name}: block_cull != plain")

        tn = tn[:, :nsb]
        tn_cand = torch.where(tn < INF_DIST, tn, INF_DIST)
        tn_sorted, sb_sorted = torch.sort(tn_cand, dim=1, stable=True)
        ok = tn_sorted[:, :cfg.closest_k] < INF_DIST
        pt, psb, n_real = pk.compact_pairs(ok, sb_sorted[:, :cfg.closest_k])
        pm = cull.pair_cull(pt, psb, n_real, rays, sbbox)
        pm_p = cull.pair_cull_plain(pt, psb, n_real, rays, sbbox)
        pc_err = (pm - pm_p).abs().max().item()
        require(torch.equal(pm, pm_p), f"{name}: pair_cull != plain")

        t, slot = si.sb_intersect(pt, psb, pm, n_real, rays, ps.planes)
        t_p, slot_p = si.sb_intersect_plain(pt, psb, pm, n_real, rays,
                                            ps.planes, chunk=128)
        si_err = (t - t_p).abs().max().item()
        require(torch.equal(t, t_p) and torch.equal(slot, slot_p),
                f"{name}: sb_intersect (t, slot) != plain")
        n_hit = int((slot[:nt * 128] >= 0).sum())
        n_sub = int(sum(((pm >> k) & 1).sum() for k in range(8)))
        log(f"[kernels] {name}: {r} rays, {nt} tiles, n_live "
            f"{int(n_live)}, {int(n_real)} round-1 pairs, {n_sub} live "
            f"sub-blocks, {n_hit} hits; kernels == plain exactly")

        times = {
            "block_cull": (cuda_ms(lambda: cull.block_cull(
                rays, sb_rows, n_live), 20), cuda_ms(
                lambda: cull.block_cull_plain(rays, sb_rows, n_live), 3),
                bc_err),
            "pair_cull": (cuda_ms(lambda: cull.pair_cull(
                pt, psb, n_real, rays, sbbox), 20), cuda_ms(
                lambda: cull.pair_cull_plain(pt, psb, n_real, rays, sbbox),
                3), pc_err),
            "sb_intersect": (cuda_ms(lambda: si.sb_intersect(
                pt, psb, pm, n_real, rays, ps.planes), 5), cuda_ms(
                lambda: si.sb_intersect_plain(pt, psb, pm, n_real, rays,
                                              ps.planes, chunk=128), 1),
                si_err),
        }
        for k, (ms, pms, err) in times.items():
            log(f"[kernels] {name} {k}: kernel {ms:.4f} ms, plain "
                f"{pms:.4f} ms ({pms / ms:.1f}x), max |kernel - plain| "
                f"{err}")
        rows[name] = times
    return rows


def host_syncs(fn) -> collections.Counter:
    """Host syncs torch reports while ``fn()`` runs, counted by the
    source line that issued them (``set_sync_debug_mode("warn")``)."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(
        f"{'/'.join(Path(w.filename).parts[-2:])}:{w.lineno} "
        f"{linecache.getline(w.filename, w.lineno).strip()!r}"
        for w in caught if "synchroniz" in str(w.message))


@contextlib.contextmanager
def plain_versions():
    """Run the packet query on the kernels' plain versions (parity
    phase only)."""
    import functools
    from prismarine_core_tpu_torch.accel import packet as pk
    from prismarine_core_tpu_torch.ops import cull, sb_intersect as si
    saved = (pk.block_cull, pk.pair_cull, pk.sb_intersect)
    pk.block_cull = cull.block_cull_plain
    pk.pair_cull = cull.pair_cull_plain
    pk.sb_intersect = functools.partial(si.sb_intersect_plain, chunk=128)
    try:
        yield
    finally:
        pk.block_cull, pk.pair_cull, pk.sb_intersect = saved


def phase_frame(scene, cam, cfg, dev, n_frames=3):
    import torch
    from prismarine_core_tpu_torch.accel import packet as pk
    from prismarine_core_tpu_torch.ops import cull, sb_intersect as si
    from prismarine_core_tpu_torch.ops.sampling import (
        make_coherent_sample_arrays)
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)

    gen = torch.Generator(device=dev).manual_seed(0)
    cam_s, bounce_s = make_coherent_sample_arrays(gen, cfg, block=(64, 64))
    wrappers = {"block_cull": cull.block_cull, "pair_cull": cull.pair_cull,
                "sb_intersect": si.sb_intersect}

    # the main-path run: counters from 0, read right after
    for w in wrappers.values():
        w.launches = 0
    syncs0 = pk.compact_pairs.host_syncs
    t0 = time.perf_counter()
    img, stats = render_with_samples(scene, cam, cfg, cam_s, bounce_s,
                                     with_stats=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    compactions = pk.compact_pairs.host_syncs - syncs0
    log(f"[frame] first frame {first_s:.3f} s; launches {launches}; "
        f"{compactions} pair compactions")
    for k, n in launches.items():
        require(0 < n <= MAX_LAUNCHES, f"{k}: {n} launches")
    require(img.shape == (H, W, 3), f"image shape {tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), "non-finite image")
    mean = float(img.mean())
    require(MEAN_BAND[0] <= mean <= MEAN_BAND[1], f"image mean {mean}")
    stats = stats.cpu()
    rays = int(stats[:, 0].sum() + stats[:, 4].sum())
    log(f"[frame] mean {mean:.6f}; stats {stats.tolist()}")

    # every host sync torch detects over one frame, less what switching
    # the detection on and off reports by itself
    sources = (host_syncs(lambda: render_with_samples(
        scene, cam, cfg, cam_s, bounce_s)) - host_syncs(lambda: None))
    syncs = sum(sources.values())

    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(n_frames):
        t0 = time.perf_counter()
        out = render_with_samples(scene, cam, cfg, cam_s, bounce_s)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    require(torch.equal(out, img), "frames differ between runs")
    ms = 1e3 * sum(times) / n_frames
    result = dict(ms_per_frame=ms, frame_ms=[1e3 * t for t in times],
                  live_rays=rays, mrays_per_s=rays / (ms * 1e3),
                  host_syncs_per_frame=syncs,
                  compactions_per_frame=compactions,
                  peak_mem_bytes=peak, mean=mean, launches=launches)
    log(f"[frame] {ms:.3f} ms/frame over {n_frames} frames "
        f"({', '.join(f'{1e3 * t:.3f}' for t in times)}); {rays} live rays "
        f"-> {rays / (ms * 1e3):.3f} Mrays/s; {syncs} host syncs per frame "
        f"({compactions} of them pair compactions); peak memory "
        f"{peak / 2**20:.1f} MiB")
    log(f"[frame] host syncs by source line: {dict(sources.most_common())}")
    return img, result, (cam_s, bounce_s)


def phase_parity(scene, cam, cfg, img, samples):
    import numpy as np
    import torch
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    t0 = time.perf_counter()
    with plain_versions():
        ref = render_with_samples(scene, cam, cfg, *samples)
    torch.cuda.synchronize()
    a, b = img.cpu().numpy(), ref.cpu().numpy()
    close = np.isclose(a, b, rtol=1e-3, atol=1e-3).all(axis=-1).mean()
    log(f"[parity] plain-version frame in {time.perf_counter() - t0:.1f} "
        f"s: pixel parity {close:.6f}, mean {a.mean():.6f} vs "
        f"{b.mean():.6f}, bit-identical {bool(np.array_equal(a, b))}")
    require(close >= 0.98, f"pixel parity {close}")
    require(abs(a.mean() - b.mean()) <= 5e-3 * abs(b.mean()),
            f"image mean {a.mean()} vs plain {b.mean()}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False — this script "
            "runs only on an NVIDIA GPU")
        return 2
    sys.path.insert(0, str(REPO))
    from prismarine_core_tpu_torch import _build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    ptxas = lib_path.with_name(lib_path.stem + ".ptxas.txt")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")

    t0 = time.perf_counter()
    scene, cam, cfg = bench_setup(dev)
    torch.cuda.synchronize()
    log(f"[scene] {int(scene.triangles.num_valid())} tris, "
        f"{scene.bvh.n_nodes} nodes, {scene.packets.n_superblocks} "
        f"superblocks, built in {time.perf_counter() - t0:.1f} s")

    ktimes = phase_kernels(scene, cam, cfg, dev)
    img, frame, samples = phase_frame(scene, cam, cfg, dev)
    phase_parity(scene, cam, cfg, img, samples)

    replaces = {
        "block_cull": ("prismarine_core_tpu_torch/csrc/cull.cu",
                       "prismarine_core_tpu/ops/pallas_cull.py:51"),
        "pair_cull": ("prismarine_core_tpu_torch/csrc/cull.cu",
                      "prismarine_core_tpu/ops/pallas_cull.py:200"),
        "sb_intersect": ("prismarine_core_tpu_torch/csrc/sb_intersect.cu",
                         "prismarine_core_tpu/ops/pallas_intersect.py:85"),
    }
    table = {"kernels": [
        {"name": k, "route": "cuda", "source": replaces[k][0],
         "replaces": replaces[k][1], "launches": frame["launches"][k],
         "max_abs_err": max(ktimes[s][k][2] for s in ktimes),
         "ms": ktimes["bounce1"][k][0], "plain_ms": ktimes["bounce1"][k][1],
         "shape": "bounce-1 rays, round 1 of the closest query"}
        for k in KERNELS],
        "frame": {k: v for k, v in frame.items() if k != "launches"},
        "card": smi}
    log(json.dumps(table))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
