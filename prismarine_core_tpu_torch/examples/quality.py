"""Matched-wall-clock time-to-quality: the loop that ``r6_rr_quality`` and
``coherent_quality_ab`` share.

A study renders each mode's frames for a fixed budget of wall time,
averages them, and holds each mean against a long reference mean by the
per-pixel MSE.  As in the JAX scripts (``examples/r6_rr_quality.py``,
``examples/coherent_quality_ab.py``), a frame's sample generation and
render lie inside the budget, and every frame ends in one synchronize, so
the budget counts finished frames.  Frames accumulate in float64 on the
device (``FrameStats``), not through a host copy a frame.

Two departures from the JAX scripts:

- **Seeds.**  JAX keys its measured frames 1000 n + c and its reference
  frames 100000 + i, so measured frame n = 100 reuses a reference frame.
  At the card's frame rate a budget reaches such n, and the estimate is
  then correlated with its own reference: its MSE comes out too low.
  Here every seed comes from ``frame_seed``, whose ranges (the reference,
  the warm-up, each measured range) are disjoint for any frame index
  below ``SEED_SPAN``.
- **The reference's own noise.**  Against a reference of n_ref frames the
  MSE is var(estimate) + var(reference) + bias^2, and the middle term,
  the same for both modes, pushes every ratio toward 1.  So the
  reference is rendered after the measured modes, by default with
  n_ref = ``REF_FACTOR`` x the larger frame count, and every MSE line
  prints that term (the per-pixel sample variance of the reference's
  frames over n_ref, averaged over pixels) beside n_ref.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from prismarine_core_tpu_torch.models.camera import Camera
from prismarine_core_tpu_torch.models.procedural import (
    make_hall_scene, make_sky_environment)
from prismarine_core_tpu_torch.ops.sampling import (
    make_coherent_sample_arrays, make_sample_arrays)
from prismarine_core_tpu_torch.utils.device import resolve_device
from prismarine_core_tpu_torch.utils.profiling import wait_for

#: the studies' frame and scene (the JAX scripts'): 640x360 on the hall at
#: 50,000 target triangles under a 128-row sky
WIDTH, HEIGHT, HALL_TRIS, SKY_RESOLUTION = 640, 360, 50_000, 128
EYE, TARGET, FOV_Y_DEG = (-10.0, 2.2, 0.0), (6.0, 1.6, 0.0), 60.0
#: frame indices per seed range; ``frame_seed`` raises beyond it
SEED_SPAN = 10 ** 8
#: the seed ranges of the reference and the warm-up frames; measured
#: modes take ranges from MEASURED on
REFERENCE, WARM_UP, MEASURED = 0, 1, 2
#: the default reference: this many times the larger measured frame count
REF_FACTOR = 10


def frame_seed(seed_range: int, i: int) -> int:
    """The generator seed of frame ``i`` of ``seed_range``; ranges are
    disjoint because ``i`` stays below SEED_SPAN."""
    if not 0 <= i < SEED_SPAN:
        raise ValueError(f"frame index {i} outside [0, {SEED_SPAN})")
    return seed_range * SEED_SPAN + i


def study_scene(target_tris: int = HALL_TRIS, device=None):
    """(scene, camera): the hall under the procedural sky, the camera down
    its length."""
    scene = dataclasses.replace(
        make_hall_scene(target_tris=target_tris, device=device),
        environment=make_sky_environment(resolution=SKY_RESOLUTION,
                                         device=device))
    camera = Camera.look_at(eye=EYE, target=TARGET, fov_y_deg=FOV_Y_DEG,
                            device=device)
    return scene, camera


def study_samples(cfg, seed: int, device, block=None):
    """A frame's (cam, bounce) uniforms from a generator seeded ``seed``:
    ``block``-pixel coherent bounce rows, or independent ones when
    ``block`` is None."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if block is None:
        return make_sample_arrays(gen, cfg.n_rays, cfg.max_bounces,
                                  device=device)
    return make_coherent_sample_arrays(gen, cfg, block=block, device=device)


class FrameStats:
    """Running float64 mean and sum of squared deviations (Welford) of a
    stream of frames, on the frames' device."""

    def __init__(self):
        self.n = 0
        self.mean = None
        self.m2 = None

    def add(self, img: torch.Tensor) -> None:
        x = img.detach().to(torch.float64)
        self.n += 1
        if self.mean is None:
            self.mean, self.m2 = x.clone(), torch.zeros_like(x)
            return
        delta = x - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (x - self.mean)

    def var_of_mean(self) -> float:
        """The per-pixel sample variance over n, averaged over pixels:
        the variance the mean carries from its own frames (n >= 2)."""
        if self.n < 2:
            raise ValueError("the variance of a mean needs two frames")
        return float((self.m2 / ((self.n - 1) * self.n)).mean())

    def mse(self, ref: "FrameStats") -> float:
        return float(((self.mean - ref.mean) ** 2).mean())


def render_for(frame, budget_s: float, seed_range: int):
    """Frames of ``frame(seed)`` until ``budget_s`` of wall time has
    passed (at least one), each ended by one synchronize: (FrameStats,
    seconds)."""
    stats = FrameStats()
    t0 = time.perf_counter()
    while stats.n == 0 or time.perf_counter() - t0 < budget_s:
        stats.add(frame(frame_seed(seed_range, stats.n)))
        wait_for(stats.mean)
    return stats, time.perf_counter() - t0


def render_n(frame, n: int, seed_range: int):
    """``n`` frames of ``frame(seed)``: (FrameStats, seconds)."""
    stats = FrameStats()
    t0 = time.perf_counter()
    for i in range(n):
        stats.add(frame(frame_seed(seed_range, i)))
        wait_for(stats.mean)
    return stats, time.perf_counter() - t0


def run_study(frames: dict, seed_ranges: dict, reference: str,
              ratio: tuple, budget_s: float, n_ref: int) -> dict:
    """The study: ``frames`` maps each mode to its frame function
    (seed -> f32[H,W,3]), ``seed_ranges`` each mode to its
    measured seed range, ``reference`` names the mode whose frames make the
    reference, ``ratio`` the (numerator, denominator) modes of the MSE
    ratio.  n_ref 0 takes REF_FACTOR x the larger frame count.  Each mode
    is warmed once, then measured for ``budget_s``; then the reference."""
    for k, frame in enumerate(frames.values()):
        wait_for(frame(frame_seed(WARM_UP, k)))
    measured = {m: render_for(f, budget_s, seed_ranges[m])
                for m, f in frames.items()}
    most = max(stats.n for stats, _ in measured.values())
    n_ref = n_ref or REF_FACTOR * most
    ref, ref_s = render_n(frames[reference], n_ref, REFERENCE)
    modes = {m: dict(frames=stats.n, ms_per_frame=1e3 * s / stats.n,
                     mean=float(stats.mean.mean()), mse=stats.mse(ref),
                     var_of_mean=(stats.var_of_mean() if stats.n > 1
                                  else None))
             for m, (stats, s) in measured.items()}
    num, den = (modes[m]["mse"] for m in ratio)
    return dict(budget_s=budget_s, n_ref=n_ref, ref_factor=n_ref / most,
                reference=dict(mode=reference, mean=float(ref.mean.mean()),
                               var_of_mean=ref.var_of_mean(),
                               ms_per_frame=1e3 * ref_s / n_ref),
                modes=modes, ratio_modes=list(ratio), ratio=num / den,
                winner=ratio[0] if num < den else ratio[1])


def study_args(prog: str, description: str, argv, block: bool = False):
    """The studies' argv, in the JAX scripts' order: budget_s, n_ref (0:
    REF_FACTOR x the larger frame count), the coherent block (with
    ``block``), and ``--cpu``; and the device (None, with a message on
    stderr, when there is no card and no ``--cpu``)."""
    ap = argparse.ArgumentParser(prog=prog, description=description)
    ap.add_argument("budget_s", type=float, nargs="?", default=20.0,
                    help="wall-clock budget of each mode, in seconds")
    ap.add_argument("n_ref", type=int, nargs="?", default=0,
                    help=f"reference frames (0: {REF_FACTOR} x the larger "
                         "measured frame count)")
    if block:
        ap.add_argument("block", type=int, nargs="?", default=16,
                        help="the coherent mode's square pixel block")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)
    if args.n_ref == 1 or args.n_ref < 0:
        ap.error("n_ref is 0 (automatic) or at least 2")
    try:
        return args, resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"{prog}: {e}; for this program, pass --cpu", file=sys.stderr)
        return args, None


def device_name(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def print_reference(tag: str, result: dict) -> None:
    ref = result["reference"]
    print(f"[{tag}] reference mean={ref['mean']:.5f} n_ref="
          f"{result['n_ref']} ({result['ref_factor']:.1f} x the larger "
          f"frame count; {ref['ms_per_frame']:.2f} ms/frame)", flush=True)


def print_result(tag: str, result: dict) -> None:
    """The ratio line (``ratio`` as run_study's) and the JSON line."""
    num, den = result["ratio_modes"]
    print(f"[{tag}] equal-wall-clock MSE ratio {num}/{den} = "
          f"{result['ratio']:.3f}  (frames {result['modes'][num]['frames']}"
          f" vs {result['modes'][den]['frames']}, n_ref {result['n_ref']})"
          f" -> {result['winner']} WINS", flush=True)
    print(f"[{tag}] result {json.dumps(result)}", flush=True)


def ref_term(result: dict) -> str:
    """The text beside each MSE: the reference's own variance and n_ref."""
    return (f"ref_var={result['reference']['var_of_mean']:.3e} "
            f"n_ref={result['n_ref']}")
