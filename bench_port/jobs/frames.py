"""Frames in a closed loop, one in flight, each with fresh sample arrays
drawn on the device from (seed, frame) and ending in a device sync.
``frame_ms`` is the window over the frames completed in it,
``frame_ms_p95`` the 95th percentile of the frames' own times.

Each frame keeps ``KEPT_PIXELS`` of its pixels, drawn from the seed,
inside the window; after it the plain reference traces those pixels of a
sample of the frames from their own sample rows."""

from __future__ import annotations

import numpy as np
import torch

from bench_port import compare, program, sampling
from bench_port.reference import tracer

#: frames that keep their checked pixels, and how many pixels each keeps
KEPT_FRAMES, KEPT_PIXELS = 4096, 256
#: frames before the window
WARMUP_FRAMES = 3


class Job:
    def __init__(self, cell, prog, seed: int):
        self.cell, self.prog, self.seed = cell, prog, seed
        self.render = cell.config["render"]
        dev = prog.device
        n_pix = self.render["width"] * self.render["height"]
        gen = sampling.generator(dev, seed, sampling.CHECK, 0)
        self.pix = torch.randint(0, n_pix, (KEPT_FRAMES, KEPT_PIXELS),
                                 generator=gen, device=dev)
        self.kept = torch.zeros((KEPT_FRAMES, KEPT_PIXELS, 3),
                                dtype=torch.float32, device=dev)

    def samples(self, stream: int, i: int, dev=None):
        dev = dev or self.prog.device
        gen = sampling.generator(dev, self.seed, stream, i)
        return sampling.frame_samples(self.cell.workload["sampling"],
                                      self.render, gen, dev, self.cell.base)

    def draw(self, cam_s, bounce_s):
        from prismarine_core_tpu_torch.render import integrator
        p = self.prog
        return integrator.render_with_samples(p.scene, p.camera, p.cfg,
                                              cam_s, bounce_s)

    def frame(self, stream: int, i: int, keep: bool = True):
        img = self.draw(*self.samples(stream, i))
        if keep and i < KEPT_FRAMES:
            torch.index_select(img.reshape(-1, 3), 0, self.pix[i],
                               out=self.kept[i])
        return img

    def warmup(self):
        for i in range(WARMUP_FRAMES):
            self.frame(sampling.WARMUP, i, keep=False)
        program.sync(self.prog.device)

    def unit(self, i: int):
        self.frame(sampling.WINDOW, i)

    def sync_probe(self):
        """One frame's render on samples drawn beforehand, for counting
        its host syncs."""
        samples = self.samples(sampling.WARMUP, WARMUP_FRAMES)
        return lambda: self.draw(*samples)

    def e2e(self, times, window_s) -> dict:
        return {"frame_ms": 1e3 * window_s / len(times),
                "frame_ms_p95": 1e3 * float(np.percentile(times, 95))}

    def failed(self, n: int) -> int:
        k = min(n, KEPT_FRAMES)
        return int((~torch.isfinite(self.kept[:k]).all(-1).all(-1)).sum())

    def free(self):
        """Keep the checked pixels, drop the program."""
        self.kept = self.kept.cpu()
        self.pix = self.pix.cpu()
        self.prog = None

    def _checked_frames(self, n: int) -> list:
        k = min(n, KEPT_FRAMES)
        rng = np.random.default_rng(
            sampling.stream_seed(self.seed, sampling.CHECK, 1))
        return np.sort(rng.choice(k, size=min(
            self.cell.workload["check"]["frames"], k), replace=False)).tolist()

    def reference(self, frames: list, arrays: dict, dev, dtype):
        """The reference's radiance at the kept pixels of ``frames``, each
        the mean of its ``spp`` paths."""
        ref_scene = tracer.build_scene(arrays, dev, dtype)
        index = tracer.scene_index(ref_scene)
        out = []
        for j in frames:
            cam_s, bounce_s = self.samples(sampling.WINDOW, j, dev)
            pix = self.pix[j].to(dev)
            lanes = tracer.pixel_lanes(self.render, pix)
            out.append(tracer.render_pixels(
                ref_scene, index, self.cell.config["camera"], self.render,
                cam_s[lanes], bounce_s[:, lanes], pix).float())
        return torch.cat(out)

    def check(self, n: int, arrays: dict, dev) -> dict:
        """The reference over the kept pixels of a sample of the frames,
        drawn from the seed."""
        frames = self._checked_frames(n)
        want = self.reference(frames, arrays, dev, torch.float32)
        got = torch.cat([self.kept[j].to(dev) for j in frames])
        return compare.frames_numbers(got, want)

    def control(self, n: int, arrays: dict, dev) -> dict:
        """The check with the reference in bfloat16 in the program's
        place."""
        frames = self._checked_frames(n)
        return compare.frames_numbers(
            self.reference(frames, arrays, dev, torch.bfloat16),
            self.reference(frames, arrays, dev, torch.float32))
