"""The benchmark's frozen sample generators and seed streams.

A frozen copy of the port's frame uniforms
(``prismarine_core_tpu_torch/ops/sampling.py:make_sample_arrays`` and
``make_coherent_sample_arrays``, without the tile lane order that no
configuration here turns on): the port's layouts, cam f32[R,4] and bounce
f32[B,R,11], drawn on the device from a ``torch.Generator`` in the same
calls and order, so they equal the port's for the same generator state
(``tests/test_bench_port_inputs.py``).

Every draw of a run comes from ``stream_seed(seed, stream, index)``: the
run's ``--seed``, a stream (window frames or steps, warm-up, the train
step's first steps, check samples) and the frame or step index.  The same
seed gives the same inputs; two streams never share a generator state.
"""

from __future__ import annotations

import numpy as np
import torch

SAMPLES_PER_CAMERA_RAY = 4
SAMPLES_PER_BOUNCE = 11

#: the streams of a run
WINDOW, WARMUP, FIRST_STEPS, CHECK, TARGET = range(5)


def stream_seed(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit generator seed for (run seed, stream, index).  Any whole
    number is a valid run seed: it enters the hash as its 32-bit words."""
    words = []
    s = abs(int(seed))
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            break
    words.append(int(seed < 0))
    state = np.random.SeedSequence(words + [stream, index]).generate_state(
        2, dtype=np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device, seed: int, stream: int, index: int = 0):
    """A generator on ``device`` at (seed, stream, index)."""
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream, index))


def independent_samples(gen, n_rays: int, bounces: int, device):
    """Independent uniforms of one frame: (cam f32[R,4], bounce
    f32[B,R,11])."""
    cam = torch.rand((n_rays, SAMPLES_PER_CAMERA_RAY), generator=gen,
                     device=device)
    bounce = torch.rand((bounces, n_rays, SAMPLES_PER_BOUNCE),
                        generator=gen, device=device)
    return cam, bounce


def coherent_samples(gen, width: int, height: int, spp: int, bounces: int,
                     block, device):
    """Block-coherent uniforms of one frame: every ray of a ``block``
    (rows, columns) pixel block of an spp plane shares its bounce rows;
    camera jitter stays per ray.  (cam f32[R,4], bounce f32[B,R,11]) in
    [spp, H, W] row-major lane order."""
    n_rays = width * height * spp
    cam = torch.rand((n_rays, SAMPLES_PER_CAMERA_RAY), generator=gen,
                     device=device)
    bh, bw = block
    nby = -(-height // bh)
    nbx = -(-width // bw)
    ub = torch.rand((bounces, spp, nby * nbx, SAMPLES_PER_BOUNCE),
                    generator=gen, device=device)
    by = torch.arange(height, device=device) // bh
    bx = torch.arange(width, device=device) // bw
    bid = (by[:, None] * nbx + bx[None, :]).reshape(-1)
    bounce = ub[:, :, bid, :].reshape(bounces, n_rays, SAMPLES_PER_BOUNCE)
    return cam, bounce


def frame_samples(spec: dict, render: dict, gen, device, base=None):
    """A frame's uniforms under a workload's ``sampling`` block, drawn by
    the sampler its ``kind`` names (``samplers/<kind>.py``), at a
    configuration's ``render`` block."""
    from bench_port import plugins
    mod = plugins.load("samplers", spec["kind"], base or plugins.HERE)
    return mod.draw(spec, render, gen, device)
