"""3D Morton codes (30-bit, and 60-bit as two halves), computed in int64.

The counterpart of ``prismarine_core_tpu.ops.morton``.  Torch has no
uint32, and an int32 code with bit 31 set (the BVH's invalid-triangle key,
the ray sort's dead-lane bit) would sort first; int64 holds every u32 key
with its unsigned order.
"""

from __future__ import annotations

import torch


def _part1by2_10(x):
    """Spread 10 bits: bit i -> bit 3i."""
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton30(q):
    """q: int[..., 3] with components in [0, 1023] -> int64[...] codes."""
    return (_part1by2_10(q[..., 0])
            | (_part1by2_10(q[..., 1]) << 1)
            | (_part1by2_10(q[..., 2]) << 2))


def morton60(q):
    """q: int[..., 3] with components in [0, 2^20) -> (hi, lo) int64 codes
    of the high and low 10-bit halves; (hi, lo) compares lexicographically
    as the interleaved 60-bit code does."""
    return morton30((q >> 10) & 0x3FF), morton30(q & 0x3FF)


def quantize_unit(p, bits: int = 10):
    """Map unit-cube positions onto the lattice [0, 2^bits - 1]
    (truncation, like the JAX package's float -> uint32 cast)."""
    scale = float((1 << bits) - 1)
    return (torch.clamp(p, 0.0, 1.0) * scale).to(torch.int64)
