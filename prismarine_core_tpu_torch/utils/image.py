"""Image output: tonemapped PNG + Radiance HDR (.hdr) + raw .npy.

The counterpart of ``prismarine_core_tpu.utils.image``.  Every writer
takes a numpy array or a tensor on any device (copied to the host once).
The PNG is written here with ``zlib`` and ``struct`` (8-bit RGB, filter 0
on every row), so no image library is needed; it holds the same pixels
as the JAX package's file.  ``save_hdr`` writes the same bytes as the
JAX package's.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _host(img) -> np.ndarray:
    """``img`` as a float32 numpy array (a tensor leaves its device)."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return np.asarray(img, np.float32)


def tonemap(img, exposure: float = 1.0, gamma: float = 2.2) -> np.ndarray:
    """Exposure + gamma to 8-bit (clamped to [0, 1] first)."""
    x = np.clip(_host(img) * exposure, 0.0, 1.0)
    x = x ** (1.0 / gamma)
    return (x * 255.0 + 0.5).astype(np.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _encode_png(rgb: np.ndarray) -> bytes:
    """PNG bytes of a uint8[H,W,3] image: 8-bit RGB, no interlace, filter
    type 0 (none) on every row, one IDAT chunk."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"_encode_png takes RGB, got {c} channels")
    rows = np.zeros((h, 1 + 3 * w), np.uint8)   # leading 0: filter none
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_png(path: str, img, exposure: float = 1.0) -> None:
    with open(path, "wb") as f:
        f.write(_encode_png(tonemap(img, exposure)))


def save_hdr(path: str, img) -> None:
    """Write Radiance RGBE (.hdr), flat (non-RLE) scanlines."""
    img = _host(img)
    h, w, _ = img.shape
    maxc = np.maximum(img.max(axis=-1), 1e-32)
    exp = np.ceil(np.log2(maxc)).astype(np.int32)
    mant = img / (2.0 ** exp[..., None])
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(mant * 256.0, 0, 255).astype(np.uint8)
    rgbe[..., 3] = (exp + 128).astype(np.uint8)
    rgbe[maxc < 1e-30] = 0
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def load_hdr(path: str) -> np.ndarray:
    """Read back flat RGBE written by save_hdr."""
    with open(path, "rb") as f:
        data = f.read()
    idx = data.index(b"\n\n") + 2
    nl = data.index(b"\n", idx)
    dims = data[idx:nl].split()
    h, w = int(dims[1]), int(dims[3])
    rgbe = np.frombuffer(data[nl + 1:], np.uint8).reshape(h, w, 4)
    exp = rgbe[..., 3].astype(np.int32) - 128
    img = rgbe[..., :3].astype(np.float32) / 256.0 * (2.0 ** exp[..., None])
    img[rgbe[..., 3] == 0] = 0.0
    return img


def save_npy(path: str, img) -> None:
    np.save(path, _host(img))
