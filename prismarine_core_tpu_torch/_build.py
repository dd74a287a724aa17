"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

At the first CUDA launch, ``library()`` compiles every ``csrc/*.cu`` with
nvcc (one process per source, all started together, then one link) into
one shared library with a plain C interface, under
``build/torch_kernels/`` beside the package (a directory git ignores), and
loads it with ``ctypes``.  The library's file name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing here runs at import.

Every C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch; ``check``
turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of every entry point: (argtypes), all return int
_SIGNATURES = {
    # rays, box_rows, n_live, out, n_tiles, nb_pad, stream
    "block_cull_launch": (_P, _P, _P, _P, _I, _I, _P),
    # pair_tile, pair_sb, n_real, rays, sb_boxes, out, n_pairs, stream
    "pair_cull_launch": (_P, _P, _P, _P, _P, _P, _I, _P),
    # tile_start, pair_tile, pair_sb, pair_mask, n_real, rays, planes,
    # prior_t, prior_slot, keys, csum, unit_pair, out_t, out_slot, n_rows,
    # n_pairs, unit, stream
    "sb_intersect_launch": (_P,) * 14 + (_I, _I, _I, _P),
    # nodes, slots, o, d, t_cap, out_t, out_slot, next_ray, n_rays,
    # n_nodes, leaf_size, any_hit, stream
    "bvh_walk_launch": (_P,) * 8 + (_I, _I, _I, _I, _P),
    # soup, uvs, mats, tri, u, v, ns, ng, uv, tang, diffuse, specular,
    # emissive, transmission, ior, tex, n_rays, textured, bump, stream
    "surface_fields_launch": (_P,) * 16 + (_I, _I, _I, _P),
    # quad, sizes, uv, ns, tang, diffuse, specular, emissive, tex_diffuse,
    # tex_specular, tex_emissive, tex_bump, out ns, albedo, emissive,
    # rough, metal, n_rays, n_tex, h, w, kinds, stream
    "texture_fields_launch": (_P,) * 17 + (_I,) * 5 + (_P,),
    # in[23], out[17], ints[12], floats[3] (ops/shade.py), stream
    "shade_launch": (_P,) * 5,
    # radiance, factor, occ, out, n_rays, stream
    "nee_resolve_launch": (_P,) * 4 + (_I, _P),
}
# the "mt2" and "mxu" walks take the "mt" walk's arguments
_SIGNATURES["sb_intersect_mt2_launch"] = _SIGNATURES["sb_intersect_launch"]
_SIGNATURES["sb_intersect_mxu_launch"] = _SIGNATURES["sb_intersect_launch"]

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libprismarine_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless a library for these exact sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (p.stem + ".o") for p in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c",
                 "-o", str(o), str(p)] for p, o in zip(cu, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        logs = [p.communicate()[1] for p in procs]   # waits for every one
        tmp_out = Path(tmp) / out.name
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_out),
                *map(str, objs)]
        for cmd, proc, err in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{err}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stderr}")
        (BUILD_DIR / (out.stem + ".ptxas.txt")).write_text("".join(logs))
        os.replace(tmp_out, out)          # atomic: no half-written library
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


class Records:
    """A kernel's packed records, kept for the last source tensors they
    were packed from and reused while every source tensor keeps its
    storage, layout and version.  The key holds each tensor's data
    pointer, shape, strides, dtype, device and version counter (shared
    with every view and detached copy, so an in-place write changes it),
    and the entry holds the tensors themselves, so no other tensor can
    take their addresses while it is kept; a refit makes new tensors,
    hence a new key.  Inference tensors keep no version counter: their
    records are packed at every call."""

    def __init__(self):
        self._entry = None      # (key, source tensors, records)

    def get(self, srcs, pack):
        """The records ``pack()`` builds from the tensors ``srcs``, packed
        outside autograd."""
        import torch
        if any(t.is_inference() for t in srcs):
            with torch.no_grad():
                return pack()
        key = tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype,
                     t.device, t._version) for t in srcs)
        if self._entry is None or self._entry[0] != key:
            with torch.no_grad():
                self._entry = (key, srcs, pack())
        return self._entry[2]


def check_tensor(t, dtype, shape, name, device=None, numel=None):
    """Validate a kernel argument before its pointer is passed: a CUDA
    tensor (on ``device`` when given) of ``dtype``, ``shape`` (or
    ``numel`` elements), contiguous, outside any autograd graph (a kernel
    sees only the pointer)."""
    import torch
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} must hold {numel} element(s)")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.requires_grad:
        raise ValueError(f"{name} requires grad: detach it before the "
                         "kernel (no gradient flows through a kernel)")
