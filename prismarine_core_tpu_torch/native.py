"""ctypes binding of the native OBJ parser (``native/src/objparse.cc``).

The port's own copy of ``prismarine_core_tpu.native``: the same plain C
ABI (``obj_parse``, ``obj_counts``, ``obj_fill``, ``obj_mat_name``,
``obj_mtllib``, ``obj_free``), built on first use with
``g++ -O3 -std=c++17 -shared -fPIC`` into ``build/torch_native/`` beside
the package (a directory git ignores).  The library's file name carries a
hash of the source and flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing here runs at import.

``library()`` raises when the library cannot be built or loaded;
``get_lib()`` returns None instead (the optional path of ``load_obj``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent
SRC = _ROOT / "native" / "src" / "objparse.cc"
BUILD_DIR = _ROOT / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_F = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)
#: (restype, argtypes) of every entry point
_SIGNATURES = {
    "obj_parse": (_P, [ctypes.c_char_p]),
    "obj_counts": (None, [_P, _I64P, _I64P]),
    "obj_mat_name": (ctypes.c_char_p, [_P, ctypes.c_int64]),
    "obj_mtllib": (ctypes.c_char_p, [_P]),
    # handle, v0 v1 v2 n0 n1 n2 (f32[N,3]), t0 t1 t2 (f32[N,2]), mat i32[N]
    "obj_fill": (None, [_P] + [_F] * 9 + [ctypes.POINTER(ctypes.c_int32)]),
    "obj_free": (None, [_P]),
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libprismarine_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the parser unless a library for this exact source exists;
    raises with the compiler's output when the build fails."""
    if not SRC.exists():
        raise RuntimeError(f"native parser source missing: {SRC}")
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp_out)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native parser build failed: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"native parser build failed "
                               f"({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(tmp_out, out)          # atomic: no half-written library
    return out


def library() -> ctypes.CDLL:
    """The loaded parser library (built on first call); raises when it
    cannot be built or loaded."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _lib = lib
        return _lib


def get_lib():
    """The parser library, or None when it cannot be built or loaded."""
    try:
        return library()
    except (RuntimeError, OSError):
        return None


def parse_obj_native(path: str, lib=None):
    """Parse OBJ geometry natively.

    Returns a dict with v0..v2, n0..n2 f32[N,3], t0..t2 f32[N,2],
    mat i32[N], mat_names list[str] and mtllib str, or None when the file
    cannot be read or holds no face.  ``lib`` defaults to ``library()``
    (which raises when the parser is unavailable)."""
    lib = library() if lib is None else lib
    h = lib.obj_parse(os.fsencode(path))
    if not h:
        return None
    try:
        n_tris = ctypes.c_int64()
        n_mats = ctypes.c_int64()
        lib.obj_counts(h, ctypes.byref(n_tris), ctypes.byref(n_mats))
        n = n_tris.value
        if n == 0:
            return None
        f3 = [np.empty((n, 3), np.float32) for _ in range(6)]
        f2 = [np.empty((n, 2), np.float32) for _ in range(3)]
        mat = np.empty((n,), np.int32)

        def fp(a):
            return a.ctypes.data_as(_F)

        lib.obj_fill(h, *map(fp, f3), *map(fp, f2),
                     mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        names = [lib.obj_mat_name(h, i).decode("utf-8", "replace")
                 for i in range(n_mats.value)]
        mtllib = lib.obj_mtllib(h).decode("utf-8", "replace")
        return {
            "v0": f3[0], "v1": f3[1], "v2": f3[2],
            "n0": f3[3], "n1": f3[4], "n2": f3[5],
            "t0": f2[0], "t1": f2[1], "t2": f2[2],
            "mat": mat, "mat_names": names, "mtllib": mtllib,
        }
    finally:
        lib.obj_free(h)
