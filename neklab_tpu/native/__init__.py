"""ctypes bindings for the native (C++) mesh-preprocessing library.

Compiled from the committed source on first use with g++, for whatever host
runs it (no host-specific instruction set), and cached next to the source;
every entry point has a pure-Python fallback so the package works without a
toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "neklab_native.cpp")
_SO = os.path.join(_DIR, "libneklab_native.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            # build beside the target and rename, so processes that build at
            # the same time never load a half-written library
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.nt_adjacency_coloring.restype = ctypes.c_int64
        lib.nt_adjacency_coloring.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i32p, i32p]
        lib.nt_rcb_partition.restype = None
        lib.nt_rcb_partition.argtypes = [ctypes.c_int64, ctypes.c_int32, f64p, ctypes.c_int32, i32p]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def adjacency_colorings(gidx: np.ndarray, nel: int) -> tuple[np.ndarray, np.ndarray] | None:
    """(colors_distance1, colors_distance2) for the element graph, or None if
    the native library is unavailable. gidx: any layout; reshaped to
    [nel, npts] in element-major order by the caller."""
    lib = _load()
    if lib is None:
        return None
    g = np.ascontiguousarray(gidx.reshape(nel, -1), dtype=np.int64)
    c2 = np.zeros(nel, dtype=np.int32)
    c3 = np.zeros(nel, dtype=np.int32)
    rc = lib.nt_adjacency_coloring(nel, g.shape[1], g, c2, c3)
    if rc < 0:
        return None
    return c2.astype(np.int64), c3.astype(np.int64)


def rcb_partition(centroids: np.ndarray, nparts: int) -> np.ndarray | None:
    """Balanced element partition by recursive coordinate bisection."""
    lib = _load()
    if lib is None:
        return None
    c = np.ascontiguousarray(centroids, dtype=np.float64)
    part = np.zeros(c.shape[0], dtype=np.int32)
    lib.nt_rcb_partition(c.shape[0], c.shape[1], c, nparts, part)
    return part.astype(np.int64)
