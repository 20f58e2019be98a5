"""ctypes bindings of the host graph code the port shares with the JAX
package (the port's counterpart of its ``native.py``).

The pointer-chasing half of normal orientation and of surface meshing —
Prim's MST with sign propagation, union-find components and ball-pivoting
front propagation — lives in the repository's ``native/src/graph_ops.cpp``
and ``native/src/ball_pivot.cpp``. The port compiles those two sources
itself with ``g++`` and the flags of ``native/Makefile`` into
``build/native/libslnative_<hash>.so`` at the repository root
(git-ignored), so both packages run the same code on one host; it writes
nothing into ``native/``. The hash covers the sources and the flags; the
library is written under a temporary name and renamed into place, so
concurrent first users never load a half-written file.

As in the JAX package, the library is an accelerator of host work, never a
hard dependency: :func:`available` is False when the build or the load
fails (logged once as a warning), and the callers take their fallbacks —
the scipy MST for ``"tangent"`` orientation, the trimmed Poisson solve for
mode ``"surface"``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parents[1]
_SOURCES = (_ROOT / "native" / "src" / "graph_ops.cpp",
            _ROOT / "native" / "src" / "ball_pivot.cpp")
_BUILD_DIR = _ROOT / "build" / "native"
# native/Makefile:5-6 (CXXFLAGS, LDFLAGS).
_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
          "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libslnative_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    cxx = shutil.which("g++") or "g++"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
    try:
        subprocess.run([cxx, *_FLAGS, "-o", str(tmp), *map(str, _SOURCES)],
                       check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> None:
    i32 = ctypes.c_int32
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(i32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.sl_mst_orient_normals.argtypes = [i32, i32, f32p, f32p, i32p, u8p,
                                          f32p]
    lib.sl_mst_orient_normals.restype = i32
    lib.sl_connected_components.argtypes = [i32, i32, i32p, u8p, i32p]
    lib.sl_connected_components.restype = i32
    lib.sl_ball_pivot.argtypes = [i32, f32p, f32p, f32p, i32, i32p, i32,
                                  i32]
    lib.sl_ball_pivot.restype = i32


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None) or e
            log.warning("native library unavailable (%s); using the Python "
                        "fallbacks", detail)
            return None
        _declare(lib)
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library built (or was already built) and loaded."""
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native layer unavailable")
    return lib


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _graph(nbr_idx, nbr_ok) -> tuple[np.ndarray, np.ndarray]:
    idx = np.ascontiguousarray(nbr_idx, np.int32)
    ok = np.ascontiguousarray(nbr_ok, np.uint8)
    if idx.ndim != 2 or ok.shape != idx.shape:
        raise ValueError(f"neighbour table {idx.shape} and mask {ok.shape} "
                         "must be one (n, k) shape")
    if idx.size and ((idx < 0) | (idx >= idx.shape[0]))[ok != 0].any():
        raise ValueError("a valid neighbour index is out of range")
    return idx, ok


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def mst_orient_normals(points, normals, nbr_idx, nbr_ok,
                       seed_dir=(0.0, 0.0, 0.0)) -> tuple[np.ndarray, int]:
    """Consistently oriented copy of ``normals`` (Prim's MST over the
    symmetrised KNN graph, signs propagated along it) and the number of
    components."""
    lib = _require()
    pts = _f32(points)
    nrm = _f32(normals).copy()
    idx, ok = _graph(nbr_idx, nbr_ok)
    n, k = idx.shape
    if pts.shape != (n, 3) or nrm.shape != (n, 3):
        raise ValueError("points and normals must be (n, 3) for an (n, k) "
                         "graph")
    sd = _f32(np.asarray(seed_dir, np.float32))
    comps = lib.sl_mst_orient_normals(
        n, k, _ptr(pts, ctypes.c_float), _ptr(nrm, ctypes.c_float),
        _ptr(idx, ctypes.c_int32), _ptr(ok, ctypes.c_uint8),
        _ptr(sd, ctypes.c_float))
    return nrm, int(comps)


def connected_components(nbr_idx, nbr_ok) -> tuple[np.ndarray, int]:
    """(labels (n,), count) of the undirected KNN graph's components."""
    lib = _require()
    idx, ok = _graph(nbr_idx, nbr_ok)
    n, k = idx.shape
    labels = np.empty(n, np.int32)
    count = lib.sl_connected_components(n, k, _ptr(idx, ctypes.c_int32),
                                        _ptr(ok, ctypes.c_uint8),
                                        _ptr(labels, ctypes.c_int32))
    return labels, int(count)


def ball_pivot(points, normals, radii,
               max_hole_edges: int = 12) -> np.ndarray:
    """(T, 3) int32 triangles by ball pivoting over the sorted ``radii``;
    boundary loops of up to ``max_hole_edges`` edges are filled afterwards
    (0 disables)."""
    lib = _require()
    pts = _f32(points)
    nrm = _f32(normals)
    if pts.ndim != 2 or pts.shape[1] != 3 or nrm.shape != pts.shape:
        raise ValueError("points and normals must be one (n, 3) shape")
    rad = _f32(np.sort(np.asarray(radii, np.float32)))
    n = len(pts)
    cap = max(4 * n, 1024)
    for _ in range(2):
        out = np.empty((cap, 3), np.int32)
        rc = lib.sl_ball_pivot(n, _ptr(pts, ctypes.c_float),
                               _ptr(nrm, ctypes.c_float),
                               _ptr(rad, ctypes.c_float), len(rad),
                               _ptr(out, ctypes.c_int32), cap,
                               int(max_hole_edges))
        if rc >= 0:
            return out[:rc].copy()
        cap = -rc  # the buffer was too small: retry at the reported need
    raise RuntimeError("ball_pivot: buffer negotiation failed")
