"""ctypes bindings of the host code the port shares with the JAX package
(the port's counterpart of its ``native.py``).

The repository's ``native/src`` holds the pointer-chasing host work: the
PLY and STL writers (``ply_codec.cpp``), Prim's MST with sign propagation,
union-find components and DBSCAN labelling (``graph_ops.cpp``),
ball-pivoting front propagation (``ball_pivot.cpp``) and an exact grid KNN
(``grid_knn.cpp``). The port compiles those four sources itself with
``g++`` and the flags of ``native/Makefile`` into
``build/native/libslnative_<hash>.so`` at the repository root
(git-ignored), so both packages run the same code on one host; it writes
nothing into ``native/``. The hash covers the sources and the flags; the
library is written under a temporary name and renamed into place, so
concurrent first users never load a half-written file.

As in the JAX package, the library is an accelerator of host work, never a
hard dependency of a path: :func:`available` is False when the build or the
load fails (logged once as a warning), and the callers take their
fallbacks — the scipy MST for ``"tangent"`` orientation, the trimmed
Poisson solve for mode ``"surface"``. Every binding itself raises
``RuntimeError`` without the library. As in the JAX package, no path of the
port calls ``ply_write``, ``stl_write``, ``dbscan_labels`` or ``grid_knn``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parents[1]
# native/Makefile:9 (SRC), in its order.
_SOURCES = tuple(_ROOT / "native" / "src" / name for name in (
    "ply_codec.cpp", "graph_ops.cpp", "ball_pivot.cpp", "grid_knn.cpp"))
_BUILD_DIR = _ROOT / "build" / "native"
# native/Makefile:5-6 (CXXFLAGS, LDFLAGS).
_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
          "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
# Seconds the g++ build took in this process (None: the library was already
# built, or the load has not run yet).
build_seconds: float | None = None


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libslnative_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    global build_seconds
    cxx = shutil.which("g++") or "g++"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
    t0 = time.perf_counter()
    try:
        subprocess.run([cxx, *_FLAGS, "-o", str(tmp), *map(str, _SOURCES)],
                       check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0


def _declare(lib: ctypes.CDLL) -> None:
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(i32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.sl_ply_write.argtypes = [ctypes.c_char_p, i64, f32p, u8p, f32p, i32]
    lib.sl_ply_write.restype = i32
    lib.sl_stl_write.argtypes = [ctypes.c_char_p, i64, f32p, i64, i32p]
    lib.sl_stl_write.restype = i32
    lib.sl_dbscan_labels.argtypes = [i32, i32, i32p, u8p, u8p, i32p]
    lib.sl_dbscan_labels.restype = i32
    lib.sl_mst_orient_normals.argtypes = [i32, i32, f32p, f32p, i32p, u8p,
                                          f32p]
    lib.sl_mst_orient_normals.restype = i32
    lib.sl_connected_components.argtypes = [i32, i32, i32p, u8p, i32p]
    lib.sl_connected_components.restype = i32
    lib.sl_ball_pivot.argtypes = [i32, f32p, f32p, f32p, i32, i32p, i32,
                                  i32]
    lib.sl_ball_pivot.restype = i32
    lib.sl_grid_knn.argtypes = [i32, f32p, i32, f32p, i32, ctypes.c_float,
                                i32, i32p, f32p]
    lib.sl_grid_knn.restype = None


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


def _xyz(a, what: str) -> np.ndarray:
    a = _f32(a)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"{what} must be (n, 3), got {a.shape}")
    return a


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def ply_write(path, points, colors=None, normals=None,
              binary: bool = True) -> None:
    """Write a PLY point cloud (binary little-endian, or ASCII at six
    decimals); ``colors`` (n, 3) uint8 and ``normals`` (n, 3) may be None."""
    lib = _require()
    pts = _xyz(points, "points")
    n = len(pts)
    col = None if colors is None else np.ascontiguousarray(colors, np.uint8)
    nrm = None if normals is None else _xyz(normals, "normals")
    for name, a in (("colors", col), ("normals", nrm)):
        if a is not None and a.shape != (n, 3):
            raise ValueError(f"{name} must be ({n}, 3), got {a.shape}")
    rc = lib.sl_ply_write(
        os.fsencode(path), n, _ptr(pts, ctypes.c_float),
        None if col is None else _ptr(col, ctypes.c_uint8),
        None if nrm is None else _ptr(nrm, ctypes.c_float),
        1 if binary else 0)
    if rc != 0:
        raise OSError(f"native PLY write failed ({rc}): {path}")


def stl_write(path, vertices, faces) -> None:
    """Write a binary STL of the (F, 3) triangles over ``vertices``."""
    lib = _require()
    v = _xyz(vertices, "vertices")
    f = np.ascontiguousarray(faces, np.int32)
    if f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"faces must be (F, 3), got {f.shape}")
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("a face index is out of range")
    rc = lib.sl_stl_write(os.fsencode(path), len(v), _ptr(v, ctypes.c_float),
                          len(f), _ptr(f, ctypes.c_int32))
    if rc != 0:
        raise OSError(f"native STL write failed ({rc}): {path}")


def dbscan_labels(nbr_idx, nbr_ok, core) -> tuple[np.ndarray, int]:
    """(labels (n,), cluster count) of DBSCAN over a KNN graph: clusters
    grow from the ``core`` points along valid edges; -1 is noise."""
    lib = _require()
    idx, ok = _graph(nbr_idx, nbr_ok)
    co = np.ascontiguousarray(core, np.uint8)
    n, k = idx.shape
    if co.shape != (n,):
        raise ValueError(f"core must be ({n},), got {co.shape}")
    labels = np.empty(n, np.int32)
    count = lib.sl_dbscan_labels(n, k, _ptr(idx, ctypes.c_int32),
                                 _ptr(ok, ctypes.c_uint8),
                                 _ptr(co, ctypes.c_uint8),
                                 _ptr(labels, ctypes.c_int32))
    return labels, int(count)


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


def grid_knn(points, k: int, queries=None, cell_size: float = 0.0,
             exclude_self: bool | None = None):
    """Exact host KNN over a uniform grid: (d2 (m, k) float32, idx (m, k)
    int32), ascending; idx -1 where fewer than k points exist.
    ``queries=None`` queries the points themselves, and then excludes each
    point from its own list unless ``exclude_self`` says otherwise;
    ``cell_size`` 0 lets the library choose."""
    lib = _require()
    pts = _xyz(points, "points")
    self_query = queries is None
    q = pts if self_query else _xyz(queries, "queries")
    if exclude_self is None:
        exclude_self = self_query
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    m, n = len(q), len(pts)
    idx = np.empty((m, k), np.int32)
    d2 = np.empty((m, k), np.float32)
    lib.sl_grid_knn(n, _ptr(pts, ctypes.c_float), m,
                    _ptr(q, ctypes.c_float), k, cell_size,
                    1 if exclude_self else 0, _ptr(idx, ctypes.c_int32),
                    _ptr(d2, ctypes.c_float))
    return d2, idx
