"""Compile ``csrc/*.cu`` with ``nvcc`` into one shared library with a plain
C interface, at first use, and load it with ``ctypes``.

Every source is compiled for ``sm_90a`` by its own ``nvcc -c``, all started
together, and one more ``nvcc -shared`` links the objects into
``build/torch_kernels/libslkernels_<hash>.so`` at the repository root
(git-ignored). The hash covers the sources and the flags, so a source change
rebuilds; an existing library with the right hash is loaded as is. The
library is written under a temporary name and renamed into place, so
concurrent first users never load a half-written file.
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

log = logging.getLogger(__name__)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# No --use_fast_math and no -ftz=true: classify compares against iso with
# gradual underflow, and matvec, the TSDF combine and the brick KNN round op
# by op (true division included) like their plain versions; the splat
# composite keeps the accurate expf.
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
          "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# name -> argtypes of every extern "C" launcher; each returns cudaError_t.
_SIGNATURES = {
    # stack, col, row, B, F, H, W, col_bits, row_bits, downsample, stream
    "sl_decode_maps": (_P, _P, _P, _L, _I, _L, _L, _I, _I, _I, _P),
    # queries, keys_t, p2v, d2, idx, M, N, splits, per_lane, stream
    "sl_nearest_one": (_P, _P, _P, _P, _P, _L, _L, _I, _I, _P),
    # x, W, nbr, block_valid, out, M, stream
    "sl_matvec_band": (_P, _P, _P, _P, _P, _L, _P),
    # c9, iso, block_valid, active, M, stream
    "sl_classify_cells": (_P, _P, _P, _P, _L, _P),
    # tsdf, weight, rgb, num, den, rgbnum, tsdf_out, weight_out, rgb_out,
    # n, max_weight, stream
    "sl_tsdf_combine": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L,
                        ctypes.c_float, _P),
    # bricks, nbr, nnb, cells, k, exclude_self, out_d, out_i, stream
    "sl_brick_knn": (_P, _P, _P, _L, _I, _I, _P, _P, _P),
    # u, v, ca, cb, cc, cr, cg, cbl, opa, ok, x0, y0, rgb_out, a_out, nt, k,
    # tile, stream
    "sl_composite_cells": (*(_P,) * 14, _L, _L, _I, _P),
}

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None   # wall time of this process's build
build_log = ""   # nvcc's output of that build (ptxas registers, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ at first use and need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libslkernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise on the first failure. Returns
    their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{o}")
    return "".join(outs)


def _compile(out: Path) -> None:
    global build_seconds, build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{src.stem}.o") for src in _sources()]
    tmp = out.with_name(f"{tag}.so.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        build_log = _run([[nvcc, *_FLAGS, "-c", "-o", str(o), str(src)]
                          for src, o in zip(_sources(), objs)])
        build_log += _run([[nvcc, *_ARCH, "-shared", "-o", str(tmp),
                            *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    log.info("built %s in %.1f s", out.name, build_seconds)


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a launcher's non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
