"""Cloud → printable mesh workflows (counterpart of the JAX
``models/meshing.py``): estimate and orient normals, run the screened
Poisson solve, extract, write STL.

The analogue of the reference's `ProcessingLogic.reconstruct_stl`
(`server/processing.py:184-249`) and `ProcessingLogic.mesh_360`
(`server/processing.py:251-310`). Orientation modes mirror
`server/processing.py:267-289`:

* ``"radial"``  — orient toward the cloud centre, then negate (outward);
* ``"tangent"`` — Hoppe MST propagation, falling back to radial on failure
  like the reference's try/except at `:284-289`;
* ``"camera"``  — toward an explicit camera location.

Mode ``"watertight"`` with representation ``"poisson"``: depth ≤ 8 solves
on a dense grid (:mod:`..ops.poisson`), depth 9-13 on the band-sparse one
(:mod:`..ops.poisson_sparse`, kernel ``csrc/matvec.cu``), extracted by the
device marching extractor on the card (kernel ``csrc/classify.cu``) or by
the host oracle. Not ported yet, each raising an error that names the
ROADMAP step that brings it: mode ``"surface"`` (native ball pivoting,
step 9), representations ``"tsdf"`` and ``"archival"`` (step 5),
``cg_x0`` and :func:`mesh_from_cloud_async` (step 5), ``device_mesh``
(step 8).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .._device import resolve_device, stage_clock
from ..io.ply import PointCloud
from ..io.stl import TriangleMesh, write_stl
from ..ops import marching, orientation, poisson, poisson_sparse
from ..ops import pointcloud as pc_ops

log = logging.getLogger(__name__)

_not_ported = poisson_sparse._not_ported


def ensure_oriented_normals(
    cloud: PointCloud,
    mode: str = "radial",
    k: int = 30,
    camera: np.ndarray | None = None,
    device=None,
) -> np.ndarray:
    """Estimate (if absent) and globally orient normals on ``device``;
    stores them on ``cloud`` and returns them, (N, 3) float32."""
    dev = resolve_device(device)
    pts = np.asarray(cloud.points, np.float32)
    pts_t = torch.from_numpy(pts).to(dev)
    if cloud.normals is not None and len(cloud.normals) == len(pts):
        normals = np.asarray(cloud.normals, np.float32)
    else:
        normals = pc_ops.estimate_normals(pts_t, k=k)[0].cpu().numpy()

    def toward(location, outward):
        return pc_ops.orient_normals(
            pts_t, torch.from_numpy(np.ascontiguousarray(normals)).to(dev),
            torch.as_tensor(np.asarray(location, np.float32), device=dev),
            outward=outward).cpu().numpy()

    center = pts.mean(axis=0)
    if mode == "radial":
        # Toward the centre then negate → outward (`processing.py:270-277`).
        normals = toward(center, True)
    elif mode == "tangent":
        try:
            normals = orientation.orient_normals_consistent_tangent_plane(
                pts, normals, k=100, device=dev)
        except Exception as exc:  # the reference falls back to radial
            log.warning("tangent orientation failed (%s); radial fallback",
                        exc)
            normals = toward(center, True)
    elif mode == "camera":
        if camera is None:
            raise ValueError("orientation='camera' needs a camera location")
        normals = toward(camera, False)
    else:
        raise ValueError(f"unknown orientation mode {mode!r}")
    cloud.normals = normals
    return normals


def mesh_from_cloud(
    cloud: PointCloud,
    mode: str = "watertight",
    depth: int = 8,
    quantile_trim: float = 0.02,
    orientation_mode: str = "radial",
    camera: np.ndarray | None = None,
    cg_iters: int = 300,
    preconditioner: str = "additive",
    extraction: str = "auto",
    max_blocks: int | None = None,
    representation: str = "poisson",
    cg_x0=None,
    device_mesh=None,
    solve_stats: dict | None = None,
    timing: dict | None = None,
    device=None,
) -> TriangleMesh:
    """Poisson-mesh a cloud on ``device`` (the body of ``reconstruct_stl``
    and ``mesh_360``).

    ``quantile_trim`` drops the given density quantile of triangles
    (reference default 2%; 0.0 is fully watertight, the ``mesh_360``
    default). ``depth`` ≤ 8 solves on a 2^depth dense grid; depth 9-13 on
    the band-sparse solver with ``preconditioner`` (``"additive"`` or
    ``"jacobi"``), ``max_blocks`` (None = the solver's budget, with its
    overflow retry) and ``extraction`` (``"auto"`` = device marching on the
    card, the host oracle for a CPU run; ``"host"``; ``"device"``).
    ``solve_stats`` (a caller's dict) receives the sparse solver's stats.
    ``timing``, when given, receives wall seconds per stage, each measured
    with a device synchronize: ``normals_s``, then ``setup_s``,
    ``coarse_s``, ``fine_cg_s``, ``iso_s`` (sparse) or ``solve_s``
    (dense), and ``extract_s``."""
    if mode not in ("watertight", "surface"):
        raise ValueError(f"unknown mesh mode {mode!r}")
    if extraction not in ("auto", "host", "device"):
        raise ValueError(f"unknown extraction engine {extraction!r}")
    if representation not in ("poisson", "tsdf", "archival"):
        raise ValueError(f"unknown representation {representation!r} "
                         "(expected 'poisson', 'tsdf' or 'archival')")
    if representation != "poisson":
        raise _not_ported(f"representation={representation!r}",
                          "step 5 (streaming and TSDF)")
    if mode == "surface":
        raise _not_ported("mode='surface' (native ball pivoting)",
                          "step 9 (deep-mesh and surface options)")
    if cg_x0 is not None:
        raise _not_ported("the cg_x0 warm start", "step 5 (streaming)")
    if device_mesh is not None:
        raise _not_ported("the device_mesh sharded solve",
                          "step 8 (devices and serving)")
    dev = resolve_device(device)
    pts = np.asarray(cloud.points, np.float32)
    if pts.shape[0] < 16:
        raise ValueError(f"too few points to mesh ({pts.shape[0]})")
    clock = stage_clock(dev, timing)
    t0 = clock()
    normals = ensure_oriented_normals(cloud, orientation_mode, camera=camera,
                                      device=dev)
    pts_t = torch.from_numpy(pts).to(dev)
    nrm_t = torch.from_numpy(np.ascontiguousarray(normals)).to(dev)
    t1 = clock()
    if timing is not None:
        timing["normals_s"] = t1 - t0
    if int(depth) > 8:
        kw = {} if max_blocks is None else {"max_blocks": int(max_blocks)}
        grid, n_blocks, stats = poisson_sparse.reconstruct_sparse(
            pts_t, nrm_t, depth=int(depth), cg_iters=cg_iters,
            preconditioner=preconditioner, with_stats=True, timing=timing,
            **kw)
        stats["n_blocks"] = n_blocks
        if solve_stats is not None:
            solve_stats.update(stats)
        log.info("sparse Poisson depth=%d: %d active blocks", int(depth),
                 n_blocks)
        t2 = clock()
        mesh = marching.extract_sparse(grid, quantile_trim=quantile_trim,
                                       engine=extraction)
    else:
        grid = poisson.reconstruct(pts_t, nrm_t, depth=int(depth),
                                   cg_iters=cg_iters)
        t2 = clock()
        if timing is not None:
            timing["solve_s"] = t2 - t1
        mesh = marching.extract(grid, quantile_trim=quantile_trim)
    t3 = clock()
    if timing is not None:
        timing["extract_s"] = t3 - t2
    log.info("meshed %d points -> %d verts / %d faces (mode=%s depth=%d)",
             pts.shape[0], len(mesh.vertices), len(mesh.faces), mode, depth)
    return mesh


def mesh_from_cloud_async(cloud: PointCloud, *, task_name: str = "mesh",
                          **kw):
    """The overlapped-finalize worker of the JAX package; not ported."""
    raise _not_ported("mesh_from_cloud_async (utils/overlap.py)",
                      "step 5 (streaming)")


def reconstruct_stl(
    cloud: PointCloud,
    out_path: str,
    mode: str = "watertight",
    depth: int = 8,
    quantile_trim: float = 0.02,
    orientation_mode: str = "radial",
    device=None,
    **kw,
) -> TriangleMesh:
    """Cloud → STL file (drop-in for `ProcessingLogic.reconstruct_stl`,
    `server/processing.py:184-249`), meshed on ``device``."""
    mesh = mesh_from_cloud(cloud, mode=mode, depth=depth,
                           quantile_trim=quantile_trim,
                           orientation_mode=orientation_mode, device=device,
                           **kw)
    _write(out_path, mesh, kw.get("timing"))
    return mesh


def mesh_360(
    cloud: PointCloud,
    out_path: str,
    depth: int = 8,
    quantile_trim: float = 0.0,
    orientation_mode: str = "radial",
    device=None,
    **kw,
) -> TriangleMesh:
    """Merged-360° cloud → watertight STL (drop-in for
    `ProcessingLogic.mesh_360`, `server/processing.py:251-310`; watertight
    trim default 0.0 per `server/gui.py:65`), meshed on ``device``. A
    ``timing`` dict (a :func:`mesh_from_cloud` keyword) also receives the
    STL write's wall as ``write_s``."""
    mesh = mesh_from_cloud(cloud, mode="watertight", depth=depth,
                           quantile_trim=quantile_trim,
                           orientation_mode=orientation_mode, device=device,
                           **kw)
    _write(out_path, mesh, kw.get("timing"))
    return mesh


def _write(out_path, mesh: TriangleMesh, timing: dict | None) -> None:
    """Write the STL; with ``timing``, record its wall as ``write_s``."""
    t0 = time.perf_counter()
    write_stl(out_path, mesh)
    if timing is not None:
        timing["write_s"] = time.perf_counter() - t0
