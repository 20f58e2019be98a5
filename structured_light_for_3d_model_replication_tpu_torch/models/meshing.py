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

Representation ``"poisson"`` (and its alias ``"archival"``, the streaming
session's watertight final format): depth ≤ 8 solves on a dense grid
(:mod:`..ops.poisson`), depth 9-16 on the band-sparse one
(:mod:`..ops.poisson_sparse`, kernel ``csrc/matvec.cu``, any of its four
preconditioners), extracted by the device marching extractor on the card
(kernel ``csrc/classify.cu``) or by the host oracle; ``cg_x0`` warm-starts
either solve. Representation ``"tsdf"`` fuses the oriented cloud into a
brick-pool TSDF (:mod:`..fusion`, kernel ``csrc/combine.cu``) and extracts a
vertex-coloured mesh. :func:`mesh_from_cloud_async` runs the same call on a
pipelined worker.

Mode ``"surface"`` ball-pivots the cloud with radii = mean 1-NN distance ×
multipliers (`server/processing.py:222-235`) in the native layer the port
shares with the JAX package (:mod:`.._native`, ``native/src/ball_pivot.cpp``:
sequential front propagation, a host job); without that library it falls
back, as the JAX package does, to the Poisson solve with a hard density
trim. ``device_mesh`` (a :class:`..parallel.mesh.Mesh`) keeps a dense
solve on the mesh's cards: the serving tier's sharded bucket meshes on a
card its decode spanned.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .. import _native
from .._device import resolve_device, stage_clock
from ..io.ply import PointCloud
from ..io.stl import TriangleMesh, write_stl
from ..ops import marching, orientation, poisson, poisson_sparse
from ..ops import pointcloud as pc_ops
from ..ops.knn import knn

log = logging.getLogger(__name__)


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
    radii_multipliers: str = "1,2,4",
    cg_iters: int = 300,
    preconditioner: str = "additive",
    extraction: str = "auto",
    max_blocks: int | None = None,
    representation: str = "poisson",
    tsdf_max_bricks: int = 8192,
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
    default). ``mode="surface"`` ball-pivots with radii of the mean 1-NN
    distance times each of the comma-separated ``radii_multipliers``; when
    the native library is absent it meshes as watertight but trims at
    least 25%. ``depth`` ≤ 8 solves on a 2^depth dense grid; depth 9-16 on
    the band-sparse solver with ``preconditioner`` (``"additive"``,
    ``"vcycle"``, ``"chebyshev"`` or ``"jacobi"``), ``max_blocks`` (None =
    the solver's budget, with its overflow retry) and ``extraction``
    (``"auto"`` = device marching on the card, the host oracle for a CPU
    run; ``"host"``; ``"device"``).
    ``solve_stats`` (a caller's dict) receives the sparse solver's stats.
    ``cg_x0`` warm-starts the Poisson solve: at depth ≤ 8 a χ tensor at the
    solve resolution seeds the CG; at depth > 8 a dense
    :class:`..ops.poisson.PoissonGrid` (a streaming preview's last grid)
    warm-starts the internal coarse solve and a
    :class:`..ops.poisson_sparse.SparsePoissonGrid` reseeds the band.
    ``representation="tsdf"`` maps ``depth`` onto the TSDF grid depth
    (clamped to 5–9), trims the lowest-weight ``quantile_trim`` of the
    triangles, bounds the brick pool by ``tsdf_max_bricks`` (overflow
    degrades to holes, logged) and ignores ``cg_x0``.
    ``device_mesh`` (a :class:`..parallel.mesh.Mesh`) places the dense
    solve on one of the mesh's space members: ``device`` when it is one
    (a serving lane's own card), else the first. The whole cloud is
    solved there by :func:`..ops.poisson.reconstruct`; splitting its splat
    over the members saved nothing, since the CG on the grid is the cost.
    Depth > 8, the ball pivot and the TSDF representation ignore it, as
    the JAX package does.
    ``timing``, when given, receives wall seconds per stage, each measured
    with a device synchronize: ``normals_s``, then ``setup_s``,
    ``coarse_s``, ``fine_cg_s``, ``iso_s`` (sparse) or ``solve_s``
    (dense), and ``extract_s``."""
    if mode not in ("watertight", "surface"):
        raise ValueError(f"unknown mesh mode {mode!r}")
    if extraction not in ("auto", "host", "device"):
        raise ValueError(f"unknown extraction engine {extraction!r}")
    if representation == "archival":
        # The streaming session's watertight final format: by the time a
        # cloud reaches this function, archival IS the Poisson print path.
        representation = "poisson"
    if representation not in ("poisson", "tsdf"):
        raise ValueError(f"unknown representation {representation!r} "
                         "(expected 'poisson', 'tsdf' or 'archival')")
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
    trim = quantile_trim if mode == "watertight" else max(quantile_trim, 0.25)
    if representation == "tsdf":
        mesh = _tsdf_mesh(cloud, pts, normals, depth, trim,
                          tsdf_max_bricks, dev)
        if timing is not None:
            timing["extract_s"] = clock() - t1
        log.info("TSDF-meshed %d points -> %d verts / %d faces (depth=%d, "
                 "colored=%s)", pts.shape[0], len(mesh.vertices),
                 len(mesh.faces), depth, mesh.vertex_colors is not None)
        return mesh
    if mode == "surface":
        mesh = _ball_pivot_mesh(pts, pts_t, normals, radii_multipliers)
        if mesh is not None:
            if timing is not None:
                timing["extract_s"] = clock() - t1
            log.info("ball-pivoted %d points -> %d verts / %d faces",
                     pts.shape[0], len(mesh.vertices), len(mesh.faces))
            return mesh
        log.warning("native ball pivoting unavailable; Poisson surface "
                    "fallback")
    if int(depth) > 8:
        kw = {} if max_blocks is None else {"max_blocks": int(max_blocks)}
        if isinstance(cg_x0, (poisson.PoissonGrid,
                              poisson_sparse.SparsePoissonGrid)):
            kw["x0"] = cg_x0
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
        mesh = marching.extract_sparse(grid, quantile_trim=trim,
                                       engine=extraction)
    else:
        if device_mesh is not None:
            on = solve_device(device_mesh, dev)
            pts_t, nrm_t = pts_t.to(on), nrm_t.to(on)
            cg_x0 = None if cg_x0 is None else cg_x0.to(on)
        grid = poisson.reconstruct(pts_t, nrm_t, depth=int(depth),
                                   cg_iters=cg_iters, x0=cg_x0)
        t2 = clock()
        if timing is not None:
            timing["solve_s"] = t2 - t1
        mesh = marching.extract(grid, quantile_trim=trim)
    t3 = clock()
    if timing is not None:
        timing["extract_s"] = t3 - t2
    log.info("meshed %d points -> %d verts / %d faces (mode=%s depth=%d)",
             pts.shape[0], len(mesh.vertices), len(mesh.faces), mode, depth)
    return mesh


def solve_device(device_mesh, device: torch.device) -> torch.device:
    """The member of ``device_mesh``'s space axis a dense solve runs on:
    ``device`` when the mesh holds it (compared by label: host lanes all
    report ``cpu``), else the first member."""
    from ..parallel.mesh import device_label

    members = device_mesh.space_members
    label = device_label(device)
    return next((m for m in members if device_label(m) == label),
                members[0])


def mesh_from_cloud_async(cloud: PointCloud, *, task_name: str = "mesh",
                          **kw):
    """Launch :func:`mesh_from_cloud` on a pipelined worker and return its
    :class:`..utils.overlap.PipelinedTask`; ``task.result()`` joins. The
    worker runs the same call with the same arguments as the sequential
    path, on the caller's device and CUDA stream. The caller must not
    mutate ``cloud`` until the join; a worker exception re-raises at
    ``result()``."""
    from ..utils.overlap import PipelinedTask

    return PipelinedTask(mesh_from_cloud, cloud, name=task_name, **kw)


def _tsdf_mesh(cloud: PointCloud, pts: np.ndarray, normals: np.ndarray,
               depth: int, quantile_trim: float, max_bricks: int,
               dev: torch.device) -> TriangleMesh:
    """Oriented cloud → fused TSDF (inward = −n̂) → vertex-coloured mesh.
    The point count is padded to a power of two with invalid rows, as the
    JAX package does."""
    from ..fusion import TSDFParams, TSDFVolume
    from ..ops.marching_device import _bucket

    params = TSDFParams(grid_depth=min(max(int(depth), 5), 9),
                        max_bricks=int(max_bricks))
    n = pts.shape[0]
    pad = _bucket(n) - n
    has_colors = cloud.colors is not None and len(cloud.colors) == n
    cols = np.asarray(cloud.colors, np.float32) if has_colors \
        else np.zeros((n, 3), np.float32)
    pts_p = np.concatenate([pts, np.zeros((pad, 3), np.float32)])
    cols_p = np.concatenate([cols, np.zeros((pad, 3), np.float32)])
    nrm_p = np.concatenate([np.asarray(normals, np.float32),
                            np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32),
                                    (pad, 1))])
    val_p = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    vol = TSDFVolume.from_bounds(params, pts.min(axis=0), pts.max(axis=0),
                                 device=dev)
    vol.integrate_oriented(pts_p, cols_p, val_p, nrm_p)
    if vol.n_dropped:
        log.warning("TSDF mesh dropped %d brick(s) past max_bricks=%d — "
                    "raise tsdf_max_bricks or lower depth if the surface "
                    "shows holes", vol.n_dropped, int(max_bricks))
    return vol.extract(quantile_trim=quantile_trim, with_colors=has_colors)


def ball_pivot_radii(pts_t: torch.Tensor,
                     radii_multipliers: str = "1,2,4") -> list[float]:
    """Mode ``"surface"``'s ball radii: the mean 1-NN distance (the exact
    KNN on ``pts_t``'s device) times each parsed multiplier, "1,2,4" when
    the list is empty."""
    multipliers = [float(x) for x in str(radii_multipliers).split(",") if x]
    if not multipliers:
        multipliers = [1.0, 2.0, 4.0]
    d2, _, nbv = knn(pts_t, 1, exclude_self=True)
    d = np.sqrt(d2[:, 0].cpu().numpy())
    nbv = nbv[:, 0].cpu().numpy()
    avg = float(d[nbv].mean()) if nbv.any() else 1.0
    return [avg * m for m in multipliers]


def _ball_pivot_mesh(pts: np.ndarray, pts_t: torch.Tensor,
                     normals: np.ndarray,
                     radii_multipliers: str) -> TriangleMesh | None:
    """Ball pivoting in the native layer; None when it is unavailable or
    gives no triangle."""
    if not _native.available():
        return None
    tris = _native.ball_pivot(pts, normals,
                              ball_pivot_radii(pts_t, radii_multipliers))
    if len(tris) == 0:
        return None
    return TriangleMesh(vertices=pts.copy(), faces=tris)


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
