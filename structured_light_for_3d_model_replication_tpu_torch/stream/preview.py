"""Progressive mesh previews of a streaming session (counterpart of the JAX
``stream/preview.py``).

:class:`PreviewMesher` is the ``"poisson"`` lane: the running model is
stratified-sampled into ``points`` fixed slots (invalid slots masked, never
compacted), normals are estimated and oriented outward from the valid
centroid, the dense screened Poisson solves at a constant ``depth`` and the
host marching oracle extracts. The previous preview's χ warm-starts the next
solve's CG, so after the first stop the residual stop fires after a fraction
of the cold iteration count (``last_cg_iters``); the last grid also
warm-starts the finalize solve.

:func:`make_previewer` picks the session's previewer from its
``StreamParams``: the TSDF mesher (:mod:`..fusion.preview`) for ``"tsdf"``
and ``"archival"``, this one for ``"poisson"``.
"""

from __future__ import annotations

import logging

import torch

from ..io.stl import TriangleMesh
from ..ops import marching, pointcloud, poisson

log = logging.getLogger(__name__)


class PreviewMesher:
    """Coarse progressive previews of a running fused model. ``__call__``
    takes the session's model buffer (fixed slots + valid mask, on the
    device) and returns a host :class:`TriangleMesh`."""

    def __init__(self, points: int = 8192, depth: int = 6,
                 quantile_trim: float = 0.05, normals_k: int = 16,
                 cg_iters: int = 60):
        if depth > 8:
            raise ValueError(f"preview depth {depth} > 8: previews ride "
                             "the dense Poisson grid (keep them coarse; "
                             "finalize owns the deep solve)")
        self.points = int(points)
        self.depth = int(depth)
        self.quantile_trim = float(quantile_trim)
        self.normals_k = int(normals_k)
        self.cg_iters = int(cg_iters)
        self.last_cg_iters: int | None = None
        self._last_grid: poisson.PoissonGrid | None = None

    def _sample_normals(self, pts: torch.Tensor, valid: torch.Tensor):
        """Model buffer → ``points`` preview slots and outward normals."""
        idx, v = pointcloud.stratified_indices(valid, self.points)
        zero = torch.zeros((), device=pts.device)
        p = torch.where(v[:, None], pts[idx], zero)
        nv = v.to(torch.float32).sum().clamp_min(1.0)
        center = p.sum(0) / nv
        normals, n_ok = pointcloud.estimate_normals(p, valid=v,
                                                    k=self.normals_k)
        normals = pointcloud.orient_normals(p, normals, center, outward=True)
        return p, normals, v & n_ok

    def __call__(self, model_pts, model_valid) -> TriangleMesh:
        p, normals, v = self._sample_normals(model_pts, model_valid)
        grid, iters = poisson.reconstruct(
            p, normals, valid=v, depth=self.depth, cg_iters=self.cg_iters,
            x0=self.last_chi, return_iters=True)
        self.last_cg_iters = iters
        self._last_grid = grid
        mesh = marching.extract(grid, quantile_trim=self.quantile_trim)
        log.debug("preview: %d sample slots -> %d faces (depth %d, %d CG "
                  "iters)", self.points, len(mesh.faces), self.depth, iters)
        return mesh

    @property
    def last_chi(self):
        """Latest preview χ grid: the next preview's, and a same-depth
        finalize's, warm start."""
        return None if self._last_grid is None else self._last_grid.chi

    @property
    def last_grid(self):
        """Latest preview grid with its world normalization: a sparse
        finalize (depth > 8) warm-starts its coarse solve from it."""
        return self._last_grid


def make_previewer(params, device=None):
    """StreamParams → the session's previewer: the incremental TSDF mesher
    for ``"tsdf"`` and ``"archival"`` (whose previews are the same TSDF
    lane), the splat appearance lane for ``"splat"`` (``splat/preview.py``
    — the TSDF mesher plus rendered novel views), the coarse-Poisson
    re-solver for ``"poisson"``. All share the ``__call__(model_pts,
    model_valid) -> TriangleMesh`` contract."""
    if params.representation in ("tsdf", "splat", "archival"):
        from ..fusion.preview import TSDFPreviewMesher
        from ..ops.tsdf import TSDFParams

        tparams = TSDFParams(grid_depth=params.tsdf_grid_depth,
                             max_bricks=params.tsdf_max_bricks,
                             carve_steps=params.tsdf_carve_steps)
        hint = params.tsdf_voxel_scale * params.merge.voxel_size
        if params.representation == "splat":
            from ..splat.model import SplatParams
            from ..splat.preview import SplatPreviewMesher

            return SplatPreviewMesher(
                voxel_size_hint=hint, params=tparams,
                splat_params=SplatParams(capacity=params.splat_cap),
                fit_iters=params.splat_fit_iters,
                max_frames=params.splat_max_frames,
                fit_pixels=params.splat_fit_pixels,
                render_sizes=params.splat_render_sizes,
                quantile_trim=params.preview_trim, device=device)
        return TSDFPreviewMesher(
            voxel_size_hint=hint, params=tparams,
            quantile_trim=params.preview_trim, device=device)
    return PreviewMesher(points=params.preview_points,
                         depth=params.preview_depth,
                         quantile_trim=params.preview_trim)
