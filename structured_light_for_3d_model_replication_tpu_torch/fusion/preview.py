"""TSDF progressive previews: incremental integration, no re-solve
(counterpart of the JAX ``fusion/preview.py``).

Each fused stop's pose-transformed points are integrated into a persistent
volume (:func:`..ops.tsdf.integrate`, one combine-kernel launch on the
card), and the preview is a direct extraction of what the volume holds:
work per stop is proportional to the stop, not the model, and the preview
carries per-vertex colour. The volume's world mapping is fixed lazily at
the first stop (padded bounds, :func:`.volume.fit_bounds`); later stops of a
turntable ring orbit the same object, and points outside the volume are
dropped by the integrate op's bounds mask.
"""

from __future__ import annotations

import logging

import numpy as np

from ..io.stl import TriangleMesh
from ..ops.tsdf import TSDFParams
from .volume import TSDFVolume

log = logging.getLogger(__name__)


class TSDFPreviewMesher:
    """Drop-in for ``stream.preview.PreviewMesher`` with per-stop
    incremental integration: the session feeds each fused stop through
    :meth:`integrate_stop`; ``__call__`` keeps the Poisson previewer's
    signature and ignores the model buffer (the volume IS the running
    model)."""

    def __init__(self, voxel_size_hint: float,
                 params: TSDFParams = TSDFParams(max_bricks=4096),
                 min_weight: float = 0.0, quantile_trim: float = 0.0,
                 pad_frac: float = 0.6, cells_floor: int = 16384,
                 tris_floor: int = 65536, device=None):
        # The volume never resolves finer than the session's merge voxel
        # (there is no data below it); fit_bounds may choose coarser.
        self.voxel_size_hint = float(voxel_size_hint)
        self.params = params
        self.min_weight = float(min_weight)
        self.quantile_trim = float(quantile_trim)
        self.pad_frac = float(pad_frac)
        self.cells_floor = int(cells_floor)
        self.tris_floor = int(tris_floor)
        self.device = device
        self.volume: TSDFVolume | None = None
        self.last_cg_iters = None    # interface parity with PreviewMesher

    def _ensure_volume(self, moved_np: np.ndarray) -> None:
        if self.volume is not None:
            return
        lo = moved_np.min(axis=0) if moved_np.shape[0] else \
            np.zeros(3, np.float32)
        hi = moved_np.max(axis=0) if moved_np.shape[0] else \
            np.ones(3, np.float32)
        vol = TSDFVolume.from_bounds(self.params, lo, hi,
                                     pad_frac=self.pad_frac,
                                     device=self.device)
        if vol.voxel_size < self.voxel_size_hint:
            vol.voxel_size = self.voxel_size_hint
        self.volume = vol
        log.debug("TSDF preview volume: voxel %.4f, %d^3 voxels, %d brick "
                  "slots", vol.voxel_size, self.params.resolution,
                  self.params.max_bricks)

    def integrate_stop(self, moved, colors, valid, cam,
                       moved_np: np.ndarray | None = None) -> int:
        """Fuse one pose-transformed stop (tensors straight from the
        session's fuse step); ``cam`` is the stop's camera centre in the
        model frame. ``moved_np`` (the valid points' host copy) seeds the
        lazy bounds."""
        if self.volume is None:
            ref = moved_np if moved_np is not None else \
                moved.cpu().numpy()[valid.cpu().numpy()]
            self._ensure_volume(np.asarray(ref, np.float32))
        return self.volume.integrate_from_camera(moved, colors, valid, cam)

    def __call__(self, model_pts, model_valid) -> TriangleMesh:
        """Extract the current surface (arguments accepted for the Poisson
        previewer's signature; the volume holds the model)."""
        del model_pts, model_valid
        if self.volume is None:
            return self.empty()
        return self.volume.extract(
            min_weight=self.min_weight, quantile_trim=self.quantile_trim,
            cells_floor=self.cells_floor, tris_floor=self.tris_floor)

    @staticmethod
    def empty() -> TriangleMesh:
        return TriangleMesh(vertices=np.zeros((0, 3), np.float32),
                            faces=np.zeros((0, 3), np.int32))

    def stats(self) -> dict:
        return self.volume.stats() if self.volume is not None else {}
