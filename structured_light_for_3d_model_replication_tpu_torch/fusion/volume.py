"""TSDFVolume: the host-side handle on a TSDF brick volume on a device
(counterpart of the JAX ``fusion/volume.py``).

Owns the volume tensors and the world mapping (origin + voxel size), logs
capacity overflows (they degrade to holes, never an error) and fronts the
two integration flavours: :meth:`integrate_from_camera` (streaming stops,
inward along the viewing rays) and :meth:`integrate_oriented` (batch clouds,
inward = −normal). :func:`fit_bounds` picks the world mapping: an isotropic
padded cube around the bounds.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .._device import resolve_device
from ..io.stl import TriangleMesh
from ..ops import tsdf as tsdf_ops
from .extract import extract_colored

log = logging.getLogger(__name__)


def fit_bounds(lo, hi, params: tsdf_ops.TSDFParams, pad_frac: float = 0.15):
    """(origin, voxel_size) covering the padded isotropic cube around
    [lo, hi] with the volume's ``2^grid_depth`` voxels."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    extent = float(np.max(hi - lo))
    extent = extent if extent > 1e-12 else 1.0
    side = extent * (1.0 + 2.0 * float(pad_frac))
    voxel = side / params.resolution
    center = 0.5 * (lo + hi)
    origin = center - 0.5 * side
    return origin.astype(np.float32), float(voxel)


class TSDFVolume:
    """One TSDF scene: fixed params, fixed world mapping, fused state, on
    ``device`` (None means the card)."""

    def __init__(self, params: tsdf_ops.TSDFParams, origin, voxel_size,
                 device=None):
        self.params = params
        self.device = resolve_device(device)
        self.origin = np.asarray(origin, np.float32)
        self.voxel_size = float(voxel_size)
        self._state = tsdf_ops.init_state(params, self.device)
        self.n_bricks = 0
        self.n_wanted = 0
        self.n_dropped = 0
        self.stops_integrated = 0

    @classmethod
    def from_bounds(cls, params: tsdf_ops.TSDFParams, lo, hi,
                    pad_frac: float = 0.15, device=None) -> "TSDFVolume":
        origin, voxel = fit_bounds(lo, hi, params, pad_frac=pad_frac)
        return cls(params, origin, voxel, device=device)

    @classmethod
    def from_arrays(cls, params: tsdf_ops.TSDFParams, origin, voxel_size,
                    dir_map, tsdf, weight, rgb, brick_coords, n_bricks,
                    device=None) -> "TSDFVolume":
        """A volume holding the given state (host arrays in the
        :class:`~..ops.tsdf.TSDFState` layout — another package's volume,
        say) on ``device`` (None means the card)."""
        vol = cls(params, origin, voxel_size, device=device)

        def t(a, dtype):
            return torch.as_tensor(np.array(a), device=vol.device).to(
                dtype).contiguous()

        vol._state = tsdf_ops.TSDFState(
            dir_map=t(dir_map, torch.int32), tsdf=t(tsdf, torch.float32),
            weight=t(weight, torch.float32), rgb=t(rgb, torch.float32),
            brick_coords=t(brick_coords, torch.int32),
            n_bricks=t(n_bricks, torch.int32).reshape(()))
        vol.n_bricks = vol.n_wanted = int(vol._state.n_bricks)
        return vol

    @property
    def state(self) -> tsdf_ops.TSDFState:
        return self._state

    # ------------------------------------------------------------------

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _integrate(self, points, colors, valid, dirs) -> int:
        self._state, n_wanted = tsdf_ops.integrate(
            self._state, self.params, points, colors, valid, dirs,
            self.origin, self.voxel_size)
        n_wanted = int(n_wanted)
        cap = int(self.params.max_bricks)
        if n_wanted > cap and self.n_dropped == 0:
            log.warning(
                "TSDF brick pool overflowed max_bricks=%d (%d wanted) — "
                "excess bricks dropped (holes in the extracted surface)",
                cap, n_wanted)
        self.n_dropped = max(self.n_dropped, n_wanted - cap)
        self.n_wanted = n_wanted
        self.n_bricks = min(n_wanted, cap)
        self.stops_integrated += 1
        return n_wanted

    def integrate_from_camera(self, points, colors, valid, cam) -> int:
        """Fuse one stop observed from camera centre ``cam`` (3,); all
        arrays world-frame (tensors or host arrays). Returns wanted
        bricks."""
        pts = self._t(points).to(torch.float32)
        dirs = tsdf_ops.camera_dirs(pts, self._t(cam).to(torch.float32))
        return self._integrate(pts, self._t(colors), self._t(valid), dirs)

    def integrate_oriented(self, points, colors, valid, normals) -> int:
        """Fuse an oriented cloud: inward = −(outward normal)."""
        dirs = -self._t(normals).to(torch.float32)
        return self._integrate(self._t(points), self._t(colors),
                               self._t(valid), dirs)

    # ------------------------------------------------------------------

    def extract(self, min_weight: float = 0.0, quantile_trim: float = 0.0,
                cells_floor: int = 4096, tris_floor: int = 8192,
                with_colors: bool = True) -> TriangleMesh:
        return extract_colored(
            self._state, self.params, self.origin, self.voxel_size,
            min_weight=min_weight, quantile_trim=quantile_trim,
            cells_floor=cells_floor, tris_floor=tris_floor,
            with_colors=with_colors)

    def to_dense(self):
        """Dense (tsdf, weight, rgb) host arrays (the oracle's layout)."""
        return tsdf_ops.state_to_dense(self._state, self.params)

    def stats(self) -> dict:
        return {
            "bricks": int(self.n_bricks),
            "bricks_wanted": int(self.n_wanted),
            "max_bricks": int(self.params.max_bricks),
            "bricks_dropped": int(self.n_dropped),
            "stops_integrated": int(self.stops_integrated),
            "voxel_size": round(self.voxel_size, 6),
            "grid_depth": int(self.params.grid_depth),
        }
