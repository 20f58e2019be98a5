"""Ray-plane triangulation and calibration precompute (counterpart of the JAX
``ops/triangulate.py``).

Frames: everything lives in the CAMERA frame. `stereoCalibrate`-convention
extrinsics map camera→projector: X_p = R @ X_c + T. Hence the projector
center in camera coordinates is -Rᵀ T and a projector-pixel ray direction is
Rᵀ K_p⁻¹ [u, v, 1]. Geometry is float32 throughout, as in the JAX package
(which runs without x64).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..config import TriangulationConfig


class Calibration(NamedTuple):
    """Device-resident calibration, mirroring the reference .mat container
    keys {Nc, Oc, wPlaneCol, wPlaneRow, cam_K, proj_K, R, T}."""

    cam_K: torch.Tensor       # (3,3)
    proj_K: torch.Tensor      # (3,3)
    R: torch.Tensor           # (3,3) camera->projector rotation
    T: torch.Tensor           # (3,)  camera->projector translation
    Nc: torch.Tensor          # (H, W, 3) unit ray per camera pixel
    Oc: torch.Tensor          # (3,) camera center (zeros in camera frame)
    plane_cols: torch.Tensor  # (proj_w, 4) [nx, ny, nz, d], n·X + d = 0
    plane_rows: torch.Tensor  # (proj_h, 4)

    def to(self, device) -> "Calibration":
        return Calibration(*(t.to(device) for t in self))


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, dtype=np.float32), dtype=torch.float32,
                        device=device)


def camera_rays(cam_K: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Unit viewing ray per camera pixel, (H, W, 3) float32."""
    dev = cam_K.device
    u = torch.arange(width, dtype=torch.float32, device=dev)
    v = torch.arange(height, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")                  # (H, W)
    pix = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1)      # (H, W, 3)
    kinv = torch.linalg.inv(cam_K.to(torch.float32))
    rays = torch.einsum("hwj,kj->hwk", pix, kinv)
    return rays / torch.linalg.norm(rays, dim=-1, keepdim=True)


def projector_center(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Projector optical center in camera coordinates: -Rᵀ T."""
    return -(R.T @ T)


def projector_planes(proj_K: torch.Tensor, R: torch.Tensor, T: torch.Tensor,
                     n: int, axis: str) -> torch.Tensor:
    """Light-plane equations for every projector column (axis="col") or row
    (axis="row"), (n, 4) with plane n·X + d = 0 in camera coordinates."""
    proj_K = proj_K.to(torch.float32)
    R = R.to(torch.float32)
    T = T.to(torch.float32)
    kinv = torch.linalg.inv(proj_K)
    center = -(R.T @ T)
    idx = torch.arange(n, dtype=torch.float32, device=proj_K.device)
    zero, one = torch.zeros_like(idx), torch.ones_like(idx)
    if axis == "col":
        p0 = torch.stack([idx, zero, one], dim=-1)
        edge = kinv[:, 1]  # exact direction along a column: K⁻¹ e_v
    elif axis == "row":
        p0 = torch.stack([zero, idx, one], dim=-1)
        edge = kinv[:, 0]  # exact direction along a row: K⁻¹ e_u
    else:
        raise ValueError(f"axis must be 'col' or 'row', got {axis!r}")
    # normal = cross(ray(p0), edge_cam): crossing with the exact edge vector
    # avoids the fp32 cancellation of two nearly parallel rays.
    d0 = torch.einsum("nj,kj,km->nm", p0, kinv, R)
    edge_cam = torch.einsum("km,k->m", R, edge)
    normal = torch.linalg.cross(d0, edge_cam[None, :].expand_as(d0), dim=-1)
    normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
    d = -torch.sum(normal * center[None, :], dim=-1)
    return torch.cat([normal, d[:, None]], dim=-1)


def make_calibration(cam_K, proj_K, R, T, cam_height: int, cam_width: int,
                     proj_width: int = 1920, proj_height: int = 1080,
                     device=None) -> Calibration:
    """Precompute the full device-resident calibration container."""
    dev = resolve_device(device)
    cam_K = _f32(cam_K, dev)
    proj_K = _f32(proj_K, dev)
    R = _f32(R, dev)
    T = _f32(T, dev).reshape(3)
    return Calibration(
        cam_K=cam_K, proj_K=proj_K, R=R, T=T,
        Nc=camera_rays(cam_K, cam_height, cam_width),
        Oc=torch.zeros(3, dtype=torch.float32, device=dev),
        plane_cols=projector_planes(proj_K, R, T, proj_width, "col"),
        plane_rows=projector_planes(proj_K, R, T, proj_height, "row"),
    )


def calibration_from_numpy(arrays: dict, device=None) -> Calibration:
    """A calibration carried across as numpy arrays — e.g.
    ``{k: np.asarray(v) for k, v in jax_calib._asdict().items()}`` — on
    ``device``. Fields: cam_K, proj_K, R, T, Nc, Oc, plane_cols,
    plane_rows."""
    dev = resolve_device(device)
    return Calibration(**{f: _f32(arrays[f], dev)
                          for f in Calibration._fields})


def _ray_plane_t(planes: torch.Tensor, rays: torch.Tensor,
                 origin: torch.Tensor, eps: float):
    """t for origin + t·ray hitting plane n·X + d = 0; invalid → 0.
    ``planes`` (..., 4) and ``rays`` (..., 3) broadcast."""
    denom = (planes[..., 0] * rays[..., 0] + planes[..., 1] * rays[..., 1]
             + planes[..., 2] * rays[..., 2])
    num = -((planes[..., 0] * origin[0] + planes[..., 1] * origin[1]
             + planes[..., 2] * origin[2]) + planes[..., 3])
    safe = denom.abs() > eps
    one = torch.ones((), dtype=denom.dtype, device=denom.device)
    t = torch.where(safe, num / torch.where(safe, denom, one),
                    torch.zeros((), dtype=denom.dtype, device=denom.device))
    return t, safe


def triangulate(col_map: torch.Tensor, row_map: torch.Tensor,
                mask: torch.Tensor, calib: Calibration,
                cfg: TriangulationConfig = TriangulationConfig()):
    """Dense masked triangulation of (..., H, W) decode maps + mask ->
    ((..., H·W, 3) float32 points, (..., H·W) bool valid). Every pixel is
    computed; `valid` marks real points. Reproduces
    `t = -(N·Oc + d)/(N·ray)` with the |denom| > eps guard."""
    lead = col_map.shape[:-2]
    rays = calib.Nc.reshape(-1, 3)                    # (P, 3)
    origin = calib.Oc
    flat_mask = mask.reshape(lead + (-1,))
    n_cols = calib.plane_cols.shape[0]
    n_rows = calib.plane_rows.shape[0]
    col_idx = col_map.reshape(lead + (-1,)).to(torch.int64).clamp(0, n_cols - 1)
    row_idx = row_map.reshape(lead + (-1,)).to(torch.int64).clamp(0, n_rows - 1)

    if cfg.plane_axis == "col":
        t, safe = _ray_plane_t(calib.plane_cols[col_idx], rays, origin,
                               cfg.denom_eps)
    elif cfg.plane_axis == "row":
        t, safe = _ray_plane_t(calib.plane_rows[row_idx], rays, origin,
                               cfg.denom_eps)
    elif cfg.plane_axis == "both":
        # Inverse-variance fusion: each axis's variance is its depth
        # sensitivity to a one-index plane step (forward difference,
        # backward at the last plane).
        def est(planes_all, idx, n_planes):
            nbr = torch.where(idx + 1 < n_planes, idx + 1, idx - 1)
            t0, s0 = _ray_plane_t(planes_all[idx], rays, origin,
                                  cfg.denom_eps)
            t1, _ = _ray_plane_t(planes_all[nbr], rays, origin,
                                 cfg.denom_eps)
            sens = (t1 - t0).abs() + 1e-12
            return t0, s0, 1.0 / (sens * sens)

        tc, sc, wc = est(calib.plane_cols, col_idx, n_cols)
        tr, sr, wr = est(calib.plane_rows, row_idx, n_rows)
        wc = wc * sc
        wr = wr * sr
        wsum = wc + wr
        safe = (sc | sr) & (wsum > 0.0)
        one = torch.ones((), dtype=wsum.dtype, device=wsum.device)
        t = torch.where(safe, (wc * tc + wr * tr) / torch.where(safe, wsum, one),
                        torch.zeros((), dtype=wsum.dtype, device=wsum.device))
    else:
        raise ValueError(f"unknown plane_axis {cfg.plane_axis!r}")

    valid = flat_mask & safe & (t > cfg.min_t) & (t < cfg.max_t)
    points = origin + t[..., None] * rays
    points = torch.where(valid[..., None], points,
                         torch.zeros((), dtype=points.dtype,
                                     device=points.device))
    return points.to(torch.float32), valid


def colors_from_white(white: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    """Per-point colors from the white reference frame, (H·W, 3) uint8.
    Grayscale (H, W) input is broadcast to 3 channels; (H, W, 3) is RGB.
    ``batch_dims`` leading axes are kept."""
    if white.dim() - batch_dims == 2:
        white = white[..., None].expand(white.shape + (3,))
    return white.reshape(white.shape[:batch_dims] + (-1, 3)).to(torch.uint8)
