"""NumPy oracle (a copy of the JAX package's ``models/oracle.py``).

A plainly written NumPy decode and triangulation with the reference's
semantics (`server/sl_system.py:508-653`,
`multi_point_cloud_process.py:23-119`). It is no kernel's plain version:
it is the reference's NumPy/OpenCV path (the JAX package's
``"numpy_cv2"`` backend), the ground truth that bench config 1 times, and
the synthetic rig's ray source. Clarity over speed.
"""

from __future__ import annotations

import numpy as np

from ..config import DecodeConfig, TriangulationConfig


def gray_to_binary_np(g: np.ndarray, n_bits: int) -> np.ndarray:
    b = g.copy()
    shift = 1
    while shift < n_bits:
        b ^= b >> shift
        shift *= 2
    return b


def decode_bits_np(pairs: np.ndarray) -> np.ndarray:
    """(n_bits, 2, H, W) -> (H, W) int32 binary code. bit = pattern > inverse."""
    n_bits = pairs.shape[0]
    gray = np.zeros(pairs.shape[2:], dtype=np.int32)
    for b in range(n_bits):
        bit = (pairs[b, 0] > pairs[b, 1]).astype(np.int32)
        gray |= bit << (n_bits - 1 - b)
    return gray_to_binary_np(gray, n_bits)


def masks_np(white: np.ndarray, black: np.ndarray, cfg: DecodeConfig) -> np.ndarray:
    w = white.astype(np.float32)
    b = black.astype(np.float32)
    if cfg.mode == "adaptive":
        thresh_w = cfg.white_factor * np.percentile(b, cfg.black_percentile)
        contrast = w - b
        return (w > thresh_w) & (contrast > cfg.contrast_frac * contrast.max())
    if cfg.mode == "fixed":
        return (w > cfg.white_thresh) & ((w - b) > cfg.contrast_thresh)
    raise ValueError(cfg.mode)


def decode_stack_np(stack: np.ndarray, col_bits: int, row_bits: int,
                    cfg: DecodeConfig = DecodeConfig(), downsample: int = 1):
    """(n_frames, H, W) -> (col_map, row_map, mask); protocol frame order."""
    n = 2 + 2 * col_bits + 2 * row_bits
    assert stack.shape[0] == n, (stack.shape, n)
    white, black = stack[0], stack[1]
    col = stack[2:2 + 2 * col_bits].reshape(col_bits, 2, *stack.shape[1:])
    row = stack[2 + 2 * col_bits:].reshape(row_bits, 2, *stack.shape[1:])
    off = (downsample - 1) // 2
    return (
        decode_bits_np(col) * downsample + off,
        decode_bits_np(row) * downsample + off,
        masks_np(white, black, cfg),
    )


def camera_rays_np(cam_K: np.ndarray, height: int, width: int) -> np.ndarray:
    uu, vv = np.meshgrid(np.arange(width, dtype=np.float64),
                         np.arange(height, dtype=np.float64))
    pix = np.stack([uu, vv, np.ones_like(uu)], axis=-1)
    rays = pix @ np.linalg.inv(cam_K).T
    return rays / np.linalg.norm(rays, axis=-1, keepdims=True)


def projector_planes_np(proj_K, R, T, n: int, axis: str) -> np.ndarray:
    """Per-column/row light planes (n, 4) in camera coords; see ops.triangulate."""
    Kinv = np.linalg.inv(np.asarray(proj_K, np.float64))
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64).reshape(3)
    center = -(R.T @ T)
    idx = np.arange(n, dtype=np.float64)
    one = np.ones_like(idx)
    zero = np.zeros_like(idx)
    if axis == "col":
        p0 = np.stack([idx, zero, one], -1)
        edge = Kinv[:, 1]
    else:
        p0 = np.stack([zero, idx, one], -1)
        edge = Kinv[:, 0]
    d0 = (p0 @ Kinv.T) @ R
    normal = np.cross(d0, (R.T @ edge)[None, :])
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    d = -(normal @ center)
    return np.concatenate([normal, d[:, None]], axis=-1).astype(np.float64)


def _plane_t_np(planes, rays, eps):
    """t per ray for origin + t*ray on plane n·X + d = 0 (origin = 0)."""
    n, d = planes[:, :3], planes[:, 3]
    denom = np.sum(n * rays, axis=-1)
    ok = np.abs(denom) > eps
    t = np.where(ok, -d / np.where(ok, denom, 1.0), 0.0)
    return t, ok


def _est_np(planes_all, idx, rays, eps):
    """(t, ok, inverse-variance weight) — same fusion scheme as the JAX path:
    variance = depth sensitivity to a one-index plane step (forward diff,
    backward at the last plane)."""
    n_planes = len(planes_all)
    idx = np.clip(idx, 0, n_planes - 1)
    nbr = np.where(idx + 1 < n_planes, idx + 1, idx - 1)
    t0, ok0 = _plane_t_np(planes_all[idx], rays, eps)
    t1, _ = _plane_t_np(planes_all[nbr], rays, eps)
    sens = np.abs(t1 - t0) + 1e-12
    return t0, ok0, 1.0 / (sens * sens)


def triangulate_np(col_map, row_map, mask, cam_K, proj_K, R, T,
                   proj_width=1920, proj_height=1080,
                   cfg: TriangulationConfig = TriangulationConfig()):
    """Gathered (ragged) triangulation like the reference: only valid pixels.

    Returns (points (N,3) float64, valid_flat_indices (N,)).
    """
    H, W = col_map.shape
    rays = camera_rays_np(cam_K, H, W).reshape(-1, 3)
    valid = np.flatnonzero(mask.reshape(-1))
    r = rays[valid]
    if cfg.plane_axis == "col":
        planes_all = projector_planes_np(proj_K, R, T, proj_width, "col")
        idx = np.clip(col_map.reshape(-1)[valid], 0, proj_width - 1)
        t, ok = _plane_t_np(planes_all[idx], r, cfg.denom_eps)
    elif cfg.plane_axis == "row":
        planes_all = projector_planes_np(proj_K, R, T, proj_height, "row")
        idx = np.clip(row_map.reshape(-1)[valid], 0, proj_height - 1)
        t, ok = _plane_t_np(planes_all[idx], r, cfg.denom_eps)
    elif cfg.plane_axis == "both":
        pc = projector_planes_np(proj_K, R, T, proj_width, "col")
        pr = projector_planes_np(proj_K, R, T, proj_height, "row")
        tc, sc, wc = _est_np(pc, col_map.reshape(-1)[valid], r, cfg.denom_eps)
        tr, sr, wr = _est_np(pr, row_map.reshape(-1)[valid], r, cfg.denom_eps)
        wc = wc * sc
        wr = wr * sr
        wsum = wc + wr
        ok = (sc | sr) & (wsum > 0.0)
        t = np.where(ok, (wc * tc + wr * tr) / np.where(ok, wsum, 1.0), 0.0)
    else:
        raise ValueError(f"unknown plane_axis {cfg.plane_axis!r}")
    ok &= (t > cfg.min_t) & (t < cfg.max_t)
    points = t[:, None] * r
    return points[ok], valid[ok]
