"""A frozen NumPy copy of the port's frame model
(``models/synthetic.py``: ``default_calibration``, ``rotated_scene``,
``raycast``, ``FrameShader``; ``models/oracle.camera_rays_np``;
``ops/patterns.pattern_stack``), kept here so that the on-card renderer
(``render.py``) is held to a fixed model whatever the port later changes.
Host only, float64, no noise."""

from __future__ import annotations

import numpy as np


def default_calibration(cam_height: int, cam_width: int, proj_width: int,
                        proj_height: int):
    """(cam_K, proj_K, R, T): the rig's camera and projector, X_p = R X_c +
    T in mm."""
    f_cam = 1.1 * cam_width
    cam_K = np.array([[f_cam, 0, cam_width / 2 - 0.5],
                      [0, f_cam, cam_height / 2 - 0.5],
                      [0, 0, 1]], dtype=np.float64)
    f_proj = 1.2 * proj_width
    proj_K = np.array([[f_proj, 0, proj_width / 2 - 0.5],
                       [0, f_proj, proj_height / 2 - 0.5],
                       [0, 0, 1]], dtype=np.float64)
    ang = np.deg2rad(8.0)
    R = np.array([[np.cos(ang), 0, -np.sin(ang)],
                  [0, 1, 0],
                  [np.sin(ang), 0, np.cos(ang)]], dtype=np.float64)
    T = np.array([150.0, 0.0, 20.0], dtype=np.float64)
    return cam_K, proj_K, R, T


def gray_bits(n: int, n_bits: int) -> np.ndarray:
    """(n_bits, n) uint8: Gray-code bit b (MSB first) of each index."""
    idx = np.arange(n, dtype=np.int64)
    g = idx ^ (idx >> 1)
    shifts = np.arange(n_bits - 1, -1, -1)[:, None]
    return ((g[None, :] >> shifts) & 1).astype(np.uint8)


def pattern_frames(width: int, height: int, col_bits: int, row_bits: int,
                   brightness: int = 200) -> np.ndarray:
    """(2 + 2 col_bits + 2 row_bits, height, width) uint8: white, black,
    then a (pattern, inverse) pair per column bit, then per row bit."""
    b = brightness
    frames = [np.full((height, width), b, np.uint8),
              np.zeros((height, width), np.uint8)]
    for bit in gray_bits(width, col_bits):
        pat = np.broadcast_to(bit[None, :] * b, (height, width))
        frames += [pat.astype(np.uint8), (b - pat).astype(np.uint8)]
    for bit in gray_bits(height, row_bits):
        pat = np.broadcast_to(bit[:, None] * b, (height, width))
        frames += [pat.astype(np.uint8), (b - pat).astype(np.uint8)]
    return np.stack(frames)


def rotated_spheres(spheres, pivot, angle_deg: float):
    """The spheres after the turntable turns by ``angle_deg`` about the
    vertical axis through ``pivot``: [(center, radius, albedo)]."""
    th = np.deg2rad(angle_deg)
    Ry = np.array([[np.cos(th), 0, np.sin(th)],
                   [0, 1, 0],
                   [-np.sin(th), 0, np.cos(th)]], dtype=np.float64)
    p = np.asarray(pivot, np.float64)
    return [(tuple(p + Ry @ (np.asarray(c, np.float64) - p)), r, a)
            for c, r, a in spheres]


def camera_rays(cam_K, height: int, width: int) -> np.ndarray:
    uu, vv = np.meshgrid(np.arange(width, dtype=np.float64),
                         np.arange(height, dtype=np.float64))
    pix = np.stack([uu, vv, np.ones_like(uu)], axis=-1)
    rays = pix @ np.linalg.inv(cam_K).T
    return rays / np.linalg.norm(rays, axis=-1, keepdims=True)


def raycast(spheres, wall_z, wall_albedo: float, rays: np.ndarray):
    """(t, albedo, hit) of unit rays from the origin; nearest hit wins."""
    n = rays.shape[0]
    t_best = np.full(n, np.inf)
    albedo = np.zeros(n)
    for c, r, a in spheres:
        c = np.asarray(c, np.float64)
        b = rays @ c
        disc = b * b - (c @ c - r ** 2)
        ok = disc > 0
        sq = np.sqrt(np.where(ok, disc, 0.0))
        t0, t1 = b - sq, b + sq
        t = np.where(t0 > 1e-6, t0, t1)
        ok &= t > 1e-6
        closer = ok & (t < t_best)
        t_best = np.where(closer, t, t_best)
        albedo = np.where(closer, a, albedo)
    if wall_z is not None:
        rz = rays[:, 2]
        ok = rz > 1e-6
        t = np.where(ok, wall_z / np.where(ok, rz, 1.0), np.inf)
        closer = ok & (t < t_best)
        t_best = np.where(closer, t, t_best)
        albedo = np.where(closer, wall_albedo, albedo)
    hit = np.isfinite(t_best)
    return np.where(hit, t_best, 0.0), albedo, hit


def render_stop(spheres, wall_z, wall_albedo: float, ambient: float, rig,
                cam_height: int, cam_width: int, frames: np.ndarray):
    """One stop's (F, H, W) uint8 stack: each camera pixel sees the
    projector pixel its surface point projects to, scaled by the albedo,
    plus the ambient light."""
    cam_K, proj_K, R, T = rig
    ph, pw = frames.shape[1:]
    rays = camera_rays(cam_K, cam_height, cam_width).reshape(-1, 3)
    t, albedo, hit = raycast(spheres, wall_z, wall_albedo, rays)
    P_p = (t[:, None] * rays) @ R.T + T[None, :]
    z = P_p[:, 2]
    ok_z = z > 1e-6
    zs = np.where(ok_z, z, 1.0)
    u = np.where(ok_z, (proj_K[0, 0] * P_p[:, 0] + proj_K[0, 2] * z) / zs,
                 -1.0)
    v = np.where(ok_z, (proj_K[1, 1] * P_p[:, 1] + proj_K[1, 2] * z) / zs,
                 -1.0)
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    lit = hit & ok_z & (ui >= 0) & (ui < pw) & (vi >= 0) & (vi < ph)
    ui, vi = np.clip(ui, 0, pw - 1), np.clip(vi, 0, ph - 1)
    out = np.empty((frames.shape[0], cam_height, cam_width), np.uint8)
    for f in range(frames.shape[0]):
        val = frames[f][vi, ui].astype(np.float64)
        val = np.where(lit, albedo * val + ambient,
                       np.where(hit, ambient, 0.0))
        out[f] = np.clip(val, 0, 255).astype(np.uint8).reshape(
            cam_height, cam_width)
    return out
