"""The plain reference: Gray-code decode, the adaptive mask, ray-plane
triangulation against the projector's column planes, the turntable's
commanded poses, voxel thinning, nearest-neighbour distances and a binary
STL reader, in plain PyTorch and NumPy. It works everything out again from
the rendered frames and the rig; it takes nothing the port made, and it
imports nothing of the port."""

from __future__ import annotations

import math

import numpy as np
import torch

# What the reference computes in; ``CONTROL`` is the nearest precision below
# the float32 the configurations state (their ``precision`` key), in which
# the control computes the same answers.
EXACT = torch.float64
CONTROL = torch.bfloat16


def decode(stack: torch.Tensor, col_bits: int):
    """(F, H, W) uint8 stack → (column index (H·W,) int64, valid (H·W,)
    bool): bit b is pattern > inverse, MSB first, Gray to binary; valid
    where white > 1.5 × the 95th percentile of black and white − black >
    5% of its maximum."""
    f, h, w = stack.shape
    flat = stack.reshape(f, -1)
    gray = torch.zeros(h * w, dtype=torch.int64, device=stack.device)
    for b in range(col_bits):
        bit = (flat[2 + 2 * b] > flat[3 + 2 * b]).to(torch.int64)
        gray = gray | (bit << (col_bits - 1 - b))
    col = gray.clone()
    shift = 1
    while shift < col_bits:
        col = col ^ (col >> shift)
        shift *= 2
    white = flat[0].to(torch.float64)
    black = flat[1].to(torch.float64)
    contrast = white - black
    valid = (white > 1.5 * torch.quantile(black, 0.95)) \
        & (contrast > 0.05 * contrast.max())
    return col, valid


def camera_rays(cam_K: np.ndarray, h: int, w: int, device,
                dtype=EXACT) -> torch.Tensor:
    """(H·W, 3) unit rays of the camera's pixels."""
    kinv = torch.tensor(np.linalg.inv(cam_K), dtype=torch.float64,
                        device=device)
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                          torch.arange(w, dtype=torch.float64, device=device),
                          indexing="ij")
    pix = torch.stack([u, v, torch.ones_like(u)], -1).reshape(-1, 3)
    rays = pix @ kinv.T
    return (rays / torch.linalg.norm(rays, dim=-1, keepdim=True)).to(dtype)


def column_planes(proj_K: np.ndarray, R: np.ndarray, T: np.ndarray,
                  n: int, device, dtype=EXACT) -> torch.Tensor:
    """(n, 4) planes [normal, d] in camera coordinates, one per projector
    column: through the projector's centre, spanned by the column's rays."""
    kinv = np.linalg.inv(proj_K)
    center = -(R.T @ T)
    u = np.arange(n, dtype=np.float64)
    top = np.stack([u, np.zeros(n), np.ones(n)], -1) @ kinv.T @ R
    along = R.T @ kinv[:, 1]
    normal = np.cross(top, along[None, :])
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    d = -(normal @ center)
    return torch.tensor(np.concatenate([normal, d[:, None]], -1),
                        device=device).to(dtype)


def triangulate(stack: torch.Tensor, rig, dtype=EXACT):
    """(points (N, 3) float32 of the valid pixels, pixel indices (N,)) of
    one stop, computed in ``dtype``."""
    cam_K, proj_K, R, T = rig.matrices
    col, valid = decode(stack, rig.col_bits)
    col = col.clamp(0, rig.proj_w - 1)
    rays = camera_rays(cam_K, rig.cam_h, rig.cam_w, stack.device, dtype)
    planes = column_planes(proj_K, R, T, rig.proj_w, stack.device, dtype)
    pl = planes[col]
    denom = (pl[:, :3] * rays).sum(-1)
    ok = denom.abs() > 1e-6
    t = -pl[:, 3] / torch.where(ok, denom, torch.ones_like(denom))
    valid = valid & ok & (t > 0) & (t < 1e5)
    idx = torch.nonzero(valid).squeeze(1)
    points = (t[idx, None] * rays[idx]).to(torch.float32)
    return points, idx


def turntable_pose(angle_deg: float, anchor_deg: float, pivot) -> np.ndarray:
    """4×4 map from the camera frame of the stop at ``angle_deg`` to the
    frame of the stop at ``anchor_deg`` (the turntable turns the scene about
    the vertical axis through ``pivot``)."""
    th = math.radians(anchor_deg - angle_deg)
    c, s = math.cos(th), math.sin(th)
    Ry = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    p = np.asarray(pivot, np.float64)
    pose = np.eye(4)
    pose[:3, :3] = Ry
    pose[:3, 3] = p - Ry @ p
    return pose


def transform(pose: np.ndarray, points: torch.Tensor) -> torch.Tensor:
    P = torch.as_tensor(pose, dtype=torch.float64, device=points.device)
    return (points.to(torch.float64) @ P[:3, :3].T + P[:3, 3]).to(
        torch.float32)


def thin(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """One point of each ``voxel``-sized cell (the first in cell order)."""
    if points.shape[0] == 0:
        return points
    q = torch.floor(points.to(torch.float64) / voxel).to(torch.int64)
    q = q - q.min(0).values
    span = q.max(0).values + 1
    key = (q[:, 0] * span[1] + q[:, 1]) * span[2] + q[:, 2]
    order = torch.argsort(key, stable=True)
    ks = key[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    return points[order[first]]


def nearest_distance(queries: torch.Tensor, keys: torch.Tensor,
                     block: int = 2048, key_block: int = 65536) -> torch.Tensor:
    """Distance of each query to its nearest key: float64 about the keys'
    mean, where the matmul expansion of ``cdist`` loses nothing that
    matters (|x|² ~ 10⁴ mm² against a float64 ulp)."""
    if keys.shape[0] == 0:
        return torch.full((queries.shape[0],), math.inf,
                          device=queries.device)
    center = keys.to(torch.float64).mean(0)
    q = queries.to(torch.float64) - center
    k = keys.to(torch.float64) - center
    out = torch.empty(q.shape[0], dtype=torch.float64, device=q.device)
    for i in range(0, q.shape[0], block):
        best = None
        for j in range(0, k.shape[0], key_block):
            d = torch.cdist(q[i:i + block], k[j:j + key_block],
                            compute_mode="use_mm_for_euclid_dist")
            m = d.min(1).values
            best = m if best is None else torch.minimum(best, m)
        out[i:i + block] = best
    return out


def percentile(values: torch.Tensor, q: float) -> float:
    """The ``q``-th percentile (linear, as numpy's default)."""
    v = values.to(torch.float64).cpu().numpy()
    return float(np.percentile(v, q)) if v.size else math.inf


_STL = np.dtype([("normal", "<f4", (3,)), ("v", "<f4", (3, 3)),
                 ("attr", "<u2")])


def read_stl(data: bytes) -> np.ndarray:
    """Binary STL bytes → (F, 3, 3) float32 triangle corners; raises on a
    malformed file."""
    if len(data) < 84:
        raise ValueError("STL shorter than its header")
    n = int(np.frombuffer(data, "<u4", 1, 80)[0])
    if len(data) != 84 + 50 * n:
        raise ValueError(f"STL of {len(data)} bytes for {n} triangles")
    return np.frombuffer(data, _STL, n, 84)["v"]
