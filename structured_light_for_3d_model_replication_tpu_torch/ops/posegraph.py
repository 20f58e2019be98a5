"""Pose utilities of the 360° chain (counterpart of the JAX
``ops/posegraph.py``: ``log_so3`` and ``chain_poses``; the pose-graph
Levenberg–Marquardt solve is not part of the port yet).

Node pose X_i maps frame-i points into the global (node 0) frame.
"""

from __future__ import annotations

import torch


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation vector of (..., 3, 3); safe near identity."""
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    cos = ((tr - 1.0) / 2.0).clamp(-1.0, 1.0)
    th = torch.acos(cos)
    v = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    s = torch.sin(th)
    one = torch.ones((), dtype=R.dtype, device=R.device)
    # th / (2 sin th) → 1/2 as th → 0.
    scale = torch.where(th[..., None] > 1e-6,
                        th[..., None] / (2.0 * torch.where(s.abs() > 1e-12,
                                                           s, one)[..., None]),
                        0.5 * one)
    return v * scale


def chain_poses(edge_T_seq: torch.Tensor) -> torch.Tensor:
    """Odometry poses from sequential edges: X_{i+1} = X_i · T_i, where T_i
    maps frame-(i+1) points into frame i (the ICP result of aligning scan
    i+1 onto scan i). Returns (N, 4, 4) with X_0 = I."""
    X = torch.eye(4, dtype=edge_T_seq.dtype, device=edge_T_seq.device)
    poses = [X]
    for T in edge_T_seq:
        X = X @ T
        poses.append(X)
    return torch.stack(poses)
