"""Pose utilities and the pose-graph solve of the 360° ring (counterpart of
the JAX ``ops/posegraph.py``): ``log_so3``, ``chain_poses``, the
Levenberg–Marquardt ``optimize`` and ``build_360_graph``.

Node pose X_i maps frame-i points into the global (node 0) frame; an edge
(i, j, T_ij) measures ``X_i ≈ X_j · T_ij`` with the residual
``r = [log_SO3, trans](T_ij⁻¹ · X_j⁻¹ · X_i)`` weighted by the edge's 6×6
information matrix.

The JAX package takes the LM Jacobian by ``jax.jacfwd`` at ξ = 0 through its
small-angle-safe ``exp_se3``, whose ``where(θ > 1e-12, R, I)`` masks the
Rodrigues branch: the rotation columns of that Jacobian are exactly zero,
so its LM moves each node's translation (in the node's own frame) and
leaves rotations at their chained values. The port writes that Jacobian
out: ``∂r_t/∂t_src = R(E)``, ``∂r_t/∂t_dst = −R(T⁻¹)``, every other entry
zero — the same steps, with no autodiff and no host read per iteration
(accept/reject is a ``torch.where``). Float32 throughout; the port never
enables TF32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PoseGraph(NamedTuple):
    poses: torch.Tensor       # (N, 4, 4) initial node poses (frame i → global)
    edge_src: torch.Tensor    # (E,) int
    edge_dst: torch.Tensor    # (E,) int
    edge_T: torch.Tensor      # (E, 4, 4) measured X_dst⁻¹ X_src
    edge_info: torch.Tensor   # (E, 6, 6) information matrices


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


def _residuals(poses, Tinv, src, dst):
    """(E, 6) edge residuals [log_SO3(E_R), E_t] and the (E, 3, 3) E_R of
    ``E = T⁻¹ · X_dst⁻¹ · X_src``."""
    E = Tinv @ torch.linalg.inv(poses[dst]) @ poses[src]
    return torch.cat([log_so3(E[:, :3, :3]), E[:, :3, 3]], dim=-1), \
        E[:, :3, :3]


def _cost(r, info):
    return torch.einsum("ei,eij,ej->", r, info, r)


def optimize(graph: PoseGraph, iterations: int = 30,
             damping: float = 1e-6) -> torch.Tensor:
    """Levenberg–Marquardt over node poses (node 0 held fixed). Returns the
    optimized (N, 4, 4) float32 poses. A step that lowers the weighted cost
    is accepted and λ halves, otherwise it is rejected and λ grows ×4 (the
    JAX package's schedule)."""
    n = graph.poses.shape[0]
    nv = 6 * (n - 1)
    dev = graph.poses.device
    f32 = torch.float32
    poses = graph.poses.to(f32)
    Tinv = torch.linalg.inv(graph.edge_T.to(f32))
    info = graph.edge_info.to(f32)
    src = graph.edge_src.to(torch.int64)
    dst = graph.edge_dst.to(torch.int64)
    e = src.shape[0]
    lam = torch.full((), float(damping), dtype=f32, device=dev)
    eye_nv = torch.eye(nv, dtype=f32, device=dev)
    # Translation column blocks of each edge's endpoints (node k ≥ 1 owns
    # variables 6(k−1) .. 6(k−1)+5, translation at +3 .. +5); node 0 is
    # fixed and gets none.
    cols = torch.arange(3, dtype=torch.int64, device=dev)
    rows_e = torch.arange(e, dtype=torch.int64, device=dev)
    for _ in range(iterations):
        r, E_R = _residuals(poses, Tinv, src, dst)
        J = torch.zeros((e + 1, 6, nv + 6), dtype=f32, device=dev)
        # Node 0's columns land in a spare block (index nv .. nv+5) that is
        # cut off, as are padded rows.
        cs = torch.where(src > 0, 6 * (src - 1) + 3, nv)
        cd = torch.where(dst > 0, 6 * (dst - 1) + 3, nv)
        ix = (rows_e[:, None, None], 3 + cols[None, :, None],
              cs[:, None, None] + cols[None, None, :])
        # torchlint: disable=atomic-scatter -- one entry an index: no sum
        J.index_put_(ix, E_R, accumulate=True)
        ix = (rows_e[:, None, None], 3 + cols[None, :, None],
              cd[:, None, None] + cols[None, None, :])
        # torchlint: disable=atomic-scatter -- one entry an index: no sum
        J.index_put_(ix, -Tinv[:, :3, :3], accumulate=True)
        J = J[:e, :, :nv]
        JL = torch.einsum("eij,ejv->eiv", info, J)
        H = torch.einsum("eiv,eiw->vw", J, JL)
        g = torch.einsum("eiv,eij,ej->v", J, info, r)
        delta = -torch.linalg.solve(H + lam * eye_nv, g)
        new_poses = _apply_delta(poses, delta, n)
        c0 = _cost(r, info)
        c1 = _cost(_residuals(new_poses, Tinv, src, dst)[0], info)
        better = c1 < c0
        poses = torch.where(better, new_poses, poses)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    return poses


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    """(K, 3) rotation vectors → (K, 3, 3) (Rodrigues, small-angle-safe)."""
    from .registration import skew

    th = torch.linalg.norm(w, dim=-1)[:, None, None]
    one = torch.ones((), dtype=w.dtype, device=w.device)
    K = skew(w / torch.where(th[:, 0] > 1e-12, th[:, 0], one))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    R = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
    return torch.where(th > 1e-12, R, eye)


def _apply_delta(poses: torch.Tensor, xi: torch.Tensor, n: int):
    """Right-perturb every pose except node 0 by exp_se3(ξ_k)."""
    from .registration import _assemble_rigid

    xi_full = torch.cat([xi.new_zeros((1, 6)), xi.reshape(n - 1, 6)])
    deltas = _assemble_rigid(_exp_so3(xi_full[:, :3]), xi_full[:, 3:])
    return poses @ deltas


def build_360_graph(seq_T: torch.Tensor, seq_info: torch.Tensor,
                    loop_T: torch.Tensor | None = None,
                    loop_info: torch.Tensor | None = None) -> PoseGraph:
    """Graph of an N-stop turntable ring: sequential edges i+1 → i plus the
    optional loop-closure edge 0 → N−1. ``seq_T[i]`` maps frame-(i+1)
    points into frame i; ``loop_T`` maps frame-0 points into frame N−1."""
    n = seq_T.shape[0] + 1
    dev = seq_T.device
    poses = chain_poses(seq_T)
    src = torch.arange(1, n, dtype=torch.int64, device=dev)
    dst = torch.arange(0, n - 1, dtype=torch.int64, device=dev)
    edge_T, info = seq_T, seq_info
    if loop_T is not None:
        src = torch.cat([src, src.new_zeros(1)])
        dst = torch.cat([dst, dst.new_full((1,), n - 1)])
        edge_T = torch.cat([edge_T, loop_T[None]])
        info = torch.cat([info, loop_info[None]])
    return PoseGraph(poses, src, dst, edge_T, info)
