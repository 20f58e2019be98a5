"""Rigid registration: Kabsch/Horn, feature RANSAC, ICP, information matrix
(counterpart of the JAX ``ops/registration.py``).

Transforms are 4×4 float32, ``x' = T[:3,:3] @ x + T[:3,3]``, pose order
(rotation | translation). The JAX package's ``vmap`` becomes a written-out
batch dimension and its ``lax.scan`` a Python loop. The k = 1
correspondence sweep (:func:`_nn1`) always goes through ``ops/nn.py``: the
CUDA kernel on the card, its plain version on the host.

The edge math — :func:`_nn1`, :func:`transform_points`,
:func:`match_features`, :func:`ransac_feature_registration`, :func:`icp`
and :func:`information_matrix` — also takes a leading edge axis E (every
operand (E, ...)): the JAX package's fused ring ``vmap``s it over the
ring's edges, the port runs each step once for all E. Per edge it is the
same arithmetic; where a batched matrix product may sum in another order
than the single one, an edge can differ from its own single run in the
last bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import nn as nn_ops
from .knn import knn, rows


def _nn1(moved, dst_pts, dst_valid, src_valid, table=None):
    """k = 1 correspondence sweep. Returns (idx (N,), found (N,), d2 (N,))
    with d2 = +inf where no valid key exists (each (E, N) with a leading
    edge axis: one launch for all edges). ``table`` reuses a
    precomputed ``nn.key_table`` when the same keys are swept repeatedly.
    Unlike the JAX package there is no key-count cap and no other path."""
    if table is None:
        table = nn_ops.key_table(dst_pts, dst_valid)
    d2, idx = nn_ops.nearest_one(moved.contiguous(), *table)
    found = torch.isfinite(d2)
    if src_valid is not None:
        found = found & src_valid
    return idx, found, d2


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transforms applied to (..., N, 3) points."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) -> (..., 3, 3) rotation (Rodrigues,
    small-angle-safe)."""
    th = torch.linalg.norm(omega, dim=-1, keepdim=True)
    one = torch.ones((), dtype=omega.dtype, device=omega.device)
    k = omega / torch.where(th > 1e-12, th, one)
    K = skew(k)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    th = th[..., None]
    R = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
    return torch.where(th > 1e-12, R, eye)


def _assemble_rigid(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[R | t; 0 0 0 1], batched."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def exp_se3(omega: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotation vector + translation -> 4×4 (translation applied directly,
    matching the ICP small-step update)."""
    return _assemble_rigid(exp_so3(omega), t)


def _quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternion (w, x, y, z) → (..., 3, 3) rotation."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def _power_step(A: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    q = (A @ q[..., None])[..., 0]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-20)


def kabsch(src: torch.Tensor, dst: torch.Tensor,
           weights: torch.Tensor | None = None, power_iters: int = 24,
           ensure_converged: bool = False) -> torch.Tensor:
    """Optimal rigid transform src→dst (weighted), (..., N, 3) batched, by
    Horn's quaternion method: the dominant eigenvector of a 4×4 symmetric
    matrix, found by a fixed-count shifted power iteration (the JAX
    package's algorithm, not an SVD). ``ensure_converged`` keeps iterating
    until the Rayleigh residual ‖Aq − λq‖ < 1e-6 or 160 extra steps: in a
    batch every problem steps until its own residual is below it and is
    then held, as under the JAX package's ``vmap`` of its while loop, with
    one host readback a step for the whole batch."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights[..., None]
    wsum = w.sum(-2, keepdim=True).clamp_min(1e-12)
    cs = (src * w).sum(-2, keepdim=True) / wsum
    cd = (dst * w).sum(-2, keepdim=True) / wsum
    s = (src - cs) * w
    d = dst - cd
    H = s.transpose(-1, -2) @ d

    S = H / torch.linalg.norm(H, dim=(-2, -1), keepdim=True).clamp_min(1e-12)
    t0, t1, t2 = S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]
    K = torch.stack([
        torch.stack([t0 + t1 + t2, S[..., 1, 2] - S[..., 2, 1],
                     S[..., 2, 0] - S[..., 0, 2],
                     S[..., 0, 1] - S[..., 1, 0]], dim=-1),
        torch.stack([S[..., 1, 2] - S[..., 2, 1], t0 - t1 - t2,
                     S[..., 0, 1] + S[..., 1, 0],
                     S[..., 0, 2] + S[..., 2, 0]], dim=-1),
        torch.stack([S[..., 2, 0] - S[..., 0, 2],
                     S[..., 0, 1] + S[..., 1, 0], -t0 + t1 - t2,
                     S[..., 1, 2] + S[..., 2, 1]], dim=-1),
        torch.stack([S[..., 0, 1] - S[..., 1, 0],
                     S[..., 0, 2] + S[..., 2, 0],
                     S[..., 1, 2] + S[..., 2, 1], -t0 - t1 + t2], dim=-1),
    ], dim=-2)
    # K's spectrum lies in [-2, 2] after normalization, so K + 2I is PSD and
    # the power iteration converges to the TOP eigenvalue.
    A = K + 2.0 * torch.eye(4, dtype=K.dtype, device=K.device)
    q = torch.tensor([0.5377, 0.2810, 0.4821, 0.6317], dtype=K.dtype,
                     device=K.device).expand(K.shape[:-2] + (4,))
    for _ in range(power_iters):
        q = _power_step(A, q)
    if ensure_converged:
        for _ in range(160):
            Aq = (A @ q[..., None])[..., 0]
            lam = (q * Aq).sum(-1, keepdim=True)
            active = torch.linalg.norm(Aq - lam * q, dim=-1) > 1e-6
            if not bool(active.any()):
                break
            q = torch.where(active[..., None], _power_step(A, q), q)
    degenerate = torch.linalg.norm(H, dim=(-2, -1)) < 1e-12
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=q.dtype,
                         device=q.device)
    q = torch.where(degenerate[..., None], ident, q)
    R = _quat_to_rot(q)
    t = cd[..., 0, :] - (R @ cs[..., 0, :, None])[..., 0]
    return _assemble_rigid(R, t)


class RegistrationResult(NamedTuple):
    transformation: torch.Tensor  # (4, 4)
    fitness: torch.Tensor         # inliers / valid source points
    inlier_rmse: torch.Tensor


def _triplet_rigid(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Exact rigid transform of (..., 3, 3) point triplets via triangle
    frames: R maps src's orthonormal triangle frame onto dst's. RANSAC's
    hypothesis solver."""
    def frame(p):
        u = p[..., 1, :] - p[..., 0, :]
        v = p[..., 2, :] - p[..., 0, :]
        e1 = u / torch.linalg.norm(u, dim=-1, keepdim=True).clamp_min(1e-12)
        w = v - (v * e1).sum(-1, keepdim=True) * e1
        e2 = w / torch.linalg.norm(w, dim=-1, keepdim=True).clamp_min(1e-12)
        e3 = torch.linalg.cross(e1, e2, dim=-1)
        return torch.stack([e1, e2, e3], dim=-1)        # columns
    R = frame(d) @ frame(s).transpose(-1, -2)
    t = d.mean(-2) - (R @ s.mean(-2)[..., None])[..., 0]
    return _assemble_rigid(R, t)


# ---------------------------------------------------------------------------
# Global registration: feature matching + batched RANSAC
# ---------------------------------------------------------------------------


def match_features(src_feat: torch.Tensor, dst_feat: torch.Tensor,
                   src_valid: torch.Tensor | None = None,
                   dst_valid: torch.Tensor | None = None,
                   mutual: bool = True,
                   live: tuple[int, int] | None = None):
    """Nearest-neighbour correspondence per source feature (33-D exact KNN).
    Returns (dst_index (N,), corr_valid (N,)), each (E, N) with a leading
    edge axis; ``mutual`` keeps only pairs that are each other's nearest
    neighbours. ``live`` = (src, dst) counts of the leading rows that hold
    every valid feature (``knn``'s ``live``): the rows past them come back
    unmatched."""
    _, idx_sd, v_sd = knn(dst_feat, 1, queries=src_feat,
                          points_valid=dst_valid, queries_valid=src_valid,
                          live=None if live is None else live[::-1])
    nn = idx_sd[..., 0]
    ok = v_sd[..., 0]
    if mutual:
        _, idx_ds, v_ds = knn(src_feat, 1, queries=dst_feat,
                              points_valid=src_valid, queries_valid=dst_valid,
                              live=live)
        back = torch.gather(idx_ds[..., 0], -1, nn)
        ok = ok & torch.gather(v_ds[..., 0], -1, nn) & (back == torch.arange(
            src_feat.shape[-2], device=back.device))
    return nn, ok


def ransac_samples(n: int, num_iterations: int, batch: int,
                   generator: torch.Generator | None, device,
                   ransac_n: int = 3) -> torch.Tensor:
    """(n_batches, batch, ransac_n) int64 correspondence draws in [0, n)."""
    n_batches = max(1, num_iterations // batch)
    return torch.randint(0, n, (n_batches, batch, ransac_n),
                         generator=generator, device=device)


def _ransac_core(generator, src_pts, dst_pts, corr_idx, corr_ok,
                 distance_threshold: float, edge_length_ratio: float,
                 num_iterations: int, batch: int, ransac_n: int,
                 samples: torch.Tensor | None = None) -> RegistrationResult:
    """``(num_iterations // batch) * batch`` hypotheses in batches: sample
    triplets, solve, prune with the edge-length and distance checkers,
    rank by inliers on a strided 256-point subset; the winner is re-scored
    and polished on the full set. ``samples`` (n_batches, batch, ransac_n)
    int64 replaces the draws from ``generator`` (tests feed both packages
    the same draws). With a leading edge axis E every operand is (E, ...),
    ``generator`` a sequence of E generators (edge e draws exactly what its
    single run draws from its own) or ``samples`` (E, n_batches, batch,
    ransac_n), and each hypothesis batch runs once for all E: about
    E × batch × 256 × 12 bytes at its peak (0.58 GB at 23 × 8192)."""
    lead = src_pts.shape[:-2]
    n = src_pts.shape[-2]
    dev = src_pts.device
    if samples is None:
        samples = torch.stack([
            ransac_samples(n, num_iterations, batch, g, dev, ransac_n)
            for g in (generator if lead else [generator])]).reshape(
                lead + (-1, batch, ransac_n))
    samples = samples.to(dev)
    thr2 = distance_threshold ** 2
    dst_c = rows(dst_pts, corr_idx)

    def score_T(T):
        d2 = torch.sum((transform_points(T, src_pts) - dst_c) ** 2, dim=-1)
        inl = corr_ok & (d2 <= thr2)
        cnt = inl.sum(-1)
        rmse = torch.sqrt(torch.where(inl, d2, torch.zeros((), device=dev))
                          .sum(-1) / cnt.clamp_min(1))
        return cnt, rmse, inl

    # Hypothesis ranking on a strided subset of the correspondences.
    sub = max(1, n // 256)
    sub_src = src_pts[..., None, ::sub, :]
    sub_dst = dst_c[..., None, ::sub, :]
    sub_ok = corr_ok[..., None, ::sub]
    tbl = torch.cat([src_pts, dst_c, corr_ok.to(torch.float32)[..., None]],
                    -1)
    iu, ju = torch.triu_indices(ransac_n, ransac_n, 1, device=dev)

    best_T = torch.eye(4, dtype=torch.float32, device=dev).expand(
        lead + (4, 4))
    best_cnt = torch.full(lead, -1, dtype=torch.int64, device=dev)
    for k in range(samples.shape[-3]):
        samp = samples[..., k, :, :]
        drawn = rows(tbl, samp)                            # (…, b, n_s, 7)
        s = drawn[..., :3]
        d = drawn[..., 3:6]
        ok = torch.all(drawn[..., 6] > 0.5, dim=-1)
        es = torch.linalg.norm(s[..., iu, :] - s[..., ju, :], dim=-1)
        ed = torch.linalg.norm(d[..., iu, :] - d[..., ju, :], dim=-1)
        ratio = torch.minimum(es, ed) / torch.maximum(es, ed).clamp_min(1e-12)
        ok = ok & torch.all(ratio >= edge_length_ratio, dim=-1)
        T = (_triplet_rigid(s, d) if ransac_n == 3
             else kabsch(s, d, power_iters=12))
        moved = transform_points(T, s)
        ok = ok & torch.all(torch.linalg.norm(moved - d, dim=-1)
                            <= distance_threshold, dim=-1)
        sd2 = torch.sum((transform_points(T, sub_src) - sub_dst) ** 2, -1)
        cnt = (sub_ok & (sd2 <= thr2)).sum(-1)
        cnts = torch.where(ok, cnt, torch.full((), -1, dtype=cnt.dtype,
                                               device=dev))
        i = torch.argmax(cnts, dim=-1, keepdim=True)
        top = torch.gather(cnts, -1, i)[..., 0]
        better = top > best_cnt
        T_i = torch.gather(T, -3, i[..., None, None].expand(
            lead + (1, 4, 4)))[..., 0, :, :]
        best_T = torch.where(better[..., None, None], T_i, best_T)
        best_cnt = torch.where(better, top, best_cnt)

    # Polish: re-estimate from ALL inliers of the best hypothesis.
    cnt0, _, inl = score_T(best_T)
    T_ref = kabsch(src_pts, dst_c, weights=inl.to(torch.float32),
                   ensure_converged=True)
    cnt1, _, _ = score_T(T_ref)
    T_fin = torch.where((cnt1 >= cnt0)[..., None, None], T_ref, best_T)
    cntf, rmsef, _ = score_T(T_fin)
    fitness = cntf.to(torch.float32) / corr_ok.sum(-1).clamp_min(1)
    return RegistrationResult(T_fin, fitness, rmsef)


def ransac_feature_registration(src_pts, src_feat, dst_pts, dst_feat,
                                distance_threshold: float,
                                src_valid=None, dst_valid=None,
                                mutual: bool = True,
                                edge_length_ratio: float = 0.9,
                                num_iterations: int = 100_000,
                                batch: int = 8192, ransac_n: int = 3,
                                generator=None,
                                live: tuple[int, int] | None = None
                                ) -> RegistrationResult:
    """Global registration à la
    ``registration_ransac_based_on_feature_matching`` (1.5·voxel threshold,
    edge-length 0.9, 100k iterations). Every hypothesis runs — no early
    confidence exit (equivalent to confidence = 1.0). With a leading edge
    axis, ``generator`` is one ``torch.Generator`` an edge. ``live`` goes
    to :func:`match_features`."""
    src_pts = src_pts.to(torch.float32)
    dst_pts = dst_pts.to(torch.float32)
    corr_idx, corr_ok = match_features(src_feat, dst_feat, src_valid,
                                       dst_valid, mutual=mutual, live=live)
    if src_valid is not None:
        corr_ok = corr_ok & src_valid
    return _ransac_core(generator, src_pts, dst_pts, corr_idx, corr_ok,
                        distance_threshold, edge_length_ratio,
                        num_iterations, batch, ransac_n)


# ---------------------------------------------------------------------------
# ICP
# ---------------------------------------------------------------------------


def icp(src_pts: torch.Tensor, dst_pts: torch.Tensor,
        max_correspondence_distance: float,
        init: torch.Tensor | None = None,
        dst_normals: torch.Tensor | None = None,
        src_valid: torch.Tensor | None = None,
        dst_valid: torch.Tensor | None = None,
        max_iterations: int = 30, method: str = "point_to_plane",
        schedule: tuple | None = None,
        warmup_subsample: int = 1) -> RegistrationResult:
    """Iterative closest point, ``registration_icp`` semantics: a fixed
    number of iterations, optional per-iteration multipliers on the
    correspondence distance (``schedule``), and ``warmup_subsample`` > 1
    running the first 80% of iterations on every S-th source point. The
    final fitness/rmse are evaluated at the base distance on the full set.
    With a leading edge axis E every operand is (E, ...) (``init`` (E, 4,
    4)) and each step solves E point-to-plane systems at once."""
    src_pts = src_pts.to(torch.float32)
    dst_pts = dst_pts.to(torch.float32)
    dev = src_pts.device
    lead = src_pts.shape[:-1]
    if init is None:
        init = torch.eye(4, dtype=torch.float32, device=dev).expand(
            lead[:-1] + (4, 4))
    if src_valid is None:
        src_valid = torch.ones(lead, dtype=torch.bool, device=dev)
    if method == "point_to_plane" and dst_normals is None:
        raise ValueError("point_to_plane ICP needs dst_normals")
    if schedule is None:
        mults = (1.0,) * max_iterations
    else:
        if len(schedule) != max_iterations:
            raise ValueError(f"schedule length {len(schedule)} != "
                             f"max_iterations {max_iterations}")
        mults = tuple(float(m) for m in schedule)
    md2 = max_correspondence_distance ** 2
    table = nn_ops.key_table(dst_pts, dst_valid)   # constant across sweeps
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    zero = torch.zeros((), device=dev)

    def correspondences(T, pts, valid, m2=1.0):
        moved = transform_points(T, pts)
        idx, found, d2 = _nn1(moved, dst_pts, dst_valid, valid, table)
        ok = found & (d2 <= md2 * m2)
        return moved, idx, ok, torch.where(torch.isfinite(d2), d2, zero)

    def step(T, pts, valid, mult):
        moved, idx, ok, _ = correspondences(T, pts, valid, mult * mult)
        w = ok.to(torch.float32)
        q = rows(dst_pts, idx)
        if method == "point_to_point":
            dT = kabsch(moved, q, weights=w, ensure_converged=True)
        else:
            nq = rows(dst_normals, idx)
            r = torch.sum((moved - q) * nq, dim=-1)
            J = torch.cat([torch.linalg.cross(moved, nq, dim=-1), nq], -1)
            Jw = J * w[..., None]
            A = Jw.transpose(-1, -2) @ J
            b = -(Jw.transpose(-1, -2) @ r[..., None])[..., 0]
            x = torch.linalg.solve_ex(A + 1e-9 * eye6, b)[0]
            dT = exp_se3(x[..., :3], x[..., 3:])
        return dT @ T

    T = init.to(torch.float32)
    n_warm = 0
    if warmup_subsample > 1 and max_iterations >= 8:
        n_warm = int(round(0.8 * max_iterations))
        sub_pts = src_pts[..., ::warmup_subsample, :]
        sub_val = src_valid[..., ::warmup_subsample]
        for mult in mults[:n_warm]:
            T = step(T, sub_pts, sub_val, mult)
    for mult in mults[n_warm:]:
        T = step(T, src_pts, src_valid, mult)
    _, idx, ok, d2 = correspondences(T, src_pts, src_valid)
    cnt = ok.sum(-1)
    fitness = cnt.to(torch.float32) / src_valid.sum(-1).clamp_min(1)
    rmse = torch.sqrt(torch.where(ok, d2, zero).sum(-1) / cnt.clamp_min(1))
    return RegistrationResult(T, fitness, rmse)


# ---------------------------------------------------------------------------
# Information matrix (for pose-graph optimization)
# ---------------------------------------------------------------------------


def information_matrix(src_pts: torch.Tensor, dst_pts: torch.Tensor,
                       T: torch.Tensor, max_correspondence_distance: float,
                       src_valid: torch.Tensor | None = None,
                       dst_valid: torch.Tensor | None = None) -> torch.Tensor:
    """6×6 Σ JᵀJ over inlier correspondences
    (``get_information_matrix_from_point_clouds``): J_i = [−[q_i]ₓ | I]
    with q_i the matched TARGET point; (E, 6, 6) with a leading edge
    axis."""
    src_pts = src_pts.to(torch.float32)
    dst_pts = dst_pts.to(torch.float32)
    moved = transform_points(T.to(torch.float32), src_pts)
    idx, found, d2 = _nn1(moved, dst_pts, dst_valid, src_valid)
    ok = found & (d2 <= max_correspondence_distance ** 2)
    q = rows(dst_pts, idx)
    eye = torch.eye(3, dtype=torch.float32, device=q.device)
    J = torch.cat([-skew(q), eye.expand(q.shape[:-1] + (3, 3))], dim=-1)
    w = ok.to(torch.float32)[..., None, None]
    return torch.einsum("...nij,...nik->...jk", J * w, J)
