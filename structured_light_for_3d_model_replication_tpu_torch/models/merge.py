"""360° sequential chain merge (counterpart of the JAX ``models/merge.py``:
the per-stop preprocess, the ring's edge registration with the
turntable-axis prior, and the final voxel → SOR → normals cleanup).

Reference flow (`server/processing.py:115-181`): for each consecutive pair,
voxel downsample → normals → FPFH → feature RANSAC → point-to-plane ICP;
accumulate the chained transform; finish with voxel downsample +
statistical outlier removal + normal re-estimation.

The JAX package's "loop" ring strategy is the one ported: a Python loop
over stops and edges, each edge seeded with its predecessor's transform,
with the optional loop-closure edge 0 → N−1 last. Each edge's RANSAC draws
come from its own ``torch.Generator`` seeded from (seed, edge index)
(:func:`edge_generator`), so a streaming session that registers the same
edges one stop at a time (:func:`preprocess_registration_view`,
:func:`register_edge`, :func:`axis_prior_pass`) draws the same numbers as
the batch ring. The streams differ from the JAX package's ``jax.random``
keys.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from ..io import ply as ply_io
from ..ops import features, nn, pointcloud, registration
from ..ops.knn import knn
from ..ops.posegraph import log_so3
from ..ops.sor_normals import sor_normals

log = logging.getLogger(__name__)

_PAD = 1024  # pad point counts to a multiple of this


def _round_up(n: int) -> int:
    return ((n + _PAD - 1) // _PAD) * _PAD


@dataclasses.dataclass(frozen=True)
class MergeParams:
    """Knobs mirroring the reference GUI defaults (`server/gui.py:27-83`,
    `server/processing.py:115`); the same fields and defaults as the JAX
    package's ``MergeParams`` for the sequential "gather"-FPFH path."""

    voxel_size: float = 0.02
    ransac_iterations: int = 100_000
    icp_iterations: int = 30
    fpfh_max_nn: int = 100
    normals_k: int = 30
    final_nb_neighbors: int = 20      # final SOR (`server/processing.py:174`)
    final_std_ratio: float = 2.0
    loop_closure: bool = True         # pose-graph method only
    posegraph_iterations: int = 50
    # Turntable-axis pose prior: every ring edge measures the same rigid
    # step, so a robust consensus of the edge screws seeds a second, tight
    # ICP pass that each edge keeps unless it is clearly worse.
    axis_prior: bool = True
    axis_prior_margin: float = 0.02
    # Commanded turntable advance per stop in degrees, when known: only
    # edges whose rotation lands near it vote in the consensus.
    step_deg: float | None = None
    # Per-scan point cap for REGISTRATION (the KNN/FPFH/ICP stages are
    # O(M²)); poses from the subsample are applied to the full clouds.
    max_points: int = 8_192
    # Slot cap for the FINAL cleanup chain after the global voxel downsample.
    final_max_points: int = 1_048_576


def _preprocess(pts, valid, voxel: float, normals_k: int, fpfh_max_nn: int):
    """`preprocess_point_cloud` (`server/processing.py:78-96`): voxel
    downsample, normals, FPFH at 5·voxel. ONE shared KNN sweep feeds both
    normals (first ``normals_k`` columns) and FPFH (all ``fpfh_max_nn``).
    Returns (pts, valid, normals, feat)."""
    dpts, _, dvalid, _ = pointcloud.voxel_downsample(pts, voxel, valid=valid)
    nb = knn(dpts, max(normals_k, fpfh_max_nn), points_valid=dvalid)
    normals, nvalid = pointcloud.estimate_normals(dpts, valid=dvalid,
                                                  k=normals_k, neighbors=nb)
    feat, fvalid = features.fpfh(dpts, normals, 5.0 * voxel, valid=nvalid,
                                 max_nn=fpfh_max_nn, neighbors=nb)
    return dpts, dvalid & nvalid & fvalid, normals, feat


def _anneal(it: int) -> tuple:
    """Coarse-to-fine correspondence radius, geometric 4 → 1 over ICP."""
    return tuple(float(4.0 ** (1.0 - i / max(it - 1, 1))) for i in range(it))


def _register_edge(params: MergeParams, s_pts, s_val, s_feat, d_pts, d_val,
                   d_nrm, d_feat, generator, hint):
    """One ring edge, src onto dst: feature RANSAC → best of {RANSAC, hint,
    identity} by correspondence count at 4·voxel → annealed point-to-plane
    ICP → information matrix. Returns (T, fitness, rmse, info)."""
    v = params.voxel_size
    coarse = registration.ransac_feature_registration(
        s_pts, s_feat, d_pts, d_feat, distance_threshold=1.5 * v,
        src_valid=s_val, dst_valid=d_val,
        num_iterations=params.ransac_iterations, generator=generator)
    eye = torch.eye(4, dtype=torch.float32, device=s_pts.device)
    cands = torch.stack([coarse.transformation, hint, eye])
    table = nn.key_table(d_pts, d_val)

    def count_corr(T):
        moved = registration.transform_points(T, s_pts)
        _, found, d2 = registration._nn1(moved, d_pts, d_val, s_val, table)
        return (found & (d2 <= (4.0 * v) ** 2)).sum()

    counts = torch.stack([count_corr(T) for T in cands])
    init = cands[torch.argmax(counts)]
    fine = registration.icp(
        s_pts, d_pts, max_correspondence_distance=v, init=init,
        dst_normals=d_nrm, src_valid=s_val, dst_valid=d_val,
        max_iterations=params.icp_iterations, method="point_to_plane",
        schedule=_anneal(params.icp_iterations), warmup_subsample=4)
    info = registration.information_matrix(
        s_pts, d_pts, fine.transformation, max_correspondence_distance=v,
        src_valid=s_val, dst_valid=d_val)
    return fine.transformation, fine.fitness, fine.inlier_rmse, info


def edge_generator(seed: int, edge: int, device) -> torch.Generator:
    """The RANSAC generator of ring edge ``edge`` (sequential edges in ring
    order, the loop edge last), seeded from (seed, edge index)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) << 20) + int(edge))
    return g


def _ring_edge_indices(n: int, loop_closure: bool = False):
    """(src, dst) stop indices of the ring's edges: sequential edges
    i+1 → i, then the optional loop edge 0 → N−1."""
    src = tuple(range(1, n)) + ((0,) if loop_closure else ())
    dst = tuple(range(0, n - 1)) + ((n - 1,) if loop_closure else ())
    return src, dst


def _edge_xs(pre, n: int, loop_closure: bool = False):
    """Per-edge registration inputs from per-stop preprocess tuples
    ``(pts, valid, normals, feat)``: the positional layout every edge
    registration unpacks."""
    src_ix, dst_ix = _ring_edge_indices(n, loop_closure)
    return [(pre[s][0], pre[s][1], pre[s][3],
             pre[d][0], pre[d][1], pre[d][2], pre[d][3])
            for s, d in zip(src_ix, dst_ix)]


def _consensus_step(Ts: torch.Tensor, step_deg: float | None) -> torch.Tensor:
    """Robust common per-edge transform of a turntable ring: the median of
    the edge screws (linear-interpolation median, as ``jnp.median``: the
    mean of the two middle values for an even count). With the commanded
    step known only edges whose rotation lands within 35% of it vote."""
    w = log_so3(Ts[:, :3, :3])
    t = Ts[:, :3, 3]
    if step_deg is not None:
        step = abs(float(step_deg)) * math.pi / 180.0
        ang = torch.linalg.norm(w, dim=1)
        trusted = (ang - step).abs() <= 0.35 * step
        trusted = trusted | ~trusted.any()   # none trusted: all vote
        nan = torch.full((), float("nan"), device=Ts.device)
        w_bar = torch.nanquantile(torch.where(trusted[:, None], w, nan), 0.5,
                                  dim=0)
        t_bar = torch.nanquantile(torch.where(trusted[:, None], t, nan), 0.5,
                                  dim=0)
    else:
        w_bar = torch.quantile(w, 0.5, dim=0)
        t_bar = torch.quantile(t, 0.5, dim=0)
    return registration._assemble_rigid(registration.exp_so3(w_bar), t_bar)


def _axis_prior_pass(params: MergeParams, xs, outs):
    """Second ICP sweep seeded with the ring-consensus step; each edge keeps
    the seeded result unless it is clearly worse (see
    ``MergeParams.axis_prior``)."""
    Ts, fit, rmse, infos = outs
    Tp = _consensus_step(Ts, params.step_deg)
    v = params.voxel_size
    re = []
    for s_pts, s_val, _sf, d_pts, d_val, d_nrm, _df in xs:
        # Tight constant radius, no annealing, few iterations: the prior is
        # already near the answer.
        fine = registration.icp(
            s_pts, d_pts, max_correspondence_distance=v, init=Tp,
            dst_normals=d_nrm, src_valid=s_val, dst_valid=d_val,
            max_iterations=min(params.icp_iterations, 6),
            method="point_to_plane")
        info2 = registration.information_matrix(
            s_pts, d_pts, fine.transformation,
            max_correspondence_distance=v, src_valid=s_val, dst_valid=d_val)
        re.append((fine.transformation, fine.fitness, fine.inlier_rmse,
                   info2))
    T2, fit2, rmse2, info2 = (torch.stack(c) for c in zip(*re))
    # Edges whose free result disagrees with the consensus are the suspected
    # slides: with the commanded step known they adopt the seeded result
    # under a 10× wider fitness margin.
    w_free = log_so3(Ts[:, :3, :3])
    w_p = log_so3(Tp[:3, :3])
    disagree = torch.linalg.norm(w_free - w_p[None], dim=1) \
        > 0.5 * torch.linalg.norm(w_p).clamp_min(1e-3)
    wide = 10.0 if params.step_deg is not None else 1.0
    margin = torch.where(disagree,
                         torch.full((), wide * params.axis_prior_margin,
                                    device=Ts.device),
                         torch.full((), params.axis_prior_margin,
                                    device=Ts.device))
    use2 = fit2 >= fit - margin
    return (torch.where(use2[:, None, None], T2, Ts),
            torch.where(use2, fit2, fit),
            torch.where(use2, rmse2, rmse),
            torch.where(use2[:, None, None], info2, infos))


def preprocess_registration_view(points, valid, params: MergeParams):
    """One stop's registration preprocess (voxel → normals → FPFH), the
    per-stop half of an incremental ring. Returns the ``(pts, valid,
    normals, feat)`` tuple :func:`register_edge` consumes."""
    return _preprocess(points, valid, params.voxel_size, params.normals_k,
                       params.fpfh_max_nn)


def register_edge(src_prep, dst_prep, params: MergeParams,
                  generator: torch.Generator, hint=None):
    """One ring edge, src registered onto dst, from two
    :func:`preprocess_registration_view` tuples: the per-edge half of an
    incremental ring. ``hint`` (the previous edge's transform) joins the
    candidate set. Returns ``(T, fitness, rmse, info)`` device tensors."""
    s_pts, s_val, _, s_feat = src_prep
    d_pts, d_val, d_nrm, d_feat = dst_prep
    if hint is None:
        hint = torch.eye(4, dtype=torch.float32, device=s_pts.device)
    return _register_edge(params, s_pts, s_val, s_feat, d_pts, d_val, d_nrm,
                          d_feat, generator, hint)


def axis_prior_pass(preps, outs, params: MergeParams,
                    loop_closure: bool = False):
    """The turntable-axis re-pass over a registered ring, from its retained
    per-stop preprocesses (``outs`` = stacked (Ts, fit, rmse, infos) in
    ring order, the loop edge last)."""
    return _axis_prior_pass(params, _edge_xs(preps, len(preps),
                                             loop_closure), outs)


def register_sequence(points: torch.Tensor, valid: torch.Tensor,
                      params: MergeParams, seed: int = 0,
                      loop_closure: bool = False):
    """Edge transforms for the ring: edge i maps scan i+1 into scan i's
    frame; the optional loop edge (last) maps scan 0 into scan N−1's frame.
    ``points`` is the (N, M, 3) registration stack with its (N, M) valid
    mask; edge e draws from :func:`edge_generator` ``(seed, e)``. Returns
    (Ts (E, 4, 4), infos (E, 6, 6), fitness list, rmse list)."""
    n = points.shape[0]
    pre = [preprocess_registration_view(points[i], valid[i], params)
           for i in range(n)]
    hint = None
    outs = []
    for e, (s, d) in enumerate(zip(*_ring_edge_indices(n, loop_closure))):
        out = register_edge(pre[s], pre[d], params,
                            edge_generator(seed, e, points.device), hint)
        outs.append(out)
        if e < n - 1:
            hint = out[0]
    Ts, fit, rmse, infos = (torch.stack(c) for c in zip(*outs))
    if params.axis_prior and len(outs) >= 3:
        Ts, fit, rmse, infos = axis_prior_pass(pre, (Ts, fit, rmse, infos),
                                               params, loop_closure)
    fit_np = fit.cpu().numpy()
    rmse_np = rmse.cpu().numpy()
    for i in range(1, n):
        log.info("edge %d→%d fitness=%.3f rmse=%.4f", i, i - 1,
                 fit_np[i - 1], rmse_np[i - 1])
    if loop_closure:
        log.info("loop edge 0→%d fitness=%.3f", n - 1, fit_np[n - 1])
    return Ts, infos, list(fit_np), list(rmse_np)


# ---------------------------------------------------------------------------
# Final cleanup
# ---------------------------------------------------------------------------


def _finalize_body(params: MergeParams, cap: int, points, colors, valid):
    """The final-cleanup math: voxel downsample → (stratified decimation to
    ``cap`` slots) → SOR + normals, fused in Morton space at ≥ 131072 slots.
    Returns (points, colors, normals, keep) as dense device tensors."""
    dpts, dcol, dvalid, _ = pointcloud.voxel_downsample(
        points, params.voxel_size, valid=valid, attrs=colors)
    if dpts.shape[0] > cap:
        dpts, dcol, dvalid = pointcloud.stratified_subsample(
            dpts, cap, valid=dvalid, attrs=dcol)
    if dpts.shape[0] >= pointcloud.APPROX_KNN_THRESHOLD:
        _, normals, nvalid = sor_normals(
            dpts, valid=dvalid, nb_neighbors=params.final_nb_neighbors,
            std_ratio=params.final_std_ratio, k_normals=params.normals_k)
        return dpts, dcol, normals, nvalid
    keep = pointcloud.statistical_outlier_removal(
        dpts, valid=dvalid, nb_neighbors=params.final_nb_neighbors,
        std_ratio=params.final_std_ratio)
    normals, nvalid = pointcloud.estimate_normals(dpts, valid=keep,
                                                  k=params.normals_k)
    return dpts, dcol, normals, keep & nvalid


def _finalize(points, colors, valid, params: MergeParams,
              has_colors: bool = True) -> ply_io.PointCloud:
    """Final cleanup chain (`server/processing.py:171-181`) → compact host
    cloud."""
    cap = _round_up(params.final_max_points)
    dpts, dcol, normals, keep = _finalize_body(params, cap, points, colors,
                                               valid)
    keep_np = keep.cpu().numpy()
    colors_u8 = None
    if has_colors:
        colors_u8 = np.clip(dcol.cpu().numpy()[keep_np], 0, 255).astype(
            np.uint8)
    return ply_io.PointCloud(points=dpts.cpu().numpy()[keep_np],
                             colors=colors_u8,
                             normals=normals.cpu().numpy()[keep_np])
