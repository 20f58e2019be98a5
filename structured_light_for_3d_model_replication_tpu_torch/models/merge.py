"""360° merge workflows (counterpart of the JAX ``models/merge.py``): the
per-stop preprocess, the ring's edge registration with the turntable-axis
prior, the final voxel → SOR → normals cleanup, the file-level ring merges
(:func:`merge_pro_360`, :func:`merge_posegraph_360`,
:func:`merge_360_files`), pairwise registration and the cleanup workflows
(:func:`remove_background`, :func:`remove_outliers`).

Reference flow (`server/processing.py:115-181`): for each consecutive pair,
voxel downsample → normals → FPFH → feature RANSAC → point-to-plane ICP;
accumulate the chained transform; finish with voxel downsample +
statistical outlier removal + normal re-estimation.

Both of the JAX package's ring strategies are ported
(:func:`register_sequence`). ``"loop"``: a Python loop over stops and edges,
each edge seeded with its predecessor's transform, with the optional
loop-closure edge 0 → N−1 last. ``"scan"`` (:func:`_ring_body`, the ring of
the JAX package's fused program): every edge starts from identity and all
edges run as one batch, each step one launch for the whole ring, the
turntable-axis pass batched the same way. Each edge's RANSAC draws come
from its own ``torch.Generator`` seeded from (seed, edge index)
(:func:`edge_generator`) in either strategy, so a streaming session that
registers the same edges one stop at a time
(:func:`preprocess_registration_view`, :func:`register_edge`,
:func:`axis_prior_pass`) draws the same numbers as the batch ring. The
streams differ from the JAX package's ``jax.random`` keys. The public entry
points take ``device=None``, which means the card.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from .. import health as health_mod
from .._device import resolve_device
from ..io import ply as ply_io
from ..io.layout import list_clouds
from ..ops import (
    features,
    features_brick,
    nn,
    pointcloud,
    posegraph,
    registration,
    segmentation,
)
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
    # FPFH engine of the per-view preprocess: "gather" (neighbour lists of
    # the shared KNN sweep, ops/features.py) or "brick" (the sorted brick
    # layout, ops/features_brick.py; the shared KNN shrinks to
    # ``normals_k`` and every in-radius pair is histogrammed).
    fpfh_engine: str = "gather"
    # The brick engine's per-cell candidate slots and occupied-cell budget;
    # past them it thins candidates (logged), so raise these when it warns.
    fpfh_slots: int = 48
    fpfh_max_cells: int = 1024
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


def _preprocess(pts, valid, voxel: float, normals_k: int, fpfh_max_nn: int,
                fpfh_engine: str = "gather", fpfh_slots: int = 48,
                fpfh_max_cells: int = 1024, cells_only: bool = False):
    """`preprocess_point_cloud` (`server/processing.py:78-96`): voxel
    downsample, normals, FPFH at 5·voxel. "gather": ONE shared KNN sweep
    feeds both normals (first ``normals_k`` columns) and FPFH (all
    ``fpfh_max_nn``). "brick": a ``normals_k`` sweep for the normals and
    the brick-layout FPFH, whose candidate thinning is logged. With
    ``cells_only`` the KNN sweeps only the downsampled cells, the leading
    slots (one host read of their count; ``knn``'s ``live``): the same
    result as the sweep over every slot, for a full-resolution cloud whose
    cells are a small share of its slots. Returns (pts, valid, normals,
    feat)."""
    if fpfh_engine not in ("gather", "brick"):
        raise ValueError(f"unknown fpfh_engine {fpfh_engine!r}")
    dpts, _, dvalid, n_cells = pointcloud.voxel_downsample(pts, voxel,
                                                           valid=valid)
    live = (int(n_cells),) * 2 if cells_only else None
    if fpfh_engine == "brick":
        nb = knn(dpts, normals_k, points_valid=dvalid, live=live)
        normals, nvalid = pointcloud.estimate_normals(
            dpts, valid=dvalid, k=normals_k, neighbors=nb)
        feat, fvalid, n_overflow = features_brick.fpfh_brick(
            dpts, normals, 5.0 * voxel, valid=nvalid, slots=fpfh_slots,
            max_cells=fpfh_max_cells)
        features_brick.emit_overflow_warning(n_overflow, nvalid.sum())
        return dpts, dvalid & nvalid & fvalid, normals, feat
    nb = knn(dpts, max(normals_k, fpfh_max_nn), points_valid=dvalid,
             live=live)
    normals, nvalid = pointcloud.estimate_normals(dpts, valid=dvalid,
                                                  k=normals_k, neighbors=nb)
    feat, fvalid = features.fpfh(dpts, normals, 5.0 * voxel, valid=nvalid,
                                 max_nn=fpfh_max_nn, neighbors=nb)
    return dpts, dvalid & nvalid & fvalid, normals, feat


def _anneal(it: int) -> tuple:
    """Coarse-to-fine correspondence radius, geometric 4 → 1 over ICP."""
    return tuple(float(4.0 ** (1.0 - i / max(it - 1, 1))) for i in range(it))


def _register_edge(params: MergeParams, s_pts, s_val, s_feat, d_pts, d_val,
                   d_nrm, d_feat, generator, hint, live=None):
    """One ring edge, src onto dst: feature RANSAC → best of {RANSAC, hint,
    identity} by correspondence count at 4·voxel → annealed point-to-plane
    ICP → information matrix. Returns (T, fitness, rmse, info). With a
    leading edge axis E (every operand (E, ...), ``hint`` (E, 4, 4),
    ``generator`` one a edge) the E edges run as one batch. ``live`` (src,
    dst) bounds the feature matching's sweep (``match_features``)."""
    v = params.voxel_size
    coarse = registration.ransac_feature_registration(
        s_pts, s_feat, d_pts, d_feat, distance_threshold=1.5 * v,
        src_valid=s_val, dst_valid=d_val,
        num_iterations=params.ransac_iterations, generator=generator,
        live=live)
    eye = torch.eye(4, dtype=torch.float32, device=s_pts.device).expand(
        hint.shape)
    cands = torch.stack([coarse.transformation, hint, eye])
    table = nn.key_table(d_pts, d_val)

    def count_corr(T):
        moved = registration.transform_points(T, s_pts)
        _, found, d2 = registration._nn1(moved, d_pts, d_val, s_val, table)
        return (found & (d2 <= (4.0 * v) ** 2)).sum(-1)

    counts = torch.stack([count_corr(T) for T in cands])
    pick = torch.argmax(counts, dim=0)[None, ..., None, None]
    init = torch.take_along_dim(cands, pick, dim=0)[0]
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


def _stack_xs(xs):
    """:func:`_edge_xs`'s per-edge tuples stacked along a leading edge
    axis: the batched ring's operands."""
    return tuple(torch.stack(c) for c in zip(*xs))


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
    """Second ICP sweep seeded with the ring-consensus step, all edges as
    one batch (``xs``: :func:`_stack_xs`'s (E, ...) operands); each edge
    keeps the seeded result unless it is clearly worse (see
    ``MergeParams.axis_prior``)."""
    Ts, fit, rmse, infos = outs
    Tp = _consensus_step(Ts, params.step_deg)
    s_pts, s_val, _sf, d_pts, d_val, d_nrm, _df = xs
    v = params.voxel_size
    # Tight constant radius, no annealing, few iterations: the prior is
    # already near the answer.
    fine = registration.icp(
        s_pts, d_pts, max_correspondence_distance=v,
        init=Tp.expand(Ts.shape), dst_normals=d_nrm, src_valid=s_val,
        dst_valid=d_val, max_iterations=min(params.icp_iterations, 6),
        method="point_to_plane")
    T2, fit2, rmse2 = fine
    info2 = registration.information_matrix(
        s_pts, d_pts, T2, max_correspondence_distance=v, src_valid=s_val,
        dst_valid=d_val)
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


def preprocess_registration_view(points, valid, params: MergeParams,
                                 cells_only: bool = False):
    """One stop's registration preprocess (voxel → normals → FPFH), the
    per-stop half of an incremental ring (``cells_only``: see
    :func:`_preprocess`). Returns the ``(pts, valid, normals, feat)``
    tuple :func:`register_edge` consumes."""
    return _preprocess(points, valid, params.voxel_size, params.normals_k,
                       params.fpfh_max_nn, params.fpfh_engine,
                       params.fpfh_slots, params.fpfh_max_cells, cells_only)


def register_edge(src_prep, dst_prep, params: MergeParams,
                  generator: torch.Generator, hint=None, live=None):
    """One ring edge, src registered onto dst, from two
    :func:`preprocess_registration_view` tuples: the per-edge half of an
    incremental ring. ``hint`` (the previous edge's transform) joins the
    candidate set; ``live`` (src, dst) bounds the feature matching's sweep
    to the leading slots that hold each view's valid points. Returns
    ``(T, fitness, rmse, info)`` device tensors."""
    s_pts, s_val, _, s_feat = src_prep
    d_pts, d_val, d_nrm, d_feat = dst_prep
    if hint is None:
        hint = torch.eye(4, dtype=torch.float32, device=s_pts.device)
    return _register_edge(params, s_pts, s_val, s_feat, d_pts, d_val, d_nrm,
                          d_feat, generator, hint, live)


def register_chain(pre, pairs, params: MergeParams, seed: int = 0):
    """Edges registered in turn, src onto dst for each (src, dst) of
    ``pairs`` (indices into the per-stop preprocesses ``pre``), each seeded
    with its predecessor's transform and edge k drawing from
    :func:`edge_generator` ``(seed, k)``: the loop strategy's ring, and the
    quality-gated ring over the surviving stops. Returns stacked (Ts
    (E, 4, 4), fit (E,), rmse (E,), infos (E, 6, 6)) device tensors."""
    hint = None
    outs = []
    for k, (s, d) in enumerate(pairs):
        out = register_edge(pre[s], pre[d], params,
                            edge_generator(seed, k, pre[s][0].device), hint)
        outs.append(out)
        hint = out[0]
    return tuple(torch.stack(c) for c in zip(*outs))


def axis_prior_pass(preps, outs, params: MergeParams,
                    loop_closure: bool = False):
    """The turntable-axis re-pass over a registered ring, from its retained
    per-stop preprocesses (``outs`` = stacked (Ts, fit, rmse, infos) in
    ring order, the loop edge last)."""
    return _axis_prior_pass(params, _stack_xs(_edge_xs(
        preps, len(preps), loop_closure)), outs)


def _ring_body(params: MergeParams, n: int, loop_closure: bool, points,
               valid, seed: int = 0):
    """The ring of the JAX package's fused program (its ``_ring_body``):
    the N per-stop preprocesses, then every edge at once from identity —
    one batch, so each RANSAC hypothesis batch, candidate count, ICP step
    and information matrix is one step for the whole ring (and one
    ``nearest_one`` launch where it sweeps) — and the axis-prior pass
    batched over the same edges, which takes the role of the loop
    strategy's hint chain. Edge e draws from :func:`edge_generator`
    ``(seed, e)``, as in the loop. Returns stacked (Ts (E, 4, 4), fit (E,),
    rmse (E,), infos (E, 6, 6)) device tensors."""
    pre = [preprocess_registration_view(points[i], valid[i], params)
           for i in range(n)]
    xs = _stack_xs(_edge_xs(pre, n, loop_closure))
    e = xs[0].shape[0]
    eye = torch.eye(4, dtype=torch.float32, device=points.device)
    outs = _register_edge(params, *xs,
                          [edge_generator(seed, k, points.device)
                           for k in range(e)], eye.expand(e, 4, 4))
    if params.axis_prior and e >= 3:
        outs = _axis_prior_pass(params, xs, outs)
    return outs


def register_sequence(points: torch.Tensor, valid: torch.Tensor,
                      params: MergeParams, seed: int = 0,
                      loop_closure: bool = False, strategy: str = "loop"):
    """Edge transforms for the ring: edge i maps scan i+1 into scan i's
    frame; the optional loop edge (last) maps scan 0 into scan N−1's frame.
    ``points`` is the (N, M, 3) registration stack with its (N, M) valid
    mask; edge e draws from :func:`edge_generator` ``(seed, e)``.
    ``strategy`` is ``"loop"`` (edges in turn, each seeded with its
    predecessor's transform) or ``"scan"`` (:func:`_ring_body`, all edges
    as one batch from identity: another program, as in the JAX package).
    Returns (Ts (E, 4, 4), infos (E, 6, 6), fitness list, rmse list)."""
    n = points.shape[0]
    if strategy == "scan":
        Ts, fit, rmse, infos = _ring_body(params, n, loop_closure, points,
                                          valid, seed)
    elif strategy == "loop":
        pre = [preprocess_registration_view(points[i], valid[i], params)
               for i in range(n)]
        Ts, fit, rmse, infos = register_chain(
            pre, list(zip(*_ring_edge_indices(n, loop_closure))), params,
            seed)
        if params.axis_prior and Ts.shape[0] >= 3:
            Ts, fit, rmse, infos = axis_prior_pass(
                pre, (Ts, fit, rmse, infos), params, loop_closure)
    else:
        raise ValueError(f"unknown ring strategy {strategy!r}")
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


# ---------------------------------------------------------------------------
# File-level ring merges (`server/processing.py:115-181`, `Old/360Merge.py`)
# ---------------------------------------------------------------------------


class _Padded:
    """N clouds stacked to one (N, M, 3) tensor + valid masks (+ colours) on
    ``device``, and a registration view capped at ``max_points`` per scan
    (a deterministic uniform subsample, numpy seed 0, stands in for a
    larger cloud — the JAX package's selection)."""

    def __init__(self, clouds, max_points: int | None, device):
        if len(clouds) < 2:
            raise ValueError("need at least two clouds to merge")
        m = _round_up(max(len(c.points) for c in clouds))
        n = len(clouds)
        pts = np.zeros((n, m, 3), np.float32)
        val = np.zeros((n, m), bool)
        col = np.zeros((n, m, 3), np.float32)
        self.has_colors = any(c.colors is not None for c in clouds)
        for i, c in enumerate(clouds):
            k = len(c.points)
            pts[i, :k] = c.points
            val[i, :k] = True
            if c.colors is not None:
                col[i, :k] = c.colors
        self.points = torch.from_numpy(pts).to(device)
        self.valid = torch.from_numpy(val).to(device)
        self.colors = torch.from_numpy(col).to(device)
        self.reg_points, self.reg_valid = self.points, self.valid
        if max_points is not None and m > _round_up(max_points):
            mr = _round_up(max_points)
            rpts = np.zeros((n, mr, 3), np.float32)
            rval = np.zeros((n, mr), bool)
            rng = np.random.default_rng(0)
            for i, c in enumerate(clouds):
                k = len(c.points)
                if k > mr:
                    rpts[i] = c.points[rng.choice(k, mr, replace=False)]
                    rval[i] = True
                else:
                    rpts[i, :k] = c.points
                    rval[i, :k] = True
            self.reg_points = torch.from_numpy(rpts).to(device)
            self.reg_valid = torch.from_numpy(rval).to(device)


def _apply_poses_and_merge(padded: _Padded, poses, params: MergeParams):
    """Every scan under its pose, concatenated (still padded), through the
    final cleanup."""
    moved = registration.transform_points(poses.to(torch.float32),
                                          padded.points)
    return _finalize(moved.reshape(-1, 3), padded.colors.reshape(-1, 3),
                     padded.valid.reshape(-1), params,
                     has_colors=padded.has_colors)


def _gate_ring_edges(n: int, Ts, infos, fit, rmse, loop: bool,
                     gates: health_mod.QualityGates, params: MergeParams,
                     health: health_mod.ScanHealthReport | None):
    """The ring's edges verdicted against ``gates``: rejects replaced by the
    ring-consensus step and down-weighted for the pose graph
    (:func:`..health.gate_edges`). Host arrays in, host arrays out."""
    edges = health_mod.ring_edges(range(n), loop)
    Ts2, infos2, _ = health_mod.gate_edges(
        edges, np.asarray(Ts), np.asarray(fit), np.asarray(rmse),
        np.asarray(infos), gates, step_deg=params.step_deg, report=health)
    return Ts2, infos2


def merge_pro_360(clouds, params: MergeParams | None = None, seed: int = 0,
                  gates: health_mod.QualityGates | None = None,
                  health: health_mod.ScanHealthReport | None = None,
                  device=None):
    """Sequential chain merge — `ProcessingLogic.merge_pro_360`
    (`server/processing.py:115-181`): scan i registers onto scan i−1, poses
    chain, no loop closure. With ``gates``, failing edges are replaced by
    the ring-consensus step before chaining. ``seed`` seeds the per-edge
    RANSAC generators. Returns (merged PointCloud, poses (N, 4, 4))."""
    params = params or MergeParams()
    dev = resolve_device(device)
    padded = _Padded(clouds, params.max_points, dev)
    Ts, infos, fit, rmse = register_sequence(
        padded.reg_points, padded.reg_valid, params, seed=seed)
    if gates is not None:
        Ts2, _ = _gate_ring_edges(len(clouds), Ts.cpu().numpy(),
                                  infos.cpu().numpy(), fit, rmse, False,
                                  gates, params, health)
        Ts = torch.from_numpy(Ts2).to(dev)
    poses = posegraph.chain_poses(Ts)
    merged = _apply_poses_and_merge(padded, poses, params)
    log.info("merge_pro_360: %d scans → %d points", len(clouds), len(merged))
    return merged, poses.cpu().numpy()


def merge_posegraph_360(clouds, params: MergeParams | None = None,
                        seed: int = 0,
                        gates: health_mod.QualityGates | None = None,
                        health: health_mod.ScanHealthReport | None = None,
                        device=None):
    """Pose-graph merge with loop closure (`Old/360Merge.py:43-84`): edge
    transforms and information matrices → Levenberg-Marquardt → merge under
    the optimized poses. With ``gates``, failing edges keep the graph
    connected but barely vote and take the ring-consensus step. Returns
    (merged PointCloud, poses (N, 4, 4))."""
    params = params or MergeParams()
    dev = resolve_device(device)
    n = len(clouds)
    padded = _Padded(clouds, params.max_points, dev)
    loop = params.loop_closure
    Ts, infos, fit, rmse = register_sequence(
        padded.reg_points, padded.reg_valid, params, seed=seed,
        loop_closure=loop)
    if gates is not None:
        Ts2, infos2 = _gate_ring_edges(n, Ts.cpu().numpy(),
                                       infos.cpu().numpy(), fit, rmse, loop,
                                       gates, params, health)
        Ts = torch.from_numpy(Ts2).to(dev)
        infos = torch.from_numpy(infos2).to(dev)
    graph = posegraph.build_360_graph(
        Ts[:n - 1], infos[:n - 1], Ts[n - 1] if loop else None,
        infos[n - 1] if loop else None)
    poses = posegraph.optimize(graph, iterations=params.posegraph_iterations)
    merged = _apply_poses_and_merge(padded, poses, params)
    log.info("merge_posegraph_360: %d scans → %d points", n, len(merged))
    return merged, poses.cpu().numpy()


def merge_360_files(folder: str, output_path: str,
                    params: MergeParams | None = None,
                    method: str = "posegraph", seed: int = 0,
                    gates: health_mod.QualityGates | None = None,
                    health: health_mod.ScanHealthReport | None = None,
                    device=None):
    """File-level entry of the GUI action (`server/gui.py:622-641`): read
    every ``*.ply`` in ``folder`` (numeric order), merge, write the result.
    Returns the merged cloud."""
    if method not in ("posegraph", "sequential"):
        raise ValueError(f"method must be 'posegraph' or 'sequential', "
                         f"got {method!r}")
    dev = resolve_device(device)
    paths = list_clouds(folder)
    if len(paths) < 2:
        raise ValueError(f"need ≥2 .ply files in {folder}, found {len(paths)}")
    clouds = [ply_io.read_ply(p) for p in paths]
    fn = merge_posegraph_360 if method == "posegraph" else merge_pro_360
    merged, _ = fn(clouds, params, seed=seed, gates=gates, health=health,
                   device=dev)
    ply_io.write_ply(output_path, merged)
    return merged


# ---------------------------------------------------------------------------
# Pairwise registration and the cleanup workflows
# (`Old/New360.py:37-79`, `server/processing.py:24-76`)
# ---------------------------------------------------------------------------


def register_pair(src_pts, src_valid, dst_pts, dst_valid,
                  params: MergeParams,
                  generator: torch.Generator | None = None):
    """RANSAC-seeded point-to-plane ICP of src onto dst, the inner step of
    `merge_pro_360` (`server/processing.py:146-156`), on full-resolution
    padded clouds (downsampled inside). The KNN and feature sweeps cover
    only the downsampled cells (``cells_only``), the same result as over
    every slot. Returns (RegistrationResult, 6×6 information matrix)."""
    if generator is None:
        generator = torch.Generator(device=src_pts.device)
        generator.manual_seed(0)
    src = preprocess_registration_view(src_pts, src_valid, params,
                                       cells_only=True)
    dst = preprocess_registration_view(dst_pts, dst_valid, params,
                                       cells_only=True)
    T, fit, rmse, info = register_edge(src, dst, params, generator,
                                       live=(_live(src[1]), _live(dst[1])))
    return registration.RegistrationResult(T, fit, rmse), info


def register_pair_clouds(src: ply_io.PointCloud, dst: ply_io.PointCloud,
                         params: MergeParams | None = None, seed: int = 0,
                         device=None):
    """Two-cloud RANSAC + ICP alignment (the reference's pairwise demo,
    `Old/New360.py:37-79`). Returns (RegistrationResult, 6×6
    information matrix)."""
    dev = resolve_device(device)
    if params is None:
        params = MergeParams(voxel_size=_auto_voxel(src.points))
    s_pts, s_val = _pad_cloud(src.points, dev)
    d_pts, d_val = _pad_cloud(dst.points, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return register_pair(s_pts, s_val, d_pts, d_val, params, generator=g)


def _live(valid: torch.Tensor) -> int:
    """The count of leading slots that holds every valid one."""
    idx = torch.nonzero(valid)
    return int(idx[-1, 0]) + 1 if len(idx) else 1


def _auto_voxel(points: np.ndarray) -> float:
    """~1/60 of the bounding-box diagonal, for parameterless entry points."""
    pts = np.asarray(points, np.float64)
    if pts.shape[0] == 0:
        return 1.0
    diag = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    return max(diag / 60.0, 1e-6)


def _pad_cloud(points: np.ndarray, device):
    """(N, 3) host points → (M, 3) device tensor padded to a multiple of
    1024, and its (M,) valid mask."""
    n = len(points)
    m = _round_up(n)
    pts = torch.zeros((m, 3), dtype=torch.float32, device=device)
    pts[:n] = torch.as_tensor(np.asarray(points, np.float32), device=device)
    return pts, torch.arange(m, device=device) < n


def _select(cloud: ply_io.PointCloud, keep: np.ndarray) -> ply_io.PointCloud:
    return ply_io.PointCloud(
        points=cloud.points[keep],
        colors=None if cloud.colors is None else cloud.colors[keep],
        normals=None if cloud.normals is None else cloud.normals[keep])


def remove_background(cloud: ply_io.PointCloud,
                      distance_threshold: float = 10.0,
                      num_iterations: int = 1000, seed: int = 0,
                      stats: dict | None = None,
                      device=None) -> ply_io.PointCloud:
    """Drop the dominant RANSAC plane (the wall or table behind the object)
    — `ProcessingLogic.remove_background` (`server/processing.py:24-52`).
    ``seed`` seeds the hypothesis generator; ``stats``, when given,
    receives the ``plane`` [a, b, c, d] and the ``inliers`` count."""
    dev = resolve_device(device)
    pts_p, val_p = _pad_cloud(cloud.points, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    plane, inliers = segmentation.segment_plane(
        pts_p, distance_threshold=distance_threshold,
        num_iterations=num_iterations, valid=val_p, generator=g)
    keep = (val_p & ~inliers).cpu().numpy()[: len(cloud.points)]
    if stats is not None:
        stats.update(plane=plane.cpu().numpy(),
                     inliers=int((inliers & val_p).sum()))
    log.info("remove_background: %d → %d points", len(cloud.points),
             int(keep.sum()))
    return _select(cloud, keep)


def remove_outliers(cloud: ply_io.PointCloud, nb_neighbors: int = 20,
                    std_ratio: float = 2.0, device=None) -> ply_io.PointCloud:
    """Statistical outlier removal — `ProcessingLogic.remove_outliers`
    (`server/processing.py:54-76`); on the card at ≥ 131,072 points its
    KNN sweep takes the brick kernel."""
    dev = resolve_device(device)
    pts_p, val_p = _pad_cloud(cloud.points, dev)
    keep = pointcloud.statistical_outlier_removal(
        pts_p, valid=val_p, nb_neighbors=nb_neighbors, std_ratio=std_ratio)
    keep = keep.cpu().numpy()[: len(cloud.points)]
    log.info("remove_outliers: %d → %d points", len(cloud.points),
             int(keep.sum()))
    return _select(cloud, keep)
