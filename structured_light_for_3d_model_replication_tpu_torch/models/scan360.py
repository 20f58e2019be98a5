"""The flagship end-to-end workflow: 360° capture stacks → merged cloud
(counterpart of the JAX ``models/scan360.py``, sequential and pose-graph
methods, "loop" ring strategy), and the per-stop halves a streaming session
runs (:func:`decode_stop`, :func:`subsample_stop`, :func:`stop_view_sizes`).

1. decode + triangulate every stop, ``stop_chunk`` stops per call (host
   stacks are staged to the device one chunk at a time);
2. one stratified subsample per stop feeding both the merge view
   (``view_cap`` slots) and the registration view (``max_points``);
3. ring registration — FPFH + feature RANSAC + point-to-plane ICP per edge
   (plus the loop-closure edge 0 → N−1 under ``method="posegraph"``), then
   the turntable-axis prior pass; chained poses, or the pose-graph LM;
4. every stop's merge view transformed by its pose and merged through the
   final voxel → SOR → normals cleanup.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from .._device import div, resolve_device, stage_clock
from ..config import DecodeConfig, TriangulationConfig
from ..ops import pointcloud, posegraph, registration
from ..ops.triangulate import Calibration
from . import merge as merge_mod
from . import pipeline as pipeline_mod

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Scan360Params:
    """End-to-end knobs. ``merge`` carries the registration/cleanup
    settings (``merge.fpfh_engine`` picks the ring preprocess's FPFH
    engine, ``"gather"`` or ``"brick"``); ``view_cap`` bounds each stop's
    contribution to the final merge (slots); ``stop_chunk`` is the number
    of stops decoded per call, which bounds the dense per-pixel
    temporaries on the device."""

    merge: merge_mod.MergeParams = merge_mod.MergeParams()
    method: str = "sequential"
    view_cap: int = 131_072
    stop_chunk: int = 6


def _subsample_views_body(view_cap: int, m_reg: int, pts, cols, vals):
    """ONE stratified pass per stop feeding both consumers: the merge view
    gathers ``view_cap`` slots and the registration view resamples those
    uniformly down to ``m_reg`` (stratified-of-stratified = stratified).
    Inputs are (N, P, ·) per-stop dense clouds."""
    n = pts.shape[0]
    dev = pts.device
    idxs, oks = zip(*(pointcloud.stratified_indices(vals[i], view_cap)
                      for i in range(n)))
    sub_idx = torch.stack(idxs)                            # (N, view_cap)
    sub_val = torch.stack(oks)
    zero = torch.zeros((), device=dev)
    sub_pts = torch.where(sub_val[..., None],
                          torch.gather(pts, 1, sub_idx[..., None].expand(
                              -1, -1, 3)), zero)
    sub_col = torch.where(sub_val[..., None],
                          torch.gather(cols, 1, sub_idx[..., None].expand(
                              -1, -1, 3)).to(torch.float32), zero)
    if view_cap >= m_reg:
        # Uniform resample of the VALID prefix of the gathered slots,
        # strided by each stop's own valid count (float stride like
        # stratified_indices); ≤ m_reg valid points keep identity slots.
        nv = sub_val.to(torch.int32).sum(1)                # (N,)
        j = torch.arange(m_reg, dtype=torch.int32, device=dev)
        stridef = div(nv.to(torch.float32)[:, None], float(m_reg))
        rj = torch.floor(j[None, :].to(torch.float32) * stridef).to(
            torch.int64)
        rj = torch.where(nv[:, None] > m_reg, rj,
                         j[None, :].to(torch.int64).clamp_max(view_cap - 1))
        rj = rj.clamp(0, view_cap - 1)
        reg_pts = torch.gather(sub_pts, 1, rj[..., None].expand(-1, -1, 3))
        reg_val = torch.gather(sub_val, 1, rj)
    else:  # unusual config: merge view smaller than registration view
        outs = [pointcloud.stratified_subsample(pts[i], m_reg, valid=vals[i])
                for i in range(n)]
        reg_pts = torch.stack([o[0] for o in outs])
        reg_val = torch.stack([o[2] for o in outs])
    return sub_pts, sub_col, sub_val, reg_pts, reg_val


def _edge_stats(n: int, fit, rmse) -> dict:
    """Per-edge registration-quality telemetry (edge i maps stop i+1 → i;
    the loop edge 0 → N−1, when present, last)."""
    edges = [{"src": i + 1 if i < n - 1 else 0,
              "dst": i if i < n - 1 else n - 1,
              "fitness": round(float(f), 4), "rmse": round(float(r), 4)}
             for i, (f, r) in enumerate(zip(fit, rmse))]
    fits = [e["fitness"] for e in edges]
    return {"edges": edges,
            "min_fitness": min(fits) if fits else None,
            "mean_fitness": round(float(np.mean(fits)), 4) if fits else None}


def scan_stacks_to_cloud(stacks, calib: Calibration, col_bits: int,
                         row_bits: int,
                         params: Scan360Params = Scan360Params(),
                         decode_cfg: DecodeConfig = DecodeConfig(),
                         tri_cfg: TriangulationConfig = TriangulationConfig(),
                         seed: int = 0, with_stats: bool = False,
                         timing: dict | None = None, device=None):
    """(N, F, H, W) uint8 capture stacks → (merged PointCloud, poses
    (N, 4, 4) np.ndarray).

    ``stacks`` may be a host ``np.ndarray`` (chunks are then staged to the
    device one at a time — a 24-stop 1080p session is 2.3 GB of uint8 that
    never needs to be resident at once) or a tensor. Stops are in turntable
    order. ``seed`` seeds the per-edge RANSAC generators
    (:func:`..models.merge.edge_generator`). ``params.method`` is
    ``"sequential"`` (chained poses) or ``"posegraph"`` (plus the loop edge
    when ``merge.loop_closure``, then the pose-graph LM). ``with_stats``
    appends a dict of per-edge fitness/rmse. ``timing``, when given, receives the
    wall seconds of each stage (``decode_triangulate_s``, ``subsample_s``,
    ``register_s``, ``merge_s``), measured with a device synchronize at
    every stage edge; without it no stage edge synchronizes."""
    if params.method not in ("sequential", "posegraph"):
        raise ValueError(f"method must be 'sequential' or 'posegraph', "
                         f"got {params.method!r}")
    dev = resolve_device(device)
    if calib.Nc.device != dev:
        calib = calib.to(dev)
    n = stacks.shape[0]
    if n < 2:
        raise ValueError(f"need at least 2 stops, got {n}")
    mp = params.merge
    chunk = max(1, min(params.stop_chunk, n))
    clock = stage_clock(dev, timing)
    t0 = clock()

    # 1. Decode + triangulate, one chunk of stops at a time. Only the dense
    # outputs needed downstream (points/colors/valid) are kept.
    pts_p, col_p, val_p = [], [], []
    for s in range(0, n, chunk):
        part = stacks[s:s + chunk]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        r = pipeline_mod.reconstruct_batch(part, calib, col_bits, row_bits,
                                           decode_cfg, tri_cfg, device=dev)
        pts_p.append(r.points)
        col_p.append(r.colors)
        val_p.append(r.valid)
        del r
    pts, cols, vals = torch.cat(pts_p), torch.cat(col_p), torch.cat(val_p)
    del pts_p, col_p, val_p
    t1 = clock()

    # 2. One stratified pass per stop feeds both the registration view and
    # the merge reduce.
    view_cap, m_reg = stop_view_sizes(params, pts.shape[1])
    sub_pts, sub_col, sub_val, reg_pts, reg_val = _subsample_views_body(
        view_cap, m_reg, pts, cols, vals)
    del pts, cols, vals
    t2 = clock()

    # 3. Ring registration → per-stop poses.
    loop = params.method == "posegraph" and mp.loop_closure
    Ts, infos, fit, rmse = merge_mod.register_sequence(
        reg_pts, reg_val, mp, seed=seed, loop_closure=loop)
    if params.method == "posegraph":
        graph = posegraph.build_360_graph(
            Ts[:n - 1], infos[:n - 1], Ts[n - 1] if loop else None,
            infos[n - 1] if loop else None)
        poses = posegraph.optimize(graph, iterations=mp.posegraph_iterations)
    else:
        poses = posegraph.chain_poses(Ts)
    t3 = clock()

    # 4. Merge under the poses: the per-stop subsample is already gathered,
    # so the merge contribution is the pose transform of (N, view_cap, 3).
    moved = registration.transform_points(poses, sub_pts)
    merged = merge_mod._finalize(
        moved.reshape(-1, 3), sub_col.reshape(-1, 3), sub_val.reshape(-1),
        mp, has_colors=True)
    t4 = clock()
    if timing is not None:
        timing.update(decode_triangulate_s=t1 - t0, subsample_s=t2 - t1,
                      register_s=t3 - t2, merge_s=t4 - t3, stops=n,
                      chunk=chunk)
    log.info("scan_stacks_to_cloud: %d stops → %d points (%s)", n,
             len(merged), params.method)
    poses_np = poses.cpu().numpy()
    if with_stats:
        return merged, poses_np, _edge_stats(n, fit, rmse)
    return merged, poses_np


def scan_stream_to_cloud(*args, **kwargs):
    """The JAX package's batch-API wrapper over a streaming session (and its
    gated batch tail); not ported yet."""
    from ..ops.poisson_sparse import _not_ported

    raise _not_ported("scan360.scan_stream_to_cloud",
                      "step 5's remainder (the gated batch tail)")


def _ring_span(labels: list[int], step_deg: float | None) -> int:
    """Total commanded steps of the full ring, for the loop edge's
    wrap-around gap: 360/step when the step is known, else
    ``max(labels) + 1``."""
    if step_deg:
        return max(int(round(360.0 / abs(step_deg))), max(labels) + 1)
    return max(labels) + 1


def decode_stop(stack, calib: Calibration, col_bits: int, row_bits: int,
                decode_cfg: DecodeConfig = DecodeConfig(),
                tri_cfg: TriangulationConfig = TriangulationConfig()):
    """ONE stop decoded and triangulated through the batch path at B = 1,
    on the calibration's device: the per-stop half of a streaming session.
    ``stack`` is (F, H, W) uint8, host array or tensor. Returns ``(points
    (P, 3) float32, colors (P, 3), valid (P,))`` tensors."""
    if stack.ndim != 3:
        raise ValueError(f"stack must be (frames, H, W), got shape "
                         f"{tuple(stack.shape)}")
    part = torch.from_numpy(np.ascontiguousarray(stack[None])) \
        if isinstance(stack, np.ndarray) else stack[None]
    r = pipeline_mod.reconstruct_batch(part, calib, col_bits, row_bits,
                                       decode_cfg, tri_cfg,
                                       device=calib.Nc.device)
    return r.points[0], r.colors[0], r.valid[0]


def subsample_stop(points, colors, valid, view_cap: int, m_reg: int):
    """One stop's merge and registration views through the batch path's
    subsample (a stop axis of 1). ``view_cap``/``m_reg`` come from
    :func:`stop_view_sizes`. Returns ``(sub_pts, sub_col, sub_val, reg_pts,
    reg_val)``."""
    out = _subsample_views_body(view_cap, m_reg, points[None], colors[None],
                                valid[None])
    return tuple(a[0] for a in out)


def stop_view_sizes(params: Scan360Params, n_pixels: int):
    """The (view_cap, m_reg) the batch path derives for ``n_pixels``-pixel
    stops, so streaming sessions subsample identically."""
    m_reg = min(merge_mod._round_up(params.merge.max_points), n_pixels)
    view_cap = merge_mod._round_up(min(params.view_cap, n_pixels))
    return view_cap, m_reg
