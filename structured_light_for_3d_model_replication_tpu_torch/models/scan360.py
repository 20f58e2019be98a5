"""The flagship end-to-end workflow: 360° capture stacks → merged cloud
(counterpart of the JAX ``models/scan360.py``), and the per-stop halves a
streaming session runs (:func:`decode_stop`, :func:`subsample_stop`,
:func:`stop_view_sizes`).

1. decode + triangulate every stop, ``stop_chunk`` stops per call (host
   stacks are staged to the device one chunk at a time through one pinned
   buffer; a ragged last chunk is padded by repeating the last stop);
2. one stratified subsample per stop feeding both the merge view
   (``view_cap`` slots) and the registration view (``max_points``);
3. ring registration — FPFH + feature RANSAC + point-to-plane ICP per edge
   (plus the loop-closure edge 0 → N−1 under ``method="posegraph"``), then
   the turntable-axis prior pass; chained poses, or the pose-graph LM;
4. every stop's merge view transformed by its pose and merged through the
   final voxel → SOR → normals cleanup.

Three forms, as in the JAX package. The multi-launch path runs the stages
in turn, the ring in the ``ring_strategy`` of ``Scan360Params``.
``fused=True`` on device-resident stacks runs :func:`_tail_body` after the
decode and reads the compacted result (``output_cap``) back in one copy:
the JAX package's one-program form, whose ring is the batched one (``merge._ring_body``: every edge from identity, each step
one launch for the whole ring). :func:`scan_stream_to_cloud` decodes
chunks as the stops arrive and then runs the same :func:`_tail_body`, so
the two give the same cloud. ``gates`` selects the quality-gated tail
(:func:`_gated_tail`): stops below the coverage gate are dropped and
bridged, failing edges repaired. :func:`scan_folders_to_cloud` is the
file-level entry: stop folders and a ``.mat`` calibration in, the merged
cloud out (and to a PLY).
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from .. import health as health_mod
from .._device import div, resolve_device, stage_clock
from ..config import DecodeConfig, TriangulationConfig
from ..io import ply as ply_io
from ..ops import pointcloud, posegraph, registration
from ..ops.triangulate import Calibration
from . import merge as merge_mod
from . import pipeline as pipeline_mod

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Scan360Params:
    """End-to-end knobs, the JAX package's fields and defaults. ``merge``
    carries the registration/cleanup settings (``merge.fpfh_engine`` picks
    the ring preprocess's FPFH engine, ``"gather"`` or ``"brick"``);
    ``method`` is ``"sequential"`` or ``"posegraph"``; ``ring_strategy``
    ``"loop"`` (edges in turn, each seeded with its predecessor) or
    ``"scan"`` (the batched ring, every edge from identity: what the
    fused form runs, here also for host-array stacks and the gated tail);
    ``view_cap`` bounds each stop's contribution to the final merge
    (slots); ``fused=True`` runs the one-readback form on device-resident
    stacks (host arrays take the multi-launch path); ``stop_chunk`` is the
    number of stops decoded per call, which bounds the dense per-pixel
    temporaries on the device; ``output_cap`` compacts the fused and
    streamed outputs to that many slots (a stratified subset, with a
    warning, when more survive); ``gates`` (a
    :class:`..health.QualityGates`) selects the quality-gated tail of the
    multi-launch path.

    ``decode_strategy`` and ``reduce_chunk`` keep the JAX package's fields
    for its callers, and only their defaults: the port has one decode
    schedule (chunks back to back, no host sync between them) and no
    chunked reduce, so any other value raises ``ValueError`` rather than
    being ignored."""

    merge: merge_mod.MergeParams = merge_mod.MergeParams()
    method: str = "sequential"
    ring_strategy: str = "loop"
    decode_strategy: str = "loop"
    view_cap: int = 131_072
    fused: bool = False
    stop_chunk: int = 6
    reduce_chunk: int = 6
    output_cap: int | None = None
    gates: health_mod.QualityGates | None = None


def _check_jax_only_knobs(params: Scan360Params) -> None:
    """Refuse a non-default value of the JAX package's fields that select
    nothing in the port (see :class:`Scan360Params`)."""
    default = Scan360Params()
    for knob in ("decode_strategy", "reduce_chunk"):
        if getattr(params, knob) != getattr(default, knob):
            raise ValueError(
                f"{knob}={getattr(params, knob)!r}: the port has one decode "
                f"schedule and no chunked reduce, so only the default "
                f"{getattr(default, knob)!r} is accepted")


class _Stager:
    """Host stacks to the device ``chunk`` stops at a time, repeat-last
    padded to ``chunk``. On the card through one reusable pinned buffer
    (filled on the host, then a ``non_blocking`` copy; the buffer is
    refilled only once its previous copy has landed); on the CPU the padded
    array itself. The copy is exact."""

    def __init__(self, chunk: int, dev: torch.device):
        self.chunk = chunk
        self.dev = dev
        self.buf = None
        self.done = None

    def __call__(self, stops) -> torch.Tensor:
        k = len(stops)
        if self.dev.type != "cuda":
            return torch.from_numpy(np.stack(
                [stops[min(i, k - 1)] for i in range(self.chunk)]))
        if self.buf is None:
            self.buf = torch.empty((self.chunk,) + tuple(stops[0].shape),
                                   dtype=torch.uint8, pin_memory=True)
        elif self.done is not None:
            self.done.synchronize()
        # torchlint: disable=host-read -- the pinned host buffer
        host = self.buf.numpy()
        for i in range(self.chunk):
            host[i] = stops[min(i, k - 1)]
        part = self.buf.to(self.dev, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record()
        return part


def _decode_chunk(part, calib, col_bits, row_bits, decode_cfg, tri_cfg, dev):
    """One chunk of stops decoded and triangulated: (points, colors,
    valid) of the dense per-stop clouds."""
    r = pipeline_mod.reconstruct_batch(part, calib, col_bits, row_bits,
                                       decode_cfg, tri_cfg, device=dev)
    return r.points, r.colors, r.valid


def _decode_all(stacks, calib, col_bits, row_bits, decode_cfg, tri_cfg,
                chunk: int, dev):
    """Every stop of ``stacks`` (host array or tensor) decoded ``chunk``
    stops a call, the last chunk padded by repeating the last stop (the
    padding sliced away). Returns the dense (N, P, ·) clouds."""
    n = stacks.shape[0]
    stage = _Stager(chunk, dev) if isinstance(stacks, np.ndarray) else None
    parts = []
    for s in range(0, n, chunk):
        part = stacks[s:s + chunk]
        if stage is not None:
            part = stage(part)
        elif part.shape[0] < chunk:
            part = torch.cat([part] + [part[-1:]] * (chunk - part.shape[0]))
        parts.append(_decode_chunk(part, calib, col_bits, row_bits,
                                   decode_cfg, tri_cfg, dev))
    return tuple(torch.cat(c)[:n] for c in zip(*parts))


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
                         timing: dict | None = None, device=None,
                         health: health_mod.ScanHealthReport | None = None,
                         stop_labels=None):
    """(N, F, H, W) uint8 capture stacks → (merged PointCloud, poses
    (N, 4, 4) np.ndarray).

    ``stacks`` may be a host ``np.ndarray`` (chunks are then staged to the
    device one at a time — a 24-stop 1080p session is 2.3 GB of uint8 that
    never needs to be resident at once) or a tensor. Stops are in turntable
    order. ``seed`` seeds the per-edge RANSAC generators
    (:func:`..models.merge.edge_generator`). ``params.method`` is
    ``"sequential"`` (chained poses) or ``"posegraph"`` (plus the loop edge
    when ``merge.loop_closure``, then the pose-graph LM). ``params.fused``
    on a tensor runs the one-readback form (:func:`_run_fused`).
    ``with_stats`` appends a dict of per-edge fitness/rmse. ``timing``,
    when given, receives the wall seconds of each stage
    (``decode_triangulate_s``, ``subsample_s``, ``register_s``,
    ``merge_s``; the fused form also ``compact_s``), measured with a device
    synchronize at every stage edge; without it no stage edge synchronizes.

    ``params.gates`` selects the quality-gated tail (:func:`_gated_tail`;
    it needs the multi-launch path, so ``fused=True`` falls back with a
    warning): ``health`` (a :class:`..health.ScanHealthReport`) collects
    what happened, ``stop_labels`` maps stack position → physical stop
    index when the stacks already exclude capture-failed stops."""
    if params.method not in ("sequential", "posegraph"):
        raise ValueError(f"method must be 'sequential' or 'posegraph', "
                         f"got {params.method!r}")
    _check_jax_only_knobs(params)
    dev = resolve_device(device)
    if calib.Nc.device != dev:
        calib = calib.to(dev)
    n = stacks.shape[0]
    if n < 2:
        raise ValueError(f"need at least 2 stops, got {n}")
    mp = params.merge
    if params.gates is not None and params.fused:
        log.warning("quality gates need the multi-launch path — "
                    "fused=True falls back to the loop strategies")
    if params.fused and params.gates is None \
            and not isinstance(stacks, np.ndarray):
        return _run_fused(stacks, calib, col_bits, row_bits, params,
                          decode_cfg, tri_cfg, seed, with_stats, timing, dev)
    chunk = max(1, min(params.stop_chunk, n))
    clock = stage_clock(dev, timing)
    t0 = clock()

    # 1. Decode + triangulate, one chunk of stops at a time. Only the dense
    # outputs needed downstream (points/colors/valid) are kept.
    pts, cols, vals = _decode_all(stacks, calib, col_bits, row_bits,
                                  decode_cfg, tri_cfg, chunk, dev)
    t1 = clock()
    if params.gates is not None:
        out = _gated_tail(pts, cols, vals, params, seed, with_stats, health,
                          stop_labels)
        if timing is not None:
            timing.update(decode_triangulate_s=t1 - t0,
                          tail_s=clock() - t1, stops=n, chunk=chunk)
        return out

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
        reg_pts, reg_val, mp, seed=seed, loop_closure=loop,
        strategy=params.ring_strategy)
    poses = _ring_poses(params, Ts, infos, n)
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


def _ring_poses(params: Scan360Params, Ts, infos, n: int):
    """Per-stop poses from the ring's edges: chained (sequential edges
    only), or the pose-graph LM over the sequential edges and the loop edge
    (the last row, when present)."""
    if params.method == "posegraph":
        loop = Ts.shape[0] > n - 1
        graph = posegraph.build_360_graph(
            Ts[:n - 1], infos[:n - 1], Ts[n - 1] if loop else None,
            infos[n - 1] if loop else None)
        return posegraph.optimize(graph,
                                  iterations=params.merge.posegraph_iterations)
    return posegraph.chain_poses(Ts[:n - 1])


# ---------------------------------------------------------------------------
# The fused and streamed forms: one tail, one readback
# ---------------------------------------------------------------------------


def _tail_body(params: Scan360Params, pts, cols, vals, seed: int,
               timing: dict | None = None):
    """Everything after the decode, from the per-stop dense clouds:
    subsample → the batched ring (``merge._ring_body``) → chained poses (or
    the pose-graph LM) → per-view transform → voxel/SOR/normals finalize →
    the ``output_cap`` compaction (``pointcloud.stratified_indices``: the
    survivors packed to the front when they fit, a stratified subset when
    not). It reads nothing back but the RANSAC polish's convergence flags
    (one a power step, ``registration.kabsch``). The fused form and
    :func:`scan_stream_to_cloud`
    both call it, so they cannot diverge. Returns device tensors (points,
    colours uint8, normals float16, keep, survivors before compaction,
    poses, fitness, rmse). ``timing``, when given, receives
    ``subsample_s``, ``register_s`` and ``merge_s`` (the device drained at
    each edge)."""
    n, p_count = pts.shape[:2]
    mp = params.merge
    loop = params.method == "posegraph" and mp.loop_closure
    clock = stage_clock(pts.device, timing)
    t0 = clock()
    vc = min(merge_mod._round_up(params.view_cap), p_count)
    mr = min(merge_mod._round_up(mp.max_points), p_count)
    sub_pts, sub_col, sub_val, reg_pts, reg_val = _subsample_views_body(
        vc, mr, pts, cols, vals)
    t1 = clock()
    Ts, fit, rmse, infos = merge_mod._ring_body(mp, n, loop, reg_pts,
                                                reg_val, seed)
    poses = _ring_poses(params, Ts, infos, n).to(torch.float32)
    t2 = clock()
    moved = registration.transform_points(poses, sub_pts)
    dpts, dcol, normals, keep = merge_mod._finalize_body(
        mp, merge_mod._round_up(mp.final_max_points), moved.reshape(-1, 3),
        sub_col.reshape(-1, 3), sub_val.reshape(-1))
    n_out = keep.sum()
    if params.output_cap is not None:
        cidx, cval = pointcloud.stratified_indices(keep, params.output_cap)
        zero = torch.zeros((), device=dpts.device)
        dpts = torch.where(cval[:, None], dpts[cidx], zero)
        dcol = torch.where(cval[:, None], dcol[cidx], zero)
        normals = torch.where(cval[:, None], normals[cidx], zero)
        keep = cval
    dcol = dcol.clamp(0, 255).to(torch.uint8)
    t3 = clock()
    if timing is not None:
        timing.update(subsample_s=t1 - t0, register_s=t2 - t1,
                      merge_s=t3 - t2)
    return (dpts, dcol, normals.to(torch.float16), keep, n_out, poses, fit,
            rmse)


def _readback(*tensors) -> list[np.ndarray]:
    """Device tensors → host arrays in ONE copy: their bytes packed into
    one buffer on the device, moved, and split on the host."""
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])
    host = flat.cpu().numpy()
    out, o = [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        # torchlint: disable=host-read -- a host scalar, for its dtype
        dt = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(host[o:o + nb].view(dt).reshape(tuple(t.shape)))
        o += nb
    return out


def _compact_result(outs, params: Scan360Params, n: int, with_stats: bool,
                    tag: str):
    """Host side of the fused and streamed forms: one batched readback,
    edge telemetry, PointCloud assembly. The stats also carry
    ``survivors``, the finalize's points before the compaction."""
    (dpts, dcol, normals, keep, n_out, poses, fit,
     rmse) = _readback(*outs)
    if params.output_cap is not None and int(n_out) > params.output_cap:
        log.warning("fused output compaction truncated %d survivors to "
                    "output_cap=%d (stratified subset)", int(n_out),
                    params.output_cap)
    for i in range(1, n):
        log.info("edge %d→%d fitness=%.3f rmse=%.4f", i, i - 1,
                 fit[i - 1], rmse[i - 1])
    if fit.shape[0] > n - 1:
        log.info("loop edge 0→%d fitness=%.3f", n - 1, fit[n - 1])
    merged = ply_io.PointCloud(points=dpts[keep], colors=dcol[keep],
                               normals=normals[keep].astype(np.float32))
    log.info("scan_stacks_to_cloud[%s]: %d stops → %d points (%s)", tag, n,
             len(merged), params.method)
    if with_stats:
        return merged, poses, dict(_edge_stats(n, fit, rmse),
                                   survivors=int(n_out))
    return merged, poses


def _run_fused(stacks, calib, col_bits, row_bits, params: Scan360Params,
               decode_cfg, tri_cfg, seed: int, with_stats: bool,
               timing: dict | None, dev):
    """The one-readback form: the chunks decoded back to back (a ragged
    last chunk padded by repeating the last stop), then :func:`_tail_body`,
    then :func:`_compact_result` reads the compacted result back in one
    copy."""
    n = stacks.shape[0]
    chunk = max(1, min(params.stop_chunk, n))
    clock = stage_clock(dev, timing)
    t0 = clock()
    pts, cols, vals = _decode_all(stacks, calib, col_bits, row_bits,
                                  decode_cfg, tri_cfg, chunk, dev)
    t1 = clock()
    outs = _tail_body(params, pts, cols, vals, seed, timing)
    del pts, cols, vals
    t2 = clock()
    result = _compact_result(outs, params, n, with_stats, tag="fused")
    if timing is not None:
        timing.update(decode_triangulate_s=t1 - t0, compact_s=clock() - t2,
                      stops=n, chunk=chunk)
    return result


def scan_stream_to_cloud(stop_stacks, calib: Calibration, col_bits: int,
                         row_bits: int,
                         params: Scan360Params = Scan360Params(),
                         decode_cfg: DecodeConfig = DecodeConfig(),
                         tri_cfg: TriangulationConfig = TriangulationConfig(),
                         seed: int = 0, with_stats: bool = False,
                         timing: dict | None = None, device=None):
    """Capture-overlapped 360° processing: per-stop host stacks consumed AS
    THEY ARRIVE, the merged cloud one tail after the last stop lands.

    Each ``stop_chunk`` of stops is staged through one reusable pinned
    buffer and decoded while the capture of the next stops is still running
    (the hardware's ~46 × 200 ms a stop); only the dense per-stop clouds are
    kept, so the raw session never needs to be resident at once. After the
    last stop :func:`_tail_body` — the fused form's — registers and merges
    the ring, so on the same stacks the result is the fused form's.

    ``stop_stacks``: iterable of per-stop (F, H, W) uint8 host arrays in
    turntable order (e.g. a generator draining the capture queue).
    ``timing``, when given, receives the wall seconds of each chunk's
    staging + decode (``stage_decode_s``, the device drained at its end),
    the tail's (``tail_s``, with its ``subsample_s``, ``register_s`` and
    ``merge_s``), ``stops`` and ``chunk``. Quality gates are not applied
    on this path (a warning says so)."""
    _check_jax_only_knobs(params)
    dev = resolve_device(device)
    if calib.Nc.device != dev:
        calib = calib.to(dev)
    if params.gates is not None:
        log.warning("quality gates are not applied on the streaming path "
                    "(single fused tail launch) — run scan_stacks_to_cloud "
                    "with gates for the contained pipeline")
    chunk = max(1, params.stop_chunk)
    stage = _Stager(chunk, dev)
    per_chunk_s = []
    parts = []
    buf = []
    n = 0

    def flush(buf):
        t0 = time.perf_counter()
        parts.append(_decode_chunk(stage(buf), calib, col_bits, row_bits,
                                   decode_cfg, tri_cfg, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        per_chunk_s.append(time.perf_counter() - t0)

    for stack in stop_stacks:
        buf.append(np.asarray(stack))
        n += 1
        if len(buf) == chunk:
            flush(buf)
            buf = []
    if buf:
        flush(buf)
    if n < 2:
        raise ValueError(f"need at least 2 stops, got {n}")

    t0 = time.perf_counter()
    pts, cols, vals = (torch.cat(c)[:n] for c in zip(*parts))
    del parts
    tail_timing = {} if timing is not None else None
    outs = _tail_body(params, pts, cols, vals, seed, tail_timing)
    del pts, cols, vals
    result = _compact_result(outs, params, n, with_stats, tag="stream")
    if timing is not None:
        timing.update(tail_timing, stage_decode_s=per_chunk_s,
                      tail_s=time.perf_counter() - t0, stops=n, chunk=chunk)
    return result


# ---------------------------------------------------------------------------
# The quality-gated tail (failure containment; see health.QualityGates)
# ---------------------------------------------------------------------------


def _ring_span(labels: list[int], step_deg: float | None) -> int:
    """Total commanded steps of the full ring, for the loop edge's
    wrap-around gap: 360/step when the step is known, else
    ``max(labels) + 1``."""
    if step_deg:
        return max(int(round(360.0 / abs(step_deg))), max(labels) + 1)
    return max(labels) + 1


def _register_ring_gated(reg_pts, reg_val, mp: merge_mod.MergeParams,
                         surv: list[int], labels: list[int], loop: bool,
                         seed: int):
    """Ring registration over the SURVIVING stops only: the loop
    strategy's hint-chained ring (:func:`..models.merge.register_chain`)
    over the survivors' pairs, edge k drawing from ``edge_generator(seed,
    k)``. An edge between non-adjacent survivors is a BRIDGE (src onto
    dst, spanning the dropped stops); its ``gap`` counts the commanded
    turntable steps it covers. The axis-prior re-pass is skipped, as in the
    JAX package: the edge gates and the consensus repair cover its failure
    mode on the degraded ring.

    Returns ``(edges, Ts, fit, rmse, infos)`` with host arrays; ``edges``
    is a list of ``(src, dst, gap)``."""
    pre = {i: merge_mod.preprocess_registration_view(reg_pts[i], reg_val[i],
                                                     mp) for i in surv}
    pairs = [(surv[j + 1], surv[j]) for j in range(len(surv) - 1)]
    if loop:
        pairs.append((surv[0], surv[-1]))
    edges = health_mod.ring_edges([labels[i] for i in surv], loop,
                                  span=_ring_span(labels, mp.step_deg))
    Ts, fit, rmse, infos = (t.cpu().numpy() for t in
                            merge_mod.register_chain(pre, pairs, mp, seed))
    return edges, Ts, fit, rmse, infos


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _terminal_guard_cloud(merged: ply_io.PointCloud, sub_pts, sub_val,
                          coverage: np.ndarray,
                          health: health_mod.ScanHealthReport):
    """Last line of defence: a NaN-poisoned or empty merge degrades to the
    best available artifact (non-finite points stripped; if nothing is
    left, the highest-coverage stop's raw subsample) instead of handing
    the caller a crash in the mesher or writer."""
    pts = np.asarray(merged.points)
    if pts.shape[0]:
        finite = np.isfinite(pts).all(axis=1)
        if not finite.all():
            health.note("terminal guard: stripped %d non-finite points "
                        "from the merged cloud", int((~finite).sum()))
            merged = ply_io.PointCloud(
                points=pts[finite],
                colors=None if merged.colors is None
                else np.asarray(merged.colors)[finite],
                normals=None if merged.normals is None
                else np.asarray(merged.normals)[finite])
    if len(merged) == 0:
        best = int(np.argmax(coverage))
        p = _host(sub_pts[best])
        v = _host(sub_val[best])
        health.note("terminal guard: merged cloud empty — degraded to the "
                    "raw subsample of best-coverage stop %d (%d points)",
                    best, int(v.sum()))
        merged = ply_io.PointCloud(points=p[v].astype(np.float32))
    return merged


def _gated_tail(pts, cols, vals, params: Scan360Params, seed: int,
                with_stats: bool,
                health: health_mod.ScanHealthReport | None,
                stop_labels=None):
    """Stages 2–4 under the quality gates: coverage gate → (possibly
    degraded) ring registration → edge gates and repair → masked merge →
    terminal guard. Dropping a stop masks its merge contribution and
    re-routes the ring's edges around it. With no stop dropped the ring is
    the ungated one (``ring_strategy``, axis-prior pass included) and, when
    every edge passes, so is the result, bit for bit.

    ``stop_labels`` maps stack position → PHYSICAL stop index (strictly
    increasing; default identity), so one ``ScanHealthReport`` can span
    capture and compute and edge gaps count real commanded steps."""
    gates = params.gates
    health = health if health is not None else health_mod.ScanHealthReport()
    mp = params.merge
    n = pts.shape[0]
    labels = list(range(n)) if stop_labels is None \
        else [int(x) for x in stop_labels]
    if len(labels) != n:
        raise ValueError(f"stop_labels has {len(labels)} entries for "
                         f"{n} stops")

    # -- per-stop decode-coverage gate (N scalars read back) ---------------
    coverage = vals.to(torch.float32).mean(1).cpu().numpy()
    for i in range(n):
        health.stop(labels[i]).coverage = float(coverage[i])
    keep = coverage >= gates.min_coverage
    if int(keep.sum()) < 2:
        order = np.argsort(-coverage)
        keep = np.zeros(n, bool)
        keep[order[:2]] = True
        health.note("coverage gate relaxed: fewer than 2 stops ≥ %.3f — "
                    "keeping best stops %s", gates.min_coverage,
                    sorted(labels[int(i)] for i in order[:2]))
    dropped = [i for i in range(n) if not keep[i]]
    for i in dropped:
        health.stop(labels[i]).status = "dropped"
        health_mod.emit("stop_dropped", severity="warning",
                        message="decode coverage below gate",
                        scan_id=health.scan_id, stop=labels[i],
                        coverage=round(float(coverage[i]), 4),
                        min_coverage=gates.min_coverage)
    if dropped:
        health.note("coverage gate dropped stops %s (coverage %s < %.3f)",
                    [labels[i] for i in dropped],
                    [round(float(coverage[i]), 4) for i in dropped],
                    gates.min_coverage)
    surv = [i for i in range(n) if keep[i]]

    # -- stage 2: the shared subsample, as ungated -------------------------
    view_cap, m_reg = stop_view_sizes(params, pts.shape[1])
    sub_pts, sub_col, sub_val, reg_pts, reg_val = _subsample_views_body(
        view_cap, m_reg, pts, cols, vals)

    # -- stage 3: ring registration + edge gates ---------------------------
    loop = params.method == "posegraph" and mp.loop_closure
    if not dropped:
        Ts, infos, fit, rmse = merge_mod.register_sequence(
            reg_pts, reg_val, mp, seed=seed, loop_closure=loop,
            strategy=params.ring_strategy)
        edges = health_mod.ring_edges(labels, loop,
                                      span=_ring_span(labels, mp.step_deg))
        Ts, infos = Ts.cpu().numpy(), infos.cpu().numpy()
    else:
        edges, Ts, fit, rmse, infos = _register_ring_gated(
            reg_pts, reg_val, mp, surv, labels, loop, seed)
    Ts2, infos2, _ = health_mod.gate_edges(
        edges, Ts, np.asarray(fit), np.asarray(rmse), infos, gates,
        step_deg=mp.step_deg, report=health)

    # -- poses: chain (or pose graph) over the surviving ring --------------
    dev = pts.device
    surv_poses = _ring_poses(params, torch.from_numpy(Ts2).to(dev),
                             torch.from_numpy(infos2).to(dev), len(surv))
    poses = torch.eye(4, dtype=torch.float32, device=dev).repeat(n, 1, 1)
    poses[surv] = surv_poses.to(torch.float32)

    # -- stage 4: merge with the dropped stops masked out ------------------
    keep_dev = torch.from_numpy(keep).to(dev)
    moved = registration.transform_points(poses, sub_pts)
    merged = merge_mod._finalize(
        moved.reshape(-1, 3), sub_col.reshape(-1, 3),
        (sub_val & keep_dev[:, None]).reshape(-1), mp, has_colors=True)
    merged = _terminal_guard_cloud(merged, sub_pts, sub_val, coverage,
                                   health)
    log.info("scan_stacks_to_cloud[gated]: %d stops (%d dropped) → %d "
             "points (%s)", n, len(dropped), len(merged), params.method)
    poses_np = poses.cpu().numpy()
    if with_stats:
        stats_edges = [
            {"src": s, "dst": d, "gap": g,
             "fitness": round(float(fit[i]), 4),
             "rmse": round(float(rmse[i]), 4)}
            for i, (s, d, g) in enumerate(edges)]
        fits = [e["fitness"] for e in stats_edges]
        stats = {"edges": stats_edges,
                 "min_fitness": min(fits) if fits else None,
                 "mean_fitness": round(float(np.mean(fits)), 4)
                 if fits else None,
                 "dropped_stops": [labels[i] for i in dropped]}
        return merged, poses_np, stats
    return merged, poses_np


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


def scan_folders_to_cloud(
    stop_dirs,
    calib_path: str,
    output_path: str | None = None,
    col_bits: int | None = None,
    row_bits: int | None = None,
    params: Scan360Params = Scan360Params(),
    decode_cfg: DecodeConfig = DecodeConfig(),
    tri_cfg: TriangulationConfig = TriangulationConfig(),
    seed: int = 0,
    health: health_mod.ScanHealthReport | None = None,
    stop_labels=None,
    device=None,
):
    """File-level wrapper: per-stop frame folders and a ``.mat``
    calibration → (merged cloud, poses), the cloud also written to
    ``output_path`` when given; on ``device`` (None means the card).

    The reference's batch flow (`multi_point_cloud_process.py`, then the
    merge tab) without its file round trips in between. The bit counts
    follow the projector extent, ``ceil(log2(dim))``, as the reference sizes
    its Gray sequences (`server/sl_system.py:52-54`), and the stacks must
    hold ``2 + 2·(col_bits + row_bits)`` frames. With ``params.fused`` the
    stacks are staged on the device in one copy (the one-readback form
    needs them there); otherwise the host stacks go to
    :func:`scan_stacks_to_cloud`, which stages them a chunk at a time."""
    import math

    from ..io import images as img_io
    from ..io import matcal

    dev = resolve_device(device)
    stacks = np.stack([img_io.load_stack(d) for d in stop_dirs])
    _, _, h, w = stacks.shape
    cal = matcal.load_calibration_mat(calib_path, h, w, device=dev)
    if col_bits is None:
        col_bits = math.ceil(math.log2(cal.plane_cols.shape[0]))
    if row_bits is None:
        row_bits = math.ceil(math.log2(cal.plane_rows.shape[0]))
    expect = 2 + 2 * (col_bits + row_bits)
    if stacks.shape[1] != expect:
        raise ValueError(
            f"stack has {stacks.shape[1]} frames but {col_bits}+{row_bits} "
            f"bits imply {expect} (white, black, then pattern/inverse pairs)")
    if params.fused:
        stacks = torch.from_numpy(stacks).to(dev)
    merged, poses = scan_stacks_to_cloud(
        stacks, cal, col_bits, row_bits, params=params,
        decode_cfg=decode_cfg, tri_cfg=tri_cfg, seed=seed, device=dev,
        health=health, stop_labels=stop_labels)
    if output_path is not None:
        ply_io.write_ply(output_path, merged)
    return merged, poses
