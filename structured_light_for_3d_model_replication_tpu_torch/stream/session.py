"""IncrementalSession: fuse a 360° scan one stop at a time (counterpart of
the JAX ``stream/session.py``).

The batch pipeline's math, re-staged so each stop is consumed when it lands:

* **decode** — the batch path at B = 1 (:func:`..models.scan360.decode_stop`);
* **subsample** — the batch path's stratified pass with a stop axis of 1;
* **register** — the batch ring's per-stop preprocess and per-edge
  registration (:func:`..models.merge.preprocess_registration_view`,
  :func:`..models.merge.register_edge`), hint-chained, each edge drawing from
  the same (seed, edge index) generator as the batch ring, so a finalized
  session reproduces ``scan_stacks_to_cloud`` on a clean scan;
* **pose update** — chain for the new stop, then a windowed local
  re-optimize: the last ``window`` edges plus turntable-step prior edges
  through the pose-graph LM at a fixed padded shape (zero-information
  padding edges constrain nothing; only λ·I keeps H regular there);
* **fuse** — the stop's merge view, pose-transformed, voxel-merged into a
  fixed-capacity running model; in the TSDF lanes it is also integrated into
  the brick-pool volume (one ``csrc/combine.cu`` launch on the card);
* **preview** — a mesh of what the session holds after every stop: a
  coloured TSDF extraction (``"tsdf"``, ``"archival"``, ``"splat"``) or a
  coarse Poisson re-solve warm-started from the previous one
  (``"poisson"``). The ``"splat"`` lane also buffers each stop's dense RGB
  frame for the appearance tier (``splat/``), whose scene is seeded and
  fitted lazily, when a render is asked for.

A covisibility gate skips redundant stops before they cost registration: a
camera-frame test against the previous accepted stop (a stuck turntable)
and a predicted-pose test against the fused model (a second lap). Skipped
stops are bridged by the next real stop. ``finalize`` closes the ring
(loop edge, axis-prior re-pass or edge gates, pose solve, merge) and builds
the final mesh, optionally on a pipelined worker.

Where the JAX package records flight-recorder events and trace spans, the
port logs records with the same event names and fields
(:func:`..health.emit`).
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from .. import health as health_mod
from .._device import resolve_device
from ..config import DecodeConfig, TriangulationConfig
from ..io import ply as ply_io
from ..models import merge as merge_mod
from ..models import scan360 as scan360_mod
from ..ops import pointcloud, posegraph, registration
from ..ops.triangulate import Calibration
from .preview import make_previewer

log = logging.getLogger(__name__)
emit = health_mod.emit


@dataclasses.dataclass(frozen=True)
class StreamParams:
    """Streaming knobs on top of the batch merge parameters (the JAX
    package's fields and defaults).

    ``expected_stops`` sizes the JAX package's per-edge PRNG key schedule,
    and bench config 8 and the HTTP session options set it. Here each
    edge's generator is seeded from (seed, edge index), so no schedule
    exists: it is accepted and changes nothing. The schedule's cap,
    ``max_stops``, which nothing sets, is left out."""

    merge: merge_mod.MergeParams = merge_mod.MergeParams()
    method: str = "posegraph"           # finalize pose solve
    view_cap: int = 131_072             # per-stop merge-view slots
    # Quality gates: per-stop decode coverage (skip and bridge) and per-edge
    # fitness/RMSE (consensus repair / down-weight) at finalize; None = off.
    gates: health_mod.QualityGates | None = None
    # Running fused model capacity (overflow keeps a stratified subset).
    model_cap: int = 262_144
    # -- covisibility / novelty gate -------------------------------------
    covis: bool = True
    covis_model_overlap: float = 0.995
    covis_duplicate_overlap: float = 0.98
    covis_voxel_scale: float = 2.0      # gate voxel = scale × merge voxel
    covis_min_points: int = 256         # below this the gate abstains
    # -- windowed local re-optimize --------------------------------------
    window: int = 6
    window_iterations: int = 10
    window_prior_scale: float = 0.05
    # -- progressive previews --------------------------------------------
    preview_every: int = 1              # 0 disables previews
    preview_points: int = 8192
    preview_depth: int = 6
    preview_trim: float = 0.05
    # "tsdf" (default): TSDF previews and a coloured TSDF final mesh;
    # "archival": TSDF previews, watertight Poisson final; "poisson":
    # coarse Poisson previews that warm-start the Poisson final; "splat":
    # the TSDF lane plus the Gaussian appearance tier (splat/), rendered
    # novel views fitted from the per-stop RGB, and a TSDF final mesh.
    representation: str = "tsdf"
    tsdf_voxel_scale: float = 2.0       # TSDF voxel = scale × merge voxel
    tsdf_grid_depth: int = 8
    tsdf_max_bricks: int = 4096
    # Free-space carving of the TSDF previews (ops/tsdf.py
    # TSDFParams.carve_steps): 0 = the plain integrate; > 0 marches
    # observed-empty samples toward the camera, erasing stale surface.
    tsdf_carve_steps: int = 0
    # -- splat appearance tier (representation="splat") -------------------
    splat_cap: int = 8192               # splat slots on the TSDF shell
    splat_fit_iters: int = 40           # Adam steps per lazy scene build
    splat_max_frames: int = 8           # RGB frames kept for the fit
    splat_fit_pixels: int = 12288       # fit-resolution pixel budget
    # Allowed render resolutions (W, H); the first is the default.
    splat_render_sizes: tuple = ((384, 288),)
    # -- finalize ---------------------------------------------------------
    final_depth: int = 8
    final_trim: float = 0.0
    # Stop-count hint of the JAX package's key schedule; no effect here.
    expected_stops: int | None = None


@dataclasses.dataclass
class StopResult:
    """What happened to one submitted stop."""

    stop: int
    fused: bool
    reason: str      # fused | skipped_coverage | skipped_duplicate |
    #                  skipped_covisible
    coverage: float
    overlap: float | None = None
    fitness: float | None = None
    rmse: float | None = None
    gap: int = 1
    preview: bool = False
    model_points: int = 0
    seconds: float = 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("coverage", "overlap", "fitness", "rmse", "seconds"):
            if d[k] is not None:
                d[k] = round(float(d[k]), 4)
        return d


@dataclasses.dataclass
class FinalizeResult:
    cloud: ply_io.PointCloud
    poses: np.ndarray      # (max_label+1, 4, 4); skipped stops carry their
    #                        predicted pose, unseen stops I
    mesh: object | None    # TriangleMesh at final_depth, if built
    health: health_mod.ScanHealthReport
    stats: dict


def _fuse(m_pts, m_col, m_val, pose, s_pts, s_col, s_val, voxel: float,
          model_cap: int):
    """Model ∪ one pose-transformed stop view → model (``model_cap`` slots);
    also returns the merged voxel count and the moved view."""
    zero = torch.zeros((), device=s_pts.device)
    moved = torch.where(s_val[:, None],
                        registration.transform_points(pose, s_pts), zero)
    dp, dc, dv, _ = pointcloud.voxel_downsample(
        torch.cat([m_pts, moved]), voxel, valid=torch.cat([m_val, s_val]),
        attrs=torch.cat([m_col, s_col]))
    idx, v2 = pointcloud.stratified_indices(dv, model_cap)
    return (torch.where(v2[:, None], dp[idx], zero),
            torch.where(v2[:, None], dc[idx], zero), v2,
            dv.sum(dtype=torch.int32), moved)


def _window_refine(edge_T, edge_info, prior_T, prior_info,
                   iterations: int) -> torch.Tensor:
    """Fixed-window pose-graph LM: W chain edges plus W turntable-step prior
    edges over the same node pairs; node 0 (the window anchor) is held, so
    the poses are relative to the window start."""
    w = edge_T.shape[0]
    dev = edge_T.device
    src = torch.arange(1, w + 1, dtype=torch.int64, device=dev)
    dst = torch.arange(0, w, dtype=torch.int64, device=dev)
    graph = posegraph.PoseGraph(
        posegraph.chain_poses(edge_T), torch.cat([src, src]),
        torch.cat([dst, dst]), torch.cat([edge_T, prior_T]),
        torch.cat([edge_info, prior_info]))
    return posegraph.optimize(graph, iterations=iterations)


# ---------------------------------------------------------------------------
# Covisibility gate helpers (host-side: a few thousand points per stop)
# ---------------------------------------------------------------------------

_VOX_BITS = 21
_VOX_OFF = 1 << (_VOX_BITS - 1)


def _voxel_keys(pts: np.ndarray, voxel: float) -> np.ndarray:
    """Exact packed int64 voxel keys (21 signed bits per axis)."""
    q = np.floor(pts / float(voxel)).astype(np.int64) + _VOX_OFF
    q = np.clip(q, 0, (1 << _VOX_BITS) - 1)
    return np.unique((q[:, 0] << (2 * _VOX_BITS))
                     | (q[:, 1] << _VOX_BITS) | q[:, 2])


def voxel_overlap(pts: np.ndarray, occupied: np.ndarray,
                  voxel: float) -> float:
    """Fraction of ``pts``'s occupied voxels already present in the sorted
    key array ``occupied`` — the covisibility measure."""
    if pts.shape[0] == 0 or occupied.size == 0:
        return 0.0
    keys = _voxel_keys(pts, voxel)
    return float(np.isin(keys, occupied, assume_unique=True).mean())


class _EdgeRec:
    """One incremental ring edge (device transform + host scalars)."""

    __slots__ = ("src", "dst", "gap", "T_dev", "T_np", "T_live", "fit",
                 "rmse", "info")

    def __init__(self, src, dst, gap, T_dev, fit, rmse, info):
        self.src = src
        self.dst = dst
        self.gap = gap
        self.T_dev = T_dev                       # raw measured (finalize)
        self.T_np = T_dev.cpu().numpy().astype(np.float64)
        self.T_live = self.T_np                  # possibly live-repaired
        self.fit = float(fit)
        self.rmse = float(rmse)
        self.info = info


class IncrementalSession:
    """Consume one decoded stop at a time; keep a fused model, live poses
    and a progressive preview current throughout. Not thread-safe; one
    session is one scan (``finalize`` closes it). Runs on ``device`` (None
    means the card); ``seed`` seeds the per-edge RANSAC generators."""

    def __init__(self, calib: Calibration, col_bits: int, row_bits: int,
                 params: StreamParams = StreamParams(),
                 decode_cfg: DecodeConfig = DecodeConfig(),
                 tri_cfg: TriangulationConfig = TriangulationConfig(),
                 seed: int = 0, scan_id: str | None = None,
                 health: health_mod.ScanHealthReport | None = None,
                 device=None):
        if params.method not in ("sequential", "posegraph"):
            raise ValueError(f"method must be 'sequential' or 'posegraph', "
                             f"got {params.method!r}")
        if params.representation not in ("poisson", "tsdf", "splat",
                                          "archival"):
            raise ValueError(f"representation must be 'poisson', 'tsdf', "
                             f"'splat' or 'archival', got "
                             f"{params.representation!r}")
        self.device = resolve_device(device)
        # None: stops arrive decoded (``add_decoded``), as the serve layer
        # hands them over; ``add_stop`` needs a calibration.
        self.calib = calib.to(self.device) \
            if calib is not None and calib.Nc.device != self.device \
            else calib
        self.col_bits = col_bits
        self.row_bits = row_bits
        self.params = params
        self.decode_cfg = decode_cfg
        self.tri_cfg = tri_cfg
        self.seed = int(seed)
        self.scan_id = scan_id or f"stream-{id(self):x}"
        self.health = health if health is not None \
            else health_mod.ScanHealthReport()
        if self.health.scan_id is None:
            self.health.scan_id = self.scan_id
        self._n_pixels: int | None = None
        self._view_cap = self._m_reg = 0
        # Per-fused-stop state (parallel lists, index = fused order).
        self._labels: list[int] = []
        self._preps: list[tuple] = []
        self._subs: list[tuple] = []
        self._poses: list[np.ndarray] = []
        self._edges: list[_EdgeRec] = []
        self._hint = None
        self._consensus: np.ndarray | None = None
        # Skipped stops: label -> (reason, predicted pose).
        self._skipped: dict[int, tuple[str, np.ndarray]] = {}
        self._next_label = 0
        self._model: tuple | None = None        # (pts, col, val) device
        self._model_points = 0
        self._model_voxels = np.empty(0, np.int64)
        self._prev_cam_voxels = np.empty(0, np.int64)
        self._mesher = make_previewer(params, device=self.device)
        self._last_integrate_s = 0.0
        self.preview = None
        self.preview_meta: dict = {}
        # Set by a serving layer under overload: the progressive preview
        # of the next stops is skipped (the last one keeps serving).
        self.suppress_previews = False
        self._finalized = False

    # -- properties --------------------------------------------------------

    @property
    def stops_fused(self) -> int:
        return len(self._labels)

    @property
    def stops_skipped(self) -> int:
        return len(self._skipped)

    @property
    def finalized(self) -> bool:
        return self._finalized

    def live_poses(self) -> np.ndarray:
        """Current (fused-stop) global poses, refined incrementally; the
        authoritative poses come from :meth:`finalize`."""
        return np.stack(self._poses) if self._poses else \
            np.zeros((0, 4, 4))

    @property
    def previewer(self):
        return self._mesher

    def status_dict(self) -> dict:
        return {
            "scan_id": self.scan_id,
            "representation": self.params.representation,
            "stops_fused": self.stops_fused,
            "stops_skipped": self.stops_skipped,
            "skipped": {str(k): v[0] for k, v in self._skipped.items()},
            "model_points": int(self._model_points),
            "preview": dict(self.preview_meta) if self.preview_meta
            else None,
            "finalized": self._finalized,
        }

    # -- per-stop ingestion ------------------------------------------------

    def add_stop(self, stack, stop: int | None = None) -> StopResult:
        """Decode one (F, H, W) uint8 capture stack and fuse it."""
        pts, cols, vals = scan360_mod.decode_stop(
            stack, self.calib, self.col_bits, self.row_bits,
            decode_cfg=self.decode_cfg, tri_cfg=self.tri_cfg)
        return self.add_decoded(pts, cols, vals, stop=stop,
                                frame_shape=stack.shape[1:3])

    def add_decoded(self, points, colors, valid, stop: int | None = None,
                    coverage: float | None = None,
                    frame_shape: tuple | None = None) -> StopResult:
        """Fuse one stop's decoded dense arrays: ``points`` (P, 3) float32,
        ``colors`` (P, 3), ``valid`` (P,) bool. ``stop`` is the physical
        stop label (strictly increasing; defaults to the next index) —
        label gaps bridge like the batch degraded ring. ``coverage``
        overrides the plain ``mean(valid)``. ``frame_shape`` (H, W) lets
        the ``"splat"`` lane buffer the stop's RGB frame for the appearance
        fit; without it the stop only fuses."""
        if self._finalized:
            raise health_mod.StopQualityError(
                f"session {self.scan_id} is finalized")
        label = self._next_label if stop is None else int(stop)
        if label < self._next_label:
            raise ValueError(
                f"stop labels must be strictly increasing: got {label} "
                f"after {self._next_label - 1}")
        self._next_label = label + 1
        t0 = time.monotonic()
        res = self._ingest(label, points, colors, valid, coverage,
                           frame_shape)
        res.seconds = time.monotonic() - t0
        return res

    def _ingest(self, label: int, points, colors, valid,
                coverage: float | None = None,
                frame_shape: tuple | None = None) -> StopResult:
        p = self.params
        mp = p.merge
        dev = self.device
        points = torch.as_tensor(points, device=dev)
        valid = torch.as_tensor(valid, device=dev)
        colors = torch.as_tensor(colors, device=dev)
        if self._n_pixels is None:
            self._n_pixels = int(points.shape[0])
            self._view_cap, self._m_reg = scan360_mod.stop_view_sizes(
                scan360_mod.Scan360Params(merge=mp, view_cap=p.view_cap),
                self._n_pixels)
        elif int(points.shape[0]) != self._n_pixels:
            raise ValueError(
                f"stop {label} has {int(points.shape[0])} pixels; this "
                f"session is locked to {self._n_pixels}")

        if coverage is None:
            coverage = float(valid.to(torch.float32).mean())
        rec = self.health.stop(label)
        rec.coverage = coverage

        # -- decode-coverage gate (skip and bridge) ------------------------
        if p.gates is not None and not p.gates.coverage_ok(coverage):
            rec.status = "dropped"
            emit("stop_dropped", severity="warning", scan_id=self.scan_id,
                 stop=label, coverage=round(coverage, 4),
                 min_coverage=p.gates.min_coverage)
            self._skipped[label] = ("skipped_coverage",
                                    self._predict_pose(label))
            return StopResult(stop=label, fused=False,
                              reason="skipped_coverage", coverage=coverage,
                              gap=self._gap_for(label))

        sub_pts, sub_col, sub_val, reg_pts, reg_val = \
            scan360_mod.subsample_stop(points, colors, valid,
                                       self._view_cap, self._m_reg)
        reg_np = reg_pts[reg_val].cpu().numpy()

        # -- covisibility / novelty gate ------------------------------------
        overlap = self._covis_overlap(label, reg_np)
        if overlap is not None:
            kind, value = overlap
            rec.status = kind
            emit("stop_skipped_covisible", scan_id=self.scan_id, stop=label,
                 message=f"redundant stop ({kind})", overlap=round(value, 4),
                 coverage=round(coverage, 4),
                 threshold=(p.covis_duplicate_overlap
                            if kind == "skipped_duplicate"
                            else p.covis_model_overlap))
            self._skipped[label] = (kind, self._predict_pose(label))
            return StopResult(stop=label, fused=False, reason=kind,
                              coverage=coverage, overlap=value,
                              gap=self._gap_for(label),
                              model_points=self._model_points)

        # -- register against the running anchor ---------------------------
        prep = merge_mod.preprocess_registration_view(reg_pts, reg_val, mp)
        fit = rmse = None
        gap = self._gap_for(label)
        if self._labels:
            edge = self._register_edge(label, prep, gap)
            fit, rmse = edge.fit, edge.rmse
            pose = self._poses[-1] @ edge.T_live
            self._edges.append(edge)
            self._update_consensus()
        else:
            pose = np.eye(4)
        self._labels.append(label)
        self._preps.append(prep)
        self._subs.append((sub_pts, sub_col, sub_val))
        self._poses.append(pose)
        if len(self._edges) >= 2:
            self._refine_window()

        # -- fuse into the running model ------------------------------------
        moved = self._fuse(sub_pts, sub_col, sub_val)
        if p.representation == "splat" and frame_shape is not None:
            # Appearance supervision (splat/preview.py): the stop's dense
            # RGB + valid mask and its registered pose join the fit buffer
            # — one strided subsample, no fit on the ingest path (the fit
            # is lazy, at render time). The stored pose is the stop's
            # at-ingest estimate.
            self._mesher.observe_frame(points, colors, valid,
                                       self._poses[-1], frame_shape)
        if p.covis:
            voxel = self._covis_voxel()
            self._prev_cam_voxels = _voxel_keys(reg_np, voxel)
            mv = moved[sub_val.cpu().numpy()]
            self._model_voxels = np.union1d(self._model_voxels,
                                            _voxel_keys(mv, voxel))

        did_preview = self._maybe_preview(label)
        emit("stop_fused", scan_id=self.scan_id, stop=label,
             coverage=round(coverage, 4),
             fitness=None if fit is None else round(fit, 4),
             rmse=None if rmse is None else round(rmse, 4), gap=gap,
             model_points=self._model_points)
        return StopResult(stop=label, fused=True, reason="fused",
                          coverage=coverage, fitness=fit, rmse=rmse,
                          gap=gap, preview=did_preview,
                          model_points=self._model_points)

    # -- gate internals ----------------------------------------------------

    def _covis_voxel(self) -> float:
        return self.params.covis_voxel_scale * self.params.merge.voxel_size

    def _gap_for(self, label: int) -> int:
        return label - self._labels[-1] if self._labels else 1

    def _predict_pose(self, label: int) -> np.ndarray:
        """Consensus-extrapolated global pose for a skipped stop."""
        if not self._poses:
            return np.eye(4)
        pose = self._poses[-1].copy()
        if self._consensus is not None:
            pose = pose @ health_mod._matrix_power_T(
                self._consensus, self._gap_for(label))
        return pose

    def _covis_overlap(self, label: int, reg_np: np.ndarray):
        """(reason, overlap) when the stop should be skipped, else None."""
        p = self.params
        if not p.covis or reg_np.shape[0] < p.covis_min_points \
                or not self._labels:
            return None
        voxel = self._covis_voxel()
        dup = voxel_overlap(reg_np, self._prev_cam_voxels, voxel)
        if dup >= p.covis_duplicate_overlap:
            return ("skipped_duplicate", dup)
        if self._consensus is not None and self._model_voxels.size:
            predicted = self._predict_pose(label)
            moved = reg_np @ predicted[:3, :3].T + predicted[:3, 3]
            cov = voxel_overlap(moved, self._model_voxels, voxel)
            if cov >= p.covis_model_overlap:
                return ("skipped_covisible", cov)
        return None

    # -- registration internals --------------------------------------------

    def _edge_generator(self, idx: int) -> torch.Generator:
        return merge_mod.edge_generator(self.seed, idx, self.device)

    def _register_edge(self, label: int, prep, gap: int) -> _EdgeRec:
        p = self.params
        T, fit, rmse, info = merge_mod.register_edge(
            prep, self._preps[-1], p.merge,
            self._edge_generator(len(self._edges)), hint=self._hint)
        self._hint = T
        edge = _EdgeRec(src=label, dst=self._labels[-1], gap=gap, T_dev=T,
                        fit=fit, rmse=rmse, info=info)
        # Live repair: a failing edge must not corrupt the LIVE pose chain
        # (finalize re-gates the raw measurements like the batch path).
        if p.gates is not None and not p.gates.edge_ok(edge.fit, edge.rmse) \
                and self._consensus is not None:
            edge.T_live = health_mod._matrix_power_T(self._consensus, gap)
            emit("edge_rejected", severity="warning", scan_id=self.scan_id,
                 message=f"live edge {label}->{edge.dst} replaced by ring "
                         "consensus", fitness=round(edge.fit, 4),
                 rmse=round(edge.rmse, 4), gap=gap)
        return edge

    def _update_consensus(self) -> None:
        steps = [e.T_np for e in self._edges if e.gap == 1]
        if steps:
            self._consensus = health_mod.consensus_step_np(
                np.stack(steps), self.params.merge.step_deg)

    def _refine_window(self) -> None:
        """Local pose-graph re-optimize over the trailing window — only when
        a step consensus exists (a pure chain is already exact)."""
        p = self.params
        if self._consensus is None or p.window < 2:
            return
        w = min(p.window, len(self._edges))
        if w < 2:
            return
        W = p.window
        eT = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
        eI = np.zeros((W, 6, 6), np.float32)
        pT = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
        pI = np.zeros((W, 6, 6), np.float32)
        sel = self._edges[-w:]
        infos = [e.info.cpu().numpy().astype(np.float64) for e in sel]
        scale = p.window_prior_scale * float(np.median(
            [np.trace(i) / 6.0 for i in infos]))
        eye6 = np.eye(6, dtype=np.float32)
        for j, (e, info) in enumerate(zip(sel, infos)):
            eT[j] = e.T_live.astype(np.float32)
            eI[j] = info.astype(np.float32)
            pT[j] = health_mod._matrix_power_T(
                self._consensus, e.gap).astype(np.float32)
            pI[j] = scale * eye6

        def t(a):
            return torch.from_numpy(a).to(self.device)

        opt = _window_refine(t(eT), t(eI), t(pT), t(pI),
                             p.window_iterations).cpu().numpy().astype(
                                 np.float64)
        anchor = self._poses[-(w + 1)]
        for j in range(1, w + 1):
            self._poses[-(w + 1) + j] = anchor @ opt[j]

    # -- fusion + preview --------------------------------------------------

    def _fuse(self, sub_pts, sub_col, sub_val) -> np.ndarray:
        p = self.params
        dev = self.device
        if self._model is None:
            cap = p.model_cap
            self._model = (torch.zeros((cap, 3), device=dev),
                           torch.zeros((cap, 3), device=dev),
                           torch.zeros((cap,), dtype=torch.bool, device=dev))
        pose = torch.as_tensor(self._poses[-1], dtype=torch.float32,
                               device=dev)
        m_pts, m_col, m_val, n_model, moved = _fuse(
            *self._model, pose, sub_pts, sub_col, sub_val,
            p.merge.voxel_size, p.model_cap)
        self._model = (m_pts, m_col, m_val)
        n_model = int(n_model)
        if n_model > p.model_cap:
            log.warning("running model overflowed model_cap=%d (%d voxels) "
                        "— previews sample a stratified subset",
                        p.model_cap, n_model)
        self._model_points = min(n_model, p.model_cap)
        moved_np = moved.cpu().numpy()
        if p.representation in ("tsdf", "splat", "archival"):
            # Incremental TSDF integration: the stop's pose-transformed view
            # fuses into the persistent volume here, so the preview is a
            # pure extraction. The camera centre in the model frame is the
            # stop pose's translation. Timed (the brick count read blocks
            # on the integrate), so a preview reads integrate + extract.
            t_int = time.monotonic()
            self._mesher.integrate_stop(
                moved, sub_col, sub_val, self._poses[-1][:3, 3],
                moved_np=moved_np[sub_val.cpu().numpy()]
                if self._mesher.volume is None else None)
            self._last_integrate_s = time.monotonic() - t_int
        return moved_np

    def _maybe_preview(self, label: int) -> bool:
        p = self.params
        if not p.preview_every:
            return False
        n = len(self._labels)
        if n != 1 and n % p.preview_every != 0:
            return False
        if self.suppress_previews:
            emit("preview_shed", scan_id=self.scan_id,
                 message="progressive preview skipped under overload "
                         "shedding", stops_fused=n)
            return False
        t0 = time.monotonic()
        mesh = self._mesher(self._model[0], self._model[2])
        dt = time.monotonic() - t0
        self.preview = mesh
        self.preview_meta = {
            "stop": label, "stops_fused": n,
            "faces": int(len(mesh.faces)),
            "vertices": int(len(mesh.vertices)),
            "depth": p.preview_depth,
            "representation": p.representation,
            "model_points": self._model_points,
            "preview_s": round(dt, 6),
            # TSDF: this stop's volume integration (0.0 under poisson,
            # whose preview_s holds its re-solve).
            "integrate_s": round(self._last_integrate_s, 6),
        }
        emit("preview_emitted", scan_id=self.scan_id,
             faces=int(len(mesh.faces)), depth=p.preview_depth,
             stops_fused=n, preview_s=round(dt, 3),
             model_points=self._model_points)
        return True

    # -- finalize ----------------------------------------------------------

    def finalize(self, mesh: bool = True,
                 overlap: bool = True) -> FinalizeResult:
        """Close the ring — loop-closure edge (``posegraph``), axis-prior
        re-pass (clean rings) or edge gates, full pose solve, merge of every
        retained stop view — and build the final mesh (``"tsdf"`` and
        ``"splat"``: the coloured TSDF of the final cloud;
        ``"archival"``/``"poisson"``: the watertight Poisson solve at
        ``final_depth``, the latter warm-started from the last preview). ``overlap=True`` runs the mesh on a
        pipelined worker while the finalize tail runs, and joins before
        returning (``stats["overlap"]`` has the window)."""
        if self._finalized:
            raise health_mod.StopQualityError(
                f"session {self.scan_id} already finalized")
        if len(self._labels) < 2:
            raise health_mod.StopQualityError(
                f"need at least 2 fused stops to finalize, have "
                f"{len(self._labels)}")
        t0 = time.monotonic()
        n = len(self._labels)
        loop = self.params.method == "posegraph" \
            and self.params.merge.loop_closure
        result = self._finalize_inner(n, loop, mesh, overlap)
        self._finalized = True
        emit("session_finalized", scan_id=self.scan_id, stops_fused=n,
             stops_skipped=len(self._skipped),
             cloud_points=len(result.cloud),
             mesh_faces=None if result.mesh is None
             else int(len(result.mesh.faces)),
             elapsed_s=round(time.monotonic() - t0, 3))
        return result

    def _finalize_inner(self, n: int, loop: bool, want_mesh: bool,
                        overlap: bool) -> FinalizeResult:
        p = self.params
        mp = p.merge
        outs = [(e.T_dev, torch.as_tensor(e.fit), torch.as_tensor(e.rmse),
                 e.info) for e in self._edges]
        if loop:
            T, f, r, info = merge_mod.register_edge(
                self._preps[0], self._preps[-1], mp,
                self._edge_generator(len(self._edges)), hint=self._hint)
            outs.append((T, f, r, info))
        Ts = torch.stack([o[0] for o in outs])
        fit_t = torch.stack([o[1].to(self.device, torch.float32)
                             for o in outs])
        rmse_t = torch.stack([o[2].to(self.device, torch.float32)
                              for o in outs])
        infos = torch.stack([o[3] for o in outs])

        bridged = any(e.gap != 1 for e in self._edges)
        if not bridged and mp.axis_prior and Ts.shape[0] >= 3:
            # Clean ring: the batch ring's consensus re-pass, fed from the
            # retained per-stop preprocesses.
            Ts, fit_t, rmse_t, infos = merge_mod.axis_prior_pass(
                self._preps, (Ts, fit_t, rmse_t, infos), mp, loop)
        fit = fit_t.cpu().numpy()

        if p.gates is not None:
            edges_meta = health_mod.ring_edges(
                self._labels, loop,
                span=scan360_mod._ring_span(self._labels, mp.step_deg))
            Ts2, infos2, _ = health_mod.gate_edges(
                edges_meta, Ts.cpu().numpy(), fit, rmse_t.cpu().numpy(),
                infos.cpu().numpy(), p.gates, step_deg=mp.step_deg,
                report=self.health)
            Ts = torch.from_numpy(Ts2).to(self.device)
            infos = torch.from_numpy(infos2).to(self.device)

        if p.method == "posegraph":
            graph = posegraph.build_360_graph(
                Ts[:n - 1], infos[:n - 1], Ts[n - 1] if loop else None,
                infos[n - 1] if loop else None)
            poses = posegraph.optimize(graph,
                                       iterations=mp.posegraph_iterations)
        else:
            poses = posegraph.chain_poses(Ts[:n - 1])

        sub_pts = torch.stack([s[0] for s in self._subs])
        sub_col = torch.stack([s[1] for s in self._subs])
        sub_val = torch.stack([s[2] for s in self._subs])
        moved = registration.transform_points(poses.to(torch.float32),
                                              sub_pts)
        merged = merge_mod._finalize(moved.reshape(-1, 3),
                                     sub_col.reshape(-1, 3),
                                     sub_val.reshape(-1), mp,
                                     has_colors=True)

        # The merged cloud is final: launch the mesh now (on the pipelined
        # worker with overlap=True) while the tail below runs.
        final_mesh = None
        mesh_task = None
        solve_stats: dict = {}
        if want_mesh:
            from ..models import meshing

            # Poisson warm starts from the previews: the last χ at the same
            # dense depth, the last grid for a sparse final (> 8). Only the
            # poisson lane has Poisson previews; archival previews are the
            # TSDF volume.
            x0 = None
            if p.representation == "poisson":
                if p.final_depth == p.preview_depth:
                    x0 = self._mesher.last_chi
                elif p.final_depth > 8:
                    x0 = self._mesher.last_grid
            # The splat lane's geometry is the TSDF volume: its final mesh
            # is the coloured TSDF extraction. Archival = TSDF previews,
            # Poisson final artifact.
            mesh_rep = {"splat": "tsdf", "archival": "poisson"}.get(
                p.representation, p.representation)
            mesh_kw = dict(
                mode="watertight", depth=p.final_depth,
                quantile_trim=p.final_trim, representation=mesh_rep,
                tsdf_max_bricks=p.tsdf_max_bricks, cg_x0=x0,
                solve_stats=solve_stats, device=self.device)
            if overlap:
                mesh_task = meshing.mesh_from_cloud_async(
                    merged, task_name=f"finalize-{self.scan_id}", **mesh_kw)
            else:
                final_mesh = meshing.mesh_from_cloud(merged, **mesh_kw)

        poses_np = poses.cpu().numpy()
        all_poses = np.tile(np.eye(4, dtype=np.float32),
                            (self._next_label, 1, 1))
        for j, lab in enumerate(self._labels):
            all_poses[lab] = poses_np[j].astype(np.float32)
        for lab, (_, predicted) in self._skipped.items():
            all_poses[lab] = predicted.astype(np.float32)

        stats = {
            "stops_fused": n,
            "stops_skipped": len(self._skipped),
            "edges": [
                {"src": e.src, "dst": e.dst, "gap": e.gap,
                 "fitness": round(e.fit, 4), "rmse": round(e.rmse, 4)}
                for e in self._edges],
            "min_fitness": round(float(fit.min()), 4) if len(fit) else None,
            "cloud_points": len(merged),
        }
        if mesh_task is not None:
            tail_done_s = time.monotonic() - mesh_task.t_submit
            final_mesh = mesh_task.result()
            timings = mesh_task.timings()
            stats["overlap"] = {
                "solve": timings,
                "tail_done_s": round(tail_done_s, 6),
                "overlapped": timings["started_s"] is not None
                and timings["started_s"] < tail_done_s,
            }
        if solve_stats:
            stats["final_solve"] = solve_stats
        log.info("stream finalize[%s]: %d fused / %d skipped stops -> %d "
                 "points%s", self.scan_id, n, len(self._skipped),
                 len(merged), "" if final_mesh is None
                 else f", {len(final_mesh.faces)} mesh faces")
        return FinalizeResult(cloud=merged, poses=all_poses,
                              mesh=final_mesh, health=self.health,
                              stats=stats)
