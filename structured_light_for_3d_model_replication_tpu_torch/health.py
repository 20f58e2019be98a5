"""Failure containment for the streaming session (the port's own copy of the
numpy parts of the JAX package's ``health.py``): the error taxonomy, the
quality gates, the per-stop/per-edge health report, and the host-side ring
repair (consensus step, edge gating).

Everything here is host numpy and stdlib: gates read back a handful of
scalars per stop and edge. Where the JAX package records a flight-recorder
event, the port logs a record with the same event name and fields.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np

log = logging.getLogger(__name__)


def emit(event: str, severity: str = "info", **fields) -> None:
    """Log one event record (the JAX package's ``events.record``): the
    event name, then its fields as ``key=value``."""
    level = logging.WARNING if severity in ("warning", "fault") \
        else logging.INFO
    log.log(level, "%s %s", event,
            " ".join(f"{k}={v}" for k, v in fields.items()))


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------


class ScanFault(RuntimeError):
    """Base of the structured scan-pipeline error taxonomy: layers raise the
    specific subclass; orchestration catches ``ScanFault`` to contain a
    failure without masking programming errors."""


class StopQualityError(ScanFault):
    """A stop (or the whole session) fell below the quality gates and no
    degradation path could salvage it."""


# ---------------------------------------------------------------------------
# Quality gates
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QualityGates:
    """Host-side thresholds on the pipeline's health signals."""

    # Minimum fraction of decoded-valid pixels per stop; a stop below it is
    # dropped from the ring and its neighbours bridged.
    min_coverage: float = 0.02
    # Minimum ICP fitness per ring edge; a failing edge is replaced by the
    # ring-consensus step (sequential) and down-weighted (posegraph).
    min_edge_fitness: float = 0.2
    # Optional inlier-RMSE ceiling per edge (scene units); None disables it.
    max_edge_rmse: float | None = None
    # Information scale of rejected edges on the pose-graph path.
    posegraph_down_weight: float = 1e-3

    def coverage_ok(self, coverage: float) -> bool:
        return bool(coverage >= self.min_coverage)

    def edge_ok(self, fitness: float, rmse: float) -> bool:
        if not math.isfinite(float(fitness)) \
                or fitness < self.min_edge_fitness:
            return False
        if self.max_edge_rmse is not None and (
                not math.isfinite(float(rmse)) or rmse > self.max_edge_rmse):
            return False
        return True


# ---------------------------------------------------------------------------
# Health report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StopHealth:
    """One stop's capture + gate record."""

    index: int
    angle_deg: float | None = None
    # captured | resumed | failed | dropped | skipped_duplicate |
    # skipped_covisible
    status: str = "captured"
    coverage: float | None = None
    retries: int = 0
    stop_attempts: int = 1
    faults: list[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.coverage is not None:
            d["coverage"] = round(float(self.coverage), 4)
        return d


@dataclasses.dataclass
class EdgeHealth:
    """One ring edge's registration + gate record; ``gap`` counts the
    commanded turntable steps the edge spans (> 1 = a bridge)."""

    src: int
    dst: int
    gap: int = 1
    fitness: float | None = None
    rmse: float | None = None
    verdict: str = "pass"       # pass | reject
    action: str = "kept"        # kept | bridged | replaced_consensus
    #                           | down_weighted

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("fitness", "rmse"):
            if d[k] is not None:
                d[k] = round(float(d[k]), 4)
        return d


@dataclasses.dataclass
class ScanHealthReport:
    """Aggregated capture → merge → mesh health for one 360° session."""

    stops: dict[int, StopHealth] = dataclasses.field(default_factory=dict)
    edges: list[EdgeHealth] = dataclasses.field(default_factory=list)
    notes: list[str] = dataclasses.field(default_factory=list)
    rotate_timeouts: int = 0
    scan_id: str | None = None

    def stop(self, index: int, angle_deg: float | None = None) -> StopHealth:
        """Get-or-create the record for a stop."""
        rec = self.stops.get(index)
        if rec is None:
            rec = StopHealth(index=index, angle_deg=angle_deg)
            self.stops[index] = rec
        elif angle_deg is not None and rec.angle_deg is None:
            rec.angle_deg = angle_deg
        return rec

    @property
    def dropped_stops(self) -> list[int]:
        return sorted(i for i, s in self.stops.items()
                      if s.status == "dropped")

    @property
    def failed_stops(self) -> list[int]:
        return sorted(i for i, s in self.stops.items()
                      if s.status == "failed")

    @property
    def recovered_stops(self) -> list[int]:
        return sorted(i for i, s in self.stops.items()
                      if s.retries > 0 and s.status in ("captured",
                                                        "resumed"))

    @property
    def rejected_edges(self) -> list[EdgeHealth]:
        return [e for e in self.edges if e.verdict == "reject"]

    def to_dict(self) -> dict:
        return {
            **({"scan_id": self.scan_id} if self.scan_id else {}),
            "stops": [self.stops[i].to_dict() for i in sorted(self.stops)],
            "edges": [e.to_dict() for e in self.edges],
            "dropped_stops": self.dropped_stops,
            "failed_stops": self.failed_stops,
            "recovered_stops": self.recovered_stops,
            "rejected_edges": len(self.rejected_edges),
            "rotate_timeouts": self.rotate_timeouts,
            "retries_total": int(sum(s.retries
                                     for s in self.stops.values())),
            "notes": list(self.notes),
        }


# ---------------------------------------------------------------------------
# so3 helpers (host-side: gate repair works on a handful of 4×4s)
# ---------------------------------------------------------------------------


def _log_so3_np(R: np.ndarray) -> np.ndarray:
    """Rotation vector of a (3, 3) rotation; safe near identity."""
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = float(np.arccos(cos))
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]],
                 np.float64)
    if th < 1e-6:
        return 0.5 * v
    return v * (th / (2.0 * np.sin(th)))


def _exp_so3_np(w: np.ndarray) -> np.ndarray:
    """Rodrigues: rotation vector → (3, 3) rotation."""
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]],
                 np.float64)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def consensus_step_np(Ts: np.ndarray,
                      step_deg: float | None = None) -> np.ndarray | None:
    """Robust common per-step transform of a turntable ring: the median of
    the edge screws, trusting only edges whose rotation lands near the
    commanded step when it is known. None for an empty ring."""
    Ts = np.asarray(Ts, np.float64)
    if Ts.shape[0] == 0:
        return None
    w = np.stack([_log_so3_np(T[:3, :3]) for T in Ts])
    t = Ts[:, :3, 3]
    if step_deg is not None:
        step = abs(float(step_deg)) * np.pi / 180.0
        ang = np.linalg.norm(w, axis=1)
        trusted = np.abs(ang - step) <= 0.35 * step
        if not trusted.any():
            trusted = np.ones_like(trusted)
        w, t = w[trusted], t[trusted]
    T = np.eye(4)
    T[:3, :3] = _exp_so3_np(np.median(w, axis=0))
    T[:3, 3] = np.median(t, axis=0)
    return T


def _matrix_power_T(T: np.ndarray, n: int) -> np.ndarray:
    out = np.eye(4)
    for _ in range(n):
        out = out @ T
    return out


# ---------------------------------------------------------------------------
# Ring edges and gating
# ---------------------------------------------------------------------------


def ring_edges(labels, loop: bool = False,
               span: int | None = None) -> list[tuple[int, int, int]]:
    """``(src, dst, gap)`` per ring edge over physical stop labels:
    sequential edges ``labels[j+1] → labels[j]`` first, then the optional
    loop edge ``labels[0] → labels[-1]`` (its gap wraps around ``span``,
    default ``max(labels) + 1``)."""
    labels = [int(x) for x in labels]
    if any(b <= a for a, b in zip(labels, labels[1:])):
        raise ValueError(f"stop labels must be strictly increasing, "
                         f"got {labels}")
    edges = [(labels[j + 1], labels[j], labels[j + 1] - labels[j])
             for j in range(len(labels) - 1)]
    if loop:
        span = span if span is not None else max(labels) + 1
        edges.append((labels[0], labels[-1],
                      (labels[0] - labels[-1]) % span or span))
    return edges


def gate_edges(edges: list[tuple[int, int, int]], Ts: np.ndarray,
               fit: np.ndarray, rmse: np.ndarray, infos: np.ndarray,
               gates: QualityGates, step_deg: float | None = None,
               report: ScanHealthReport | None = None):
    """Gate a registered ring's edges and repair the rejects. Returns
    ``(Ts2, infos2, edge_health)``: rejected transforms are replaced by the
    consensus step raised to the edge's gap (when a consensus of passing
    gap-1 edges exists) and rejected information matrices scaled by
    ``gates.posegraph_down_weight``."""
    Ts = np.array(np.asarray(Ts, np.float64), copy=True)
    infos = np.array(np.asarray(infos, np.float64), copy=True)
    fit = np.asarray(fit, np.float64)
    rmse = np.asarray(rmse, np.float64)
    ok = np.array([gates.edge_ok(fit[i], rmse[i])
                   for i in range(len(edges))], bool)
    health: list[EdgeHealth] = []
    step_T = None
    if not ok.all():
        base = [Ts[i] for i in range(len(edges))
                if ok[i] and edges[i][2] == 1]
        step_T = consensus_step_np(np.stack(base) if base else
                                   np.zeros((0, 4, 4)), step_deg)
    for i, (src, dst, gap) in enumerate(edges):
        e = EdgeHealth(src=src, dst=dst, gap=gap,
                       fitness=float(fit[i]), rmse=float(rmse[i]),
                       verdict="pass" if ok[i] else "reject",
                       action="kept" if gap == 1 else "bridged")
        if not ok[i]:
            infos[i] = infos[i] * gates.posegraph_down_weight
            if step_T is not None:
                Ts[i] = _matrix_power_T(step_T, gap)
                e.action = "replaced_consensus"
            else:
                e.action = "down_weighted"
            emit("edge_rejected", severity="warning",
                 scan_id=report.scan_id if report is not None else None,
                 src=src, dst=dst, gap=gap, fitness=round(float(fit[i]), 4),
                 rmse=round(float(rmse[i]), 4), action=e.action)
        health.append(e)
    if report is not None:
        report.edges.extend(health)
    return Ts.astype(np.float32), infos.astype(np.float32), health
