"""Multi-stop streaming sessions for the reconstruction service.

One :class:`ServeSession` wraps one `stream.IncrementalSession` behind a
lock: stops are submitted as ordinary jobs whose ``decode_sink`` hands
the batch-decoded arrays to the session (so session stops ride the SAME
admission queue → bucketed batcher → warmed program cache as one-shot
jobs — full batcher interop, including coalescing stops from different
sessions into one launch), previews are serialized lazily on demand, and
finalize lands the result as a terminal job in the service's ordinary
job registry so the existing ``GET /result`` path serves it.

The registry is bounded two ways: at most ``max_sessions`` live
(unfinalized) sessions — above it ``POST /session`` is refused with a
retryable rejection (the admission-queue rule applied to sessions) —
and EVERY session, live or finalized, expires ``session_ttl_s`` after
its last activity (finalized ones are additionally evicted oldest-first
past the cap). A client that crashes mid-scan therefore frees its slot
and its model buffers after the idle TTL instead of pinning them
forever.

Ordering: within one worker, stops complete in submission order (batches
preserve queue order and the postprocess loop is sequential). With
``workers > 1`` two batches can interleave — submit a session's next
stop after the previous stop's job is terminal (the natural capture
cadence), or keep one worker per device.
"""

from __future__ import annotations

import contextlib
import io
import threading
import time
import uuid
from collections import OrderedDict

import numpy as np
import torch

from .._device import not_ported, resolve_device
from ..io.stl import write_stl
from ..stream import IncrementalSession, StreamParams
from ..utils import events
from ..utils.log import get_logger
from .jobs import DONE, FAILED, JobRejected, ServeError, StackFormatError

log = get_logger(__name__)

#: ``POST /session`` body keys a client may override per session. The
#: merge/registration surface stays server-side (it keys compiled
#: programs; per-session drift would mint fresh compiles — exactly what
#: the warmed steady state forbids). ``representation`` picks the
#: preview/final scene representation ("tsdf" — the default,
#: integrate-don't-re-solve | "archival" — TSDF previews, watertight
#: Poisson final artifact | "poisson" — the legacy re-solve lane |
#: "splat" — the fusion/splat dispatch, docs/STREAMING.md +
#: docs/RENDERING.md; a non-default choice compiles its programs on
#: first use unless the replica warmed that lane too; "splat" adds the
#: GET /session/<id>/render + /splats surface and result_format
#: "render_png").
SESSION_OPTION_KEYS = ("preview_every", "preview_depth", "final_depth",
                       "expected_stops", "method", "covis",
                       "representation")


class SessionLimitError(JobRejected):
    """Session registry at capacity — finish or delete one, then retry."""

    retryable = True

    def __init__(self, limit: int):
        super().__init__(f"session limit reached ({limit} live sessions); "
                         "finalize or delete one and retry")
        self.retry_after_s = None


class UnknownSessionError(ServeError):
    """No such session (never created, or evicted) — maps to HTTP 404."""


class SessionResultEvicted(ServeError):
    """The session finalized, but its terminal result job fell out of the
    bounded job registry — the artifact is gone; re-scan. Maps to HTTP
    410 (the one-shot result-eviction semantics applied to sessions)."""


class ServeSession:
    """One streaming session: lock, lifecycle stamps, lazy preview bytes."""

    def __init__(self, session_id: str, session: IncrementalSession,
                 bucket_pixels: int, preview_shed=None, lane=None):
        self.session_id = session_id
        self.session = session
        self.bucket_pixels = bucket_pixels
        # Overload hook (serve/governor.py): polled per ingested stop;
        # True suppresses the progressive preview for that stop (the
        # cheapest sheddable work — the last preview keeps serving).
        self.preview_shed = preview_shed
        # Sticky device lane (serve/lanes.py): every stop job carries
        # this lane's affinity AND the session's own work (fuse, refine,
        # preview) runs on the lane's device, where the session's state
        # lives.
        self.lane = lane
        # How many times this session's sticky lane moved (device-loss
        # re-pins AND revival rebalances) — the chaos tests' migration
        # evidence, surfaced in status_dict.
        self.lane_moves = 0
        self.lock = threading.Lock()
        self.created_t = time.monotonic()
        self.last_t = self.created_t
        self.stops_submitted = 0
        self.result_job_id: str | None = None
        self._preview_cache: tuple[int, bytes] | None = None
        self._pending: list = []  # submitted stop Jobs not yet terminal

    # ------------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        """The device the session's ``IncrementalSession`` was built on:
        its sticky lane's card, or the service's device."""
        return self.session.device

    def device_ctx(self):
        """The session's card as the thread's current CUDA device for the
        enclosed work (the kernels launch on the current stream of their
        tensors' device); a no-op on the host."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(self.device)

    def repin(self, lane) -> None:
        """Move the session's sticky lane — the device-loss re-pin and
        the revival rebalance (serve/lanes.py) share this path. The
        session's state lives on its device; moving it to another card
        comes with the multi-card service (ROADMAP Queue 1 step 4(c)),
        so a lane on another device raises."""
        with self.lock:
            if lane is not None and lane.device != self.device:
                raise not_ported("re-pinning a session to another card",
                                 "step 4(c)")
            if lane is not self.lane:
                self.lane_moves += 1
            self.lane = lane

    def ingest(self, points, colors, valid, coverage=None,
               frame_shape=None) -> dict:
        """The job's ``decode_sink``: fuse one decoded stop. Runs on the
        worker thread; the lock serializes against preview/finalize —
        under the session's sticky lane device when one is assigned.
        ``frame_shape`` is the decoded bucket's (H, W) — the splat
        appearance lane's RGB supervision needs the pixel layout."""
        shed = bool(self.preview_shed()) if self.preview_shed else False
        with self.lock:
            self.session.suppress_previews = shed
            with self.device_ctx():
                res = self.session.add_decoded(points, colors, valid,
                                               coverage=coverage,
                                               frame_shape=frame_shape)
            self.last_t = time.monotonic()
            return {"session_id": self.session_id, **res.to_dict()}

    @staticmethod
    def _terminal(job) -> bool:
        # Plain status read — the prune below runs under the session
        # lock, where even a zero-timeout Event.wait is off-limits (no
        # blocking under a lock).
        return job.status in (DONE, FAILED)

    def note_pending(self, job) -> None:
        with self.lock:
            self._pending = [j for j in self._pending
                             if not self._terminal(j)]
            self._pending.append(job)
            self.last_t = time.monotonic()

    def settle_pending(self, timeout_s: float = 120.0) -> bool:
        """Block until every already-submitted stop job is terminal —
        finalize must not close the ring under a stop the client was
        told 200 about. Called WITHOUT the session lock held (the
        pending jobs' sinks need it to finish). True when all settled."""
        deadline = time.monotonic() + timeout_s
        with self.lock:
            jobs = list(self._pending)
        ok = True
        for j in jobs:
            ok = j.wait(max(0.0, deadline - time.monotonic())) and ok
        with self.lock:
            self._pending = [j for j in self._pending
                             if not self._terminal(j)]
        return ok

    def preview_bytes(self) -> tuple[bytes, dict] | None:
        """Latest progressive preview as STL bytes (serialized once per
        emitted preview, then cached)."""
        with self.lock:
            mesh = self.session.preview
            meta = dict(self.session.preview_meta)
            if mesh is None:
                return None
            stamp = meta.get("stop", -1)
            if self._preview_cache is None \
                    or self._preview_cache[0] != stamp:
                buf = io.BytesIO()
                write_stl(buf, mesh)
                self._preview_cache = (stamp, buf.getvalue())
            return self._preview_cache[1], meta

    def status_dict(self) -> dict:
        with self.lock:
            out = {"session_id": self.session_id,
                   "stops_submitted": self.stops_submitted,
                   "age_s": round(time.monotonic() - self.created_t, 3),
                   **self.session.status_dict()}
            if self.lane is not None:
                out["device_lane"] = self.lane.label
                out["lane_moves"] = self.lane_moves
            if self.result_job_id is not None:
                out["result_job_id"] = self.result_job_id
            return out


class SessionManager:
    """Bounded registry of streaming sessions."""

    def __init__(self, stream_params: StreamParams, proj,
                 decode_cfg, tri_cfg, max_sessions: int = 8,
                 session_ttl_s: float = 3600.0, store=None,
                 preview_shed=None, replica_id: str | None = None,
                 lane_pool=None, device=None):
        self.stream_params = stream_params
        # The device sessions without a sticky lane are built on (None
        # means the card).
        self.device = resolve_device(device)
        self.proj = proj
        self.decode_cfg = decode_cfg
        self.tri_cfg = tri_cfg
        self.max_sessions = max(1, int(max_sessions))
        self.session_ttl_s = float(session_ttl_s)
        # Durability journal (serve/store.py): session creations and
        # endings are appended so `--recover` rebuilds exactly the live
        # set. None = durability off.
        self.store = store
        self.preview_shed = preview_shed
        # Sticky device-lane placement (serve/lanes.py): sessions are
        # assigned the least-loaded lane at create/restore and release
        # it when they leave the registry. None = no lane dimension.
        self.lane_pool = lane_pool
        # Fleet tier: journaled session heads carry the replica id, so
        # handoff-aware recovery can compare the WAL's claim against the
        # shared stream's current owner (serve/store.py).
        self.replica_id = replica_id
        self._lock = threading.Lock()
        self._sessions: OrderedDict[str, ServeSession] = OrderedDict()

    # ------------------------------------------------------------------

    def _params_for(self, options: dict) -> StreamParams:
        import dataclasses

        bad = sorted(set(options) - set(SESSION_OPTION_KEYS))
        if bad:
            raise StackFormatError(
                f"unknown session option(s) {bad}; allowed: "
                f"{sorted(SESSION_OPTION_KEYS)}")
        overrides = {}
        for k in SESSION_OPTION_KEYS:
            if k in options and options[k] is not None:
                overrides[k] = options[k]
        if "method" in overrides \
                and overrides["method"] not in ("sequential", "posegraph"):
            raise StackFormatError(
                f"method must be 'sequential' or 'posegraph', got "
                f"{overrides['method']!r}")
        if "representation" in overrides \
                and overrides["representation"] not in ("poisson", "tsdf",
                                                        "splat",
                                                        "archival"):
            raise StackFormatError(
                f"representation must be 'poisson', 'tsdf', 'splat' or "
                f"'archival', got {overrides['representation']!r}")
        for k in ("preview_every", "preview_depth", "final_depth",
                  "expected_stops"):
            if k in overrides:
                try:
                    overrides[k] = int(overrides[k])
                except (TypeError, ValueError):
                    raise StackFormatError(f"session option {k!r} must "
                                           f"be an int")
        if "covis" in overrides:
            overrides["covis"] = bool(overrides["covis"])
        return dataclasses.replace(self.stream_params, **overrides)

    def create(self, options: dict | None = None,
               session_id: str | None = None,
               scan_id: str | None = None,
               journal: bool = True) -> ServeSession:
        options = dict(options or {})
        params = self._params_for(options)
        sid = session_id or uuid.uuid4().hex[:12]
        lane = (self.lane_pool.assign_session(sid)
                if self.lane_pool is not None else None)
        session = IncrementalSession(
            calib=None,  # serve stops arrive pre-decoded via the batcher
            col_bits=self.proj.col_bits, row_bits=self.proj.row_bits,
            params=params, decode_cfg=self.decode_cfg,
            tri_cfg=self.tri_cfg, scan_id=scan_id or f"serve-{sid}",
            device=lane.device if lane is not None else self.device)
        entry = ServeSession(sid, session, bucket_pixels=0,
                             preview_shed=self.preview_shed, lane=lane)
        expired: list[str] = []
        evicted: list[str] = []
        with self._lock:
            # Idle-TTL expiry first — an abandoned (crashed-client) live
            # session must free its slot and model buffers, not pin them
            # forever.
            now = time.monotonic()
            expired = [k for k, s in self._sessions.items()
                       if now - s.last_t > self.session_ttl_s]
            for k in expired:
                del self._sessions[k]
            live = sum(1 for s in self._sessions.values()
                       if not s.session.finalized)
            if live >= self.max_sessions:
                if self.lane_pool is not None:  # undo the assignment
                    self.lane_pool.release_session(sid)
                raise SessionLimitError(self.max_sessions)
            self._sessions[sid] = entry
            # Evict oldest FINALIZED sessions past the cap (their result
            # already lives in the job registry).
            done = [k for k, s in self._sessions.items()
                    if s.session.finalized]
            excess = len(self._sessions) - self.max_sessions
            for k in done[:max(0, excess)]:
                del self._sessions[k]
                evicted.append(k)
        # Both eviction paths journal a flight event CARRYING THE SESSION
        # ID (and the durability journal's session_end), so a vanished
        # session is attributable in a `cli diagnose` bundle instead of
        # silently 404ing.
        for k in expired:
            if self.lane_pool is not None:
                self.lane_pool.release_session(k)
            events.record("session_expired", session_id=k,
                          severity="warning", reason="idle_ttl",
                          ttl_s=self.session_ttl_s)
            self._journal_end(k, "idle_ttl")
        for k in evicted:
            if self.lane_pool is not None:
                self.lane_pool.release_session(k)
            events.record("session_evicted", session_id=k,
                          severity="warning", reason="finalized_cap",
                          max_sessions=self.max_sessions)
            self._journal_end(k, "finalized_cap")
        events.record("session_created", scan_id=session.scan_id,
                      session_id=sid)
        if journal and self.store is not None:
            self.store.append({"op": "session", "session_id": sid,
                               "scan_id": session.scan_id,
                               "options": options,
                               "replica": self.replica_id})
        return entry

    def restore(self, session_id: str, options: dict,
                scan_id: str) -> ServeSession:
        """Recreate a journaled session during recovery: same id, same
        scan id, same options (⇒ same params/key schedule — the bitwise
        replay contract), WITHOUT re-journaling its creation."""
        return self.create(options, session_id=session_id,
                           scan_id=scan_id, journal=False)

    def _journal_end(self, session_id: str, reason: str) -> None:
        # The ending replica's id rides the op: the handoff sink
        # ignores an end from a NON-owner (a stale double-hosted copy
        # expiring after its session was adopted elsewhere). Always
        # SYNC: once this replica denies the session, the definitive-404
        # contract needs the end tombstone ON the handoff stream before
        # the router's adoption sweep can read it (a lazy end let a
        # survivor "adopt" the half-ended stream) — and every caller is
        # already on a path that blocks on a sync WAL append anyway.
        if self.store is not None:
            self.store.append({"op": "session_end",
                               "session_id": session_id,
                               "reason": reason,
                               "replica": self.replica_id})

    def get(self, session_id: str) -> ServeSession:
        with self._lock:
            entry = self._sessions.get(session_id)
        if entry is None:
            raise UnknownSessionError(
                f"unknown session {session_id!r} (never created, "
                "or evicted after finalize)")
        return entry

    def peek(self, session_id: str) -> ServeSession | None:
        """``get`` without the raise — the device-loss re-pin and lane
        resolution paths probe sessions that may have ended."""
        with self._lock:
            return self._sessions.get(session_id)

    def delete(self, session_id: str) -> None:
        with self._lock:
            entry = self._sessions.pop(session_id, None)
        if entry is None:
            raise UnknownSessionError(f"unknown session {session_id!r}")
        if self.lane_pool is not None:
            self.lane_pool.release_session(session_id)
        events.record("session_deleted", session_id=session_id,
                      stops_fused=entry.session.stops_fused)
        self._journal_end(session_id, "deleted")

    def stats(self) -> dict:
        with self._lock:
            entries = list(self._sessions.values())
        return {
            "sessions": len(entries),
            "live": sum(1 for e in entries
                        if not e.session.finalized),
            "max_sessions": self.max_sessions,
        }
