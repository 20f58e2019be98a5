"""Scan orchestration: capture workflows over the hardware abstractions
(the port's copy of the JAX package's ``scanner.py``; host code, nothing
here runs on the card).

Headless equivalent of the reference's L5/L3 capture machinery — the Tkinter
GUI's worker-thread workflows (`server/gui.py`) and ``SLSystem``'s
display-then-trigger loops (`server/sl_system.py:114-182,422-481`) — written
against the :mod:`.hw` interfaces so the same code drives a physical rig
(window projector + phone + ESP32) or the virtual one (:class:`~.hw.rig
.VirtualRig`). No UI thread: callers run it directly or on their own worker.

Workflows:

* :meth:`Scanner.capture_stack` — project the protocol-ordered frame stack
  (white, black, then col/row bit pattern+inverse pairs —
  `server/sl_system.py:133-150,436-470`), capturing one camera image per
  frame into ``{idx:02d}.png``. Where the reference aborts the whole scan on
  the FIRST capture timeout (`server/sl_system.py:468-471`), each frame is
  retried under a :class:`RetryPolicy` (deterministic backoff, re-projection
  before every retry) and verified on disk (a truncated upload is a failed
  capture, not a poison pill for the decoder); only an exhausted frame
  raises.
* :meth:`Scanner.capture_calibration_pose` — the same stack at the
  calibration dwell into ``calib/pose_N/`` (`server/sl_system.py:114-182`).
* :meth:`Scanner.auto_scan_360` — the flagship loop (`server/gui.py:686-773`):
  capture a stop, rotate, wait for DONE (warn-but-continue on timeout,
  `server/gui.py:760-762`), settle, repeat; with per-stop progress timing
  (`server/gui.py:727-731`), RESUME (stops whose folders already hold a full
  stack are skipped, `io/layout.completed_stops`) and per-stop failure
  containment: a stop that exhausts its capture attempts is recorded in the
  :class:`~.health.ScanHealthReport` and SKIPPED — the turntable still
  advances, so the remaining stops land at their correct angles and the
  downstream gates (`models/scan360`) bridge the ring across the hole.

Error taxonomy: every failure raises a :class:`~.health.ScanFault` subclass
(:class:`ScanAborted` for exhausted captures, :class:`~.hw.turntable
.TurntableError` for the serial layer) so orchestration can contain scan
faults without masking programming errors.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
import uuid
from typing import Callable

import numpy as np

from .config import ProjectorConfig
from .health import CaptureError, ScanHealthReport
from .io.layout import SessionLayout, frame_name
from .ops.patterns import pattern_stack_for
from .utils import events
from .utils.log import get_logger

log = get_logger(__name__)

SCAN_DWELL_MS = 200    # server/sl_system.py:465
CALIB_DWELL_MS = 250   # server/sl_system.py:172
SETTLE_S = 0.5         # server/gui.py:763
ROTATE_TIMEOUT_S = 10.0  # server/gui.py:760


class ScanAborted(CaptureError):
    """A frame capture failed after all retries — the stack is incomplete
    and unusable."""


@dataclasses.dataclass(frozen=True)
class ScanTimings:
    """Every wall-clock constant of the capture loop in one place, so
    chaos tests and :class:`~.hw.rig.VirtualRig` runs can shrink them to
    ~zero instead of sleeping real time. Defaults are the reference's."""

    scan_dwell_ms: int = SCAN_DWELL_MS      # server/sl_system.py:465
    calib_dwell_ms: int = CALIB_DWELL_MS    # server/sl_system.py:172
    settle_s: float = SETTLE_S              # server/gui.py:763
    rotate_timeout_s: float = ROTATE_TIMEOUT_S  # server/gui.py:760


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capture retry knobs. Backoff is DETERMINISTIC (no jitter): chaos
    schedules and their health reports replay bit-identically.

    ``frame_attempts`` is per-frame scope (a flaky frame is re-projected
    and re-captured in place); ``stop_attempts`` is per-stop scope (a stop
    whose frame exhausts its attempts is re-captured from the top that
    many times before the stop is declared failed).
    """

    frame_attempts: int = 3
    stop_attempts: int = 2
    backoff_s: float = 0.1
    backoff_factor: float = 2.0

    def backoff(self, attempt: int) -> float:
        """Delay before retry ``attempt + 1`` (attempt is 0-based)."""
        return self.backoff_s * self.backoff_factor ** attempt


@dataclasses.dataclass
class ScanProgress:
    """Per-stop timing surfaced to UIs (`server/gui.py:727-731`)."""

    stop: int
    total_stops: int
    elapsed_s: float
    avg_stop_s: float
    remaining_s: float


def frame_file_ok(path: str) -> bool:
    """Cheap on-disk verification of a captured frame: exists, non-empty,
    and the container's end-of-stream marker is present — a truncated
    upload (connection dropped mid-POST) fails here and is retried as a
    capture failure instead of crashing the decoder later.

    Sniffs CONTENT, not the extension: the phone cameras write the
    uploaded JPEG bytes verbatim to whatever path the protocol names
    (``{idx:02d}.png`` — `hw/camera.py`, `hw/command_server.py`), and the
    stack loader is equally content-agnostic. PNG needs its IEND chunk,
    JPEG its EOI marker; unknown containers pass on the size check alone.
    """
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    if size == 0:
        return False
    with open(path, "rb") as f:
        head = f.read(8)
        f.seek(max(0, size - 32))
        tail = f.read()
    if head.startswith(b"\x89PNG\r\n\x1a\n"):
        return b"IEND" in tail
    if head.startswith(b"\xff\xd8"):
        return b"\xff\xd9" in tail
    return True


class Scanner:
    def __init__(
        self,
        camera,
        projector,
        turntable=None,
        proj: ProjectorConfig = ProjectorConfig(),
        layout: SessionLayout | None = None,
        settle_s: float | None = None,
        timings: ScanTimings | None = None,
        retry: RetryPolicy | None = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.camera = camera
        self.projector = projector
        self.turntable = turntable
        self.proj = proj
        self.layout = layout or SessionLayout.today().ensure()
        self.timings = timings or ScanTimings()
        # settle_s kept as a direct override for existing callers; the
        # timings dataclass is the one source of defaults.
        if settle_s is not None:
            self.timings = dataclasses.replace(self.timings,
                                               settle_s=settle_s)
        self.retry = retry or RetryPolicy()
        self._sleep = sleep
        self._frames: np.ndarray | None = None

    @property
    def settle_s(self) -> float:
        return self.timings.settle_s

    def _pattern_frames(self) -> np.ndarray:
        if self._frames is None:
            # What the projector displays: host uint8 frames, whatever
            # device the reconstruction runs on.
            # torchlint: disable=host-read -- made on the host (device="cpu")
            self._frames = pattern_stack_for(self.proj, device="cpu").numpy()
        return self._frames

    # ------------------------------------------------------------------
    # Single-stop capture
    # ------------------------------------------------------------------

    def _capture_frame(self, frame: np.ndarray, path: str, dwell_ms: int,
                       stop_health=None) -> None:
        """One frame under the retry policy: project, capture, verify; on
        failure back off deterministically, re-project, retry. Raises
        :class:`ScanAborted` when the policy is exhausted."""
        for attempt in range(self.retry.frame_attempts):
            if attempt > 0:
                self._sleep(self.retry.backoff(attempt - 1))
            self.projector.show(frame, dwell_ms=dwell_ms)
            if self.camera.capture(path) and frame_file_ok(path):
                if attempt > 0 and stop_health is not None:
                    stop_health.retries += attempt
                return
            log.warning("capture attempt %d/%d failed (%s)", attempt + 1,
                        self.retry.frame_attempts, path)
            events.record(
                "capture_retry", severity="warning",
                message=f"attempt {attempt + 1}/"
                        f"{self.retry.frame_attempts} failed",
                frame=os.path.basename(path), attempt=attempt)
            if stop_health is not None:
                stop_health.faults.append(
                    f"{os.path.basename(path)}:attempt{attempt}")
        raise ScanAborted(
            f"capture failed after {self.retry.frame_attempts} attempts "
            f"({path})")

    def capture_stack(self, out_dir: str, dwell_ms: int | None = None,
                      ext: str = "png", stop_health=None) -> list[str]:
        """Project every protocol frame and capture it to
        ``out_dir/{idx:02d}.{ext}`` (1-based numbering like the reference's
        `{idx:02d}` scheme, `server/sl_system.py:436-451`). ``dwell_ms``
        defaults to ``timings.scan_dwell_ms``."""
        if dwell_ms is None:
            dwell_ms = self.timings.scan_dwell_ms
        os.makedirs(out_dir, exist_ok=True)
        frames = self._pattern_frames()
        paths = []
        for i, frame in enumerate(frames):
            path = os.path.join(out_dir, frame_name(i + 1, ext))
            self._capture_frame(frame, path, dwell_ms,
                                stop_health=stop_health)
            paths.append(path)
        return paths

    def capture_scan(self, name: str, dwell_ms: int | None = None
                     ) -> str:
        """One scan folder under ``scans/`` (`SLSystem.capture_scan`,
        `server/sl_system.py:422-481`). Returns the folder path."""
        out = self.layout.scan_dir(name)
        self.capture_stack(out, dwell_ms=dwell_ms)
        log.info("scan %s captured (%d frames)", name,
                 self.proj.n_frames)
        return out

    def capture_calibration_pose(self, pose: int,
                                 dwell_ms: int | None = None) -> str:
        """One checkerboard pose under ``calib/pose_N/``
        (`SLSystem.capture_calibration`, `server/sl_system.py:114-182`).
        ``dwell_ms`` defaults to ``timings.calib_dwell_ms``."""
        out = self.layout.pose_dir(pose)
        self.capture_stack(out, dwell_ms=self.timings.calib_dwell_ms
                           if dwell_ms is None else dwell_ms)
        log.info("calibration pose %d captured", pose)
        return out

    # ------------------------------------------------------------------
    # Auto 360°
    # ------------------------------------------------------------------

    def _capture_stop(self, out: str, dwell_ms: int, stop_health) -> bool:
        """One stop under the per-stop retry scope. True on success; False
        when the stop is declared failed (recorded, never raised — the 360°
        loop skips it and keeps going)."""
        for stop_attempt in range(self.retry.stop_attempts):
            stop_health.stop_attempts = stop_attempt + 1
            try:
                self.capture_stack(out, dwell_ms=dwell_ms,
                                   stop_health=stop_health)
                return True
            except CaptureError as e:
                log.warning("stop capture attempt %d/%d failed: %s",
                            stop_attempt + 1, self.retry.stop_attempts, e)
        stop_health.status = "failed"
        # Scrub the partial stack: a folder with SOME frames would be
        # picked up by downstream folder scans (`cli/scan_360.has_frames`)
        # and crash the ragged np.stack — and resume treats any incomplete
        # folder as "recapture me" either way.
        removed = 0
        for ext in ("png", "jpg", "jpeg", "bmp"):
            for f in glob.glob(os.path.join(out, f"*.{ext}")):
                try:
                    os.remove(f)
                    removed += 1
                except OSError:
                    pass
        if removed:
            log.info("scrubbed %d partial frames from failed stop %s",
                     removed, out)
        return False

    def auto_scan_360(
        self,
        base_name: str,
        degrees_per_turn: float = 30.0,
        turns: int = 12,
        dwell_ms: int | None = None,
        resume: bool = True,
        on_progress: Callable[[ScanProgress], None] | None = None,
        health: ScanHealthReport | None = None,
        scan_id: str | None = None,
        on_stop: Callable[[int, str], None] | None = None,
    ) -> list[str]:
        """The flagship capture loop (`server/gui.py:686-773`). Returns the
        list of per-stop folders (``{base}_{angle}deg_scan``) that hold a
        COMPLETE stack — a stop that exhausts its retry budget is recorded
        in ``health``, skipped, and excluded from the return value (the
        turntable still advances past it). Raises :class:`ScanAborted` only
        when EVERY stop failed.

        Without a turntable the rotation is skipped entirely and the caller
        is expected to turn the object — the reference's "Simulation mode"
        prompt (`server/gui.py:690-693`) maps to passing a
        :class:`~.hw.turntable.SimulatedTurntable`.

        Resume contract: rotations are RELATIVE, and the loop still rotates
        through skipped stops, so a resumed session recaptures missing stops
        at the correct angles iff the turntable starts at the 0° home
        position (re-home the table — or restart the virtual rig, whose
        simulated table boots at 0°).

        ``on_stop`` is the STREAMING hook (docs/STREAMING.md): called with
        ``(stop_index, folder)`` the moment a stop's complete stack is on
        disk (captured or resumed) — feed it to a
        `stream.IncrementalSession` to fuse stops while the turntable is
        still moving. Consumer failures are CONTAINED (logged + journaled);
        a broken preview pipeline must never abort a 20-minute capture.
        """
        health = health if health is not None else ScanHealthReport()
        scan_id = scan_id or uuid.uuid4().hex[:12]
        health.scan_id = scan_id
        done_before = set(
            self.layout.completed_stops(base_name, degrees_per_turn,
                                        self.proj.n_frames)
            if resume else [])
        t0 = time.monotonic()
        stops = []
        captured = 0
        events.record("scan_started", scan_id=scan_id, base=base_name,
                      turns=turns, step_deg=degrees_per_turn)
        for i in range(turns):
            angle = i * degrees_per_turn
            out = self.layout.stop_dir(base_name, degrees_per_turn, angle)
            rec = health.stop(i, angle_deg=angle)
            # Correlation context: every event (and ScanFault) out of this
            # stop's capture — frame retries, exhausted stops — carries
            # the scan_id + stop index into the flight journal.
            with events.context(scan_id=scan_id, stop=i):
                landed = False
                if out in done_before:
                    log.info("stop %d/%d (%.0f°) already complete — "
                             "resumed past", i + 1, turns, angle)
                    rec.status = "resumed"
                    stops.append(out)
                    landed = True
                elif self._capture_stop(out, dwell_ms, rec):
                    captured += 1
                    stops.append(out)
                    landed = True
                else:
                    log.error("stop %d/%d (%.0f°) failed after %d stop "
                              "attempts — skipping (degraded ring)", i + 1,
                              turns, angle, self.retry.stop_attempts)
                    events.record(
                        "stop_failed", severity="error",
                        message=f"stop {i} exhausted "
                                f"{self.retry.stop_attempts} attempts",
                        angle_deg=angle)

                if landed and on_stop is not None:
                    try:
                        on_stop(i, out)
                    except Exception as e:
                        # Containment: the streaming consumer (fusion,
                        # previews) is best-effort relative to capture.
                        log.warning("on_stop consumer failed at stop %d:"
                                    " %s", i, e)
                        events.record("stream_consumer_failed",
                                      severity="warning", message=str(e),
                                      exc_type=type(e).__name__)

                if on_progress is not None:
                    elapsed = time.monotonic() - t0
                    avg = elapsed / max(captured, 1)
                    remaining = avg * sum(
                        1 for j in range(i + 1, turns)
                        if self.layout.stop_dir(base_name, degrees_per_turn,
                                                j * degrees_per_turn)
                        not in done_before)
                    on_progress(ScanProgress(i + 1, turns, elapsed, avg,
                                             remaining))

                if i < turns - 1 and self.turntable is not None:
                    self.turntable.rotate(degrees_per_turn)
                    if not self.turntable.wait_for_done(
                            self.timings.rotate_timeout_s):
                        log.warning("rotation %d DONE timeout — continuing",
                                    i)
                        events.record("rotate_timeout", severity="warning",
                                      angle_deg=angle)
                        health.rotate_timeouts += 1
                    self._sleep(self.timings.settle_s)
        if not stops:
            raise ScanAborted(
                f"auto 360 failed: all {turns} stops exhausted their "
                f"capture attempts")
        if health.failed_stops:
            health.note("auto 360 degraded: stops %s failed and were "
                        "skipped", health.failed_stops)
        log.info("auto 360 complete: %d/%d stops (%d captured, %d resumed, "
                 "%d failed) in %.1fs", len(stops), turns, captured,
                 len(done_before & set(stops)), len(health.failed_stops),
                 time.monotonic() - t0)
        events.record("scan_finished", scan_id=scan_id,
                      stops_ok=len(stops),
                      stops_failed=len(health.failed_stops),
                      elapsed_s=round(time.monotonic() - t0, 3))
        return stops
