"""Job model + bounded admission queue.

The queue is the service's ONLY growth point, so it is bounded by
construction: over-admission is rejected at submit time with a retryable
status and a ``retry_after_s`` hint (computed from queue depth × the
observed per-job service EMA), never buffered. That is the AGS admission
rule (PAPERS.md: covisibility-gated frame admission — drop at the door,
not in the middle of the pipeline) applied to a reconstruction RPC.

Service-side faults subclass the PR-3 :class:`~..health.ScanFault`
taxonomy: the status payload of a failed job carries the same error
vocabulary (``CaptureError``/``StopQualityError``/…) that `scan-360`
health reports use, so a client can tell a malformed upload from a
decode-quality failure from an overloaded queue without parsing prose.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
import uuid

import numpy as np

from ..config import DecodeConfig, TriangulationConfig
from ..health import CaptureError, ScanFault
from ..utils import events
from ..utils.log import get_logger

log = get_logger(__name__)


# ---------------------------------------------------------------------------
# Error taxonomy (service-side extensions of health.ScanFault)
# ---------------------------------------------------------------------------


class ServeError(ScanFault):
    """Base of the service-side fault vocabulary."""


class JobRejected(ServeError):
    """The job never entered the queue (full, closed, or malformed).

    ``retryable`` distinguishes "try again later" (backpressure) from
    "fix your request" (malformed stack). Rejections are designed flow
    control, not failures: they journal as warnings (``flight_severity``)
    so an overload burst — hundreds of constructions per second — never
    wraps the flight ring past genuine fault history or storms the
    dump-on-fault directory."""

    retryable = False
    flight_severity = "warning"


class QueueFullError(JobRejected):
    """Bounded queue at capacity — retry after ``retry_after_s``."""

    retryable = True

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(
            f"admission queue full ({depth} jobs); retry in "
            f"{retry_after_s:.2f}s")
        self.retry_after_s = retry_after_s


class QueueClosedError(JobRejected):
    """Service is draining (SIGTERM) — in-flight jobs finish, new work is
    refused."""

    retryable = True

    def __init__(self):
        super().__init__("service is draining; submit to another replica")
        self.retry_after_s = None


class StackFormatError(CaptureError, JobRejected):
    """Malformed capture stack (dtype/rank/frame-count/size) — the upload
    analogue of a truncated frame file, hence a ``CaptureError``."""


class DeadlineExceededError(ServeError):
    """The job's deadline lapsed before a worker could start it."""


def error_payload(exc: BaseException) -> dict:
    """Status-payload form of a fault: concrete type + the taxonomy chain
    (most-derived first) so clients can match on any ancestor they know."""
    taxonomy = [c.__name__ for c in type(exc).__mro__
                if issubclass(c, ScanFault)]
    out = {"type": type(exc).__name__, "message": str(exc),
           "taxonomy": taxonomy or ["Exception"]}
    retry = getattr(exc, "retry_after_s", None)
    if retry is not None:
        out["retry_after_s"] = round(float(retry), 3)
    return out


# ---------------------------------------------------------------------------
# Job
# ---------------------------------------------------------------------------

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"


@dataclasses.dataclass(eq=False)  # identity equality: a job IS its object
class Job:
    """One reconstruction request: a capture stack in, a PLY/STL out.

    Mutable state (status, result, error) is guarded by ``_lock``;
    ``wait`` blocks on the terminal event. Timestamps are monotonic
    (queue-wait / batch-wait / run are per-stage latencies on /metrics).
    """

    stack: np.ndarray                 # (F, H, W) uint8 capture stack
    col_bits: int
    row_bits: int
    decode_cfg: DecodeConfig = DecodeConfig()
    tri_cfg: TriangulationConfig = TriangulationConfig()
    downsample: int = 1
    result_format: str = "ply"        # "ply" | "stl"
    priority: int = 1                 # 0 high, 1 normal, 2 low
    deadline_s: float | None = None   # seconds from submit; None = no limit
    job_id: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex[:16])

    # -- lifecycle state (lock-guarded) ------------------------------------
    status: str = QUEUED
    error: dict | None = None
    result_bytes: bytes | None = None
    result_meta: dict = dataclasses.field(default_factory=dict)
    # Terminal observer (set by the service before admission): called once
    # with the job after complete/fail, WHEREVER the transition happens —
    # worker postprocess, batch-scoped failure, or deadline scrub in the
    # queue/batcher. Keeps the jobs_total{done,failed} counters conserved
    # against submitted without every layer knowing the registry.
    on_terminal: "callable | None" = dataclasses.field(
        default=None, repr=False)
    # Streaming interop (serve/sessions.py): when set, the worker hands
    # this job's decoded dense arrays (points, colors, valid — the
    # per-job batch lanes) to the sink instead of building a PLY/STL;
    # the sink's dict return becomes the job's result meta and JSON
    # payload. Session stops ride the SAME queue → batcher → program
    # cache as one-shot jobs, so they coalesce into the same batches.
    decode_sink: "callable | None" = dataclasses.field(
        default=None, repr=False)
    # Durability plumbing (serve/store.py): the content-hash cache key of
    # this job's artifact (None = uncacheable, e.g. session stops), and
    # which journal vocabulary its terminal transition appends under
    # ("job" — one-shot, recoverable; "stop" and None journal nothing at
    # terminal: stops are tracked per session, synthesized jobs not at
    # all). ``recovered`` marks a job re-queued from the journal.
    content_key: str | None = dataclasses.field(default=None, repr=False)
    journal_kind: str | None = dataclasses.field(default=None, repr=False)
    session_id: str | None = dataclasses.field(default=None, repr=False)
    recovered: bool = dataclasses.field(default=False, repr=False)
    # Device-lane affinity (serve/lanes.py): None = any worker may take
    # this job; an index pins it to that lane's pending buckets so a
    # streaming session's stops always run on the session's STICKY
    # device (its state lives there and was warmed there).
    lane: int | None = dataclasses.field(default=None, repr=False)
    # Device-loss retries: how many times this job's batch died under it
    # with a device-class fault and was re-queued onto another lane
    # (serve/worker.py). Bounded — past the pool's live-device count the
    # job fails honestly instead of ping-ponging between sick chips.
    launch_retries: int = dataclasses.field(default=0, repr=False)
    # Deferred NaN attribution (serve/worker.py): the lane whose launch
    # returned NaN under this job, pending the cross-lane retry's
    # verdict — clean elsewhere convicts the chip, NaN elsewhere
    # convicts the data.
    nan_lane: str | None = dataclasses.field(default=None, repr=False)

    submitted_t: float = 0.0
    started_t: float | None = None
    finished_t: float | None = None

    def __post_init__(self):
        self._lock = threading.Lock()
        self._terminal = threading.Event()
        self.submitted_t = time.monotonic()

    # ------------------------------------------------------------------

    @property
    def deadline_t(self) -> float | None:
        if self.deadline_s is None:
            return None
        return self.submitted_t + self.deadline_s

    def expired(self, now: float | None = None) -> bool:
        dl = self.deadline_t
        return dl is not None and (now or time.monotonic()) > dl

    # ------------------------------------------------------------------

    def mark_running(self) -> None:
        with self._lock:
            self.status = RUNNING
            self.started_t = time.monotonic()

    def complete(self, result: bytes, **meta) -> None:
        with self._lock:
            if self._terminal.is_set():
                return  # first terminal transition wins
            self.status = DONE
            self.result_bytes = result
            self.result_meta.update(meta)
            self.finished_t = time.monotonic()
            # Release the input stack: terminal jobs stay registered for
            # /status///result polling (completed_cap of them), and at
            # 1080p each stack is ~95 MB — keeping them would let the
            # registry pin tens of GB of dead inputs.
            self.stack = None
        self._terminal.set()
        if self.on_terminal is not None:
            self.on_terminal(self)

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._terminal.is_set():
                return
            self.status = FAILED
            self.error = error_payload(exc)
            self.finished_t = time.monotonic()
            self.stack = None  # same release rule as complete()
        self._terminal.set()
        if self.on_terminal is not None:
            self.on_terminal(self)

    def release_result(self) -> int:
        """Drop the retained result payload (registry byte-budget
        eviction); returns bytes freed. The job entry itself survives, so
        /status stays truthful and /result can answer an explicit 410
        instead of a silent unknown-job 404."""
        with self._lock:
            n = len(self.result_bytes) if self.result_bytes else 0
            self.result_bytes = None
            if n:
                self.result_meta["result_evicted"] = True
        return n

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the job reaches a terminal state."""
        return self._terminal.wait(timeout)

    # ------------------------------------------------------------------

    def status_dict(self) -> dict:
        with self._lock:
            # Queue wait ends at start, or at the terminal transition for
            # jobs that never started (deadline scrub) — "now" only while
            # genuinely still waiting, else the number grows forever.
            wait_end = (self.started_t or self.finished_t
                        or time.monotonic())
            out = {
                "job_id": self.job_id,
                "status": self.status,
                "result_format": self.result_format,
                "priority": self.priority,
                "queue_wait_s": round(wait_end - self.submitted_t, 4),
            }
            if self.started_t is not None and self.finished_t is not None:
                out["run_s"] = round(self.finished_t - self.started_t, 4)
            if self.error is not None:
                out["error"] = dict(self.error)
            if self.status == DONE:
                out["result"] = dict(self.result_meta)
        return out


# ---------------------------------------------------------------------------
# Bounded admission queue
# ---------------------------------------------------------------------------


class AdmissionQueue:
    """Thread-safe bounded priority queue with deadline scrubbing.

    Ordering is (priority, arrival) — starvation-free within a priority
    class. ``submit`` never blocks and never grows past ``max_depth``:
    at capacity it raises :class:`QueueFullError` whose ``retry_after_s``
    is depth × the EMA of observed per-job service time (workers feed the
    EMA via :meth:`observe_service_time`), i.e. an honest estimate of when
    a slot frees up. ``close`` flips the queue into drain mode: pops still
    serve (in-flight work finishes), submits are refused.
    """

    def __init__(self, max_depth: int = 64,
                 default_service_s: float = 0.25):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._heap: list = []
        self._seq = itertools.count()
        self._closed = False
        self._service_ema_s = default_service_s

    # ------------------------------------------------------------------

    def check_admission(self) -> None:
        """Raise the rejection `submit` WOULD raise right now, without
        enqueueing. Advisory (another submitter can win the race), but it
        lets a transport reject an oversized upload at headers time
        instead of buffering ~95 MB per connection just to say 429 —
        `submit` remains the authoritative gate."""
        with self._lock:
            self._check_admission_locked()

    def _check_admission_locked(self) -> None:
        if self._closed:
            raise QueueClosedError()
        if len(self._heap) >= self.max_depth:
            retry = max(0.05, len(self._heap) * self._service_ema_s)
            raise QueueFullError(len(self._heap), retry)

    def submit(self, job: Job) -> None:
        with self._lock:
            self._check_admission_locked()
            heapq.heappush(self._heap,
                           (job.priority, next(self._seq), job))
            self._not_empty.notify()

    def pop(self, timeout: float | None = None) -> Job | None:
        """Next admissible job, or None on timeout. Jobs whose deadline
        lapsed while queued are failed (DeadlineExceededError) and skipped
        — a worker never spends a batch slot on work nobody is waiting
        for. The fail itself runs OUTSIDE the queue lock: constructing
        the fault records a flight event and may write a dump-on-fault
        journal, and that disk I/O must never stall every submitter and
        worker contending for this lock."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            job: Job | None = None
            expired: list[Job] = []
            timed_out = False
            with self._not_empty:
                while True:
                    while self._heap:
                        _, _, j = heapq.heappop(self._heap)
                        if j.expired():
                            expired.append(j)
                            continue
                        job = j
                        break
                    if job is not None or expired:
                        break  # fail the scrubbed jobs lock-free first
                    if deadline is None:
                        self._not_empty.wait()
                    else:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            timed_out = True
                            break
                        self._not_empty.wait(remaining)
            for j in expired:
                # Context so the fault event the constructor records
                # carries the scrubbed job's id.
                with events.context(job_id=j.job_id):
                    j.fail(DeadlineExceededError(
                        f"deadline {j.deadline_s:.2f}s lapsed after "
                        f"{time.monotonic() - j.submitted_t:.2f}s "
                        "in queue"))
            if job is not None or timed_out:
                return job

    # ------------------------------------------------------------------

    def observe_service_time(self, seconds: float) -> None:
        """EMA update from a worker's measured per-job latency — feeds the
        retry-after hint."""
        with self._lock:
            self._service_ema_s = (0.8 * self._service_ema_s
                                   + 0.2 * max(1e-3, seconds))

    def retry_hint(self) -> float:
        """Honest retry-after estimate at the CURRENT depth (what a
        QueueFullError would carry) — for rejections decided outside the
        queue, e.g. the overload governor's shedding tiers."""
        with self._lock:
            return max(0.05, max(1, len(self._heap)) * self._service_ema_s)

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)

    def set_max_depth(self, max_depth: int) -> int:
        """Re-bound the queue (the device-loss tier's degraded-capacity
        honesty: a pool at N−1 chips advertises — and enforces — N−1
        chips' worth of admission headroom). Already-admitted jobs above
        a shrunken bound are NOT scrubbed (they were acked); the bound
        re-engages as they drain. Returns the new bound."""
        with self._lock:
            self.max_depth = max(1, int(max_depth))
            return self.max_depth

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
