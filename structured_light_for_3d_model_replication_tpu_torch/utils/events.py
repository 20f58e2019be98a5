"""Flight recorder: a correlated, bounded journal of structured events.

Logs answer "what did the process print"; the flight recorder answers
"what happened to THIS scan/job, in order, just before it died". It is a
thread-safe ring buffer of structured :class:`Event` records, each
stamped with wall + monotonic time, a severity, and whatever correlation
fields (``scan_id``/``job_id``/``stop``/…) were ambient when it was
recorded:

* :func:`context` — a ``contextvars``-scoped correlation context.
  ``with events.context(scan_id=sid, stop=3): ...`` tags every event
  (and, via `utils.trace`, every span) recorded inside the block. Worker
  threads establish their own context (contextvars are per-thread), so
  concurrent jobs never cross-tag.
* :func:`record` — append one event to the global recorder. O(1), lock
  + deque append; cheap enough for per-frame retry paths.
* **dump-on-fault** — :class:`~..health.ScanFault` construction calls
  :func:`fault` (see `health.py`), so every taxonomy raise — capture
  retry exhaustion, gate rejection, serve containment — lands in the
  journal with its correlation fields; when a dump directory is
  configured (:func:`set_dump_dir` or ``SL_TPU_FLIGHT_DUMP_DIR``), the
  last-N events that led to the fault are written as JSONL next to it.

The ring is bounded by construction (default 4096 events): a week-long
serve process pays a fixed few MB, never a leak. Severity counts are
mirrored into the metrics registry (``sl_events_total{severity=…}``) so
a fault burst is visible on /metrics even after the ring has wrapped.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import json
import os
import threading
import time

from .log import get_logger

log = get_logger(__name__)

#: Severities, least to most alarming. "fault" is reserved for taxonomy
#: raises (ScanFault construction) — the dump-on-fault trigger.
SEVERITIES = ("debug", "info", "warning", "error", "fault")

_CONTEXT: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "sl_event_context", default=())


@contextlib.contextmanager
def context(**fields):
    """Push correlation fields (``scan_id=…``, ``job_id=…``, ``stop=…``)
    for the dynamic extent of the block. Nested contexts merge; inner
    wins on key collisions. Events AND tracer spans recorded inside pick
    the fields up automatically."""
    merged = dict(_CONTEXT.get())
    merged.update({k: v for k, v in fields.items() if v is not None})
    token = _CONTEXT.set(tuple(sorted(merged.items())))
    try:
        yield
    finally:
        _CONTEXT.reset(token)


def current_context() -> dict:
    """The ambient correlation fields (empty dict outside any context)."""
    return dict(_CONTEXT.get())


@dataclasses.dataclass
class Event:
    """One journal entry. ``t_wall`` is epoch seconds (humans, cross-host
    correlation); ``t_mono`` is monotonic (robust ordering/latency on one
    host, same clock as tracer spans)."""

    kind: str
    severity: str
    message: str
    t_wall: float
    t_mono: float
    thread: str
    fields: dict

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "severity": self.severity,
            "message": self.message,
            "t_wall": round(self.t_wall, 6),
            "t_mono": round(self.t_mono, 6),
            "thread": self.thread,
            **({"fields": self.fields} if self.fields else {}),
        }


#: Sentinel: no explicit dump-dir choice — fall back to the env var.
_ENV_DUMP = object()


def _jsonable(v):
    """Coerce a correlation value to something json.dumps accepts —
    events must never be the thing that crashes a failing pipeline."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    try:
        return str(v)
    except Exception:
        return "<unprintable>"


class FlightRecorder:
    """Thread-safe bounded ring buffer of :class:`Event` records."""

    def __init__(self, capacity: int = 4096, registry=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: collections.deque[Event] = collections.deque(
            maxlen=capacity)
        self._dropped = 0          # events evicted by the ring bound
        # Lifetime tally per severity, independent of the ring bound —
        # the source consumers (serve's /metrics sync) read deltas from.
        self._severity_counts: dict[str, int] = {}
        # _ENV_DUMP = "defer to SL_TPU_FLIGHT_DUMP_DIR"; None = dumps
        # explicitly disabled (set_dump_dir(None) must win over the env).
        self._dump_dir: "str | None | object" = _ENV_DUMP
        self._dump_min_interval_s = 1.0
        self._last_dump_mono = -float("inf")
        self._dump_seq = 0
        self._registry = registry  # None = resolve trace.REGISTRY lazily

    # -- recording ---------------------------------------------------------

    def record(self, kind: str, message: str = "", severity: str = "info",
               **fields) -> Event:
        if severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {severity!r}")
        merged = current_context()
        # None-valued kwargs are "no value", same as in context(): they
        # must not mask an ambient correlation field.
        merged.update({k: v for k, v in fields.items() if v is not None})
        ev = Event(kind=str(kind), severity=severity, message=str(message),
                   t_wall=time.time(), t_mono=time.monotonic(),
                   thread=threading.current_thread().name,
                   fields={k: _jsonable(v) for k, v in merged.items()})
        with self._lock:
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(ev)
            self._severity_counts[severity] = \
                self._severity_counts.get(severity, 0) + 1
        self._count(severity)
        return ev

    def severity_counts(self) -> dict[str, int]:
        """Lifetime {severity: events recorded} — survives ring wrap."""
        with self._lock:
            return dict(self._severity_counts)

    def _count(self, severity: str) -> None:
        try:
            reg = self._registry
            if reg is None:
                from . import trace
                reg = trace.REGISTRY
            reg.counter("sl_events_total",
                        "flight-recorder events by severity",
                        severity=severity).inc()
        except Exception as e:  # metrics must never break recording
            log.debug("event severity counter unavailable: %s", e)

    def fault(self, exc: BaseException, **fields) -> Event:
        """Record a taxonomy raise and, for genuine faults, write the
        journal that led to it (when a dump directory is configured).

        The exception chooses its own journal severity via a
        ``flight_severity`` class attribute (default "fault"):
        designed-for flow control like serve's backpressure rejections
        declares "warning", so an overload burst neither wraps the ring
        past the real fault history nor storms the dump directory —
        only severity="fault" events trigger dumps."""
        taxonomy = [c.__name__ for c in type(exc).__mro__
                    if c not in (object, BaseException, Exception,
                                 RuntimeError)]
        severity = getattr(exc, "flight_severity", "fault")
        ev = self.record("fault", message=str(exc), severity=severity,
                         exc_type=type(exc).__name__,
                         taxonomy=",".join(taxonomy), **fields)
        if severity == "fault":
            self._maybe_dump(ev)
        return ev

    # -- dump-on-fault -----------------------------------------------------

    def set_dump_dir(self, path: str | None,
                     min_interval_s: float = 1.0) -> None:
        """Enable (or disable with None — this overrides the
        ``SL_TPU_FLIGHT_DUMP_DIR`` env var, which only applies while no
        explicit choice has been made) journal dumps on fault events.
        ``min_interval_s`` rate-limits a fault storm to one file per
        interval — the journal each dump carries covers the storm."""
        with self._lock:
            self._dump_dir = path
            self._dump_min_interval_s = float(min_interval_s)
            self._last_dump_mono = -float("inf")

    def _resolve_dump_dir(self) -> str | None:
        if self._dump_dir is _ENV_DUMP:
            return os.environ.get("SL_TPU_FLIGHT_DUMP_DIR") or None
        return self._dump_dir

    def _maybe_dump(self, ev: Event) -> str | None:
        with self._lock:
            dump_dir = self._resolve_dump_dir()
            if not dump_dir:
                return None
            now = time.monotonic()
            if now - self._last_dump_mono < self._dump_min_interval_s:
                return None
            self._dump_seq += 1
            seq = self._dump_seq
        path = os.path.join(
            dump_dir, f"flight_{os.getpid()}_{seq:04d}.jsonl")
        try:
            os.makedirs(dump_dir, exist_ok=True)
            self.dump(path)
        except OSError as e:
            # The rate-limit slot is only consumed on SUCCESS: a failed
            # write (permissions, disk full) must not suppress the next
            # fault's journal for the whole interval.
            log.warning("flight journal dump to %s failed: %s", path, e)
            return None
        with self._lock:
            self._last_dump_mono = time.monotonic()
        log.warning("flight journal dumped to %s (%s: %s)", path,
                    ev.fields.get("exc_type", "fault"), ev.message)
        return path

    # -- inspection --------------------------------------------------------

    def tail(self, n: int | None = None,
             kind: str | None = None) -> list[Event]:
        """Last ``n`` events, optionally restricted to one ``kind``
        (exact match) — the filter behind ``GET /events?kind=`` and the
        soak bench's eviction/recovery assertions. The kind filter
        applies BEFORE the tail bound, so `tail(8, kind="job_terminal")`
        is the last 8 terminals, not terminals among the last 8 events."""
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        return evs if n is None else evs[-n:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def to_jsonl(self, n: int | None = None,
                 kind: str | None = None) -> str:
        lines = [json.dumps(e.to_dict()) for e in self.tail(n, kind=kind)]
        return "\n".join(lines) + ("\n" if lines else "")

    def dump(self, path: str, n: int | None = None) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl(n))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0


# ---------------------------------------------------------------------------
# Global default recorder (mirrors trace.GLOBAL / trace.REGISTRY)
# ---------------------------------------------------------------------------

RECORDER = FlightRecorder()
record = RECORDER.record
fault = RECORDER.fault
tail = RECORDER.tail
to_jsonl = RECORDER.to_jsonl
dump = RECORDER.dump
set_dump_dir = RECORDER.set_dump_dir
