"""Overload governor: circuit breaker, load-shedding tiers, worker watchdog.

The bounded queue (jobs.py) protects memory; this module protects
*behavior* when the service is unhealthy or saturated:

* **circuit breaker** — a sliding window of worker outcomes. When the
  failure rate of genuinely service-side faults (batch launch failures,
  unexpected postprocess exceptions — NOT client-data quality gates)
  crosses the threshold, admissions are refused with a retryable
  rejection for a cooldown, then half-opened: the first success closes
  it. A broken device stops eating the queue's worth of doomed work.
* **load shedding** — graduated, cheapest first: past
  ``shed_preview_frac`` of queue capacity (or device-memory pressure)
  progressive session previews are suppressed (pure compute, no client
  is blocked on them); past ``shed_low_frac`` low-priority submits are
  refused with a retryable rejection while normal/high traffic still
  flows. Both tiers are visible as counters and flight events.
* **watchdog** — a thread that checks every worker's heartbeat. A worker
  wedged inside a launch past ``wedge_timeout_s`` is journaled (flight
  recorder + durability journal) and replaced with a fresh lane, so one
  hung device call does not silently zero the service's throughput.

Everything is advisory-at-admission (the queue remains the authoritative
gate) and all state is bounded.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

from ..utils import events
from ..utils.log import get_logger
from .jobs import JobRejected

log = get_logger(__name__)

#: Shedding tiers, mild to severe.
LEVEL_NONE = 0
LEVEL_SHED_PREVIEWS = 1
LEVEL_SHED_LOW_PRIORITY = 2
LEVEL_BREAKER_OPEN = 3


@dataclasses.dataclass(frozen=True)
class GovernorParams:
    """Tuning surface (rides ServeConfig; docs/SERVING.md)."""

    enabled: bool = True
    # -- circuit breaker --------------------------------------------------
    breaker_window: int = 32          # worker outcomes considered
    breaker_min_samples: int = 8      # below this the breaker abstains
    breaker_failure_rate: float = 0.5
    breaker_cooldown_s: float = 5.0
    # -- load shedding ----------------------------------------------------
    shed_preview_frac: float = 0.50   # of queue capacity
    shed_low_frac: float = 0.80
    # Device-memory pressure (utils/telemetry gauges) at which shedding
    # starts regardless of queue depth; 0 disables the memory signal.
    memory_pressure_frac: float = 0.92
    # -- watchdog ---------------------------------------------------------
    watchdog: bool = True
    watchdog_interval_s: float = 1.0
    # Generous by design: a cold lazy compile (warmup off) is minutes on
    # a big program and must never be mistaken for a hang.
    wedge_timeout_s: float = 300.0
    # PER-DEVICE replacement budget: a hang that eats every fresh lane
    # on one chip must not grow one abandoned thread per wedge_timeout_s
    # forever. Counted per device lane (a dead chip burning its budget
    # used to disable the watchdog for every HEALTHY chip too — the
    # global-counter bug): at the cap the lane is ESCALATED to
    # device-dead when an escalate hook is wired (serve/lanes.py — the
    # pool re-pins its sessions and the probe path owns revival), else
    # the watchdog stops replacing that lane and journals an error.
    watchdog_max_restarts: int = 4


class CircuitBreaker:
    """Sliding-window failure-rate breaker with cooldown + half-open.

    The reusable core of the PR-8 governor's worker breaker, split out so
    the fleet tier (serve/fleet.py) can run ONE PER PEER: a sliding
    window of outcomes, an open state that lasts ``cooldown_s``, and
    half-open semantics — after cooldown the first probe is allowed
    through, and its success closes the breaker (clearing the window so
    stale failures cannot re-trip it instantly).

    Thread-safe; policy-free: it reports transitions (tripped / closed)
    and leaves events, metrics and what "failure" means to the caller.
    """

    def __init__(self, window: int = 32, min_samples: int = 8,
                 failure_rate: float = 0.5, cooldown_s: float = 5.0):
        self.min_samples = int(min_samples)
        self.failure_rate = float(failure_rate)
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._outcomes: collections.deque[bool] = collections.deque(
            maxlen=max(1, int(window)))
        self._open_until = -float("inf")
        self._open_rate = 0.0

    def note_ok(self) -> bool:
        """Record one success. Returns True when this success CLOSED a
        half-open breaker (cooldown had lapsed and the probe worked)."""
        with self._lock:
            was_open = time.monotonic() < self._open_until
            self._outcomes.append(True)
            if was_open or self._open_until == -float("inf"):
                return False
            # Half-open probe succeeded: close fully, forget the window.
            self._open_until = -float("inf")
            self._outcomes.clear()
            return True

    def note_failure(self) -> tuple[bool, float, int]:
        """Record one failure. Returns (tripped_now, rate, samples)."""
        with self._lock:
            self._outcomes.append(False)
            n = len(self._outcomes)
            rate = sum(1 for ok in self._outcomes if not ok) / n
            now = time.monotonic()
            tripped = (n >= self.min_samples
                       and rate >= self.failure_rate
                       and now >= self._open_until)
            if tripped:
                self._open_until = now + self.cooldown_s
                self._open_rate = rate
            return tripped, rate, n

    def open_remaining(self) -> float | None:
        """Remaining cooldown seconds while open, else None (closed or
        half-open — probe traffic may flow)."""
        with self._lock:
            remaining = self._open_until - time.monotonic()
        return remaining if remaining > 0 else None

    @property
    def open_rate(self) -> float:
        """The failure rate observed at the last trip."""
        with self._lock:
            return self._open_rate


class BreakerOpenError(JobRejected):
    """Worker-exception rate tripped the breaker — retry after cooldown."""

    retryable = True

    def __init__(self, failure_rate: float, retry_after_s: float):
        super().__init__(
            f"service circuit breaker open (worker failure rate "
            f"{failure_rate:.0%}); retry in {retry_after_s:.1f}s")
        self.retry_after_s = retry_after_s


class LoadShedError(JobRejected):
    """Low-priority work shed under overload — retry later or raise the
    job's priority."""

    retryable = True

    def __init__(self, level: int, retry_after_s: float):
        super().__init__(
            "low-priority work shed under overload; retry in "
            f"{retry_after_s:.1f}s or submit with priority=normal")
        self.retry_after_s = retry_after_s
        self.level = level


class OverloadGovernor:
    """Breaker + shedding decisions over one service's queue/telemetry."""

    def __init__(self, params: GovernorParams, queue,
                 registry, telemetry=None, store=None):
        self.params = params
        self.queue = queue
        self.telemetry = telemetry
        self.store = store
        self._breaker = CircuitBreaker(
            window=params.breaker_window,
            min_samples=params.breaker_min_samples,
            failure_rate=params.breaker_failure_rate,
            cooldown_s=params.breaker_cooldown_s)
        # tier="preview" counts SHEDDING DECISIONS (one per stop
        # ingested while the tier is active) — the preview-due check and
        # covisibility gate run later in the session, so the per-preview
        # ground truth is the `preview_shed` flight events, not this
        # counter.
        self._shed_total = {
            tier: registry.counter("serve_shed_total",
                                   "overload-governor shed decisions "
                                   "(preview: per stop ingested while "
                                   "the tier is active)", tier=tier)
            for tier in ("preview", "low_priority", "breaker")}
        self._breaker_trips = registry.counter(
            "serve_breaker_trips_total",
            "circuit-breaker openings on worker-exception rate")
        self._level_gauge = registry.gauge(
            "serve_overload_level",
            "current shedding tier (0 none, 1 previews, "
            "2 low-priority, 3 breaker open)")
        self._restarts = registry.counter(
            "serve_worker_restarts_total",
            "wedged workers replaced by the watchdog")
        # Per-device replacement spend (the budget is per chip, not
        # global — a dead device must not disable the watchdog for the
        # healthy ones) + devices whose budget outcome already fired.
        self._restarts_by: dict[str, int] = {}
        self._budget_spent: set[str] = set()
        self._watch_stop = threading.Event()
        self._watch_thread: threading.Thread | None = None

    # -- breaker -----------------------------------------------------------

    def note_worker_ok(self) -> None:
        if self._breaker.note_ok():
            events.record("breaker_closed", severity="info",
                          message="worker recovered; breaker closed")

    def note_worker_failure(self) -> None:
        p = self.params
        tripped, rate, n = self._breaker.note_failure()
        if tripped:
            self._breaker_trips.inc()
            events.record(
                "breaker_open", severity="error",
                message=f"worker failure rate {rate:.0%} over last "
                        f"{n} outcomes; shedding admissions for "
                        f"{p.breaker_cooldown_s:.1f}s",
                failure_rate=round(rate, 3))
            if self.store is not None:
                self.store.note("breaker_open",
                                failure_rate=round(rate, 3))

    def breaker_open(self) -> float | None:
        """Remaining cooldown seconds when open, else None."""
        return self._breaker.open_remaining()

    # -- shedding ----------------------------------------------------------

    def memory_pressure(self) -> float:
        if self.telemetry is None:
            return 0.0
        return self.telemetry.memory_pressure()

    def level(self) -> int:
        p = self.params
        if not p.enabled:
            return LEVEL_NONE
        if self.breaker_open() is not None:
            return LEVEL_BREAKER_OPEN
        frac = self.queue.depth() / max(1, self.queue.max_depth)
        mem = self.memory_pressure()
        mem_pressed = (p.memory_pressure_frac > 0
                       and mem >= p.memory_pressure_frac)
        if frac >= p.shed_low_frac:
            lvl = LEVEL_SHED_LOW_PRIORITY
        elif frac >= p.shed_preview_frac or mem_pressed:
            lvl = LEVEL_SHED_PREVIEWS
        else:
            lvl = LEVEL_NONE
        self._level_gauge.set(lvl)
        return lvl

    def shed_previews(self) -> bool:
        shed = self.level() >= LEVEL_SHED_PREVIEWS
        if shed:
            self._shed_total["preview"].inc()
        return shed

    def admit(self, priority: int = 1) -> None:
        """Raise the governor's rejection for this admission, if any.
        Runs BEFORE the queue's own gate; content-cache hits are served
        upstream of this call (a cached answer costs nothing and relieves
        load, so it flows even with the breaker open)."""
        if not self.params.enabled:
            return
        remaining = self.breaker_open()
        if remaining is not None:
            self._shed_total["breaker"].inc()
            self._level_gauge.set(LEVEL_BREAKER_OPEN)
            raise BreakerOpenError(self._breaker.open_rate, remaining)
        lvl = self.level()
        if lvl >= LEVEL_SHED_LOW_PRIORITY and priority >= 2:
            self._shed_total["low_priority"].inc()
            raise LoadShedError(lvl, self.queue.retry_hint())

    # -- watchdog ----------------------------------------------------------

    def start_watchdog(self, workers_fn, restart_fn,
                       escalate_fn=None) -> None:
        """``workers_fn()`` → current worker list; ``restart_fn(worker)``
        replaces one wedged worker and returns its successor;
        ``escalate_fn(worker)`` (optional — the device-loss tier) is
        called INSTEAD of a replacement once a worker's device has spent
        its per-device restart budget: same-device swapping a chip that
        wedges every fresh lane is the failure mode this escalates to
        device-dead. Returns True when it escalated (the watchdog stops
        touching that device; the probe path owns revival)."""
        if not (self.params.enabled and self.params.watchdog):
            return
        self._watch_stop.clear()
        self._watch_thread = threading.Thread(
            target=self._watch, args=(workers_fn, restart_fn,
                                      escalate_fn),
            name="serve-watchdog", daemon=True)
        self._watch_thread.start()

    def stop_watchdog(self) -> None:
        self._watch_stop.set()
        t = self._watch_thread
        if t is not None:
            t.join(timeout=5.0)
            self._watch_thread = None

    @staticmethod
    def _budget_key(worker) -> str:
        """Restart budgets are PER DEVICE (lanes sharing a chip share
        its budget); lane-less workers fall back to their name."""
        lane = getattr(worker, "lane", None)
        return lane.label if lane is not None else worker.name

    def reset_restart_budget(self, key: str) -> None:
        """A revived device (probe path) gets a fresh watchdog budget —
        its past wedges belonged to the failure the revival cleared."""
        self._restarts_by.pop(key, None)
        self._budget_spent.discard(key)

    def _watch(self, workers_fn, restart_fn, escalate_fn=None) -> None:
        p = self.params
        budget_spent = self._budget_spent
        while not self._watch_stop.wait(p.watchdog_interval_s):
            now = time.monotonic()
            for w in workers_fn():
                stalled = now - w.last_beat
                if not w.alive or getattr(w, "abandoned", False) \
                        or stalled <= p.wedge_timeout_s:
                    continue
                key = self._budget_key(w)
                if self._restarts_by.get(key, 0) \
                        >= p.watchdog_max_restarts:
                    if key in budget_spent:
                        continue
                    if escalate_fn is not None:
                        # A chip that wedges every fresh lane is DEAD,
                        # not unlucky: hand it to the lane-health tier
                        # (re-pin + probe-revive) instead of swapping
                        # onto the same device forever.
                        budget_spent.add(key)
                        events.record(
                            "watchdog_device_escalated", severity="error",
                            message=f"device {key} spent its "
                                    f"{p.watchdog_max_restarts}-restart "
                                    "budget and still wedges — "
                                    "escalating to device-dead",
                            worker=w.name, device=key)
                        if self.store is not None:
                            self.store.note("watchdog_device_escalated",
                                            worker=w.name, device=key)
                        try:
                            escalate_fn(w)
                        except Exception as e:
                            # Abandon only on SUCCESS: a still-live
                            # worker is what lets the next pass retry
                            # the escalation (abandoned workers are
                            # skipped at the top of the scan).
                            log.error("device escalation failed: %s", e)
                            budget_spent.discard(key)
                            continue
                        w.abandoned = True
                        continue
                    budget_spent.add(key)
                    events.record(
                        "watchdog_budget_exhausted", severity="error",
                        message=f"{p.watchdog_max_restarts} worker "
                                f"replacements spent on {key} and its "
                                "lanes still wedge — not replacing "
                                "further on this device (others keep "
                                "their budgets)",
                        worker=w.name, device=key)
                    continue
                w.abandoned = True
                self._restarts.inc()
                self._restarts_by[key] = self._restarts_by.get(key, 0) + 1
                events.record(
                    "worker_wedged", severity="error",
                    message=f"worker {w.name} made no progress for "
                            f"{stalled:.0f}s; starting a replacement "
                            "lane", worker=w.name,
                    stalled_s=round(stalled, 1))
                if self.store is not None:
                    self.store.note("worker_wedged", worker=w.name,
                                    stalled_s=round(stalled, 1))
                try:
                    repl = restart_fn(w)
                except Exception as e:
                    log.error("worker restart failed: %s", e)
                    continue
                events.record("worker_restarted", severity="warning",
                              worker=w.name, replacement=repl.name)

    def stats(self) -> dict:
        remaining = self.breaker_open()
        return {
            "enabled": self.params.enabled,
            "level": self.level(),
            "breaker_open_s": (round(remaining, 2)
                               if remaining is not None else None),
            "worker_restarts": int(self._restarts.value),
            "worker_restarts_by_device": dict(self._restarts_by),
            # Autoscaler signals (router /fleet/signals aggregates
            # these across replicas).
            "memory_pressure": round(self.memory_pressure(), 4),
            "shed_total": {tier: int(c.value)
                           for tier, c in self._shed_total.items()},
        }
