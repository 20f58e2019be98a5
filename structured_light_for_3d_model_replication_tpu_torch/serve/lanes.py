"""Device lanes: one worker lane per local card (counterpart of the JAX
package's ``serve/lanes.py``).

* :class:`DeviceLane` — one launch lane pinned to one ``torch.device``.
  The lane's label (``"cuda:0"``; ``"cpu:0"`` for the host) rides the
  per-device :class:`~.cache.ProgramKey`, so built programs — and the
  zero-rebuild steady-state assertion — stay per-card.
* :class:`DeviceLanePool` — enumerates the cards once
  (``torch.cuda.device_count()``; the host only when the caller passes
  it), hands out lanes round-robin to the configured worker count, routes
  each (bucket, batch) to a lane's program, and owns STICKY session →
  lane placement.

A bucket whose pixel count meets ``shard_min_pixels`` routes instead to
the sharded cross-card tier: ONE program whose camera rows span a set of
cards (`parallel/pipeline.py`), keyed by that device SET.

The pool also owns **lane health**: each distinct device carries a
healthy → suspect → dead state machine with hysteresis (consecutive
launch failures promote; only a successful probe revives a dead device),
visible as ``serve_lane_state{device=}``. A dead transition fires the
service's ``on_device_dead`` hook, sticky sessions re-pin to surviving
lanes (``serve_lane_repins_total``), and the sharded tier re-forms its
span from the LIVE device set — the widest power-of-two width the
survivors can fill, down the 8→4→2→off ladder. Sharded launches feed the
same health machine through ``note_sharded_failure``: N consecutive faults
on one span fire ``on_span_suspect`` so the service can probe each member
and convict the dead one. On revive, ``rebalance_sessions`` migrates the
sessions that were moved off the card back home, with flap hysteresis.
Devices are told apart by LABEL (``"cuda:1"``; host lanes ``"cpu:k"``,
whose tensors all report ``cpu``).

The pool is pure bookkeeping — no threads, no device I/O.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import torch

from ..parallel.mesh import device_label, local_devices
from ..utils import events, trace
from ..utils.log import get_logger
from .batcher import BucketKey
from .cache import ProgramKey

log = get_logger(__name__)

#: Lane (device) health states, mild to terminal. The numeric values are
#: the ``serve_lane_state{device=}`` gauge's encoding.
LANE_HEALTHY, LANE_SUSPECT, LANE_DEAD = "healthy", "suspect", "dead"
_STATE_VALUE = {LANE_HEALTHY: 0, LANE_SUSPECT: 1, LANE_DEAD: 2}


class _DeviceHealth:
    """Per-device failure hysteresis (the router's readyz-miss detector
    shape applied to launch outcomes): ``suspect_failures`` consecutive
    failures → suspect, ``dead_failures`` → dead; any success while not
    dead resets to healthy. Dead is sticky — only an explicit revive
    (the probe path) returns a device to service."""

    __slots__ = ("state", "failures", "dead_since", "reason")

    def __init__(self):
        self.state = LANE_HEALTHY
        self.failures = 0
        self.dead_since: float | None = None
        self.reason = ""


@dataclasses.dataclass(frozen=True)
class DeviceLane:
    """One launch lane: a worker index pinned to one device."""

    index: int            # lane number (== worker index)
    device: torch.device
    label: str            # "type:index", the ProgramKey.device value

    def __repr__(self) -> str:  # device objects repr verbosely
        return f"DeviceLane({self.index}, {self.label})"


class DeviceLanePool:
    """Lane assignment + program routing over the local devices.

    ``n_lanes`` worker lanes spread round-robin over up to
    ``max_devices`` local devices (None = all). ``shard_min_pixels``
    selects the sharded cross-chip tier: a bucket whose padded pixel
    count meets the threshold dispatches ONE program spanning
    ``shard_devices`` chips (rows sharded over the mesh's space axis,
    `parallel/mesh.py`) instead of serializing on a single lane.
    """

    def __init__(self, n_lanes: int = 1, max_devices: int | None = None,
                 shard_min_pixels: int | None = None,
                 shard_devices: int = 0, devices=None,
                 registry: "trace.MetricsRegistry | None" = None,
                 suspect_failures: int = 2, dead_failures: int = 3,
                 sharded_suspect_failures: int = 2,
                 rebalance_flap_window_s: float = 300.0):
        devices = [torch.device(d) for d in
                   (local_devices() if devices is None else devices)]
        if max_devices is not None:
            devices = devices[:max(1, int(max_devices))]
        if not devices:
            raise ValueError("no local devices to build lanes over")
        self.devices = devices
        n_lanes = max(1, int(n_lanes))
        self.lanes = [
            DeviceLane(i, devices[i % len(devices)],
                       device_label(devices[i % len(devices)]))
            for i in range(n_lanes)
        ]
        self.shard_min_pixels = shard_min_pixels
        # The sharded tier needs >= 2 chips to be worth a distinct
        # program; 0 = span every device the pool can see.
        self.shard_devices = (len(devices) if not shard_devices
                              else min(int(shard_devices), len(devices)))
        self._lock = threading.Lock()
        self._session_lane: dict[str, DeviceLane] = {}
        # Solve meshes are keyed by the span's device SET (sorted label
        # tuple), not a count — a 4-wide span over {1,2,3,4} and one
        # over {0,1,2,3} are different meshes.
        self._solve_meshes: dict[tuple, object] = {}
        # -- lane health (device-loss tier) ----------------------------
        self.registry = registry if registry is not None \
            else trace.REGISTRY
        self.suspect_failures = max(1, int(suspect_failures))
        self.dead_failures = max(self.suspect_failures,
                                 int(dead_failures))
        # One health record per LANE DEVICE (lanes sharing a chip share
        # its fate — a dead chip kills every lane pinned to it).
        self._health: dict[str, _DeviceHealth] = {
            ln.label: _DeviceHealth() for ln in self.lanes}
        # Fired by a healthy→…→dead transition, OUTSIDE the pool lock
        # (the service hooks its re-pin/worker-deactivation here; that
        # work takes other locks and must not nest under ours).
        self.on_device_dead = None  # callable(label) | None
        # -- sharded-fault attribution ---------------------------------
        # Sharded launches can't name the dead member from the launch
        # error alone; the pool counts consecutive faults per span and
        # fires ``on_span_suspect`` (outside the lock) at the threshold
        # so the service can probe-convict (docs/ROBUSTNESS.md).
        self.sharded_suspect_failures = max(
            1, int(sharded_suspect_failures))
        self._span_failures: dict[tuple, int] = {}
        self.on_span_suspect = None  # callable(span tuple) | None
        # -- revival rebalancing ---------------------------------------
        self.rebalance_flap_window_s = float(rebalance_flap_window_s)
        self._displaced: dict[str, set[str]] = {}
        self._revive_times: dict[str, list[float]] = {}
        self._revives: dict[str, int] = {}
        self._state_gauge = {
            label: self.registry.gauge(
                "serve_lane_state",
                "device-lane health (0 healthy, 1 suspect, 2 dead)",
                device=label)
            for label in self._health}
        self._dead_total = self.registry.counter(
            "serve_device_dead_total",
            "devices declared dead by lane-health escalation")
        self._repins = self.registry.counter(
            "serve_lane_repins_total",
            "sticky sessions re-pinned to a surviving lane after their "
            "device died")
        self._span_faults = self.registry.counter(
            "serve_sharded_span_faults_total",
            "device-class faults observed on sharded cross-chip "
            "launches (pre-attribution)")
        self._span_probes = self.registry.counter(
            "serve_sharded_span_probes_total",
            "probe-convict rounds triggered by consecutive sharded "
            "faults on one span")
        self._rebalances = self.registry.counter(
            "serve_lane_rebalances_total",
            "sticky sessions migrated back to their revived device")

    # -- lanes ---------------------------------------------------------

    def lane(self, index: int) -> DeviceLane:
        return self.lanes[index]

    @property
    def n_lanes(self) -> int:
        return len(self.lanes)

    def lanes_on(self, label: str) -> list[DeviceLane]:
        """Every lane pinned to the device ``label`` (the set the
        service deactivates/revives together — a chip dies whole)."""
        return [ln for ln in self.lanes if ln.label == label]

    def device_by_label(self, label: str):
        """The torch.device behind a lane label, or None (the probe
        path's lookup)."""
        for d in self.devices:
            if device_label(d) == label:
                return d
        return None

    @property
    def multi_device(self) -> bool:
        """True when the lanes actually span more than one chip. A
        single-device pool routes through the HISTORICAL un-pinned
        program keys and takes no session placement — bit-identical to
        the pre-lane service (and its warmed program set)."""
        return len({ln.label for ln in self.lanes}) > 1

    def distinct_devices(self) -> list[DeviceLane]:
        """First lane per distinct device — the warmup iteration set
        (two lanes sharing a chip share its programs)."""
        seen: dict[str, DeviceLane] = {}
        for lane in self.lanes:
            seen.setdefault(lane.label, lane)
        return list(seen.values())

    # -- lane health (device-loss tier) --------------------------------

    def device_state(self, label: str) -> str:
        with self._lock:
            h = self._health.get(label)
            return h.state if h is not None else LANE_HEALTHY

    def live_devices(self) -> list[str]:
        with self._lock:
            return [d for d, h in self._health.items()
                    if h.state != LANE_DEAD]

    def dead_devices(self) -> list[str]:
        with self._lock:
            return [d for d, h in self._health.items()
                    if h.state == LANE_DEAD]

    def lane_alive(self, index: int) -> bool:
        """True while the lane's DEVICE is not dead (suspect lanes keep
        serving — hysteresis exists exactly so one flaky launch doesn't
        strand a chip's sticky sessions)."""
        if not (0 <= int(index) < len(self.lanes)):
            return False
        return self.device_state(self.lanes[int(index)].label) != LANE_DEAD

    def _set_state(self, h: _DeviceHealth, label: str,
                   state: str) -> None:
        h.state = state
        self._state_gauge[label].set(_STATE_VALUE[state])

    def note_launch_ok(self, label: str) -> None:
        """A clean launch on ``label``: resets the failure streak and
        demotes suspect back to healthy. A DEAD device stays dead — only
        the probe path revives it (a straggler batch completing after
        the death call must not un-kill the chip under the re-pin)."""
        with self._lock:
            h = self._health.get(label)
            if h is None or h.state == LANE_DEAD:
                return
            h.failures = 0
            if h.state != LANE_HEALTHY:
                self._set_state(h, label, LANE_HEALTHY)

    def note_launch_failure(self, label: str, reason: str = "") -> str:
        """A device-class launch failure on ``label``; returns the NEW
        state. Consecutive failures walk healthy → suspect → dead
        (``suspect_failures`` / ``dead_failures``); the dead transition
        counts ``serve_device_dead_total`` and fires ``on_device_dead``
        outside the pool lock."""
        dead_now = False
        with self._lock:
            h = self._health.get(label)
            if h is None:
                h = self._health[label] = _DeviceHealth()
                self._state_gauge.setdefault(label, self.registry.gauge(
                    "serve_lane_state",
                    "device-lane health (0 healthy, 1 suspect, 2 dead)",
                    device=label))
            if h.state == LANE_DEAD:
                return LANE_DEAD
            h.failures += 1
            h.reason = reason
            if h.failures >= self.dead_failures:
                self._set_state(h, label, LANE_DEAD)
                h.dead_since = time.monotonic()
                dead_now = True
            elif h.failures >= self.suspect_failures \
                    and h.state == LANE_HEALTHY:
                self._set_state(h, label, LANE_SUSPECT)
                events.record("lane_suspect", severity="warning",
                              device=label, reason=reason,
                              failures=h.failures)
            state = h.state
        if dead_now:
            self._dead_total.inc()
            events.record("device_dead", severity="error", device=label,
                          reason=reason,
                          message=f"device {label} declared dead after "
                                  f"{self.dead_failures} consecutive "
                                  f"launch failures ({reason})")
            log.error("device %s declared dead (%s)", label, reason)
            cb = self.on_device_dead
            if cb is not None:
                cb(label)
        return state

    def mark_device_dead(self, label: str, reason: str = "") -> bool:
        """Escalation entry (the watchdog's repeatedly-wedged-lane path
        and the probe-convict verdict on a sharded span member): declare
        ``label`` dead directly. True iff this call made the transition
        (idempotent — a second caller is a no-op). A span member that
        hosts no lane gets its health record created here — the sharded
        tier spans every pool device, not just the laned ones."""
        with self._lock:
            h = self._health.get(label)
            if h is None:
                if self.device_by_label(label) is None:
                    return False  # not a pool device at all
                h = self._health[label] = _DeviceHealth()
                self._state_gauge.setdefault(label, self.registry.gauge(
                    "serve_lane_state",
                    "device-lane health (0 healthy, 1 suspect, 2 dead)",
                    device=label))
            if h.state == LANE_DEAD:
                return False
            self._set_state(h, label, LANE_DEAD)
            h.dead_since = time.monotonic()
            h.reason = reason
        self._dead_total.inc()
        events.record("device_dead", severity="error", device=label,
                      reason=reason,
                      message=f"device {label} escalated to dead "
                              f"({reason})")
        log.error("device %s escalated to dead (%s)", label, reason)
        cb = self.on_device_dead
        if cb is not None:
            cb(label)
        return True

    def revive_device(self, label: str) -> bool:
        """The probe path's success: return a dead device to service
        (healthy, streak cleared). True iff it was dead. Each revive is
        timestamped — ``rebalance_sessions`` reads the recent-revive
        history as its flap hysteresis."""
        with self._lock:
            h = self._health.get(label)
            if h is None or h.state != LANE_DEAD:
                return False
            h.failures = 0
            h.dead_since = None
            h.reason = ""
            self._set_state(h, label, LANE_HEALTHY)
            now = time.monotonic()
            self._revives[label] = self._revives.get(label, 0) + 1
            times = self._revive_times.setdefault(label, [])
            times.append(now)
            # Bounded: only stamps inside the flap window matter.
            del times[:max(0, len(times) - 8)]
        events.record("device_revived", severity="info", device=label)
        log.info("device %s revived — rejoining the pool", label)
        return True

    def _healthy_lanes(self) -> list[DeviceLane]:
        """Lanes on non-dead devices (callers hold self._lock)."""
        return [ln for ln in self.lanes
                if self._health.get(ln.label) is None
                or self._health[ln.label].state != LANE_DEAD]

    def retry_lane(self, exclude: str | None = None) -> DeviceLane | None:
        """Least-loaded healthy lane (optionally excluding one device) —
        the cross-lane retry target for a batch that died on its chip.
        None when no healthy lane exists (single-device pool with its
        chip dead: the caller fails the work honestly)."""
        with self._lock:
            lanes = [ln for ln in self._healthy_lanes()
                     if exclude is None or ln.label != exclude]
            if not lanes:
                return None
            load: dict[int, int] = {ln.index: 0 for ln in self.lanes}
            for assigned in self._session_lane.values():
                load[assigned.index] = load.get(assigned.index, 0) + 1
            return min(lanes, key=lambda ln: (load[ln.index], ln.index))

    def repin_sessions(self, dead_label: str) -> dict[str, DeviceLane]:
        """Migrate every sticky session off ``dead_label`` onto
        least-loaded surviving lanes; returns {session_id: new lane}.
        Counts ``serve_lane_repins_total`` per migrated session. The
        caller (service) updates the live ServeSession entries — their
        per-device session programs were warmed at replica start, so
        adoption is compile-free (asserted by the lane-chaos gate)."""
        moved: dict[str, DeviceLane] = {}
        with self._lock:
            survivors = [ln for ln in self._healthy_lanes()
                         if ln.label != dead_label]
            if not survivors:
                return moved
            load: dict[int, int] = {ln.index: 0 for ln in survivors}
            for sid, assigned in self._session_lane.items():
                if assigned.index in load:
                    load[assigned.index] += 1
            for sid, assigned in list(self._session_lane.items()):
                if assigned.label != dead_label:
                    continue
                lane = min(survivors,
                           key=lambda ln: (load[ln.index], ln.index))
                load[lane.index] += 1
                self._session_lane[sid] = lane
                moved[sid] = lane
            if moved:
                # Remember who was displaced: revival rebalancing
                # brings exactly these sessions home.
                self._displaced.setdefault(
                    dead_label, set()).update(moved)
        for sid, lane in moved.items():
            self._repins.inc()
            events.record("session_lane_repin", severity="warning",
                          session_id=sid, from_device=dead_label,
                          to_device=lane.label)
        return moved

    def rebalance_sessions(self, label: str) -> dict[str, DeviceLane]:
        """Revival rebalancing: migrate the sticky sessions that were
        moved OFF ``label`` when it died back onto its lanes; returns
        {session_id: new lane}. Their per-device session programs were
        warmed at replica start (and re-warmed by the revive path), so
        the move is compile-free and finalize stays bitwise.

        Hysteresis: a chip revived more than once inside
        ``rebalance_flap_window_s`` is flapping — its displaced
        sessions stay on the survivors (kept recorded, so the next
        STABLE revival still brings them home) rather than thrashing
        back and forth with every blip."""
        moved: dict[str, DeviceLane] = {}
        with self._lock:
            now = time.monotonic()
            recent = [t for t in self._revive_times.get(label, ())
                      if now - t <= self.rebalance_flap_window_s]
            displaced = self._displaced.pop(label, set())
            if not displaced:
                return moved
            if len(recent) > 1:
                self._displaced[label] = displaced
                events.record(
                    "session_rebalance_deferred", severity="warning",
                    device=label, sessions=len(displaced),
                    revives_in_window=len(recent),
                    message=f"device {label} is flapping "
                            f"({len(recent)} revives in "
                            f"{self.rebalance_flap_window_s:.0f}s); "
                            "keeping displaced sessions on survivors")
                return moved
            targets = [ln for ln in self.lanes if ln.label == label]
            if not targets:
                return moved
            load: dict[int, int] = {ln.index: 0 for ln in targets}
            for assigned in self._session_lane.values():
                if assigned.index in load:
                    load[assigned.index] += 1
            for sid in sorted(displaced):
                cur = self._session_lane.get(sid)
                if cur is None or cur.label == label:
                    continue  # session ended, or already back home
                lane = min(targets,
                           key=lambda ln: (load[ln.index], ln.index))
                load[lane.index] += 1
                self._session_lane[sid] = lane
                moved[sid] = lane
        for sid, lane in moved.items():
            self._rebalances.inc()
            events.record("session_lane_rebalance", severity="info",
                          session_id=sid, to_device=label,
                          to_lane=lane.index)
        return moved

    # -- sharded-fault attribution -------------------------------------

    def note_sharded_ok(self, span) -> None:
        """A clean sharded launch over ``span``: the consecutive-fault
        streak resets (attribution fires only on CONSECUTIVE faults —
        an intermittently healthy span is the hysteresis's no-probe
        case)."""
        with self._lock:
            self._span_failures.pop(tuple(span), None)

    def note_sharded_failure(self, span, reason: str = "") -> int:
        """A device-class fault on a sharded launch over ``span``;
        returns the streak length. The launch error can't name WHICH
        mesh member died, so nothing escalates per device here — at
        ``sharded_suspect_failures`` consecutive faults the pool fires
        ``on_span_suspect(span)`` outside the lock and resets the
        streak (the probe verdict, not further counting, decides)."""
        span = tuple(span)
        fire = False
        with self._lock:
            n = self._span_failures.get(span, 0) + 1
            if n >= self.sharded_suspect_failures:
                self._span_failures.pop(span, None)
                fire = True
            else:
                self._span_failures[span] = n
        self._span_faults.inc()
        events.record("sharded_span_fault", severity="warning",
                      span=list(span), reason=reason, streak=n)
        if fire:
            self._span_probes.inc()
            log.warning(
                "span %s: %d consecutive sharded faults — requesting "
                "per-member probe conviction", "+".join(span), n)
            cb = self.on_span_suspect
            if cb is not None:
                cb(span)
        return n

    # -- program routing ----------------------------------------------

    def span_devices(self, assume_live: str | None = None) -> tuple:
        """The device SET the sharded tier spans RIGHT NOW: sorted
        labels of the widest power-of-two span (≤ ``shard_devices``,
        halving down the 8→4→2 ladder) fillable from the LIVE devices,
        taken in enumeration order with dead members skipped — so one
        early-order dead chip costs the span ONE member, not the whole
        tier. Empty tuple = tier off (fewer than 2 live chips).

        ``assume_live`` treats one (dead) label as live — the revive
        path warms the post-revival span's program BEFORE flipping the
        device back in, keeping the worker hot path compile-free."""
        k = self.shard_devices
        if k < 2:
            return ()
        with self._lock:
            dead = {d for d, h in self._health.items()
                    if h.state == LANE_DEAD}
        dead.discard(assume_live)
        live = [device_label(d) for d in self.devices
                if device_label(d) not in dead]
        while k >= 2:
            if len(live) >= k:
                return tuple(sorted(live[:k]))
            k //= 2
        return ()

    def effective_shard_devices(self) -> int:
        """The span WIDTH the sharded tier can honestly use right now
        (`span_devices`); 0 = tier off. Kept as the stats()/readyz
        scalar — the span set itself is what programs key on."""
        return len(self.span_devices())

    def span_for(self, key: BucketKey) -> tuple:
        """The device span a bucket's launch dispatches over: empty
        (lane-pinned program) unless the sharded tier is enabled, the
        live span covers >1 chip, the bucket meets the size threshold
        AND its row count splits evenly over the span (GSPMD would pad
        an uneven split; refusing keeps the dispatch decision — and the
        warmed program set — exact)."""
        if (self.shard_min_pixels is None
                or key.height * key.width < self.shard_min_pixels):
            return ()
        span = self.span_devices()
        if len(span) < 2 or key.height % len(span):
            return ()
        return span

    def shards_for(self, key: BucketKey) -> int:
        """Shard count for a bucket (``len(span_for(key))``): 0 means a
        lane-pinned program."""
        return len(self.span_for(key))

    def span_program_key(self, key: BucketKey, batch: int,
                         span) -> ProgramKey | None:
        """The sharded ProgramKey (bucket, batch) routes to over an
        EXPLICIT span — the warm paths' view (probe-convict re-form and
        revival compute their target span first, then warm its programs
        off the hot path). None when the bucket wouldn't shard over
        that span."""
        span = tuple(span)
        if (self.shard_min_pixels is None or len(span) < 2
                or key.height * key.width < self.shard_min_pixels
                or key.height % len(span)):
            return None
        return ProgramKey(bucket=key, batch=batch, shards=len(span),
                          span=span)

    def route(self, key: BucketKey, batch: int,
              lane: DeviceLane | None) -> ProgramKey:
        """The ProgramKey a (bucket, batch) launch uses from ``lane``:
        the sharded cross-chip program (set-keyed to the current live
        span) when the bucket qualifies, else the lane's per-device
        program."""
        span = self.span_for(key)
        if span:
            return ProgramKey(bucket=key, batch=batch, shards=len(span),
                              span=span)
        device = (lane.label if lane is not None and self.multi_device
                  else None)
        return ProgramKey(bucket=key, batch=batch, device=device)

    def span_jax_devices(self, span) -> list:
        """The torch.devices behind a span, in pool enumeration order
        (member placement must not depend on label sort). The name is the
        JAX package's."""
        want = set(span)
        return [d for d in self.devices if device_label(d) in want]

    def solve_mesh(self, key: BucketKey):
        """The `parallel/mesh.py` device mesh whose cards a sharded
        bucket's Poisson postprocess solves on
        (``mesh_from_cloud(device_mesh=…)``) — None for lane-pinned
        buckets. Memoized: one Mesh per device
        SET."""
        span = self.span_for(key)
        if not span:
            return None
        with self._lock:
            mesh = self._solve_meshes.get(span)
            if mesh is None:
                from ..parallel import mesh as pmesh

                mesh = pmesh.serve_space_mesh(
                    len(span), devices=self.span_jax_devices(span))
                self._solve_meshes[span] = mesh
            return mesh

    # -- sticky sessions ----------------------------------------------

    def assign_session(self, session_id: str) -> DeviceLane:
        """Sticky placement: the least-loaded lane (fewest live
        sessions; ties break toward the lowest index — deterministic,
        which the placement tests rely on). Idempotent per session.
        Dead-device lanes are skipped — a degraded pool places every
        new session on its surviving chips. The every-lane-dead
        degenerate no longer picks blindly across all lanes: it ranks
        by health state first (suspect before dead — a suspect chip may
        still answer; a dead one won't until a probe revives it), then
        load, so the least-doomed lane wins."""
        with self._lock:
            lane = self._session_lane.get(session_id)
            if lane is not None:
                return lane
            load = {ln.index: 0 for ln in self.lanes}
            for assigned in self._session_lane.values():
                load[assigned.index] = load.get(assigned.index, 0) + 1
            candidates = self._healthy_lanes()
            if candidates:
                lane = min(candidates, key=lambda ln: (load[ln.index],
                                                       ln.index))
            else:
                def rank(ln):
                    h = self._health.get(ln.label)
                    state = h.state if h is not None else LANE_HEALTHY
                    return (_STATE_VALUE[state], load[ln.index],
                            ln.index)
                lane = min(self.lanes, key=rank)
            self._session_lane[session_id] = lane
            return lane

    def lane_for_session(self, session_id: str) -> DeviceLane | None:
        with self._lock:
            return self._session_lane.get(session_id)

    def release_session(self, session_id: str) -> None:
        with self._lock:
            self._session_lane.pop(session_id, None)

    # ------------------------------------------------------------------

    def stats(self) -> dict:
        span = (self.span_devices()
                if self.shard_min_pixels is not None else ())
        with self._lock:
            now = time.monotonic()
            per_lane: dict[int, int] = {ln.index: 0 for ln in self.lanes}
            for lane in self._session_lane.values():
                per_lane[lane.index] = per_lane.get(lane.index, 0) + 1
            states = {label: h.state for label, h in self._health.items()}
            dead = sorted(d for d, s in states.items() if s == LANE_DEAD)
            health = {
                label: {
                    "state": h.state,
                    # Age, not the raw monotonic stamp — scrapers can't
                    # share this process's clock origin.
                    "dead_since_s": (round(now - h.dead_since, 3)
                                     if h.dead_since is not None
                                     else None),
                    "revives": self._revives.get(label, 0),
                }
                for label, h in self._health.items()}
            revives_total = sum(self._revives.values())
        return {
            "devices": [device_label(d) for d in self.devices],
            "lanes": [{"index": ln.index, "device": ln.label,
                       "state": states.get(ln.label, LANE_HEALTHY),
                       "sessions": per_lane.get(ln.index, 0)}
                      for ln in self.lanes],
            # Degraded-pool honesty (the /fleet/signals + /readyz
            # surface): how many chips the pool is actually running on,
            # each tracked device's state/death age/revive count, and
            # the exact span the sharded tier dispatches over.
            "devices_dead": dead,
            "devices_live": len(states) - len(dead),
            "device_health": health,
            "revives_total": revives_total,
            "span_devices": list(span),
            "shard_min_pixels": self.shard_min_pixels,
            "shard_devices": len(span),
        }
