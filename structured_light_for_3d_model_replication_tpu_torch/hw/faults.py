"""Deterministic fault injection for the hardware layer (chaos harness).

The rig is hardware-in-the-loop — phone uploads over HTTP, an ESP32
turntable over serial — so the interesting failures are the ones a clean
virtual rig never produces: capture timeouts, all-black/saturated frames
(torch glitch, exposure misfire), duplicated frames (stale buffer served
twice), truncated uploads (connection dropped mid-POST), missed turntable
``DONE`` lines. This module wraps any camera/turntable/channel in a
schedule-driven fault injector so the containment layer
(`scanner.RetryPolicy`, the quality gates in `models/scan360`) can be
proven against EXACTLY reproducible failure runs:

* :class:`FaultPlan` — per-(capture path, attempt) fault kinds, so a
  "transient" fault (fails attempt 0, clean on retry) and a "hard" fault
  (fails every attempt) are both one rule; deterministic by construction,
  with a seeded generator for randomized-but-reproducible campaigns.
* :class:`FlakyCamera` — wraps any ``capture(path) -> bool`` camera.
  ``timeout`` faults return False without writing (the pull-channel abort
  shape, `server/sl_system.py:102-104`); corruption faults let the inner
  capture succeed and then damage the file — those frames upload "fine"
  and must be caught downstream by the decode-coverage gate (or, for
  truncation, the scanner's frame verification).
* :class:`FlakyTurntable` / :class:`FlakyChannel` — missed DONE lines,
  dead rotations, dropped command handshakes on a per-call schedule.

Corruption composes with :mod:`..models.realism`: :func:`realism_post`
routes every *successful* frame through the photoreal degradation chain,
so a chaos run can be photometrically realistic AND fault-injected.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Sequence

import numpy as np

from ..utils.log import get_logger

log = get_logger(__name__)

#: Camera fault kinds understood by :class:`FlakyCamera`.
CAMERA_FAULTS = ("timeout", "black", "saturated", "duplicate", "truncate")
#: Turntable fault kinds understood by :class:`FlakyTurntable`.
TURNTABLE_FAULTS = ("done_timeout", "stuck")
#: Device (accelerator) fault kinds understood by :class:`FaultyDevice`.
DEVICE_FAULTS = ("device_lost", "nan_output", "latency", "hang")
#: Env var carrying a JSON :class:`DeviceFaultPlan` for subprocess
#: replicas and the lane-chaos bench (the chaos harness sets it;
#: production never does).
DEVICE_FAULTS_ENV = "SL_DEVICE_FAULTS"


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """Faults for captures whose path contains ``match``.

    ``kinds[a]`` is the fault injected on attempt ``a`` for that frame
    (attempts count per path); attempts beyond the list are clean.
    ``always`` repeats ``kinds[-1]`` forever — a hard failure no retry
    policy can outlast.
    """

    match: str
    kinds: tuple[str, ...]
    always: bool = False

    def kind_for(self, attempt: int) -> str | None:
        if attempt < len(self.kinds):
            return self.kinds[attempt]
        if self.always and self.kinds:
            return self.kinds[-1]
        return None


class FaultPlan:
    """Ordered rule list; first rule whose ``match`` is a substring of the
    capture path wins. Stateless — attempt counting lives in the wrapper,
    so one plan can drive several runs."""

    def __init__(self, rules: Sequence[FaultRule] = ()):
        self.rules = list(rules)
        for r in self.rules:
            for k in r.kinds:
                if k not in CAMERA_FAULTS:
                    raise ValueError(f"unknown camera fault kind {k!r}")

    def fault_for(self, path: str, attempt: int) -> str | None:
        for rule in self.rules:
            if rule.match in path:
                return rule.kind_for(attempt)
        return None

    @classmethod
    def transient(cls, match: str, kind: str = "timeout",
                  times: int = 1) -> FaultRule:
        """Rule failing the first ``times`` attempts, then clean."""
        return FaultRule(match=match, kinds=(kind,) * times)

    @classmethod
    def hard(cls, match: str, kind: str = "timeout") -> FaultRule:
        """Rule failing EVERY attempt."""
        return FaultRule(match=match, kinds=(kind,), always=True)

    @classmethod
    def seeded(cls, seed: int, matches: Sequence[str],
               p_transient: float = 0.1, p_hard: float = 0.0,
               kinds: Sequence[str] = ("timeout",)) -> "FaultPlan":
        """Reproducible random campaign over ``matches`` (e.g. the stop
        directories of a session): each match independently draws a
        transient or hard fault of a random kind."""
        rng = np.random.default_rng(seed)
        rules = []
        for m in matches:
            u = float(rng.random())
            kind = str(rng.choice(list(kinds)))
            if u < p_hard:
                rules.append(cls.hard(m, kind))
            elif u < p_hard + p_transient:
                rules.append(cls.transient(m, kind))
        return cls(rules)


class CallSchedule:
    """call-index → fault kind, for devices whose faults are per call
    rather than per file (turntable rotations, channel triggers)."""

    def __init__(self, faults: dict[int, str] | None = None):
        self.faults = dict(faults or {})
        self.calls = 0

    def next(self) -> str | None:
        kind = self.faults.get(self.calls)
        self.calls += 1
        return kind

    @classmethod
    def seeded(cls, seed: int, n_calls: int,
               rates: dict[str, float]) -> "CallSchedule":
        rng = np.random.default_rng(seed)
        faults: dict[int, str] = {}
        for i in range(n_calls):
            u = float(rng.random())
            acc = 0.0
            for kind, p in sorted(rates.items()):
                acc += p
                if u < acc:
                    faults[i] = kind
                    break
        return cls(faults)


# ---------------------------------------------------------------------------
# Frame corruption models
# ---------------------------------------------------------------------------


def corrupt_frame_file(path: str, kind: str,
                       duplicate_of: str | None = None) -> bool:
    """Damage an already-written frame file in place; True iff the file
    was actually modified (``duplicate`` with no prior frame is a no-op).

    ``black``/``saturated`` rewrite the image at its own size (an exposure
    misfire uploads a well-formed but informationless frame); ``duplicate``
    replaces the bytes with another frame's (stale camera buffer served
    twice); ``truncate`` chops the file mid-stream (connection dropped
    mid-upload — the result is NOT a decodable image)."""
    from ..io import images as img_io

    if kind in ("black", "saturated"):
        frame = img_io._imread_gray(path)
        value = 0 if kind == "black" else 255
        img_io.write_frame(path, np.full_like(frame, value))
    elif kind == "duplicate":
        if duplicate_of is None or not os.path.exists(duplicate_of):
            return False  # nothing to duplicate yet (first frame): no-op
        with open(duplicate_of, "rb") as src, open(path, "wb") as dst:
            dst.write(src.read())
    elif kind == "truncate":
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 3))
    else:
        raise ValueError(f"unknown corruption kind {kind!r}")
    return True


def realism_post(cam_K: np.ndarray, params=None,
                 seed: int = 0) -> Callable[[str], None]:
    """Post-capture hook routing every successful frame through the
    photoreal sensor chain (`models.realism.degrade_frame`) — compose with
    :class:`FlakyCamera` for photometrically-degraded chaos runs."""
    from ..io import images as img_io
    from ..models import realism

    if params is None:
        params = realism.SensorParams()
    rng = np.random.default_rng(seed)

    def post(path: str) -> None:
        frame = img_io._imread_gray(path)
        img_io.write_frame(path, realism.degrade_frame(frame, cam_K, params,
                                                       rng))

    return post


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


class FlakyCamera:
    """Schedule-driven fault wrapper over any ``capture(path)`` camera.

    ``injected`` logs every (path, attempt, kind) actually fired, so a
    chaos test can assert the health report records EXACTLY the injected
    faults and nothing else.
    """

    def __init__(self, inner, plan: FaultPlan,
                 post: Callable[[str], None] | None = None):
        self.inner = inner
        self.plan = plan
        self.post = post
        self.attempts: dict[str, int] = defaultdict(int)
        self.injected: list[tuple[str, int, str]] = []
        self._last_good: str | None = None

    @property
    def connected(self) -> bool:
        return bool(getattr(self.inner, "connected", True))

    def capture(self, path: str) -> bool:
        attempt = self.attempts[path]
        self.attempts[path] += 1
        kind = self.plan.fault_for(path, attempt)
        if kind == "timeout":
            self.injected.append((path, attempt, kind))
            log.debug("chaos: capture timeout injected (%s attempt %d)",
                      path, attempt)
            return False
        if not self.inner.capture(path):
            return False
        applied = False
        if kind is not None:
            applied = corrupt_frame_file(path, kind,
                                         duplicate_of=self._last_good)
        if applied:
            # Ledger records only faults that actually FIRED — a chaos
            # test asserting health == injected must not be lied to by a
            # no-op (duplicate with no prior frame).
            self.injected.append((path, attempt, kind))
            log.debug("chaos: frame corruption %r injected (%s attempt %d)",
                      kind, path, attempt)
        else:
            if self.post is not None:
                self.post(path)
            self._last_good = path
        return True


class FlakyTurntable:
    """Fault wrapper over any rotate/wait_for_done turntable.

    ``done_timeout``: the move happens but the DONE line is lost (the
    warn-and-continue case, `server/gui.py:760-762`). ``stuck``: the
    rotation command is swallowed — the table never moves, and DONE (for
    that move) never comes.
    """

    def __init__(self, inner, schedule: CallSchedule):
        self.inner = inner
        self.schedule = schedule
        self.injected: list[tuple[int, str]] = []
        self._pending: str | None = None

    @property
    def connected(self) -> bool:
        return bool(getattr(self.inner, "connected", True))

    @property
    def angle_deg(self) -> float:
        return self.inner.angle_deg

    def connect(self) -> bool:
        return self.inner.connect()

    def rotate(self, degrees: float) -> None:
        kind = self.schedule.next()
        self._pending = kind
        if kind is not None:
            self.injected.append((self.schedule.calls - 1, kind))
            if kind == "stuck":
                log.debug("chaos: rotation swallowed (%.1f°)", degrees)
                return
        self.inner.rotate(degrees)

    def wait_for_done(self, timeout: float = 30.0) -> bool:
        kind, self._pending = self._pending, None
        if kind == "stuck":
            return False        # nothing is moving; DONE never comes
        done = self.inner.wait_for_done(timeout)
        if kind == "done_timeout":
            return False        # move completed but the line was lost
        return done

    def close(self) -> None:
        self.inner.close()


# ---------------------------------------------------------------------------
# Device (accelerator) fault injection — the serve tier's lane boundary
# ---------------------------------------------------------------------------


class DeviceLostError(RuntimeError):
    """The launch's view of a dead chip: the runtime refused the program
    because the device is gone (the ``DEVICE_LOST`` shape real backends
    raise). The serve tier's lane-health escalation keys on this class
    (plus the per-backend taxonomy below for real runtime errors,
    `serve/worker.py`)."""


#: Env var extending :data:`DEVICE_LOSS_TAXONOMY` with deployment
#: vocabulary the table doesn't ship (a fleet's driver build may word a
#: dead chip its own way). Accepts a JSON object keyed by backend —
#: ``{"tpu": ["pattern", ...]}`` or ``{"tpu": {"patterns": [...],
#: "types": [...]}}`` — or a bare comma-separated pattern list applied
#: to every backend. Malformed values are logged and ignored, never
#: raised (the BlobFaultPlan env idiom).
DEVICE_LOSS_PATTERNS_ENV = "SL_DEVICE_LOSS_PATTERNS"

#: Per-backend device-loss vocabulary: ``types`` are exception CLASS
#: names (matched against the exception's MRO — lets an extension key on
#: an unambiguous error class instead of prose), ``patterns`` are
#: lowercase message substrings. The split by backend exists because the
#: same word means different things per runtime: a TPU "halted" is a
#: dead chip, a CPU "halted" is somebody's debugger — classifying with
#: one flat list (the old string sniff) either over-fires on healthy
#: backends or under-fires on real losses. Deliberately NOT listed:
#: allocation failures ("out of memory", "RESOURCE_EXHAUSTED") — an OOM
#: lane is overloaded, not dead, and must feed the governor's breaker,
#: never the lane-death escalation.
DEVICE_LOSS_TAXONOMY: dict[str, dict[str, tuple[str, ...]]] = {
    # CPU devices don't die under a living process: only the generic
    # (injected-fault) vocabulary classifies.
    "cpu": {
        "types": (),
        "patterns": ("device_lost", "device lost", "device is gone"),
    },
    "tpu": {
        "types": (),
        "patterns": ("device_lost", "device lost", "device is gone",
                     "tpu is halted", "core halted",
                     "slice health check failed",
                     "failed to connect to tpu driver"),
    },
    "gpu": {
        "types": (),
        "patterns": ("device_lost", "device lost", "device is gone",
                     "cuda_error_device_unavailable",
                     "cuda_error_ecc_uncorrectable",
                     "fell off the bus", "gpu is lost"),
    },
}

# torch device types that aren't taxonomy keys (a CUDA card is "gpu").
_BACKEND_ALIASES = {"cuda": "gpu", "rocm": "gpu"}

# (raw env string, parsed extension) — re-parsed only when the env var
# actually changes, so the per-launch classifier costs one dict probe.
_env_taxonomy_cache: tuple[str | None, dict] = (None, {})


def _env_taxonomy() -> dict:
    global _env_taxonomy_cache
    raw = os.environ.get(DEVICE_LOSS_PATTERNS_ENV)
    if raw == _env_taxonomy_cache[0]:
        return _env_taxonomy_cache[1]
    ext: dict[str, dict[str, tuple[str, ...]]] = {}
    if raw and raw.strip():
        try:
            doc = json.loads(raw)
        except ValueError:
            doc = None
        if isinstance(doc, dict):
            for backend, spec in doc.items():
                if isinstance(spec, dict):
                    ext[backend] = {
                        "types": tuple(spec.get("types", ())),
                        "patterns": tuple(
                            str(p).lower()
                            for p in spec.get("patterns", ())),
                    }
                else:
                    ext[backend] = {"types": (), "patterns": tuple(
                        str(p).lower() for p in spec)}
        elif doc is None:
            # Not JSON: a bare comma list — every backend learns it.
            pats = tuple(p.strip().lower()
                         for p in raw.split(",") if p.strip())
            ext = {b: {"types": (), "patterns": pats}
                   for b in DEVICE_LOSS_TAXONOMY}
        else:
            log.error("ignoring malformed %s: not a JSON object or "
                      "pattern list", DEVICE_LOSS_PATTERNS_ENV)
    _env_taxonomy_cache = (raw, ext)
    return ext


def _loss_entries(backend: str | None) -> list[dict]:
    """Taxonomy entries to consult: the backend's own (plus its env
    extension), or — when the backend can't be resolved — the union of
    every backend's (the conservative superset: an unclassifiable
    runtime must not silence a real loss)."""
    ext = _env_taxonomy()
    if backend is not None:
        backend = _BACKEND_ALIASES.get(backend, backend)
        if backend in DEVICE_LOSS_TAXONOMY or backend in ext:
            entries = []
            if backend in DEVICE_LOSS_TAXONOMY:
                entries.append(DEVICE_LOSS_TAXONOMY[backend])
            if backend in ext:
                entries.append(ext[backend])
            return entries
    return list(DEVICE_LOSS_TAXONOMY.values()) + list(ext.values())


def is_device_loss(exc: BaseException, backend: str | None = None,
                   device=None) -> bool:
    """Device-loss classifier shared by the worker and the probe: the
    injected :class:`DeviceLostError`, or a real runtime error matching
    the backend's row of :data:`DEVICE_LOSS_TAXONOMY` (error-type name
    or message vocabulary, extensible via ``SL_DEVICE_LOSS_PATTERNS``).

    ``backend`` defaults to the type of ``device`` (a ``torch.device`` or
    its string, e.g. the tensor's device the failed launch ran on;
    ``cuda`` reads the ``"gpu"`` row); with neither, every backend's
    vocabulary is matched — over-matching a dying process beats
    under-matching a dead chip."""
    if isinstance(exc, DeviceLostError):
        return True
    if backend is None and device is not None:
        backend = str(device).split(":", 1)[0]
    names = {c.__name__ for c in type(exc).__mro__}
    msg = str(exc).lower()
    for entry in _loss_entries(backend):
        if names.intersection(entry["types"]):
            return True
        if any(p in msg for p in entry["patterns"]):
            return True
    return False


@dataclasses.dataclass(frozen=True)
class DeviceFaultRule:
    """Faults for launches on devices whose label contains ``device``.

    Launches count per device (the wrapper/injector owns the counter —
    plans stay stateless, the :class:`FaultPlan` rule). The fault fires
    on launch indices ``[after_launches, after_launches + count)``;
    ``count = -1`` repeats forever — a genuinely dead chip no retry can
    outlast. ``stall_s`` is the injected delay for ``latency`` (the
    launch then proceeds) and ``hang`` (the launch stalls the worker's
    heartbeat — the watchdog's wedge signal — then raises device-lost).
    """

    device: str
    kind: str
    after_launches: int = 0
    count: int = -1
    stall_s: float = 0.25

    def fires(self, launch: int) -> bool:
        if launch < self.after_launches:
            return False
        if self.count < 0:
            return True
        return launch < self.after_launches + self.count


class DeviceFaultPlan:
    """Ordered rule list; first rule whose ``device`` is a substring of
    the lane's device label wins. Stateless — launch counting lives in
    :class:`DeviceFaultInjector`, so one plan drives several runs (and
    serializes to/from the ``SL_DEVICE_FAULTS`` env for subprocess
    replicas, the :class:`~..serve.blobstore.BlobFaultPlan` idiom)."""

    def __init__(self, rules: Sequence[DeviceFaultRule] = ()):
        self.rules = list(rules)
        for r in self.rules:
            if r.kind not in DEVICE_FAULTS:
                raise ValueError(f"unknown device fault kind {r.kind!r}")

    def fault_for(self, device_label: str,
                  launch: int) -> DeviceFaultRule | None:
        for rule in self.rules:
            if rule.device in device_label:
                return rule if rule.fires(launch) else None
        return None

    # -- env round-trip (subprocess replicas / chaos bench) ------------

    def to_env(self) -> str:
        return json.dumps({"rules": [dataclasses.asdict(r)
                                     for r in self.rules]})

    @classmethod
    def from_env(cls, env: str = DEVICE_FAULTS_ENV
                 ) -> "DeviceFaultPlan | None":
        spec = os.environ.get(env)
        if not spec:
            return None
        try:
            doc = json.loads(spec)
        except ValueError as e:
            log.error("ignoring malformed %s: %s", env, e)
            return None
        allowed = {f.name for f in dataclasses.fields(DeviceFaultRule)}
        try:
            rules = [DeviceFaultRule(
                **{k: v for k, v in r.items() if k in allowed})
                for r in doc.get("rules", [])]
            return cls(rules)
        except (TypeError, ValueError) as e:
            log.error("ignoring malformed %s: %s", env, e)
            return None

    @classmethod
    def seeded(cls, seed: int, devices: Sequence[str],
               p_dead: float = 0.0, p_nan: float = 0.0,
               after_launches: int = 0) -> "DeviceFaultPlan":
        """Reproducible random campaign over device labels: each device
        independently draws a permanent device-loss or NaN-output fault
        (hw/faults determinism rule — same seed, same casualties)."""
        rng = np.random.default_rng(seed)
        rules = []
        for d in devices:
            u = float(rng.random())
            if u < p_dead:
                rules.append(DeviceFaultRule(
                    device=d, kind="device_lost",
                    after_launches=after_launches))
            elif u < p_dead + p_nan:
                rules.append(DeviceFaultRule(
                    device=d, kind="nan_output",
                    after_launches=after_launches))
        return cls(rules)


class DeviceFaultInjector:
    """Per-process launch counters + fired-fault ledger over one plan.

    ``injected`` logs every (monotonic t, device, launch index, kind)
    that actually fired, so the lane-chaos gate can measure
    ``lane_failover_s`` from the FIRST injection and assert the lane
    health report records exactly the injected faults."""

    def __init__(self, plan: DeviceFaultPlan, sleep=time.sleep):
        self.plan = plan
        self._sleep = sleep
        self._lock = threading.Lock()
        self._launches: dict[str, int] = defaultdict(int)
        self.injected: list[tuple[float, str, int, str]] = []

    def next_fault(self, device_label: str) -> DeviceFaultRule | None:
        """Count one launch on ``device_label``; the rule that fires for
        it, if any (recorded in the ledger). Quarantine PROBES count as
        launches too, deliberately: a dead device receives no worker
        launches, so a count-limited (transient) outage could otherwise
        never expire while quarantined — probe attempts are what walk
        the fault window shut, and a probe a rule fires against IS an
        injected fault in the ledger."""
        with self._lock:
            launch = self._launches[device_label]
            self._launches[device_label] += 1
            rule = self.plan.fault_for(device_label, launch)
            if rule is not None:
                self.injected.append((time.monotonic(), device_label,
                                      launch, rule.kind))
        if rule is not None:
            log.debug("chaos: device fault %r injected (%s launch %d)",
                      rule.kind, device_label, launch)
        return rule

    def first_fault_t(self) -> float | None:
        """Monotonic stamp of the first fired fault (the lane-chaos
        bench's ``lane_failover_s`` zero point), or None."""
        with self._lock:
            return self.injected[0][0] if self.injected else None

    def fire_pre_launch(self, rule: DeviceFaultRule,
                        device_label: str) -> None:
        """The pre-launch side of a fired rule: stall and/or raise.
        ``nan_output`` does nothing here (the launch must succeed so
        the poisoned payload flows through the readback path)."""
        if rule.kind in ("latency", "hang"):
            self._sleep(rule.stall_s)
        if rule.kind == "device_lost" or rule.kind == "hang":
            raise DeviceLostError(
                f"injected device loss on {device_label} "
                f"(kind={rule.kind})")

    @staticmethod
    def poison_output(out):
        """The post-launch side of ``nan_output``: the launch succeeded
        but the chip returned garbage — every point lane becomes NaN
        while validity still claims them good (exactly the payload the
        SL_SANITIZE finite-check must catch at the readback
        boundary)."""
        import types

        if hasattr(out.points, "new_full"):   # a tensor, on its device
            points = out.points.new_full(out.points.shape, float("nan"))
        else:
            points = np.full(np.shape(out.points), np.nan, np.float32)
        return types.SimpleNamespace(points=points, colors=out.colors,
                                     valid=out.valid)


class FaultyDevice:
    """Wraps one program at the lane boundary (`serve/worker.py`):
    launches on the wrapped device consult the injector first, so a
    seeded plan turns one chip of a healthy pool into a dead / stalling
    / NaN-emitting one without touching the runtime."""

    def __init__(self, compiled, device_label: str,
                 injector: DeviceFaultInjector):
        self.compiled = compiled
        self.device_label = device_label
        self.injector = injector

    def __call__(self, *args):
        rule = self.injector.next_fault(self.device_label)
        if rule is not None:
            self.injector.fire_pre_launch(rule, self.device_label)
        out = self.compiled(*args)
        if rule is not None and rule.kind == "nan_output":
            out = self.injector.poison_output(out)
        return out


class FaultySpan:
    """Span-member targeting for the sharded cross-chip tier: wraps one
    sharded program and consults the injector for EVERY device in
    the program's span, so an ``SL_DEVICE_FAULTS`` rule naming a single
    member (``"cpu:0"``) kills/poisons the whole sharded launch — which
    is exactly what a real mesh does when one chip dies. Each member's
    launch counter advances per sharded launch (a span launch IS a
    launch on every member), keeping count-limited (transient) rules'
    windows consistent with the per-lane wrapper's.

    The raised loss deliberately does NOT name the guilty member to the
    caller-visible error flow the worker classifies on — attribution is
    the probe-convict protocol's job (`serve/service.py`,
    docs/ROBUSTNESS.md), and a chaos error that confessed would test
    nothing."""

    def __init__(self, compiled, span: Sequence[str],
                 injector: DeviceFaultInjector):
        self.compiled = compiled
        self.span = tuple(span)
        self.injector = injector

    def __call__(self, *args):
        fired = None
        for label in self.span:
            rule = self.injector.next_fault(label)
            if rule is not None and fired is None:
                fired = (rule, label)
        if fired is not None:
            rule, label = fired
            if rule.kind in ("latency", "hang"):
                self.injector._sleep(rule.stall_s)
            if rule.kind in ("device_lost", "hang"):
                raise DeviceLostError(
                    "injected device loss on sharded span "
                    f"{'+'.join(self.span)} (kind={rule.kind})")
        out = self.compiled(*args)
        if fired is not None and fired[0].kind == "nan_output":
            out = self.injector.poison_output(out)
        return out


class FlakyChannel:
    """Fault wrapper over a ``CommandChannel``-shaped object: a ``drop``
    fault swallows the trigger (the phone never saw the command — the
    poll response was lost in flight)."""

    def __init__(self, inner, schedule: CallSchedule):
        self.inner = inner
        self.schedule = schedule
        self.injected: list[tuple[int, str]] = []

    @property
    def connected(self) -> bool:
        return self.inner.connected

    def trigger_capture(self, save_path: str, timeout: float = 20.0) -> bool:
        kind = self.schedule.next()
        if kind is not None:
            self.injected.append((self.schedule.calls - 1, kind))
            log.debug("chaos: trigger dropped (%s)", save_path)
            return False
        return self.inner.trigger_capture(save_path, timeout=timeout)
