"""Device & compile telemetry: program builds, device memory, recompile
storms (counterpart of the JAX ``utils/telemetry.py``).

A serving process that silently rebuilds its programs is a latency
mystery: the symptom is a multi-second p99 spike, the cause is an off-menu
shape three layers down. This module makes those builds a first-class
metric:

* :class:`DeviceTelemetry` — the port has no jit, so its "compiles" are
  the serve ``ProgramCache``'s builds (kernel library built if it is not,
  then one run of the program on a zero batch of its exact shape), which
  report themselves through :func:`note_compile`. Each installed telemetry
  meters them into its registry as ``sl_compile_total`` + an
  ``sl_compile_seconds`` histogram.
* **recompile-storm detector** — a sliding window over compile times; a
  burst above threshold increments ``sl_recompile_storms_total`` and
  records a warning event in the flight recorder, so "it rebuilt 40 times
  in a minute" is an alert, not archaeology.
* :meth:`DeviceTelemetry.sample_memory` — per-card ``bytes_in_use`` /
  ``peak_bytes_in_use`` gauges from ``torch.cuda.memory_stats`` (the
  caching allocator's live and peak bytes) with the card's
  ``total_memory`` as its limit; a host without a card reports ``cpu:0``
  with no stats and the gauges stay absent.

* :meth:`DeviceTelemetry.sample_kernel_launches` — the port's own hand-
  written kernels: every wrapper counts the launches of its kernel on the
  card (``<wrapper>.launches``; a CPU tensor takes the plain version and
  counts nothing), and each scrape folds the growth since the last one
  (or since the telemetry was made) into
  ``serve_kernel_launches_total{kernel=...}``. A replica is its own
  process, so its ``/metrics`` is how a fleet shows that the replica ran
  its kernels on the card.

One process-level fan-out dispatches to every installed
:class:`DeviceTelemetry`, so tests can install a telemetry against a
private registry and uninstall it without disturbing the process-global
one.
"""

from __future__ import annotations

import collections
import threading
import time

from . import events as events_mod
from . import trace
from .log import get_logger

log = get_logger(__name__)

#: The port's kernels by name: (module under the package, wrapper).
KERNELS = {"decode_maps": ("ops.decode", "decode_maps"),
           "nearest_one": ("ops.nn", "nearest_one"),
           "matvec_band": ("ops.poisson_matvec", "matvec_band"),
           "classify_bricks": ("ops.marching_classify", "classify_bricks"),
           "tsdf_combine": ("ops.tsdf_combine", "tsdf_combine"),
           "brick_knn_cells": ("ops.brickknn_kernel", "brick_knn_cells"),
           "composite_cells": ("ops.splat_composite", "composite")}


def kernel_wrappers() -> dict:
    """Every kernel's wrapper, by kernel name (imports the wrappers, never
    their bindings); each counts its launches in ``.launches``."""
    import importlib

    root = __name__.rsplit(".", 2)[0]
    return {name: getattr(importlib.import_module(f"{root}.{mod}"), attr)
            for name, (mod, attr) in KERNELS.items()}


def kernel_launches() -> dict[str, int]:
    """Every kernel wrapper's launch count in this process, by kernel
    name."""
    return {name: int(fn.launches)
            for name, fn in kernel_wrappers().items()}


# Fan-out: every installed telemetry hears every program build.
_DISPATCH_LOCK = threading.Lock()
_DISPATCH: list["DeviceTelemetry"] = []


def note_compile(duration_s: float) -> None:
    """One program build of ``duration_s`` seconds, metered into every
    installed :class:`DeviceTelemetry` (the ``ProgramCache`` calls this)."""
    with _DISPATCH_LOCK:
        sinks = list(_DISPATCH)
    for t in sinks:
        t.observe_compile(duration_s)


class DeviceTelemetry:
    """Compile + device-memory meters over one :class:`MetricsRegistry`."""

    def __init__(self, registry: "trace.MetricsRegistry | None" = None,
                 recorder: "events_mod.FlightRecorder | None" = None,
                 storm_window_s: float = 30.0,
                 storm_threshold: int = 20):
        self.registry = registry if registry is not None else trace.REGISTRY
        self.recorder = (recorder if recorder is not None
                         else events_mod.RECORDER)
        self.storm_window_s = float(storm_window_s)
        self.storm_threshold = int(storm_threshold)
        self._lock = threading.Lock()
        self._recent: collections.deque[float] = collections.deque()
        self._in_storm = False
        self.monitoring_available: bool | None = None
        self._compiles = self.registry.counter(
            "sl_compile_total", "program builds observed")
        self._compile_s = self.registry.histogram(
            "sl_compile_seconds", "per-compile wall-clock",
            buckets=trace.COMPILE_SECONDS_BUCKETS)
        self._storms = self.registry.counter(
            "sl_recompile_storms_total",
            "compile bursts above the storm threshold")
        self._launches = {
            k: self.registry.counter(
                "serve_kernel_launches_total",
                "launches of the port's hand-written kernels on the card",
                kernel=k)
            for k in KERNELS}
        # Launches made before this telemetry are not its service's: the
        # counters start from the wrappers' counts now.
        self._launches_seen: dict[str, int] = kernel_launches()

    # -- lifecycle ---------------------------------------------------------

    def install(self) -> "DeviceTelemetry":
        """Start receiving compile events. Idempotent."""
        self.monitoring_available = True
        with _DISPATCH_LOCK:
            if self not in _DISPATCH:
                _DISPATCH.append(self)
        return self

    def uninstall(self) -> None:
        with _DISPATCH_LOCK:
            if self in _DISPATCH:
                _DISPATCH.remove(self)

    # -- compile metering --------------------------------------------------

    @property
    def compiles_total(self) -> int:
        """Program builds observed by THIS telemetry since install()."""
        return int(self._compiles.value)

    def observe_compile(self, duration_s: float) -> None:
        self._compiles.inc()
        self._compile_s.observe(float(duration_s))
        now = time.monotonic()
        with self._lock:
            self._recent.append(now)
            horizon = now - self.storm_window_s
            while self._recent and self._recent[0] < horizon:
                self._recent.popleft()
            burst = len(self._recent)
            storming = burst >= self.storm_threshold
            new_storm = storming and not self._in_storm
            self._in_storm = storming
        if new_storm:
            self._storms.inc()
            self.recorder.record(
                "recompile_storm", severity="warning",
                message=f"{burst} program builds inside "
                        f"{self.storm_window_s:.0f}s — check for "
                        "shape churn",
                compiles_in_window=burst)
            log.warning("recompile storm: %d compiles in %.0fs", burst,
                        self.storm_window_s)

    # -- device memory -----------------------------------------------------

    def sample_memory(self) -> dict:
        """Refresh per-card memory gauges; returns {device: stats} with
        ``bytes_in_use`` (the allocator's live bytes), ``peak_bytes_in_use``
        and ``bytes_limit`` (the card's total memory). A host without a
        card reports ``cpu:0`` with no stats, and nothing is gauged."""
        import torch

        out: dict[str, dict] = {}
        if not torch.cuda.is_available():
            out["cpu:0"] = {}
            return out
        for i in range(torch.cuda.device_count()):
            name = f"cuda:{i}"
            try:
                raw = torch.cuda.memory_stats(i)
                limit = torch.cuda.get_device_properties(i).total_memory
            except RuntimeError as e:
                log.debug("memory stats of %s failed: %s", name, e)
                out[name] = {}
                continue
            stats = {
                "bytes_in_use": int(raw.get("allocated_bytes.all.current",
                                            0)),
                "peak_bytes_in_use": int(raw.get("allocated_bytes.all.peak",
                                                 0)),
                "bytes_reserved": int(raw.get("reserved_bytes.all.current",
                                              0)),
                "bytes_limit": int(limit)}
            out[name] = stats
            self.registry.gauge(
                "sl_device_bytes_in_use",
                "live buffer bytes per device", device=name
            ).set(float(stats["bytes_in_use"]))
            self.registry.gauge(
                "sl_device_peak_bytes",
                "peak buffer bytes per device", device=name
            ).set(float(stats["peak_bytes_in_use"]))
        return out

    def memory_pressure(self) -> float:
        """Worst-device ``bytes_in_use / bytes_limit`` in [0, 1] — the
        overload governor's device-memory shedding signal. 0.0 when no
        device reports memory stats (CPU) or limits are absent."""
        worst = 0.0
        for stats in self.sample_memory().values():
            in_use = stats.get("bytes_in_use")
            limit = stats.get("bytes_limit") or stats.get(
                "bytes_reservable_limit")
            if in_use is not None and limit:
                worst = max(worst, float(in_use) / float(limit))
        return min(1.0, worst)

    # -- kernel launches ---------------------------------------------------

    def sample_kernel_launches(self) -> dict[str, int]:
        """Fold the wrappers' launch counts into
        ``serve_kernel_launches_total``: the growth since the last sample
        (a wrapper count that went down was zeroed by its caller, and all
        of its new value is growth). Returns the wrappers' counts."""
        now = kernel_launches()
        with self._lock:
            for k, n in now.items():
                last = self._launches_seen.get(k, 0)
                self._launches[k].inc(n - last if n >= last else n)
                self._launches_seen[k] = n
        return now

    # -- snapshots ---------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "monitoring_available": self.monitoring_available,
            "compiles_total": int(self._compiles.value),
            "compile_seconds": self._compile_s.snapshot(),
            "recompile_storms": int(self._storms.value),
            "device_memory": self.sample_memory(),
            "kernel_launches": self.sample_kernel_launches(),
        }


# ---------------------------------------------------------------------------
# Global default telemetry (lazy; serve/bench/diagnose call install_global)
# ---------------------------------------------------------------------------

_GLOBAL: DeviceTelemetry | None = None
_GLOBAL_LOCK = threading.Lock()


def install_global() -> DeviceTelemetry:
    """The process-default telemetry against ``trace.REGISTRY`` — created
    and installed once, returned thereafter."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = DeviceTelemetry().install()
        return _GLOBAL
