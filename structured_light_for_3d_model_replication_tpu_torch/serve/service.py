"""Service composition + stdlib HTTP front end, one replica on one device
(counterpart of the JAX package's ``serve/service.py``).

:class:`ReconstructionService` wires queue → batcher → program cache →
device workers into one lifecycle (start / serve / drain) and owns the
job registry clients poll. :class:`ServeHTTPServer` is the transport: a
``ThreadingHTTPServer`` (same dependency posture as `hw/command_server.py`
— no web framework) exposing

========================  ==================================================
``POST /submit``           ``.npy`` capture stack body (+ ``X-*`` option
                           headers) → ``{"job_id": ...}``; 429 + Retry-After
                           on backpressure, 503 while draining, 400 on a
                           malformed stack
``GET /status?id=``        job lifecycle + taxonomy error payload
``GET /result?id=``        the PLY/STL bytes (409 until done)
``GET /healthz``           liveness + drain flag + worker/queue state
``GET /metrics``           Prometheus text: queue depth, batch-occupancy
                           histogram, program-cache stats, per-stage span
                           latencies (utils/trace), compile/device-memory
                           telemetry (utils/telemetry)
``GET /events?n=``         flight-recorder journal tail as JSONL
                           (utils/events)
========================  ==================================================

The HTTP layer holds no state of its own — every handler delegates to the
service object, so in-process callers (tests, bench) and HTTP clients see
identical semantics.

The service runs on ``ServeConfig.device`` (None means every card, and a
host without one raises; the CPU serves only when asked for). Worker
lanes spread over the cards, sessions
stay on one lane's card, and buckets past ``shard_min_pixels`` run as one
program over a span of cards (serve/lanes.py). The fleet tier runs: peers'
content caches (``peers``, serve/fleet.py) and the session handoff volume
(``handoff_dir``) behind the router (serve/router.py).
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import threading
import time
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .._device import resolve_device
from ..config import DecodeConfig, ProjectorConfig, TriangulationConfig
from ..health import QualityGates
from ..stream import StreamParams
from ..utils import events, telemetry, trace
from ..utils.log import get_logger
from .batcher import BucketBatcher, BucketKey
from .cache import ContentCache, ProgramCache, content_key
from .fleet import PeerCacheClient
from .governor import GovernorParams, OverloadGovernor
from .jobs import (
    DONE,
    FAILED,
    AdmissionQueue,
    Job,
    JobRejected,
    StackFormatError,
    error_payload,
)
from .lanes import LANE_DEAD, DeviceLanePool
from .sessions import SessionManager, UnknownSessionError
from .store import JournalStore, SessionStreamStore
from .tenants import TenantQuotas
from .worker import DeviceWorker

log = get_logger(__name__)

_PRIORITY_NAMES = {"high": 0, "normal": 1, "low": 2}
_CONTENT_TYPES = {"ply": "application/x-ply",
                  "stl": "model/stl",
                  "mesh_ply": "application/x-ply",  # vertex-colored mesh
                  "render_png": "image/png",  # splat novel-view render
                  "json": "application/json"}  # session-stop payloads
#: What a ONE-SHOT submit may ask for — the worker's postprocess menu.
#: ``json`` is the session-stop payload shape and ``render_png`` needs a
#: session's fitted splat scene; neither is a worker artifact.
_SUBMIT_FORMATS = ("ply", "stl", "mesh_ply")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Service tuning surface (docs/SERVING.md has the tuning guide)."""

    # The device the replica serves on: None means every card (a host
    # without one raises); "cpu" runs the plain PyTorch versions.
    device: str | None = None
    proj: ProjectorConfig = ProjectorConfig()
    decode_cfg: DecodeConfig = DecodeConfig()
    tri_cfg: TriangulationConfig = TriangulationConfig()
    gates: QualityGates = QualityGates()

    queue_depth: int = 64          # bounded admission (backpressure above)
    linger_ms: float = 10.0        # max wait for batch company
    workers: int = 1               # device launch lanes
    # Device dimension (serve/lanes.py): worker lanes spread round-robin
    # over up to this many local devices (None = all of them).
    # workers=N with N cards visible is the one-lane-per-card topology;
    # the default workers=1 keeps the single-device service.
    devices: int | None = None
    # Sharded big-bucket tier: a bucket whose padded H*W meets this
    # threshold dispatches ONE cross-card program (camera rows split over
    # parallel/mesh.py's space axis, spanning shard_devices cards; 0 = all
    # visible) instead of serializing on a single lane — and its Poisson
    # postprocess solves on one of those cards. None disables the tier.
    shard_min_pixels: int | None = None
    shard_devices: int = 0
    buckets: tuple = ((1080, 1920),)   # padded (H, W) shapes
    batch_sizes: tuple = (1, 2, 4, 8)
    max_cache_entries: int = 32
    warmup: bool = True            # build buckets × batch sizes at start
    # Run the SESSION lane once too (stream/warmup.py): per-stop
    # registration, windowed refine, model fuse and the preview chain
    # pay their first-use costs at replica start instead of inside the
    # first session. Only applies when ``warmup`` is on.
    warmup_sessions: bool = True
    mesh_depth: int = 7            # STL results: Poisson depth
    # Scene representation for one-shot STL/mesh_ply results
    # (docs/MESHING.md): "poisson" watertight print path, "tsdf" the
    # fused colored-surface path (fusion/).
    mesh_representation: str = "poisson"
    completed_cap: int = 256       # terminal jobs kept for /status///result
    # Byte budget for retained result payloads (a 1080p PLY is ~30 MB —
    # 256 of those would pin ~8 GB; the count cap alone doesn't bound
    # memory). Oldest terminal jobs are evicted past EITHER cap.
    result_cache_bytes: int = 512 << 20
    # Compile/memory telemetry (docs/OBSERVABILITY.md): sl_compile_total,
    # sl_compile_seconds, device-memory gauges and the recompile-storm
    # detector on this service's /metrics.
    telemetry: bool = True
    # Streaming sessions (docs/STREAMING.md): per-session incremental
    # fusion defaults and the bounded live-session cap. Per-session
    # overrides are limited to the non-compiling surface
    # (`sessions.SESSION_OPTION_KEYS`).
    stream: StreamParams = StreamParams()
    max_sessions: int = 8
    # Idle expiry for sessions (live AND finalized): a crashed client's
    # abandoned session frees its slot + model buffers after this.
    session_ttl_s: float = 3600.0
    # -- durability (serve/store.py; docs/SERVING.md § durability) --------
    # Journal volume: crash-safe WAL of job admissions/terminals and
    # per-session accepted stops, plus the persistent half of the
    # content cache. None = in-memory service (the historical behavior);
    # set it and restart with start(recover_from=...) / `--recover` to
    # survive kill -9.
    store_dir: str | None = None
    # Content-hash result cache: duplicate submits (same stack bytes +
    # same processing config) return the finished artifact at admission
    # without touching the queue — and, with a store_dir, across
    # restarts and past result-registry eviction.
    content_cache: bool = True
    content_cache_bytes: int = 256 << 20
    # Overload governor (serve/governor.py): circuit breaker on the
    # worker-exception rate, graduated load shedding (previews first,
    # then low-priority admissions), worker watchdog.
    governor: GovernorParams = GovernorParams()
    # -- fleet tier (serve/fleet.py, serve/router.py; SERVING.md § fleet)
    # Replica identity: stamped into journaled session heads and the
    # /healthz//readyz payloads; None = a fresh random id per process.
    replica_id: str | None = None
    # Peer base URLs for the shared content cache: a local miss at
    # admission consults peers' ``GET /cache/<key>`` (bounded timeouts,
    # per-peer breakers, single-flight, negative TTL) before computing.
    peers: tuple = ()
    peer_timeout_s: float = 2.0     # per-peer request bound
    peer_budget_s: float = 3.0      # whole peer-lookup bound
    peer_negative_ttl_s: float = 5.0
    # Shared session-handoff volume: the WAL streams session ops there
    # (SessionStreamStore sink) so a survivor replica can adopt a dead
    # replica's live sessions. Requires store_dir (the stream rides the
    # WAL's group commit). May be a local directory (the historical
    # shared-POSIX layout) or an object-store spec
    # (``http://host:port[/prefix]`` — serve/blobstore.py; replicas
    # then share no filesystem at all).
    handoff_dir: str | None = None
    # -- per-tenant admission quotas (serve/tenants.py) -------------------
    # Sustained admissions/s per tenant (the X-Tenant header; 0 = quotas
    # off) and the token bucket's burst headroom. Enforced at admission
    # BEFORE the queue and governor — one hot client can't starve the
    # fleet — with retryable 429s (taxonomy TenantQuotaError +
    # Retry-After) and per-tenant serve_tenant_* counters. Content-cache
    # hits are exempt (they cost the fleet nothing).
    tenant_rate_per_s: float = 0.0
    tenant_burst: int = 8
    # Cost-weighted tenant spend (`tenants.stack_cost`): a token spend
    # proportional to the stack's MEGAPIXELS instead of 1-per-submit —
    # a 4K stack and a 240p stack stop costing the same. Rejections
    # refund the exact cost spent (the refund-parity contract). The
    # headers-time probe checks at the COST FLOOR (the body — and with
    # it the true cost — hasn't been read yet, and probing higher
    # would 429 cheap stacks a weighted admit accepts); the
    # authoritative weighted spend happens at admission.
    tenant_cost_weighted: bool = False
    # -- device-loss tolerance (serve/lanes.py; SERVING.md failure
    # matrix). A device declared dead (lane-health escalation or the
    # watchdog's per-device budget) is probed with a tiny synthetic
    # program at this cadence, doubling per miss up to the cap; a probe
    # that answers re-warms the lane and returns it to the pool.
    device_probe_interval_s: float = 5.0
    device_probe_backoff_max_s: float = 60.0


def _pool_devices(device) -> list | None:
    """``ServeConfig.device`` as the lane pool's device list: one named
    device is a pool of one, and None is every card (the pool enumerates
    them; a host without one raises)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return None
    return [dev]


def _current_card(dev: torch.device):
    """``dev`` as the thread's current CUDA device for the enclosed work; a
    no-op on the host."""
    import contextlib

    if dev.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def synthetic_calib_provider(proj: ProjectorConfig, device=None):
    """Per-bucket synthetic rig calibration (the no-hardware default —
    the same `models/synthetic.default_calibration` geometry the bench
    and tests use), built on ``device`` (None means the card). Memoized
    per (H, W): Calibration tensors are shared by every batch of that
    bucket."""
    from ..models import synthetic
    from ..ops.triangulate import make_calibration

    lock = threading.Lock()
    cache: dict = {}

    def provider(height: int, width: int):
        with lock:
            calib = cache.get((height, width))
        if calib is not None:
            return calib
        cam_K, proj_K, R, T = synthetic.default_calibration(
            height, width, proj)
        calib = make_calibration(cam_K, proj_K, R, T, height, width,
                                 proj_width=proj.width,
                                 proj_height=proj.height, device=device)
        with lock:
            cache[(height, width)] = calib
        return calib

    return provider


def fixed_calib_provider(calib):
    """Single-rig provider from a loaded calibration (``--calib`` .mat):
    only the bucket matching its camera geometry is servable."""
    h, w = int(calib.Nc.shape[0]), int(calib.Nc.shape[1])

    def provider(height: int, width: int):
        if (height, width) != (h, w):
            raise StackFormatError(
                f"service calibration is {h}x{w}; bucket "
                f"{height}x{width} has no calibration")
        return calib

    return provider


class ReconstructionService:
    """Queue → batcher → cache → workers, one lifecycle, one job registry."""

    def __init__(self, config: ServeConfig = ServeConfig(),
                 calib_provider=None,
                 registry: "trace.MetricsRegistry | None" = None,
                 tracer: "trace.Tracer | None" = None,
                 lane_devices=None):
        """``lane_devices`` gives the lane pool its devices in enumeration
        order, for a caller that picks them itself (the tests' host lanes
        ``torch.device("cpu", k)``); None takes them from
        ``config.device``."""
        self.config = config
        pool_devices = (_pool_devices(config.device) if lane_devices is None
                        else [resolve_device(d) for d in lane_devices])
        self.device = pool_devices[0] if pool_devices else resolve_device()
        # Fresh registry per service by default: parallel services (tests,
        # bench sweeps) must not sum each other's counters. Pass
        # trace.REGISTRY explicitly to meter into the process-global one.
        self.registry = registry if registry is not None \
            else trace.MetricsRegistry()
        self.tracer = tracer if tracer is not None else trace.GLOBAL
        self.queue = AdmissionQueue(max_depth=config.queue_depth)
        self.batcher = BucketBatcher(
            self.queue, buckets=config.buckets,
            batch_sizes=config.batch_sizes,
            linger_s=config.linger_ms / 1e3)
        self.calib_provider = (calib_provider if calib_provider is not None
                               else synthetic_calib_provider(config.proj,
                                                             self.device))
        # Fleet identity: journaled session heads carry it, so a
        # restarting replica can tell "still mine" from "a survivor
        # adopted this while I was dead" (handoff-aware recovery).
        self.replica_id = config.replica_id or f"r-{uuid.uuid4().hex[:8]}"
        # Shared session-handoff volume (fleet tier): session ops stream
        # there as the WAL sink, riding the group commit.
        if config.handoff_dir is not None and config.store_dir is None:
            raise ValueError(
                "handoff_dir requires store_dir — the handoff stream is "
                "a sink of the WAL's group commit")
        self.handoff: SessionStreamStore | None = (
            SessionStreamStore(config.handoff_dir)
            if config.handoff_dir is not None else None)
        # Durability journal + persistent content cache share one volume.
        self.store: JournalStore | None = (
            JournalStore(config.store_dir, sink=self.handoff)
            if config.store_dir is not None else None)
        self.content_cache: ContentCache | None = (
            ContentCache(max_bytes=config.content_cache_bytes,
                         dir=(self.store.content_dir
                              if self.store is not None else None),
                         registry=self.registry)
            if config.content_cache else None)
        # Peer half of the shared content cache (serve/fleet.py):
        # consulted at admission after a local miss; every degraded mode
        # converges on "compute locally", never a stall.
        self.peer_cache: PeerCacheClient | None = (
            PeerCacheClient(config.peers,
                            timeout_s=config.peer_timeout_s,
                            budget_s=config.peer_budget_s,
                            negative_ttl_s=config.peer_negative_ttl_s,
                            registry=self.registry)
            if (config.peers and config.content_cache) else None)
        # Constructed here (its counter families must exist in the
        # registry from the first scrape) but installed into the compile-
        # event dispatch only for the start→drain window, so an abandoned
        # or failed service never keeps receiving process-wide events.
        self.telemetry: "telemetry.DeviceTelemetry | None" = (
            telemetry.DeviceTelemetry(registry=self.registry)
            if config.telemetry else None)
        self.governor = OverloadGovernor(
            config.governor, self.queue, self.registry,
            telemetry=self.telemetry, store=self.store)
        # Per-tenant admission quotas (serve/tenants.py); None = off.
        self.tenants: TenantQuotas | None = (
            TenantQuotas(config.tenant_rate_per_s, config.tenant_burst,
                         self.registry)
            if config.tenant_rate_per_s > 0 else None)
        # Device-lane pool (serve/lanes.py): every worker lane is pinned
        # to one local device; sessions get sticky lanes; buckets past
        # shard_min_pixels route to the cross-chip sharded tier. The
        # pool also owns lane HEALTH — its device-dead transitions call
        # back into _on_device_dead (cross-lane re-pin, worker
        # deactivation, probe-revive scheduling).
        self.lanes = DeviceLanePool(
            n_lanes=max(1, config.workers),
            max_devices=config.devices,
            shard_min_pixels=config.shard_min_pixels,
            shard_devices=config.shard_devices,
            devices=pool_devices,
            registry=self.registry)
        # Sharded keys resolve their span in the pool's enumeration order.
        self.cache = ProgramCache(self.calib_provider,
                                  max_entries=config.max_cache_entries,
                                  registry=self.registry,
                                  device=self.device,
                                  devices=self.lanes.devices)
        self.lanes.on_device_dead = self._on_device_dead
        # Sharded-fault attribution (docs/ROBUSTNESS.md § probe-
        # convict): N consecutive faults on one sharded span fire this
        # hook; the service probes each member and convicts the dead
        # one — the only way a sharded-only workload ever detects a
        # chip death (the launch error can't name the member).
        self.lanes.on_span_suspect = self._on_span_suspect
        # Lane re-resolution at absorb time (device-loss tier): a stop
        # whose session re-pinned must ride the adopting lane's buckets.
        self.batcher.lane_resolver = self._resolve_lane
        # Seeded device chaos (hw/faults.py): SL_DEVICE_FAULTS arms a
        # FaultyDevice shim at every lane's launch boundary — how the
        # chaos bench and the multichip-chaos CI gate kill a chip.
        from ..hw import faults as hwfaults

        plan = hwfaults.DeviceFaultPlan.from_env()
        self.fault_injector = (hwfaults.DeviceFaultInjector(plan)
                               if plan is not None else None)
        if self.fault_injector is not None:
            log.warning("device faults armed: %d rule(s)",
                        len(plan.rules))
        # Probe-revive bookkeeping: device label -> (backoff_s, due_t).
        self._probe_plan: dict[str, tuple[float, float]] = {}
        self._probe_stop = threading.Event()
        self._probe_thread: threading.Thread | None = None
        self._queue_depth0 = config.queue_depth
        self._workers_lock = threading.Lock()
        self._worker_seq = max(1, config.workers)
        self.workers = [self._make_worker(f"serve-worker-{i}",
                                          self.lanes.lane(i))
                        for i in range(max(1, config.workers))]
        self._jobs_lock = threading.Lock()
        self._jobs: OrderedDict[str, Job] = OrderedDict()
        self._draining = False
        self._started = False
        self._jobs_total = lambda status: self.registry.counter(
            "serve_jobs_total", "jobs by admission/terminal status",
            status=status)
        self._queue_gauge = self.registry.gauge(
            "serve_queue_depth", "jobs waiting in the admission queue")
        # Per-job latency histograms: seconds-valued, so they take the
        # explicit latency bucket layout (the occupancy-shaped Histogram
        # default would bin every sub-second wait into `le="1"`).
        self._queue_wait_s = self.registry.histogram(
            "serve_job_queue_wait_seconds",
            "submit-to-start wait per job",
            buckets=trace.LATENCY_SECONDS_BUCKETS)
        self._run_s = self.registry.histogram(
            "serve_job_run_seconds", "start-to-terminal time per job",
            buckets=trace.LATENCY_SECONDS_BUCKETS)
        self._events_seen: dict[str, int] = {}  # _sync_event_counters
        self._events_seen_lock = threading.Lock()
        self._warmup_report: dict = {}
        self._ready = False  # /readyz: warmup + recovery complete
        self.sessions = SessionManager(
            config.stream, config.proj, config.decode_cfg, config.tri_cfg,
            max_sessions=config.max_sessions,
            session_ttl_s=config.session_ttl_s,
            store=self.store,
            preview_shed=self.governor.shed_previews,
            replica_id=self.replica_id,
            lane_pool=self.lanes if self.lanes.multi_device else None,
            device=self.lanes.lane(0).device)

    def _make_worker(self, name: str, lane) -> DeviceWorker:
        return DeviceWorker(self.batcher, self.cache,
                            gates=self.config.gates,
                            mesh_depth=self.config.mesh_depth,
                            registry=self.registry, tracer=self.tracer,
                            name=name, governor=self.governor,
                            mesh_representation=self.config
                            .mesh_representation,
                            lane=lane, lane_pool=self.lanes,
                            fault_injector=self.fault_injector)

    def _restart_worker(self, wedged: DeviceWorker) -> DeviceWorker:
        """Watchdog callback: replace one wedged worker with a fresh
        lane ON THE SAME DEVICE — the wedged worker's sticky sessions
        and per-device programs live there, so a replacement that
        migrated would rebuild them (and strand every session pinned to
        the lane). The wedged thread is asked to stop but cannot be killed —
        if its launch ever returns, Job's first-terminal-wins rule makes
        the race harmless."""
        wedged.request_stop()
        wedged.abort()
        with self._workers_lock:
            self._worker_seq += 1
            repl = self._make_worker(
                f"serve-worker-r{self._worker_seq}", wedged.lane)
            self.workers = [repl if w is wedged else w
                            for w in self.workers]
        repl.start()
        return repl

    # -- device-loss tolerance (serve/lanes.py; SERVING.md) ---------------

    def _escalate_worker_device(self, worker: DeviceWorker) -> None:
        """Watchdog escalation: a device whose per-device restart budget
        is spent (every fresh lane wedges) is declared DEAD — the pool's
        callback then re-pins its sessions and schedules the probe."""
        if worker.lane is None:
            return
        self.lanes.mark_device_dead(worker.lane.label,
                                    reason="watchdog budget exhausted")

    def _resolve_lane(self, job: Job) -> int | None:
        """Batcher lane hook: the lane a job should ride NOW. Session
        stops follow their session's CURRENT sticky lane (it may have
        re-pinned since the stop was submitted); anything stamped with
        a dead lane re-routes to the least-loaded survivor."""
        pool = self.lanes
        if not pool.multi_device:
            return job.lane
        if job.session_id is not None and job.launch_retries == 0:
            # Session affinity — EXCEPT for a job the device-loss path
            # already re-laned: its explicit retry placement must win,
            # or the resolver would bounce it straight back onto the
            # sick (not-yet-dead) lane it just died on, burning the
            # retry budget without ever reaching a survivor.
            entry = self.sessions.peek(job.session_id)
            if entry is not None and entry.lane is not None \
                    and pool.lane_alive(entry.lane.index):
                return entry.lane.index
        if job.lane is None or pool.lane_alive(job.lane):
            return job.lane
        target = pool.retry_lane()
        return target.index if target is not None else job.lane

    def _lane_program_keys(self, lane) -> list:
        """The ProgramKeys a worker on ``lane`` can dispatch to, over
        the configured buckets × batch sizes — the single definition of
        the warmed program set, shared by start()'s warmup and the
        probe path's re-warm (divergence would silently re-introduce
        post-revive compiles in the worker hot path)."""
        keys = []
        for h, w in self.config.buckets:
            bkey = self._bucket_key(h, w)
            for b in self.config.batch_sizes:
                keys.append(self.lanes.route(bkey, int(b), lane))
        return keys

    def _span_program_keys(self, span) -> list:
        """The sharded ProgramKeys the router would answer over an
        EXPLICIT span, for every configured bucket × batch — the warm
        set for a span about to come into service (probe-convict
        re-form, revival restore). Warming these OFF the worker hot
        path is what keeps the zero-recompile steady state across a
        span change."""
        keys = []
        for h, w in self.config.buckets:
            bkey = self._bucket_key(h, w)
            for b in self.config.batch_sizes:
                k = self.lanes.span_program_key(bkey, int(b), span)
                if k is not None:
                    keys.append(k)
        return keys

    def _warm_span_programs(self, span) -> bool:
        """Compile/warm the sharded programs for ``span``; True when
        every key is resident afterwards. Failures are contained — the
        worker's next dispatch would compile inline (counted, slower,
        but correct), so a warm failure must not block the span change
        that routing has already made."""
        ok = True
        for k in self._span_program_keys(span):
            try:
                self.cache.get(k)
            except Exception as e:
                ok = False
                events.record("span_warm_failed", severity="error",
                              program=k.label(), message=str(e))
        return ok

    def _on_span_suspect(self, span) -> None:
        """Probe-convict: the pool saw N consecutive device-class
        faults on sharded launches over ``span`` (worker thread; no
        locks held). Run the tiny probe program on EVERY span member —
        the launch error couldn't name the casualty, the per-member
        probe can — and convict the ones that fail via
        ``mark_device_dead`` (which re-pins sessions, stops lane
        workers, and schedules the probe-revive cycle exactly like a
        lane-attributed death). Then warm the re-formed span's programs
        so surviving sharded traffic stays compile-free."""
        convicted = []
        for label in span:
            if self.lanes.device_state(label) == LANE_DEAD:
                continue  # already convicted (e.g. by a lane launch)
            if not self._probe_device(label):
                convicted.append(label)
        if not convicted:
            # Inconclusive: every member answered its probe. Transient
            # mesh failure (link blip, collective timeout) — leave the
            # span alone; another fault streak re-probes.
            events.record("span_probe_inconclusive", severity="warning",
                          span=list(span))
            return
        for label in convicted:
            events.record("span_member_convicted", severity="error",
                          device=label, span=list(span))
            log.error("sharded span %s: probe convicted member %s",
                      "+".join(span), label)
            self.lanes.mark_device_dead(
                label, reason="sharded-fault probe conviction")
        new_span = self.lanes.span_devices()
        if new_span:
            self._warm_span_programs(new_span)
        if self.store is not None:
            self.store.note("span_reformed", convicted=convicted,
                            span=list(new_span))

    def _lane_device_count(self) -> int:
        return len(self.lanes.distinct_devices())

    def _rescale_queue(self) -> None:
        """Degraded-capacity honesty: the admission bound tracks the
        live-device fraction, so /readyz, /fleet/signals and the 429
        backpressure all describe the pool that actually exists."""
        total = self._lane_device_count()
        if total <= 1:
            return
        live = max(0, total - len(self.lanes.dead_devices()))
        self.queue.set_max_depth(
            max(1, round(self._queue_depth0 * max(1, live) / total)))
        self._queue_gauge.set(self.queue.depth())

    def _on_device_dead(self, label: str) -> None:
        """The pool's dead-transition callback (worker or watchdog
        thread; no locks held). Contain the chip: stop its workers
        (their in-flight batch was already re-queued cross-lane), move
        its sticky sessions to surviving lanes (compile-free — every
        distinct lane device was session-warmed at start), re-key any
        pending work, shrink the admission bound, and schedule the
        probe-revive cycle."""
        with self._workers_lock:
            victims = [w for w in self.workers
                       if w.lane is not None and w.lane.label == label]
        for w in victims:
            # abandoned: the watchdog must not "replace" a deactivated
            # worker, and _revive_device's replacement scan must cover
            # a victim still ALIVE at revival time (e.g. blocked inside
            # a hung launch that outlives the quarantine) — skipping it
            # would leave the revived lane permanently worker-less.
            w.abandoned = True
            w.request_stop()
            w.abort()
        moved = self.lanes.repin_sessions(label)
        for sid, lane in moved.items():
            entry = self.sessions.peek(sid)
            if entry is not None:
                # repin migrates the session's device-resident state
                # too — committed arrays would otherwise keep pulling
                # compute back to the dead chip.
                entry.repin(lane)
        repinned = self.batcher.repin_pending()
        self._rescale_queue()
        if self.store is not None:
            self.store.note("device_dead", device=label,
                            sessions_repinned=len(moved))
        log.warning("device %s contained: %d worker(s) stopped, %d "
                    "session(s) re-pinned, %d pending job(s) re-keyed",
                    label, len(victims), len(moved), repinned)
        cfg = self.config
        self._probe_plan[label] = (
            cfg.device_probe_interval_s,
            time.monotonic() + cfg.device_probe_interval_s)
        if not self._draining:
            self._ensure_probe_thread()

    def _ensure_probe_thread(self) -> None:
        with self._workers_lock:
            if self._probe_thread is not None \
                    and self._probe_thread.is_alive():
                # Benign with the exit handshake in _probe_loop: a
                # thread seen alive here either already cleared
                # _probe_thread (we spawn fresh) or will re-check
                # dead_devices() under this same lock before exiting
                # and keep looping for the device that just died.
                return
            self._probe_stop.clear()
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="serve-device-probe",
                daemon=True)
            self._probe_thread.start()

    def _probe_loop(self) -> None:
        """Quarantine probing: each dead device gets a tiny synthetic
        launch at backoff cadence; success re-warms and revives the
        lane. The thread exits when nothing is dead (restarted by the
        next dead transition) — the exit re-checks under _workers_lock
        so a concurrent dead transition can never slip between the
        empty check and _ensure_probe_thread's is_alive() test and be
        left with no probe cycle."""
        tick = min(0.5, self.config.device_probe_interval_s / 2)
        while not self._probe_stop.wait(max(0.05, tick)):
            dead = self.lanes.dead_devices()
            if not dead:
                with self._workers_lock:
                    if self.lanes.dead_devices():
                        continue  # died between checks: keep probing
                    self._probe_thread = None
                    return
            now = time.monotonic()
            for label in dead:
                backoff, due = self._probe_plan.get(
                    label, (self.config.device_probe_interval_s, now))
                if now < due:
                    continue
                ok = self._probe_device(label)
                events.record("device_probe", severity="info",
                              device=label, ok=ok,
                              backoff_s=round(backoff, 2))
                # The plan is dropped only on a COMPLETED revival: a
                # probe that answered but whose re-warm failed keeps
                # the device dead, and must keep its backoff too — a
                # popped plan would retry probe + full re-warm every
                # tick in a hot loop.
                if ok and self._revive_device(label):
                    self._probe_plan.pop(label, None)
                else:
                    backoff = min(
                        backoff * 2,
                        self.config.device_probe_backoff_max_s)
                    self._probe_plan[label] = (backoff,
                                               now + backoff)

    def _probe_device(self, label: str) -> bool:
        """One probe launch on a dead device, THROUGH the fault
        boundary (a still-faulted chip must stay quarantined)."""
        if self.fault_injector is not None:
            # Counts as a launch on purpose (see next_fault): probes
            # are what let a count-limited transient outage expire
            # while the device is quarantined and worker-launch-free.
            rule = self.fault_injector.next_fault(label)
            if rule is not None and rule.kind != "latency":
                # Any still-armed fault keeps the chip quarantined —
                # including nan_output: the injector poisons WORKER
                # launches, not this probe's arithmetic, so treating a
                # NaN-emitting chip's probe as clean would revive it
                # into an indefinite die/revive flap. (Real hardware
                # needs no special case: whatever the sick chip
                # actually returns hits the finite check below.)
                return False
        dev = self.lanes.device_by_label(label)
        if dev is None:
            return False
        try:
            out = (torch.ones(8, device=dev) + 1).cpu().numpy()
            return bool(np.isfinite(out).all())
        except Exception as e:
            log.debug("device probe %s failed: %s", label, e)
            return False

    def _revive_device(self, label: str) -> bool:
        """Probe success: re-warm the lane's program set AND the
        restored (post-revival) sharded span's programs (cache hits
        when still resident; honest counted compiles when the LRU
        evicted them while dead), THEN rejoin — fresh workers, restored
        admission bound, fresh watchdog budget — and migrate the
        sessions that were displaced off this device back home
        (``rebalance_sessions``; compile-free via the per-device
        session warmup, so their finalize stays bitwise, with flap
        hysteresis so a bouncing chip doesn't thrash them). True iff
        the device actually rejoined (a failed re-warm keeps it dead
        and the caller keeps its probe backoff)."""
        lanes = self.lanes.lanes_on(label)
        if not lanes:
            return False
        try:
            for k in self._lane_program_keys(lanes[0]):
                if k.device == label:
                    self.cache.get(k)
            # The span this revival restores (the full set again once
            # every member is back): warmed BEFORE the device flips
            # live, so the first sharded dispatch after the re-form is
            # a hit, not an inline compile on the request path.
            for k in self._span_program_keys(
                    self.lanes.span_devices(assume_live=label)):
                self.cache.get(k)
        except Exception as e:
            events.record("device_rewarm_failed", severity="error",
                          device=label, message=str(e))
            return False  # stays dead; the probe retries at backoff
        self.lanes.revive_device(label)
        # Restore the admission bound in the same breath as the state
        # flip: anything watching device_state() may act on HEALTHY
        # immediately, and the worker-restart + rebalance steps below
        # can take a while on a loaded host.
        self._rescale_queue()
        self.governor.reset_restart_budget(label)
        with self._workers_lock:
            for lane in lanes:
                for i, w in enumerate(self.workers):
                    if w.lane is lane and (not w.alive
                                           or getattr(w, "abandoned",
                                                      False)):
                        self._worker_seq += 1
                        repl = self._make_worker(
                            f"serve-worker-r{self._worker_seq}", lane)
                        self.workers[i] = repl
                        repl.start()
        # Revival rebalancing: bring the displaced sticky sessions home
        # (after the fresh workers exist, so the lane can serve them).
        moved = self.lanes.rebalance_sessions(label)
        for sid, lane in moved.items():
            entry = self.sessions.peek(sid)
            if entry is not None:
                entry.repin(lane)
        if moved:
            self.batcher.repin_pending()
        if self.store is not None:
            self.store.note("device_revived", device=label,
                            sessions_rebalanced=len(moved))
        return True

    # -- lifecycle ---------------------------------------------------------

    def start(self, recover_from: "str | bool | None" = None
              ) -> "ReconstructionService":
        """Warm up, optionally recover a journal volume, start workers.

        ``recover_from``: True replays this service's own ``store_dir``;
        a path opens (and adopts) that volume. Recovery runs AFTER
        warmup — the replay rides the already-compiled B=1 lane — and
        BEFORE the workers start, so recovered jobs re-queue exactly
        once, ahead of fresh traffic. ``/readyz`` reports 503 until this
        method completes."""
        if recover_from and recover_from is not True \
                and self.store is not None and os.path.abspath(
                    str(recover_from)) != os.path.abspath(self.store.root):
            # Silently replaying the CONFIGURED volume while the caller
            # named a different one would "recover" nothing they asked
            # for and journal new state to the wrong disk.
            raise ValueError(
                f"recover_from={recover_from!r} conflicts with the "
                f"configured store_dir {self.store.root!r} — a service "
                "journals to exactly one volume")
        if recover_from and self.store is None:
            if recover_from is True:
                raise ValueError("recover_from=True needs a configured "
                                 "store_dir")
            self.store = JournalStore(str(recover_from),
                                      sink=self.handoff)
            self.sessions.store = self.store
            self.governor.store = self.store
            if self.content_cache is not None:
                # Adopting the volume adopts its persistent content
                # cache too — the memory-only cache built when store_dir
                # was unset would miss every pre-restart artifact.
                self.content_cache = ContentCache(
                    max_bytes=self.config.content_cache_bytes,
                    dir=self.store.content_dir, registry=self.registry)
        if self.telemetry is not None:
            self.telemetry.install()   # before warmup: count its compiles
        try:
            if self.config.warmup:
                # Warm EXACTLY the program set the lane router will
                # dispatch to (serve/lanes.py): per-device keys for
                # every distinct lane chip, the cross-chip sharded key
                # for buckets past shard_min_pixels, the historical
                # un-pinned keys on a single-device pool — so the
                # zero-recompile steady state holds per chip.
                t0 = time.monotonic()
                pkeys, seen = [], set()
                for lane in self.lanes.distinct_devices():
                    for k in self._lane_program_keys(lane):
                        if k not in seen:
                            seen.add(k)
                            pkeys.append(k)
                self._warmup_report = self.cache.warmup(
                    (), program_keys=pkeys)
                log.info("warmup: %d programs in %.1fs",
                         len(self._warmup_report), time.monotonic() - t0)
                if self.config.warmup_sessions:
                    # Session-lane warmup (stream/warmup.py): an adopted
                    # or recovered session must find the kernels built,
                    # the allocator's pools sized and the solver handles
                    # made. Runs ONCE PER DISTINCT LANE DEVICE: a session
                    # is sticky on its lane, and both first placement and
                    # failover adoption must find that card warm. It
                    # builds no ProgramKey, so the program cache's miss
                    # count stays buckets × batch sizes.
                    from ..stream.warmup import warm_session_programs

                    session_lanes = (self.lanes.distinct_devices()
                                     if self.lanes.multi_device
                                     else [None])
                    for h, w in self.config.buckets:
                        for lane in session_lanes:
                            label = f"session:{h}x{w}" + (
                                f"@{lane.label}" if lane else "")
                            dev = (lane.device if lane is not None
                                   else self.sessions.device)
                            with _current_card(dev):
                                report = warm_session_programs(
                                    self.config.stream, h * w,
                                    col_bits=self.config.proj.col_bits,
                                    row_bits=self.config.proj.row_bits,
                                    frame_shape=(h, w), device=dev)
                            self._warmup_report[label] = report
            if recover_from:
                self._recover()
        except BaseException:
            if self.telemetry is not None:
                self.telemetry.uninstall()
            raise
        for w in self.workers:
            w.start()
        self.governor.start_watchdog(lambda: list(self.workers),
                                     self._restart_worker,
                                     escalate_fn=(
                                         self._escalate_worker_device
                                         if self.lanes.multi_device
                                         else None))
        self._started = True
        self._ready = True
        return self

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful shutdown: refuse new work, finish everything admitted,
        stop workers. Returns True when every worker exited in time."""
        self._draining = True
        self._ready = False
        self.queue.close()
        self.governor.stop_watchdog()
        self._probe_stop.set()
        for w in self.workers:
            w.request_stop()
        deadline = time.monotonic() + timeout
        ok = True
        for w in self.workers:
            w.join(max(0.0, deadline - time.monotonic()))
            ok = ok and not w.alive
        if not ok:
            log.warning("drain timed out after %.1fs with workers alive",
                        timeout)
        self.cache.release_staging()
        if self.telemetry is not None:
            self.telemetry.uninstall()
        if self.store is not None:
            self.store.note("drain", clean=ok)
            self.store.close()
        return ok

    def abort(self) -> None:
        """Crash-style stop for the durability tests and the soak bench:
        workers exit at their next loop iteration WITHOUT draining, the
        queue keeps its jobs, nothing journals a terminal transition —
        the in-process stand-in for ``kill -9``. The journal retains
        every acked op; a new service over the same ``store_dir`` with
        ``start(recover_from=True)`` takes over."""
        self._draining = True
        self._ready = False
        self.governor.stop_watchdog()
        self._probe_stop.set()
        for w in self.workers:
            w.abort()
        for w in self.workers:
            w.join(timeout=5.0)
        # A killed process's pinned staging memory goes with it.
        self.cache.release_staging()
        if self.telemetry is not None:
            self.telemetry.uninstall()
        if self.store is not None:
            self.store.close()

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def ready(self) -> bool:
        """Readiness (the ``/readyz`` contract): warmup + recovery done,
        at least one worker lane alive, not draining."""
        return (self._ready and not self._draining
                and any(w.alive for w in self.workers))

    def _bucket_key(self, h: int, w: int) -> BucketKey:
        cfg = self.config
        return BucketKey(height=h, width=w, frames=cfg.proj.n_frames,
                         col_bits=cfg.proj.col_bits,
                         row_bits=cfg.proj.row_bits,
                         decode_cfg=cfg.decode_cfg, tri_cfg=cfg.tri_cfg)

    # -- recovery (serve/store.py) -----------------------------------------

    def _recover(self) -> None:
        """Replay the journal: re-queue every non-terminal job under its
        ORIGINAL id (clients keep polling the ids they hold) and rebuild
        every live session by replaying its accepted stops through the
        compiled B=1 lane — deterministic, so a recovered session
        finalizes bitwise-identically to an uninterrupted one."""
        state = self.store.recover()
        if state.empty:
            return
        t0 = time.monotonic()
        n_jobs = n_sessions = n_stops = 0
        for rj in state.jobs:
            try:
                stack = self.store.load_stack(rj.stack_path)
            except (OSError, ValueError) as e:
                # A purged/corrupt stack blob: the job cannot replay.
                # Register it FAILED (the client polling its id gets an
                # honest taxonomy answer, not a 404) — which also
                # journals its terminal op, so the dead admission stops
                # haunting every future recovery of this volume.
                events.record("job_recover_failed", severity="error",
                              job_id=rj.job_id, message=str(e))
                job = Job(stack=np.empty((0, 0, 0), np.uint8),
                          col_bits=self.config.proj.col_bits,
                          row_bits=self.config.proj.row_bits,
                          result_format=rj.result_format,
                          priority=rj.priority, job_id=rj.job_id)
                job.journal_kind = "job"
                job.recovered = True
                job.on_terminal = self._on_terminal
                self._jobs_total("submitted").inc()
                with events.context(job_id=job.job_id):
                    from ..health import CaptureError

                    job.fail(CaptureError(
                        f"recovered capture stack unreadable "
                        f"({rj.stack_path}): {e}"))
                self._register(job)
                continue
            deadline = None
            if rj.deadline_s is not None:
                deadline = rj.deadline_s - (time.time()
                                            - rj.submitted_wall)
            job = Job(stack=stack, col_bits=self.config.proj.col_bits,
                      row_bits=self.config.proj.row_bits,
                      decode_cfg=self.config.decode_cfg,
                      tri_cfg=self.config.tri_cfg,
                      result_format=rj.result_format,
                      priority=rj.priority,
                      deadline_s=deadline, job_id=rj.job_id)
            job.content_key = rj.content_key
            job.journal_kind = "job"
            job.recovered = True
            job.on_terminal = self._on_terminal
            self._jobs_total("submitted").inc()
            with events.context(job_id=job.job_id):
                if deadline is not None and deadline <= 0:
                    self._register(job)
                    from .jobs import DeadlineExceededError

                    job.fail(DeadlineExceededError(
                        f"deadline {rj.deadline_s:.2f}s lapsed across "
                        "the crash/restart window"))
                    continue
                try:
                    self.queue.submit(job)
                except JobRejected as e:  # shrunk queue_depth on restart
                    self._register(job)
                    job.fail(e)
                    continue
                self._register(job)
            events.record("job_recovered", job_id=job.job_id,
                          result_format=rj.result_format)
            n_jobs += 1
        for rs in state.sessions:
            if self.handoff is not None:
                # Handoff-aware recovery: while this replica was dead
                # the router may have re-pinned the session to a
                # survivor (adopt_session stamps the stream's owner),
                # or the session may have ENDED there (end tombstone).
                # Either is POSITIVE evidence the session is no longer
                # ours — journal the local tombstone so this WAL drains
                # clean instead of resurrecting a second live copy. A
                # MISSING stream is the opposite: the mirror never
                # wrote (shared-volume failure, handoff enabled after
                # the session started) and this WAL holds the ONLY
                # copy — recover it; losing acked stops to a mirror
                # hiccup would invert the durability contract.
                stream = self.handoff.stream_state(rs.session_id)
                owner = self.handoff.owner(rs.session_id)
                if stream == "ended" or (stream == "live"
                                         and owner != rs.replica):
                    events.record(
                        "session_skipped_handed_off", severity="warning",
                        session_id=rs.session_id, journaled_by=rs.replica,
                        stream_state=stream, stream_owner=owner)
                    # scope=local: the sink must NOT mirror this end —
                    # the stream now belongs to the adopter (or is the
                    # tombstone we consume below).
                    self.store.append(
                        {"op": "session_end",
                         "session_id": rs.session_id,
                         "reason": "handed_off", "scope": "local"},
                        sync=False)
                    if stream == "ended":
                        # Tombstone consumed: only THIS replica's WAL
                        # referenced it; dropping it bounds tombstone
                        # accumulation on long-lived volumes.
                        self.handoff.drop_session(rs.session_id)
                    continue
                if stream == "missing":
                    events.record(
                        "session_recovered_without_stream",
                        severity="warning", session_id=rs.session_id,
                        message="no handoff stream (mirror never "
                                "wrote); recovering from the local "
                                "WAL only")
            try:
                entry = self.sessions.restore(rs.session_id, rs.options,
                                              rs.scan_id)
            except JobRejected as e:  # shrunk max_sessions on restart
                events.record("session_recover_failed", severity="error",
                              session_id=rs.session_id, message=str(e))
                continue
            if self.handoff is not None and stream == "missing":
                # Heal the stream from the local WAL (head + stop
                # blobs) so the recovered session is adoptable again;
                # a still-failing shared volume degrades handoff only.
                try:
                    self.handoff.mirror(
                        {"op": "session", "session_id": rs.session_id,
                         "scan_id": rs.scan_id, "options": rs.options,
                         "replica": rs.replica}, self.store)
                    for jid, path in rs.stops:
                        self.handoff.mirror(
                            {"op": "stop",
                             "session_id": rs.session_id,
                             "job_id": jid, "stack": path}, self.store)
                except OSError as e:
                    self.handoff.mirror_failures += 1
                    events.record("handoff_mirror_failed",
                                  severity="error",
                                  session_id=rs.session_id,
                                  message=str(e))
            replayed = 0
            for path in rs.stop_paths:
                try:
                    stack = self.store.load_stack(path)
                    self._replay_stop(entry, stack)
                    replayed += 1
                except Exception as e:
                    # A stop that cannot replay degrades the session (it
                    # loses bitwise parity) but must not kill recovery
                    # of everything else.
                    events.record(
                        "session_recover_degraded", severity="error",
                        session_id=rs.session_id, message=str(e),
                        exc_type=type(e).__name__)
            with entry.lock:
                entry.stops_submitted = replayed
            events.record("session_recovered", session_id=rs.session_id,
                          scan_id=rs.scan_id, stops_replayed=replayed)
            n_sessions += 1
            n_stops += replayed
        log.info("recovered %d job(s), %d session(s) (%d stops "
                 "replayed) in %.2fs", n_jobs, n_sessions, n_stops,
                 time.monotonic() - t0)
        events.record("service_recovered", jobs=n_jobs,
                      sessions=n_sessions, stops=n_stops,
                      seconds=round(time.monotonic() - t0, 3))

    def _replay_stop(self, entry, stack: np.ndarray) -> None:
        """Run one journaled stop through the SAME program the worker
        used (the bucket's B=1 executable) and hand the per-lane arrays
        to the session's ingest — the exact decode path of the original
        submission, so replay is bit-reproducible."""
        stack = self._validate_stack(stack)
        probe = Job(stack=stack, col_bits=self.config.proj.col_bits,
                    row_bits=self.config.proj.row_bits,
                    decode_cfg=self.config.decode_cfg,
                    tri_cfg=self.config.tri_cfg)
        key = self.batcher.key_for(probe)
        # Route through the session's sticky lane (serve/lanes.py): the
        # replay must hit the SAME per-device executable the original
        # stops ran on — warmed at start, so recovery stays compile-free
        # and bitwise.
        pkey = self.lanes.route(key, 1, getattr(entry, "lane", None))
        compiled = self.cache.get(pkey)
        calib = self.cache.placed_calib(pkey)
        batch = np.zeros((1, key.frames, key.height, key.width), np.uint8)
        f, h, w = stack.shape
        batch[0, :f, :h, :w] = stack
        out = compiled(self.cache.stage(pkey, batch), calib)
        # The worker's one readback of the batch result (a card's tensors
        # reach numpy only through the host).
        points = out.points.cpu().numpy()[0]
        colors = out.colors.cpu().numpy()[0]
        valid = out.valid.cpu().numpy()[0]
        vgrid = valid.reshape(key.height, key.width)[:h, :w]
        entry.ingest(points, colors, valid, coverage=float(vgrid.mean()),
                     frame_shape=(key.height, key.width))

    # -- submission --------------------------------------------------------

    def _content_sig(self, result_format: str) -> str:
        """Config half of the content-hash key: everything besides the
        pixels that shapes the artifact."""
        cfg = self.config
        return (f"{cfg.proj.col_bits}/{cfg.proj.row_bits}/"
                f"{cfg.decode_cfg}/{cfg.tri_cfg}/"
                f"mesh{cfg.mesh_depth}/{cfg.mesh_representation}/"
                f"{result_format}")

    def _tenant_cost(self, stack: np.ndarray) -> float:
        """Token spend for one admission: 1.0 historically, the stack's
        megapixel cost under ``tenant_cost_weighted``
        (`tenants.stack_cost` — a 4K stack spends ~8×, a 240p one
        ~1/10th, so per-tenant budgets meter actual fleet burn)."""
        if not self.config.tenant_cost_weighted:
            return 1.0
        from .tenants import stack_cost

        _, h, w = stack.shape
        return stack_cost(h, w)

    def submit_array(self, stack: np.ndarray, result_format: str = "ply",
                     priority="normal",
                     deadline_s: float | None = None,
                     tenant: str | None = None) -> Job:
        """Validate + admit one capture stack; returns the live Job.
        Raises a :class:`~.jobs.JobRejected` subclass on refusal.

        A content-cache hit (same bytes, same config, finished before —
        even pre-restart or post-eviction) returns a completed job
        WITHOUT touching the queue; the lookup runs before the overload
        governor AND the tenant quota because a cached answer costs
        nothing and relieves load."""
        cfg = self.config
        try:
            stack = self._validate_stack(stack)
            if result_format not in _SUBMIT_FORMATS:
                raise StackFormatError(
                    f"result_format must be one of "
                    f"{sorted(_SUBMIT_FORMATS)}, got {result_format!r}")
            if isinstance(priority, str):
                if priority not in _PRIORITY_NAMES:
                    raise StackFormatError(
                        f"priority must be one of "
                        f"{sorted(_PRIORITY_NAMES)} or an int, "
                        f"got {priority!r}")
                priority = _PRIORITY_NAMES[priority]
            ckey = None
            if self.content_cache is not None and not self._draining:
                # A draining service refuses even free answers: drain
                # means "go to another replica", and a 200 here would
                # keep clients pinned to a dying process.
                ckey = content_key(stack, self._content_sig(result_format))
                cached = self.content_cache.get(ckey)
                source = "local"
                if cached is None and self.peer_cache is not None:
                    # Shared fleet cache: a mesh computed on replica A
                    # answers a duplicate submit here. Bounded lookup —
                    # every degraded peer mode is a local miss. The
                    # fetched artifact is re-cached locally so the NEXT
                    # duplicate is a local hit.
                    cached = self.peer_cache.lookup(ckey)
                    source = "peer"
                    if cached is not None:
                        payload, meta, fmt = cached
                        self.content_cache.put(ckey, payload,
                                               dict(meta), fmt)
                if cached is not None:
                    return self._complete_from_cache(
                        ckey, result_format, int(priority), cached,
                        source=source)
            # Governor BEFORE the tenant spend: a fleet-side refusal
            # (breaker open, shedding) must not drain the tenant's
            # bucket for work that never ran — and a queue-full
            # rejection below refunds the token for the same reason.
            self.governor.admit(int(priority))
            cost = self._tenant_cost(stack)
            if self.tenants is not None:
                self.tenants.admit(tenant, cost=cost)
            job = Job(stack=stack, col_bits=cfg.proj.col_bits,
                      row_bits=cfg.proj.row_bits,
                      decode_cfg=cfg.decode_cfg, tri_cfg=cfg.tri_cfg,
                      result_format=result_format,
                      priority=int(priority), deadline_s=deadline_s)
            job.content_key = ckey
            # journal_kind BEFORE admission: a worker may reach the
            # terminal transition before _journal_job runs, and that
            # job_done must not be lost (the store's mirror tolerates
            # done-before-admitted ordering).
            job.journal_kind = "job" if self.store is not None else None
            # Observer BEFORE admission (a worker may finish the job
            # before _register runs); registry entry AFTER admission (a
            # rejected job must leave no trace — a pre-registered one
            # would sit QUEUED forever, pinning its stack, unbounded
            # growth under the exact overload the bounded queue exists
            # for).
            job.on_terminal = self._on_terminal
            try:
                self.queue.submit(job)
            except JobRejected:
                if self.tenants is not None:
                    # Refund EXACTLY the weighted spend (refund parity).
                    self.tenants.refund(tenant, cost=cost)
                raise
            self._journal_job(job, stack)
            self._register(job)
        except JobRejected:
            self._jobs_total("rejected").inc()
            raise
        self._jobs_total("submitted").inc()
        self._queue_gauge.set(self.queue.depth())
        return job

    def _complete_from_cache(self, ckey: str, result_format: str,
                             priority: int, cached,
                             source: str = "local") -> Job:
        """Land a content-cache hit as an already-terminal job in the
        registry (same polling surface as a computed result).
        ``source`` says which half of the shared cache answered —
        "local" (this replica's disk/memory) or "peer" (fetched over
        the fleet's GET /cache/<key> protocol)."""
        payload, meta, fmt = cached
        job = Job(stack=np.empty((0, 0, 0), np.uint8),
                  col_bits=self.config.proj.col_bits,
                  row_bits=self.config.proj.row_bits,
                  result_format=fmt or result_format, priority=priority)
        job.content_key = ckey
        job.on_terminal = self._on_terminal
        self._jobs_total("submitted").inc()  # counter conservation
        job.mark_running()
        job.complete(payload, **{**meta, "content_cache_hit": True,
                                 "cache_source": source})
        self._register(job)
        events.record("content_cache_hit", job_id=job.job_id,
                      key=ckey[:12], source=source)
        return job

    def _journal_job(self, job: Job, stack: np.ndarray) -> None:
        """WAL the admission (stack blob first, then the op — the op
        must never reference a blob that does not exist). Runs after
        queue.submit: a rejected job journals nothing; the sync append
        is the durability promise the HTTP 200 rides on.

        A failing volume (disk full, I/O error) degrades DURABILITY,
        never availability: the job still runs and serves — it just
        won't survive a crash — and its journal_kind is cleared so the
        terminal op doesn't dangle against an admission that never
        landed."""
        if self.store is None:
            return
        try:
            rel = self.store.put_stack(job.job_id, stack)
            self.store.append({
                "op": "job", "job_id": job.job_id, "stack": rel,
                "result_format": job.result_format,
                "priority": job.priority, "deadline_s": job.deadline_s,
                "content_key": job.content_key})
        except OSError as e:
            job.journal_kind = None
            log.error("job %s admission not journaled (%s) — it will "
                      "not survive a crash", job.job_id, e)
            events.record("journal_write_failed", severity="error",
                          job_id=job.job_id, message=str(e))

    def _validate_stack(self, stack: np.ndarray) -> np.ndarray:
        cfg = self.config
        stack = np.asarray(stack)
        if stack.dtype != np.uint8:
            raise StackFormatError(
                f"stack must be uint8, got {stack.dtype}")
        if stack.ndim != 3:
            raise StackFormatError(
                f"stack must be (frames, H, W), got shape {stack.shape}")
        f, h, w = stack.shape
        if f != cfg.proj.n_frames:
            raise StackFormatError(
                f"stack has {f} frames; this service's protocol is "
                f"{cfg.proj.n_frames} (2 + 2x{cfg.proj.col_bits} + "
                f"2x{cfg.proj.row_bits})")
        # Must fit SOME configured bucket (per-axis maxima are not
        # enough: a stack under both maxima but inside no single bucket
        # would otherwise fail late in the worker — or trigger a
        # request-time compile of an off-menu quantum bucket).
        if h < 8 or w < 8 or not any(h <= bh and w <= bw
                                     for bh, bw in cfg.buckets):
            raise StackFormatError(
                f"frame size {h}x{w} fits no configured bucket "
                f"{list(cfg.buckets)} (min 8x8)")
        return stack

    # -- streaming sessions (docs/STREAMING.md) ----------------------------

    def create_session(self, options: dict | None = None,
                       tenant: str | None = None) -> dict:
        """``POST /session``: open a streaming session. Refused while
        draining (same rule as submissions), past ``max_sessions``, or
        over the tenant's admission quota."""
        if self._draining:
            from .jobs import QueueClosedError

            self._jobs_total("rejected").inc()
            raise QueueClosedError()
        try:
            if self.tenants is not None:
                self.tenants.admit(tenant)
            try:
                entry = self.sessions.create(options)
            except JobRejected:
                if self.tenants is not None:
                    self.tenants.refund(tenant)  # registry refused
                raise
        except JobRejected:
            self._jobs_total("rejected").inc()
            raise
        return {"session_id": entry.session_id,
                "scan_id": entry.session.scan_id}

    def submit_session_stop(self, session_id: str, stack: np.ndarray,
                            tenant: str | None = None) -> Job:
        """``POST /session/<id>/stop``: admit one stop through the SAME
        queue → batcher → program-cache lane as one-shot jobs; the
        decoded arrays are handed to the session instead of a writer.
        Returns the live Job (its meta carries the fuse/skip decision)."""
        entry = self.sessions.get(session_id)
        cfg = self.config
        try:
            stack = self._validate_stack(stack)
            # Governor before the tenant spend (same rationale as
            # submit_array: fleet-side refusals don't charge tenants).
            self.governor.admit(1)
            cost = self._tenant_cost(stack)
            if self.tenants is not None:
                self.tenants.admit(tenant, cost=cost)
            job = Job(stack=stack, col_bits=cfg.proj.col_bits,
                      row_bits=cfg.proj.row_bits,
                      decode_cfg=cfg.decode_cfg, tri_cfg=cfg.tri_cfg,
                      result_format="json")
            job.decode_sink = entry.ingest
            job.journal_kind = "stop"
            job.session_id = session_id
            # Sticky lane affinity (serve/lanes.py): only the worker on
            # the session's device lane flushes this stop — the
            # session's fuse/preview programs live (warm) on that chip.
            if entry.lane is not None:
                job.lane = entry.lane.index
            job.on_terminal = self._on_terminal
            try:
                self.queue.submit(job)
            except JobRejected:
                if self.tenants is not None:
                    self.tenants.refund(tenant, cost=cost)  # nothing ran
                raise
            if self.store is not None:
                # The accepted stop IS the session's recoverable state:
                # replaying these blobs in order through the B=1 lane
                # rebuilds the session bit-for-bit. (A stop whose job
                # later FAILS service-side journals a stop_failed op —
                # replay must skip it exactly as the live session never
                # fused it.) A failing volume degrades durability, not
                # the stop itself.
                try:
                    rel = self.store.put_stack(
                        f"{session_id}-{job.job_id}", stack)
                    self.store.append({"op": "stop",
                                       "session_id": session_id,
                                       "job_id": job.job_id,
                                       "stack": rel})
                except OSError as e:
                    job.journal_kind = None
                    log.error("session %s stop not journaled (%s) — it "
                              "will not survive a crash", session_id, e)
                    events.record("journal_write_failed",
                                  severity="error",
                                  session_id=session_id,
                                  job_id=job.job_id, message=str(e))
            self._register(job)
        except JobRejected:
            self._jobs_total("rejected").inc()
            raise
        entry.note_pending(job)
        with entry.lock:
            entry.stops_submitted += 1
        self._jobs_total("submitted").inc()
        self._queue_gauge.set(self.queue.depth())
        return job

    def session_preview(self, session_id: str):
        """``GET /session/<id>/preview``: latest progressive STL bytes +
        meta, or None before the first preview."""
        return self.sessions.get(session_id).preview_bytes()

    def _session_splat_mesher(self, entry):
        """The session's splat previewer, or a 400 when the session
        was not created with ``representation="splat"`` — the render
        surface exists only on that lane (docs/RENDERING.md)."""
        mesher = getattr(entry.session, "_mesher", None)
        if not hasattr(mesher, "render_png"):
            raise StackFormatError(
                "session has no render lane — create it with "
                '{"representation": "splat"} to get novel-view renders')
        return mesher

    def _splat_scene_off_lock(self, entry, mesher):
        """Build the session's current splat scene with the EXPENSIVE
        phase off the session lock (the ROADMAP async-scene-build
        item): the cheap seed snapshot runs under the lock, the
        fixed-iteration appearance fit runs lock-FREE on the snapshot
        (concurrent stop ingest proceeds — a live-polling render
        client no longer delays the capture cadence), and the publish
        re-takes the lock (newest-stops-wins, so racing builds
        converge). Returns the built scene, or None before the first
        fused stop."""
        with entry.lock:
            with entry.device_ctx():
                token = mesher.begin_scene_build()
        if token is None:
            return None
        with entry.device_ctx():
            mesher.finish_scene_build(token)
        with entry.lock:
            with entry.device_ctx():
                scene = mesher.adopt_scene(token)
            entry.last_t = time.monotonic()
        return scene

    def render_session(self, session_id: str, azim: float, elev: float,
                       width: int | None = None,
                       height: int | None = None):
        """``GET /session/<id>/render?az=..&el=..[&w=..&h=..]``: render
        the session's CURRENT splat scene from a novel orbit view —
        PNG bytes + meta, or None before the first fused stop (the
        endpoint's 409). Angles are traced operands of one compiled
        program per resolution; ``w``/``h`` must name a configured
        render size (each size is its own program — an open set would
        mint compiles on demand, which the zero-steady-state-recompile
        bar forbids), else 400. A render that follows new stops
        REBUILDS the scene (seed + ``splat_fit_iters`` fit steps) with
        the fit OFF the session lock (`_splat_scene_off_lock`), so
        concurrent stop ingest is not delayed; only the cheap
        seed/publish/raster phases hold the lock, on the session's
        sticky lane device (docs/RENDERING.md)."""
        entry = self.sessions.get(session_id)
        mesher = self._session_splat_mesher(entry)
        if (width is None) != (height is None):
            raise StackFormatError("pass both w and h, or neither")
        if width is not None \
                and not mesher.render_size_ok(width, height):
            raise StackFormatError(
                f"render size {width}x{height} is not served; "
                f"configured sizes: "
                f"{['%dx%d' % s for s in mesher.render_sizes]}")
        if not (-360.0 <= float(azim) <= 360.0) \
                or not (-90.0 <= float(elev) <= 90.0):
            raise StackFormatError(
                f"render angles out of range (az {azim}, el {elev}): "
                "az in [-360, 360], el in [-90, 90]")
        scene = self._splat_scene_off_lock(entry, mesher)
        if scene is None:
            return None
        with entry.lock:
            with entry.device_ctx():
                out = mesher.render_png(float(azim), float(elev),
                                        width, height, scene=scene)
            entry.last_t = time.monotonic()
        if out is not None:
            events.record("session_rendered", session_id=session_id,
                          **{k: out[1][k] for k in ("azim", "elev",
                                                    "render_s")})
        return out

    def session_splats(self, session_id: str) -> bytes | None:
        """``GET /session/<id>/splats``: the current splat scene as an
        .npz archive — ``cli render`` reproduces the endpoint's pixels
        from it offline (the serve↔CLI parity contract), or None
        before the first fused stop. The scene build's fit phase runs
        off the session lock, like renders."""
        entry = self.sessions.get(session_id)
        mesher = self._session_splat_mesher(entry)
        scene = self._splat_scene_off_lock(entry, mesher)
        if scene is None:
            return None
        with entry.lock:
            with entry.device_ctx():
                return mesher.scene_bytes(scene=scene)

    def finalize_session(self, session_id: str,
                         result_format: str = "stl") -> Job:
        """``POST /session/<id>/finalize``: close the ring, build the
        final artifact, and land it as a terminal job in the ordinary
        registry — the existing ``GET /result`` path serves it. Runs on
        the calling thread (one full pose solve + merge + mesh)."""
        if result_format not in ("ply", "stl", "mesh_ply", "render_png"):
            raise StackFormatError(
                f"result_format must be 'ply', 'stl', 'mesh_ply' or "
                f"'render_png', got {result_format!r}")
        entry = self.sessions.get(session_id)
        if result_format == "render_png":
            # Lane check BEFORE finalize — a 400 must not close the ring.
            self._session_splat_mesher(entry)
        cfg = self.config
        # Settle in-flight stops FIRST (without the session lock — their
        # sinks need it): a stop the client already got a 200 for must
        # be fused or journaled before the ring closes. A stop that
        # cannot settle inside the timeout surfaces as a 409 from the
        # session's own guards rather than a silent exclusion.
        entry.settle_pending(timeout_s=120.0)
        with entry.lock:
            if entry.result_job_id is not None:
                job = self.get_job(entry.result_job_id)
                if job is not None:
                    return job  # idempotent finalize
                from .sessions import SessionResultEvicted

                raise SessionResultEvicted(
                    f"session {session_id} finalized but its result "
                    "job fell out of the bounded registry — the "
                    "artifact is gone; re-scan")
            # Finalize on the session's sticky device (no-op context
            # without a lane): the model buffers already live there,
            # and the finalize-only programs (full-ring solve, merge)
            # compile-and-run where the session's data is instead of
            # pulling it across chips.
            with entry.device_ctx():
                result = entry.session.finalize(
                    mesh=result_format in ("stl", "mesh_ply"))
            if result_format == "stl":
                from .worker import _stl_bytes

                payload = _stl_bytes(result.mesh)
                meta = {"vertices": int(len(result.mesh.vertices)),
                        "faces": int(len(result.mesh.faces))}
            elif result_format == "mesh_ply":
                # Vertex-colored final mesh (colors survive only under
                # the TSDF representation; Poisson meshes carry none).
                from .worker import _mesh_ply_bytes

                payload = _mesh_ply_bytes(result.mesh)
                meta = {"vertices": int(len(result.mesh.vertices)),
                        "faces": int(len(result.mesh.faces)),
                        "colored": result.mesh.vertex_colors is not None}
            elif result_format == "render_png":
                # The splat lane's rendered artifact: the fitted scene's
                # default orbit view (docs/RENDERING.md; live-angle
                # renders ride GET /session/<id>/render). Under the
                # sticky lane device like every other session device
                # path — the lazy scene rebuild must land where the
                # per-lane warmup compiled.
                with entry.device_ctx():
                    out = self._session_splat_mesher(entry).render_png(
                        30.0, 20.0)
                if out is None:
                    raise RuntimeError(
                        "no splat scene to render (no stops fused)")
                payload, rmeta = out
                meta = {k: rmeta[k] for k in ("azim", "elev", "width",
                                              "height", "splats")}
            else:
                from .worker import _ply_bytes

                payload = _ply_bytes(result.cloud)
                meta = {}
            meta.update(points=len(result.cloud),
                        stops_fused=result.stats["stops_fused"],
                        stops_skipped=result.stats["stops_skipped"])
            job = Job(stack=np.empty((0, 0, 0), np.uint8),
                      col_bits=cfg.proj.col_bits,
                      row_bits=cfg.proj.row_bits,
                      result_format=result_format)
            job.on_terminal = self._on_terminal
            self._jobs_total("submitted").inc()  # counter conservation
            job.complete(payload, **meta)
            self._register(job)
            entry.result_job_id = job.job_id
        # Journal OUTSIDE the session lock (append can block on the
        # group commit): a finalized session's stops are no longer
        # needed for recovery — the artifact lives in the registry, and
        # a post-crash client re-scans (documented in SERVING.md).
        if self.store is not None:
            self.store.append({"op": "session_end",
                               "session_id": session_id,
                               "reason": "finalized",
                               "replica": self.replica_id})
        return job

    def adopt_session(self, session_id: str) -> dict:
        """``POST /session/<id>/adopt`` (fleet tier): take over a live
        session from the shared handoff stream — the router calls this
        on a survivor after the session's pinned replica died.

        Claims ownership on the stream FIRST (so the dead replica's
        eventual ``--recover`` sees the session is no longer its),
        re-journals the session into THIS replica's WAL (so the
        adopter's own crash-recovery covers it), and replays the
        journaled stops through the compiled B=1 lane — deterministic,
        so the re-pinned session finalizes bitwise-identically to an
        uninterrupted run. Idempotent: adopting a session already live
        here is a no-op report."""
        if self.handoff is None:
            raise StackFormatError(
                "this replica has no handoff volume configured "
                "(--handoff-dir)")
        if self._draining:
            from .jobs import QueueClosedError

            raise QueueClosedError()
        try:
            entry = self.sessions.get(session_id)
        except UnknownSessionError:
            entry = None
        if entry is not None:
            with entry.lock:
                fused = entry.session.stops_fused
            return {"session_id": session_id, "adopted": False,
                    "stops_fused": fused, "replica": self.replica_id}
        info = self.handoff.read_session(session_id)
        if info is None:
            raise UnknownSessionError(
                f"session {session_id!r} has no handoff stream (never "
                "created with a handoff volume, or already ended)")
        t0 = time.monotonic()
        # Ownership first — a sync, direct stream append: from this line
        # on, the previous owner's recovery must skip the session.
        self.handoff.append({"op": "session_owner",
                             "session_id": session_id,
                             "replica": self.replica_id,
                             "t_wall": time.time()})
        entry = self.sessions.restore(session_id, info.options,
                                      info.scan_id)
        if self.store is not None:
            self.store.append({"op": "session", "session_id": session_id,
                               "scan_id": info.scan_id,
                               "options": info.options,
                               "replica": self.replica_id})
        replayed = degraded = 0
        for job_id, blob in info.stops:
            try:
                stack = self.handoff.load_blob(blob)
                self._replay_stop(entry, stack)
            except Exception as e:
                # One unreadable blob degrades the session (bitwise
                # parity is gone) but must not kill the adoption.
                events.record("session_recover_degraded",
                              severity="error", session_id=session_id,
                              message=str(e), exc_type=type(e).__name__)
                degraded += 1
                continue
            if self.store is not None:
                # Same job ids as the origin replica's stops: the sink
                # re-mirrors them, and the stream reader dedups by id.
                rel = self.store.put_stack(
                    f"{session_id}-{job_id or uuid.uuid4().hex[:8]}",
                    stack)
                self.store.append({"op": "stop",
                                   "session_id": session_id,
                                   "job_id": job_id, "stack": rel})
            replayed += 1
        with entry.lock:
            entry.stops_submitted = replayed
            fused = entry.session.stops_fused
        events.record("session_adopted", session_id=session_id,
                      scan_id=info.scan_id, from_replica=info.replica,
                      replica=self.replica_id, stops_replayed=replayed,
                      stops_degraded=degraded,
                      seconds=round(time.monotonic() - t0, 3))
        log.info("adopted session %s from %s: %d stop(s) replayed "
                 "(%d degraded) in %.2fs", session_id, info.replica,
                 replayed, degraded, time.monotonic() - t0)
        return {"session_id": session_id, "adopted": True,
                "stops_fused": fused, "stops_degraded": degraded,
                "replica": self.replica_id}

    def cache_export(self, key: str) -> tuple[bytes, dict, str] | None:
        """``GET /cache/<key>`` (the peer protocol's server half): this
        replica's LOCAL content-cache entry, or None. Never consults
        peers — a fleet of replicas proxying each other's lookups would
        recurse. Uses the non-counting peek so peer probes don't inflate
        this replica's admission hit/miss counters."""
        if self.content_cache is None:
            return None
        return self.content_cache.peek(key)

    def check_admission(self, priority: int = 1,
                        tenant: str | None = None) -> None:
        """Headers-time backpressure probe for the HTTP layer: raises the
        rejection `submit_array` would (tenant quota, governor
        shedding/breaker OR queue backpressure), AND counts it — a
        refusal must hit the rejected counter whether it happened before
        or after the body was read. The tenant check is the NON-spending
        probe (`TenantQuotas.check`) — rejecting an over-budget tenant
        before its ~95 MB body is buffered, while the authoritative
        token spend happens exactly once, inside
        `submit_array`/`submit_session_stop`."""
        try:
            if self.tenants is not None:
                # Under cost weighting the true cost is unknown until
                # the body is read: probe at the COST FLOOR, so a cheap
                # stack a weighted admit would accept is never 429'd
                # at headers time (the probe stays advisory either
                # way; the authoritative spend is the weighted admit).
                from .tenants import MIN_STACK_COST

                probe_cost = (MIN_STACK_COST
                              if self.config.tenant_cost_weighted
                              else 1.0)
                self.tenants.check(tenant, cost=probe_cost)
            self.governor.admit(priority)
            self.queue.check_admission()
        except JobRejected:
            self._jobs_total("rejected").inc()
            raise

    def _on_terminal(self, job: Job) -> None:
        """Counter conservation: every admitted job ends exactly one of
        done/failed (rejected jobs are counted at submit), wherever the
        terminal transition happened — worker postprocess, batch-scoped
        failure, or deadline scrub in the queue/batcher."""
        self._jobs_total("done" if job.status == DONE else "failed").inc()
        wait_end = job.started_t or job.finished_t
        if wait_end is not None:
            self._queue_wait_s.observe(wait_end - job.submitted_t)
        if job.started_t is not None and job.finished_t is not None:
            self._run_s.observe(job.finished_t - job.started_t)
        # Durability bookkeeping: only successful NON-hit artifacts enter
        # the content cache (failures keep their honest taxonomy answer;
        # a hit is already cached), and only one-shot jobs journal their
        # terminal (stops are tracked per session, synthesized result
        # jobs not at all).
        if (self.content_cache is not None and job.status == DONE
                and job.content_key is not None
                and job.result_bytes is not None
                and not job.result_meta.get("content_cache_hit")):
            self.content_cache.put(job.content_key, job.result_bytes,
                                   dict(job.result_meta),
                                   job.result_format)
        if self.store is not None and job.journal_kind == "job":
            self.store.append({"op": "job_done", "job_id": job.job_id,
                               "status": job.status}, sync=False)
        elif self.store is not None and job.journal_kind == "stop" \
                and job.status == FAILED:
            # A stop whose job failed SERVICE-side was never fused by
            # the live session; replay must skip it or a recovered
            # session would fuse one stop more than the uninterrupted
            # run (breaking bitwise recovery parity). Successful stops
            # stay journaled until their session ends.
            self.store.append({"op": "stop_failed",
                               "session_id": job.session_id,
                               "job_id": job.job_id}, sync=False)
        events.record("job_terminal",
                      severity="info" if job.status == DONE else "warning",
                      job_id=job.job_id, status=job.status,
                      exc_type=(job.error or {}).get("type"))

    def _register(self, job: Job) -> None:
        with self._jobs_lock:
            self._jobs[job.job_id] = job
            # Bound the registry two ways (live jobs are never touched —
            # a client could still be polling them):
            # count cap — drop the oldest terminal ENTRIES entirely;
            terminal = [(jid, j) for jid, j in self._jobs.items()
                        if j.status in (DONE, FAILED)]
            excess = len(self._jobs) - self.config.completed_cap
            for jid, _ in terminal[:max(0, excess)]:
                del self._jobs[jid]
            # byte budget — drop only the oldest result PAYLOADS. The
            # entries stay, so a client that saw "done" and comes late
            # gets an explicit 410 ("result evicted"), never a silent
            # unknown-job 404.
            kept = [j for _, j in terminal[max(0, excess):]]
            held = sum(len(j.result_bytes) for j in kept
                       if j.result_bytes is not None)
            for j in kept:
                if held <= self.config.result_cache_bytes:
                    break
                held -= j.release_result()

    # -- inspection --------------------------------------------------------

    def get_job(self, job_id: str) -> Job | None:
        with self._jobs_lock:
            return self._jobs.get(job_id)

    def result_payload(self, job: Job) -> bytes | None:
        """The job's artifact bytes — from the registry, or (when the
        byte-bounded registry evicted the payload) re-fetched from the
        content-hash cache. Only when BOTH are gone does ``/result``
        answer its 410."""
        data = job.result_bytes
        if data is None and job.content_key is not None \
                and self.content_cache is not None:
            cached = self.content_cache.get(job.content_key)
            if cached is not None:
                return cached[0]
        return data

    def status(self, job_id: str) -> dict | None:
        job = self.get_job(job_id)
        if job is None:
            return None
        out = job.status_dict()
        # Terminal counters are registered at observation time (cheap,
        # idempotent-per-scrape is fine for these dashboards).
        return out

    def stats(self) -> dict:
        out = {
            "replica_id": self.replica_id,
            "queue_depth": self.queue.depth(),
            "queue_capacity": self.queue.max_depth,
            "pending_batches": self.batcher.pending_depth(),
            "draining": self._draining,
            "ready": self.ready,
            "workers_alive": sum(w.alive for w in self.workers),
            "lanes": self.lanes.stats(),
            "cache": self.cache.stats(),
            "warmup": self._warmup_report,
            "sessions": self.sessions.stats(),
            "governor": self.governor.stats(),
        }
        if self.tenants is not None:
            out["tenants"] = self.tenants.stats()
        if self.content_cache is not None:
            out["content_cache"] = self.content_cache.stats()
        if self.store is not None:
            out["store"] = self.store.stats()
        if self.peer_cache is not None:
            out["peer_cache"] = self.peer_cache.stats()
        if self.handoff is not None:
            out["handoff"] = self.handoff.stats()
        return out

    def readiness(self) -> dict:
        """The ``/readyz`` payload: ready iff warmup + recovery are done,
        a worker lane is alive, and the service is not draining —
        routers stop sending here on 503 while ``/healthz`` (liveness)
        stays 200 so the orchestrator does NOT restart the pod during a
        drain or warmup."""
        reasons = []
        if not self._started:
            reasons.append("starting (warmup/recovery in progress)")
        if self._draining:
            reasons.append("draining")
        if self._started and not any(w.alive for w in self.workers):
            reasons.append("no worker lanes alive")
        out = {"ready": self.ready, "reasons": reasons,
               "replica_id": self.replica_id}
        dead = self.lanes.dead_devices()
        if dead:
            # Degraded-but-ready honesty: the pool serves at N−1 chips.
            # Routers keep sending (ready stays true while any lane
            # lives); autoscalers read the shrunken capacity here and
            # on /fleet/signals.
            out["degraded"] = True
            out["devices_dead"] = dead
            out["queue_capacity"] = self.queue.max_depth
        return out

    def metrics_text(self) -> str:
        self._queue_gauge.set(self.queue.depth())
        if self.telemetry is not None:
            self.telemetry.sample_memory()  # refresh device gauges
            self.telemetry.sample_kernel_launches()
        self._sync_event_counters()
        return self.registry.prometheus_text(tracer=self.tracer)

    def _sync_event_counters(self) -> None:
        """Mirror the process flight recorder's severity tallies onto
        THIS service's registry at scrape time — the recorder is
        process-global and counts into trace.REGISTRY, which a service
        with a private registry (the default) never renders. Deltas keep
        the counters monotonic across scrapes; the lock keeps concurrent
        scrapes (ThreadingHTTPServer) from double-applying a delta. When
        the service IS handed the global registry, the recorder already
        counts there — mirroring would double every event."""
        if self.registry is trace.REGISTRY:
            return
        with self._events_seen_lock:
            for sev, total in events.RECORDER.severity_counts().items():
                seen = self._events_seen.get(sev, 0)
                if total > seen:
                    self.registry.counter(
                        "sl_events_total",
                        "flight-recorder events by severity",
                        severity=sev).inc(total - seen)
                    self._events_seen[sev] = total

    def events_jsonl(self, n: int = 256, kind: str | None = None) -> str:
        """Tail of the process flight journal (GET /events): the ordered,
        correlated record of what recently happened to which job.
        ``kind`` filters to one event kind (e.g. ``session_evicted``)."""
        return events.to_jsonl(n, kind=kind)


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------


MAX_SUBMIT_BYTES = 1 << 30  # absolute transport bound; admission is tighter


class _ServeHandler(BaseHTTPRequestHandler):
    service: ReconstructionService  # bound by ServeHTTPServer

    protocol_version = "HTTP/1.1"
    # Socket timeout: a stalled upload or idle keep-alive connection must
    # not pin its handler thread forever — without this, N dead-slow
    # clients hold N threads with the admission queue's 429 never
    # engaging (the request never completes).
    timeout = 120.0

    def _json(self, obj, status=200, headers=()):
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _bytes(self, data: bytes, content_type: str):
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    # ------------------------------------------------------------------

    def _reject(self, e: JobRejected) -> None:
        """JobRejected → response mapping shared by every POST route."""
        payload = error_payload(e)
        retry = payload.get("retry_after_s")
        status = 400
        headers = []
        if e.retryable:
            status = 503 if retry is None else 429
            if retry is not None:
                headers.append(("Retry-After", str(max(1, round(retry)))))
        if self.close_connection:  # body was never read (length gate)
            headers.append(("Connection", "close"))
        self._json({"error": payload}, status, headers)

    def _read_stack_body(self):
        """Read + decode an ``.npy`` POST body behind the headers-time
        gates (length bound, queue backpressure + governor shedding) —
        the early-error paths respond WITHOUT reading the (possibly
        ~95 MB) body; under HTTP/1.1 keep-alive the unread bytes would
        desync the next request on the connection, so those paths close
        it."""
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0 or length > MAX_SUBMIT_BYTES:
            self.close_connection = True
            # Counted here because this refusal never reaches the
            # service's own counting gates (check_admission /
            # submit_array) — transport-level refusals must hit the
            # rejected counter too.
            self.service._jobs_total("rejected").inc()
            raise StackFormatError(
                f"Content-Length {length} outside (0, "
                f"{MAX_SUBMIT_BYTES}]")
        # Backpressure at HEADERS time: when the queue is full or
        # draining, reject before buffering the (~95 MB at 1080p)
        # body — N overloaded connections must cost N sockets, not
        # N stacks of transient RSS. submit_array/submit_session_stop
        # below remain the authoritative (race-free) gates. Advisory by
        # design: a duplicate submit the content cache could answer is
        # sometimes refused here — the cache cannot be consulted before
        # the body exists.
        try:
            self.service.check_admission(
                _PRIORITY_NAMES.get(
                    self.headers.get("X-Priority", "normal"), 1),
                tenant=self._tenant())
        except JobRejected:
            self.close_connection = True
            raise
        body = self.rfile.read(length)
        return np.load(io.BytesIO(body), allow_pickle=False)

    def _tenant(self) -> str | None:
        return self.headers.get("X-Tenant")

    def _read_json_body(self) -> dict:
        """Small JSON POST body ({} when absent)."""
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0:
            return {}
        if length > (1 << 20):
            self.close_connection = True
            raise StackFormatError(f"JSON body too large ({length} B)")
        body = self.rfile.read(length)
        try:
            out = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            raise StackFormatError("body must be a JSON object")
        if not isinstance(out, dict):
            raise StackFormatError("body must be a JSON object")
        return out

    def do_POST(self):
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            if url.path == "/submit":
                stack = self._read_stack_body()
                deadline = self.headers.get("X-Deadline-S")
                job = self.service.submit_array(
                    stack,
                    result_format=self.headers.get("X-Result-Format",
                                                   "ply"),
                    priority=self.headers.get("X-Priority", "normal"),
                    deadline_s=float(deadline) if deadline else None,
                    tenant=self._tenant())
                self._json({"job_id": job.job_id, "status": job.status})
            elif parts and parts[0] == "session":
                self._post_session(parts)
            else:
                self.close_connection = True
                self._json({"error": "not found"}, 404,
                           headers=(("Connection", "close"),))
        except JobRejected as e:
            self._reject(e)
        except UnknownSessionError as e:
            self._json({"error": {"type": type(e).__name__,
                                  "message": str(e)}}, 404)
        except Exception as e:
            # Undecodable body, bad header values, … — client-side
            # errors. The body may not have been read (e.g. a garbage
            # Content-Length header throws before rfile.read), so this
            # path closes the connection like the other early errors.
            self.close_connection = True
            self._json({"error": {"type": type(e).__name__,
                                  "message": str(e)}}, 400,
                       headers=(("Connection", "close"),))

    def _post_session(self, parts: list[str]) -> None:
        """POST /session | /session/<id>/stop | /session/<id>/finalize
        (docs/STREAMING.md)."""
        if len(parts) == 1:
            out = self.service.create_session(self._read_json_body(),
                                              tenant=self._tenant())
            self._json(out)
        elif len(parts) == 3 and parts[2] == "stop":
            stack = self._read_stack_body()
            job = self.service.submit_session_stop(parts[1], stack,
                                                   tenant=self._tenant())
            self._json({"job_id": job.job_id, "status": job.status,
                        "session_id": parts[1]})
        elif len(parts) == 3 and parts[2] == "adopt":
            # Fleet handoff (docs/SERVING.md § fleet): take over a live
            # session from the shared stream. 404 when no stream exists,
            # 409 when adoption cannot proceed (e.g. session registry
            # full) — the router tries the next survivor.
            try:
                out = self.service.adopt_session(parts[1])
            except (JobRejected, UnknownSessionError):
                raise
            except Exception as e:
                self._json({"error": {"type": type(e).__name__,
                                      "message": str(e)}}, 409)
                return
            self._json(out)
        elif len(parts) == 3 and parts[2] == "finalize":
            from .sessions import SessionResultEvicted

            body = self._read_json_body()
            try:
                job = self.service.finalize_session(
                    parts[1], body.get("result_format", "stl"))
            except (JobRejected, UnknownSessionError):
                raise
            except SessionResultEvicted as e:
                # The one-shot result-eviction semantics (HTTP 410):
                # finalize happened, the artifact is gone for good.
                self._json({"error": {"type": type(e).__name__,
                                      "message": str(e)}}, 410)
                return
            except Exception as e:
                # A finalize that cannot proceed (too few fused stops,
                # meshing failure) is a client-visible conflict, not a
                # server error — the session stays usable.
                self._json({"error": {"type": type(e).__name__,
                                      "message": str(e)}}, 409)
                return
            self._json({"job_id": job.job_id, "status": job.status,
                        "result": dict(job.result_meta)})
        else:
            self.close_connection = True
            self._json({"error": "not found"}, 404,
                       headers=(("Connection", "close"),))

    def do_GET(self):
        url = urlparse(self.path)
        if url.path == "/healthz":
            # LIVENESS: the process is up and answering — always 200.
            # Routing decisions belong to /readyz; if this endpoint went
            # 503 during a graceful drain, an orchestrator probing it
            # for liveness would kill the pod mid-drain.
            self._json({"ok": True, **self.service.stats()})
        elif url.path == "/readyz":
            # READINESS: 503 until warmup + recovery complete, while no
            # worker lane is alive, and during drain — the router's
            # send-traffic-here signal (docs/SERVING.md deployment
            # recipe).
            ready = self.service.readiness()
            self._json(ready, 200 if ready["ready"] else 503)
        elif url.path == "/metrics":
            data = self.service.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif url.path == "/events":
            q = parse_qs(url.query)
            try:
                n = int((q.get("n") or ["256"])[0])
            except ValueError:
                n = 256
            kind = (q.get("kind") or [None])[0]
            data = self.service.events_jsonl(max(1, n),
                                             kind=kind).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "application/x-ndjson; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif url.path.startswith("/cache/"):
            # Peer protocol (serve/fleet.py): export one LOCAL content-
            # cache artifact to a fleet peer. Served even while draining
            # (a free answer for a peer costs nothing and 404s would
            # look like misses).
            key = url.path[len("/cache/"):]
            out = None
            if len(key) == 64 and all(c in "0123456789abcdef"
                                      for c in key):
                out = self.service.cache_export(key)
            if out is None:
                self._json({"error": "no such artifact"}, 404)
            else:
                payload, meta, fmt = out
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("X-Content-Format", fmt)
                self.send_header("X-Content-Meta", json.dumps(meta))
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
        elif url.path == "/status":
            job_id = (parse_qs(url.query).get("id") or [""])[0]
            status = self.service.status(job_id)
            if status is None:
                self._json({"error": f"unknown job {job_id!r}"}, 404)
            else:
                self._json(status)
        elif url.path == "/result":
            self._result((parse_qs(url.query).get("id") or [""])[0])
        elif url.path.startswith("/session/"):
            self._get_session([p for p in url.path.split("/") if p],
                              parse_qs(url.query))
        else:
            self._json({"error": "not found"}, 404)

    def _get_session(self, parts: list[str], query=None) -> None:
        """GET /session/<id> (status) | /session/<id>/preview (latest
        progressive STL) | /session/<id>/render?az=..&el=.. (splat
        novel view PNG) | /session/<id>/splats (scene .npz)."""
        query = query or {}
        try:
            if len(parts) == 2:
                self._json(self.service.sessions.get(
                    parts[1]).status_dict())
            elif len(parts) == 3 and parts[2] == "render":
                self._session_render(parts[1], query)
            elif len(parts) == 3 and parts[2] == "splats":
                data = self.service.session_splats(parts[1])
                if data is None:
                    self._json({"session_id": parts[1],
                                "error": "no splat scene yet (submit a "
                                         "stop first)"}, 409)
                    return
                self._bytes(data, "application/octet-stream")
            elif len(parts) == 3 and parts[2] == "preview":
                out = self.service.session_preview(parts[1])
                if out is None:
                    self._json({"session_id": parts[1],
                                "error": "no preview yet (submit a "
                                         "stop first)"}, 409)
                    return
                data, meta = out
                self.send_response(200)
                self.send_header("Content-Type", _CONTENT_TYPES["stl"])
                self.send_header("Content-Length", str(len(data)))
                self.send_header("X-Preview-Stop", str(meta.get("stop")))
                self.send_header("X-Preview-Faces",
                                 str(meta.get("faces")))
                self.send_header("X-Stops-Fused",
                                 str(meta.get("stops_fused")))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._json({"error": "not found"}, 404)
        except UnknownSessionError as e:
            self._json({"error": {"type": type(e).__name__,
                                  "message": str(e)}}, 404)
        except JobRejected as e:
            # Render-surface refusals (no splat lane, off-menu size,
            # out-of-range angles) — client errors, not conflicts.
            self._reject(e)

    def _session_render(self, session_id: str, query: dict) -> None:
        """GET /session/<id>/render: az/el floats (defaults 30/20), an
        optional configured w×h. 400 on malformed/out-of-range values,
        409 before the first fused stop."""
        def num(name, default):
            raw = (query.get(name) or [None])[0]
            if raw is None:
                return default
            try:
                val = float(raw)
            except ValueError:
                raise StackFormatError(
                    f"query param {name!r} must be a number, "
                    f"got {raw!r}")
            if not np.isfinite(val):
                # 'nan'/'inf' PARSE as floats but int() on them raises
                # past the 400 mapping — reject them as the client
                # errors they are.
                raise StackFormatError(
                    f"query param {name!r} must be finite, got {raw!r}")
            return val

        def whole(name):
            val = num(name, None)
            if val is not None and val != int(val):
                # Truncating 384.9 → 384 would 200 at a size the
                # client did not ask for — the endpoint's strict-400
                # posture applies to fractional sizes too.
                raise StackFormatError(
                    f"query param {name!r} must be an integer, "
                    f"got {val!r}")
            return val

        azim = num("az", 30.0)
        elev = num("el", 20.0)
        w = whole("w")
        h = whole("h")
        out = self.service.render_session(
            session_id, azim, elev,
            None if w is None else int(w),
            None if h is None else int(h))
        if out is None:
            self._json({"session_id": session_id,
                        "error": "no splat scene yet (submit a stop "
                                 "first)"}, 409)
            return
        data, meta = out
        self.send_response(200)
        self.send_header("Content-Type", _CONTENT_TYPES["render_png"])
        self.send_header("Content-Length", str(len(data)))
        self.send_header("X-Render-Splats", str(meta.get("splats")))
        self.send_header("X-Render-Seconds", str(meta.get("render_s")))
        self.end_headers()
        self.wfile.write(data)

    def do_DELETE(self):
        parts = [p for p in urlparse(self.path).path.split("/") if p]
        if len(parts) == 2 and parts[0] == "session":
            try:
                self.service.sessions.delete(parts[1])
            except UnknownSessionError as e:
                self._json({"error": {"type": type(e).__name__,
                                      "message": str(e)}}, 404)
                return
            self._json({"session_id": parts[1], "deleted": True})
        else:
            self._json({"error": "not found"}, 404)

    def _result(self, job_id: str):
        job = self.service.get_job(job_id)
        if job is None:
            self._json({"error": f"unknown job {job_id!r}"}, 404)
        elif job.status == DONE:
            # Registry payload, or the content-hash cache when the byte
            # budget evicted it — 410 only when both are gone.
            data = self.service.result_payload(job)
            if data is None:
                self._json({"job_id": job_id, "status": job.status,
                            "error": "result evicted from the bounded "
                                     "result cache; resubmit the scan",
                            "result": dict(job.result_meta)}, 410)
            else:
                self._bytes(data, _CONTENT_TYPES[job.result_format])
        elif job.status == FAILED:
            self._json(job.status_dict(), 409)
        else:
            self._json({"job_id": job_id, "status": job.status,
                        "error": "result not ready"}, 409)

    def log_message(self, fmt, *args):  # per-request noise → debug log
        log.debug("http: " + fmt, *args)


class _Listener(ThreadingHTTPServer):
    """The stdlib listener with a deep accept backlog: ``socketserver``'s
    default of 5 overflows under a few dozen polling clients, and a dropped
    SYN costs the client a TCP retransmit of 1, 3, 7 … seconds."""

    request_queue_size = 128


class ServeHTTPServer:
    """Owns the listener thread (mirrors `hw/command_server.CommandServer`)."""

    def __init__(self, service: ReconstructionService,
                 host: str = "127.0.0.1", port: int = 0):
        self.service = service
        handler = type("BoundServeHandler", (_ServeHandler,),
                       {"service": service})
        self._httpd = _Listener((host, port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serve-http", daemon=True)
        self._started = False

    def start(self) -> "ServeHTTPServer":
        self._thread.start()
        self._started = True
        log.info("reconstruction service on :%d", self.port)
        return self

    def stop(self) -> None:
        if self._started:
            self._httpd.shutdown()
        self._httpd.server_close()
