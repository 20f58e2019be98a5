"""Device worker: batch launch, per-job postprocess, fault containment.

One worker owns one launch-at-a-time lane to the device: it asks the
batcher for a coalesced batch, fetches the built program from the
program cache (a hit in steady state), launches, reads back, and
postprocesses each job independently. Failure containment follows the
PR-3 rule (health.py): a poisoned stack degrades ITS job — a
`StopQualityError` in that job's status payload — while batchmates
complete normally and the process keeps serving. Only genuinely
batch-scoped failures (the launch itself) fail the whole batch, and even
those never kill the worker loop.

Graceful drain: ``request_stop`` flips the loop into force-flush mode —
partial buckets launch immediately (linger is pointless when no more
work is coming) — and the thread exits once batcher and queue are empty.
"""

from __future__ import annotations

import io
import threading
import time

import numpy as np
import torch

from ..health import QualityGates, ScanFault, StopQualityError
from ..hw import faults as hwfaults
from ..io.ply import PointCloud, write_ply
from ..io.stl import write_stl
from ..utils import events, sanitize, trace
from ..utils.log import get_logger
from .batcher import Batch, BucketBatcher
from .cache import ProgramCache, ProgramKey
from .jobs import DONE, FAILED

log = get_logger(__name__)


class DeviceOutputError(ScanFault):
    """A launch SUCCEEDED but its valid-masked payload is non-finite.
    Ambiguous on one observation — a sick chip emitting garbage OR a
    degenerate stack tripping a decode corner — so attribution is
    DEFERRED to the cross-lane retry's verdict: clean on another lane
    convicts the chip (feeds LANE health, never the whole-service
    breaker — one NaN-emitting chip must degrade itself, not shed
    fleet admissions), a second NaN elsewhere convicts the data (the
    job fails with the historical per-job containment semantics, and
    no lane is blamed — a poisoned upload must not walk healthy
    devices to dead). Detected only under SL_SANITIZE on multi-device
    pools; single-device services keep the historical per-job
    assert_finite containment."""


def _ply_bytes(cloud: PointCloud) -> bytes:
    buf = io.BytesIO()
    write_ply(buf, cloud)
    return buf.getvalue()


def _stl_bytes(mesh) -> bytes:
    buf = io.BytesIO()
    write_stl(buf, mesh)
    return buf.getvalue()


def _mesh_ply_bytes(mesh) -> bytes:
    from ..io.ply import write_ply_mesh

    buf = io.BytesIO()
    write_ply_mesh(buf, mesh)
    return buf.getvalue()


class DeviceWorker:
    """Thread running the batch → launch → postprocess loop.

    With a lane pool (serve/lanes.py) each worker is PINNED to one
    device lane: batches stage onto that chip, programs come from the
    lane's per-device cache keys, and `next_batch(lane=…)` restricts the
    flush to free buckets plus this lane's sticky-session ones. Buckets
    past the pool's ``shard_min_pixels`` route to the sharded cross-chip
    program instead (one huge job spans chips rather than serializing on
    this lane).
    """

    def __init__(self, batcher: BucketBatcher, cache: ProgramCache,
                 gates: QualityGates = QualityGates(),
                 mesh_depth: int = 7,
                 registry: "trace.MetricsRegistry | None" = None,
                 tracer: "trace.Tracer | None" = None,
                 name: str = "serve-worker",
                 governor=None, mesh_representation: str = "poisson",
                 lane=None, lane_pool=None, fault_injector=None):
        self.batcher = batcher
        self.cache = cache
        self.gates = gates
        self.mesh_depth = mesh_depth
        self.mesh_representation = mesh_representation
        self.registry = registry if registry is not None else trace.REGISTRY
        self.tracer = tracer if tracer is not None else trace.GLOBAL
        # Overload governor (serve/governor.py): fed worker outcomes for
        # the circuit breaker; the watchdog reads the heartbeat below.
        self.governor = governor
        self.lane = lane                # DeviceLane | None
        self.lane_pool = lane_pool      # DeviceLanePool | None
        # Seeded device chaos (hw/faults.DeviceFaultInjector, armed via
        # SL_DEVICE_FAULTS): launches on this lane go through the
        # FaultyDevice shim. None in production.
        self.fault_injector = fault_injector
        self.name = name
        # Heartbeat: stamped every loop iteration. While the thread is
        # stuck inside a launch it goes stale — the watchdog's wedge
        # signal.
        self.last_beat = time.monotonic()
        self.abandoned = False  # set by the watchdog on replacement
        self._stop = threading.Event()
        self._abort = threading.Event()
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._batches = self.registry.counter(
            "serve_batches_total", "batches launched")
        self._occupancy = self.registry.histogram(
            "serve_batch_occupancy", "real jobs per launched batch",
            buckets=(1, 2, 4, 8))
        self._padded = self.registry.counter(
            "serve_padded_slots_total",
            "batch slots filled with zero stacks to reach a bucketed size")
        # Per-lane visibility (docs/SERVING.md § multi-chip): which chip
        # did the work. Labeled by device so N workers sharing a chip
        # sum into one series; "default" = no lane pool (historical
        # single-device service).
        lane_label = self.lane.label if self.lane is not None else "default"
        self._lane_jobs = self.registry.counter(
            "serve_lane_jobs_total", "jobs completed per device lane",
            device=lane_label)
        self._lane_batches = self.registry.counter(
            "serve_lane_batches_total", "batches launched per device lane",
            device=lane_label)
        self._lane_occupancy = self.registry.histogram(
            "serve_lane_occupancy", "real jobs per batch, per device lane",
            buckets=(1, 2, 4, 8), device=lane_label)
        self._sharded_batches = self.registry.counter(
            "serve_sharded_batches_total",
            "batches dispatched through the cross-chip sharded tier")

    # ------------------------------------------------------------------

    def start(self) -> "DeviceWorker":
        self._thread.start()
        return self

    def request_stop(self) -> None:
        self._stop.set()

    def abort(self) -> None:
        """Crash-style stop: exit at the next loop iteration WITHOUT
        draining the queue or pending buckets (simulated kill -9 for the
        durability tests/bench — queued jobs stay non-terminal, exactly
        what the journal must recover)."""
        self._abort.set()

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    # ------------------------------------------------------------------

    def _run(self) -> None:
        if self.lane is not None and self.lane.device.type == "cuda":
            # The lane's card is this thread's current device: work the
            # postprocess and a session's ingest place by default (and
            # the current stream the kernels launch on) stay on it.
            torch.cuda.set_device(self.lane.device)
        while True:
            if self._abort.is_set():
                return
            self.last_beat = time.monotonic()
            draining = self._stop.is_set()
            batch = self.batcher.next_batch(
                timeout=0.05, force=draining,
                lane=self.lane.index if self.lane is not None else None)
            if batch is None:
                if draining and self.batcher.pending_depth() == 0 \
                        and self.batcher.queue.depth() == 0:
                    return
                continue
            try:
                contained = self._process(batch)
                # The breaker hears "ok" only for a batch with NO
                # service-side failures: a postprocess bug contained
                # per-job already fed note_worker_failure, and pairing
                # every such batch with an ok would pin the window's
                # failure rate at 50% no matter how broken the lane is.
                if self.governor is not None and not contained:
                    self.governor.note_worker_ok()
            except Exception as e:
                self._handle_batch_failure(batch, e)

    def _handle_batch_failure(self, batch: Batch, e: Exception) -> None:
        """Batch-scoped failure (compile, launch, transfer — or an
        injected/real device loss). Device-class faults feed LANE health
        (serve/lanes.py: healthy→suspect→dead escalation) and their jobs
        are RE-QUEUED onto a surviving lane instead of failed — a dead
        chip must cost latency, never acked work. Anything else keeps
        the historical containment: every job fails with the fault
        payload, and the governor's breaker counts it."""
        log.warning("batch %s failed: %s", batch.key.label(), e)
        key = getattr(batch, "program_key", None)
        sharded = key is not None and bool(key.shards)
        label = self.lane.label if self.lane is not None else None
        # Classify against THIS lane's platform ("cpu:0" → "cpu"), not
        # the process default backend — the right row of the device-loss
        # taxonomy in a heterogeneous pool.
        device_fault = (isinstance(e, DeviceOutputError)
                        or hwfaults.is_device_loss(
                            e, backend=label.split(":", 1)[0]
                            if label else None))
        events.record(
            "batch_failed", severity="error", message=str(e),
            program=batch.key.label(), exc_type=type(e).__name__,
            device=label or "default", device_fault=device_fault,
            sharded=sharded,
            jobs=",".join(j.job_id for j in batch.jobs))
        nan_fault = isinstance(e, DeviceOutputError)
        if device_fault and self.lane_pool is not None \
                and not nan_fault:
            if sharded:
                # A sharded program spans many chips and the launch
                # error cannot name WHICH mesh member died — blaming
                # the driving worker's own (healthy) lane would kill
                # the wrong chip. Instead the pool counts consecutive
                # faults per SPAN; at the threshold it fires the
                # service's probe-convict hook, which runs a tiny
                # program on each member and feeds mark_device_dead
                # with the actual casualty (docs/ROBUSTNESS.md §
                # probe-convict). The batch's jobs still retry below
                # and re-dispatch through whatever span route()
                # answers after the re-form.
                self.lane_pool.note_sharded_failure(
                    key.span or (), reason=type(e).__name__)
            elif label is not None:
                # NaN faults defer attribution further (below): the
                # fault could live in the DATA, and only the
                # cross-lane retry's outcome disambiguates.
                self.lane_pool.note_launch_failure(label,
                                                   reason="device_lost")
        failed = 0
        for job in batch.jobs:
            if device_fault and nan_fault and not sharded \
                    and getattr(job, "nan_lane", None) is not None:
                # Second NaN for this job, on a DIFFERENT lane: the
                # NaN follows the JOB, not the chip — a degenerate
                # stack tripping a decode/triangulate corner. Fail it
                # per the historical containment (below) and blame no
                # lane: without this, one poisoned upload retried a
                # few times would walk every healthy device to dead.
                pass
            elif device_fault and self._retry_cross_lane(
                    job, None if sharded else label):
                # Sharded faults exclude NO lane: the casualty is some
                # span member (the probe's verdict, maybe this worker's
                # own chip, maybe not) — excluding the driving lane
                # here would strand retries in a 2-lane pool once the
                # OTHER lane's device is convicted.
                if nan_fault and label is not None:
                    # Deferred attribution: remember where the NaN
                    # happened; a CLEAN completion on another lane
                    # confirms the chip (fed in _process), a second
                    # NaN elsewhere convicts the data (above).
                    job.nan_lane = label
                continue
            failed += 1
            with events.context(job_id=job.job_id):
                job.fail(e)
        # The breaker hears only batches that actually COST jobs: a
        # device-class fault whose work was absorbed by surviving lanes
        # is the lane escalation's problem, not grounds to shed
        # admissions fleet-wide. (On a single-device pool nothing can
        # absorb it, every job fails, and the breaker opens — the
        # historical protection.)
        if failed and self.governor is not None:
            self.governor.note_worker_failure()

    def _retry_cross_lane(self, job, exclude_label: str | None) -> bool:
        """Re-queue one job from a device-faulted batch onto a surviving
        lane. False (→ the caller fails the job honestly) when the pool
        has no healthy lane off this device, the retry budget is spent,
        or the job is already terminal (deadline scrub race)."""
        pool = self.lane_pool
        if pool is None or not pool.multi_device:
            return False
        if job.status in (DONE, FAILED):
            return True  # terminal already: nothing to fail OR retry
        if job.launch_retries >= max(2, len(pool.devices)):
            return False
        target = pool.retry_lane(exclude=exclude_label)
        if target is None:
            return False
        job.launch_retries += 1
        # Pin the retry to the surviving lane (the service's lane
        # resolver may re-route a session stop to its session's current
        # sticky lane at absorb time).
        job.lane = target.index
        events.record("job_lane_retry", severity="warning",
                      job_id=job.job_id, from_device=exclude_label,
                      to_device=target.label, retry=job.launch_retries)
        self.batcher.requeue(job)
        return True

    # ------------------------------------------------------------------

    def _process(self, batch: Batch) -> bool:
        """Run one batch; returns True when any job failed through the
        SERVICE-SIDE containment path (feeds the breaker's view of this
        batch — quality-gate failures are the client's data, not ours)."""
        t0 = time.monotonic()
        for job in batch.jobs:
            job.mark_running()
        if self.lane_pool is not None:
            # Lane routing (serve/lanes.py): the lane's per-device
            # program, or the sharded cross-chip one for buckets past
            # the size threshold.
            key = self.lane_pool.route(batch.key, batch.size, self.lane)
        else:
            key = ProgramKey(bucket=batch.key, batch=batch.size)
        # Stashed for _handle_batch_failure: a fault in a SHARDED
        # launch must not be attributed to this worker's own lane
        # device (route() may answer differently after a degrade).
        batch.program_key = key
        contained = False
        with self.tracer.span("serve.batch", program=key.label(),
                              occupancy=batch.occupancy):
            compiled = self.cache.get(key)
            if self.fault_injector is not None and self.lane is not None:
                # Seeded device chaos (hw/faults.py): the launch
                # boundary is where a dead/NaN-emitting chip manifests.
                # Sharded launches consult the injector per SPAN MEMBER
                # (FaultySpan) — a rule naming one chip kills the whole
                # cross-chip program, exactly like a real mesh — so a
                # sharded-only workload exercises the probe-convict
                # attribution path under SL_DEVICE_FAULTS.
                if key.shards and key.span:
                    compiled = hwfaults.FaultySpan(
                        compiled, key.span, self.fault_injector)
                elif not key.shards:
                    compiled = hwfaults.FaultyDevice(
                        compiled, self.lane.label, self.fault_injector)
            calib = self.cache.placed_calib(key)
            with self.tracer.span("launch"):  # path: serve.batch.launch
                # The launch runs on the current stream of the key's
                # device; the staged batch is dropped as soon as the
                # program returns (nothing keeps it alive past its
                # launch).
                out = compiled(self.cache.stage(key, batch.stacked()),
                               calib)
                # Single readback of the dense batch result; everything
                # after is host-side numpy.
                points = out.points.cpu().numpy()
                colors = out.colors.cpu().numpy()
                valid = out.valid.cpu().numpy()
                del out
            if sanitize.enabled() and self.lane_pool is not None \
                    and self.lane is not None \
                    and self.lane_pool.multi_device:
                # Device-output integrity at the READBACK boundary: a
                # chip claiming validity over non-finite points is a
                # device fault — escalate the lane and retry the batch
                # on a survivor (DeviceOutputError → device-class path
                # in _handle_batch_failure), instead of containing it
                # per job as a client-data problem.
                masked = points[valid.astype(bool)]
                if masked.size and not np.isfinite(masked).all():
                    raise DeviceOutputError(
                        f"launch on {self.lane.label} returned "
                        "non-finite points under a claimed-valid mask "
                        "— NaN-emitting device output")
            # Lane health hears the clean LAUNCH here (before the
            # postprocess, whose per-job failures are not the chip's
            # fault): the failure streak resets the moment the device
            # answers with sane output — and before the jobs turn
            # terminal, so a caller observing a done job observes the
            # healthy lane too. Sharded launches stay out of LANE
            # health both ways (see _handle_batch_failure): a
            # cross-chip success is not evidence about THIS lane's
            # chip and must not reset a genuine lane-pinned failure
            # streak — it resets the SPAN's consecutive-fault streak
            # instead.
            if self.lane_pool is not None and key.shards:
                self.lane_pool.note_sharded_ok(key.span or ())
            if self.lane_pool is not None and self.lane is not None \
                    and not key.shards:
                self.lane_pool.note_launch_ok(self.lane.label)
                # NaN verdicts (deferred from _handle_batch_failure):
                # this batch decoded CLEAN here, so a job that NaN'd on
                # another lane convicts THAT chip — the same data on a
                # healthy device is fine.
                for job in batch.jobs:
                    nan_lane = getattr(job, "nan_lane", None)
                    if nan_lane is not None \
                            and nan_lane != self.lane.label:
                        job.nan_lane = None
                        self.lane_pool.note_launch_failure(
                            nan_lane, reason="nan_output")
            self._batches.inc()
            self._occupancy.observe(batch.occupancy)
            self._padded.inc(batch.size - batch.occupancy)
            self._lane_batches.inc()
            self._lane_jobs.inc(batch.occupancy)
            self._lane_occupancy.observe(batch.occupancy)
            if key.shards:
                self._sharded_batches.inc()
            with self.tracer.span("postprocess"):
                for i, job in enumerate(batch.jobs):
                    contained |= self._finish_job(
                        job, batch.key, points[i], colors[i], valid[i])
        per_job = (time.monotonic() - t0) / max(1, batch.occupancy)
        self.batcher.queue.observe_service_time(per_job)
        return contained

    def _finish_job(self, job, key, points, colors, valid) -> bool:
        """Postprocess one job; True iff it failed via the service-side
        (unexpected-exception) containment path."""
        # Correlation context covers the whole postprocess: a gate raise
        # (StopQualityError construction) journals with this job's id.
        with events.context(job_id=job.job_id):
            try:
                result, meta = self._postprocess(job, key, points, colors,
                                                 valid)
                job.complete(result, **meta)
            except ScanFault as e:
                log.warning("job %s failed: %s", job.job_id, e)
                job.fail(e)
            except Exception as e:
                # Containment boundary: an unexpected host-side error (a
                # meshing corner case, a writer bug) costs this job only
                # — but unlike a quality-gate fault it IS a service-side
                # exception, so the breaker hears about it.
                log.warning("job %s failed unexpectedly: %s", job.job_id, e)
                events.record("job_contained", severity="error",
                              message=str(e), exc_type=type(e).__name__)
                job.fail(e)
                if self.governor is not None:
                    self.governor.note_worker_failure()
                return True
        return False

    def _postprocess(self, job, key, points, colors,
                     valid) -> tuple[bytes, dict]:
        """Dense per-job lane → client artifact (PLY cloud or STL mesh).

        The coverage gate reads the job's ORIGINAL (pre-padding) pixel
        region: padded pixels are black and decode invalid by design, so
        counting them would punish small-in-bucket jobs."""
        if job.decode_sink is not None:
            # Streaming session stop: the sink (the session's ingest,
            # serve/sessions.py) owns gating — its covisibility/coverage
            # decisions are skip-and-bridge, not per-job failures. Runs
            # on this worker thread under the session lock. Coverage is
            # measured over the job's ORIGINAL pre-padding region here
            # (same rule as the one-shot gate below) and handed along —
            # the session only sees the padded bucket lane.
            import json as _json

            _, h, w = job.stack.shape
            vgrid = valid.reshape(key.height, key.width)[:h, :w]
            meta = job.decode_sink(points, colors, valid,
                                   coverage=float(vgrid.mean()),
                                   frame_shape=(key.height, key.width))
            return _json.dumps(meta).encode(), meta
        _, h, w = job.stack.shape
        vgrid = valid.reshape(key.height, key.width)[:h, :w]
        coverage = float(vgrid.mean())
        if not self.gates.coverage_ok(coverage):
            raise StopQualityError(
                f"decode coverage {coverage:.4f} below gate "
                f"{self.gates.min_coverage} — stack unusable "
                "(black/saturated/garbage upload?)")
        keep = valid.astype(bool)
        cloud = PointCloud(points=points[keep].astype(np.float32),
                           colors=colors[keep].astype(np.uint8))
        if sanitize.enabled():
            # Valid-masked triangulations must be finite — a NaN here is
            # a decode/triangulate bug, caught AT the containment
            # boundary (fails this job only) instead of shipping as a
            # poisoned mesh.
            sanitize.assert_finite(cloud.points, "serve.postprocess")
        meta = {"points": int(len(cloud)), "coverage": round(coverage, 4)}
        if job.result_format == "ply":
            return _ply_bytes(cloud), meta
        # STL / mesh_ply: the models/meshing tail (normals → solve →
        # extraction → weld) on this job's cloud. ``mesh_ply`` keeps the
        # representation's vertex colors (fusion/; STL cannot carry
        # them).
        from ..models import meshing

        from ..parallel import mesh as pmesh

        # A sharded-bucket job solves on one card of the span its decode
        # spanned (serve/lanes.py): this lane's card when the span holds
        # it, else the span's first. Spread over the span's cards, a slab
        # of grid planes each, the dense solve took 2.6-5.5x one card's
        # time at depths 6 and 7 over 2 and 4 H100s (PERF.md, Findings).
        device = (self.lane.device if self.lane is not None
                  else self.cache.device)
        span = (self.lane_pool.solve_mesh(key)
                if self.lane_pool is not None else None)
        mesh = meshing.mesh_from_cloud(
            cloud, mode="watertight", depth=self.mesh_depth,
            quantile_trim=0.0,
            representation=self.mesh_representation,
            device_mesh=None if span is None else pmesh.serve_space_mesh(
                1, devices=[meshing.solve_device(span, device)]),
            device=device)
        meta.update(vertices=int(len(mesh.vertices)),
                    faces=int(len(mesh.faces)),
                    representation=self.mesh_representation)
        if len(mesh.faces) == 0:
            raise StopQualityError(
                f"meshing produced 0 faces from {len(cloud)} points — "
                "cloud too sparse for a watertight surface")
        if job.result_format == "mesh_ply":
            return _mesh_ply_bytes(mesh), meta
        return _stl_bytes(mesh), meta
