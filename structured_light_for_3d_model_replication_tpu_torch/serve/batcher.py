"""Continuous batcher: bucket by padded shape, coalesce, flush on full/linger.

The pipeline's throughput lane is the batch program
(`models/pipeline.reconstruct_batch`: one decode-kernel launch for the
whole batch). Each (bucket, batch) program is built and warmed once (the
``ProgramCache``), so mixed traffic only rides that lane if the server
first makes shapes equal. This module does exactly two things:

* **bucketing** — a job's (H, W) is padded up to the smallest configured
  bucket that fits (else to a ``pad_quantum`` multiple, so arbitrary
  shapes still batch among themselves instead of each minting a new
  program). Padding is zero-fill: black pixels fail the decode validity
  threshold, so padded lanes triangulate to nothing and cost only
  bandwidth. The bucket key carries everything that selects a program
  (shape, bits, decode/tri configs).

* **coalescing** — per-bucket pending lists; a bucket flushes when it
  holds ``max_batch`` jobs OR its oldest job has lingered past
  ``linger_s``. Flush size rounds UP to the next power of two in
  ``batch_sizes`` (padded slots are zero stacks), so the program cache
  holds at most ``len(batch_sizes)`` executables per bucket and a burst
  of 5 runs as one B=8 launch, not 4+1.

This is the "continuous batching" shape every serving stack converges on
(vLLM-style): admission is decoupled from launch, and the linger timer
bounds the latency cost of waiting for company.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from ..config import DecodeConfig, TriangulationConfig
from ..utils import events
from ..utils.log import get_logger
from .jobs import AdmissionQueue, DeadlineExceededError, Job

log = get_logger(__name__)

DEFAULT_BATCH_SIZES = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """Everything that selects one compiled program family (all batch
    sizes of one shape/config combination). Frozen/hashable — it is a
    dict key here and the trunk of `cache.ProgramKey`."""

    height: int          # padded camera rows
    width: int           # padded camera cols
    frames: int          # protocol length (2 + 2*col_bits + 2*row_bits)
    col_bits: int
    row_bits: int
    decode_cfg: DecodeConfig = DecodeConfig()
    tri_cfg: TriangulationConfig = TriangulationConfig()
    downsample: int = 1

    def label(self) -> str:
        return f"{self.height}x{self.width}x{self.frames}"


def bucket_for(h: int, w: int, buckets: tuple,
               pad_quantum: int = 64) -> tuple[int, int]:
    """Smallest configured (H, W) bucket containing (h, w); off-menu
    shapes round up to ``pad_quantum`` multiples so they still coalesce
    with equals instead of compiling per-resolution."""
    best = None
    for bh, bw in buckets:
        if bh >= h and bw >= w:
            area = bh * bw
            if best is None or area < best[0]:
                best = (area, bh, bw)
    if best is not None:
        return best[1], best[2]
    q = pad_quantum
    return ((h + q - 1) // q * q, (w + q - 1) // q * q)


def batch_size_for(n: int, batch_sizes: tuple) -> int:
    """Smallest allowed batch size >= n (callers cap n at max first)."""
    for b in sorted(batch_sizes):
        if b >= n:
            return b
    return max(batch_sizes)


@dataclasses.dataclass
class Batch:
    """One flush: jobs + the padded device-ready array.

    ``occupancy`` is the number of REAL jobs; ``size`` the padded program
    batch dimension. The (B, F, H, W) array is assembled host-side here
    (cheap memcpy) so workers only own device interaction.
    """

    key: BucketKey
    jobs: list
    size: int
    lane: "int | None" = None   # device-lane affinity the flush honored
    # The ProgramKey the worker launched this batch through (stamped in
    # DeviceWorker._process): failure handling needs to know whether
    # the launch was lane-pinned or sharded cross-chip.
    program_key: object = None

    @property
    def occupancy(self) -> int:
        return len(self.jobs)

    def stacked(self) -> np.ndarray:
        k = self.key
        out = np.zeros((self.size, k.frames, k.height, k.width), np.uint8)
        for i, job in enumerate(self.jobs):
            f, h, w = job.stack.shape
            out[i, :f, :h, :w] = job.stack
        return out


class BucketBatcher:
    """Pulls from the admission queue, buckets, and hands coalesced
    batches to whichever worker asks next.

    Multiple workers share one batcher: ``next_batch`` is the
    synchronization point (internal lock), so batch assembly is
    single-writer per bucket while independent buckets drain in
    parallel across workers.
    """

    def __init__(self, queue: AdmissionQueue,
                 buckets: tuple = ((1080, 1920),),
                 batch_sizes: tuple = DEFAULT_BATCH_SIZES,
                 linger_s: float = 0.01,
                 pad_quantum: int = 64):
        if not batch_sizes:
            raise ValueError("batch_sizes must be non-empty")
        self.queue = queue
        self.buckets = tuple((int(h), int(w)) for h, w in buckets)
        self.batch_sizes = tuple(sorted(int(b) for b in batch_sizes))
        self.max_batch = self.batch_sizes[-1]
        self.linger_s = float(linger_s)
        self.pad_quantum = int(pad_quantum)
        self._lock = threading.Lock()
        # (lane | None, BucketKey) -> list[(enqueue_t, Job)]. The lane
        # half is device-lane AFFINITY (serve/lanes.py): jobs with
        # lane=None coalesce freely and any worker may flush them; a
        # session stop pinned to lane k only flushes to the worker on
        # that lane (sticky sessions — the session's state lives on that
        # card). Affine and free jobs never share a batch: they launch
        # through different programs.
        self._pending: dict[tuple, list] = {}
        # Device-loss hook (serve/service.py): maps a job to the lane it
        # should ride NOW — a stop whose session re-pinned after its
        # device died must land in the adopting lane's buckets, not wait
        # forever in a dead lane's. Applied at absorb time and by
        # repin_pending(); None = affinity is taken as stamped.
        self.lane_resolver = None  # callable(Job) -> int | None

    # ------------------------------------------------------------------

    def key_for(self, job: Job) -> BucketKey:
        f, h, w = job.stack.shape
        bh, bw = bucket_for(h, w, self.buckets, self.pad_quantum)
        return BucketKey(height=bh, width=bw, frames=f,
                         col_bits=job.col_bits, row_bits=job.row_bits,
                         decode_cfg=job.decode_cfg, tri_cfg=job.tri_cfg,
                         downsample=job.downsample)

    def pending_depth(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._pending.values())

    # ------------------------------------------------------------------

    def _absorb(self, job: Job) -> None:
        bkey = self.key_for(job)
        with self._lock:
            # Resolve INSIDE the lock: repin_pending() re-keys under
            # this lock, so a job resolved to a lane in its last
            # healthy instant either lands before the re-key (and is
            # re-keyed with the rest) or resolves after the death (and
            # sees the dead lane) — never inserted-after-re-key into a
            # bucket no worker will ever flush. The resolver takes the
            # pool/session locks; that order (batcher → pool/session)
            # matches repin_pending and is never reversed.
            if self.lane_resolver is not None:
                job.lane = self.lane_resolver(job)
            self._pending.setdefault((job.lane, bkey), []).append(
                (time.monotonic(), job))

    def requeue(self, job: Job) -> None:
        """Re-absorb a job whose batch died under it (the device-loss
        cross-lane retry, serve/worker.py): the lane resolver re-routes
        it to a surviving lane. Original enqueue order is NOT preserved
        — the retry is new work from the batcher's point of view."""
        self._absorb(job)

    def repin_pending(self) -> int:
        """Re-key every pending job through the lane resolver (the
        device-dead path: jobs parked in a dead lane's buckets would
        never flush — its workers are gone). Returns jobs moved."""
        if self.lane_resolver is None:
            return 0
        moved = 0
        with self._lock:
            items = [(key, entry) for key, lst in self._pending.items()
                     for entry in lst]
            self._pending.clear()
            for (old_lane, bkey), (t, job) in items:
                lane = self.lane_resolver(job)
                job.lane = lane
                if lane != old_lane:
                    moved += 1
                self._pending.setdefault((lane, bkey), []).append(
                    (t, job))
            for lst in self._pending.values():
                lst.sort(key=lambda e: e[0])
        return moved

    def _flushable(self, now: float, force: bool,
                   lane: "int | None") -> tuple | None:
        """Pending key due for flush: full beats lingering; among
        lingering ones, the oldest wait wins. A worker on ``lane`` may
        flush free (lane=None) buckets and its own lane's buckets;
        ``lane=None`` (no lane pool) flushes everything."""
        best = None
        with self._lock:
            for key, items in self._pending.items():
                if not items:
                    continue
                if not (lane is None or key[0] is None or key[0] == lane):
                    continue
                if len(items) >= self.max_batch:
                    return key
                age = now - items[0][0]
                if force or age >= self.linger_s:
                    if best is None or age > best[0]:
                        best = (age, key)
        return best[1] if best else None

    def _take(self, key: tuple) -> Batch | None:
        with self._lock:
            items = self._pending.get(key, [])
            take, rest = items[:self.max_batch], items[self.max_batch:]
            if rest:
                self._pending[key] = rest
            else:
                self._pending.pop(key, None)
        jobs = [j for _, j in take if not j.expired()]
        for _, j in take:
            if j not in jobs:
                # Context so the fault event the constructor records
                # carries the scrubbed job's id (same rule as the
                # queue-side scrub in jobs.pop).
                with events.context(job_id=j.job_id):
                    j.fail(DeadlineExceededError(
                        "deadline lapsed while batching"))
        if not jobs:
            return None
        return Batch(key=key[1], jobs=jobs,
                     size=batch_size_for(len(jobs), self.batch_sizes),
                     lane=key[0])

    # ------------------------------------------------------------------

    def next_batch(self, timeout: float = 0.1, force: bool = False,
                   lane: "int | None" = None) -> Batch | None:
        """Next coalesced batch, or None after ``timeout``.

        ``force=True`` flushes partial buckets immediately (drain path:
        linger is pointless when no more work is coming). ``lane``
        restricts the flush to free buckets plus that lane's affine
        ones (the caller is a lane-pinned worker); absorption from the
        queue is unrestricted — a worker may absorb another lane's job
        into the shared pending state, where its own worker picks it up
        within one loop tick."""
        deadline = time.monotonic() + timeout
        while True:
            # Absorb everything already queued without blocking.
            while True:
                job = self.queue.pop(timeout=0.0)
                if job is None:
                    break
                self._absorb(job)
            now = time.monotonic()
            key = self._flushable(now, force, lane)
            if key is not None:
                batch = self._take(key)
                if batch is not None:
                    return batch
                continue  # bucket was all-expired; rescan
            remaining = deadline - now
            if remaining <= 0:
                return None
            # Sleep until new work, but never past the nearest linger
            # expiry of a pending bucket (or the caller's deadline).
            wait = min(remaining, self._nearest_linger(now))
            job = self.queue.pop(timeout=max(wait, 0.0))
            if job is not None:
                self._absorb(job)

    def _nearest_linger(self, now: float) -> float:
        with self._lock:
            ages = [now - items[0][0]
                    for items in self._pending.values() if items]
        if not ages:
            # Nothing pending ⇒ no linger deadline to honor: let the
            # caller sleep its full remaining timeout on the queue
            # instead of waking every linger_s while idle.
            return float("inf")
        return max(0.0, self.linger_s - max(ages))
