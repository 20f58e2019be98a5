"""Explicit program cache: warmup, LRU, hit/miss counters (counterpart of
the JAX package's ``serve/cache.py``).

A program is ``models/pipeline.reconstruct_batch`` bound to one
(bucket, batch, device). Its first use is the expensive one on the card:
the kernel library is built if it is not, and the first run at a shape
sizes the caching allocator's pools and creates the library handles. Here
that cost is paid EXPLICITLY — the "compile" of a key builds the library
and runs the program once on a zero batch of its exact shape — and the
program is held in a bounded LRU:

* **warmup** builds the configured buckets × batch sizes at startup, so
  steady-state traffic never pays a first run on the request path (the
  zero-rebuild acceptance bar, asserted in tests via these counters);
* **hit/miss/compile-time counters** land in the metrics registry
  (``serve_program_cache_*`` on /metrics), and every build is reported to
  the compile telemetry (``utils/telemetry.note_compile``), so a miss
  storm is visible as a counter spike, not a latency mystery;
* **LRU eviction** bounds the set of resident programs and their pinned
  staging buffers; evicting drops both, and the next use rebuilds
  (counted).

A build happens at most once per key even under concurrent misses: the
per-key entry holds an event that racers wait on while the first caller
builds outside the registry lock.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from .._device import resolve_device
from ..utils import telemetry, trace
from ..utils.log import get_logger
from .batcher import BucketKey
from .blobstore import BlobStore, open_blob_store

log = get_logger(__name__)


def label_device(label: str) -> torch.device:
    """The ``torch.device`` behind a lane label (``"cuda:1"``; ``"cpu:0"``
    is the host)."""
    kind, _, index = label.partition(":")
    if kind == "cpu":
        return torch.device("cpu")
    return torch.device(kind, int(index or 0))


@dataclasses.dataclass(frozen=True)
class ProgramKey:
    """BucketKey + batch size (+ placement): one built program.

    ``device`` pins the program to one card (a `lanes.DeviceLane` label
    like ``"cuda:0"``); ``None`` is the cache's own device. ``shards`` > 0
    selects the sharded cross-card tier instead: one program whose camera
    rows span that many devices (`parallel/pipeline.py`). ``span`` is the
    sharded program's device-SET identity — the sorted labels of the exact
    cards it runs on — so a span re-formed around a dead member is a
    distinct program from the full-width one, and reviving the member
    brings the still-cached full-span program back without a build. (The
    JAX package's count-prefix key, ``shards`` without a ``span``, has no
    router that makes it, and the port's cache refuses it.)
    """

    bucket: BucketKey
    batch: int
    device: str | None = None
    shards: int = 0
    span: tuple = ()

    def label(self) -> str:
        base = f"B{self.batch}:{self.bucket.label()}"
        if self.shards:
            if self.span:
                return f"{base}@mesh{self.shards}[{'+'.join(self.span)}]"
            return f"{base}@mesh{self.shards}"
        if self.device is not None:
            return f"{base}@{self.device}"
        return base


class _Entry:
    __slots__ = ("ready", "compiled", "error", "compile_s")

    def __init__(self):
        self.ready = threading.Event()
        self.compiled = None
        self.error: BaseException | None = None
        self.compile_s = 0.0


class _Program:
    """``reconstruct_batch`` bound to one bucket's configs and one device:
    ``program(stacks, calib) -> CloudResult`` on that device."""

    def __init__(self, bucket: BucketKey, device: torch.device):
        self.bucket = bucket
        self.device = device

    def __call__(self, stacks, calib):
        from ..models import pipeline

        b = self.bucket
        return pipeline.reconstruct_batch(
            stacks, calib, b.col_bits, b.row_bits, decode_cfg=b.decode_cfg,
            tri_cfg=b.tri_cfg, downsample=b.downsample, device=self.device)


class _ShardedProgram:
    """``parallel/pipeline.reconstruct_blocks`` bound to one bucket's
    configs and one span: ``program(blocks, calibs) -> CloudResult`` with
    each member's row block and calibration on that member, the result
    gathered on the host in member order."""

    def __init__(self, bucket: BucketKey, members):
        self.bucket = bucket
        self.members = tuple(members)

    def __call__(self, blocks, calibs):
        from ..parallel import pipeline as par

        b = self.bucket
        return par.reconstruct_blocks(
            [list(blocks)], [list(calibs)], b.col_bits, b.row_bits,
            decode_cfg=b.decode_cfg, tri_cfg=b.tri_cfg,
            downsample=b.downsample, out_device=torch.device("cpu"))


class _PinnedStager:
    """One (bucket, batch) program's host → card copy: the host batch is
    written into a reusable pinned buffer, then copied ``non_blocking`` on
    the current stream. The buffer is refilled only after its previous
    copy has landed (an event recorded behind each copy), so concurrent
    stagers of one key never overwrite a batch in flight."""

    def __init__(self, shape: tuple, device: torch.device):
        self.device = device
        self.buf = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
        self.done: torch.cuda.Event | None = None
        self.lock = threading.Lock()

    def __call__(self, batch: np.ndarray) -> torch.Tensor:
        with self.lock:
            if self.done is not None:
                self.done.synchronize()
            # torchlint: disable=host-read -- the pinned host buffer
            np.copyto(self.buf.numpy(), batch)
            with torch.cuda.device(self.device):
                staged = self.buf.to(self.device, non_blocking=True)
                self.done = torch.cuda.Event()
                self.done.record()
            return staged


class ProgramCache:
    """LRU of built batch-reconstruction programs.

    ``calib_provider(height, width)`` returns the Calibration for a
    bucket; it is placed once per (bucket, placement)
    (:meth:`placed_calib`). Keys without a device run on ``device`` (None
    means the card; the caller asks for the CPU with ``device="cpu"``). A
    sharded key's span resolves against ``devices``, the enumeration order
    of the lane pool (None = every card).
    """

    def __init__(self, calib_provider, max_entries: int = 32,
                 registry: "trace.MetricsRegistry | None" = None,
                 device=None, devices=None):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.calib_provider = calib_provider
        self.max_entries = max_entries
        self.device = resolve_device(device)
        self.devices = None if devices is None else list(devices)
        self.registry = registry if registry is not None else trace.REGISTRY
        self._lock = threading.Lock()
        self._entries: OrderedDict[ProgramKey, _Entry] = OrderedDict()
        self._hits = self.registry.counter(
            "serve_program_cache_hits_total",
            "program-cache lookups served without compiling")
        self._misses = self.registry.counter(
            "serve_program_cache_misses_total",
            "program-cache lookups that triggered a compile")
        self._evictions = self.registry.counter(
            "serve_program_cache_evictions_total",
            "programs dropped by LRU bounding")
        self._compile_s = self.registry.counter(
            "serve_program_cache_compile_seconds_total",
            "cumulative wall-clock spent compiling programs")
        self._entries_gauge = self.registry.gauge(
            "serve_program_cache_entries", "resident compiled programs")
        # Placement memos (tiny, bounded by devices × buckets): one placed
        # calibration per (bucket geometry, placement), and one pinned
        # staging buffer per member of a resident (bucket, batch,
        # placement) program.
        self._placed_calibs: dict = {}
        self._stagers: dict = {}

    # -- placement -----------------------------------------------------

    def placement(self, key: ProgramKey) -> tuple:
        """The devices ``key``'s program runs on: the lane's card, the
        cache's own device for an un-pinned key, or a sharded key's span
        members in ENUMERATION order (`parallel/mesh.
        resolve_device_labels`: row placement must not follow label
        order)."""
        if key.shards:
            from ..parallel import mesh as pmesh

            if len(key.span) != key.shards:
                raise ValueError(f"{key.label()}: a sharded key names its "
                                 f"{key.shards} members")
            return tuple(pmesh.resolve_device_labels(
                key.span, self.devices if self.devices is not None
                else pmesh.local_devices()))
        if key.device is None:
            return (self.device,)
        return (label_device(key.device),)

    def placed_calib(self, key: ProgramKey):
        """The calibration where ``key``'s program expects it — on the
        lane's device, or one copy on each span member (a tuple) —
        memoized per (bucket geometry, placement): every batch of a bucket
        reuses the same tensors."""
        b = key.bucket
        members = self.placement(key)
        memo = (b.height, b.width, key.span or members[0])
        with self._lock:
            placed = self._placed_calibs.get(memo)
        if placed is not None:
            return placed
        calib = self.calib_provider(b.height, b.width)
        if key.shards:
            placed = tuple(calib.to(d) for d in members)
        else:
            placed = calib if calib.Nc.device == members[0] \
                else calib.to(members[0])
        with self._lock:
            placed = self._placed_calibs.setdefault(memo, placed)
        return placed

    def stage(self, key: ProgramKey, batch):
        """One host batch array (B, F, H, W) uint8 where ``key``'s program
        expects it: on the lane's card through the key's pinned buffer and
        a ``non_blocking`` copy (on the CPU the array itself); for a
        sharded key, the batch split by rows into one block per span
        member, each through its own pinned buffer. The caller drops what
        it gets once its launch is done."""
        members = self.placement(key)
        batch = np.ascontiguousarray(batch, dtype=np.uint8)
        if not key.shards:
            return self._staged(key, batch, members[0], 0)
        from ..parallel import mesh as pmesh

        return [self._staged(key, batch[:, :, r0:r1], dev, i)
                for i, ((r0, r1), dev) in enumerate(zip(
                    pmesh.blocks(batch.shape[2], len(members)), members))]

    def _staged(self, key: ProgramKey, batch: np.ndarray,
                dev: torch.device, member: int) -> torch.Tensor:
        if dev.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(batch))
        memo = (key.bucket, key.batch, key.span or dev, member)
        with self._lock:
            stager = self._stagers.get(memo)
            if stager is None:
                stager = self._stagers[memo] = _PinnedStager(
                    batch.shape, dev)
        return stager(batch)

    def release_staging(self) -> None:
        """Drop every pinned staging buffer (a stopped service's): the
        caching host allocator keeps the blocks, so a successor service in
        the same process stages into them instead of pinning more."""
        with self._lock:
            self._stagers.clear()

    # ------------------------------------------------------------------

    def _compile(self, key: ProgramKey):
        """Build ``key``'s program: the kernel library (on the card, if it
        is not built), then one run on a zero batch of the key's exact
        shape, read back — timed as the compile."""
        b = key.bucket
        members = self.placement(key)
        program = (_ShardedProgram(b, members) if key.shards
                   else _Program(b, members[0]))
        calib = self.placed_calib(key)
        t0 = time.monotonic()
        if any(d.type == "cuda" for d in members):
            from ..kernels import build

            build.library()
        # A sharded build runs the zero batch on every member.
        zero = self.stage(key, np.zeros(
            (key.batch, b.frames, b.height, b.width), np.uint8))
        out = program(zero, calib)
        out.valid.any().item()
        del zero, out
        dt = time.monotonic() - t0
        self._compile_s.inc(dt)
        telemetry.note_compile(dt)
        log.info("compiled %s in %.2fs", key.label(), dt)
        return program, dt

    def get(self, key: ProgramKey):
        """The compiled executable for ``key`` — compiling (and counting a
        miss) if absent, else a counted hit. Raises the original compile
        error on every lookup of a key whose compile failed (failed
        entries are not cached)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                owner = False
            else:
                entry = _Entry()
                self._entries[key] = entry
                owner = True
        if owner:
            self._misses.inc()
            try:
                entry.compiled, entry.compile_s = self._compile(key)
            except BaseException as e:
                entry.error = e
                with self._lock:
                    self._entries.pop(key, None)
                raise
            finally:
                entry.ready.set()
            self._bound()
        else:
            entry.ready.wait()
            if entry.error is not None:
                raise entry.error
            self._hits.inc()
        with self._lock:
            self._entries_gauge.set(len(self._entries))
        return entry.compiled

    def _bound(self) -> None:
        with self._lock:
            while len(self._entries) > self.max_entries:
                # Victim = oldest READY entry: an in-flight compile must
                # not be popped (its executable would be dropped the
                # moment it finishes, forcing a duplicate compile on the
                # next lookup of that key).
                victim = next((k for k, e in self._entries.items()
                               if e.ready.is_set()), None)
                if victim is None:
                    break  # everything resident is mid-compile
                self._entries.pop(victim)
                self._stagers = {m: st for m, st in self._stagers.items()
                                 if m[:2] != (victim.bucket, victim.batch)}
                self._evictions.inc()
                log.info("evicted %s (LRU, max_entries=%d)",
                         victim.label(), self.max_entries)

    # ------------------------------------------------------------------

    def warmup(self, bucket_keys, batch_sizes=(),
               program_keys=()) -> dict:
        """Build every (bucket, batch) program — plus any explicit
        ``program_keys`` (the per-device lane set the service routes to);
        returns {label: compile_s}. Called at service start so the first
        real request of any configured shape is a hit."""
        out = {}
        keys = [ProgramKey(bucket=bucket, batch=int(b))
                for bucket in bucket_keys for b in batch_sizes]
        keys.extend(program_keys)
        for key in keys:
            with trace.span("serve.warmup", program=key.label()):
                t0 = time.monotonic()
                self.get(key)
                out[key.label()] = round(time.monotonic() - t0, 3)
        # Warmup compiles are misses by construction; zero them out of the
        # steady-state signal? No — they stay counted (honest totals), and
        # the zero-recompile assertion compares counters AFTER warmup.
        return out

    def stats(self) -> dict:
        with self._lock:
            entries = [k.label() for k in self._entries]
        return {
            "entries": entries,
            "size": len(entries),
            "max_entries": self.max_entries,
            "hits": int(self._hits.value),
            "misses": int(self._misses.value),
            "evictions": int(self._evictions.value),
            "compile_seconds_total": round(self._compile_s.value, 3),
        }


# ---------------------------------------------------------------------------
# Content-hash result cache
# ---------------------------------------------------------------------------


def content_key(stack, config_sig: str) -> str:
    """SHA-256 over the capture stack (shape + dtype + raw bytes) and
    the reconstruction config signature: two submits with identical
    pixels AND identical processing settings name the same artifact.
    Shape/dtype are part of the key — raw bytes alone would let two
    different-shaped stacks over the same buffer collide."""
    import numpy as np

    h = hashlib.sha256()
    h.update(config_sig.encode())
    h.update(f"{stack.shape}/{stack.dtype}".encode())
    h.update(np.ascontiguousarray(stack).tobytes())
    return h.hexdigest()


class ContentCache:
    """Byte-bounded LRU of finished result artifacts keyed by content
    hash — the admission-time duplicate detector.

    A duplicate submit returns the cached mesh without touching the
    queue, which makes it independent of BOTH bounds the job registry
    enforces (``completed_cap`` / ``result_cache_bytes``): a result
    evicted from the registry's byte budget still answers a resubmit
    with 200 instead of 410. With a directory (the journal volume's
    ``content/``) the cache also survives restarts: payloads live on
    disk (``<key>.bin`` + ``<key>.json`` sidecar, tmp + atomic rename),
    the in-memory index is rebuilt from the sidecars at open, and hits
    read the payload back lazily. Without a directory it is memory-only
    with the same budget.

    Persistence rides the :class:`~.blobstore.BlobStore` seam: ``dir``
    opens the historical local layout (byte-for-byte identical), or
    pass ``store=`` an :class:`~.blobstore.ObjectStore` to persist
    artifacts in an S3-style service instead of a POSIX volume. Either
    way every store failure is absorbed here (quarantine + miss) —
    corruption and outages degrade the cache, never admission.

    Failed jobs are never cached (their taxonomy payload is the honest
    answer), and session stops never consult it (a duplicate stop is the
    covisibility gate's decision, not the cache's).
    """

    def __init__(self, max_bytes: int = 256 << 20, dir: str | None = None,
                 registry: "trace.MetricsRegistry | None" = None,
                 store: BlobStore | None = None):
        self.max_bytes = int(max_bytes)
        self.dir = dir
        # allow_faults=False: SL_BLOB_FAULTS targets the SHARED fleet
        # stores (handoff streams, pin board); silently injecting env
        # faults into every replica's private artifact cache would skew
        # the duplicate-hit ratios the fleet gates assert on. Chaos
        # coverage for this class passes a FaultyBlobStore explicitly.
        self._blob: BlobStore | None = (
            store if store is not None
            else (open_blob_store(dir, allow_faults=False)
                  if dir is not None else None))
        self.registry = registry if registry is not None else trace.REGISTRY
        self._lock = threading.Lock()
        # key -> {"bytes": int, "format": str, "meta": dict,
        #         "payload": bytes | None}   (payload None = on disk)
        self._index: OrderedDict[str, dict] = OrderedDict()
        self._held = 0
        self._hits = self.registry.counter(
            "serve_content_cache_hits_total",
            "admissions answered from the content-hash result cache")
        self._misses = self.registry.counter(
            "serve_content_cache_misses_total",
            "admissions that found no cached artifact")
        self._evictions = self.registry.counter(
            "serve_content_cache_evictions_total",
            "artifacts dropped by the byte budget")
        self._corrupt = self.registry.counter(
            "serve_content_cache_corrupt_total",
            "corrupt/truncated disk blobs quarantined at load or hit")
        self._bytes_gauge = self.registry.gauge(
            "serve_content_cache_bytes", "retained artifact bytes")
        # Cached quarantine-object count: stats() rides every /healthz
        # scrape (and the router's per-second signal sweep), so it must
        # never pay a store listing — seeded once at open, bumped per
        # quarantine move.
        self._quarantined_objects = 0
        if self._blob is not None:
            if dir is not None:
                os.makedirs(os.path.join(dir, "quarantine"),
                            exist_ok=True)
            try:
                self._quarantined_objects = sum(
                    1 for k in self._blob.list("quarantine/")
                    if k.endswith(".bin"))
            except OSError:
                pass
            self._load_index()

    # ------------------------------------------------------------------

    def _payload_key(self, key: str) -> str:
        return f"{key}.bin"

    def _quarantine(self, key: str, reason: str) -> None:
        """Move a corrupt entry's objects aside (never delete evidence —
        the quarantine prefix is what a post-mortem inspects) and count
        it. The entry is already out of the index when this runs; a
        quarantined key simply misses, it NEVER raises into admission."""
        self._corrupt.inc()
        log.warning("content cache entry %s quarantined: %s",
                    key[:12], reason)
        for suffix in (".bin", ".json"):
            try:
                self._blob.rename(f"{key}{suffix}",
                                  f"quarantine/{key}{suffix}")
                if suffix == ".bin":
                    with self._lock:
                        self._quarantined_objects += 1
            except OSError:
                log.debug("quarantine move of %s%s failed", key[:12],
                          suffix)

    def _load_index(self) -> None:
        """Rebuild the index from sidecars, oldest first (so LRU order
        approximates the previous process's write order)."""
        sidecars = []
        try:
            names = self._blob.list("")
        except OSError as e:
            log.warning("content cache index unreadable: %s", e)
            names = []
        for fname in names:
            if "/" in fname or not fname.endswith(".json"):
                continue
            try:
                raw = self._blob.get(fname)
                doc = json.loads(raw.decode()) if raw is not None \
                    else None
            except (OSError, ValueError, UnicodeDecodeError):
                continue
            if doc is None:
                continue
            key = fname[:-5]
            try:
                size = self._blob.size(self._payload_key(key))
            except OSError:
                size = None
            if size is None:
                continue  # no payload: sidecar-only orphan
            if size != int(doc.get("bytes", -1)):
                # Truncated/grown blob (torn write, disk fault): a miss
                # and a quarantine, never an entry that would raise —
                # or serve garbage — at hit time.
                self._quarantine(key, f"size {size} != sidecar "
                                      f"{doc.get('bytes')}")
                continue
            sidecars.append((float(doc.get("t", 0.0)), key, doc))
        for _, key, doc in sorted(sidecars):
            n = int(doc.get("bytes", 0))
            self._index[key] = {"bytes": n,
                                "format": doc.get("format", "ply"),
                                "meta": dict(doc.get("meta") or {}),
                                "sha256": doc.get("sha256"),
                                "payload": None}
            self._held += n
        # Enforce the budget at load too: a lowered max_bytes (or a
        # previous process's fuller budget) must not survive the
        # restart — evict oldest exactly like put() does.
        while self._held > self.max_bytes and len(self._index) > 1:
            victim, entry = self._index.popitem(last=False)
            self._held -= entry["bytes"]
            self._evictions.inc()
            for suffix in (".bin", ".json"):
                try:
                    self._blob.delete(f"{victim}{suffix}")
                except OSError:
                    pass
        self._bytes_gauge.set(self._held)
        if self._index:
            log.info("content cache: %d artifacts (%d MB) recovered "
                     "from %s", len(self._index), self._held >> 20,
                     self.dir or self._blob.stats())

    # ------------------------------------------------------------------

    def get(self, key: str) -> tuple[bytes, dict, str] | None:
        """(payload, meta, format) for ``key``, or None. Counts the
        hit/miss; disk reads happen outside the index lock. A corrupt
        or truncated disk blob counts as a MISS and is quarantined —
        admission never sees an exception from this path."""
        return self._get(key, count=True)

    def peek(self, key: str) -> tuple[bytes, dict, str] | None:
        """``get`` without touching the hit/miss counters — the peer
        protocol's export path (serve/fleet.py), so fleet probes don't
        masquerade as admission traffic on this replica's dashboards.
        Corruption handling is identical (quarantine, miss)."""
        return self._get(key, count=False)

    def _get(self, key: str, count: bool) -> tuple[bytes, dict, str] | None:
        with self._lock:
            entry = self._index.get(key)
            if entry is not None:
                self._index.move_to_end(key)
                payload = entry["payload"]
                meta, fmt = dict(entry["meta"]), entry["format"]
                want_bytes = entry["bytes"]
                want_sha = entry.get("sha256")
        if entry is None:
            if count:
                self._misses.inc()
            return None
        if payload is None:
            try:
                payload = self._blob.get(self._payload_key(key))
            except OSError as e:
                payload = None
                reason = f"unreadable ({e})"
            else:
                reason = "payload object missing"
            if payload is None:
                self._drop(key)
                self._quarantine(key, reason)
                if count:
                    self._misses.inc()
                return None
            # Integrity gate: a bit-flipped or truncated blob must never
            # reach a client (or a fleet peer) as a "cached artifact".
            corrupt = (len(payload) != want_bytes
                       or (want_sha is not None
                           and hashlib.sha256(payload).hexdigest()
                           != want_sha))
            if corrupt:
                self._drop(key)
                self._quarantine(
                    key, f"payload {len(payload)}B fails integrity "
                         f"check (want {want_bytes}B)")
                if count:
                    self._misses.inc()
                return None
        if count:
            self._hits.inc()
        return payload, meta, fmt

    def _drop(self, key: str) -> None:
        with self._lock:
            gone = self._index.pop(key, None)
            if gone is not None:
                self._held -= gone["bytes"]
                self._bytes_gauge.set(self._held)

    def put(self, key: str, payload: bytes, meta: dict, fmt: str) -> None:
        """Retain one finished artifact; evicts oldest past the byte
        budget. File writes happen before the index insert so a hit can
        never race a half-written payload."""
        if len(payload) > self.max_bytes:
            return  # one artifact over the whole budget: not cacheable
        stored: bytes | None = payload
        # Digest only for store-backed caches: memory-held payloads are
        # never re-read, so hashing them would be pure wasted CPU on
        # the job-completion path.
        sha = (hashlib.sha256(payload).hexdigest()
               if self._blob is not None else None)
        if self._blob is not None:
            side = json.dumps({"format": fmt, "meta": meta,
                               "bytes": len(payload), "sha256": sha,
                               "t": time.time()}).encode()
            try:
                self._blob.put(self._payload_key(key), payload)
                self._blob.put(f"{key}.json", side)
            except OSError as e:
                log.warning("content cache write failed: %s", e)
                return
            stored = None
        victims: list[str] = []
        with self._lock:
            prior = self._index.pop(key, None)
            if prior is not None:
                self._held -= prior["bytes"]
            self._index[key] = {"bytes": len(payload), "format": fmt,
                                "meta": dict(meta), "sha256": sha,
                                "payload": stored}
            self._held += len(payload)
            while self._held > self.max_bytes and len(self._index) > 1:
                victim, entry = self._index.popitem(last=False)
                self._held -= entry["bytes"]
                victims.append(victim)
            self._bytes_gauge.set(self._held)
        for victim in victims:
            self._evictions.inc()
            if self._blob is not None:
                for suffix in (".bin", ".json"):
                    try:
                        self._blob.delete(f"{victim}{suffix}")
                    except OSError:
                        pass

    def stats(self) -> dict:
        with self._lock:
            quarantined = self._quarantined_objects
            return {
                "entries": len(self._index),
                "bytes": self._held,
                "max_bytes": self.max_bytes,
                "persistent": self._blob is not None,
                "backend": (self._blob.stats().get("backend")
                            if self._blob is not None else None),
                "hits": int(self._hits.value),
                "misses": int(self._misses.value),
                "evictions": int(self._evictions.value),
                "corrupt_quarantined": int(self._corrupt.value),
                "quarantined_objects": quarantined,
            }
