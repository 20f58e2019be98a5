"""Crash-safe journal + snapshot store for the reconstruction service.

The paper's own pipeline persists every stage to disk so any step can be
re-run offline; this module restores that property to the serving stack.
A :class:`JournalStore` is one directory (the "journal volume" of
docs/SERVING.md's deployment recipe):

    <root>/journal.jsonl     append-only op log (one JSON object per line)
    <root>/stacks/           .npy capture-stack blobs referenced by ops
    <root>/content/          content-hash result cache (serve/cache.py)

**What is journaled.** Job admissions (with the stack blob), job
terminal transitions, session creations, every ACCEPTED session stop
(with its stack blob; a ``stop_failed`` op marks one whose job later
failed service-side — the live session never fused it, so replay skips
it), and session endings (finalized / deleted / expired / evicted).
After a ``kill -9``, :meth:`recover` rebuilds the live set:
non-terminal jobs are re-queued and live sessions are replayed stop by
stop through the already-compiled B=1 program lane
(`ReconstructionService.start(recover_from=...)`) — the replay is
deterministic, so a recovered session finalizes bitwise-identically to
an uninterrupted one (tests/test_durability.py).

**Group commit.** A single writer thread owns the file: ``append``
enqueues the serialized op and (by default) blocks until its batch is
written + flushed, so concurrent submitters amortize one write/flush per
batch instead of serializing on the file lock — and no service lock is
ever held across journal I/O (no blocking under a lock).
``flush`` is the ``kill -9`` durability bar (the bytes survive the
process in the page cache); ``fsync`` is batched on a timer
(``fsync_interval_s``) as the cheap host-crash hedge.

**Compaction.** Terminal jobs and ended sessions are dead weight; when
enough dead ops accumulate the writer rewrites the journal from the live
mirror (tmp file + atomic rename) and deletes unreferenced stack blobs.
A fresh open compacts immediately, so restart cost is O(live), not
O(history).
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import threading
import time
from collections import OrderedDict

import numpy as np

from ..utils import events
from ..utils.log import get_logger
from .blobstore import BlobStore, open_blob_store

log = get_logger(__name__)

JOURNAL_NAME = "journal.jsonl"
STACKS_DIR = "stacks"
CONTENT_DIR = "content"


# ---------------------------------------------------------------------------
# Recovered state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RecoveredJob:
    """One non-terminal one-shot job found in the journal."""

    job_id: str
    stack_path: str
    result_format: str = "ply"
    priority: int = 1
    deadline_s: float | None = None
    submitted_wall: float = 0.0
    content_key: str | None = None


@dataclasses.dataclass
class RecoveredSession:
    """One live (never-ended) streaming session + its accepted stops in
    submission order. ``replica`` is the replica id that journaled the
    session head (fleet tier: ownership comparisons against the handoff
    stream decide whether a recovering replica still owns it)."""

    session_id: str
    scan_id: str
    options: dict
    stop_paths: list = dataclasses.field(default_factory=list)
    replica: str | None = None
    # (job_id, blob) pairs for handoff streams, where blob identity (not
    # a journal-relative path) names the shared-volume copy.
    stops: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RecoveredState:
    jobs: list          # [RecoveredJob] in admission order
    sessions: list      # [RecoveredSession] in creation order
    ops: int = 0
    corrupt_lines: int = 0

    @property
    def empty(self) -> bool:
        return not self.jobs and not self.sessions


def _parse_journal(path: str) -> RecoveredState:
    """Tolerant replay of one journal file: unknown ops are ignored
    (forward compatibility), a torn final line (crash mid-write of an
    unacked op) is skipped and counted."""
    jobs: dict[str, RecoveredJob] = {}
    done: set[str] = set()
    sessions: dict[str, RecoveredSession] = {}
    ended: set[str] = set()
    stops: dict[str, list] = {}        # sid -> [(job_id, path)]
    failed_stops: set[str] = set()     # stop job_ids that never fused
    ops = corrupt = 0
    if not os.path.exists(path):
        return RecoveredState(jobs=[], sessions=[])
    with open(path, "rb") as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            try:
                op = json.loads(line)
            except ValueError:
                corrupt += 1
                continue
            ops += 1
            kind = op.get("op")
            if kind == "job":
                jobs[op["job_id"]] = RecoveredJob(
                    job_id=op["job_id"], stack_path=op["stack"],
                    result_format=op.get("result_format", "ply"),
                    priority=int(op.get("priority", 1)),
                    deadline_s=op.get("deadline_s"),
                    submitted_wall=float(op.get("t_wall", 0.0)),
                    content_key=op.get("content_key"))
            elif kind == "job_done":
                done.add(op["job_id"])
            elif kind == "session":
                sid = op["session_id"]
                sessions[sid] = RecoveredSession(
                    session_id=sid, scan_id=op.get("scan_id", sid),
                    options=dict(op.get("options") or {}),
                    replica=op.get("replica"))
            elif kind == "stop":
                if op["session_id"] in sessions:
                    stops.setdefault(op["session_id"], []).append(
                        (op.get("job_id"), op["stack"]))
            elif kind == "stop_failed":
                # The stop's job failed service-side: the live session
                # never fused it, so replay must skip it (set-based —
                # tolerates the op landing before its stop op).
                if op.get("job_id"):
                    failed_stops.add(op["job_id"])
            elif kind == "session_end":
                ended.add(op["session_id"])
            # "note" and unknown ops carry no recoverable state.
    for sid, entries in stops.items():
        live = [(jid, p) for jid, p in entries
                if jid not in failed_stops]
        sessions[sid].stop_paths = [p for _, p in live]
        sessions[sid].stops = live
    live_jobs = [j for jid, j in jobs.items() if jid not in done]
    live_sessions = [s for sid, s in sessions.items() if sid not in ended]
    return RecoveredState(jobs=live_jobs, sessions=live_sessions,
                          ops=ops, corrupt_lines=corrupt)


# ---------------------------------------------------------------------------
# Session handoff streams (the fleet tier's shared volume)
# ---------------------------------------------------------------------------

#: WAL ops the sink mirrors to the shared volume.
SESSION_STREAM_OPS = ("session", "stop", "stop_failed", "session_end",
                      "session_owner")


class SessionStreamStore:
    """Per-session op streams on a shared volume — the
    :class:`JournalStore` **sink abstraction** of the fleet tier
    (docs/SERVING.md § fleet).

    Layout::

        <root>/<session_id>.jsonl    the session's op stream
        <root>/blobs/                stack blobs (one per accepted stop)

    The owning :class:`JournalStore` mirrors session-scoped WAL ops here
    from its writer thread **inside the group commit** (before the
    commit event fires), so an acked session stop is on the shared
    volume by the time the client sees its HTTP 200 — the property that
    lets the router re-pin a SIGKILLed replica's live sessions to a
    survivor (`ReconstructionService.adopt_session`) with zero acked
    stops lost.

    Appends are lock-free single ``write`` calls in append mode, so the
    writer thread and an adopting service can interleave safely;
    :meth:`read_session` is tolerant by construction — duplicate heads
    take the LAST (ownership moved), duplicate stops dedup by job id
    keeping the FIRST (an adopter's replayed stops mirror again with the
    same ids), ``stop_failed`` removes its stop, torn tails are skipped.
    A mirrored ``session_end`` deletes the stream file and its blobs:
    an empty stream directory after drain is the fleet-level
    journal-clean signal.

    Storage rides the :class:`~.blobstore.BlobStore` seam: ``root`` may
    be a local directory (the historical shared-POSIX-volume layout,
    preserved byte for byte) or an object-store spec
    (``http://host:port[/prefix]`` — replicas then share NO filesystem;
    serve/blobstore.py). Every store failure is an OSError the callers'
    containment already absorbs: a sick store degrades handoff
    durability, never serving.
    """

    BLOBS_DIR = "blobs"

    def __init__(self, root: str, store: BlobStore | None = None):
        self.root = root
        self.store = store if store is not None else open_blob_store(root)
        self.mirror_failures = 0

    # -- keys -----------------------------------------------------------

    def _stream_key(self, session_id: str) -> str:
        # Session ids are uuid hex (ours) but defend the key join
        # anyway: a traversal-shaped id must not escape the volume.
        safe = "".join(c for c in session_id if c.isalnum() or c in "-_")
        return f"{safe}.jsonl"

    def _blob_key(self, name: str) -> str:
        return f"{self.BLOBS_DIR}/{name}"

    # -- writing --------------------------------------------------------

    def append(self, op: dict) -> None:
        """Append one op line to its session's stream (atomic-enough
        single write; readers tolerate interleaves)."""
        line = json.dumps(op) + "\n"
        self.store.append(self._stream_key(op["session_id"]),
                          line.encode("utf-8"))

    def put_blob(self, name: str, data: bytes) -> str:
        """Store one stack blob by content bytes (atomic whole-object
        write); returns the blob name."""
        self.store.put(self._blob_key(name), data)
        return name

    def mirror(self, op: dict, store: "JournalStore") -> None:
        """Sink entry point, called by ``store``'s writer thread per
        session-scoped WAL op. Blob copy FIRST (an op must never
        reference a blob that is not there), then the op line. A failing
        shared volume degrades handoff — loudly — never local serving;
        the caller wraps this in the OSError containment."""
        kind = op.get("op")
        out = dict(op)
        if kind == "stop" and op.get("stack"):
            blob = f"{op['session_id']}-{op.get('job_id') or 'stop'}.npy"
            if self.store.size(self._blob_key(blob)) is None:
                with open(os.path.join(store.root, op["stack"]),
                          "rb") as f:
                    self.put_blob(blob, f.read())
            out["blob"] = blob
            out.pop("stack", None)
        if kind == "session_end":
            if op.get("scope") == "local":
                # A handed-off tombstone: the stream now belongs to the
                # adopting replica — leave it alone.
                return
            ender = op.get("replica")
            owner = self.owner(op["session_id"])
            if ender is not None and owner is not None \
                    and ender != owner:
                # A NON-OWNER's end (e.g. the origin replica's idle-TTL
                # expiry of its stale double-hosted copy after a
                # handoff): the stream belongs to the adopter — nuking
                # it would lose the adopter's acked stops at its next
                # recovery.
                log.info("ignoring session_end from non-owner %s for "
                         "%s (owner %s)", ender, op["session_id"],
                         owner)
                return
            self.end_session(op["session_id"],
                             reason=op.get("reason", "ended"))
            return
        self.append(out)

    def end_session(self, session_id: str,
                    reason: str = "ended") -> None:
        """The session ended fleet-wide (finalized/deleted/expired/
        evicted): free its blobs and rewrite the stream to ONE
        tombstone line. The tombstone is POSITIVE evidence of the end —
        recovery must distinguish "ended somewhere" (tombstone) from
        "the mirror never wrote" (missing stream), because the latter
        means the local WAL is the only copy and must recover.

        Tombstone FIRST, blob unlinks after: a concurrent reader (the
        router's adoption sweep) must see either the fully-live stream
        or the tombstone — never a live head whose blobs are already
        gone, which an adopter would dutifully "adopt" as an all-
        degraded empty session."""
        info = self._read(session_id, include_failed=True)
        line = json.dumps({"op": "session_end",
                           "session_id": session_id,
                           "reason": reason,
                           "t_wall": time.time()}) + "\n"
        self.store.replace(self._stream_key(session_id),
                           line.encode("utf-8"))
        if info is not None:
            for _, blob in info.stops:
                try:
                    self.store.delete(self._blob_key(blob))
                except OSError:
                    log.debug("handoff blob %s already gone", blob)

    def drop_session(self, session_id: str) -> None:
        """Hard-remove a stream file (the origin replica calls this
        after consuming an end tombstone at recovery, bounding
        tombstone accumulation on long-lived volumes)."""
        try:
            self.store.delete(self._stream_key(session_id))
        except OSError:
            log.debug("handoff stream %s already gone", session_id)

    # -- reading --------------------------------------------------------

    def _scan(self, session_id: str, include_failed: bool = False
              ) -> tuple[bool, "RecoveredSession | None"]:
        """(ended, info) for one stream; info is None when the file is
        missing, unreadable or headless. ``ended`` True = an end
        tombstone is present (positive evidence the session finished
        SOMEWHERE in the fleet)."""
        head = None
        owner = None
        ended = False
        stops: "OrderedDict[str, str]" = OrderedDict()
        anon: list[tuple[None, str]] = []
        failed: set[str] = set()
        try:
            data = self.store.get(self._stream_key(session_id))
        except OSError as e:
            log.warning("handoff stream %s unreadable: %s", session_id, e)
            return False, None
        if data is None:
            return False, None
        for raw in data.splitlines():
            line = raw.strip()
            if not line:
                continue
            try:
                op = json.loads(line)
            except ValueError:
                continue  # torn/interleaved line: skip, keep reading
            kind = op.get("op")
            if kind == "session":
                head = op                      # last head wins
                owner = op.get("replica", owner)
            elif kind == "session_owner":
                owner = op.get("replica", owner)
            elif kind == "session_end":
                ended = True
            elif kind == "stop" and op.get("blob"):
                jid = op.get("job_id")
                if jid is None:
                    anon.append((None, op["blob"]))
                elif jid not in stops:         # dedup: first wins
                    stops[jid] = op["blob"]
            elif kind == "stop_failed" and op.get("job_id"):
                failed.add(op["job_id"])
        if head is None:
            return ended, None
        pairs = [(jid, blob) for jid, blob in stops.items()
                 if include_failed or jid not in failed] + anon
        return ended, RecoveredSession(
            session_id=session_id,
            scan_id=head.get("scan_id", session_id),
            options=dict(head.get("options") or {}),
            replica=owner, stops=pairs)

    def _read(self, session_id: str,
              include_failed: bool = False) -> RecoveredSession | None:
        ended, info = self._scan(session_id, include_failed)
        return None if ended else info

    def stream_state(self, session_id: str) -> str:
        """``"live"`` (adoptable stream), ``"ended"`` (tombstoned — the
        session finished somewhere in the fleet), or ``"missing"`` (no
        stream: never mirrored, or the mirror failed — the caller's
        local WAL may be the ONLY copy)."""
        ended, info = self._scan(session_id, include_failed=True)
        if ended:
            return "ended"
        return "live" if info is not None else "missing"

    def read_session(self, session_id: str) -> RecoveredSession | None:
        """The session's replayable state: head options/scan id, current
        owner, and (job_id, blob) stop pairs with service-side-failed
        stops excluded — replay must skip exactly what the live session
        never fused."""
        return self._read(session_id, include_failed=False)

    def owner(self, session_id: str) -> str | None:
        """Current owner replica id, or None when the stream is
        missing/ended or carries no replica stamps."""
        info = self._read(session_id, include_failed=True)
        return info.replica if info is not None else None

    def has_session(self, session_id: str) -> bool:
        """True while a LIVE (adoptable, un-ended) stream exists."""
        return self.stream_state(session_id) == "live"

    def load_blob(self, name: str) -> np.ndarray:
        data = self.store.get(self._blob_key(name))
        if data is None:
            raise FileNotFoundError(f"handoff blob {name} missing")
        return np.load(io.BytesIO(data), allow_pickle=False)

    def list_sessions(self) -> list[str]:
        """Session ids with LIVE streams (end tombstones excluded) —
        the fleet-level "journal clean?" probe."""
        try:
            names = self.store.list("")
        except OSError:
            return []
        out = []
        for n in names:
            if "/" in n or not n.endswith(".jsonl"):
                continue
            sid = n[:-6]
            if self.stream_state(sid) == "live":
                out.append(sid)
        return out

    def stats(self) -> dict:
        # Parse-free on purpose: this rides every /healthz scrape, and
        # the shared volume may be remote (NFS or an object service).
        # ``streams`` counts stream OBJECTS — live sessions plus
        # not-yet-consumed end tombstones; the exact live set is
        # ``list_sessions()``, which parses every stream and belongs in
        # probes, not health scrapes.
        try:
            names = self.store.list("")
        except OSError:
            names = []
        streams = sum(1 for n in names
                      if "/" not in n and n.endswith(".jsonl"))
        blobs = sum(1 for n in names
                    if n.startswith(f"{self.BLOBS_DIR}/")
                    and ".tmp" not in n)   # temp suffix is .tmp-<pid>
        return {"root": self.root, "streams": streams, "blobs": blobs,
                "mirror_failures": self.mirror_failures,
                "backend": self.store.stats().get("backend")}


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------


class JournalStore:
    """Write-ahead journal + stack-blob store over one directory.

    ``sink`` (fleet tier): a :class:`SessionStreamStore` that receives
    every session-scoped op from the writer thread as part of the group
    commit — the journal *streams* session state to the shared volume so
    a survivor replica can adopt a dead replica's live sessions."""

    def __init__(self, root: str, fsync_interval_s: float = 0.25,
                 compact_min_dead: int = 256,
                 compact_on_open: bool = True,
                 sink: "SessionStreamStore | None" = None):
        self.root = root
        self.sink = sink
        self.fsync_interval_s = float(fsync_interval_s)
        self.compact_min_dead = int(compact_min_dead)
        os.makedirs(os.path.join(root, STACKS_DIR), exist_ok=True)
        os.makedirs(os.path.join(root, CONTENT_DIR), exist_ok=True)
        self._path = os.path.join(root, JOURNAL_NAME)
        # Live mirror (writer-thread-owned after start; seeded here from
        # whatever a previous process left behind).
        state = _parse_journal(self._path)
        self._jobs: dict[str, dict] = {}
        self._sessions: dict[str, dict] = {}
        self._early_done: set[str] = set()
        self._early_failed_stops: set[str] = set()
        self._purge: list[str] = []  # blob relpaths freed by dead ops
        self._sync_timeouts = 0
        self._write_failures = 0
        self._seed_mirror(state)
        self._recovered = state
        self._dead_ops = 0
        self._compactions = 0
        self._last_fsync = time.monotonic()
        # Group-commit plumbing: callers enqueue serialized lines under
        # the condition, the writer thread swaps the batch out and does
        # ALL file I/O lock-free (no caller-visible lock spans I/O).
        self._cond = threading.Condition()
        self._batch: list[tuple[str, dict]] = []
        self._commit_ev = threading.Event()
        self._closing = False
        self._closed = False
        self._f = open(self._path, "a", encoding="utf-8")
        self._writer = threading.Thread(target=self._run,
                                        name="journal-writer", daemon=True)
        self._writer.start()
        if compact_on_open and (state.ops > len(self._live_ops())
                                or state.corrupt_lines):
            self._request_compact()

    # -- mirror ------------------------------------------------------------

    def _seed_mirror(self, state: RecoveredState) -> None:
        for j in state.jobs:
            self._jobs[j.job_id] = {
                "op": "job", "job_id": j.job_id, "stack": j.stack_path,
                "result_format": j.result_format, "priority": j.priority,
                "deadline_s": j.deadline_s, "t_wall": j.submitted_wall,
                "content_key": j.content_key}
        for s in state.sessions:
            # Carry replica + stop job_ids through compaction: the
            # rewritten journal must preserve the ownership stamp (the
            # handoff-aware recovery compares it against the stream's
            # owner) and the ids stop_failed ops match against.
            self._sessions[s.session_id] = {
                "head": {"op": "session", "session_id": s.session_id,
                         "scan_id": s.scan_id, "options": s.options,
                         "replica": s.replica},
                "stops": [{"op": "stop", "session_id": s.session_id,
                           "job_id": jid, "stack": p}
                          for jid, p in s.stops]}

    def _live_ops(self) -> list[dict]:
        out = list(self._jobs.values())
        for s in self._sessions.values():
            out.append(s["head"])
            out.extend(s["stops"])
        return out

    def _apply(self, op: dict) -> None:
        """Writer-thread mirror update; terminal/end ops mark their blob
        paths dead for the next compaction."""
        kind = op.get("op")
        if kind == "job":
            if op["job_id"] in self._early_done:
                # Terminal transition journaled BEFORE the admission op
                # (a worker can outrun the submitter's append): dead on
                # arrival, never live in the mirror.
                self._early_done.discard(op["job_id"])
                self._dead_ops += 2
            else:
                self._jobs[op["job_id"]] = op
        elif kind == "job_done":
            prior = self._jobs.pop(op["job_id"], None)
            if prior is None:
                self._early_done.add(op["job_id"])
            elif prior.get("stack"):
                # Free the blob the moment its terminal op commits — at
                # 1080p every retained stack is ~95 MB, and waiting for
                # compaction would let a busy service pin GBs of dead
                # inputs on the journal volume.
                self._purge.append(prior["stack"])
            self._dead_ops += 1 + (1 if prior else 0)
        elif kind == "session":
            self._sessions[op["session_id"]] = {"head": op, "stops": []}
        elif kind == "stop":
            if op.get("job_id") in self._early_failed_stops:
                # Failure op outran the admission append: dead on
                # arrival (mirrors the job _early_done handling).
                self._early_failed_stops.discard(op["job_id"])
                self._dead_ops += 2
                if op.get("stack"):
                    self._purge.append(op["stack"])
            else:
                sess = self._sessions.get(op["session_id"])
                if sess is not None:
                    sess["stops"].append(op)
        elif kind == "stop_failed":
            sess = self._sessions.get(op.get("session_id"))
            matched = None
            if sess is not None and op.get("job_id"):
                for s in sess["stops"]:
                    if s.get("job_id") == op["job_id"]:
                        matched = s
                        break
            if matched is not None:
                sess["stops"].remove(matched)
                self._dead_ops += 2
                if matched.get("stack"):
                    self._purge.append(matched["stack"])
            elif op.get("job_id"):
                self._early_failed_stops.add(op["job_id"])
                self._dead_ops += 1
        elif kind == "session_end":
            prior = self._sessions.pop(op["session_id"], None)
            self._dead_ops += 1
            if prior:
                self._dead_ops += 1 + len(prior["stops"])
                self._purge.extend(s["stack"] for s in prior["stops"]
                                   if s.get("stack"))
        else:
            self._dead_ops += 1  # notes are never live

    # -- appending ---------------------------------------------------------

    def append(self, op: dict, sync: bool = True) -> None:
        """Append one op. ``sync=True`` blocks until the op's batch is
        written + flushed (the durability promise an HTTP 200 rides on);
        ``sync=False`` is fire-and-forget for low-stakes ops (terminal
        transitions, notes) that recovery treats as advisory."""
        op = dict(op)
        op.setdefault("t_wall", time.time())
        line = json.dumps(op)
        with self._cond:
            if self._closed or self._closing:
                log.debug("journal append after close dropped: %s",
                          op.get("op"))
                return
            self._batch.append((line, op))
            ev = self._commit_ev
            self._cond.notify()
        if sync and not ev.wait(timeout=10.0):
            # The caller proceeds (an overloaded volume must not wedge
            # the serving path), but the durability promise is broken
            # for this op — say so loudly and count it, so "acked but
            # lost after crash" is diagnosable instead of silent.
            with self._cond:
                self._sync_timeouts += 1
            log.error("journal sync append timed out after 10s "
                      "(op=%s) — volume stalled; this op may not "
                      "survive a crash", op.get("op"))

    def note(self, kind: str, sync: bool = False, **fields) -> None:
        """Journal an advisory marker (worker restarts, drains) — dropped
        at compaction, but present in the raw log for post-mortems."""
        self.append({"op": "note", "kind": kind, **fields}, sync=sync)

    # -- stack blobs -------------------------------------------------------

    def put_stack(self, name: str, stack: np.ndarray) -> str:
        """Persist one capture stack; returns the journal-relative path.
        tmp + rename so a torn write can never be mistaken for a blob."""
        rel = os.path.join(STACKS_DIR, f"{name}.npy")
        path = os.path.join(self.root, rel)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, stack)
        os.replace(tmp, path)
        return rel

    def load_stack(self, rel: str) -> np.ndarray:
        with open(os.path.join(self.root, rel), "rb") as f:
            return np.load(io.BytesIO(f.read()), allow_pickle=False)

    @property
    def content_dir(self) -> str:
        return os.path.join(self.root, CONTENT_DIR)

    # -- recovery ----------------------------------------------------------

    def recover(self) -> RecoveredState:
        """The live set as parsed at open() — what a fresh service must
        re-queue/replay. (Re-parse with :func:`_parse_journal` for the
        current on-disk state of a FOREIGN store, e.g. post-drain
        journal-clean assertions.)"""
        return self._recovered

    # -- writer thread -----------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._batch and not self._closing:
                    self._cond.wait(0.5)
                batch, self._batch = self._batch, []
                ev, self._commit_ev = self._commit_ev, threading.Event()
                closing = self._closing and not batch
            if batch:
                try:
                    for line, _ in batch:
                        self._f.write(line + "\n")
                    self._f.flush()
                    now = time.monotonic()
                    if now - self._last_fsync >= self.fsync_interval_s:
                        os.fsync(self._f.fileno())
                        self._last_fsync = now
                except OSError as e:
                    # A full/broken volume must degrade durability, not
                    # take the serving path down with it — but LOUDLY:
                    # the commit event below still fires (callers must
                    # not wedge), so the flight journal + the stats
                    # counter are the only record that acked ops are not
                    # actually on disk.
                    with self._cond:
                        self._write_failures += 1
                    log.error("journal write failed: %s", e)
                    events.record("journal_write_failed",
                                  severity="error", message=str(e),
                                  ops=len(batch))
                if self.sink is not None:
                    # Handoff mirroring is part of the group commit: an
                    # acked session op is on the shared volume before
                    # the commit event fires. A failing shared volume
                    # degrades HANDOFF (survivors adopt a shorter
                    # stream), never local serving — loudly.
                    for _, op in batch:
                        if op.get("op") not in SESSION_STREAM_OPS:
                            continue
                        try:
                            self.sink.mirror(op, self)
                        except OSError as e:
                            self.sink.mirror_failures += 1
                            log.error("handoff mirror failed: %s", e)
                            events.record(
                                "handoff_mirror_failed",
                                severity="error", message=str(e),
                                session_id=op.get("session_id"))
                with self._cond:  # mirror updates visible to stats()
                    for _, op in batch:
                        self._apply(op)
                    compact_due = self._dead_ops >= self.compact_min_dead
                    purge, self._purge = self._purge, []
                ev.set()
                for rel in purge:  # blob deletes outside the lock
                    try:
                        os.remove(os.path.join(self.root, rel))
                    except OSError:
                        pass
                if compact_due:
                    self._compact()
                continue
            if closing:
                try:
                    self._f.flush()
                    os.fsync(self._f.fileno())
                except OSError:
                    pass
                self._f.close()
                ev.set()  # release any racer that grabbed this event
                return

    def _request_compact(self) -> None:
        # Make the open-time compaction ride the writer thread like every
        # other journal mutation: a no-op note trips the dead-op check.
        with self._cond:
            self._dead_ops = max(self._dead_ops, self.compact_min_dead)
            self._batch.append((json.dumps(
                {"op": "note", "kind": "open_compact",
                 "t_wall": time.time()}), {"op": "note"}))
            self._cond.notify()

    def _compact(self) -> None:
        """Rewrite the journal from the live mirror (writer thread only:
        it owns the file handle and the mirror)."""
        tmp = self._path + ".tmp"
        with self._cond:
            live = self._live_ops()
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                for op in live:
                    f.write(json.dumps(op) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self._path)
            self._f = open(self._path, "a", encoding="utf-8")
        except OSError as e:
            log.error("journal compaction failed: %s", e)
            if self._f.closed:  # keep appending SOMEWHERE
                self._f = open(self._path, "a", encoding="utf-8")
            return
        # Blob hygiene: anything on disk no live op references (dead
        # jobs/sessions, orphans from crashes between put_stack and
        # append) is deleted.
        referenced = {op["stack"] for op in live if op.get("stack")}
        stacks_dir = os.path.join(self.root, STACKS_DIR)
        for fname in os.listdir(stacks_dir):
            rel = os.path.join(STACKS_DIR, fname)
            if rel not in referenced:
                try:
                    os.remove(os.path.join(stacks_dir, fname))
                except OSError:
                    pass
        with self._cond:
            dead = self._dead_ops
            self._dead_ops = 0
            self._compactions += 1
        log.info("journal compacted: %d live ops kept, %d dead dropped",
                 len(live), dead)

    # -- lifecycle / inspection --------------------------------------------

    def close(self) -> None:
        """Flush every acked op and stop the writer. Idempotent; appends
        after close are dropped (a crashing service may race its own
        teardown)."""
        with self._cond:
            if self._closed:
                return
            self._closing = True
            self._cond.notify_all()
        self._writer.join(timeout=10.0)
        with self._cond:
            self._closed = True

    def stats(self) -> dict:
        with self._cond:
            live_jobs = len(self._jobs)
            live_sessions = len(self._sessions)
            dead = self._dead_ops
        try:
            journal_bytes = os.path.getsize(self._path)
        except OSError:
            journal_bytes = 0
        return {
            "root": self.root,
            "live_jobs": live_jobs,
            "live_sessions": live_sessions,
            "dead_ops": dead,
            "journal_bytes": journal_bytes,
            "compactions": self._compactions,
            "sync_timeouts": self._sync_timeouts,
            "write_failures": self._write_failures,
        }


def read_live_state(root: str) -> RecoveredState:
    """Parse a journal volume WITHOUT opening a store (no writer thread,
    no compaction): the post-drain "journal clean?" probe used by the
    soak bench and the durability tests."""
    return _parse_journal(os.path.join(root, JOURNAL_NAME))
