"""Thin fleet front router: consistent-hash admission, sticky sessions
(counterpart of the JAX package's ``serve/router.py``).

One :class:`FleetRouter` in front of N replicas (each a normal
`cli serve` process) turns "a durable replica" into "a fleet that loses
a node and doesn't care":

* **health-driven membership** — a background thread polls every
  replica's ``/readyz`` (the replica's readiness contract) on a short bounded
  timeout; a 503 or a dead socket removes the replica from the routing
  ring until it answers ready again. No replica-side cooperation beyond
  the endpoint that already exists.
* **consistent-hash admission** — ``POST /submit`` is placed by the
  SHA-256 of the request body over a :class:`~.fleet.HashRing`, so
  duplicate submits land on the replica that already holds the artifact
  (a local content-cache hit). When that replica dies, only its arc of
  keys remaps — and the peer half of the shared cache
  (serve/fleet.py) covers the remapped duplicates.
* **replica-sticky sessions with handoff** — ``POST /session`` pins the
  new session to a ready replica; every later op routes to the pin.
  When the pinned replica dies mid-session, the router walks the ring's
  survivors and asks one to **adopt** the session from the shared
  handoff stream (``POST /session/<id>/adopt``,
  `ReconstructionService.adopt_session`), re-pins, and forwards the op
  — the client sees one slower stop, not a dead scan.
* **transparent proxying** — everything else (``/status``, ``/result``,
  previews, metrics aggregation's per-replica scrape) forwards to the
  owning replica; job→replica placements are remembered (bounded) so
  polling follows the job wherever admission put it.
* **router HA** — 2+ routers share the session-pin map through a
  :class:`~.blobstore.BlobStore` (:class:`PinBoard`: one
  generation-stamped record per session, last-writer-wins, ties broken
  by router id) and probe each other (``router_peers``): a client may
  hit any router, a freshly restarted router RE-LEARNS its pins from
  the board instead of probing the fleet (and therefore never steals a
  live session), and concurrent routers converge on one owner because
  every adoption consults the board for a fresher pin first.
* **proactive re-pin** — a readyz-miss failure detector with hysteresis
  (consecutive misses → suspect → dead; consecutive hits to come back)
  triggers ``adopt_session`` on ring survivors in the BACKGROUND the
  moment a replica is declared dead, so failover is pre-completed work
  instead of the next client op's latency spike
  (``fleet_proactive_repin_s`` in the fleet chaos run). Among live peered routers, the lowest
  router id is the detector primary — the rest stand by (adoption is
  idempotent and board-converged, so an election race is benign, just
  wasteful).

The router holds NO reconstruction state and never touches a device:
killing it loses only routing memory not yet on the pin board (job pins
are re-learned by probing replicas), which is why thin processes are
enough in front of the fleet. (Importing it still pulls the serve
package — and with it torch — so it runs from the same install as a
replica; it never touches a card.) Its listener keeps the replica's
128-deep accept backlog (``service._Listener``): the router multiplies
connections, and at the stdlib's 5 a dropped SYN costs a client a TCP
retransmit of seconds.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qs, urlparse

from ..utils import events, trace
from ..utils.log import get_logger
from .blobstore import BlobStore, open_blob_store
from .fleet import HashRing, PeerTransport
from .service import MAX_SUBMIT_BYTES, _Listener

log = get_logger(__name__)

#: Request headers the router forwards to replicas verbatim.
_FORWARD_HEADERS = ("X-Result-Format", "X-Priority", "X-Deadline-S",
                    "X-Tenant", "Content-Type")

#: Failure-detector states (readyz-miss hysteresis).
ALIVE, SUSPECT, DEAD = "alive", "suspect", "dead"


class PinBoard:
    """Session-pin records shared by a router set through a blob store.

    One object per session (``router/pins/<sid>.json``) carrying
    ``{url, gen, router}``. Records are totally ordered by
    ``(gen, router)`` — writers stamp ``gen = known + 1``, the highest
    order wins, and an equal-generation double-write tie-breaks on
    router id — so every reader converges on ONE owner without
    coordination: :meth:`write` refuses to clobber a higher-ranked
    record, readers only adopt records that outrank their local
    knowledge, and the owning router's periodic sync re-asserts a
    record a racing replace landed over. Store failures are contained
    here: a sick board degrades pin SHARING (each router falls back to
    its local memory), never routing."""

    PREFIX = "router/pins/"
    JOB_PREFIX = "router/jobs/"

    def __init__(self, store: BlobStore, router_id: str):
        self.store = store
        self.router_id = router_id
        self.write_failures = 0

    def _key(self, session_id: str) -> str:
        safe = "".join(c for c in session_id
                       if c.isalnum() or c in "-_")
        return f"{self.PREFIX}{safe}.json"

    def _job_key(self, job_id: str) -> str:
        safe = "".join(c for c in job_id if c.isalnum() or c in "-_")
        return f"{self.JOB_PREFIX}{safe}.json"

    # -- job pins -------------------------------------------------------
    #
    # Jobs never MOVE (a job lives and dies on the replica that admitted
    # it), so job records need none of the session records' generation
    # machinery: last-writer-wins trivially because every writer writes
    # the same placement. Sharing them is what lets a freshly restarted
    # (or peer) router answer /status//result without probing the whole
    # fleet — the ROADMAP open item. Records carry t_wall so the board
    # sync can prune ones past their useful life (results are bounded
    # registry entries replica-side anyway).

    def write_job(self, job_id: str, url: str) -> None:
        try:
            rec = json.dumps({"url": url, "router": self.router_id,
                              "t_wall": time.time()}).encode()
            self.store.replace(self._job_key(job_id), rec)
        except OSError as e:
            self.write_failures += 1
            log.warning("pin-board job write for %s failed: %s",
                        job_id, e)

    def read_job(self, job_id: str) -> str | None:
        try:
            data = self.store.get(self._job_key(job_id))
        except OSError:
            return None
        if data is None:
            return None
        try:
            return str(json.loads(data.decode())["url"])
        except (ValueError, KeyError, UnicodeDecodeError):
            return None  # torn record: ignore

    def prune_jobs(self, ttl_s: float, max_records: int = 512) -> int:
        """Drop job records older than ``ttl_s`` (board hygiene — the
        replicas' bounded registries stopped answering for them long
        ago). At most ``max_records`` are READ per sweep: each check
        is a store GET, and this runs on the board-sync thread next to
        session-pin reconciliation — an unbounded sweep over a
        sustained-submit backlog would stall that thread for minutes
        against a slow store (pruning is eventually-consistent by
        design). Returns records dropped; store failures degrade
        pruning only."""
        dropped = 0
        try:
            keys = self.store.list(self.JOB_PREFIX)
        except OSError:
            return 0
        cutoff = time.time() - ttl_s
        for key in keys[:max(1, int(max_records))]:
            if not key.endswith(".json"):
                continue
            try:
                data = self.store.get(key)
                doc = json.loads(data.decode()) if data is not None \
                    else None
            except (OSError, ValueError, UnicodeDecodeError):
                continue
            if doc is None or float(doc.get("t_wall", 0.0)) >= cutoff:
                continue
            try:
                self.store.delete(key)
                dropped += 1
            except OSError:
                continue
        return dropped

    def write(self, session_id: str, url: str, gen: int) -> None:
        """Publish a pin UNLESS the board already holds a higher-ranked
        record ((gen, router) lexicographic — the tie-break that makes
        two routers stamping the same generation deterministic). The
        read-compare-write is not a CAS; a racing replace can still
        land the lower-ranked record last, which the owning router's
        periodic board sync detects and re-asserts."""
        try:
            cur = self.read(session_id)
            if cur is not None \
                    and (cur[1], cur[2]) > (int(gen), self.router_id):
                return
            rec = json.dumps({"url": url, "gen": int(gen),
                              "router": self.router_id,
                              "t_wall": time.time()}).encode()
            self.store.replace(self._key(session_id), rec)
        except OSError as e:
            self.write_failures += 1
            log.warning("pin-board write for %s failed: %s",
                        session_id, e)

    def clear(self, session_id: str) -> None:
        try:
            self.store.delete(self._key(session_id))
        except OSError as e:
            self.write_failures += 1
            log.warning("pin-board clear for %s failed: %s",
                        session_id, e)

    @staticmethod
    def _parse(data: bytes) -> tuple[str, int, str] | None:
        try:
            doc = json.loads(data.decode())
            return str(doc["url"]), int(doc.get("gen", 0)), \
                str(doc.get("router", ""))
        except (ValueError, KeyError, UnicodeDecodeError):
            return None  # torn record (FaultyBlobStore): ignore

    def read(self, session_id: str) -> tuple[str, int, str] | None:
        """(url, gen, router) or None — missing, unreadable or torn."""
        try:
            data = self.store.get(self._key(session_id))
        except OSError:
            return None
        return self._parse(data) if data is not None else None

    def load(self) -> dict:
        """{session_id: (url, gen, router)} — the router-restart
        re-learn path."""
        out: dict = {}
        try:
            keys = self.store.list(self.PREFIX)
        except OSError as e:
            log.warning("pin-board load failed: %s", e)
            return out
        for key in keys:
            if not key.endswith(".json"):
                continue
            try:
                data = self.store.get(key)
            except OSError:
                continue
            rec = self._parse(data) if data is not None else None
            if rec is not None:
                out[key[len(self.PREFIX):-5]] = rec
        return out


class FleetRouter:
    """Routing brain (transport-agnostic; the HTTP server is below)."""

    def __init__(self, replicas, check_interval_s: float = 1.0,
                 health_timeout_s: float = 2.0,
                 forward_timeout_s: float = 600.0,
                 transport: PeerTransport | None = None,
                 registry: "trace.MetricsRegistry | None" = None,
                 max_job_pins: int = 65536,
                 router_id: str | None = None,
                 pin_store: "BlobStore | str | None" = None,
                 router_peers=(),
                 proactive_repin: bool = True,
                 suspect_misses: int = 2, dead_misses: int = 3,
                 recover_hits: int = 2,
                 signals_interval_s: float = 5.0):
        urls = [u.rstrip("/") for u in replicas]
        if not urls:
            raise ValueError("a router needs at least one replica URL")
        self.replicas = urls
        self.check_interval_s = float(check_interval_s)
        self.health_timeout_s = float(health_timeout_s)
        self.forward_timeout_s = float(forward_timeout_s)
        self.transport = transport if transport is not None \
            else PeerTransport()
        self.registry = registry if registry is not None \
            else trace.MetricsRegistry()
        self.ring = HashRing(urls)
        self.router_id = router_id or f"router-{uuid.uuid4().hex[:8]}"
        self.router_peers = [u.rstrip("/") for u in router_peers]
        if isinstance(pin_store, str):
            pin_store = open_blob_store(pin_store)
        self.pin_board: PinBoard | None = (
            PinBoard(pin_store, self.router_id)
            if pin_store is not None else None)
        self.proactive_repin = bool(proactive_repin)
        self.suspect_misses = max(1, int(suspect_misses))
        self.dead_misses = max(self.suspect_misses, int(dead_misses))
        self.recover_hits = max(1, int(recover_hits))
        # Signal snapshots are a SLOWER cadence than readiness probes:
        # scraping every replica's full /healthz stats at the sweep
        # rate would tax the fleet for data an autoscaler reads every
        # few seconds at most.
        self.signals_interval_s = float(signals_interval_s)
        self._signals_last = -float("inf")
        # Board reconciliation cadence: a load() is list + one store
        # GET per pinned session, so it runs at its own (slower)
        # interval rather than per sweep — pin freshness between
        # routers only needs to beat human/autoscaler reaction time,
        # and the write-through path keeps the board itself current.
        self.board_sync_interval_s = max(float(check_interval_s), 2.0)
        # Job-pin board hygiene: records past this age are pruned by
        # the board-sync thread (replica registries are bounded — a
        # stale pin would just proxy to a 404 anyway). Pruning is a
        # list+read sweep, so it runs far below the sync cadence.
        self.job_pin_ttl_s = 3600.0
        self._job_prune_interval_s = 600.0
        self._job_prune_last = time.monotonic()
        # Job-pin write BACKLOG: pin_job runs on the per-request
        # handler thread, and a slow/hung pin store must never stall
        # the hot submit path (the same hazard the board-sync thread
        # already absorbs for session pins' reconciliation). Writes
        # drain on that thread at its cadence; bounded — overflow
        # drops the OLDEST pins, which merely fall back to the
        # probe-the-fleet path after a router death.
        self._job_pin_backlog: OrderedDict[str, str] = OrderedDict()
        self._max_job_pin_backlog = 4096
        self._lock = threading.Lock()
        self._ready: dict[str, bool] = {u: False for u in urls}
        self._reasons: dict[str, str] = {}
        self._jobs: OrderedDict[str, str] = OrderedDict()  # job -> url
        self._max_job_pins = int(max_job_pins)
        # sid -> (url, generation, writer router id): records are
        # totally ordered by (gen, router) — the order the pin board
        # shares, so concurrent routers converge on ONE owner.
        self._sessions: dict[str, tuple[str, int, str]] = {}
        # Failure detector (readyz-miss hysteresis, per replica).
        self._det_state: dict[str, str] = {u: ALIVE for u in urls}
        self._det_misses: dict[str, int] = {u: 0 for u in urls}
        self._det_hits: dict[str, int] = {u: 0 for u in urls}
        self._repin_inflight: set[str] = set()
        # Peer routers (readyz-driven peering): url -> router_id | None.
        self._peer_ids: dict[str, str | None] = {
            u: None for u in self.router_peers}
        # Per-replica signal snapshots scraped by the sweep (the
        # /fleet/signals + corrupt-aggregation source — request handlers
        # never fan out to replicas themselves).
        self._replica_stats: dict[str, dict] = {}
        self._rr = 0
        # Smooth-weighted round-robin credit per replica (session
        # creation spread): with equal weights it degenerates to plain
        # round-robin; a degraded replica (dead chips, deep queue)
        # accrues credit slower and is picked proportionally less.
        self._wrr_credit: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._board_thread: threading.Thread | None = None
        self._requests = lambda route: self.registry.counter(
            "router_requests_total", "requests by route", route=route)
        self._failovers = self.registry.counter(
            "router_failovers_total",
            "submits re-placed after the hash owner failed")
        self._repins = self.registry.counter(
            "router_session_repins_total",
            "sessions handed off to a survivor after their pinned "
            "replica died")
        self._proactive = self.registry.counter(
            "router_proactive_repins_total",
            "sessions adopted in the background by the failure "
            "detector, before any client op needed them")
        self._unroutable = self.registry.counter(
            "router_unroutable_total",
            "requests refused with no ready replica")
        self._ready_gauge = self.registry.gauge(
            "router_ready_replicas", "replicas currently routable")
        if self.pin_board is not None:
            # Router-restart re-learn: adopt the board's pins as-is.
            # Believing the board (instead of probing/adopting) is what
            # keeps a restarted router from stealing a session that is
            # alive and well on its pinned replica.
            for sid, rec in self.pin_board.load().items():
                self._sessions[sid] = rec

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "FleetRouter":
        self._sweep()  # synchronous first sweep: route from request one
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch,
                                        name="router-health", daemon=True)
        self._thread.start()
        if self.pin_board is not None:
            # Board reconciliation runs on its OWN thread: pin-store
            # I/O (possibly a slow remote object service) must never
            # delay the readiness probes above.
            self._board_thread = threading.Thread(
                target=self._board_watch, name="router-board-sync",
                daemon=True)
            self._board_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in (self._thread, self._board_thread):
            if t is not None:
                t.join(timeout=5.0)
        self._thread = None
        self._board_thread = None

    def _watch(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            self._sweep()

    def _sweep(self) -> None:
        for url in self.replicas:
            ready, reason = self._probe(url)
            self._set_ready(url, ready, reason)
            self._detect(url, ready)
        self._probe_router_peers()
        self._scrape_signals()
        if self.proactive_repin:
            # Re-kick while any dead replica still has pinned sessions:
            # covers pins that reached the shared board after the dead
            # transition, a standby promoted to primary by its peer's
            # death, and transiently failed adoptions.
            with self._lock:
                dead = [u for u, s in self._det_state.items()
                        if s == DEAD]
            for url in dead:
                self._kick_proactive(url)
        with self._lock:
            self._ready_gauge.set(sum(self._ready.values()))

    # -- failure detector (proactive re-pin) ---------------------------

    def _detect(self, url: str, ready: bool) -> None:
        """Readyz-miss hysteresis: ``suspect_misses`` consecutive misses
        → suspect, ``dead_misses`` → dead (fires the proactive re-pin);
        ``recover_hits`` consecutive hits to come back — a replica
        flapping at the probe cadence never oscillates the detector."""
        dead_now = False
        with self._lock:
            state = self._det_state.get(url, ALIVE)
            if ready:
                self._det_misses[url] = 0
                self._det_hits[url] = self._det_hits.get(url, 0) + 1
                if state != ALIVE \
                        and self._det_hits[url] >= self.recover_hits:
                    self._det_state[url] = ALIVE
                    log.info("detector: replica %s recovered", url)
            else:
                self._det_hits[url] = 0
                misses = self._det_misses.get(url, 0) + 1
                self._det_misses[url] = misses
                if misses >= self.dead_misses and state != DEAD:
                    self._det_state[url] = DEAD
                    dead_now = True
                elif misses >= self.suspect_misses and state == ALIVE:
                    self._det_state[url] = SUSPECT
        if dead_now:
            events.record("router_replica_dead", severity="warning",
                          url=url, misses=self.dead_misses)
            log.warning("detector: replica %s declared dead after %d "
                        "missed probes", url, self.dead_misses)
            if self.proactive_repin:
                self._kick_proactive(url)

    def _dead_pinned_sessions(self, url: str) -> list:
        """Sessions pinned to ``url`` that a proactive sweep should
        move. LOCAL map only — board records arrive via the board-sync
        thread (`_sync_board`), so the health sweep itself never blocks
        on pin-store I/O: a slow or hung board must not stall readiness
        probing for the whole fleet."""
        with self._lock:
            return [sid for sid, rec in self._sessions.items()
                    if rec[0] == url
                    and sid not in self._repin_inflight]

    def _sync_board(self) -> None:
        """One board reconciliation pass (its own thread, never the
        health sweep): pull peer routers' pins into the local map by
        (gen, router) order — a session created through a PEER router
        must be visible to THIS router's failure detector — and
        re-assert any of our OWN records a racing lower-ranked replace
        clobbered on the board. Deletions win: a record absent from the
        board is never resurrected from local memory."""
        self._flush_job_pins()
        board = self.pin_board.load()
        for sid, (url, gen, stamp) in board.items():
            self._merge_pin(sid, url, gen, stamp)
        with self._lock:
            local = dict(self._sessions)
        for sid, (url, gen, stamp) in local.items():
            rec = board.get(sid)
            if rec is not None and stamp == self.router_id \
                    and (rec[1], rec[2]) < (gen, stamp):
                self.pin_board.write(sid, url, gen)
        now = time.monotonic()
        if now - self._job_prune_last >= self._job_prune_interval_s:
            self._job_prune_last = now
            self.pin_board.prune_jobs(self.job_pin_ttl_s)

    def _board_watch(self) -> None:
        while not self._stop.wait(self.board_sync_interval_s):
            try:
                self._sync_board()
            except Exception as e:  # a sick board degrades pin sharing
                log.warning("pin-board sync failed: %s", e)

    def _kick_proactive(self, url: str) -> None:
        """Adopt the dead replica's pinned sessions on ring survivors in
        a background thread — failover becomes pre-completed work. Only
        the detector PRIMARY (lowest router id among live peered
        routers) sweeps; a standby whose primary just died takes over at
        its own next sweep (the sweep re-kicks while a dead replica
        still has pinned sessions), and any election race is benign:
        the replica-side adopt is idempotent and the pin board
        converges last-writer-wins."""
        if not self._is_detector_primary():
            log.debug("detector: standing by (peer router is primary) "
                      "for dead replica %s", url)
            return
        sids = self._dead_pinned_sessions(url)
        if not sids:
            return
        with self._lock:
            self._repin_inflight.update(sids)
        threading.Thread(target=self._proactive_repin_replica,
                         args=(url, sids), name="router-repin",
                         daemon=True).start()

    def _proactive_repin_replica(self, url: str, sids: list) -> None:
        try:
            # The cached detector flag can be stale — and unlike the
            # lazy path (where a client op needs a home NOW), the
            # proactive path has time to be conservative: re-probe
            # fresh, and adopt ONLY from a replica whose socket is
            # dead. A replica that ANSWERS — even a 503 (drain,
            # warmup-after-restart, watchdog lane swap) — is alive and
            # may be hosting (or recovering) these sessions; stealing
            # them would double-host. route_session_ex still covers
            # the alive-but-unready case when a client op actually
            # needs to move.
            ready, reason = self._probe(url)
            self._set_ready(url, ready, reason)
            if ready or not reason.startswith("unreachable"):
                log.info("proactive re-pin of %s aborted: replica "
                         "answered its probe (%s)", url,
                         reason or "ready")
                return
            for sid in sids:
                t0 = time.monotonic()
                with self._lock:
                    still_dead = self._det_state.get(url) == DEAD
                    rec = self._sessions.get(sid)
                    pin = rec[0] if rec is not None else None
                if not still_dead or pin != url:
                    continue
                new, unknown = self._adopt_on_survivor_ex(sid)
                if new is not None:
                    self._proactive.inc()
                    events.record(
                        "session_proactive_repin", severity="warning",
                        session_id=sid, from_url=url, to_url=new,
                        seconds=round(time.monotonic() - t0, 3))
                elif unknown:
                    # Definitively ended fleet-wide (every survivor
                    # answered 404, no adoptable stream): drop the pin
                    # so the sweep stops hunting a ghost.
                    self.unpin_session(sid)
        finally:
            with self._lock:
                self._repin_inflight.difference_update(sids)

    def detector_state(self, url: str) -> str:
        with self._lock:
            return self._det_state.get(url, ALIVE)

    # -- router peering -------------------------------------------------

    def _probe_router_peers(self) -> None:
        for peer in self.router_peers:
            rid = None
            try:
                status, _, body = self.transport.get(
                    f"{peer}/healthz", timeout_s=self.health_timeout_s)
                if status == 200:
                    doc = json.loads(body.decode())
                    rid = doc.get("router_id")
                    if rid is None:
                        # A 200 WITHOUT a router id is not a router
                        # (a replica URL listed in --router-peers by
                        # mistake) — it must not participate in the
                        # primary election, where a placeholder id
                        # would outrank every real router and silently
                        # disable proactive failover fleet-wide.
                        log.warning(
                            "router peer %s answered /healthz without "
                            "a router_id (a replica URL in "
                            "--router-peers?); ignoring for election",
                            peer)
            except (OSError, ValueError, UnicodeDecodeError):
                rid = None
            with self._lock:
                self._peer_ids[peer] = rid

    def _is_detector_primary(self) -> bool:
        with self._lock:
            alive = [rid for rid in self._peer_ids.values()
                     if rid is not None]
        return all(self.router_id <= rid for rid in alive)

    # -- replica signal scraping (autoscaler + corrupt aggregation) ----

    #: /healthz keys the sweep snapshots per replica.
    _SIGNAL_KEYS = ("replica_id", "queue_depth", "queue_capacity",
                    "workers_alive", "sessions", "governor",
                    "content_cache", "lanes", "store", "handoff")

    def _scrape_signals(self) -> None:
        now = time.monotonic()
        if now - self._signals_last < self.signals_interval_s:
            return
        self._signals_last = now
        for url in self.ready_replicas():
            try:
                status, _, body = self.transport.get(
                    f"{url}/healthz", timeout_s=self.health_timeout_s)
                if status != 200:
                    continue
                doc = json.loads(body.decode())
            except (OSError, ValueError, UnicodeDecodeError):
                continue
            snap = {k: doc.get(k) for k in self._SIGNAL_KEYS
                    if k in doc}
            snap["t_mono"] = time.monotonic()
            with self._lock:
                self._replica_stats[url] = snap

    def signals(self) -> dict:
        """``GET /fleet/signals``: the aggregate an autoscaler consumes
        — queue pressure, lane/session occupancy, shed + overload state,
        device-memory pressure — computed from the sweep's cached
        per-replica snapshots (a scrape never fans out to the fleet)."""
        with self._lock:
            snaps = {u: dict(s) for u, s in self._replica_stats.items()}
            ready = [u for u in self.replicas if self._ready.get(u)]
        queue_depth = queue_cap = sessions_live = lanes_total = 0
        shed_total = devices_dead = 0
        workers = 0
        mem_frac = 0.0
        overload = 0
        revives_total = span_width_total = 0
        for url in ready:
            s = snaps.get(url)
            if not s:
                continue
            queue_depth += int(s.get("queue_depth") or 0)
            queue_cap += int(s.get("queue_capacity") or 0)
            workers += int(s.get("workers_alive") or 0)
            sess = s.get("sessions") or {}
            sessions_live += int(sess.get("live") or 0)
            lane_stats = s.get("lanes") or {}
            lanes = lane_stats.get("lanes") or []
            dead = lane_stats.get("devices_dead") or []
            # A dead chip's lanes are not capacity: the autoscaler must
            # see the fleet as it runs, not as it was provisioned.
            lanes_total += sum(1 for ln in lanes
                               if ln.get("device") not in dead)
            devices_dead += len(dead)
            revives_total += int(lane_stats.get("revives_total") or 0)
            # Span truth, not just a count: the autoscaler (and the
            # weighted placement above) must see how wide the sharded
            # tier actually runs fleet-wide.
            span_width_total += len(lane_stats.get("span_devices")
                                    or [])
            gov = s.get("governor") or {}
            overload = max(overload, int(gov.get("level") or 0))
            mem_frac = max(mem_frac,
                           float(gov.get("memory_pressure") or 0.0))
            shed_total += sum(
                int(v) for v in (gov.get("shed_total") or {}).values())
        return {
            "router_id": self.router_id,
            "ready_replicas": len(ready),
            "replicas_total": len(self.replicas),
            "queue_depth_total": queue_depth,
            "queue_capacity_total": queue_cap,
            "queue_frac": (round(queue_depth / queue_cap, 4)
                           if queue_cap else 0.0),
            "sessions_live_total": sessions_live,
            "worker_lanes_total": workers,
            "device_lanes_total": lanes_total,
            "devices_dead_total": devices_dead,
            "device_revives_total": revives_total,
            "span_devices_total": span_width_total,
            "overload_level_max": overload,
            "memory_pressure_max": round(mem_frac, 4),
            "shed_total": shed_total,
            "unroutable_total": int(self._unroutable.value),
        }

    def corrupt_blob_summary(self) -> dict:
        """Fleet-wide content-cache corruption view for ``/fleet``:
        quarantined-blob counters summed over ready replicas (blob
        corruption is a VOLUME problem — per-replica counters hide a
        shared sick disk)."""
        with self._lock:
            snaps = {u: dict(s) for u, s in self._replica_stats.items()}
        per = {}
        corrupt = quarantined = 0
        for url, s in snaps.items():
            cc = s.get("content_cache") or {}
            c = int(cc.get("corrupt_quarantined") or 0)
            q = int(cc.get("quarantined_objects") or 0)
            per[url] = {"corrupt_quarantined": c,
                        "quarantined_objects": q}
            corrupt += c
            quarantined += q
        return {"corrupt_quarantined_total": corrupt,
                "quarantined_objects_total": quarantined,
                "per_replica": per}

    def _probe(self, url: str) -> tuple[bool, str]:
        try:
            status, _, body = self.transport.get(
                f"{url}/readyz", timeout_s=self.health_timeout_s)
        except OSError as e:
            return False, f"unreachable ({e})"
        if status == 200:
            return True, ""
        try:
            reasons = json.loads(body.decode()).get("reasons", [])
        except (ValueError, UnicodeDecodeError):
            reasons = []
        return False, "; ".join(reasons) or f"readyz {status}"

    def _set_ready(self, url: str, ready: bool, reason: str = "") -> None:
        with self._lock:
            was = self._ready.get(url)
            self._ready[url] = ready
            self._reasons[url] = reason
        if was is not None and was != ready:
            log.info("replica %s -> %s%s", url,
                     "ready" if ready else "not ready",
                     f" ({reason})" if reason else "")
            events.record("router_replica_health", severity="info"
                          if ready else "warning", url=url, ready=ready,
                          reason=reason)

    # -- membership views ----------------------------------------------

    def ready_replicas(self) -> list[str]:
        with self._lock:
            return [u for u in self.replicas if self._ready.get(u)]

    def _down(self) -> set[str]:
        with self._lock:
            return {u for u in self.replicas if not self._ready.get(u)}

    # -- placement ------------------------------------------------------

    def replica_weight(self, url: str) -> float:
        """Health-aware load weight from the sweep's cached /healthz
        snapshot: the replica's live-device fraction (a 7/8-chip
        replica weighs 0.875 — it IS 7/8ths of a replica) scaled down
        by its queue fill. 1.0 with no snapshot yet (cold start must
        not zero anybody out), floored above 0 so a ready-but-strained
        replica stays reachable rather than starved."""
        with self._lock:
            s = self._replica_stats.get(url)
        if not s:
            return 1.0
        w = 1.0
        lane_stats = s.get("lanes") or {}
        devices = lane_stats.get("devices") or []
        dead = lane_stats.get("devices_dead")
        # Dead-count over the pool's full device list — NOT the
        # "devices_live" field, which counts only health-TRACKED chips
        # (lane devices + convicted span members) and would read a
        # healthy 8-chip/2-lane replica as 2/8 alive.
        if devices and isinstance(dead, list):
            w *= max(0.0, 1.0 - min(1.0, len(dead) / len(devices)))
        try:
            depth = float(s.get("queue_depth") or 0)
            cap = float(s.get("queue_capacity") or 0)
        except (TypeError, ValueError):
            depth = cap = 0.0
        if cap > 0:
            w *= max(0.0, 1.0 - min(1.0, depth / cap))
        return max(w, 0.05)

    def place_submit(self, body: bytes) -> list[str]:
        """Candidate replicas for one submit: the consistent-hash
        preference list, load-weighted. Each candidate keeps its ring
        rank with probability ``weight / max_weight``, decided by a
        DETERMINISTIC per-(key, replica) draw — so duplicates of the
        same bytes still land on the same replica (the content-cache
        affinity contract holds exactly), equal weights reproduce the
        pure ring order bit-for-bit, and a degraded replica sheds a
        proportional slice of its keyspace to the next preference
        instead of all (thundering re-key) or none (7/8 chips, 8/8
        load)."""
        key = hashlib.sha256(body).hexdigest()
        pref = self.ring.preference(key, avoid=self._down())
        if len(pref) < 2:
            return pref
        weights = {u: self.replica_weight(u) for u in pref}
        w_max = max(weights.values())
        if w_max <= 0:
            return pref
        kept, demoted = [], []
        for u in pref:
            # Uniform in [0, 1) from the (key, replica) pair — stable
            # across calls, independent across replicas.
            draw = int(hashlib.sha256(
                f"{key}|{u}".encode()).hexdigest()[:8], 16) / 0x100000000
            (kept if draw < weights[u] / w_max else demoted).append(u)
        return kept + demoted

    def place_session(self, session_id: str) -> list[str]:
        return self.ring.preference(session_id, avoid=self._down())

    def next_replica(self) -> str | None:
        """Session creation spread: smooth weighted round-robin over
        ready replicas. Equal weights (no signals scraped yet) cycle
        exactly like the historical round-robin; a replica reporting
        dead chips or a deep queue (``replica_weight``) is picked
        proportionally less often."""
        ready = self.ready_replicas()
        if not ready:
            return None
        weights = {u: self.replica_weight(u) for u in ready}
        total = sum(weights.values())
        with self._lock:
            credit = self._wrr_credit
            for gone in [u for u in credit if u not in weights]:
                credit.pop(gone)
            for u in ready:
                credit[u] = credit.get(u, 0.0) + weights[u]
            pick = max(ready, key=lambda u: credit[u])
            credit[pick] -= total
            return pick

    # -- pin bookkeeping -------------------------------------------------

    def pin_job(self, job_id: str, url: str) -> None:
        with self._lock:
            self._jobs[job_id] = url
            while len(self._jobs) > self._max_job_pins:
                self._jobs.popitem(last=False)
            if self.pin_board is not None:
                # Enqueue only: the board write is store I/O and this
                # is the per-submit hot path — the board-sync thread
                # drains the backlog (_flush_job_pins). Sharing the
                # placement is what spares a restarted or peer router
                # the probe-the-whole-fleet /status sweep.
                self._job_pin_backlog[job_id] = url
                while len(self._job_pin_backlog) \
                        > self._max_job_pin_backlog:
                    self._job_pin_backlog.popitem(last=False)

    def _flush_job_pins(self) -> int:
        """Drain the job-pin backlog to the board (board-sync thread;
        also called directly by tests). Store failures are counted by
        write_job and the pin simply isn't shared — routing never
        depends on it."""
        with self._lock:
            pending = list(self._job_pin_backlog.items())
            self._job_pin_backlog.clear()
        for job_id, url in pending:
            self.pin_board.write_job(job_id, url)
        return len(pending)

    def job_url(self, job_id: str) -> str | None:
        with self._lock:
            url = self._jobs.get(job_id)
        if url is not None:
            return url
        if self.pin_board is not None:
            # Local miss (router restart, or the job was admitted
            # through a peer): believe the shared board before the
            # caller falls back to probing every ready replica.
            url = self.pin_board.read_job(job_id)
            if url is not None:
                with self._lock:
                    self._jobs[job_id] = url
                    while len(self._jobs) > self._max_job_pins:
                        self._jobs.popitem(last=False)
        return url

    def _merge_pin(self, session_id: str, url: str, gen: int,
                   stamp: str) -> bool:
        """Adopt one pin record into the local map iff it outranks what
        we know ((gen, router) lexicographic — the pin board's total
        order; re-checked INSIDE the lock so a concurrent higher-ranked
        adoption can never be rolled back). True when adopted."""
        with self._lock:
            known = self._sessions.get(session_id)
            if known is not None and (known[1], known[2]) >= (gen, stamp):
                return False
            self._sessions[session_id] = (url, gen, stamp)
            return True

    def pin_session(self, session_id: str, url: str) -> None:
        with self._lock:
            known = self._sessions.get(session_id)
            gen = (known[1] if known is not None else 0) + 1
            self._sessions[session_id] = (url, gen, self.router_id)
        if self.pin_board is not None:
            # Write-through OUTSIDE the lock (board I/O must never
            # stall routing); the board's (gen, router) order keeps
            # concurrent routers convergent.
            self.pin_board.write(session_id, url, gen)

    def session_url(self, session_id: str) -> str | None:
        with self._lock:
            pin = self._sessions.get(session_id)
        if pin is not None:
            return pin[0]
        if self.pin_board is not None:
            # Local miss (pin created through a peer router after our
            # restart re-learn): believe the shared board.
            rec = self.pin_board.read(session_id)
            if rec is not None:
                self._merge_pin(session_id, *rec)
                return rec[0]
        return None

    def _fresher_board_pin(self, session_id: str,
                           avoid: str | None) -> str | None:
        """A pin-board record OUTRANKING our local knowledge, pointing
        at a READY replica that is not ``avoid`` — the peer router
        already moved this session; believe it instead of adopting a
        second time."""
        if self.pin_board is None:
            return None
        rec = self.pin_board.read(session_id)
        if rec is None:
            return None
        url, gen, stamp = rec
        with self._lock:
            ready = self._ready.get(url, False)
        if url == avoid or not ready:
            return None
        if not self._merge_pin(session_id, url, gen, stamp):
            return None
        return url

    def unpin_session(self, session_id: str) -> None:
        with self._lock:
            self._sessions.pop(session_id, None)
        if self.pin_board is not None:
            self.pin_board.clear(session_id)

    # -- forwarding ------------------------------------------------------

    def forward(self, url: str, method: str, path: str,
                body: bytes | None = None, headers: dict | None = None
                ) -> tuple[int, dict, bytes]:
        """One bounded-proxy hop. OSError propagates (connection-level
        death) and flips the replica not-ready immediately — the health
        sweep would notice within a second anyway, but the failing
        request IS the freshest probe we have."""
        try:
            return self.transport.request(
                method, url + path, body=body, headers=headers,
                timeout_s=self.forward_timeout_s)
        except OSError:
            self._set_ready(url, False, "request failed")
            raise

    # -- session handoff --------------------------------------------------

    def adopt_on_survivor(self, session_id: str) -> str | None:
        """Walk the ring's survivors asking each to adopt the session
        from the shared handoff stream; returns the new pin, or None
        when nobody could (no ready replicas, or no handoff volume)."""
        return self._adopt_on_survivor_ex(session_id)[0]

    def _adopt_on_survivor_ex(self, session_id: str
                              ) -> tuple[str | None, bool]:
        """``(new pin, definitively_unknown)``: the second element is
        True only when at least one survivor ANSWERED the adoption and
        every answer was a 404 — no adoptable handoff stream exists
        (the session ended, or never rode a handoff volume), so a
        retry cannot help. Transport failures and busy refusals (503)
        keep it False — those warrant the caller's retryable 503."""
        old = self.session_url(session_id)
        fresher = self._fresher_board_pin(session_id, avoid=old)
        if fresher is not None:
            # A peer router already re-pinned this session (its board
            # record outran our knowledge): converge on ITS owner
            # instead of adopting a second copy.
            return fresher, False
        attempted = 0
        uncertain = 0      # transport failures + non-404 refusals
        for url in self.place_session(session_id):
            if url == old:
                continue
            attempted += 1
            try:
                status, _, body = self.forward(
                    url, "POST", f"/session/{session_id}/adopt")
            except OSError:
                uncertain += 1
                continue
            if status == 200:
                self.pin_session(session_id, url)
                self._repins.inc()
                events.record("session_repinned", severity="warning",
                              session_id=session_id, from_url=old,
                              to_url=url)
                log.warning("session %s re-pinned %s -> %s",
                            session_id, old, url)
                return url, False
            if status != 404:
                uncertain += 1
            log.warning("survivor %s refused adoption of %s: %s %s",
                        url, session_id, status, body[:200])
        return None, attempted > 0 and uncertain == 0

    def route_session(self, session_id: str) -> str | None:
        return self.route_session_ex(session_id)[0]

    def route_session_ex(self, session_id: str
                         ) -> tuple[str | None, bool]:
        """The replica a session op should go to: the live pin; for an
        UNKNOWN session (router restart — pins are memory) the replica
        that already holds it live, re-learned by probing; else a
        survivor that successfully adopts. Probing before adopting
        matters: stealing a session from a healthy replica would
        double-host it and pay an adoption replay for a failover that
        never happened.

        Returns ``(replica, definitively_unknown)``. ``(None, True)``
        = every ready replica answered and denied the session AND no
        adoptable handoff stream exists — the caller should 404, not
        tell the client to retry a session that already ended.
        ``(None, False)`` = nowhere to send it right now (no ready
        replicas, or transport failures muddied the sweep) — caller
        503s and the client retries."""
        url = self.session_url(session_id)
        if url is not None:
            with self._lock:
                pinned_ready = self._ready.get(url, False)
            if pinned_ready:
                return url, False
            # The sweep's cached flag can be STALE (one missed probe
            # while the replica was busy). Adoption is expensive and —
            # worse — steals the session; re-probe the pin fresh and
            # believe a live answer before walking the survivors.
            ready, reason = self._probe(url)
            self._set_ready(url, ready, reason)
            if ready:
                return url, False
            # A pin is evidence the session recently lived on a replica
            # we can no longer ask — its fate is UNKNOWN until a
            # survivor adopts or the replica recovers, so never 404.
            return self._adopt_on_survivor_ex(session_id)[0], False
        probed = 0
        uncertain = 0      # transport failures + non-(200|404) answers
        for candidate in self.ready_replicas():
            probed += 1
            try:
                status, _, _ = self.forward(
                    candidate, "GET", f"/session/{session_id}")
            except OSError:
                uncertain += 1
                continue
            if status == 200:
                self.pin_session(session_id, candidate)
                return candidate, False
            if status != 404:
                uncertain += 1
        adopted, adopt_unknown = self._adopt_on_survivor_ex(session_id)
        if adopted is not None:
            return adopted, False
        return None, probed > 0 and uncertain == 0 and adopt_unknown

    # -- inspection -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            out = {
                "router_id": self.router_id,
                "replicas": [
                    {"url": u, "ready": self._ready.get(u, False),
                     "detector": self._det_state.get(u, ALIVE),
                     "reason": self._reasons.get(u, "")}
                    for u in self.replicas],
                "routers": [
                    {"url": u, "router_id": rid, "alive": rid is not None}
                    for u, rid in self._peer_ids.items()],
                "sessions_pinned": {sid: rec[0] for sid, rec
                                    in self._sessions.items()},
                "jobs_pinned": len(self._jobs),
                "failovers": int(self._failovers.value),
                "session_repins": int(self._repins.value),
                "proactive_repins": int(self._proactive.value),
                "pin_board": (None if self.pin_board is None else {
                    "backend": self.pin_board.store.stats()
                    .get("backend"),
                    "write_failures": self.pin_board.write_failures}),
            }
        out["content_cache"] = self.corrupt_blob_summary()
        return out

    def metrics_text(self) -> str:
        with self._lock:
            self._ready_gauge.set(sum(self._ready.values()))
        return self.registry.prometheus_text()


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------


class _RouterHandler(BaseHTTPRequestHandler):
    router: FleetRouter  # bound by RouterHTTPServer

    protocol_version = "HTTP/1.1"
    timeout = 120.0

    def _json(self, obj, status=200):
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _relay(self, status: int, headers: dict, body: bytes) -> None:
        self.send_response(status)
        for k, v in headers.items():
            if k.lower() in ("content-type", "retry-after") \
                    or k.lower().startswith("x-"):
                self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _no_replica(self) -> None:
        self.router._unroutable.inc()
        self._json({"error": {"type": "NoReadyReplicaError",
                              "message": "no ready replica in the "
                                         "fleet; retry shortly"}}, 503)

    def _session_unknown(self, session_id: str) -> None:
        # Definitive (route_session_ex's second element): every ready
        # replica denied the session and no handoff stream exists — a
        # retryable 503 here would have clients polling an ended
        # session forever, each poll costing a full fleet sweep.
        self._json({"error": {"type": "UnknownSessionError",
                              "message": f"unknown session "
                                         f"{session_id!r} on every "
                                         "ready replica"}}, 404)

    def _read_body(self) -> bytes | None:
        length = int(self.headers.get("Content-Length", 0))
        if length < 0 or length > MAX_SUBMIT_BYTES:
            self.close_connection = True
            self._json({"error": {"type": "StackFormatError",
                                  "message": f"Content-Length {length} "
                                             f"outside [0, "
                                             f"{MAX_SUBMIT_BYTES}]"}},
                       400)
            return None
        return self.rfile.read(length) if length else b""

    def _fwd_headers(self) -> dict:
        return {k: self.headers[k] for k in _FORWARD_HEADERS
                if self.headers.get(k)}

    # ------------------------------------------------------------------

    def do_POST(self):
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        body = self._read_body()
        if body is None:
            return
        if url.path == "/submit":
            self._submit(body)
        elif parts and parts[0] == "session":
            self._session_op(parts, body)
        else:
            self._json({"error": "not found"}, 404)

    def _submit(self, body: bytes) -> None:
        r = self.router
        r._requests("submit").inc()
        candidates = r.place_submit(body)
        if not candidates:
            self._no_replica()
            return
        for i, replica in enumerate(candidates):
            try:
                status, hdrs, resp = r.forward(
                    replica, "POST", "/submit", body=body,
                    headers=self._fwd_headers())
            except OSError:
                r._failovers.inc()
                continue
            if status == 503 and i + 1 < len(candidates):
                # Draining/unready replica the sweep hasn't flagged yet:
                # fail over along the ring like a dead one. 429 is NOT
                # failed over — backpressure is load, and shoving the
                # burst onto the next replica just moves the hot spot.
                r._failovers.inc()
                continue
            if status == 200:
                try:
                    job_id = json.loads(resp.decode()).get("job_id")
                except (ValueError, UnicodeDecodeError):
                    job_id = None
                if job_id:
                    r.pin_job(job_id, replica)
            self._relay(status, hdrs, resp)
            return
        self._no_replica()

    def _session_op(self, parts: list, body: bytes) -> None:
        r = self.router
        if len(parts) == 1:
            # POST /session — create on the round-robin pick.
            r._requests("session_create").inc()
            replica = r.next_replica()
            if replica is None:
                self._no_replica()
                return
            try:
                status, hdrs, resp = r.forward(
                    replica, "POST", "/session", body=body,
                    headers=self._fwd_headers())
            except OSError:
                self._no_replica()
                return
            if status == 200:
                try:
                    sid = json.loads(resp.decode()).get("session_id")
                except (ValueError, UnicodeDecodeError):
                    sid = None
                if sid:
                    r.pin_session(sid, replica)
            self._relay(status, hdrs, resp)
            return
        sid = parts[1]
        r._requests("session_op").inc()
        replica, unknown = r.route_session_ex(sid)
        if replica is None:
            self._session_unknown(sid) if unknown else self._no_replica()
            return
        try:
            status, hdrs, resp = r.forward(
                replica, "POST", "/" + "/".join(parts), body=body,
                headers=self._fwd_headers())
        except OSError:
            # The pin died mid-request: one handoff retry, then give up
            # (the client's own retry policy owns anything beyond).
            replica = r.adopt_on_survivor(sid)
            if replica is None:
                self._no_replica()
                return
            try:
                status, hdrs, resp = r.forward(
                    replica, "POST", "/" + "/".join(parts), body=body,
                    headers=self._fwd_headers())
            except OSError:
                self._no_replica()
                return
        if len(parts) == 3 and parts[2] == "finalize" and status == 200:
            try:
                job_id = json.loads(resp.decode()).get("job_id")
            except (ValueError, UnicodeDecodeError):
                job_id = None
            if job_id:
                r.pin_job(job_id, replica)
        self._relay(status, hdrs, resp)

    # ------------------------------------------------------------------

    def do_GET(self):
        url = urlparse(self.path)
        r = self.router
        if url.path == "/healthz":
            self._json({"ok": True, "router": True, **r.stats()})
        elif url.path == "/readyz":
            ready = bool(r.ready_replicas())
            self._json({"ready": ready,
                        "reasons": ([] if ready
                                    else ["no ready replicas"])},
                       200 if ready else 503)
        elif url.path == "/fleet":
            self._json(r.stats())
        elif url.path == "/fleet/signals":
            self._json(r.signals())
        elif url.path == "/metrics":
            data = r.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif url.path in ("/status", "/result"):
            self._job_query(url)
        elif url.path.startswith("/session/"):
            parts = [p for p in url.path.split("/") if p]
            if len(parts) < 2:     # bare "/session/" — no id to route
                self._json({"error": "not found"}, 404)
                return
            replica, unknown = r.route_session_ex(parts[1])
            if replica is None:
                self._session_unknown(parts[1]) if unknown \
                    else self._no_replica()
                return
            self._proxy_get(replica, self.path)
        else:
            self._json({"error": "not found"}, 404)

    def _job_query(self, url) -> None:
        r = self.router
        job_id = (parse_qs(url.query).get("id") or [""])[0]
        replica = r.job_url(job_id)
        if replica is not None:
            self._proxy_get(replica, self.path)
            return
        # Unknown placement (router restarted, or the job predates us):
        # probe the fleet — first replica that knows the id wins the pin.
        for candidate in r.ready_replicas():
            try:
                status, hdrs, body = r.forward(candidate, "GET",
                                               self.path)
            except OSError:
                continue
            if status != 404:
                r.pin_job(job_id, candidate)
                self._relay(status, hdrs, body)
                return
        self._json({"error": f"unknown job {job_id!r} on every ready "
                             "replica"}, 404)

    def _proxy_get(self, replica: str, path: str) -> None:
        try:
            status, hdrs, body = self.router.forward(replica, "GET", path)
        except OSError:
            self._json({"error": {"type": "ReplicaUnreachableError",
                                  "message": f"replica {replica} did "
                                             "not answer"}}, 503)
            return
        self._relay(status, hdrs, body)

    def do_DELETE(self):
        parts = [p for p in urlparse(self.path).path.split("/") if p]
        if len(parts) == 2 and parts[0] == "session":
            replica, unknown = self.router.route_session_ex(parts[1])
            if replica is None:
                self._session_unknown(parts[1]) if unknown \
                    else self._no_replica()
                return
            try:
                status, hdrs, body = self.router.forward(
                    replica, "DELETE", self.path)
            except OSError:
                self._no_replica()
                return
            if status == 200:
                self.router.unpin_session(parts[1])
            self._relay(status, hdrs, body)
        else:
            self._json({"error": "not found"}, 404)

    def log_message(self, fmt, *args):
        log.debug("router: " + fmt, *args)


class RouterHTTPServer:
    """Owns the router's listener thread (mirrors ServeHTTPServer, and
    like it listens with a 128-deep accept backlog)."""

    def __init__(self, router: FleetRouter, host: str = "127.0.0.1",
                 port: int = 0):
        self.router = router
        handler = type("BoundRouterHandler", (_RouterHandler,),
                       {"router": router})
        self._httpd = _Listener((host, port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="router-http", daemon=True)
        self._started = False

    def start(self) -> "RouterHTTPServer":
        self.router.start()
        self._thread.start()
        self._started = True
        log.info("fleet router on :%d (%d replica(s))", self.port,
                 len(self.router.replicas))
        return self

    def stop(self) -> None:
        self.router.stop()
        if self._started:
            self._httpd.shutdown()
        self._httpd.server_close()
