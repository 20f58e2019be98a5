"""Fleet tier: replica identity, peer protocol, shared content cache
(counterpart of the JAX package's ``serve/fleet.py``; pure stdlib).

A single durable replica's journal, content cache and governor all die
with the process's disk and port. This module is the peer half of the
fleet tier (the front router lives in serve/router.py): every
:class:`~.service.ReconstructionService` can now carry a **replica
identity** and a **peer table**, and consult its peers' content caches
at admission time, so a mesh computed on replica A answers a duplicate
submit on replica B without touching B's queue or device.

The peer protocol is deliberately tiny — ``GET /cache/<key>`` over the
existing stdlib HTTP front end — and defended on every axis a sick peer
could hurt us through:

* **bounded timeouts** — one per-peer request bound
  (``peer_timeout_s``) and one whole-lookup budget (``peer_budget_s``);
  a slow peer degrades to a local miss, never a stall in admission;
* **per-peer circuit breakers** — the overload governor's
  :class:`~.governor.CircuitBreaker` machinery, one per peer, so a
  persistently failing peer is skipped for a cooldown instead of being
  probed on every admission;
* **jittered exponential backoff** — transient transport failures back
  the peer off (base × 2^n, ±50% jitter, capped) so N replicas don't
  hammer a restarting peer in lockstep;
* **single-flight dedup** — concurrent admissions of the same content
  key share ONE peer fetch; racers wait (bounded) instead of fanning N
  identical requests across the fleet;
* **negative-result TTL** — a fleet-wide miss is remembered for a few
  seconds, so a burst of novel submits does not re-sweep every peer per
  request.

:class:`PeerTransport` is the single seam to the network; the
fault-injecting :class:`FaultyPeerTransport` (seeded drops + latency,
``SL_PEER_FAULTS`` env for subprocess replicas) is how the fleet chaos
runs prove the degraded modes. :class:`HashRing` is the consistent-hash used by the router for
content-key admission placement and session preference order.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import json
import os
import random
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict

from ..utils import trace
from ..utils.log import get_logger
from .governor import CircuitBreaker

log = get_logger(__name__)

#: Env var carrying a JSON :class:`PeerFaultPlan` for subprocess replicas
#: (the chaos harness sets it; production never does).
PEER_FAULTS_ENV = "SL_PEER_FAULTS"


# ---------------------------------------------------------------------------
# Transport (the single network seam — and the fault-injection point)
# ---------------------------------------------------------------------------


class PeerTransport:
    """Stdlib HTTP with a bounded timeout. Connection-level failures
    surface as OSError (``urllib.error.URLError`` subclasses it); HTTP
    error statuses are returned, not raised — the caller decides what a
    404 vs a 503 means for the peer's health."""

    def request(self, method: str, url: str, body: bytes | None = None,
                headers: dict | None = None,
                timeout_s: float = 5.0) -> tuple[int, dict, bytes]:
        req = urllib.request.Request(url, data=body,
                                     headers=dict(headers or {}),
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def get(self, url: str,
            timeout_s: float = 5.0) -> tuple[int, dict, bytes]:
        return self.request("GET", url, timeout_s=timeout_s)


@dataclasses.dataclass(frozen=True)
class PeerFaultPlan:
    """Seeded peer-network fault schedule: a deterministic fraction of
    requests is dropped (connection error) and/or delayed. One shared
    RNG stream per transport — the same seed reproduces the same fault
    sequence, the chaos-harness determinism rule (hw/faults.py applied
    to the peer network)."""

    seed: int = 0
    drop_rate: float = 0.0      # P(request raises URLError instead)
    latency_s: float = 0.0      # injected delay when latency fires
    latency_rate: float = 0.0   # P(latency_s is injected)

    @classmethod
    def from_env(cls, env: str = PEER_FAULTS_ENV) -> "PeerFaultPlan | None":
        spec = os.environ.get(env)
        if not spec:
            return None
        try:
            doc = json.loads(spec)
        except ValueError as e:
            log.error("ignoring malformed %s=%r: %s", env, spec, e)
            return None
        allowed = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in allowed})


class FaultyPeerTransport(PeerTransport):
    """Wraps a transport with a :class:`PeerFaultPlan`. ``sleep`` is
    injectable so unit tests assert latency decisions without waiting."""

    def __init__(self, plan: PeerFaultPlan,
                 inner: PeerTransport | None = None, sleep=time.sleep):
        self.plan = plan
        self.inner = inner if inner is not None else PeerTransport()
        self._sleep = sleep
        self._lock = threading.Lock()  # one deterministic RNG stream
        self._rng = random.Random(plan.seed)
        self.drops = 0
        self.delays = 0

    def request(self, method, url, body=None, headers=None,
                timeout_s=5.0):
        with self._lock:
            drop = self._rng.random() < self.plan.drop_rate
            delay = (not drop
                     and self._rng.random() < self.plan.latency_rate)
            if drop:
                self.drops += 1
            if delay:
                self.delays += 1
        if drop:
            raise urllib.error.URLError(
                ConnectionResetError("injected peer-network drop"))
        if delay:
            self._sleep(self.plan.latency_s)
        return self.inner.request(method, url, body=body, headers=headers,
                                  timeout_s=timeout_s)


def transport_from_env() -> PeerTransport:
    """The transport a real replica should use: fault-injecting when the
    chaos harness armed ``SL_PEER_FAULTS``, plain otherwise."""
    plan = PeerFaultPlan.from_env()
    if plan is None:
        return PeerTransport()
    log.warning("peer transport faults armed: %s", plan)
    return FaultyPeerTransport(plan)


# ---------------------------------------------------------------------------
# Consistent-hash ring
# ---------------------------------------------------------------------------


def _h64(s: str) -> int:
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring with virtual nodes.

    ``node_for(key)`` is stable under membership changes: removing one
    node remaps only the keys that hashed to it (its vnode arcs), which
    is exactly the duplicate-hit-friendly property the router's
    content-key admission needs — a replica death must not reshuffle
    every key to a new (cache-cold) replica. Thread-safe."""

    def __init__(self, nodes=(), vnodes: int = 64):
        self.vnodes = max(1, int(vnodes))
        self._lock = threading.Lock()
        self._ring: list[tuple[int, str]] = []
        self._nodes: set[str] = set()
        for n in nodes:
            self.add(n)

    def add(self, node: str) -> None:
        with self._lock:
            if node in self._nodes:
                return
            self._nodes.add(node)
            for v in range(self.vnodes):
                bisect.insort(self._ring, (_h64(f"{node}#{v}"), node))

    def remove(self, node: str) -> None:
        with self._lock:
            if node not in self._nodes:
                return
            self._nodes.discard(node)
            self._ring = [(h, n) for h, n in self._ring if n != node]

    @property
    def nodes(self) -> set[str]:
        with self._lock:
            return set(self._nodes)

    def preference(self, key: str, avoid=()) -> list[str]:
        """Distinct nodes in ring order from ``key``'s position — the
        failover order: preference[0] is the consistent-hash owner,
        preference[1] the node keys fall over to when it dies."""
        avoid = set(avoid)
        with self._lock:
            if not self._ring:
                return []
            out: list[str] = []
            start = bisect.bisect_left(self._ring, (_h64(key), ""))
            for i in range(len(self._ring)):
                node = self._ring[(start + i) % len(self._ring)][1]
                if node not in avoid and node not in out:
                    out.append(node)
            return out

    def node_for(self, key: str, avoid=()) -> str | None:
        pref = self.preference(key, avoid=avoid)
        return pref[0] if pref else None


# ---------------------------------------------------------------------------
# Peer table (breaker + backoff per peer)
# ---------------------------------------------------------------------------


class _PeerState:
    """One peer's health bookkeeping: a circuit breaker for persistent
    failure, exponential backoff for transient failure. Both answer one
    question — "should we spend a request on this peer right now?"."""

    def __init__(self, url: str, breaker: CircuitBreaker,
                 backoff_base_s: float, backoff_cap_s: float,
                 rng: random.Random):
        self.url = url
        self.breaker = breaker
        self._base = backoff_base_s
        self._cap = backoff_cap_s
        self._rng = rng
        self._lock = threading.Lock()
        self._fails = 0
        self._backoff_until = 0.0

    def usable(self) -> bool:
        if self.breaker.open_remaining() is not None:
            return False
        with self._lock:
            return time.monotonic() >= self._backoff_until

    def note_ok(self) -> None:
        self.breaker.note_ok()
        with self._lock:
            self._fails = 0
            self._backoff_until = 0.0

    def note_failure(self) -> bool:
        """Record one failed request; bumps the jittered exponential
        backoff. Returns True when this failure tripped the breaker."""
        tripped, _, _ = self.breaker.note_failure()
        with self._lock:
            self._fails += 1
            delay = min(self._cap, self._base * (2 ** (self._fails - 1)))
            self._backoff_until = (time.monotonic()
                                   + delay * self._rng.uniform(0.5, 1.5))
        return tripped

    def stats(self) -> dict:
        remaining = self.breaker.open_remaining()
        with self._lock:
            backoff = max(0.0, self._backoff_until - time.monotonic())
        return {"url": self.url,
                "breaker_open_s": (round(remaining, 2)
                                   if remaining is not None else None),
                "backoff_s": round(backoff, 2),
                "consecutive_failures": self._fails}


# ---------------------------------------------------------------------------
# Peer content-cache client
# ---------------------------------------------------------------------------


class PeerCacheClient:
    """Admission-time peer lookup for the shared content cache.

    ``lookup(key)`` returns ``(payload, meta, format)`` from the first
    peer that holds the artifact, or None. The calling admission path
    treats None exactly like a local miss — every degraded mode (slow
    peer, dead peer, open breaker, spent budget) converges on "compute
    it locally", never on a stall or an error."""

    def __init__(self, peers, transport: PeerTransport | None = None,
                 timeout_s: float = 2.0, budget_s: float = 3.0,
                 negative_ttl_s: float = 5.0,
                 breaker_window: int = 8, breaker_min_samples: int = 4,
                 breaker_failure_rate: float = 0.5,
                 breaker_cooldown_s: float = 10.0,
                 backoff_base_s: float = 0.5, backoff_cap_s: float = 30.0,
                 registry: "trace.MetricsRegistry | None" = None,
                 rng: random.Random | None = None):
        self.timeout_s = float(timeout_s)
        self.budget_s = float(budget_s)
        self.negative_ttl_s = float(negative_ttl_s)
        self.transport = (transport if transport is not None
                          else transport_from_env())
        self.registry = registry if registry is not None else trace.REGISTRY
        rng = rng if rng is not None else random.Random()
        self._peers = [
            _PeerState(url.rstrip("/"),
                       CircuitBreaker(window=breaker_window,
                                      min_samples=breaker_min_samples,
                                      failure_rate=breaker_failure_rate,
                                      cooldown_s=breaker_cooldown_s),
                       backoff_base_s, backoff_cap_s, rng)
            for url in peers]
        self._lock = threading.Lock()
        # Single-flight: key -> {"ev": Event, "result": tuple | None}.
        self._inflight: dict[str, dict] = {}
        # Negative TTL: key -> monotonic expiry (bounded FIFO).
        self._negative: OrderedDict[str, float] = OrderedDict()
        self._negative_cap = 4096
        self._hits = self.registry.counter(
            "serve_peer_cache_hits_total",
            "admissions answered from a peer's content cache")
        self._misses = self.registry.counter(
            "serve_peer_cache_misses_total",
            "peer lookups that found no artifact fleet-wide")
        self._failures = self.registry.counter(
            "serve_peer_fetch_failures_total",
            "peer requests that failed at the transport level")
        self._skips = self.registry.counter(
            "serve_peer_skips_total",
            "peer requests not attempted (breaker open or backing off)")
        self._breaker_trips = self.registry.counter(
            "serve_peer_breaker_trips_total",
            "per-peer circuit-breaker openings")

    @property
    def peer_urls(self) -> list[str]:
        return [p.url for p in self._peers]

    # ------------------------------------------------------------------

    def _peer_order(self, key: str) -> list[_PeerState]:
        """Rendezvous order: peers sorted by hash(key, peer) — the same
        key probes peers in the same order fleet-wide (the likely owner
        first under the router's consistent-hash placement), different
        keys spread their first probes across peers."""
        return sorted(self._peers,
                      key=lambda p: _h64(f"{key}@{p.url}"))

    def lookup(self, key: str) -> tuple[bytes, dict, str] | None:
        if not self._peers:
            return None
        now = time.monotonic()
        with self._lock:
            exp = self._negative.get(key)
            if exp is not None:
                if now < exp:
                    return None
                del self._negative[key]
            rec = self._inflight.get(key)
            if rec is None:
                rec = {"ev": threading.Event(), "result": None}
                self._inflight[key] = rec
                owner = True
            else:
                owner = False
        if not owner:
            # Single-flight racer: share the owner's fetch. A timeout
            # here (wedged owner) is just a miss — never a stall.
            rec["ev"].wait(self.budget_s)
            return rec["result"]
        result = None
        try:
            result = self._fetch(key)
        finally:
            with self._lock:
                if result is None:
                    self._prune_negative_locked(now)
                    self._negative[key] = (time.monotonic()
                                           + self.negative_ttl_s)
                self._inflight.pop(key, None)
            rec["result"] = result
            rec["ev"].set()
        return result

    def _prune_negative_locked(self, now: float) -> None:
        while self._negative:
            k, exp = next(iter(self._negative.items()))
            if exp >= now and len(self._negative) < self._negative_cap:
                break
            del self._negative[k]

    def _fetch(self, key: str) -> tuple[bytes, dict, str] | None:
        deadline = time.monotonic() + self.budget_s
        for peer in self._peer_order(key):
            if time.monotonic() >= deadline:
                break
            if not peer.usable():
                self._skips.inc()
                continue
            timeout = min(self.timeout_s,
                          max(0.05, deadline - time.monotonic()))
            try:
                status, hdrs, body = self.transport.get(
                    f"{peer.url}/cache/{key}", timeout_s=timeout)
            except OSError as e:
                self._failures.inc()
                if peer.note_failure():
                    self._breaker_trips.inc()
                    log.warning("peer %s breaker opened (%s)",
                                peer.url, e)
                continue
            if status == 200:
                peer.note_ok()
                try:
                    meta = json.loads(hdrs.get("X-Content-Meta") or "{}")
                except ValueError:
                    meta = {}
                fmt = hdrs.get("X-Content-Format", "ply")
                self._hits.inc()
                return body, meta, fmt
            if status == 404:
                peer.note_ok()   # healthy peer, honest miss
                continue
            # Draining (503) or confused (4xx/5xx) peer: a failure for
            # backoff purposes so we stop hammering it, but not a
            # transport error.
            self._failures.inc()
            if peer.note_failure():
                self._breaker_trips.inc()
        self._misses.inc()
        return None

    def stats(self) -> dict:
        with self._lock:
            negative = len(self._negative)
            inflight = len(self._inflight)
        return {
            "peers": [p.stats() for p in self._peers],
            "hits": int(self._hits.value),
            "misses": int(self._misses.value),
            "fetch_failures": int(self._failures.value),
            "skips": int(self._skips.value),
            "breaker_trips": int(self._breaker_trips.value),
            "negative_entries": negative,
            "inflight": inflight,
        }
