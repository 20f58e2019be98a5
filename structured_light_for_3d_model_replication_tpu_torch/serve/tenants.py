"""Per-tenant admission quotas: token buckets at the service door.

The governor (serve/governor.py) protects the service from AGGREGATE
overload; this module protects tenants from EACH OTHER — one hot client
replaying scans in a loop must not eat the whole queue and starve
everyone. Each tenant (the ``X-Tenant`` request header; ``anon`` when
absent) gets a token bucket: ``rate_per_s`` sustained admissions per
second with ``burst`` of headroom. An empty bucket refuses the
admission with :class:`TenantQuotaError` — a retryable
:class:`~.jobs.JobRejected` (HTTP 429 + Retry-After carrying the exact
refill wait), so well-behaved clients back off with the same taxonomy
machinery every other rejection uses.

Accounting rules:

* the token spend sits AFTER the governor and BEFORE the queue: a
  fleet-side refusal (breaker open, shedding) must not drain a
  tenant's bucket for work that never ran, an over-budget tenant must
  not occupy queue headroom, and a queue/session-registry rejection
  after the spend is REFUNDED (:meth:`TenantQuotas.refund`) for the
  same reason. The HTTP layer's headers-time probe uses the
  non-spending :meth:`TenantQuotas.check` (leading with the cheapest
  gate), so the authoritative spend happens exactly once;
* content-cache hits are exempt by placement (the service consults the
  cache upstream of every admission gate — a cached answer costs the
  fleet nothing, charging for it would punish deduplication);
* per-tenant traffic is visible as ``serve_tenant_admitted_total`` /
  ``serve_tenant_rejected_total`` {tenant=...} counters. Tenant label
  cardinality is bounded: ids are sanitized to ``[A-Za-z0-9_-]{1,32}``
  (anything else collapses to ``other``) and the bucket table is a
  bounded LRU — an attacker minting random tenant ids recycles buckets
  instead of growing memory.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from ..utils.log import get_logger
from .jobs import JobRejected

log = get_logger(__name__)

#: The tenant every unlabelled request bills to.
DEFAULT_TENANT = "anon"

#: Floor on a cost-weighted spend: even a thumbnail stack pays
#: something (a zero-cost admission would make the quota a no-op for
#: tiny-stack floods, the exact abuse quotas exist for).
MIN_STACK_COST = 0.125

_ALLOWED = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-")


def stack_cost(height: int, width: int) -> float:
    """Cost-weighted token spend for one capture stack: its MEGAPIXELS
    (floored at :data:`MIN_STACK_COST`), so a 1080p stack (~2.07 MP)
    spends ~2 tokens where a 240p one spends the 0.125 floor —
    ``rate_per_s`` becomes sustained megapixels/s per tenant instead of
    submits/s. Refunds must pass the SAME cost back
    (:meth:`TenantQuotas.refund` — the refund-parity contract)."""
    return max(MIN_STACK_COST, (int(height) * int(width)) / 1.0e6)


def sanitize_tenant(raw: str | None) -> str:
    """Metric-label-safe tenant id: empty/None → ``anon``; anything
    outside ``[A-Za-z0-9_-]{1,32}`` → ``other`` (bounded label
    cardinality beats per-tenant fidelity for hostile ids)."""
    if not raw:
        return DEFAULT_TENANT
    if len(raw) > 32 or any(c not in _ALLOWED for c in raw):
        return "other"
    return raw


class TenantQuotaError(JobRejected):
    """Tenant over its admission budget — retry after the bucket
    refills (or spread load over more time; the fleet is fine, YOUR
    lane is full)."""

    retryable = True

    def __init__(self, tenant: str, retry_after_s: float):
        super().__init__(
            f"tenant {tenant!r} admission quota exhausted; retry in "
            f"{retry_after_s:.2f}s")
        self.tenant = tenant
        self.retry_after_s = retry_after_s


class TenantQuotas:
    """Bounded table of per-tenant token buckets.

    ``rate_per_s`` tokens accrue continuously up to ``burst``; one
    admission spends one token. ``clock`` is injectable (monotonic
    seconds) so tests drive time deterministically."""

    def __init__(self, rate_per_s: float, burst: int,
                 registry, max_tenants: int = 1024,
                 clock=time.monotonic):
        if rate_per_s <= 0:
            raise ValueError(f"rate_per_s must be > 0, got {rate_per_s}")
        self.rate_per_s = float(rate_per_s)
        self.burst = max(1, int(burst))
        self.max_tenants = max(1, int(max_tenants))
        self._clock = clock
        self._lock = threading.Lock()
        # tenant -> [tokens, last_refill_t]; LRU-bounded.
        self._buckets: OrderedDict[str, list] = OrderedDict()
        self._admitted = lambda tenant: registry.counter(
            "serve_tenant_admitted_total",
            "admissions accepted per tenant", tenant=tenant)
        self._rejected = lambda tenant: registry.counter(
            "serve_tenant_rejected_total",
            "admissions refused by the tenant quota", tenant=tenant)

    def _bucket(self, tenant: str, now: float) -> list:
        b = self._buckets.get(tenant)
        if b is None:
            b = [float(self.burst), now]
            self._buckets[tenant] = b
            while len(self._buckets) > self.max_tenants:
                self._buckets.popitem(last=False)
        else:
            self._buckets.move_to_end(tenant)
            tokens, last = b
            b[0] = min(float(self.burst),
                       tokens + (now - last) * self.rate_per_s)
            b[1] = now
        return b

    def admit(self, tenant: str | None, cost: float = 1.0) -> str:
        """Spend ``cost`` tokens for ``tenant`` (sanitized; returned so
        the caller can stamp the job). ``cost`` defaults to the
        historical 1-per-submit; cost-weighted services pass
        :func:`stack_cost` so spend tracks megapixels. Raises
        :class:`TenantQuotaError` when the bucket can't cover it."""
        return self._admit(tenant, spend=True, cost=cost)

    def check(self, tenant: str | None, cost: float = 1.0) -> str:
        """The refusal :meth:`admit` WOULD raise right now, without
        spending a token — the HTTP layer's headers-time probe (reject
        an over-budget tenant before buffering its ~95 MB body; the
        authoritative spend happens at the real admission, where the
        weighted cost is known). Advisory: counts only rejections."""
        return self._admit(tenant, spend=False, cost=cost)

    def _need(self, cost: float) -> float:
        # Capped at burst: a stack costing more than the whole bucket
        # must still be admittable at full burst, else it is rejected
        # forever no matter how patient the tenant.
        return min(float(self.burst), max(MIN_STACK_COST, float(cost)))

    def _admit(self, tenant: str | None, spend: bool,
               cost: float = 1.0) -> str:
        tenant = sanitize_tenant(tenant)
        need = self._need(cost)
        now = self._clock()
        with self._lock:
            b = self._bucket(tenant, now)
            if b[0] >= need:
                if spend:
                    b[0] -= need
                admitted = True
                wait = 0.0
            else:
                admitted = False
                wait = (need - b[0]) / self.rate_per_s
        if admitted:
            if spend:
                self._admitted(tenant).inc()
            return tenant
        self._rejected(tenant).inc()
        raise TenantQuotaError(tenant, max(0.05, wait))

    def refund(self, tenant: str | None, cost: float = 1.0) -> None:
        """Return the spend (capped at burst): the admission tokens were
        spent on was refused FURTHER DOWN the gate chain (queue full,
        session registry full) — nothing ran, so the tenant's budget
        must not be charged. ``cost`` must be the SAME value the paired
        :meth:`admit` spent (refund parity — asserted in tests). The
        ``serve_tenant_admitted_total`` counter keeps token-SPEND
        semantics (monotonic counters can't decrement); a refunded
        spend shows up as a paired queue-level rejection on the same
        scrape."""
        tenant = sanitize_tenant(tenant)
        need = self._need(cost)
        with self._lock:
            b = self._buckets.get(tenant)
            if b is not None:
                b[0] = min(float(self.burst), b[0] + need)

    def stats(self) -> dict:
        with self._lock:
            return {
                "rate_per_s": self.rate_per_s,
                "burst": self.burst,
                "tenants_tracked": len(self._buckets),
                "tokens": {t: round(b[0], 2)
                           for t, b in self._buckets.items()},
            }
