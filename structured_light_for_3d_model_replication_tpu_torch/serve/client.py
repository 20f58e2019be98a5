"""Stdlib client for the reconstruction service.

The wire format is deliberately primitive — an ``.npy`` body plus a few
``X-`` headers — so anything that can HTTP-POST a file can submit a scan
(curl included; docs/SERVING.md shows the one-liner). This class wraps
the submit → poll → fetch dance for tests, the bench offered-load sweep
(config [7]) and the CI smoke script, with honest error surfacing:
backpressure (429/503) raises :class:`BackpressureError` carrying the
server's retry-after hint instead of burying it in response prose.

Submitting calls (``submit`` / ``submit_stop`` / ``create_session``)
retry backpressure themselves by default: the server's ``Retry-After``
hint is honored when present (else exponential backoff), jittered so a
rejected burst does not re-arrive as the same burst, and bounded by BOTH
an attempt count (``retries``) and a wall-clock budget
(``retry_budget_s``). ``retries=0`` restores surface-immediately
semantics.

Fleet failover: ``base_url`` may be a LIST of replica (or router) URLs.
Connection-level failures (refused/reset/timeout — a dead replica)
raise :class:`TransportError`, which is retryable under the same backoff
policy and rotates the client to the next URL first, so the retry lands
on a live replica instead of hammering the corpse.
"""

from __future__ import annotations

import io
import json
import random
import time
import urllib.error
import urllib.request

import numpy as np


class ServeClientError(RuntimeError):
    """Non-retryable client-visible failure (4xx, failed job, timeout)."""

    def __init__(self, message: str, payload: dict | None = None):
        super().__init__(message)
        self.payload = payload or {}


class BackpressureError(ServeClientError):
    """Queue full (429) or draining (503) — retry after ``retry_after_s``."""

    def __init__(self, message: str, retry_after_s: float | None,
                 payload: dict | None = None):
        super().__init__(message, payload)
        self.retry_after_s = retry_after_s


class TransportError(ServeClientError):
    """Connection-level failure — refused, reset, DNS, timeout. A dead
    replica looks exactly like this, so it is RETRYABLE under the same
    backoff policy as backpressure, and a client constructed with
    several base URLs rotates to the next one before the retry."""


class ServeClient:
    def __init__(self, base_url, timeout_s: float = 30.0,
                 retries: int = 4, retry_backoff_s: float = 0.25,
                 retry_budget_s: float = 30.0,
                 unknown_grace_s: float = 0.0,
                 tenant: str | None = None):
        # One URL or a list: with a list, connection-level failures
        # rotate to the next replica (failover), while HTTP-level
        # answers (including 429/503) stay on the current one.
        urls = ([base_url] if isinstance(base_url, str)
                else list(base_url))
        if not urls:
            raise ValueError("base_url must name at least one replica")
        self._urls = [u.rstrip("/") for u in urls]
        self._url_idx = 0
        self.timeout_s = timeout_s
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_budget_s = float(retry_budget_s)
        # How long wait() keeps polling through "unknown job" 404s
        # before trusting them. Behind a fleet router, an acked job can
        # 404 transiently while its replica is dead-awaiting-recovery
        # (every survivor answers 404); clients that poll recoverable
        # jobs across failover set this to their recovery budget.
        # Default 0.0 keeps the honest fast 404.
        self.unknown_grace_s = float(unknown_grace_s)
        # Tenant identity: stamped as X-Tenant on every admission call
        # (submit / session create / stop) so per-tenant quotas and the
        # serve_tenant_* metrics attribute this client's load. None =
        # the server's "anon" bucket.
        self.tenant = tenant
        # Injectable for deterministic tests.
        self._sleep = time.sleep
        self._rng = random.Random()

    def _tenant_headers(self, headers: dict) -> dict:
        if self.tenant:
            headers["X-Tenant"] = self.tenant
        return headers

    @property
    def base_url(self) -> str:
        """The replica currently in rotation."""
        return self._urls[self._url_idx % len(self._urls)]

    def _rotate(self) -> None:
        if len(self._urls) > 1:
            self._url_idx = (self._url_idx + 1) % len(self._urls)

    # ------------------------------------------------------------------

    def _retrying(self, fn):
        """Run ``fn`` with jittered backoff on backpressure AND on
        connection-level failure (a dead/restarting replica): the
        server's Retry-After hint (when present) sets the base delay,
        otherwise exponential from ``retry_backoff_s``; every delay is
        jittered ±50% so N rejected clients don't re-arrive in lockstep.
        Bounded by attempts AND wall clock; the LAST error is re-raised
        intact (hint included) when the budget is spent. Transport
        failures have already rotated the base URL, so the retry lands
        on the next replica in the list."""
        deadline = time.monotonic() + self.retry_budget_s
        attempt = 0
        while True:
            try:
                return fn()
            except (BackpressureError, TransportError) as e:
                if attempt >= self.retries:
                    raise
                hint = getattr(e, "retry_after_s", None)
                base = (hint if hint
                        else self.retry_backoff_s * (2 ** attempt))
                delay = base * self._rng.uniform(0.5, 1.5)
                if time.monotonic() + delay > deadline:
                    raise
                self._sleep(delay)
                attempt += 1

    def _request(self, req: urllib.request.Request):
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()
        except OSError as e:
            # urllib.error.URLError (connection refused/reset/DNS) and
            # raw socket timeouts are all OSError. Rotate FIRST so even
            # a non-retrying caller's next call tries the next replica.
            self._rotate()
            raise TransportError(
                f"replica unreachable ({e}); "
                f"next base URL: {self.base_url}") from e

    @staticmethod
    def _payload(body: bytes) -> dict:
        try:
            return json.loads(body.decode())
        except (ValueError, UnicodeDecodeError):
            return {"raw": body[:200].decode(errors="replace")}

    # ------------------------------------------------------------------

    def submit(self, stack: np.ndarray, result_format: str = "ply",
               priority: str = "normal",
               deadline_s: float | None = None) -> str:
        """POST one capture stack; returns the job id. Backpressure
        (429/503) is retried per the client's retry policy before a
        :class:`BackpressureError` surfaces."""
        stack = np.asarray(stack)
        if stack.dtype != np.uint8:
            # No silent coercion: casting float [0,1] data (or aliasing
            # int16 mod 256) would upload a well-formed but meaningless
            # stack that fails server-side with a misleading coverage
            # error. The caller converts explicitly or fixes the source.
            raise ServeClientError(
                f"stack must be uint8, got {stack.dtype} — convert "
                "explicitly (e.g. (x * 255).astype(np.uint8))")
        buf = io.BytesIO()
        np.save(buf, stack)
        headers = self._tenant_headers(
            {"Content-Type": "application/octet-stream",
             "X-Result-Format": result_format,
             "X-Priority": priority})
        if deadline_s is not None:
            headers["X-Deadline-S"] = str(deadline_s)
        data = buf.getvalue()

        def once():
            req = urllib.request.Request(self.base_url + "/submit",
                                         data=data, headers=headers,
                                         method="POST")
            status, hdrs, body = self._request(req)
            payload = self._payload(body)
            if status in (429, 503):
                msg = payload.get("error", {}).get("message", "overloaded")
                raise BackpressureError(
                    f"submit refused ({status}): {msg}",
                    self._retry_hint(payload, hdrs), payload)
            if status != 200:
                raise ServeClientError(
                    f"submit failed ({status}): {payload}", payload)
            return payload["job_id"]

        return self._retrying(once)

    @staticmethod
    def _retry_hint(payload: dict, hdrs: dict) -> float | None:
        retry = payload.get("error", {}).get("retry_after_s")
        if retry is None and hdrs.get("Retry-After"):
            retry = float(hdrs["Retry-After"])
        return retry

    def status(self, job_id: str) -> dict:
        status, _, body = self._request(urllib.request.Request(
            f"{self.base_url}/status?id={job_id}"))
        payload = self._payload(body)
        if status != 200:
            raise ServeClientError(f"status failed ({status}): {payload}",
                                   payload)
        return payload

    def wait(self, job_id: str, timeout_s: float = 60.0,
             poll_s: float = 0.05) -> dict:
        """Poll until the job is terminal; returns its final status dict.
        A FAILED job returns normally — callers inspect ``error`` (its
        taxonomy chain tells retryable congestion from poisoned input)."""
        deadline = time.monotonic() + timeout_s
        grace_end = time.monotonic() + self.unknown_grace_s
        while True:
            try:
                st = self.status(job_id)
            except TransportError:
                # A restarting/failing-over replica mid-poll: keep
                # polling (the base URL already rotated) until the
                # caller's own deadline says stop.
                if time.monotonic() > deadline:
                    raise
                self._sleep(poll_s)
                continue
            except ServeClientError as e:
                # An "unknown job" 404 can be a wrong-replica answer
                # rather than a terminal fact: multi-URL clients after
                # a transport rotation (the job lives on the replica
                # that admitted it — rotate onward), and router
                # clients while the admitting replica is dead awaiting
                # recovery (poll through within unknown_grace_s).
                now = time.monotonic()
                if "unknown job" in str(e) and now <= deadline \
                        and (len(self._urls) > 1 or now < grace_end):
                    self._rotate()
                    self._sleep(poll_s)
                    continue
                raise
            if st["status"] in ("done", "failed"):
                return st
            if time.monotonic() > deadline:
                raise ServeClientError(
                    f"job {job_id} still {st['status']} after "
                    f"{timeout_s}s", st)
            time.sleep(poll_s)

    def result(self, job_id: str) -> bytes:
        status, _, body = self._request(urllib.request.Request(
            f"{self.base_url}/result?id={job_id}"))
        if status != 200:
            raise ServeClientError(
                f"result not available ({status})", self._payload(body))
        return body

    def run(self, stack: np.ndarray, result_format: str = "ply",
            timeout_s: float = 60.0) -> tuple[bytes, dict]:
        """submit + wait + fetch; raises on a failed job."""
        job_id = self.submit(stack, result_format=result_format)
        st = self.wait(job_id, timeout_s=timeout_s)
        if st["status"] != "done":
            raise ServeClientError(
                f"job {job_id} failed: {st.get('error')}", st)
        return self.result(job_id), st

    # -- streaming sessions (docs/STREAMING.md) ------------------------

    def create_session(self, **options) -> str:
        """POST /session → session id. ``options`` are the per-session
        overrides the server allows (preview_depth, expected_stops, …)."""
        def once():
            req = urllib.request.Request(
                self.base_url + "/session",
                data=json.dumps(options).encode(),
                headers=self._tenant_headers(
                    {"Content-Type": "application/json"}),
                method="POST")
            status, hdrs, body = self._request(req)
            payload = self._payload(body)
            if status in (429, 503):
                raise BackpressureError(
                    f"session refused ({status})",
                    self._retry_hint(payload, hdrs), payload)
            if status != 200:
                raise ServeClientError(
                    f"create_session failed ({status}): {payload}",
                    payload)
            return payload["session_id"]

        return self._retrying(once)

    def submit_stop(self, session_id: str, stack: np.ndarray) -> str:
        """POST one stop's capture stack into a session; returns the
        stop job id (poll with :meth:`wait` — its result meta carries
        the fuse/skip decision)."""
        stack = np.asarray(stack)
        if stack.dtype != np.uint8:
            raise ServeClientError(
                f"stack must be uint8, got {stack.dtype}")
        buf = io.BytesIO()
        np.save(buf, stack)
        data = buf.getvalue()

        def once():
            req = urllib.request.Request(
                f"{self.base_url}/session/{session_id}/stop",
                data=data,
                headers=self._tenant_headers(
                    {"Content-Type": "application/octet-stream"}),
                method="POST")
            status, hdrs, body = self._request(req)
            payload = self._payload(body)
            if status in (429, 503):
                raise BackpressureError(
                    f"stop refused ({status})",
                    self._retry_hint(payload, hdrs), payload)
            if status != 200:
                raise ServeClientError(
                    f"submit_stop failed ({status}): {payload}", payload)
            return payload["job_id"]

        return self._retrying(once)

    def session_status(self, session_id: str) -> dict:
        status, _, body = self._request(urllib.request.Request(
            f"{self.base_url}/session/{session_id}"))
        payload = self._payload(body)
        if status != 200:
            raise ServeClientError(
                f"session_status failed ({status}): {payload}", payload)
        return payload

    def preview(self, session_id: str) -> tuple[bytes, dict] | None:
        """Latest progressive preview STL, or None before the first
        preview (HTTP 409)."""
        status, hdrs, body = self._request(urllib.request.Request(
            f"{self.base_url}/session/{session_id}/preview"))
        if status == 409:
            return None
        if status != 200:
            raise ServeClientError(
                f"preview failed ({status})", self._payload(body))
        meta = {k[2:].lower().replace("-", "_"): v
                for k, v in hdrs.items() if k.startswith("X-")}
        return body, meta

    def render(self, session_id: str, azim: float = 30.0,
               elev: float = 20.0,
               size: tuple | None = None) -> tuple[bytes, dict] | None:
        """GET /session/<id>/render → (PNG bytes, meta) novel view of
        the session's splat scene (``representation="splat"``), or None
        before the first fused stop (HTTP 409). ``size`` must be one of
        the server's configured (W, H) render sizes."""
        q = f"?az={float(azim)}&el={float(elev)}"
        if size is not None:
            q += f"&w={int(size[0])}&h={int(size[1])}"
        status, hdrs, body = self._request(urllib.request.Request(
            f"{self.base_url}/session/{session_id}/render{q}"))
        if status == 409:
            return None
        if status != 200:
            raise ServeClientError(
                f"render failed ({status})", self._payload(body))
        meta = {k[2:].lower().replace("-", "_"): v
                for k, v in hdrs.items() if k.startswith("X-")}
        return body, meta

    def splats(self, session_id: str) -> bytes | None:
        """GET /session/<id>/splats → the scene .npz (``cli render``
        re-renders it offline), or None before the first stop."""
        status, _, body = self._request(urllib.request.Request(
            f"{self.base_url}/session/{session_id}/splats"))
        if status == 409:
            return None
        if status != 200:
            raise ServeClientError(
                f"splats failed ({status})", self._payload(body))
        return body

    def finalize_session(self, session_id: str,
                         result_format: str = "stl") -> dict:
        """POST finalize; returns {"job_id", "status", "result"} — fetch
        the artifact with :meth:`result`."""
        req = urllib.request.Request(
            f"{self.base_url}/session/{session_id}/finalize",
            data=json.dumps({"result_format": result_format}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        status, _, body = self._request(req)
        payload = self._payload(body)
        if status != 200:
            raise ServeClientError(
                f"finalize failed ({status}): {payload}", payload)
        return payload

    def delete_session(self, session_id: str) -> None:
        req = urllib.request.Request(
            f"{self.base_url}/session/{session_id}", method="DELETE")
        status, _, body = self._request(req)
        if status != 200:
            raise ServeClientError(
                f"delete_session failed ({status})", self._payload(body))

    # ------------------------------------------------------------------

    def healthz(self) -> dict:
        """Liveness: 200 with stats while the process answers."""
        _, _, body = self._request(urllib.request.Request(
            self.base_url + "/healthz"))
        return self._payload(body)

    def readyz(self) -> dict:
        """Readiness: ``{"ready": bool, "reasons": [...]}`` — 503-bodied
        during warmup/recovery, drain, or with no worker lanes alive."""
        _, _, body = self._request(urllib.request.Request(
            self.base_url + "/readyz"))
        return self._payload(body)

    def metrics(self) -> str:
        status, _, body = self._request(urllib.request.Request(
            self.base_url + "/metrics"))
        if status != 200:
            raise ServeClientError(f"metrics failed ({status})")
        return body.decode()
