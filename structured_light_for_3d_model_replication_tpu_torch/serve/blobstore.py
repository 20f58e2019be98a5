"""Pluggable blob/object-store backend for the fleet's shared state.

PR 9's fleet tier shares session-handoff streams (and, optionally,
content-cache artifacts) through one POSIX directory — which makes "a
fleet" secretly mean "replicas mounting one filesystem volume". This
module extracts the storage seam: :class:`BlobStore` is the small
interface `store.SessionStreamStore` and `cache.ContentCache` actually
need, with two implementations —

* :class:`LocalDirStore` — the historical shared-directory layout,
  preserved bit-for-bit (same tmp + atomic-rename writes, same file
  names), so existing deployments and every on-disk assertion in the
  test suite see identical bytes;
* :class:`ObjectStore` — an S3-style flat key→bytes namespace over a
  tiny client protocol (``put/get/delete/list/append/head``). The
  in-process :class:`InMemoryObjectClient` and the stdlib
  :class:`ObjectStoreServer` + :class:`HTTPObjectClient` pair (a
  mini object service the fleet smoke runs replicas against across
  processes) are the reference backends; a real S3/GCS client only has
  to speak the same six calls. ``append`` is served atomically by these
  backends — a production S3 adapter would emulate it with per-record
  objects or multipart compose; the stream readers already tolerate
  interleaves and torn tails either way.

Failure posture: a missing object is ``None`` (or a no-op delete),
never an exception; every infrastructure failure is an ``OSError`` —
exactly what the WAL mirror containment, the content-cache quarantine
and the adoption degrade paths already catch. A store failure may
therefore degrade DURABILITY (shorter handoff stream, cache miss) but
never availability — the property :class:`FaultyBlobStore` (seeded
latency / errors / torn writes, ``SL_BLOB_FAULTS`` env for subprocess
replicas, hw/faults.py's determinism rule) exists to prove under chaos.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.log import get_logger

log = get_logger(__name__)

#: Env var carrying a JSON :class:`BlobFaultPlan` for subprocess
#: replicas (the chaos harness sets it; production never does).
BLOB_FAULTS_ENV = "SL_BLOB_FAULTS"


def _check_key(key: str) -> str:
    """Keys are "/"-joined relative names. Reject anything that could
    escape a local root (the object backends are flat namespaces, but
    one validation serves both)."""
    if not key or key.startswith("/") or ".." in key.split("/"):
        raise ValueError(f"bad blob key {key!r}")
    return key


class BlobStore:
    """The storage seam: whole-object put/get/delete/list plus ordered
    ``append`` (log semantics — session streams) and atomic ``replace``
    (tombstone rewrites). Missing objects read as None; infrastructure
    failures raise OSError."""

    backend = "abstract"

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def append(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def replace(self, key: str, data: bytes) -> None:
        """Atomically swap the whole object (default: a plain put —
        object backends overwrite atomically by construction)."""
        self.put(key, data)

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        """Move one object (quarantine paths). Missing src is OSError."""
        data = self.get(src)
        if data is None:
            raise FileNotFoundError(src)
        self.put(dst, data)
        self.delete(src)

    def list(self, prefix: str = "") -> list[str]:
        raise NotImplementedError

    def size(self, key: str) -> int | None:
        data = self.get(key)
        return None if data is None else len(data)

    def stats(self) -> dict:
        return {"backend": self.backend}


# ---------------------------------------------------------------------------
# Local directory backend (the historical shared-volume layout)
# ---------------------------------------------------------------------------


class LocalDirStore(BlobStore):
    """Keys are relative paths under ``root``. Writes are tmp + atomic
    rename (a torn put can never be mistaken for an object); appends are
    single buffered writes in append mode, flushed — the same
    atomic-enough discipline `SessionStreamStore` always used, so this
    backend reproduces the PR-9 on-disk layout byte for byte."""

    backend = "file"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *_check_key(key).split("/"))

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def get(self, key: str) -> bytes | None:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except (FileNotFoundError, IsADirectoryError):
            return None

    def append(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "ab") as f:
            f.write(data)
            f.flush()

    def replace(self, key: str, data: bytes) -> None:
        self.put(key, data)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def rename(self, src: str, dst: str) -> None:
        dpath = self._path(dst)
        os.makedirs(os.path.dirname(dpath), exist_ok=True)
        os.replace(self._path(src), dpath)

    def list(self, prefix: str = "") -> list[str]:
        # Walk only the subtree the prefix's directory part names, not
        # the whole root: a stats-path listing of "quarantine/" must
        # stay proportional to the quarantine, not to every artifact.
        if prefix and ".." in prefix.split("/"):
            raise ValueError(f"bad list prefix {prefix!r}")
        dir_part = prefix.rpartition("/")[0]
        start = (os.path.join(self.root, *dir_part.split("/"))
                 if dir_part else self.root)
        out: list[str] = []
        for dirpath, _, names in os.walk(start):
            rel = os.path.relpath(dirpath, self.root)
            base = "" if rel == "." else rel.replace(os.sep, "/") + "/"
            for n in names:
                key = base + n
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def size(self, key: str) -> int | None:
        try:
            return os.path.getsize(self._path(key))
        except OSError:
            return None

    def stats(self) -> dict:
        return {"backend": self.backend, "root": self.root}


# ---------------------------------------------------------------------------
# Object backends (S3-style flat namespace over a six-call client)
# ---------------------------------------------------------------------------


class InMemoryObjectClient:
    """Dict-backed object client — the stdlib in-process fake. Appends
    are atomic under the lock (the "server-side append" contract the
    ObjectStore docstring describes)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objects: dict[str, bytes] = {}

    def put_object(self, key: str, data: bytes) -> None:
        with self._lock:
            self._objects[key] = bytes(data)

    def get_object(self, key: str) -> bytes | None:
        with self._lock:
            return self._objects.get(key)

    def append_object(self, key: str, data: bytes) -> None:
        with self._lock:
            self._objects[key] = self._objects.get(key, b"") + bytes(data)

    def delete_object(self, key: str) -> None:
        with self._lock:
            self._objects.pop(key, None)

    def list_objects(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def head_object(self, key: str) -> int | None:
        with self._lock:
            data = self._objects.get(key)
            return None if data is None else len(data)


class _ObjectHandler(BaseHTTPRequestHandler):
    client: InMemoryObjectClient  # bound by ObjectStoreServer

    protocol_version = "HTTP/1.1"
    timeout = 30.0

    def _key(self) -> str | None:
        path = urllib.parse.urlparse(self.path).path
        if not path.startswith("/o/"):
            return None
        return urllib.parse.unquote(path[len("/o/"):])

    def _respond(self, status: int, body: bytes = b"",
                 extra: dict | None = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", "application/octet-stream")
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n) if n > 0 else b""

    def do_PUT(self):
        key = self._key()
        if key is None:
            self._respond(404)
            return
        self.client.put_object(key, self._body())
        self._respond(200)

    def do_POST(self):  # append
        key = self._key()
        if key is None:
            self._respond(404)
            return
        self.client.append_object(key, self._body())
        self._respond(200)

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        if url.path == "/list":
            prefix = (urllib.parse.parse_qs(url.query).get("prefix")
                      or [""])[0]
            body = json.dumps(self.client.list_objects(prefix)).encode()
            self._respond(200, body, {"Content-Type": "application/json"})
            return
        key = self._key()
        data = self.client.get_object(key) if key is not None else None
        if data is None:
            self._respond(404)
        else:
            self._respond(200, data)

    def do_HEAD(self):
        key = self._key()
        n = self.client.head_object(key) if key is not None else None
        if n is None:
            self._respond(404)
        else:
            self.send_response(200)
            self.send_header("Content-Length", str(n))
            self.end_headers()

    def do_DELETE(self):
        key = self._key()
        if key is not None:
            self.client.delete_object(key)
        self._respond(200)

    def log_message(self, fmt, *args):
        log.debug("objectstore: " + fmt, *args)


class ObjectStoreServer:
    """A mini object service over HTTP (stdlib, like every other server
    in this repo): the cross-process fake the fleet smoke runs replicas
    against, so "no shared filesystem" is provable with subprocesses.
    NOT a production store — it exists to exercise the ObjectStore code
    path end to end."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 client: InMemoryObjectClient | None = None):
        self.client = client if client is not None \
            else InMemoryObjectClient()
        handler = type("BoundObjectHandler", (_ObjectHandler,),
                       {"client": self.client})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="objectstore-http",
                                        daemon=True)
        self._started = False

    def start(self) -> "ObjectStoreServer":
        self._thread.start()
        self._started = True
        log.info("object store on :%d", self.port)
        return self

    def stop(self) -> None:
        if self._started:
            self._httpd.shutdown()
        self._httpd.server_close()


class HTTPObjectClient:
    """Client half of :class:`ObjectStoreServer`'s protocol. Connection
    failures surface as OSError (urllib.error.URLError subclasses it);
    5xx answers become OSError too — both are store faults the callers'
    containment handles."""

    def __init__(self, base_url: str, timeout_s: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)

    def _request(self, method: str, path: str, body: bytes | None = None
                 ) -> tuple[int, dict, bytes]:
        req = urllib.request.Request(self.base_url + path, data=body,
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            if e.code >= 500:
                raise OSError(f"object store {method} {path}: "
                              f"HTTP {e.code}")
            return e.code, dict(e.headers), e.read()

    @staticmethod
    def _opath(key: str) -> str:
        return "/o/" + urllib.parse.quote(key, safe="/")

    def put_object(self, key: str, data: bytes) -> None:
        self._request("PUT", self._opath(key), data)

    def get_object(self, key: str) -> bytes | None:
        status, _, body = self._request("GET", self._opath(key))
        return body if status == 200 else None

    def append_object(self, key: str, data: bytes) -> None:
        self._request("POST", self._opath(key), data)

    def delete_object(self, key: str) -> None:
        self._request("DELETE", self._opath(key))

    def list_objects(self, prefix: str = "") -> list[str]:
        status, _, body = self._request(
            "GET", "/list?prefix=" + urllib.parse.quote(prefix, safe=""))
        if status != 200:
            raise OSError(f"object store list: HTTP {status}")
        return list(json.loads(body.decode()))

    def head_object(self, key: str) -> int | None:
        status, hdrs, _ = self._request("HEAD", self._opath(key))
        if status != 200:
            return None
        return int(hdrs.get("Content-Length", 0))


class ObjectStore(BlobStore):
    """BlobStore over a six-call object client (in-memory fake, the
    HTTP mini-service, or a real S3-style adapter)."""

    backend = "object"

    def __init__(self, client, prefix: str = ""):
        self.client = client
        self.prefix = prefix.strip("/")

    def _key(self, key: str) -> str:
        key = _check_key(key)
        return f"{self.prefix}/{key}" if self.prefix else key

    def put(self, key: str, data: bytes) -> None:
        self.client.put_object(self._key(key), data)

    def get(self, key: str) -> bytes | None:
        return self.client.get_object(self._key(key))

    def append(self, key: str, data: bytes) -> None:
        self.client.append_object(self._key(key), data)

    def delete(self, key: str) -> None:
        self.client.delete_object(self._key(key))

    def list(self, prefix: str = "") -> list[str]:
        full = (f"{self.prefix}/{prefix}" if self.prefix else prefix)
        strip = len(self.prefix) + 1 if self.prefix else 0
        return [k[strip:] for k in self.client.list_objects(full)]

    def size(self, key: str) -> int | None:
        return self.client.head_object(self._key(key))

    def stats(self) -> dict:
        return {"backend": self.backend,
                "url": getattr(self.client, "base_url", "memory")}


# ---------------------------------------------------------------------------
# Fault injection (the chaos harness's storage seam)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlobFaultPlan:
    """Seeded store-fault schedule: a deterministic fraction of
    operations errors (OSError), is delayed, and/or — for writes —
    lands TORN (a truncated payload persisted while the call still
    reports success: the bit the durability counters must absorb and
    the readers' torn-line/size-check tolerance must survive). One RNG
    stream per store — same seed, same fault sequence (hw/faults.py's
    determinism rule applied to storage)."""

    seed: int = 0
    error_rate: float = 0.0       # P(op raises OSError)
    latency_s: float = 0.0        # injected delay when latency fires
    latency_rate: float = 0.0     # P(latency_s is injected)
    torn_write_rate: float = 0.0  # P(a write persists truncated)

    @classmethod
    def from_env(cls, env: str = BLOB_FAULTS_ENV) -> "BlobFaultPlan | None":
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


class FaultyBlobStore(BlobStore):
    """Wraps any BlobStore with a :class:`BlobFaultPlan`. ``sleep`` is
    injectable so unit tests assert latency decisions without waiting."""

    backend = "faulty"

    def __init__(self, inner: BlobStore, plan: BlobFaultPlan,
                 sleep=time.sleep):
        self.inner = inner
        self.plan = plan
        self._sleep = sleep
        self._lock = threading.Lock()  # one deterministic RNG stream
        self._rng = random.Random(plan.seed)
        self.errors = 0
        self.delays = 0
        self.torn_writes = 0

    def _roll(self, writing: bool) -> tuple[bool, bool, float]:
        """(error, delay, torn_frac) for one op; torn_frac < 0 = whole."""
        with self._lock:
            error = self._rng.random() < self.plan.error_rate
            delay = (not error
                     and self._rng.random() < self.plan.latency_rate)
            torn = -1.0
            if writing and not error \
                    and self._rng.random() < self.plan.torn_write_rate:
                torn = self._rng.random()
            if error:
                self.errors += 1
            if delay:
                self.delays += 1
            if torn >= 0.0:
                self.torn_writes += 1
        return error, delay, torn

    def _enter(self, writing: bool = False) -> float:
        error, delay, torn = self._roll(writing)
        if delay:
            self._sleep(self.plan.latency_s)
        if error:
            raise OSError("injected blob-store fault")
        return torn

    def _maim(self, data: bytes, torn: float) -> bytes:
        if torn < 0.0 or not data:
            return data
        return data[:int(len(data) * torn)]

    def put(self, key, data):
        self.inner.put(key, self._maim(data, self._enter(writing=True)))

    def get(self, key):
        self._enter()
        return self.inner.get(key)

    def append(self, key, data):
        self.inner.append(key, self._maim(data, self._enter(writing=True)))

    def replace(self, key, data):
        self.inner.replace(key,
                           self._maim(data, self._enter(writing=True)))

    def delete(self, key):
        self._enter()
        self.inner.delete(key)

    def rename(self, src, dst):
        self._enter()
        self.inner.rename(src, dst)

    def list(self, prefix=""):
        self._enter()
        return self.inner.list(prefix)

    def size(self, key):
        self._enter()
        return self.inner.size(key)

    def stats(self) -> dict:
        out = dict(self.inner.stats())
        out.update(backend=f"faulty+{self.inner.backend}",
                   injected_errors=self.errors,
                   injected_delays=self.delays,
                   injected_torn_writes=self.torn_writes)
        return out


# ---------------------------------------------------------------------------
# Spec parsing (the config/CLI seam)
# ---------------------------------------------------------------------------


def open_blob_store(spec: str, allow_faults: bool = True) -> BlobStore:
    """A BlobStore from a spec string: ``http(s)://host:port[/prefix]``
    → :class:`ObjectStore` over the HTTP protocol, ``mem:`` → a private
    in-process object store (unit tests), anything else (optionally
    ``file:``-prefixed) → :class:`LocalDirStore` on that directory —
    which is why every existing ``--handoff-dir /path`` deployment keeps
    its exact on-disk layout. When the chaos harness armed
    ``SL_BLOB_FAULTS`` the store is wrapped in a
    :class:`FaultyBlobStore` (disable with ``allow_faults=False``)."""
    if spec.startswith(("http://", "https://")):
        url = urllib.parse.urlparse(spec)
        base = f"{url.scheme}://{url.netloc}"
        store: BlobStore = ObjectStore(HTTPObjectClient(base),
                                       prefix=url.path.strip("/"))
    elif spec.startswith("mem:"):
        store = ObjectStore(InMemoryObjectClient(),
                            prefix=spec[len("mem:"):].strip("/"))
    else:
        if spec.startswith("file:"):
            spec = spec[len("file:"):]
        store = LocalDirStore(spec)
    if allow_faults:
        plan = BlobFaultPlan.from_env()
        if plan is not None:
            log.warning("blob-store faults armed: %s", plan)
            store = FaultyBlobStore(store, plan)
    return store
