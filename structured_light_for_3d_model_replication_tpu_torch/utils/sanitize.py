"""Runtime sanitizers (``SL_SANITIZE=1``), a host copy of the JAX
package's ``utils/sanitize.py``: checks made at runtime, with zero cost
when off:

* **lock-order checker** — :func:`install` replaces ``threading.Lock`` /
  ``threading.RLock`` with factories returning instrumented locks (only
  for locks CREATED by this package's code or its tests — stdlib and
  third-party lock traffic is left untouched). Every blocking acquire
  records an acquired-while-holding edge in a process-wide order graph;
  an acquire that would close a cycle raises :class:`LockOrderError` at
  the *second* ordering, i.e. before any schedule can actually deadlock.
  Per-instance, so cross-instance orderings are tracked exactly.
* **no-compile region** — :func:`no_compile_region` turns the serve
  steady-state zero-recompile assertion into a reusable guard: it
  installs a scoped :class:`~.telemetry.DeviceTelemetry` listener and
  raises :class:`CompileInRegionError` if more than ``allowed`` program
  builds (the serve ``ProgramCache``'s, :func:`.telemetry.note_compile`)
  landed inside the block.
* **NaN/Inf debug wrap** — :func:`assert_finite` /
  :func:`nan_debug_wrap` check array trees on the host side at
  containment boundaries (the serve worker runs its post-readback
  points through it when sanitizing), so a non-finite triangulation
  fails loudly AT the boundary instead of as a meaningless mesh later.

Enable with ``SL_SANITIZE=1``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import sys
import threading
import _thread

from .log import get_logger

log = get_logger(__name__)

_PKG_MARKERS = ("structured_light_for_3d_model_replication_tpu", "tests")


def enabled() -> bool:
    return os.environ.get("SL_SANITIZE", "").lower() in ("1", "true", "on")


class SanitizerError(RuntimeError):
    """Base of the sanitizer fault vocabulary."""


class LockOrderError(SanitizerError):
    """Acquiring this lock here closes a cycle in the runtime
    acquisition-order graph — a schedule exists that deadlocks."""


class CompileInRegionError(SanitizerError):
    """A program was built inside a region asserted build-free."""


class NonFiniteError(SanitizerError):
    """NaN/Inf where the pipeline contract says finite."""


# ---------------------------------------------------------------------------
# Lock-order checker
# ---------------------------------------------------------------------------


class _OrderGraph:
    """Process-wide acquired-while-holding digraph over sanitized locks.

    Nodes are per-instance (a monotonic id, never reused); edges carry
    the creation sites of both locks for the error message. All state is
    guarded by a RAW lock so the checker cannot recurse into itself."""

    def __init__(self):
        self._mu = _thread.allocate_lock()
        self._edges: dict[int, set] = {}       # a → {b}: a held when b taken
        self._names: dict[int, str] = {}
        self._local = threading.local()

    def register(self, lock_id: int, name: str) -> None:
        with self._mu:
            self._names[lock_id] = name

    def _held(self) -> list:
        if not hasattr(self._local, "held"):
            self._local.held = []
        return self._local.held

    def _reaches(self, src: int, dst: int) -> bool:
        seen, frontier = set(), [src]
        while frontier:
            cur = frontier.pop()
            for nxt in self._edges.get(cur, ()):
                if nxt == dst:
                    return True
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return False

    def before_acquire(self, lock_id: int) -> None:
        """Record edges held→lock_id; raise on a would-be cycle."""
        held = self._held()
        if not held or lock_id in held:
            return  # first lock, or RLock re-entry: no new ordering
        with self._mu:
            for h in held:
                if h == lock_id or lock_id in self._edges.get(h, ()):
                    continue
                if self._reaches(lock_id, h):
                    a = self._names.get(h, f"lock#{h}")
                    b = self._names.get(lock_id, f"lock#{lock_id}")
                    raise LockOrderError(
                        f"lock-order violation: acquiring {b} while "
                        f"holding {a}, but {b} has (transitively) been "
                        f"held while acquiring {a} elsewhere — two "
                        "threads taking both paths deadlock; pick one "
                        "global order (SL_SANITIZE lock checker)")
                self._edges.setdefault(h, set()).add(lock_id)

    def acquired(self, lock_id: int) -> None:
        self._held().append(lock_id)

    def released(self, lock_id: int) -> None:
        held = self._held()
        # Remove the LAST occurrence (RLock depth, out-of-order release).
        for i in range(len(held) - 1, -1, -1):
            if held[i] == lock_id:
                del held[i]
                return

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()


GRAPH = _OrderGraph()
_lock_seq = itertools.count(1)


class _SanitizedLock:
    """Order-checked wrapper over one ``_thread`` lock (or RLock).

    Duck-types the lock protocol (``acquire``/``release``/context
    manager/``locked``) plus the private hooks ``threading.Condition``
    reaches for on reentrant locks."""

    def __init__(self, inner, name: str):
        self._inner = inner
        self._sl_id = next(_lock_seq)
        self._sl_name = name
        GRAPH.register(self._sl_id, name)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking:
            # Only blocking acquires can deadlock; try-locks never wait.
            GRAPH.before_acquire(self._sl_id)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            GRAPH.acquired(self._sl_id)
        return ok

    def release(self) -> None:
        self._inner.release()
        GRAPH.released(self._sl_id)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<sanitized {self._inner!r} from {self._sl_name}>"

    # Condition() integration: delegate the private lock protocol.
    def _release_save(self):
        if hasattr(self._inner, "_release_save"):
            state = self._inner._release_save()
        else:
            self._inner.release()
            state = None
        GRAPH.released(self._sl_id)
        return state

    def _acquire_restore(self, state) -> None:
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        GRAPH.acquired(self._sl_id)

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


def _caller_is_ours(depth: int = 2) -> bool:
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return False
    fname = frame.f_code.co_filename.replace(os.sep, "/")
    return any(m in fname for m in _PKG_MARKERS)


def _site(depth: int = 2) -> str:
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return "<unknown>"
    return f"{os.path.basename(frame.f_code.co_filename)}:" \
           f"{frame.f_lineno}"


_real_lock = threading.Lock
_real_rlock = threading.RLock
_installed = False


def _make_lock():
    if _caller_is_ours():
        return _SanitizedLock(_real_lock(), f"Lock@{_site()}")
    return _real_lock()


def _make_rlock():
    if _caller_is_ours():
        return _SanitizedLock(_real_rlock(), f"RLock@{_site()}")
    return _real_rlock()


def install() -> bool:
    """Patch the ``threading`` lock factories (idempotent). Only locks
    created AFTER install, by this package/tests, are instrumented."""
    global _installed
    if _installed:
        return True
    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    _installed = True
    log.info("SL_SANITIZE lock-order checker installed")
    return True


def uninstall() -> None:
    global _installed
    if _installed:
        threading.Lock = _real_lock
        threading.RLock = _real_rlock
        _installed = False


def install_if_enabled() -> bool:
    if enabled():
        return install()
    return False


# ---------------------------------------------------------------------------
# No-compile region
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def no_compile_region(name: str = "", allowed: int = 0):
    """Assert the enclosed block performs at most ``allowed`` program
    builds (default: none — the serve steady-state bar).

    A scoped DeviceTelemetry (`utils/telemetry.py`) joins the process
    build fan-out for the block's extent. Yields the telemetry, so callers
    can also read ``compiles_total`` mid-region."""
    from . import telemetry, trace

    tel = telemetry.DeviceTelemetry(registry=trace.MetricsRegistry())
    tel.install()
    try:
        yield tel
    finally:
        tel.uninstall()
        compiles = int(tel.compiles_total)
        if compiles > allowed and sys.exc_info()[0] is None:
            raise CompileInRegionError(
                f"no_compile_region({name!r}): {compiles} program "
                f"build(s) inside a region allowing {allowed} — "
                "steady state is rebuilding (off-menu shape? cache "
                "eviction?)")


# ---------------------------------------------------------------------------
# NaN/Inf debug wrap
# ---------------------------------------------------------------------------


def _iter_arrays(tree):
    """Leaves of nested tuples/lists/dicts that look like arrays."""
    if isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _iter_arrays(item)
    elif isinstance(tree, dict):
        for item in tree.values():
            yield from _iter_arrays(item)
    elif hasattr(tree, "dtype") and hasattr(tree, "shape"):
        yield tree


def assert_finite(tree, name: str = "") -> None:
    """Raise :class:`NonFiniteError` if any float array leaf holds a
    NaN/Inf. Host-side (``np.asarray`` readback) — use at containment
    boundaries."""
    import numpy as np

    for arr in _iter_arrays(tree):
        a = np.asarray(arr)
        if a.dtype.kind != "f" or a.size == 0:
            continue
        finite = np.isfinite(a)
        if not bool(finite.all()):
            bad = int(a.size - int(finite.sum()))
            raise NonFiniteError(
                f"assert_finite({name or 'array'}): {bad}/{a.size} "
                f"non-finite element(s) in a {a.shape} {a.dtype} array")


def nan_debug_wrap(fn, name: str | None = None):
    """Wrap ``fn`` so its return tree is finite-checked when the
    sanitizer is enabled; a passthrough otherwise."""
    label = name or getattr(fn, "__name__", "fn")

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        out = fn(*args, **kwargs)
        if enabled():
            assert_finite(out, label)
        return out

    return inner
