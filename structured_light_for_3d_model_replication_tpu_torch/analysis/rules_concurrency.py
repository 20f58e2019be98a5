"""Concurrency rule family: the threaded `serve/`, `hw/` and `gui.py`
hazards.

The port's copy of the JAX package's ``analysis/rules_concurrency.py``:
the port's serve tier (``serve/service.py``, ``router.py``, ``fleet.py``,
``lanes.py``, ``store.py``), ``hw/command_server.py`` and ``gui.py`` are
threaded as the JAX package's are. Three project rules over the
:class:`~.locks.LockModel` and the call graph's thread entry points:

* ``lock-order`` — two locks acquired in both orders somewhere in the
  project (directly or through calls made while holding a lock). The
  static half of the deadlock story; `utils/sanitize.py` is the runtime
  half (per-instance, catches what instance-collapsing hides).
* ``blocking-under-lock`` — file/socket I/O, sleeps, ``.compile()`` /
  ``.lower()``, thread joins or event waits executed while a lock is
  held. One slow call under a hot lock serializes every thread behind
  it (the flight recorder dumps its journal outside the queue lock for
  this reason).
* ``unlocked-shared-state`` — a module-level mutable (list/dict/set)
  that is MUTATED somewhere and reached from more than one thread entry
  point with at least one access outside any lock. Read-only constant
  tables (never mutated project-wide) are exempt.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .callgraph import CallGraph
from .project import ProjectIndex, ProjectRule, register_project
from .rules import dotted

# ---------------------------------------------------------------------------
# lock-order
# ---------------------------------------------------------------------------


@register_project
class LockOrderRule(ProjectRule):
    """Inconsistent lock-acquisition order across the project lock graph.

    Heuristic: declared locks (``self.X = threading.Lock()`` /
    module-level), ``with``-statement acquisitions only, instance-
    collapsed, call edges followed transitively. An inverted pair
    (A held while B taken somewhere, B held while A taken elsewhere) is
    a potential deadlock the moment two threads hit both paths. Blind
    spots: ``.acquire()`` call pairs, per-instance ordering (see
    `utils/sanitize.py`), locks passed as arguments."""

    name = "lock-order"
    description = ("two locks acquired in inconsistent order somewhere "
                   "in the project (potential deadlock)")

    def check_project(self, index: ProjectIndex) -> Iterator:
        model = index.locks
        for a, b, edge_ab, edge_ba in model.find_cycles():
            site = edge_ab.node
            other = ""
            if edge_ba is not None:
                other = (f"; the opposite order is taken at "
                         f"{edge_ba.fn.module.rel_path}:"
                         f"{edge_ba.node.lineno}")
            via = f" (via {edge_ab.via})" if edge_ab.via else ""
            v = self.report(
                index, edge_ab.fn.module.rel_path, site,
                f"lock {b} is acquired{via} while holding "
                f"{a}, but the project also acquires them in "
                f"the opposite order{other} — two threads taking the two "
                "paths concurrently deadlock; pick one global order "
                "(see README.md)")
            if v:
                yield v


# ---------------------------------------------------------------------------
# blocking-under-lock
# ---------------------------------------------------------------------------


_BLOCKING_BARE = {"open", "sleep", "urlopen"}
_BLOCKING_DOTTED_TAILS = {
    "sleep", "urlopen", "makedirs", "compile", "lower",
    "write_text", "read_text", "read_bytes", "write_bytes",
    "recv", "accept", "connect", "sendall",
    "run", "check_call", "check_output", "Popen",
}
_BLOCKING_DOTTED_HEADS = {"time", "subprocess", "socket", "os", "shutil",
                          "urllib"}
# Dotted-call tails that block regardless of the object (the flight-
# recorder journal write, thread joins on *thread-like* attributes).
_WAIT_TAIL = "wait"
_DUMP_TAILS = {"dump", "export", "export_perfetto"}


@register_project
class BlockingUnderLockRule(ProjectRule):
    """A blocking call while holding a lock serializes every contender.

    Flags, lexically inside a ``with <lock>:`` body: ``open()``/
    ``time.sleep``/``urllib``/``socket``/``subprocess``/``os.makedirs``-
    class calls; ``.compile()``/``.lower()`` (a program build is seconds);
    ``.wait(...)`` on anything OTHER than the condition being held
    (waiting on an event while holding an unrelated lock is a classic
    ordering bug); and flight-recorder/tracer ``.dump()``/``.export*()``
    journal writes. Calls made *by callees* are not followed (the
    lock-order rule follows calls; this one is about the lexically
    obvious cases where the fix is local: move the I/O out of the
    critical section)."""

    name = "blocking-under-lock"
    description = ("blocking call (I/O, sleep, compile, wait, journal "
                   "dump) while holding a lock")

    def check_project(self, index: ProjectIndex) -> Iterator:
        model = index.locks
        seen: set[tuple] = set()
        for held_key, call, fn, held_stack in model.calls_under_lock:
            msg = self._classify(call, fn, model, held_stack)
            if msg is None:
                continue
            site = (fn.module.rel_path, call.lineno, call.col_offset)
            if site in seen:
                continue
            seen.add(site)
            v = self.report(
                index, fn.module.rel_path, call,
                f"{msg} while holding lock {held_key} — every "
                "thread contending for it stalls behind this call; move "
                "it outside the critical section")
            if v:
                yield v

    def _classify(self, call: ast.Call, fn, model, held_stack):
        f = call.func
        name = dotted(f) or ""
        if isinstance(f, ast.Name) and f.id in _BLOCKING_BARE:
            return f"{f.id}() blocks"
        if isinstance(f, ast.Attribute):
            tail = f.attr
            head = name.split(".")[0] if name else ""
            if tail in _BLOCKING_DOTTED_TAILS and \
                    head in _BLOCKING_DOTTED_HEADS:
                return f"{name}() blocks"
            if tail in ("compile", "lower") and head != "re":
                return f".{tail}() builds a program (seconds)"
            if tail in _DUMP_TAILS and not name.startswith("json."):
                return f".{tail}() writes a journal/trace to disk"
            if tail == _WAIT_TAIL:
                # Waiting on the held condition itself is the Condition
                # protocol (it releases the lock); waiting on anything
                # else keeps the lock held for the wait's duration.
                waited = model._resolve_expr(fn, f.value)
                if waited is not None and waited in held_stack:
                    return None
                return f"{dotted(f.value) or '<expr>'}.wait() blocks"
        return None


# ---------------------------------------------------------------------------
# unlocked-shared-state
# ---------------------------------------------------------------------------


_MUTATORS = {"append", "extend", "insert", "remove", "pop", "popleft",
             "clear", "update", "setdefault", "add", "discard",
             "appendleft"}


def _module_mutables(mod) -> dict[str, int]:
    """Module-level list/dict/set assignments: name → lineno."""
    out: dict[str, int] = {}
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign):
            targets = [t for t in stmt.targets if isinstance(t, ast.Name)]
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and \
                isinstance(stmt.target, ast.Name) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        if isinstance(value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                              ast.DictComp, ast.SetComp)) or (
                isinstance(value, ast.Call)
                and (dotted(value.func) or "").split(".")[-1] in
                ("list", "dict", "set", "defaultdict", "OrderedDict",
                 "deque", "bytearray")):
            for t in targets:
                out[t.id] = stmt.lineno
    return out


def _is_mutated(mod, name: str) -> bool:
    """Is the module global ever written/mutated (vs a constant table)?
    Assignment targets beyond the initializer, subscript/del stores,
    ``global`` rebinding, or a mutating method call."""
    initializer_seen = False
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Name) and node.id == name and \
                isinstance(node.ctx, (ast.Store, ast.Del)):
            if not initializer_seen:
                initializer_seen = True
            else:
                return True
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == name and \
                isinstance(node.ctx, (ast.Store, ast.Del)):
            return True
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == name and \
                node.func.attr in _MUTATORS:
            return True
        elif isinstance(node, ast.Global) and name in node.names:
            return True
    return False


@register_project
class UnlockedSharedStateRule(ProjectRule):
    """Module-level mutable state reached from >1 thread entry point with
    some access outside any lock.

    Thread entry points are pass 1's roots (``Thread(target=…)``,
    ``Thread.run``, HTTP ``do_*`` handlers); functions reachable from no
    root collapse into one implicit "main thread" entry. A global that
    is never mutated project-wide is a constant table, not state.
    Guardedness is lexical per access (inside some ``with <lock>:``) —
    the rule does not prove the SAME lock guards every access; it only
    accepts state whose every access is under some lock (the lock-order
    rule polices lock identity confusion)."""

    name = "unlocked-shared-state"
    description = ("module-level mutable reached from >1 thread entry "
                   "point with at least one unguarded access")
    path_filter = ()

    def check_project(self, index: ProjectIndex) -> Iterator:
        graph: CallGraph = index.graph
        model = index.locks
        reach = {root: graph.reachable(root)
                 for root in graph.thread_roots}
        for mod in graph.modules.values():
            mutables = _module_mutables(mod)
            if not mutables:
                continue
            hot = {n for n in mutables if _is_mutated(mod, n)}
            if not hot:
                continue
            # name → (entries, unguarded access site or None)
            uses: dict[str, tuple[set, ast.AST | None]] = {}
            for info in graph.functions.values():
                if info.module is not mod:
                    continue
                local = _local_bindings(info.node)
                regions = model.lock_regions.get(info.qname, ())
                entries = {r for r, seen in reach.items()
                           if info.qname in seen} or {"<main>"}
                for node in ast.walk(info.node):
                    if isinstance(node, ast.Name) and node.id in hot \
                            and node.id not in local:
                        ents, site = uses.get(node.id, (set(), None))
                        ents = ents | entries
                        # Guardedness is per ACCESS: lexically inside
                        # some with-lock region of this function.
                        guarded = any(s <= node.lineno <= e
                                      for s, e in regions)
                        if not guarded and site is None:
                            site = node
                        uses[node.id] = (ents, site)
            for name, (entries, site) in sorted(uses.items()):
                if len(entries) < 2 or site is None:
                    continue
                roots = ", ".join(sorted(e.split(":")[-1]
                                         for e in entries))
                v = self.report(
                    index, mod.rel_path, site,
                    f"module-level mutable {name!r} (defined at line "
                    f"{mutables[name]}) is reached from {len(entries)} "
                    f"thread entry points ({roots}) and this access is "
                    "outside any lock — guard every access with one "
                    "lock or make the structure immutable")
                if v:
                    yield v


def _local_bindings(fn) -> set:
    names = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                             + fn.args.kwonlyargs)}
    if fn.args.vararg:
        names.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        names.add(fn.args.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
    return names
