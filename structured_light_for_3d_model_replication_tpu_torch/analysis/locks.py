"""Lock model: who acquires what, in which order, holding it over what.

The port's copy of the JAX package's ``analysis/locks.py``. Built on
pass 1's :class:`~.callgraph.CallGraph`. Locks are identified
*declaratively* — ``self.X = threading.Lock()/RLock()/Condition(…)`` in a
method body, or a module-level ``X = threading.Lock()`` — and acquisition
sites are ``with <lockexpr>:`` blocks whose expression resolves to a
declared lock:

* ``self.X`` → the enclosing class's lock ``X``;
* a bare ``X`` → the module-level lock;
* ``anything.X`` → the unique class in the project declaring a lock
  attribute ``X`` (cross-object references like ``job._lock`` resolve
  because ``Job`` is the only class with a ``_lock``… when it is not
  unique the site is skipped, never guessed).

``Condition(self.Y)`` aliases to ``Y`` — acquiring the condition IS
acquiring the wrapped lock, so ``with self._not_empty:`` vs
``with self._lock:`` cannot manufacture a phantom ordering.

The model is instance-collapsed (one node per *declaration*, not per
runtime object), which is the usual static compromise: cross-instance
inversions of the same class's lock are invisible (self-edges are
dropped — re-acquisition of one instance and nested acquisition of two
instances are indistinguishable lexically), and ``.acquire()`` /
``.release()`` call pairs are not tracked (only ``with``). The runtime
sanitizer (`utils/sanitize.py`) covers the per-instance cases.
"""

from __future__ import annotations

import ast
import dataclasses

from .callgraph import CallGraph, FunctionInfo
from .rules import dotted

__all__ = ["LockModel", "Acquisition", "LockEdge", "build_lock_model"]

_LOCK_CTORS = {"Lock", "RLock", "threading.Lock", "threading.RLock"}
_CONDITION_CTORS = {"Condition", "threading.Condition"}


@dataclasses.dataclass(frozen=True)
class LockDecl:
    key: str          # "module:Class.attr" | "module:attr"
    rel_path: str
    lineno: int
    reentrant: bool   # RLock


@dataclasses.dataclass
class Acquisition:
    """One ``with <lock>:`` block."""

    key: str
    node: ast.With    # the with statement
    item: ast.expr    # the lock expression
    fn: FunctionInfo


@dataclasses.dataclass
class LockEdge:
    """``held`` was held while ``acquired`` was taken at ``node``.
    ``via`` names the callee chain for interprocedural edges ('' when
    the nested acquisition is in the same function)."""

    held: str
    acquired: str
    node: ast.AST
    fn: FunctionInfo
    via: str = ""


class LockModel:
    def __init__(self, graph: CallGraph):
        self.graph = graph
        self.decls: dict[str, LockDecl] = {}
        self.aliases: dict[str, str] = {}       # condition attr → lock key
        # lock attr name → set of declaring keys (for unique-attr lookup).
        self._by_attr: dict[str, set] = {}
        self.acquisitions: list[Acquisition] = []
        self.edges: list[LockEdge] = []
        # qname → set of lock keys the function may acquire (direct).
        self.direct: dict[str, set] = {}
        # qname → transitive closure over the call graph.
        self.closure: dict[str, set] = {}
        # (lock key, ast.Call, FunctionInfo) for every call made while
        # lexically inside a with-lock body (innermost lock).
        self.calls_under_lock: list[tuple] = []
        # qname → [(start_lineno, end_lineno)] of with-lock statements:
        # the unlocked-shared-state rule checks each ACCESS for lexical
        # containment (per access, not per function — a function that
        # locks one access and forgets the next must still flag).
        self.lock_regions: dict[str, list] = {}

    # -- pass A: declarations ---------------------------------------------

    def _declare(self, key: str, rel_path: str, lineno: int,
                 reentrant: bool) -> None:
        if key not in self.decls:
            self.decls[key] = LockDecl(key, rel_path, lineno, reentrant)
            self._by_attr.setdefault(key.rsplit(".", 1)[-1].split(":")[-1],
                                     set()).add(key)

    def collect_declarations(self) -> None:
        for mod in self.graph.modules.values():
            for stmt in mod.tree.body:
                if isinstance(stmt, ast.Assign) and \
                        isinstance(stmt.value, ast.Call):
                    ctor = dotted(stmt.value.func) or ""
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            self._module_decl(mod, t.id, ctor, stmt)
            for info in self.graph.functions.values():
                if info.module is not mod or info.cls is None:
                    continue
                for node in ast.walk(info.node):
                    if isinstance(node, ast.Assign) and \
                            isinstance(node.value, ast.Call):
                        ctor = dotted(node.value.func) or ""
                        for t in node.targets:
                            if isinstance(t, ast.Attribute) and \
                                    isinstance(t.value, ast.Name) and \
                                    t.value.id == "self":
                                self._attr_decl(mod, info, t.attr, ctor,
                                                node)

    def _module_decl(self, mod, name: str, ctor: str, stmt) -> None:
        if ctor in _LOCK_CTORS:
            self._declare(f"{mod.module}:{name}", mod.rel_path,
                          stmt.lineno, ctor.endswith("RLock"))
        elif ctor in _CONDITION_CTORS:
            self._declare(f"{mod.module}:{name}", mod.rel_path,
                          stmt.lineno, True)

    def _attr_decl(self, mod, info, attr: str, ctor: str, node) -> None:
        key = f"{mod.module}:{info.cls}.{attr}"
        if ctor in _LOCK_CTORS:
            self._declare(key, mod.rel_path, node.lineno,
                          ctor.endswith("RLock"))
        elif ctor in _CONDITION_CTORS:
            # Condition(self.Y) aliases to Y; a bare Condition() is its
            # own (reentrant-ish) lock.
            arg = node.value.args[0] if node.value.args else None
            base = self._resolve_expr(info, arg) if arg is not None \
                else None
            if base is not None:
                self.aliases[key] = base
                self._by_attr.setdefault(attr, set()).add(key)
            else:
                self._declare(key, mod.rel_path, node.lineno, True)

    # -- resolution --------------------------------------------------------

    def _canon(self, key: str | None) -> str | None:
        seen = set()
        while key in self.aliases and key not in seen:
            seen.add(key)
            key = self.aliases[key]
        return key

    def _resolve_expr(self, fn: FunctionInfo,
                      expr: ast.expr) -> str | None:
        mod = fn.module.module
        if isinstance(expr, ast.Name):
            return self._canon_or_none(f"{mod}:{expr.id}")
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and \
                    expr.value.id == "self" and fn.cls:
                key = self._canon_or_none(f"{mod}:{fn.cls}.{expr.attr}")
                if key is not None:
                    return key
            # anything.X → unique declaring class project-wide.
            cands = {self._canon(k)
                     for k in self._by_attr.get(expr.attr, ())}
            if len(cands) == 1:
                return next(iter(cands))
        return None

    def _canon_or_none(self, key: str) -> str | None:
        key = self._canon(key)
        return key if key in self.decls else None

    # -- pass B: acquisitions & edges --------------------------------------

    def collect_acquisitions(self) -> None:
        for info in self.graph.functions.values():
            self._walk_body(info, info.node.body, held=[])

    def _walk_body(self, fn: FunctionInfo, body: list, held: list) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs run later, not under this lock
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                keys_here = []
                for item in stmt.items:
                    key = self._resolve_expr(fn, item.context_expr)
                    if key is not None:
                        self.acquisitions.append(
                            Acquisition(key, stmt, item.context_expr, fn))
                        for h in held + keys_here:
                            if h != key:
                                self.edges.append(
                                    LockEdge(h, key, stmt, fn))
                        keys_here.append(key)
                        self.direct.setdefault(fn.qname, set()).add(key)
                        self.lock_regions.setdefault(fn.qname, []).append(
                            (stmt.lineno,
                             getattr(stmt, "end_lineno", stmt.lineno)))
                    elif held:
                        # Non-lock context expr entered while a lock is
                        # held: `with open(path) as f:` — the call in
                        # the item IS executed under the lock.
                        for node in _walk_skip_lambdas(item.context_expr):
                            if isinstance(node, ast.Call):
                                self.calls_under_lock.append(
                                    (held[-1], node, fn, tuple(held)))
                self._walk_body(fn, stmt.body, held + keys_here)
                continue
            if held:
                # Calls in THIS statement's expressions only — nested
                # statement bodies are covered by the recursion below
                # (and lambda bodies run later, not under this lock).
                for expr in ast.iter_child_nodes(stmt):
                    if not isinstance(expr, ast.expr):
                        continue
                    for node in _walk_skip_lambdas(expr):
                        if isinstance(node, ast.Call):
                            self.calls_under_lock.append(
                                (held[-1], node, fn, tuple(held)))
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list) and sub and \
                        isinstance(sub[0], ast.stmt):
                    self._walk_body(fn, sub, held)
            for handler in getattr(stmt, "handlers", []):
                self._walk_body(fn, handler.body, held)

    # -- pass C: transitive closure + interprocedural edges ----------------

    def compute_closure(self) -> None:
        closure = {q: set(keys) for q, keys in self.direct.items()}
        changed = True
        while changed:
            changed = False
            for q in list(self.graph.functions):
                acc = closure.setdefault(q, set())
                for callee in self.graph.callees.get(q, ()):
                    extra = closure.get(callee, set()) - acc
                    if extra:
                        acc |= extra
                        changed = True
        self.closure = closure

    def interprocedural_edges(self) -> None:
        """held-lock → every lock a callee (transitively) may acquire,
        for calls made inside with-lock bodies."""
        for held, call, fn, _stack in self.calls_under_lock:
            name = dotted(call.func)
            if not name:
                continue
            target = self.graph._resolve(fn.module, fn, name)
            if target is None:
                continue
            for key in self.closure.get(target.qname, ()):
                if key != held:
                    self.edges.append(LockEdge(held, key, call, fn,
                                               via=target.qname))

    # -- queries -----------------------------------------------------------

    def order_graph(self) -> dict[str, set]:
        g: dict[str, set] = {}
        for e in self.edges:
            g.setdefault(e.held, set()).add(e.acquired)
        return g

    def find_cycles(self) -> list[tuple]:
        """Unordered (a, b, edge_ab, edge_ba) pairs where both orders
        exist — the minimal inconsistent-order witness. Longer cycles
        reduce to at least one inverted pair under the pairwise check
        run over the transitive order graph."""
        g = self.order_graph()
        # transitive reachability per node
        reach: dict[str, set] = {}
        for a in g:
            seen, frontier = set(), [a]
            while frontier:
                cur = frontier.pop()
                for nxt in g.get(cur, ()):
                    if nxt not in seen:
                        seen.add(nxt)
                        frontier.append(nxt)
            reach[a] = seen
        out, seen_pairs = [], set()
        for e in self.edges:
            a, b = e.held, e.acquired
            if a == b or (b, a) in seen_pairs or (a, b) in seen_pairs:
                continue
            if a in reach.get(b, ()):  # b can (transitively) reach a
                back = next((x for x in self.edges
                             if x.held == b and x.acquired == a), None)
                out.append((a, b, e, back))
                seen_pairs.add((a, b))
        return out


def _walk_skip_lambdas(expr: ast.expr):
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Lambda):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def build_lock_model(graph: CallGraph) -> LockModel:
    model = LockModel(graph)
    model.collect_declarations()
    model.collect_acquisitions()
    model.compute_closure()
    model.interprocedural_edges()
    return model
