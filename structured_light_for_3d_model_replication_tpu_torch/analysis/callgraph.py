"""Pass 1 of the project engine: cross-module symbol table + call graph.

The port's copy of the JAX package's ``analysis/callgraph.py``, less its
jit bookkeeping (the port traces nothing, and no port rule asks). The
lexical rules (:mod:`.rules`) see one file at a time; lock-order
inversions across ``serve/`` and shared mutable state reached from
several thread entry points are only visible with a project-wide view.
This module builds that view, still AST-only and stdlib-only:

* **modules** — every parsed file with its dotted module name and an
  import alias table (``trace`` → ``pkg.utils.trace``), resolved through
  relative imports.
* **functions** — every function/method with its parameters and the
  calls it makes (dotted, unresolved).
* **call graph** — best-effort resolution of callsites to project
  functions: bare names to the same module, ``self.m()`` to the same
  class, ``alias.f()`` through the import table. Unresolvable calls
  (dynamic dispatch, external libraries) are simply absent — every
  consumer of the graph must treat it as an under-approximation.
* **thread entry points** — functions handed to ``threading.Thread(
  target=…)``, ``run()`` methods of ``Thread`` subclasses, and
  ``do_GET``-style handler methods of ``BaseHTTPRequestHandler``
  subclasses (each request runs on its own thread under
  ``ThreadingHTTPServer``). Reachability from these roots is what the
  concurrency rules consume.
"""

from __future__ import annotations

import ast
import dataclasses

from .rules import dotted

__all__ = ["FunctionInfo", "ModuleInfo", "CallGraph"]

_HANDLER_METHODS = ("do_GET", "do_POST", "do_PUT", "do_DELETE", "do_HEAD",
                    "do_PATCH")
_THREAD_BASES = {"Thread", "threading.Thread"}
_HANDLER_BASES = {"BaseHTTPRequestHandler", "StreamRequestHandler",
                  "BaseRequestHandler"}


def module_name(rel_path: str) -> str:
    """'pkg/serve/jobs.py' → 'pkg.serve.jobs' ('pkg/__init__.py' → 'pkg')."""
    parts = rel_path[:-3].split("/") if rel_path.endswith(".py") \
        else rel_path.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


@dataclasses.dataclass
class ModuleInfo:
    rel_path: str
    module: str                      # dotted name
    tree: ast.Module
    # local alias → fully dotted target ("trace" → "pkg.utils.trace",
    # "Job" → "pkg.serve.jobs.Job").
    imports: dict = dataclasses.field(default_factory=dict)
    # top-level function / class names defined here.
    defs: set = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class FunctionInfo:
    """One function or method, with everything pass 2 asks about."""

    qname: str                       # "pkg.mod:Class.meth" | "pkg.mod:fn"
    module: ModuleInfo
    node: ast.AST                    # FunctionDef | AsyncFunctionDef
    cls: str | None = None           # enclosing class name
    params: tuple = ()               # positional-or-keyword parameter names
    # [(dotted callee text, ast.Call)] — unresolved callsites.
    calls: list = dataclasses.field(default_factory=list)

    @property
    def name(self) -> str:
        return self.node.name


def _package_of(module: str, is_init: bool) -> str:
    if is_init:
        return module
    return module.rpartition(".")[0]


def _resolve_relative(package: str, level: int, mod: str | None) -> str:
    """Absolute dotted target of ``from <level dots><mod> import …``."""
    parts = package.split(".") if package else []
    if level > 1:
        parts = parts[: max(0, len(parts) - (level - 1))]
    if mod:
        parts += mod.split(".")
    return ".".join(parts)


def _collect_imports(info: ModuleInfo, is_init: bool) -> None:
    package = _package_of(info.module, is_init)
    for node in ast.walk(info.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                target = alias.name if alias.asname else \
                    alias.name.split(".")[0]
                info.imports[name] = target
        elif isinstance(node, ast.ImportFrom):
            base = (_resolve_relative(package, node.level, node.module)
                    if node.level else (node.module or ""))
            for alias in node.names:
                if alias.name == "*":
                    continue
                name = alias.asname or alias.name
                info.imports[name] = (f"{base}.{alias.name}" if base
                                      else alias.name)


def _function_info(mod: ModuleInfo, fn, cls: str | None) -> FunctionInfo:
    qual = f"{cls}.{fn.name}" if cls else fn.name
    info = FunctionInfo(qname=f"{mod.module}:{qual}", module=mod, node=fn,
                        cls=cls,
                        params=tuple(a.arg for a in (fn.args.posonlyargs
                                                     + fn.args.args
                                                     + fn.args.kwonlyargs)))
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            if name:
                info.calls.append((name, node))
    return info


class CallGraph:
    """The project symbol table + resolved call edges + thread roots."""

    def __init__(self):
        self.modules: dict[str, ModuleInfo] = {}      # rel_path → info
        self.by_module: dict[str, ModuleInfo] = {}    # dotted → info
        self.functions: dict[str, FunctionInfo] = {}  # qname → info
        # caller qname → set of callee qnames.
        self.callees: dict[str, set] = {}
        self.thread_roots: set[str] = set()
        # "module:Class" for every project class.
        self.classes: set[str] = set()
        # ("module:Class", attr) → "module:Class" — inferred instance-
        # attribute types (self.x = Ctor(...) / self.x = annotated_param).
        self.attr_types: dict[tuple, str] = {}
        # method name → set of "module:Class.method" (unique-name
        # fallback resolution for obj.method() calls).
        self._methods_by_name: dict[str, set] = {}

    # -- building ----------------------------------------------------------

    def add_module(self, rel_path: str, tree: ast.Module) -> ModuleInfo:
        mod = ModuleInfo(rel_path=rel_path, module=module_name(rel_path),
                         tree=tree)
        _collect_imports(mod, rel_path.endswith("__init__.py"))
        self.modules[rel_path] = mod
        self.by_module[mod.module] = mod
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                mod.defs.add(stmt.name)
        # Functions: top-level and one class level deep (methods).
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(mod, stmt, None)
            elif isinstance(stmt, ast.ClassDef):
                self.classes.add(f"{mod.module}:{stmt.name}")
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self._add_function(mod, sub, stmt.name)
        return mod

    def _add_function(self, mod: ModuleInfo, fn, cls: str | None) -> None:
        info = _function_info(mod, fn, cls)
        self.functions[info.qname] = info
        if cls is not None:
            self._methods_by_name.setdefault(fn.name, set()).add(
                info.qname)

    def _resolve_class(self, mod: ModuleInfo, name: str) -> str | None:
        """Dotted expression text → 'module:Class' when it names a
        project class (directly or through the import table)."""
        if not name:
            return None
        if f"{mod.module}:{name}" in self.classes:
            return f"{mod.module}:{name}"
        head, _, rest = name.partition(".")
        target = mod.imports.get(head)
        if target is None:
            return None
        full = f"{target}.{rest}" if rest else target
        mod_part, _, cls_part = full.rpartition(".")
        key = f"{mod_part}:{cls_part}"
        return key if key in self.classes else None

    def _infer_attr_types(self) -> None:
        """self.x = Ctor(...) and self.x = <annotated ctor param> give
        instance attributes a class, so self.x.m() / obj.x.m() chains
        resolve to real methods."""
        for info in self.functions.values():
            if info.cls is None:
                continue
            owner = f"{info.module.module}:{info.cls}"
            ann = {}
            args = info.node.args
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                if a.annotation is not None:
                    text = None
                    if isinstance(a.annotation, ast.Constant) and \
                            isinstance(a.annotation.value, str):
                        text = a.annotation.value.strip().split("|")[0] \
                            .strip().strip('"')
                    else:
                        text = dotted(a.annotation)
                    if text:
                        ann[a.arg] = text
            for node in ast.walk(info.node):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    cls_key = None
                    if isinstance(node.value, ast.Call):
                        cls_key = self._resolve_class(
                            info.module, dotted(node.value.func) or "")
                    elif isinstance(node.value, ast.Name) and \
                            node.value.id in ann:
                        cls_key = self._resolve_class(
                            info.module, ann[node.value.id])
                    if cls_key is not None:
                        self.attr_types[(owner, t.attr)] = cls_key

    def finalize(self) -> None:
        """Resolve call edges and thread roots (after every module is in)."""
        self._infer_attr_types()
        for info in self.functions.values():
            for name, call in info.calls:
                target = self._resolve(info.module, info, name)
                if target is not None:
                    self.callees.setdefault(info.qname, set()).add(
                        target.qname)
                if name.split(".")[-1] == "Thread":
                    self._thread_target(info, call)
        for info in self.functions.values():
            if info.cls is None:
                continue
            cls_node = next((s for s in info.module.tree.body
                             if isinstance(s, ast.ClassDef)
                             and s.name == info.cls), None)
            bases = {dotted(b) or "" for b in cls_node.bases} \
                if cls_node else set()
            base_tails = {b.split(".")[-1] for b in bases}
            if info.name == "run" and base_tails & _THREAD_BASES:
                self.thread_roots.add(info.qname)
            if info.name in _HANDLER_METHODS and (
                    base_tails & _HANDLER_BASES
                    or any(b.endswith("Handler") for b in base_tails)):
                self.thread_roots.add(info.qname)

    def _thread_target(self, caller: FunctionInfo, call: ast.Call) -> None:
        target_expr = next((k.value for k in call.keywords
                            if k.arg == "target"), None)
        if target_expr is None:
            return
        resolved = self._resolve(caller.module, caller,
                                 dotted(target_expr) or "")
        if resolved is not None:
            self.thread_roots.add(resolved.qname)

    # -- resolution --------------------------------------------------------

    # Method names too generic for the unique-name fallback: they
    # collide with dict/list/set/str/file/threading builtins, so a
    # lexical match would mis-resolve container calls to project code.
    _GENERIC_METHODS = frozenset({
        "get", "pop", "append", "add", "update", "clear", "remove",
        "extend", "insert", "discard", "copy", "read", "write", "close",
        "flush", "keys", "values", "items", "setdefault", "popleft",
        "appendleft", "sort", "split", "join", "strip", "format",
        "encode", "decode", "wait", "set", "start", "run", "put",
        "send", "recv", "acquire", "release", "item", "mean", "sum",
        "reshape", "astype", "count", "index", "search", "match",
        "group", "open", "seek", "tell", "getvalue", "inc", "dec",
    })

    def _resolve(self, mod: ModuleInfo, caller: FunctionInfo | None,
                 name: str) -> FunctionInfo | None:
        """Best-effort: a dotted callsite text → a project FunctionInfo."""
        if not name:
            return None
        head, _, rest = name.partition(".")
        # self.m() → method of the caller's class (same module);
        # self.attr[.attr…].m() → through the inferred attribute types.
        if head == "self" and caller is not None and caller.cls and rest:
            parts = rest.split(".")
            if len(parts) == 1:
                return self.functions.get(
                    f"{mod.module}:{caller.cls}.{parts[0]}")
            cur = f"{mod.module}:{caller.cls}"
            for attr in parts[:-1]:
                cur = self.attr_types.get((cur, attr))
                if cur is None:
                    break
            if cur is not None:
                hit = self.functions.get(f"{cur}.{parts[-1]}")
                if hit is not None:
                    return hit
            return self._unique_method(parts[-1])
        # Bare name → same-module function.
        if not rest:
            return self.functions.get(f"{mod.module}:{head}")
        # alias.path → through the import table.
        target = mod.imports.get(head)
        if target is not None:
            full = f"{target}.{rest}"
            mod_part, _, fn_part = full.rpartition(".")
            hit = self.functions.get(f"{mod_part}:{fn_part}")
            if hit is not None:
                return hit
            # `from .mod import Class` + Class.method chains — one more
            # split: pkg.mod.Class.method → pkg.mod:Class.method.
            mod2, _, cls_part = mod_part.rpartition(".")
            if mod2:
                hit = self.functions.get(f"{mod2}:{cls_part}.{fn_part}")
                if hit is not None:
                    return hit
            return None
        # obj.m() on an untyped local: unique-method-name fallback.
        return self._unique_method(name.rsplit(".", 1)[-1])

    def _unique_method(self, method: str) -> FunctionInfo | None:
        """The project-wide unique method of this name, unless the name
        is generic enough to collide with builtins."""
        if method in self._GENERIC_METHODS or method.startswith("__"):
            return None
        cands = self._methods_by_name.get(method, ())
        if len(cands) == 1:
            return self.functions.get(next(iter(cands)))
        return None

    # -- queries -----------------------------------------------------------

    def reachable(self, root: str) -> set[str]:
        """qnames reachable from ``root`` over resolved call edges
        (including ``root`` itself)."""
        seen = {root}
        frontier = [root]
        while frontier:
            cur = frontier.pop()
            for nxt in self.callees.get(cur, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return seen
