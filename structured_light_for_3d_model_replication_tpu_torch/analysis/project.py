"""Pass 2: project-wide (dataflow-aware) rules over the call graph.

The lexical rules are per-file — that stays the fast path
(:func:`~.core.lint_path`). This module adds the *project* pass (the
port's copy of the JAX package's ``analysis/project.py``):

1. **pass 1** parses every file once and builds the
   :class:`~.callgraph.CallGraph` (symbol table, resolved call edges,
   thread entry points) plus the :class:`~.locks.LockModel` (declared
   locks, acquisition order, calls made under locks);
2. **pass 2** runs every registered :class:`ProjectRule` over that index.

Project rules report plain :class:`~.core.Violation` records, honor the
same ``# torchlint: disable=RULE`` suppression comments (via the per-file
:class:`~.core.FileContext`), ratchet through the same baseline, and may
declare ``severity = "warn"`` — warn-tier findings are reported and
baselined but never fail the gate.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterator

from .callgraph import CallGraph
from .core import (FileContext, Violation, iter_python_files, parse_file,
                   resolve_root)
from .locks import LockModel, build_lock_model

__all__ = ["ProjectIndex", "ProjectRule", "PROJECT_REGISTRY",
           "register_project", "build_index", "project_lint",
           "rule_severity"]


class ProjectIndex:
    """Everything pass 2 reads: parsed files + call graph + lock model."""

    def __init__(self, root: Path):
        self.root = root
        self.contexts: dict[str, FileContext] = {}   # rel_path → ctx
        self.parse_errors: list[Violation] = []
        self.graph = CallGraph()
        self.locks: LockModel | None = None

    @classmethod
    def build(cls, root: Path) -> "ProjectIndex":
        """Parse every file ONCE; the CLI reuses ``contexts`` for the
        lexical pass (no second read/parse) and ``parse_errors`` carries
        the unreadable/unparseable files both passes must report. The
        tree is ``root`` after :func:`~.core.resolve_root`."""
        root = resolve_root(root).resolve()
        index = cls(root)
        for path in iter_python_files(root):
            rel = (path.name if root.is_file()
                   else path.relative_to(root).as_posix())
            ctx, err = parse_file(path, rel)
            if err is not None:
                index.parse_errors.append(err)
                continue
            index.contexts[rel] = ctx
            index.graph.add_module(rel, ctx.tree)
        index.graph.finalize()
        index.locks = build_lock_model(index.graph)
        return index

    def context_for(self, module) -> FileContext | None:
        """FileContext of a ModuleInfo (for suppression checks)."""
        return self.contexts.get(module.rel_path)


class ProjectRule:
    """Like :class:`~.core.Rule` but checked once against the whole
    project index. ``severity`` is ``"error"`` (gates) or ``"warn"``
    (reported + ratcheted, never fails the gate)."""

    name: str = ""
    description: str = ""
    severity: str = "error"
    # Findings are only REPORTED for files matching these (same semantics
    # as core.Rule): the index itself always covers the whole tree.
    path_filter: tuple = ()
    exempt_parts: tuple = ("tests", "scripts")
    exempt_suffixes: tuple = ()

    def applies_to(self, rel_path: str) -> bool:
        if self.path_filter and not any(s in rel_path
                                        for s in self.path_filter):
            return False
        parts = rel_path.split("/")
        if any(p in parts for p in self.exempt_parts):
            return False
        if any(parts[-1].endswith(s) for s in self.exempt_suffixes):
            return False
        return True

    def check_project(self, index: ProjectIndex) -> Iterator[Violation]:
        raise NotImplementedError

    def report(self, index: ProjectIndex, rel_path: str, node: ast.AST,
               message: str) -> Violation | None:
        if not self.applies_to(rel_path):
            return None
        ctx = index.contexts.get(rel_path)
        if ctx is not None and ctx.suppressed(self.name, node):
            return None
        return Violation(rel_path, getattr(node, "lineno", 1),
                         getattr(node, "col_offset", 0), self.name,
                         message)


PROJECT_REGISTRY: dict[str, ProjectRule] = {}


def register_project(cls: type[ProjectRule]) -> type[ProjectRule]:
    rule = cls()
    if not rule.name:
        raise ValueError(f"project rule {cls.__name__} has no name")
    if rule.name in PROJECT_REGISTRY:
        raise ValueError(f"duplicate project rule name {rule.name!r}")
    PROJECT_REGISTRY[rule.name] = rule
    return cls


def build_index(root: Path) -> ProjectIndex:
    return ProjectIndex.build(Path(root))


def project_lint(root: Path, rules=None,
                 index: ProjectIndex | None = None) -> list[Violation]:
    """Run every project rule over ``root`` (or a prebuilt index);
    Violation paths are posix-relative to ``root`` (same contract as
    core.lint_path). Parse errors are NOT included — the caller's
    lexical pass owns reporting those."""
    if index is None:
        index = ProjectIndex.build(Path(root))
    out: list[Violation] = []
    for rule in (rules if rules is not None else PROJECT_REGISTRY.values()):
        out.extend(v for v in rule.check_project(index) if v is not None)
    out.sort()
    return out


def rule_severity(name: str) -> str:
    """'error' | 'warn' for a registered rule name (lexical or project);
    unknown names — parse-error included — gate as errors."""
    from .core import REGISTRY

    rule = PROJECT_REGISTRY.get(name) or REGISTRY.get(name)
    return getattr(rule, "severity", "error")
