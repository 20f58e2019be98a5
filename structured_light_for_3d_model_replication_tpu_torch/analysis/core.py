"""torchlint core — rule registry, suppression comments, baseline ratchet.

The port's copy of the JAX package's ``analysis/core.py``: AST-only and
stdlib-only, so the gate runs on a host without ``torch``, ``triton`` or a
card. Rules live in :mod:`.rules` and :mod:`.rules_concurrency`; each is a
small class registered under a kebab-case name and reporting
:class:`Violation` records against one parsed file at a time.

Three mechanisms keep the gate adoptable on a codebase that already has
violations:

* **suppressions** — ``# torchlint: disable=RULE[,RULE2]`` on (or on a
  comment line directly above) the offending line silences those rules
  there; ``disable=all`` silences everything.  Suppressions are the
  mechanism for *justified* hazards — put the justification in the same
  comment.
* **baseline** — a committed JSON file (:data:`BASELINE_NAME`, in the
  port's package directory) holding per-(file, rule) grandfathered
  violation COUNTS.  The check fails only when a (file, rule) pair exceeds
  its baselined count, so new violations are blocked while old ones are
  paid down incrementally (count-based, not line-based, so unrelated
  edits don't shift entries).
* **per-rule path scoping** — a rule can restrict itself to path
  substrings (e.g. dtype discipline only under ``ops/``) and exempt
  designated files (e.g. ``kernels/`` IS the sanctioned home of the
  kernel build imports).

The scope is the port's own code: a directory that holds the port's
package (a checkout of the repository) is linted as that package
(:func:`resolve_root`), so the JAX package beside it is never read.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Iterable, Iterator

__all__ = [
    "BASELINE_NAME", "FileContext", "PACKAGE", "Rule", "REGISTRY",
    "Violation",
    "apply_baseline", "iter_python_files", "lint_context", "lint_file",
    "lint_path", "load_baseline", "make_baseline", "parse_file",
    "register", "resolve_root", "to_sarif",
]

BASELINE_NAME = "torchlint_baseline.json"

# The port's package: the lint's scope.
PACKAGE = "structured_light_for_3d_model_replication_tpu_torch"

# Directory parts never linted (caches, VCS internals, virtualenvs).
SKIP_DIR_PARTS = {"__pycache__", ".git", ".venv", "venv", "node_modules",
                  "build", "dist", ".eggs"}


@dataclasses.dataclass(frozen=True, order=True)
class Violation:
    """One finding: ``path:line:col: [rule] message``."""

    path: str          # posix path relative to the checked root
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] " \
               f"{self.message}"


_SUPPRESS_RE = re.compile(
    r"#\s*torchlint:\s*disable=([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)")


class FileContext:
    """One parsed file: source, AST, and the suppression table."""

    def __init__(self, rel_path: str, source: str, tree: ast.Module):
        self.rel_path = rel_path
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self.suppressions = self._parse_suppressions()

    def _parse_suppressions(self) -> dict[int, set[str]]:
        """line → suppressed rule names.  A trailing comment applies to
        its own line; a comment-only line applies to the next code
        line (for statements whose line is already full)."""
        table: dict[int, set[str]] = {}
        pending: set[str] = set()
        for lineno, text in enumerate(self.lines, 1):
            m = _SUPPRESS_RE.search(text)
            rules = ({r.strip() for r in m.group(1).split(",") if r.strip()}
                     if m else set())
            stripped = text.strip()
            if rules and stripped.startswith("#"):
                pending |= rules          # standalone comment → next code line
                continue
            if stripped and not stripped.startswith("#"):
                line_rules = rules | pending
                pending = set()
                if line_rules:
                    table[lineno] = line_rules
        return table

    def suppressed(self, rule: str, node: ast.AST) -> bool:
        """True when any source line spanned by ``node`` carries a
        ``disable=`` for this rule (multi-line calls can put the comment
        on whichever line fits)."""
        start = getattr(node, "lineno", None)
        if start is None:
            return False
        end = getattr(node, "end_lineno", None) or start
        for line in range(start, end + 1):
            rules = self.suppressions.get(line)
            if rules and (rule in rules or "all" in rules):
                return True
        return False


class Rule:
    """Base class: subclass, set ``name``/``description``, implement
    :meth:`check`, and decorate with :func:`register`."""

    name: str = ""
    description: str = ""
    # "error" findings gate (exit 1); "warn" findings are reported and
    # ratcheted through the baseline but never fail the check.
    severity: str = "error"
    # Lint only files whose relative posix path contains one of these
    # substrings (empty tuple = every file).
    path_filter: tuple[str, ...] = ()
    # Skip files with any of these path PARTS (every rule skips the
    # tests and the operator scripts) …
    exempt_parts: tuple[str, ...] = ("tests", "scripts")
    # … or with any of these filename suffixes.
    exempt_suffixes: tuple[str, ...] = ()

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

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        raise NotImplementedError

    def report(self, ctx: FileContext, node: ast.AST,
               message: str) -> Violation | None:
        """Build a Violation unless a suppression comment covers it."""
        if ctx.suppressed(self.name, node):
            return None
        return Violation(ctx.rel_path, getattr(node, "lineno", 1),
                         getattr(node, "col_offset", 0), self.name, message)


REGISTRY: dict[str, Rule] = {}


def register(cls: type[Rule]) -> type[Rule]:
    rule = cls()
    if not rule.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    if rule.name in REGISTRY:
        raise ValueError(f"duplicate rule name {rule.name!r}")
    REGISTRY[rule.name] = rule
    return cls


# ---------------------------------------------------------------------------
# Running the rules
# ---------------------------------------------------------------------------


def resolve_root(root: Path) -> Path:
    """The tree to lint for ``root``: a directory holding the port's
    package (a checkout of the repository) is linted as that package, so
    the rules never read the JAX package, ``bench.py`` or ``tests/``
    beside it; any other path as it is."""
    root = Path(root)
    pkg = root / PACKAGE
    return pkg if (pkg / "__init__.py").is_file() else root


def iter_python_files(root: Path) -> Iterator[Path]:
    if root.is_file():
        yield root
        return
    for p in sorted(root.rglob("*.py")):
        rel_parts = p.relative_to(root).parts
        if any(part in SKIP_DIR_PARTS or part.startswith(".")
               for part in rel_parts[:-1]):
            continue
        yield p


def parse_file(path: Path, rel_path: str):
    """(FileContext, None) or (None, parse-error Violation)."""
    try:
        source = path.read_text(encoding="utf-8")
    except (OSError, UnicodeDecodeError) as exc:
        # Same non-baselinable channel as a syntax error: an unreadable
        # file must fail the gate with a pointer, not a traceback.
        return None, Violation(rel_path, 1, 0, "parse-error",
                               f"could not read: {exc}")
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as exc:
        # Unparseable files fail the gate outright (parse-error is not a
        # registered rule, so it can neither be suppressed nor baselined).
        return None, Violation(rel_path, exc.lineno or 1, exc.offset or 0,
                               "parse-error",
                               f"could not parse: {exc.msg}")
    return FileContext(rel_path, source, tree), None


def lint_context(ctx: FileContext,
                 rules: Iterable[Rule] | None = None) -> list[Violation]:
    """Run the (lexical) rules over an already-parsed file."""
    out: list[Violation] = []
    for rule in (rules if rules is not None else REGISTRY.values()):
        if rule.applies_to(ctx.rel_path):
            out.extend(rule.check(ctx))
    out.sort()
    return out


def lint_file(path: Path, rel_path: str,
              rules: Iterable[Rule] | None = None) -> list[Violation]:
    ctx, err = parse_file(path, rel_path)
    if err is not None:
        return [err]
    return lint_context(ctx, rules)


def lint_path(root: Path,
              rules: Iterable[Rule] | None = None) -> list[Violation]:
    """Lint every ``*.py`` under ``root`` (or ``root`` itself if a file).
    Violation paths are posix-relative to ``root``, after
    :func:`resolve_root`."""
    root = resolve_root(root).resolve()
    out: list[Violation] = []
    for path in iter_python_files(root):
        rel = (path.name if root.is_file()
               else path.relative_to(root).as_posix())
        out.extend(lint_file(path, rel, rules))
    out.sort()
    return out


# ---------------------------------------------------------------------------
# SARIF 2.1.0 export
# ---------------------------------------------------------------------------

SARIF_SCHEMA_URI = ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")


def to_sarif(violations: list[Violation],
             rules_meta: dict[str, tuple[str, str]]) -> dict:
    """SARIF 2.1.0 document for the given findings.

    ``rules_meta`` maps rule name → (description, severity); severities
    map warn→"warning", everything else →"error". Columns are
    1-indexed per the SARIF spec (Violation.col is 0-indexed AST
    col_offset)."""
    used = sorted({v.rule for v in violations} | set(rules_meta))
    rule_index = {name: i for i, name in enumerate(used)}
    rules = [{
        "id": name,
        "shortDescription": {
            "text": rules_meta.get(name, ("", "error"))[0]
                    or name},
        "defaultConfiguration": {
            "level": ("warning"
                      if rules_meta.get(name, ("", "error"))[1] == "warn"
                      else "error")},
    } for name in used]
    results = [{
        "ruleId": v.rule,
        "ruleIndex": rule_index[v.rule],
        "level": ("warning"
                  if rules_meta.get(v.rule, ("", "error"))[1] == "warn"
                  else "error"),
        "message": {"text": v.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": v.path,
                                     "uriBaseId": "SRCROOT"},
                "region": {"startLine": max(1, v.line),
                           "startColumn": v.col + 1},
            },
        }],
    } for v in violations]
    return {
        "$schema": SARIF_SCHEMA_URI,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "torchlint",
                "informationUri": "README.md",
                "rules": rules,
            }},
            "results": results,
            # No columnKind declared: startColumn comes from ast
            # col_offset (a UTF-8 byte offset), which is neither of the
            # declarable units — on the rare non-ASCII line it is a
            # best-effort approximation, and declaring a unit it does
            # not honor would just mis-anchor viewers confidently.
        }],
    }


# ---------------------------------------------------------------------------
# Baseline (count-based ratchet)
# ---------------------------------------------------------------------------


def load_baseline(path: Path) -> dict:
    data = json.loads(path.read_text(encoding="utf-8"))
    if not isinstance(data, dict) or "entries" not in data:
        raise ValueError(f"{path}: not a torchlint baseline "
                         "(expected an object with an 'entries' list)")
    return data


def baseline_counts(data: dict) -> dict[tuple[str, str], int]:
    return {(e["path"], e["rule"]): int(e["count"])
            for e in data.get("entries", [])}


def apply_baseline(violations: list[Violation], data: dict | None):
    """Split findings into (new, grandfathered_count, stale_entries).

    A (path, rule) group within its baselined count is grandfathered in
    full.  A group EXCEEDING its count surfaces every member (a count
    ratchet cannot tell old from new occurrences, so the whole group is
    shown for triage).  Entries whose current count dropped are reported
    stale so the baseline can be ratcheted down.
    """
    counts = baseline_counts(data) if data else {}
    groups: dict[tuple[str, str], list[Violation]] = defaultdict(list)
    for v in violations:
        groups[(v.path, v.rule)].append(v)
    new: list[Violation] = []
    grandfathered = 0
    for key, vs in sorted(groups.items()):
        allowed = counts.get(key, 0)
        if key[1] != "parse-error" and len(vs) <= allowed:
            grandfathered += len(vs)
        else:
            new.extend(vs)
    stale = [(path, rule, len(groups.get((path, rule), ())), allowed)
             for (path, rule), allowed in sorted(counts.items())
             if len(groups.get((path, rule), ())) < allowed]
    return new, grandfathered, stale


def make_baseline(violations: list[Violation],
                  old_data: dict | None = None) -> dict:
    """Baseline document grandfathering the given violations, keeping
    any human-written justifications from ``old_data``."""
    old_just = {}
    if old_data:
        old_just = {(e["path"], e["rule"]): e.get("justification", "")
                    for e in old_data.get("entries", [])}
    groups: dict[tuple[str, str], int] = defaultdict(int)
    for v in violations:
        if v.rule == "parse-error":
            continue    # apply_baseline never honors parse-error entries
        groups[(v.path, v.rule)] += 1
    entries = [
        {"path": path, "rule": rule, "count": count,
         "justification": old_just.get(
             (path, rule), "TODO: justify or fix (see README.md)")}
        for (path, rule), count in sorted(groups.items())
    ]
    return {
        "comment": "torchlint grandfathered violations — see README.md. "
                   "Each entry allows `count` violations of `rule` in "
                   "`path`; exceeding it fails the gate.",
        "entries": entries,
    }
