"""torchlint CLI (the port's copy of the JAX package's jaxlint CLI).

``python -m structured_light_for_3d_model_replication_tpu_torch.analysis
--check <pkg>`` lints every ``*.py`` under the given roots — the lexical
fast path plus the cross-module project pass (``--fast`` skips the
latter) — and exits 0 iff no *error-tier* violations beyond the
committed baseline (the nearest ``torchlint_baseline.json`` at or above
the first checked root) remain. A root that holds the port's package (a
checkout of the repository) is checked as that package. Warn-tier
findings are reported and ratcheted but never gate.

Exit codes: 0 clean (modulo baseline, warnings allowed), 1 new
error-tier violations, 2 usage errors / bad baseline / DEAD baseline
entries (entries matching no current violation — fix with
``--prune-baseline``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

from .core import (BASELINE_NAME, REGISTRY, apply_baseline, lint_context,
                   lint_path, load_baseline, make_baseline, resolve_root,
                   to_sarif)
from .project import (PROJECT_REGISTRY, ProjectIndex, project_lint,
                      rule_severity)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m structured_light_for_3d_model_replication_tpu_torch"
             ".analysis",
        description="torchlint: static analysis for the port's "
                    "PyTorch-on-a-card hazards (see README.md)")
    p.add_argument("--check", nargs="+", metavar="PATH",
                   help="files or directories to lint")
    p.add_argument("--baseline", metavar="FILE", default=None,
                   help=f"baseline file (default: <first PATH>/"
                        f"{BASELINE_NAME} when it exists)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file (report everything)")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline to grandfather the current "
                        "violations (keeps existing justifications)")
    p.add_argument("--prune-baseline", action="store_true",
                   help="drop dead baseline entries (no matching "
                        "violation) and ratchet stale counts down, then "
                        "run the check against the pruned baseline")
    p.add_argument("--fast", action="store_true",
                   help="lexical rules only (skip the cross-module "
                        "project pass)")
    p.add_argument("--sarif", metavar="FILE", default=None,
                   help="also write the reported findings as SARIF 2.1.0")
    p.add_argument("--list-rules", action="store_true",
                   help="print the registered rules and exit")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress per-violation output (summary only)")
    return p


def _all_rules_meta() -> dict[str, tuple[str, str]]:
    meta = {name: (r.description, getattr(r, "severity", "error"))
            for name, r in REGISTRY.items()}
    meta.update({name: (r.description, r.severity)
                 for name, r in PROJECT_REGISTRY.items()})
    return meta


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        meta = _all_rules_meta()
        for name in sorted(meta):
            desc, severity = meta[name]
            tier = " [warn]" if severity == "warn" else ""
            scope = ("project"
                     if name in PROJECT_REGISTRY else "lexical")
            print(f"{name} ({scope}{tier}): {desc}")
        return 0
    if not args.check:
        build_parser().print_usage(sys.stderr)
        print("error: --check PATH is required (or --list-rules)",
              file=sys.stderr)
        return 2

    roots = [resolve_root(Path(p)) for p in args.check]
    for root in roots:
        if not root.exists():
            print(f"error: no such path: {root}", file=sys.stderr)
            return 2

    baseline_path = (Path(args.baseline) if args.baseline else
                     _default_baseline(roots[0]))
    # Violation paths are reported — and matched against the baseline —
    # relative to the baseline's directory, so a subtree invocation
    # (`--check <pkg>/ops` from the repo root) still matches the repo
    # baseline's repo-root-relative entry paths.
    anchor = baseline_path.parent.resolve()

    violations = []
    covered = []   # anchored path prefixes this run actually linted
    for root in roots:
        if args.fast:
            vs = lint_path(root)
        else:
            # One parse feeds both passes: the index's FileContexts run
            # the lexical rules, then the project rules.
            index = ProjectIndex.build(root)
            vs = list(index.parse_errors)
            for ctx in index.contexts.values():
                vs.extend(lint_context(ctx))
            vs.extend(project_lint(root, index=index))
            vs.sort()
        base = root.resolve()
        is_file = base.is_file()
        if is_file:
            base = base.parent
        try:
            prefix = base.relative_to(anchor).as_posix()
            if prefix == ".":
                prefix = ""
        except ValueError:
            prefix = None    # root outside the anchor: keep root-relative
        if prefix:
            vs = [dataclasses.replace(v, path=f"{prefix}/{v.path}")
                  for v in vs]
        if prefix is not None:
            covered.append(f"{prefix}/{root.name}".lstrip("/")
                           if is_file else prefix)
        violations.extend(vs)
    baseline = None
    if not args.no_baseline and baseline_path.exists() \
            and not args.update_baseline:
        try:
            baseline = load_baseline(baseline_path)
        except (ValueError, json.JSONDecodeError) as exc:
            print(f"error: bad baseline {baseline_path}: {exc}",
                  file=sys.stderr)
            return 2

    # A --fast run never produces project-rule findings, so baseline
    # entries for those rules are out of scope: they must be neither
    # declared dead/stale nor dropped by --update/--prune (their absence
    # says nothing — the rules were not run).
    rules_not_run = set(PROJECT_REGISTRY) if args.fast else set()

    def _was_linted(path: str) -> bool:
        return any(c == "" or path == c or path.startswith(c + "/")
                   for c in covered)

    def _entry_in_scope(path: str, rule_name: str) -> bool:
        """Could THIS run have produced violations for the entry? Only
        then does the entry's absence mean anything. Rule path_filters
        match ROOT-relative paths, so a subtree run strips the prefix
        before asking the rule (`--check <pkg>/ops` renames decode.py's
        path to 'decode.py', which no longer matches the 'ops/' filter —
        the rule did not run there, the entry is NOT dead)."""
        if rule_name in rules_not_run:
            return False
        rule = REGISTRY.get(rule_name) or PROJECT_REGISTRY.get(rule_name)
        if rule is None:
            # Unknown (renamed/removed) rule: genuinely prunable debt —
            # scope by path coverage alone.
            return _was_linted(path)
        for c in covered:
            if c == "" or path == c or path.startswith(c + "/"):
                rel = path[len(c):].lstrip("/") if c else path
                if rule.applies_to(rel):
                    return True
        return False

    if args.update_baseline:
        return _update_baseline(args, baseline_path, violations,
                                _entry_in_scope)

    if args.prune_baseline and baseline is not None:
        baseline = _prune(baseline_path, baseline, violations,
                          _entry_in_scope)

    new, grandfathered, stale = apply_baseline(violations, baseline)
    new_errors = [v for v in new if rule_severity(v.rule) != "warn"]
    new_warns = [v for v in new if rule_severity(v.rule) == "warn"]
    # Dead entries: baselined (path, rule) pairs this run's rules
    # actually covered that match zero current violations. Stale-but-
    # alive entries (count dropped, not to zero) stay a warning; dead
    # ones fail the check — a baseline full of ghosts ratchets nothing.
    dead = [(path, rule, have, allowed)
            for path, rule, have, allowed in stale
            if have == 0 and _entry_in_scope(path, rule)]
    shown = [s for s in stale if s[2] > 0 or s in dead]

    if not args.quiet:
        for v in new_errors:
            print(v.format())
        for v in new_warns:
            print(f"warning: {v.format()}")
        for path, rule, have, allowed in shown:
            kind = "DEAD" if (path, rule, have, allowed) in dead \
                else "stale"
            print(f"torchlint: {kind} baseline entry {path} [{rule}]: "
                  f"allows {allowed}, found {have} — fix with "
                  f"--prune-baseline", file=sys.stderr)

    if args.sarif:
        doc = to_sarif(sorted(new_errors + new_warns), _all_rules_meta())
        Path(args.sarif).write_text(json.dumps(doc, indent=2) + "\n",
                                    encoding="utf-8")

    per_rule: dict[str, int] = {}
    for v in new_errors + new_warns:
        per_rule[v.rule] = per_rule.get(v.rule, 0) + 1
    detail = ", ".join(f"{r}: {n}" for r, n in sorted(per_rule.items()))
    summary = (f"torchlint: {len(new_errors)} new violation(s), "
               f"{len(new_warns)} warning(s), "
               f"{grandfathered} grandfathered, "
               f"{len(REGISTRY) + len(PROJECT_REGISTRY)} rules"
               + (f" [{detail}]" if detail else ""))
    print(summary, file=sys.stderr if new_errors else sys.stdout)
    if new_errors:
        return 1
    if dead:
        print(f"torchlint: {len(dead)} dead baseline entr"
              f"{'y' if len(dead) == 1 else 'ies'} — run "
              "--prune-baseline", file=sys.stderr)
        return 2
    return 0


def _update_baseline(args, baseline_path: Path, violations,
                     entry_in_scope) -> int:
    old = None
    if baseline_path.exists():
        try:
            old = load_baseline(baseline_path)
        except (ValueError, json.JSONDecodeError) as exc:
            print(f"error: bad baseline {baseline_path}: {exc}",
                  file=sys.stderr)
            return 2
    doc = make_baseline(violations, old)
    if old is not None:
        # A subtree (or --fast) run sees only its own violations — keep
        # old entries this run's rules could not have re-observed, or a
        # scoped --update-baseline would silently drop the rest of the
        # repo's grandfathered entries.
        kept = [e for e in old.get("entries", [])
                if not entry_in_scope(e["path"], e["rule"])]
        doc["entries"] = sorted(kept + doc["entries"],
                                key=lambda e: (e["path"], e["rule"]))
    baseline_path.write_text(json.dumps(doc, indent=2) + "\n",
                             encoding="utf-8")
    n_gf = sum(e["count"] for e in doc["entries"])
    print(f"torchlint: wrote {baseline_path} grandfathering "
          f"{n_gf} violation(s) in "
          f"{len(doc['entries'])} (file, rule) group(s)")
    if n_gf < len(violations):
        print(f"torchlint: {len(violations) - n_gf} parse-error "
              "violation(s) NOT baselined (unparseable files always "
              "fail the gate — fix them)", file=sys.stderr)
    return 0


def _prune(baseline_path: Path, baseline: dict, violations,
           entry_in_scope) -> dict:
    """Drop in-scope entries with no matching violation; ratchet
    in-scope counts down to the observed count. Justifications survive;
    entries this run's rules could not have re-observed (unlinted
    paths, filter-stripped subtree paths, --fast project rules) are
    untouchable."""
    from collections import defaultdict

    current: dict[tuple, int] = defaultdict(int)
    for v in violations:
        current[(v.path, v.rule)] += 1
    entries = []
    dropped = ratcheted = 0
    for e in baseline.get("entries", []):
        key = (e["path"], e["rule"])
        if not entry_in_scope(e["path"], e["rule"]):
            entries.append(e)
            continue
        have = current.get(key, 0)
        if have == 0:
            dropped += 1
            continue
        if have < int(e["count"]):
            e = dict(e, count=have)
            ratcheted += 1
        entries.append(e)
    doc = dict(baseline, entries=entries)
    baseline_path.write_text(json.dumps(doc, indent=2) + "\n",
                             encoding="utf-8")
    print(f"torchlint: pruned {baseline_path}: {dropped} dead entr"
          f"{'y' if dropped == 1 else 'ies'} removed, "
          f"{ratcheted} count(s) ratcheted down", file=sys.stderr)
    return doc


def _default_baseline(root: Path) -> Path:
    """Nearest baseline at or ABOVE the checked root, so subtree
    invocations honor the committed repo baseline; falls back to
    ``<root>/torchlint_baseline.json`` when none exists up the tree."""
    base = (root if root.is_dir() else root.parent).resolve()
    for d in (base, *base.parents):
        cand = d / BASELINE_NAME
        if cand.exists():
            return cand
    return base / BASELINE_NAME


if __name__ == "__main__":
    sys.exit(main())
