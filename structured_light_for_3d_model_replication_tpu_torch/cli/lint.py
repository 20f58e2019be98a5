"""``cli lint`` — the port's torchlint gate as a command-line tool.

A thin front end over ``python -m …_torch.analysis`` (README "Lint (the
port)"), beside ``serve`` and ``diagnose`` in the operator's toolbox::

    cli lint                 # full two-pass check of the port's package
    cli lint --fast          # lexical rules only (seconds)
    cli lint --sarif out.sarif
    cli lint path/to/subtree --prune-baseline

Arguments before the first ``--`` flag are the paths to check (default:
the port's package directory, wherever the command runs; a checkout of
the repository is checked as that package); every ``analysis`` flag
passes through unchanged. Exit codes are the gate's: 0 clean (warnings
allowed), 1 new error-tier violations, 2 usage / bad baseline / dead
baseline entries.
"""

from __future__ import annotations

from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    from ..analysis.__main__ import main as analysis_main

    argv = list(argv or [])
    if "--list-rules" in argv:
        return analysis_main(["--list-rules"])
    paths = []
    while argv and not argv[0].startswith("-"):
        paths.append(argv.pop(0))
    return analysis_main(["--check", *(paths or [str(PACKAGE_DIR)]), *argv])
