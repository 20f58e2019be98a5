"""torchlint — the port's static analysis for PyTorch-on-a-card hazards.

Usage::

    python -m structured_light_for_3d_model_replication_tpu_torch.analysis \\
        --check structured_light_for_3d_model_replication_tpu_torch

or ``cli lint`` (its default path is the port's package). The port's copy
of the JAX package's jaxlint, with its own rules. Two passes:

* the **lexical** fast path (:mod:`.core` + :mod:`.rules`): per-file AST
  rules for the hazard classes this port has actually shipped or guards
  against — kernel builds imported at import time, imports of JAX or the
  JAX package, numpy reads of tensors that may live on the card, implicit
  dtypes in the ops layer, random draws outside an explicit generator,
  atomic scatter-sums outside ``ops/_scatter.py``, silent broad excepts;
* the **project** pass (:mod:`.project` over :mod:`.callgraph` +
  :mod:`.locks`): cross-module rules — lock-order inversions, blocking
  calls under locks, unlocked shared state across thread entry points.

jaxlint's ``sharding-readiness`` (warn tier, :mod:`.rules_sharding`)
takes its PyTorch meaning: on the modules the multi-card tier spans it
flags work pinned to the current or first card. jaxlint's tracing rules
(``static-argnames``, ``mutable-global``, ``jit-static-from-loop``,
``jit-traced-shape-scalar``) have no counterpart: the port traces nothing
(no ``torch.jit``, ``torch.compile`` or CUDA graph).

Everything is AST-only and stdlib-only, so the gate runs where torch
itself is absent. The runtime complements live in `utils/sanitize.py`.
"""

from .core import (  # noqa: F401
    BASELINE_NAME,
    PACKAGE,
    FileContext,
    REGISTRY,
    Rule,
    Violation,
    apply_baseline,
    iter_python_files,
    lint_file,
    lint_path,
    load_baseline,
    make_baseline,
    register,
    resolve_root,
    to_sarif,
)
from . import rules  # noqa: F401  (importing registers the built-in rules)
from . import rules_sharding  # noqa: F401  (registers sharding-readiness)
from .project import (  # noqa: F401
    PROJECT_REGISTRY,
    ProjectIndex,
    ProjectRule,
    build_index,
    project_lint,
    register_project,
    rule_severity,
)
from . import rules_concurrency  # noqa: F401  (registers project rules)
