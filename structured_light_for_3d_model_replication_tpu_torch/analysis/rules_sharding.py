"""Sharding readiness (WARN tier) — the counterpart of the JAX package's
``analysis/rules_sharding.py``, given its PyTorch meaning.

In the JAX package the rule asks the heavy jit sites for donation and
sharding annotations, so GSPMD can flip them from replicated to sharded.
The port places work by hand: each multi-card path hands every member its
device (``parallel/``, the sharded serve tier, the dense solve's members),
and the kernel wrappers launch on their tensors' device. What breaks that
is code that pins work to the current or the first card instead of the
device it was given — a ``"cuda"`` or ``"cuda:0"`` literal as a device,
``.cuda()``, or ``resolve_device(None)`` (the default card) — which puts a
member's work on card 0.

Lexical: flags those forms in the modules the multi-card tier spans. Blind
spots: a device string built at run time, and a helper outside these
modules that resolves the default card for them. Warnings never gate; they
are ratcheted through the baseline.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .core import FileContext, Rule, Violation, register
from .rules import dotted

_DEFAULT_CARDS = {"cuda", "cuda:0"}


def _default_card(node: ast.expr | None) -> bool:
    return isinstance(node, ast.Constant) and node.value in _DEFAULT_CARDS


@register
class ShardingReadinessRule(Rule):
    """Work pinned to the current or first card on the multi-card path: a
    ``"cuda"`` / ``"cuda:0"`` device literal (``torch.device(…)`` without
    an index, ``device=…``, ``.to(…)``), a ``.cuda()`` call, or
    ``resolve_device(None)`` / ``resolve_device()``."""

    name = "sharding-readiness"
    description = ("work pinned to the current or first card (a 'cuda' "
                   "device literal, .cuda(), resolve_device(None)) on the "
                   "multi-card path (warn tier)")
    severity = "warn"
    path_filter = ("parallel/", "serve/cache.py", "serve/worker.py",
                   "serve/lanes.py", "models/meshing.py",
                   "models/pipeline.py", "models/scan360.py",
                   "ops/poisson")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            what = self._pins(node)
            if what is None:
                continue
            v = self.report(
                ctx, node,
                f"{what} pins the work to the current or first card — on "
                "the multi-card path take the device the caller gave (a "
                "span member's, a lane's) instead")
            if v:
                yield v

    @staticmethod
    def _pins(call: ast.Call) -> str | None:
        name = dotted(call.func) or ""
        if name == "torch.device" and len(call.args) == 1 \
                and not call.keywords and _default_card(call.args[0]):
            return f"torch.device({call.args[0].value!r})"
        if name.split(".")[-1] == "resolve_device" and (
                not call.args or (isinstance(call.args[0], ast.Constant)
                                  and call.args[0].value is None)):
            return "resolve_device(None)"
        if isinstance(call.func, ast.Attribute):
            if call.func.attr == "cuda" and not call.args:
                return ".cuda()"
            if call.func.attr == "to" and call.args \
                    and _default_card(call.args[0]):
                return f".to({call.args[0].value!r})"
        for k in call.keywords:
            if k.arg == "device" and _default_card(k.value):
                return f"device={k.value.value!r}"
        return None
