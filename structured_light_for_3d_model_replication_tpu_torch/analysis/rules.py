"""torchlint built-in rules — the hazard classes of PyTorch on a card that
this port has shipped or guards against.

Each rule is the counterpart of one of the JAX package's jaxlint rules, or
of a hazard only the port has:

=====================  ===================================================
``kernel-import``      jaxlint ``pallas-import``: kernels build at first
                       use, never at import
``foreign-import``     the port imports nothing of JAX or the JAX package
``host-read``          jaxlint ``host-sync-in-jit``: numpy reading a
                       tensor that may live on the card
``implicit-dtype``     jaxlint ``implicit-dtype``: ``ops/`` tensors built
                       without a dtype
``implicit-rng``       jaxlint ``key-reuse``: random draws outside an
                       explicit ``torch.Generator``
``atomic-scatter``     atomic float sums on the card, which do not repeat
``silent-except``      jaxlint ``silent-except``, as it is
=====================  ===================================================

Every rule is lexical (pure AST, no type inference), so each one states
its exact heuristic and the known blind spots.  False positives are the
suppression comment's job (`# torchlint: disable=RULE` with a
justification); systemic exceptions belong in the rule's path scoping,
not in per-line noise. Every rule skips ``tests/`` and ``scripts/``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .core import PACKAGE, FileContext, Rule, Violation, register

# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------


def dotted(node: ast.AST) -> str | None:
    """'torch.cuda.synchronize' for a Name/Attribute chain, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _import_targets(node: ast.Import | ast.ImportFrom) -> list[str]:
    """Every module an import statement names, relative ones with their
    leading dots ('..kernels.build', '.kernels' for ``from . import
    kernels``)."""
    if isinstance(node, ast.Import):
        return [alias.name for alias in node.names]
    base = "." * node.level + (node.module or "")
    out = [base] if node.module else []
    sep = "" if base.endswith(".") or not base else "."
    out += [f"{base}{sep}{alias.name}" for alias in node.names
            if alias.name != "*"]
    return out


def _under(name: str, prefix: str) -> bool:
    """``name`` is the module ``prefix`` or one inside it."""
    return name == prefix or name.startswith(prefix + ".")


def _keyword(call: ast.Call, name: str) -> ast.expr | None:
    return next((k.value for k in call.keywords if k.arg == name), None)


def _is_cpu(node: ast.expr | None) -> bool:
    """'cpu' / torch.device('cpu')."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and dotted(node.func) == "torch.device":
        return bool(node.args) and _is_cpu(node.args[0])
    return False


def _chain(node: ast.expr):
    """The receiver chain of an expression, outermost first: the calls,
    attributes and subscripts down to its root."""
    while True:
        yield node
        if isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        else:
            return


def _moved_to_host(node: ast.expr) -> bool:
    """Some call in the receiver chain copies to the host: ``.cpu()`` or
    ``.to("cpu")`` / ``.to(device="cpu")``."""
    for link in _chain(node):
        if isinstance(link, ast.Call) and isinstance(link.func,
                                                     ast.Attribute):
            if link.func.attr == "cpu":
                return True
            if link.func.attr == "to" and (
                    (link.args and _is_cpu(link.args[0]))
                    or _is_cpu(_keyword(link, "device"))):
                return True
    return False


def _torch_rooted(node: ast.expr) -> bool:
    """The expression's receiver chain starts at the name ``torch``."""
    *_, root = _chain(node)
    return isinstance(root, ast.Name) and root.id == "torch"


# ---------------------------------------------------------------------------
# Rule 1: kernel builds imported at module scope
# ---------------------------------------------------------------------------

_BUILD_MODULES = ("triton", "torch.utils.cpp_extension")


@register
class KernelImportRule(Rule):
    """Kernels build at first use, never at import.

    Hosts without ``nvcc``, ``triton`` or a card import every module of
    the port (the CPU tests do), so the kernel bindings in ``kernels/``
    and the build tools (``triton``, ``torch.utils.cpp_extension``) are
    imported inside the function that launches a kernel — as every
    wrapper does (``ops/decode.py``, ``ops/nn.py``, ``serve/cache.py``).
    Flags such an import anywhere a module executes at import time:
    module scope, class bodies, and ``if``/``try`` blocks there (unlike
    ``pallas-import``, a branch is no gate: a card host takes it at
    import). ``kernels/`` itself is exempt. Blind spot: an
    ``importlib.import_module`` string."""

    name = "kernel-import"
    description = ("import of the kernels package, triton or "
                   "torch.utils.cpp_extension at module scope (kernels "
                   "build at first use)")
    exempt_parts = ("tests", "scripts", "kernels")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        yield from self._visit(ctx, ctx.tree)

    def _visit(self, ctx, node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue          # runs at call time, not at import
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                for target in _import_targets(child):
                    if self._is_kernel_build(target):
                        v = self.report(
                            ctx, child,
                            f"import of {target!r} at import time: import "
                            "the kernel bindings and build tools inside "
                            "the function that launches the kernel, so "
                            "hosts without nvcc, triton or a card import "
                            "this module")
                        if v:
                            yield v
                        break
                continue
            yield from self._visit(ctx, child)

    @staticmethod
    def _is_kernel_build(target: str) -> bool:
        if target.startswith("."):
            return target.lstrip(".").split(".")[0] == "kernels"
        return (_under(target, f"{PACKAGE}.kernels")
                or any(_under(target, m) for m in _BUILD_MODULES))


# ---------------------------------------------------------------------------
# Rule 2: imports of JAX or the JAX package
# ---------------------------------------------------------------------------

# jax, and the JAX package the port was made from (the reference).
_FOREIGN = ("jax", "jaxlib", "structured_light_for_3d_model_replication_tpu")


@register
class ForeignImportRule(Rule):
    """The port imports nothing of JAX and nothing of the JAX package —
    not even its stdlib-only modules; it keeps its own copy. Flags any
    import statement, at any depth, of ``jax``, ``jaxlib`` or the JAX
    package, matched by the exact name or that name followed by ``.``
    (the port's own name starts with the JAX package's). Blind spot: an
    ``importlib.import_module`` string."""

    name = "foreign-import"
    description = ("import of jax, jaxlib or the JAX package (the port "
                   "keeps its own copy)")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.Import, ast.ImportFrom)) or (
                    isinstance(node, ast.ImportFrom) and node.level):
                continue
            for target in _import_targets(node):
                hit = next((m for m in _FOREIGN if _under(target, m)), None)
                if hit is not None:
                    v = self.report(
                        ctx, node,
                        f"import of {target!r}: the port imports nothing "
                        f"of {hit!r}; keep a copy of what it needs in the "
                        "port")
                    if v:
                        yield v
                    break


# ---------------------------------------------------------------------------
# Rule 3: numpy reads of tensors that may live on the card
# ---------------------------------------------------------------------------

_NP_MODS = ("np", "numpy")
_NP_READS = ("asarray", "array", "copyto")


@register
class HostReadRule(Rule):
    """numpy reading a tensor that may live on the card. ``.numpy()`` and
    ``np.asarray(t)`` work on a host tensor and raise on a CUDA one, so a
    path that runs on the CPU in the tests fails only on the card (the
    fleet adoption's replay once shipped that way). Flags ``.numpy()``
    whose receiver chain has no ``.cpu()`` / ``.to("cpu")`` (and no
    ``force=True``), and ``np.asarray`` / ``np.array`` / ``np.copyto`` of
    an argument whose chain starts at ``torch`` without such a copy.
    Blind spot: a tensor held in a plain name (``np.asarray(t)``); a host
    tensor by construction is a false positive for the suppression
    comment."""

    name = "host-read"
    description = (".numpy() or np.asarray/np.array/np.copyto of a tensor "
                   "with no .cpu() in its chain (raises on the card)")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not isinstance(
                    node.func, ast.Attribute):
                continue
            f = node.func
            if f.attr == "numpy" and not node.args:
                force = _keyword(node, "force")
                if not (isinstance(force, ast.Constant) and force.value) \
                        and not _moved_to_host(f.value):
                    v = self.report(
                        ctx, node,
                        ".numpy() of a tensor with no .cpu() in its chain "
                        "raises on a CUDA tensor — copy it with .cpu() "
                        "first, or suppress with the reason it is a host "
                        "tensor")
                    if v:
                        yield v
            elif dotted(f.value) in _NP_MODS and f.attr in _NP_READS:
                args = list(node.args) + [k.value for k in node.keywords]
                if any(_torch_rooted(a) and not _moved_to_host(a)
                       for a in args):
                    v = self.report(
                        ctx, node,
                        f"{dotted(f)}() of a torch expression with no "
                        ".cpu() in its chain raises on a CUDA tensor — "
                        "copy it to the host first")
                    if v:
                        yield v


# ---------------------------------------------------------------------------
# Rule 4: implicit dtype in ops/
# ---------------------------------------------------------------------------


@register
class ImplicitDtypeRule(Rule):
    """``torch.tensor`` / ``torch.as_tensor`` without an explicit dtype
    takes the input's: a float64 numpy array stays float64 in torch,
    where the JAX package (x64 off) computes in float32, and Python
    floats take the default dtype. Scoped to ``ops/`` — the numerical
    layer where every tensor's dtype is part of the contract."""

    name = "implicit-dtype"
    description = ("torch.tensor/torch.as_tensor without an explicit "
                   "dtype in ops/ (float64 inputs stay float64)")
    path_filter = ("ops/",)

    _FUNCS = {"torch.tensor", "torch.as_tensor"}

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name not in self._FUNCS:
                continue
            has_dtype = ((name == "torch.as_tensor" and len(node.args) >= 2)
                         or _keyword(node, "dtype") is not None)
            if not has_dtype:
                v = self.report(
                    ctx, node,
                    f"{name}() without an explicit dtype in ops/ — the "
                    "tensor takes its input's dtype (float64 from numpy); "
                    "pass the intended dtype")
                if v:
                    yield v


# ---------------------------------------------------------------------------
# Rule 5: random draws outside an explicit generator
# ---------------------------------------------------------------------------

_DRAWS = {"torch.rand", "torch.randn", "torch.randint", "torch.randperm",
          "torch.multinomial", "torch.normal", "torch.bernoulli",
          "torch.poisson", "torch.rand_like", "torch.randn_like",
          "torch.randint_like"}
_INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "random_",
                  "exponential_", "geometric_", "cauchy_", "log_normal_"}
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                 "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}


@register
class ImplicitRngRule(Rule):
    """The port draws from explicit ``torch.Generator`` objects seeded by
    its callers (``models/merge.py``, ``ops/segmentation.py``), so a run
    repeats whatever else drew before it — the counterpart of the JAX
    package's explicit PRNG keys. Flags a random draw (``torch.rand*``,
    ``randperm``, ``multinomial``, ``normal``, ``bernoulli``,
    ``poisson`` and the in-place ``uniform_`` / ``normal_`` / … forms)
    without ``generator=``, and any seeding of the global generator
    (``torch.manual_seed`` and its CUDA forms). Blind spot: a generator
    passed positionally (no torch draw takes one)."""

    name = "implicit-rng"
    description = ("random draw without generator=, or a seed of the "
                   "global generator")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func) or ""
            if name in _GLOBAL_SEEDS:
                msg = (f"{name}() seeds the global generator, which every "
                       "other draw in the process shares — seed a "
                       "torch.Generator and pass it instead")
            elif (name in _DRAWS or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _INPLACE_DRAWS)) \
                    and _keyword(node, "generator") is None:
                msg = (f"{name or node.func.attr}() draws from the global "
                       "generator — pass generator= (a seeded "
                       "torch.Generator on the tensor's device)")
            else:
                continue
            v = self.report(ctx, node, msg)
            if v:
                yield v


# ---------------------------------------------------------------------------
# Rule 6: atomic scatter-adds outside ops/_scatter.py
# ---------------------------------------------------------------------------

_SCATTERS = {"index_add", "index_add_", "scatter_add", "scatter_add_",
             "scatter_reduce", "scatter_reduce_"}


@register
class AtomicScatterRule(Rule):
    """On the card ``index_add_``, ``scatter_add_``, ``scatter_reduce_``
    and ``index_put_(…, accumulate=True)`` sum with atomics in no fixed
    order: a float sum then differs between two runs in its last bits,
    and the port's paths must repeat bit for bit. Every float
    scatter-sum goes through ``ops/_scatter.py`` (a sorting or segmented
    sum on the card), the one module exempt. Flags those calls (method or
    ``torch.`` form) anywhere else; an integer count, a sum of ones, an
    ``amin`` or unique indices repeat, and take the suppression comment
    with that reason."""

    name = "atomic-scatter"
    description = ("index_add/scatter_add/scatter_reduce or "
                   "index_put(accumulate=True) outside ops/_scatter.py "
                   "(atomic float sums do not repeat)")

    def applies_to(self, rel_path: str) -> bool:
        return super().applies_to(rel_path) and not (
            rel_path == "ops/_scatter.py"
            or rel_path.endswith("/ops/_scatter.py"))

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not isinstance(
                    node.func, ast.Attribute):
                continue
            attr = node.func.attr
            if attr in ("index_put", "index_put_"):
                acc = _keyword(node, "accumulate")
                if acc is None and len(node.args) >= 3:
                    acc = node.args[2]
                if not (isinstance(acc, ast.Constant) and acc.value is True):
                    continue
            elif attr not in _SCATTERS:
                continue
            v = self.report(
                ctx, node,
                f"{attr}() sums with atomics on the card, in no fixed "
                "order: use ops/_scatter.py for a float sum, or suppress "
                "with the reason this one repeats (integers, ones, amin, "
                "unique indices)")
            if v:
                yield v


# ---------------------------------------------------------------------------
# Rule 7: silent broad excepts
# ---------------------------------------------------------------------------


@register
class SilentExceptRule(Rule):
    """``except Exception: pass`` swallows EVERYTHING — including the
    device and transport failures the rest of this linter exists to
    surface — and leaves no log line to debug from.  The hazard class
    behind the turntable serial-probe fix: a broad handler whose body
    does literally nothing.  Heuristic: the handler catches a broad type
    (bare ``except``, ``Exception``/``BaseException``, alone or in a
    tuple) AND its body is only ``pass``/``continue`` (docstring-style
    constants ignored).  Handlers that log, return a fallback, re-raise
    or set state are fine — the rule targets silence, not breadth."""

    name = "silent-except"
    description = ("except Exception/bare except whose body only "
                   "pass/continues — failures vanish with no log or "
                   "fallback")

    _BROAD = {"Exception", "BaseException"}

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._is_broad(node.type):
                continue
            if not self._is_silent(node.body):
                continue
            v = self.report(
                ctx, node,
                "broad except with a pass/continue-only body silently "
                "swallows every failure — log it, narrow the exception "
                "type, or return an explicit fallback")
            if v:
                yield v

    def _is_broad(self, type_node) -> bool:
        if type_node is None:           # bare except:
            return True
        if isinstance(type_node, ast.Tuple):
            return any(self._is_broad(e) for e in type_node.elts)
        name = dotted(type_node)
        return name is not None and name.split(".")[-1] in self._BROAD

    @staticmethod
    def _is_silent(body) -> bool:
        real = [s for s in body
                if not (isinstance(s, ast.Expr)
                        and isinstance(s.value, ast.Constant))]
        return bool(real) and all(
            isinstance(s, (ast.Pass, ast.Continue)) for s in real)
