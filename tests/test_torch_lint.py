"""torchlint, the port's static analysis (``analysis/`` and ``cli lint``),
held against the JAX package's jaxlint on the CPU.

* ``silent-except`` and the three concurrency rules (``lock-order``,
  ``blocking-under-lock``, ``unlocked-shared-state``) find the same
  ``(path, line, rule)`` set as jaxlint on the same fixture trees — the
  fixtures of tests/test_jaxlint.py, copied here as strings, the suppressed
  ones with the port's ``# torchlint:`` comment;
* the baseline machinery gives the same exit codes, baseline entries and
  DEAD / stale notices as jaxlint's in the same scenarios, run with the
  ``implicit-dtype`` rule both tools have (the JAX fixture's
  ``jnp.asarray(x)`` and the port's ``torch.as_tensor(x)`` on the same
  line);
* the SARIF results equal jaxlint's apart from the tool's name, the rule
  metadata and the message texts;
* each port rule triggers, passes its clean fixture and honors its
  suppression comment, with the edge cases of its heuristic;
* the CLI exit codes equal jaxlint's, and the port's own tree is clean
  modulo ``torchlint_baseline.json``, every entry justified.

Fixtures are SOURCE STRINGS linted from a temp tree: both linters parse
this file too, and string constants are invisible to their AST walks.
"""

import json
import textwrap
from pathlib import Path

import pytest

from structured_light_for_3d_model_replication_tpu import analysis as jlint
from structured_light_for_3d_model_replication_tpu.analysis.__main__ import (
    main as jaxlint_main,
)
from structured_light_for_3d_model_replication_tpu.cli import (
    lint as jcli_lint,
)
from structured_light_for_3d_model_replication_tpu_torch import (
    analysis as tlint,
)
from structured_light_for_3d_model_replication_tpu_torch.analysis import (
    __main__ as tlint_main,
)
from structured_light_for_3d_model_replication_tpu_torch.cli import (
    lint as cli_lint,
)

torchlint_main = tlint_main.main

PORT_DIR = Path(tlint.__file__).resolve().parents[1]

LEXICAL_RULES = {"kernel-import", "foreign-import", "host-read",
                 "implicit-dtype", "implicit-rng", "atomic-scatter",
                 "silent-except"}
PROJECT_RULES = {"lock-order", "blocking-under-lock",
                 "unlocked-shared-state"}
SHARED_RULES = {"silent-except"} | PROJECT_RULES

# rule → (rel_path, triggering source, clean source, suppressed source).
FIXTURES = {
    "kernel-import": (
        "ops/mod.py",
        """
        from ..kernels import build
        """,
        """
        def launch(x):
            from ..kernels import build

            return build.library().run(x)
        """,
        """
        from ..kernels import build  # torchlint: disable=kernel-import -- probe
        """,
    ),
    "foreign-import": (
        "io/mod.py",
        """
        from structured_light_for_3d_model_replication_tpu.io import ply
        """,
        """
        from structured_light_for_3d_model_replication_tpu_torch.io import ply
        """,
        """
        # torchlint: disable=foreign-import -- a parity harness
        from structured_light_for_3d_model_replication_tpu.io import ply
        """,
    ),
    "host-read": (
        "models/mod.py",
        """
        def pull(t):
            return t.detach().numpy()
        """,
        """
        def pull(t):
            return t.detach().cpu().numpy()
        """,
        """
        def pull(t):
            return t.numpy()  # torchlint: disable=host-read -- a host tensor
        """,
    ),
    "implicit-dtype": (
        "ops/mod.py",
        """
        import torch

        def f(x):
            return torch.as_tensor(x)
        """,
        """
        import torch

        def f(x):
            return torch.as_tensor(x, dtype=torch.float32)
        """,
        """
        import torch

        def f(x):
            return torch.as_tensor(x)  # torchlint: disable=implicit-dtype
        """,
    ),
    "implicit-rng": (
        "ops/mod.py",
        """
        import torch

        def pick(n, dev):
            return torch.randperm(n, device=dev)
        """,
        """
        import torch

        def pick(n, dev, seed=0):
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            return torch.randperm(n, generator=g, device=dev)
        """,
        """
        import torch

        def pick(n, dev):
            return torch.randperm(n, device=dev)  # torchlint: disable=implicit-rng
        """,
    ),
    "atomic-scatter": (
        "ops/mod.py",
        """
        def accumulate(out, idx, val):
            return out.index_add_(0, idx, val)
        """,
        """
        from ._scatter import scatter_sum

        def accumulate(out, idx, val):
            return scatter_sum(out, idx, val)
        """,
        """
        def accumulate(out, idx, val):
            # torchlint: disable=atomic-scatter -- int64 counts
            return out.index_add_(0, idx, val)
        """,
    ),
    "silent-except": (
        "hw/mod.py",
        """
        def probe(ports):
            for p in ports:
                try:
                    return open_port(p)
                except Exception:
                    continue
        """,
        """
        def probe(ports):
            for p in ports:
                try:
                    return open_port(p)
                except (OSError, ValueError) as e:
                    log.debug("no device on %s: %s", p, e)
        """,
        """
        def probe(ports):
            for p in ports:
                try:
                    return open_port(p)
                except Exception:  # jaxlint: disable=silent-except -- probe loop
                    continue
        """,
    ),
}

# rule → (triggering {rel_path: source}, clean {…}, suppressed {…}), as in
# tests/test_jaxlint.py (the suppressions in jaxlint's spelling; the port's
# copy of a tree swaps in its own).
PROJECT_FIXTURES = {
    "lock-order": (
        {"serve/locks.py": """
            import threading

            class S:
                def __init__(self):
                    self._la = threading.Lock()
                    self._lb = threading.Lock()

                def one(self):
                    with self._la:
                        with self._lb:
                            pass

                def two(self):
                    with self._lb:
                        with self._la:
                            pass
            """},
        {"serve/locks.py": """
            import threading

            class S:
                def __init__(self):
                    self._la = threading.Lock()
                    self._lb = threading.Lock()

                def one(self):
                    with self._la:
                        with self._lb:
                            pass

                def two(self):
                    with self._la:
                        with self._lb:
                            pass
            """},
        {"serve/locks.py": """
            import threading

            class S:
                def __init__(self):
                    self._la = threading.Lock()
                    self._lb = threading.Lock()

                def one(self):
                    with self._la:
                        with self._lb:  # jaxlint: disable=lock-order -- startup only
                            pass

                def two(self):
                    with self._lb:
                        with self._la:  # jaxlint: disable=lock-order -- startup only
                            pass
            """},
    ),
    "blocking-under-lock": (
        {"serve/cachez.py": """
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()

                def load(self, path):
                    with self._lock:
                        return open(path).read()
            """},
        {"serve/cachez.py": """
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()

                def load(self, path):
                    with self._lock:
                        cached = dict(x=1)
                    return open(path).read()
            """},
        {"serve/cachez.py": """
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()

                def load(self, path):
                    with self._lock:
                        return open(path).read()  # jaxlint: disable=blocking-under-lock -- tiny file
            """},
    ),
    "unlocked-shared-state": (
        {"serve/state.py": """
            import threading

            SHARED = {}

            def worker():
                SHARED["k"] = 1

            def spawn():
                threading.Thread(target=worker).start()

            def main_path():
                SHARED["j"] = 2
            """},
        {"serve/state.py": """
            import threading

            SHARED = {}
            _LOCK = threading.Lock()

            def worker():
                with _LOCK:
                    SHARED["k"] = 1

            def spawn():
                threading.Thread(target=worker).start()

            def main_path():
                with _LOCK:
                    SHARED["j"] = 2
            """},
        {"serve/state.py": """
            import threading

            SHARED = {}

            def worker():
                SHARED["k"] = 1  # jaxlint: disable=unlocked-shared-state -- write-once init

            def spawn():
                threading.Thread(target=worker).start()

            def main_path():
                SHARED["j"] = 2  # jaxlint: disable=unlocked-shared-state -- write-once init
            """},
    ),
}

# tests/test_jaxlint.py's cross-module, with-open and per-access trees.
EXTRA_TREES = {
    "cross-module lock order": {
        "serve/a.py": """
            import threading

            from . import b

            class A:
                def __init__(self):
                    self._la = threading.Lock()
                    self.helper = b.B()

                def path1(self):
                    with self._la:
                        self.helper.grab()
            """,
        "serve/b.py": """
            import threading

            class B:
                def __init__(self):
                    self._lb = threading.Lock()

                def grab(self):
                    with self._lb:
                        pass

                def path2(self, a):
                    with self._lb:
                        a.path1()
            """,
        "serve/__init__.py": "",
    },
    "with open under a lock": {"serve/withopen.py": """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def load(self, path):
                with self._lock:
                    with open(path) as f:
                        return f.read()
        """},
    "guarded then unguarded": {"serve/mixed.py": """
        import threading

        SHARED = {}
        _LOCK = threading.Lock()

        def worker():
            with _LOCK:
                SHARED["k"] = 1
            SHARED.pop("k", None)       # unguarded, two lines later

        def spawn():
            threading.Thread(target=worker).start()

        def main_path():
            with _LOCK:
                SHARED["j"] = 2
        """},
    "tests and scripts exempt": {
        "tests/cachez.py": PROJECT_FIXTURES["blocking-under-lock"][0][
            "serve/cachez.py"],
        "scripts/locks.py": PROJECT_FIXTURES["lock-order"][0][
            "serve/locks.py"]},
}


def _port_spelling(source: str) -> str:
    return source.replace("jaxlint:", "torchlint:")


def _write(root: Path, files: dict, port: bool = False) -> Path:
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        text = textwrap.dedent(src)
        path.write_text(_port_spelling(text) if port else text,
                        encoding="utf-8")
    return root


def _lint(tmp_path: Path, rel_path: str, source: str):
    path = tmp_path / rel_path
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source), encoding="utf-8")
    return tlint.lint_file(path, rel_path)


def _found(tool, root: Path) -> set:
    """(path, line, rule) of both passes, restricted to the shared rules."""
    hits = list(tool.lint_path(root)) + list(tool.project_lint(root))
    return {(v.path, v.line, v.rule) for v in hits if v.rule in SHARED_RULES}


def _shared_trees():
    out = {}
    for rule in sorted(SHARED_RULES):
        if rule in PROJECT_FIXTURES:
            for kind, files in zip(("bad", "clean", "suppressed"),
                                   PROJECT_FIXTURES[rule]):
                out[f"{rule} {kind}"] = files
        else:
            rel, *sources = FIXTURES[rule]
            for kind, src in zip(("bad", "clean", "suppressed"), sources):
                out[f"{rule} {kind}"] = {rel: src}
    return out | EXTRA_TREES


SHARED_TREES = _shared_trees()


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


def test_registry_has_the_ports_rules():
    assert set(tlint.REGISTRY) == LEXICAL_RULES == set(FIXTURES)
    assert set(tlint.PROJECT_REGISTRY) == PROJECT_RULES
    for rule in LEXICAL_RULES | PROJECT_RULES:
        assert tlint.rule_severity(rule) == "error"
    assert tlint.BASELINE_NAME == "torchlint_baseline.json"


# ---------------------------------------------------------------------------
# The shared rules against jaxlint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tree", sorted(SHARED_TREES))
def test_shared_rules_match_jaxlint(tree, tmp_path):
    files = SHARED_TREES[tree]
    want = _found(jlint, _write(tmp_path / "jax", files))
    got = _found(tlint, _write(tmp_path / "port", files, port=True))
    assert got == want
    if tree.endswith(" bad") or tree in ("cross-module lock order",
                                         "with open under a lock",
                                         "guarded then unguarded"):
        assert got, f"{tree}: nothing found"
    elif tree.endswith((" clean", " suppressed", " exempt")):
        assert not got


# ---------------------------------------------------------------------------
# Every port rule: triggers, clean, suppressed, edge cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", sorted(LEXICAL_RULES))
@pytest.mark.parametrize("kind", ["bad", "clean", "suppressed"])
def test_rule_fixture(rule, kind, tmp_path):
    rel_path, bad, clean, suppressed = FIXTURES[rule]
    source = {"bad": bad, "clean": clean,
              "suppressed": _port_spelling(suppressed)}[kind]
    hits = [v for v in _lint(tmp_path, rel_path, source) if v.rule == rule]
    if kind == "bad":
        assert hits, f"{rule} fixture did not trigger"
    else:
        assert not hits, f"{rule} fired on the {kind} fixture: {hits}"


@pytest.mark.parametrize("rule", sorted(PROJECT_RULES))
@pytest.mark.parametrize("kind", ["bad", "clean", "suppressed"])
def test_project_rule_fixture(rule, kind, tmp_path):
    files = PROJECT_FIXTURES[rule][("bad", "clean", "suppressed").index(kind)]
    _write(tmp_path, files, port=True)
    hits = [v for v in tlint.project_lint(tmp_path) if v.rule == rule]
    assert bool(hits) == (kind == "bad"), hits


# (rel_path, source, the port rules that must fire — exactly these).
EDGE_CASES = {
    "kernel import in a module-scope if": ("ops/mod.py", """
        import os

        if os.environ.get("CARD"):
            from ..kernels import build
        """, {"kernel-import"}),
    "triton in a module-scope try": ("ops/mod.py", """
        try:
            import triton
        except ImportError:
            triton = None
        """, {"kernel-import"}),
    "cpp_extension in a class body": ("ops/mod.py", """
        class K:
            from torch.utils import cpp_extension
        """, {"kernel-import"}),
    "absolute kernels import": ("serve/mod.py", """
        import structured_light_for_3d_model_replication_tpu_torch.kernels.build
        """, {"kernel-import"}),
    "kernels/ itself": ("kernels/build.py", """
        import triton
        from . import build
        """, set()),
    "kernel import in tests/": ("tests/test_mod.py", """
        from ..kernels import build
        """, set()),
    "jax inside a function": ("models/mod.py", """
        def f():
            import jax.numpy as jnp
            return jnp
        """, {"foreign-import"}),
    "jaxlib": ("models/mod.py", "import jaxlib\n", {"foreign-import"}),
    "the JAX package by its exact name": ("models/mod.py", """
        import structured_light_for_3d_model_replication_tpu as ref
        """, {"foreign-import"}),
    "the port's own name": ("models/mod.py", """
        import structured_light_for_3d_model_replication_tpu_torch.ops
        from structured_light_for_3d_model_replication_tpu_torch import cli
        """, set()),
    "a relative import": ("models/mod.py", """
        from ..analysis import core
        """, set()),
    "to cpu then numpy": ("models/mod.py", """
        def f(t):
            return t.to("cpu").numpy(), t.to(device="cpu").numpy()
        """, set()),
    "numpy(force=True)": ("models/mod.py", """
        def f(t):
            return t.numpy(force=True)
        """, set()),
    "np.asarray of a torch call": ("models/mod.py", """
        import numpy as np
        import torch

        def f(xs):
            return np.asarray(torch.stack(xs))
        """, {"host-read"}),
    "np.asarray of a torch call copied to the host": ("models/mod.py", """
        import numpy as np
        import torch

        def f(xs, out):
            np.copyto(out, torch.stack(xs).cpu())
            return np.asarray(torch.stack(xs).cpu())
        """, set()),
    "torch.tensor with dtype": ("ops/mod.py", """
        import torch

        def f(x):
            return torch.tensor(x, dtype=torch.int64)
        """, set()),
    "torch.tensor outside ops/": ("models/mod.py", """
        import torch

        def f(x):
            return torch.tensor(x)
        """, set()),
    "the global seed": ("models/mod.py", """
        import torch

        torch.manual_seed(0)
        """, {"implicit-rng"}),
    "an in-place draw": ("splat/mod.py", """
        def init(w):
            return w.normal_(0.0, 0.01)
        """, {"implicit-rng"}),
    "draws with a generator": ("splat/mod.py", """
        import torch

        def init(w, g):
            return w.normal_(0.0, 0.01, generator=g), torch.rand(3, generator=g)
        """, set()),
    "numpy's generator": ("models/mod.py", """
        import numpy as np

        def f(n):
            return np.random.default_rng(0).normal(size=n)
        """, set()),
    "index_put_ accumulating": ("ops/mod.py", """
        def f(J, ix, v):
            J.index_put_(ix, v, accumulate=True)
            J.index_put_(ix, v, True)
            return J.index_put_(ix, v, accumulate=False)
        """, {"atomic-scatter"}),
    "ops/_scatter.py itself": ("ops/_scatter.py", """
        def scatter_sum(out, idx, val):
            return out.index_add_(0, idx, val)
        """, set()),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_rule_edge_case(case, tmp_path):
    rel_path, source, want = EDGE_CASES[case]
    hits = _lint(tmp_path, rel_path, source)
    assert {v.rule for v in hits} == want, hits


def test_index_put_counts_each_accumulating_call(tmp_path):
    rel_path, source, _ = EDGE_CASES["index_put_ accumulating"]
    assert len(_lint(tmp_path, rel_path, source)) == 2


def test_checkout_is_linted_as_the_ports_package(tmp_path):
    """A tree holding the port's package is linted as that package: the
    JAX package beside it, which imports jax, is never read."""
    _write(tmp_path, {
        "structured_light_for_3d_model_replication_tpu/ops/mod.py":
            "import jax\n",
        "structured_light_for_3d_model_replication_tpu_torch/__init__.py": "",
        "structured_light_for_3d_model_replication_tpu_torch/ops/mod.py":
            FIXTURES["atomic-scatter"][1]})
    assert tlint.resolve_root(tmp_path).name == tlint.PACKAGE
    assert [(v.path, v.rule) for v in tlint.lint_path(tmp_path)] == \
        [("ops/mod.py", "atomic-scatter")]


# ---------------------------------------------------------------------------
# Baseline machinery against jaxlint's
# ---------------------------------------------------------------------------

DTYPE_BAD = {"jax": FIXTURES["implicit-dtype"][1].replace(
    "import torch", "import jax.numpy as jnp").replace(
    "torch.as_tensor(x)", "jnp.asarray(x)"),
    "port": FIXTURES["implicit-dtype"][1]}
EXTRA_DTYPE = {"jax": "import jax.numpy as jnp\n\ndef g(y):\n"
                      "    return jnp.array(y)\n",
               "port": "import torch\n\ndef g(y):\n"
                       "    return torch.tensor(y)\n"}
TOOLS = {"jax": (jaxlint_main, "jaxlint_baseline.json"),
         "port": (torchlint_main, "torchlint_baseline.json")}


def _scenario(name: str, tool: str, root: Path, capsys) -> list:
    """Run one baseline scenario with ``tool``; returns its transcript:
    exit codes, baseline entries and the baseline notices, with the tool's
    name taken out."""
    main, baseline_name = TOOLS[tool]
    baseline = root / baseline_name
    out: list = []

    def run(*args):
        out.append(main([*map(str, args)]))
        err = capsys.readouterr().err
        err = err.replace("torchlint", "TOOL").replace("jaxlint", "TOOL")
        out.append(sorted(line for line in err.splitlines()
                          if "baseline entr" in line))

    def entries():
        # Each tool's placeholder names its own documentation.
        out.append([e | {"justification": "TODO"}
                    if e["justification"].startswith("TODO") else e
                    for e in json.loads(baseline.read_text(
                        encoding="utf-8"))["entries"]])

    def put(rel, src):
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src), encoding="utf-8")

    def put_baseline(items):
        baseline.write_text(json.dumps({"entries": items}), encoding="utf-8")

    bad = DTYPE_BAD[tool]
    if name == "update, grandfather, ratchet":
        put("ops/mod.py", bad)
        run("--check", root, "-q")
        run("--check", root, "--update-baseline")
        entries()
        run("--check", root, "-q")
        run("--check", root, "-q", "--no-baseline")
        put("ops/mod.py", textwrap.dedent(bad) + EXTRA_DTYPE[tool])
        run("--check", root, "-q")
    elif name == "dead entry fails and prunes":
        put("ops/mod.py", bad)
        put_baseline([
            {"path": "ops/mod.py", "rule": "implicit-dtype", "count": 1,
             "justification": "live"},
            {"path": "ops/gone.py", "rule": "implicit-dtype", "count": 2,
             "justification": "file was deleted"}])
        run("--check", root)
        run("--check", root, "--prune-baseline")
        entries()
        run("--check", root, "-q")
    elif name == "stale but alive only warns":
        put("ops/mod.py", bad)
        put_baseline([{"path": "ops/mod.py", "rule": "implicit-dtype",
                       "count": 3, "justification": "was three"}])
        run("--check", root)
        run("--check", root, "--prune-baseline")
        entries()
    elif name == "subtree keeps its ancestor's entries":
        put("pkg/ops/mod.py", bad)
        run("--check", root, "--update-baseline")
        run("--check", root / "pkg", "-q")
        run("--check", root / "pkg" / "ops", "-q", "--prune-baseline")
        entries()
        put("pkg/ops/extra.py", EXTRA_DTYPE[tool])
        run("--check", root / "pkg", "-q")
    elif name == "subtree update keeps unlinted entries":
        for sub in ("a", "b"):
            put(f"{sub}/ops/mod.py", bad)
        run("--check", root, "--update-baseline")
        put("a/ops/mod.py", "x = 1\n")
        run("--check", root / "a", "--update-baseline")
        entries()
        run("--check", root, "-q")
    elif name == "dead entry outside the subtree is kept":
        put("a/ops/mod.py", bad)
        put_baseline([
            {"path": "a/ops/mod.py", "rule": "implicit-dtype", "count": 1,
             "justification": "live"},
            {"path": "b/ops/other.py", "rule": "implicit-dtype", "count": 1,
             "justification": "b/ is not linted here"}])
        run("--check", root / "a")
        run("--check", root / "a", "--prune-baseline")
        entries()
    elif name == "fast run keeps project entries":
        put("serve/locks.py", PROJECT_FIXTURES["lock-order"][0][
            "serve/locks.py"])
        put("ops/mod.py", bad)
        run("--check", root, "--update-baseline")
        run("--check", root, "-q", "--fast")
        run("--check", root, "-q", "--fast", "--prune-baseline")
        run("--check", root, "--fast", "--update-baseline")
        entries()
        run("--check", root, "-q")
    elif name == "parse errors are never baselined":
        put("mod.py", "def f(:\n")
        run("--check", root, "--update-baseline")
        entries()
        run("--check", root, "-q")
    elif name == "corrupt baseline":
        put("mod.py", "x = 1\n")
        baseline.write_text("{not json", encoding="utf-8")
        run("--check", root, "--update-baseline")
        run("--check", root, "-q")
        baseline.write_text(json.dumps({"no": "entries"}), encoding="utf-8")
        run("--check", root, "-q")
    return out


BASELINE_SCENARIOS = (
    "update, grandfather, ratchet", "dead entry fails and prunes",
    "stale but alive only warns", "subtree keeps its ancestor's entries",
    "subtree update keeps unlinted entries",
    "dead entry outside the subtree is kept",
    "fast run keeps project entries", "parse errors are never baselined",
    "corrupt baseline")


@pytest.mark.parametrize("scenario", BASELINE_SCENARIOS)
def test_baseline_scenario_matches_jaxlint(scenario, tmp_path, capsys):
    want = _scenario(scenario, "jax", tmp_path / "jax", capsys)
    got = _scenario(scenario, "port", tmp_path / "port", capsys)
    assert got == want


def test_baseline_api_matches_jaxlint(tmp_path):
    """make_baseline / apply_baseline on the same findings: grandfather,
    a group over its count surfacing whole, a fixed file's stale entry,
    and justifications kept."""
    results = {}
    for tool, mod in (("jax", jlint), ("port", tlint)):
        root = tmp_path / tool
        rel = "ops/mod.py"
        path = root / rel
        path.parent.mkdir(parents=True)
        path.write_text(textwrap.dedent(DTYPE_BAD[tool]), encoding="utf-8")
        found = mod.lint_file(path, rel)
        doc = mod.make_baseline(found)
        doc["entries"][0]["justification"] = "an intentional probe"
        kept = mod.make_baseline(found, doc)
        path.write_text(textwrap.dedent(DTYPE_BAD[tool]) + EXTRA_DTYPE[tool],
                        encoding="utf-8")
        more = mod.lint_file(path, rel)
        runs = [mod.apply_baseline(found, doc), mod.apply_baseline(more, doc),
                mod.apply_baseline([], doc)]
        results[tool] = (
            [(len(new), gf, stale) for new, gf, stale in runs],
            [{k: e[k] for k in ("path", "rule", "count", "justification")}
             for e in kept["entries"]])
    assert results["port"] == results["jax"]
    assert results["port"][1][0]["justification"] == "an intentional probe"


# ---------------------------------------------------------------------------
# SARIF
# ---------------------------------------------------------------------------


def _sarif_results(doc: dict) -> list:
    return sorted(
        (r["ruleId"], r["level"],
         r["locations"][0]["physicalLocation"]["artifactLocation"]["uri"],
         r["locations"][0]["physicalLocation"]["region"]["startLine"],
         r["locations"][0]["physicalLocation"]["region"]["startColumn"])
        for r in doc["runs"][0]["results"])


def test_sarif_matches_jaxlint_but_the_tool(tmp_path, capsys):
    files = dict(PROJECT_FIXTURES["lock-order"][0])
    files["hw/probe.py"] = FIXTURES["silent-except"][1]
    docs, rcs = {}, {}
    for tool, (main, _) in TOOLS.items():
        tree = dict(files)
        tree["ops/lex.py"] = DTYPE_BAD[tool]
        root = _write(tmp_path / tool, tree)
        sarif = tmp_path / f"{tool}.sarif"
        rcs[tool] = main(["--check", str(root), "-q", "--sarif", str(sarif)])
        docs[tool] = json.loads(sarif.read_text(encoding="utf-8"))
    capsys.readouterr()
    assert rcs == {"jax": 1, "port": 1}
    port, ref = docs["port"], docs["jax"]
    assert port["runs"][0]["tool"]["driver"]["name"] == "torchlint"
    assert ref["runs"][0]["tool"]["driver"]["name"] == "jaxlint"
    assert (port["$schema"], port["version"]) == (ref["$schema"],
                                                  ref["version"])
    assert _sarif_results(port) == _sarif_results(ref)
    assert {r[0] for r in _sarif_results(port)} == {
        "lock-order", "silent-except", "implicit-dtype"}
    ids = [r["id"] for r in port["runs"][0]["tool"]["driver"]["rules"]]
    assert set(ids) == LEXICAL_RULES | PROJECT_RULES
    for res in port["runs"][0]["results"]:
        assert ids[res["ruleIndex"]] == res["ruleId"]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

CLI_CASES = {
    "clean tree": ({"ops/mod.py": "x = 1\n"}, []),
    "a silent except": ({"hw/mod.py": FIXTURES["silent-except"][1]}, []),
    "a lock-order inversion": (PROJECT_FIXTURES["lock-order"][0], []),
    "lock-order with --fast": (PROJECT_FIXTURES["lock-order"][0],
                               ["--fast"]),
    "no such path": ({}, ["missing"]),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_exit_codes_match_jaxlint(case, tmp_path, capsys):
    """``cli lint`` (both front ends) and the analysis module's own entry
    point: the same exit code in each tool on the same tree."""
    files, extra = CLI_CASES[case]
    rcs = {}
    for tool, main, front in (("jax", jaxlint_main, jcli_lint.main),
                              ("port", torchlint_main, cli_lint.main)):
        root = _write(tmp_path / tool, files)
        paths = [str(root / extra[0])] if extra == ["missing"] else [
            str(root)]
        flags = [] if extra == ["missing"] else extra
        rcs[tool] = (main(["--check", *paths, "-q", *flags]),
                     front([*paths, "-q", *flags]))
    capsys.readouterr()
    assert rcs["port"] == rcs["jax"]
    assert rcs["port"][0] == {"clean tree": 0, "no such path": 2,
                              "lock-order with --fast": 0}.get(case, 1)


def test_cli_usage_and_list_rules(capsys):
    assert torchlint_main([]) == jaxlint_main([]) == 2
    capsys.readouterr()
    assert cli_lint.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    listed = {line.split(" ")[0] for line in out.splitlines()}
    assert listed == LEXICAL_RULES | PROJECT_RULES
    assert out.count("(lexical") == 7 and out.count("(project") == 3


def test_ports_tree_is_clean_modulo_its_baseline(capsys):
    """``cli lint`` with no path checks the port's package against its
    committed baseline; so does a check from the repository's root."""
    assert cli_lint.main(["-q"]) == 0
    assert torchlint_main(["--check", str(PORT_DIR.parent), "-q",
                           "--fast"]) == 0
    out = capsys.readouterr().out
    assert "0 new violation(s)" in out


def test_committed_baseline_entries_are_justified():
    baseline = PORT_DIR / "torchlint_baseline.json"
    data = json.loads(baseline.read_text(encoding="utf-8"))
    assert data["entries"], "the baseline holds the port's known hits"
    for entry in data["entries"]:
        just = entry.get("justification", "")
        assert just and not just.startswith("TODO"), (
            f"baseline entry {entry['path']} [{entry['rule']}] needs a "
            "real justification")
