"""The port's public surface against the JAX package's, by signature.

For every public function, method and class (dataclass and NamedTuple
fields included) of the JAX package whose counterpart exists in the port,
every parameter and field the JAX one has must exist in the port's; every
name a JAX ``__init__.py`` exports must import from the port's package.
Counterparts live at the same module path, or at the renamed ones:
``ops/marching_jax.py`` → ``ops/marching_device.py`` and ``native.py`` →
``_native.py``.

The JAX package is read with ``ast`` and never imported. The only
exceptions are :data:`ALLOWED`, whose keys are exactly the rows of the
README's table of deliberate differences (checked below).
"""

import ast
import importlib
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_DIR = REPO / "structured_light_for_3d_model_replication_tpu"
PORT_DIR = REPO / "structured_light_for_3d_model_replication_tpu_torch"
PORT = PORT_DIR.name
RENAMED = {"ops/marching_jax.py": "ops/marching_device.py",
           "native.py": "_native.py"}

# The README's "Deliberate differences from the JAX package" rows, by
# their first column. Each lists what it excuses:
#   params    — a parameter or field of that name, anywhere;
#   members   — (module, qualified name, parameter) triples;
#   modules   — JAX modules with no port module (a glob);
#   exports   — (package, name) exports the port does not have;
#   names     — (module, name) public functions or classes the port does
#               not have;
#   renamed   — (module, JAX name, port name): the port has the other name.
ALLOWED = {
    # A jax.random key becomes a torch.Generator (``generator=``) or an int
    # ``seed=``.
    "key": dict(params={"key"}),
    # The tensor's device picks the kernel or its plain version; nothing
    # runs the plain version on the card.
    "use_pallas": dict(params={"use_pallas", "interpret"},
                       members={("ops/decode.py", "decode_stack",
                                 "backend")}),
    # A jit factory becomes a plain function.
    "reconstruct_batch_fn": dict(renamed={("models/pipeline.py",
                                           "reconstruct_batch_fn",
                                           "reconstruct_batch")}),
    # The TPU gate has no counterpart.
    "tpu_backend": dict(modules={"ops/_backend.py"}),
    # The Pallas kernels are CUDA sources in csrc/.
    "pallas modules": dict(modules={"ops/*_pallas.py"}),
    # Knobs that select a TPU path or that nothing sets: an option is not
    # added for parity alone.
    "unused knobs": dict(
        members={("ops/knn.py", "knn", "k_tile"),
                 ("ops/knn.py", "knn", "method"),
                 ("ops/knn.py", "knn", "fast_dots"),
                 ("ops/mortonknn.py", "morton_knn", "passes"),
                 ("ops/pointcloud.py", "voxel_downsample", "with_attrs"),
                 ("stream/session.py", "StreamParams", "max_stops")}),
    # Configuration records that no path of either package reads.
    "unused config": dict(
        names={("config.py", n) for n in ("MergeConfig", "MeshConfig",
                                          "CaptureConfig", "SystemConfig")}),
    # jaxlint's tracing rules: nothing in the port traces.
    "tracing rules": dict(
        modules={"analysis/rules_recompile.py"},
        exports={("analysis", "rules_recompile")},
        members={("analysis/callgraph.py", "FunctionInfo", f)
                 for f in ("jitted", "jit_call", "static_names", "donated",
                           "sharded")}),
}


def _params(fn) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _surface(path: Path) -> dict[str, list[str]]:
    """Public top-level functions and classes (their annotated fields) and
    the classes' public methods and ``__init__`` → parameter names."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = [s.target.id for s in node.body
                              if isinstance(s, ast.AnnAssign)
                              and isinstance(s.target, ast.Name)]
            for s in node.body:
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (not s.name.startswith("_")
                             or s.name == "__init__"):
                    out[f"{node.name}.{s.name}"] = _params(s)
    return out


def _jax_modules() -> list[str]:
    return sorted(p.relative_to(JAX_DIR).as_posix()
                  for p in JAX_DIR.rglob("*.py"))


def _excused_module(rel: str, used: set) -> bool:
    for row, spec in ALLOWED.items():
        if any(Path(rel).match(g) for g in spec.get("modules", ())):
            used.add(row)
            return True
    return False


def _excused_param(rel: str, qual: str, name: str, used: set) -> bool:
    for row, spec in ALLOWED.items():
        if name in spec.get("params", ()) \
                or (rel, qual, name) in spec.get("members", ()):
            used.add(row)
            return True
    return False


def _excused_name(rel: str, qual: str, used: set) -> bool:
    for row, spec in ALLOWED.items():
        if (rel, qual.split(".")[0]) in spec.get("names", ()):
            used.add(row)
            return True
    return False


def _walk(used: set) -> list[str]:
    missing = []
    for rel in _jax_modules():
        port = PORT_DIR / RENAMED.get(rel, rel)
        if not port.exists():
            if not _excused_module(rel, used):
                missing.append(f"{rel}: no port module")
            continue
        ours = _surface(port)
        for qual, names in _surface(JAX_DIR / rel).items():
            if qual not in ours:
                _excused_name(rel, qual, used)
                continue
            for name in names:
                if name not in ours[qual] \
                        and not _excused_param(rel, qual, name, used):
                    missing.append(f"{rel}:{qual}({name})")
    return missing


def test_every_jax_parameter_and_field_exists_in_the_port():
    assert _walk(set()) == []


def _exports(init: Path) -> set[str]:
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            names |= {e.value for e in node.value.elts}
    return names - {"*"}


def _missing_exports(used: set) -> list[str]:
    missing = []
    for init in sorted(JAX_DIR.rglob("__init__.py")):
        pkg = init.parent.relative_to(JAX_DIR).as_posix()
        mod_name = PORT if pkg == "." else f"{PORT}.{pkg.replace('/', '.')}"
        mod = importlib.import_module(mod_name)
        for name in sorted(_exports(init)):
            if hasattr(mod, name):
                continue
            try:
                importlib.import_module(f"{mod_name}.{name}")
                continue
            except ImportError:
                pass
            hit = [row for row, spec in ALLOWED.items()
                   if (pkg, name) in spec.get("exports", ())]
            if hit:
                used.update(hit)
            else:
                missing.append(f"{mod_name}.{name}")
    return missing


def test_every_jax_package_export_imports_from_the_port():
    assert _missing_exports(set()) == []


def test_renamed_names_are_the_ports():
    used = set()
    for row, spec in ALLOWED.items():
        for rel, jax_name, port_name in spec.get("renamed", ()):
            jax_names = _surface(JAX_DIR / rel)
            ours = _surface(PORT_DIR / rel)
            assert jax_name in jax_names and jax_name not in ours
            assert port_name in ours
            used.add(row)
    assert used == {"reconstruct_batch_fn"}


def _readme_rows() -> set[str]:
    text = (REPO / "README.md").read_text()
    m = re.search(r"^#+ Deliberate differences from the JAX package\n"
                  r"(.*?)(?=^#)", text, re.S | re.M)
    assert m, "README.md lacks the table of deliberate differences"
    rows = set()
    for line in m.group(1).splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if line.startswith("|") and not set(cells[0]) <= set("-: "):
            rows.add(cells[0].strip("`"))
    return rows - {"Row"}


def test_allowlist_is_the_readme_table_and_each_row_is_needed():
    """The allowlist holds exactly the README table's rows, and every row
    still excuses something (a row nothing needs must go from both)."""
    assert set(ALLOWED) == _readme_rows()
    used = set()
    _walk(used)
    _missing_exports(used)
    used.add("reconstruct_batch_fn")   # held by test_renamed_names_are_the_ports
    assert used == set(ALLOWED)


@pytest.mark.parametrize("rel", ["stream/session.py", "ops/poisson_sparse.py",
                                 "ops/mortonknn.py", "ops/knn.py",
                                 "models/oracle.py", "config.py",
                                 "ops/pointcloud.py", "models/synthetic.py"])
def test_this_slices_modules_have_no_gap_left(rel):
    """The modules whose gaps this guard first found: each public name of
    the JAX module has its counterpart, parameters included."""
    ours = _surface(PORT_DIR / rel)
    for qual, names in _surface(JAX_DIR / rel).items():
        if _excused_name(rel, qual, set()):
            continue
        assert qual in ours, f"{rel}: {qual} missing"
        gaps = [n for n in names if n not in ours[qual]
                and not _excused_param(rel, qual, n, set())]
        assert gaps == [], f"{rel}:{qual} lacks {gaps}"
