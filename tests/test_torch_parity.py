"""The port's module map against the JAX reference, read from the sources.

* Every ``.py`` under ``src/repro/`` has a port file at the same relative
  path under ``src/repro_torch/``.
* Every name in a reference module's ``__all__`` exists in its port
  counterpart, but ``core/routing.py: pallas_interpret_forced`` (the port
  has no interpret switch).
* Every reference module with an ``if __name__ == "__main__":`` block has
  one in the port.
* No file of ``src/repro_torch``, ``examples/torch`` or ``chip_smoke.py``
  imports ``jax``, the JAX package or the ``codo`` alias of it.

The reference is parsed with ``ast``, never imported; the port modules
are imported to look a name up.
"""

import ast
import importlib
import warnings
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

REF_FILES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))
DROPPED = {("core/routing.py", "pallas_interpret_forced")}
FORBIDDEN = ("jax", "jaxlib", "repro", "codo")


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _all_names(path: Path) -> list[str]:
    """The string entries of a module's top-level ``__all__`` literal."""
    for node in _tree(path).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return [e.value for e in ast.walk(node.value)
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    return []


def _has_main(path: Path) -> bool:
    for node in _tree(path).body:
        if isinstance(node, ast.If) and isinstance(node.test, ast.Compare):
            names = {n.id for n in ast.walk(node.test)
                     if isinstance(n, ast.Name)}
            consts = {n.value for n in ast.walk(node.test)
                      if isinstance(n, ast.Constant)}
            if "__name__" in names and "__main__" in consts:
                return True
    return False


def _module(rel: str) -> str:
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["repro_torch", *parts])


def test_the_reference_has_88_module_files():
    assert len(REF_FILES) == 88


@pytest.mark.parametrize("rel", REF_FILES)
def test_every_reference_module_has_a_port_file(rel):
    assert (PORT / rel).is_file(), f"no src/repro_torch/{rel}"


ALL_CASES = [(rel, name) for rel in REF_FILES
             for name in _all_names(REF / rel)]


@pytest.mark.parametrize("rel", sorted({rel for rel, _ in ALL_CASES}))
def test_every_exported_name_exists_in_the_port(rel):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        mod = importlib.import_module(_module(rel))
    missing = [name for r, name in ALL_CASES if r == rel
               and (r, name) not in DROPPED and not hasattr(mod, name)]
    assert not missing, f"{_module(rel)} lacks {missing}"


def test_only_the_interpret_switch_is_dropped():
    for rel, name in DROPPED:
        assert name in _all_names(REF / rel)
        assert name not in (PORT / rel).read_text()


MAIN_FILES = [rel for rel in REF_FILES if _has_main(REF / rel)]


def test_the_reference_has_nine_main_blocks():
    assert len(MAIN_FILES) == 9


@pytest.mark.parametrize("rel", MAIN_FILES)
def test_every_main_block_has_a_port_counterpart(rel):
    assert _has_main(PORT / rel), f"src/repro_torch/{rel} has no __main__"


PORT_SOURCES = sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + [p.relative_to(ROOT).as_posix()
       for p in (ROOT / "examples" / "torch").glob("*.py")]
    + ["chip_smoke.py", "src/codo_torch.py"])


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_the_port_sources_include_the_examples():
    names = {Path(p).name for p in PORT_SOURCES if "examples" in p}
    assert names == {"compile_resnet18.py", "pipeline_parallel.py",
                     "quickstart.py", "serve_lm.py", "train_lm.py"}


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_no_port_file_imports_jax_or_the_reference(rel):
    bad = _imported_roots(ROOT / rel) & set(FORBIDDEN)
    assert not bad, f"{rel} imports {sorted(bad)}"
