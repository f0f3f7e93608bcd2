"""The port imports neither ``jax`` nor anything of the JAX package
``repro``: every module of ``src/repro_torch``, the examples of
``examples_torch/`` and ``chip_smoke.py`` import with both blocked, and no
file of theirs names either in an import; the
linter ``repro_torch.analysis`` imports with torch and numpy blocked too.
Every module of the JAX package has a counterpart at the same path in the
port."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REFERENCE = ROOT / "src" / "repro"
EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))
FILES = sorted(PORT.rglob("*.py")) + EXAMPLES + [ROOT / "chip_smoke.py"]

_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None          # any import of jax or repro now fails
sys.modules["repro"] = None
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
for path in {examples!r}:
    spec = importlib.util.spec_from_file_location("example", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")
             and sys.modules[m] is not None)
assert not bad, bad
print(" ".join(names))
"""

# the linter is stdlib-only: it imports with torch and numpy blocked as well
_IMPORT_ANALYSIS = """
import importlib, pkgutil, sys
for name in ("jax", "repro", "torch", "numpy"):
    sys.modules[name] = None
sys.path[:0] = [{src!r}]
import repro_torch.analysis
names = [m.name for m in pkgutil.walk_packages(
    repro_torch.analysis.__path__, "repro_torch.analysis.")]
for name in names:
    importlib.import_module(name)
print(" ".join(names))
"""


def test_port_imports_with_jax_and_repro_blocked():
    code = _IMPORT_ALL.format(src=str(ROOT / "src"), root=str(ROOT),
                              examples=[str(p) for p in EXAMPLES])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    # the package walk reached every module of the port
    want = {".".join(("repro_torch",) + p.relative_to(PORT).with_suffix(
        "").parts).removesuffix(".__init__") for p in PORT.rglob("*.py")}
    want.discard("repro_torch")
    assert set(out.stdout.split()) == want
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ANALYSIS.format(src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert set(out.stdout.split()) == {
        n for n in want if n.startswith("repro_torch.analysis.")}


def _modules(pkg: Path):
    return sorted(p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py")
                  if "__pycache__" not in p.parts)


def test_every_reference_module_has_a_port_counterpart():
    ref = _modules(REFERENCE)
    missing = sorted(set(ref) - set(_modules(PORT)))
    assert not missing, f"{len(ref) - len(missing)} of {len(ref)}: {missing}"
    assert len(ref) == 93


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_names_jax_or_repro_in_an_import():
    bad = [(str(p.relative_to(ROOT)), m) for p in FILES
           for m in _imported(p)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert len(FILES) > 20 and len(EXAMPLES) == 4
