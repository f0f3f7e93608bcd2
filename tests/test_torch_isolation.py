"""The port imports neither ``jax`` nor anything of the JAX package
``repro``: every module of ``src/repro_torch`` and ``chip_smoke.py`` import
with both blocked, and no file of theirs names either in an import."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax or repro now fails
sys.modules["repro"] = None
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")
             and sys.modules[m] is not None)
assert not bad, bad
print(" ".join(names))
"""


def test_port_imports_with_jax_and_repro_blocked():
    code = _IMPORT_ALL.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    # the package walk reached every module of the port
    want = {".".join(("repro_torch",) + p.relative_to(PORT).with_suffix(
        "").parts).removesuffix(".__init__") for p in PORT.rglob("*.py")}
    want.discard("repro_torch")
    assert set(out.stdout.split()) == want


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
    assert len(FILES) > 20
