"""The port stands alone: no module of ``sketchedit_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and every module imports
on a machine with neither a GPU nor a CUDA toolkit."""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "sketchedit_tpu_torch").rglob("*.py"))
SCANNED = PORT_FILES + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "sketchedit_tpu")


def test_scan_covers_the_port():
    assert len(PORT_FILES) > 20
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", SCANNED, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_catches_forbidden_imports(tmp_path):
    src = tmp_path / "bad.py"
    src.write_text("import jax.numpy as jnp\n"
                   "from sketchedit_tpu.ops import attention\n"
                   "import sketchedit_tpu\n"
                   "from sketchedit_tpu_torch.ops import image\n")
    assert [m for m in _imported_modules(src) if _forbidden(m)] == [
        "jax.numpy", "sketchedit_tpu.ops", "sketchedit_tpu"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_without_cuda(path):
    rel = path.relative_to(ROOT).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    importlib.import_module(".".join(parts))
