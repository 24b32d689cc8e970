"""The port stands alone: no module of ``sketchedit_tpu_torch``, not its
scripts and not ``chip_smoke.py`` imports JAX or the JAX package, every
module imports on a machine with neither a GPU nor a CUDA toolkit, and the
data package (the code a loader worker runs for its items) imports no
torch."""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "sketchedit_tpu_torch").rglob("*.py"))
SCANNED = PORT_FILES + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "scripts").glob("*_torch.py"))
DATA_FILES = sorted((ROOT / "sketchedit_tpu_torch" / "data").glob("*.py"))


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


@pytest.mark.parametrize("rel", [
    "server/__init__.py", "server/rawproto.py", "server/letterbox.py",
    "server/executor.py", "server/composite.py", "server/face_localizer.py",
    "server/demo_server.py", "cli/serve.py", "cli/demo.py",
    "utils/procutil.py"])
def test_scan_covers_the_serving_modules(rel):
    """The serving slice's modules are among the files that the two
    parametrised checks below walk."""
    assert ROOT / "sketchedit_tpu_torch" / rel in PORT_FILES
    assert ROOT / "sketchedit_tpu_torch" / rel in SCANNED
    assert ROOT / "chip_smoke.py" in SCANNED


@pytest.mark.parametrize("rel", [
    "parallel/__init__.py", "parallel/mesh.py",
    "parallel/sharded_attention.py", "parallel/distributed.py"])
def test_scan_covers_the_parallel_modules(rel):
    """The multi-device slice's modules are among the files that the two
    parametrised checks below walk."""
    assert ROOT / "sketchedit_tpu_torch" / rel in PORT_FILES
    assert ROOT / "sketchedit_tpu_torch" / rel in SCANNED


@pytest.mark.parametrize("rel", [
    "sketchedit_tpu_torch/server/artifact.py",
    "sketchedit_tpu_torch/ops/attention.py",
    "sketchedit_tpu_torch/ops/attention_cuda.py",
    "scripts/convergence_check_torch.py",
    "scripts/export_serving_artifact_torch.py",
    "sketchedit_tpu_torch/ops/packed_tail.py",
    "scripts/packing_ab_torch.py",
    "scripts/packing_grad_numerics_torch.py"])
def test_scan_covers_the_artifact_splitcam_and_convergence_files(rel):
    """The modules and scripts of the artifact, splitcam and convergence
    slice are among the files that the import checks walk."""
    assert ROOT / rel in SCANNED


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


def test_scan_covers_the_eval_scripts():
    names = {p.name for p in SCANNED}
    assert {"edit_eval_torch.py", "mask_eval_torch.py"} <= names
    assert len(DATA_FILES) >= 5


@pytest.mark.parametrize("path", DATA_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_data_package_imports_no_torch(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] == "torch"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_without_cuda(path):
    rel = path.relative_to(ROOT).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    importlib.import_module(".".join(parts))
