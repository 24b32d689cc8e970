"""Build and load the CUDA kernels of ``sketchedit_tpu_torch/csrc``.

Each ``csrc/*.cu`` has a plain C interface and is compiled by ``nvcc`` into
its own shared library under ``build/sketchedit_tpu_torch/`` at the root of
the checkout, then loaded with ``ctypes``. Nothing includes PyTorch's
headers, so a build takes seconds. The library's file name carries a hash
of its source and flags, so an unchanged source is built once and reused.
All sources are compiled in parallel on first use. A failed build raises.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sketchedit_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}      # kernel name -> nvcc/ptxas output
build_seconds: float | None = None  # wall time of the last build, if any


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                       "first use and need the CUDA toolkit")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def load() -> dict[str, ctypes.CDLL]:
    """Build (where needed) and load every kernel library; returns
    ``{source stem: CDLL}``."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        sources = sorted(CSRC.glob("*.cu"))
        todo = [(s, _target(s)) for s in sources if not _target(s).exists()]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            t0 = time.perf_counter()
            procs = []
            for src, out in todo:
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((src, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for src, out, tmp, proc in procs:
                log, _ = proc.communicate()
                build_log[src.stem] = log
                if proc.returncode != 0:
                    failed.append(f"{src.name}:\n{log}")
                else:
                    os.replace(tmp, out)
            build_seconds = time.perf_counter() - t0
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for src in sources:
            _libs[src.stem] = ctypes.CDLL(str(_target(src)))
        return _libs
