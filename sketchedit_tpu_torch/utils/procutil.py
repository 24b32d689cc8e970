"""Child-process hygiene for harnesses that spawn servers holding the GPU
(a copy of ``sketchedit_tpu/utils/procutil.py``).

A test fixture or benchmark script that is SIGKILLed (shell timeout, OOM
killer, a dropped connection) never runs its cleanup, and its child
serve_api/train process lingers holding the device — an orphaned idle
server skews every later benchmark and can block ports. Pass
``preexec_fn=die_with_parent`` to ``subprocess.Popen`` so the kernel
SIGTERMs the child the moment its parent dies (Linux PR_SET_PDEATHSIG).
"""

from __future__ import annotations

import signal

# resolve libc at import time: the preexec_fn runs in the forked child
# BEFORE exec, where running the import machinery can deadlock if a
# parent thread held the import lock at fork (executor daemon
# threads are live in these processes)
try:
    import ctypes
    _libc = ctypes.CDLL("libc.so.6", use_errno=True)
except Exception:       # non-Linux / no libc: best-effort only
    _libc = None

_PR_SET_PDEATHSIG = 1


def die_with_parent():
    """Popen preexec_fn: deliver SIGTERM to this child when the parent
    exits for any reason (including SIGKILL of the parent). Body is a
    single syscall — safe in the post-fork pre-exec window."""
    if _libc is not None:
        _libc.prctl(_PR_SET_PDEATHSIG, signal.SIGTERM)
