"""Device selection and the float32 precision switches, shared by the entry
points.

The port runs on the GPU unless the caller asks for the CPU by name: a
missing GPU is an error, never a silent move to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``cuda`` without a visible GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_precision(precision: str | None):
    """'highest' turns TF32 off in cuDNN convs and cuBLAS matmuls; cuDNN's
    TF32 default would put ~1e-3 of error into every float32 conv. These
    are process-wide PyTorch flags. None ('default') allows TF32."""
    allow = precision is None
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
