"""Weight layout conversion (counterpart of
``sketchedit_tpu/params/torch_convert.py``).

The JAX package keeps each net as ``{layer: {"w": HWIO, "b": (O,)}}``; the
port's modules take a state dict ``{"<layer>.weight": OIHW,
"<layer>.bias": (O,)}``, which is also the reference ``.pth`` layout.
"""

from __future__ import annotations

import numpy as np
import torch

_PREFIX = "module."


def strip_module_prefix(state_dict):
    """Drop a leading ``module.`` (DataParallel residue) from every key."""
    return {(k[len(_PREFIX):] if k.startswith(_PREFIX) else k): v
            for k, v in state_dict.items()}


def jax_params_to_state_dict(params_np) -> dict[str, torch.Tensor]:
    """``{layer: {"w": HWIO, "b": (O,)}}`` numpy arrays -> state dict."""
    out = {}
    for layer, leaves in params_np.items():
        w = np.asarray(leaves["w"], dtype=np.float32)
        if w.ndim != 4:
            raise ValueError(f"{layer}: expected an HWIO conv weight, got "
                             f"shape {w.shape}")
        out[f"{layer}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        out[f"{layer}.bias"] = torch.from_numpy(
            np.asarray(leaves["b"], dtype=np.float32).copy())
    return out
