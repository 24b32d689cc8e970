"""Weight layout conversion (counterpart of
``sketchedit_tpu/params/torch_convert.py``).

The JAX package keeps each net as ``{layer: {"w": HWIO, "b": (O,)}}``, with
the discriminator's power-iteration vector ``"u": (O,)`` beside them and
the multiscale discriminator's layers nested under ``scaleI``. The port's
modules take a state dict ``{"<layer>.weight": OIHW, "<layer>.bias": (O,),
"<layer>.u": (O,)}`` (nested layers joined with dots), which is also the
reference ``.pth`` layout. Both directions are here, so the port reads what
the JAX package saves and saves what it loads.
"""

from __future__ import annotations

import numpy as np
import torch

_PREFIX = "module."


def strip_module_prefix(state_dict):
    """Drop a leading ``module.`` (DataParallel residue) from every key."""
    return {(k[len(_PREFIX):] if k.startswith(_PREFIX) else k): v
            for k, v in state_dict.items()}


def jax_params_to_state_dict(params_np, prefix: str = "") -> dict:
    """Nested ``{layer: {"w": HWIO, "b", "u"?}}`` numpy arrays -> state
    dict."""
    out = {}
    for name, node in params_np.items():
        layer = f"{prefix}{name}"
        if "w" not in node:
            out.update(jax_params_to_state_dict(node, f"{layer}."))
            continue
        w = np.asarray(node["w"], dtype=np.float32)
        if w.ndim != 4:
            raise ValueError(f"{layer}: expected an HWIO conv weight, got "
                             f"shape {w.shape}")
        out[f"{layer}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        out[f"{layer}.bias"] = torch.from_numpy(
            np.asarray(node["b"], dtype=np.float32).copy())
        if "u" in node:
            out[f"{layer}.u"] = torch.from_numpy(
                np.asarray(node["u"], dtype=np.float32).copy())
    return out


_LEAVES = {"weight": "w", "bias": "b", "u": "u"}


def state_dict_to_jax_params(state_dict) -> dict:
    """State dict -> nested ``{layer: {"w": HWIO, "b", "u"?}}`` float32
    numpy arrays, the JAX package's layout."""
    out: dict = {}
    for key, t in state_dict.items():
        path, leaf = key.rsplit(".", 1)
        if leaf not in _LEAVES:
            raise ValueError(f"unexpected state-dict entry {key!r}")
        node = out
        for part in path.split("."):
            node = node.setdefault(part, {})
        a = t.detach().to("cpu", torch.float32).numpy()
        node[_LEAVES[leaf]] = (np.ascontiguousarray(a.transpose(2, 3, 1, 0))
                               if leaf == "weight" else a.copy())
    return out
