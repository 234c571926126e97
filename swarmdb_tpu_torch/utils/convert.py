"""Carry a parameter tree given as numpy arrays into the port's layout.

The JAX package keeps Llama parameters as a nested dict of arrays with
per-layer weights stacked ``[L, ...]``; the port keeps the same keys, the
same shapes and the same layouts as torch tensors. With this function both
packages can compute the same thing from the same weights: the caller
turns the JAX tree into numpy (``jax.tree.map(np.asarray, params)``) and
hands it here.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bf16: widen exactly, then narrow in torch
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))  # own, writable
    return t.to(device)


def params_from_numpy(tree: Dict[str, Any],
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device``, each leaf at its own precision (bf16 leaves stay bf16)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, dev)

    return conv(tree)
