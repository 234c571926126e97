"""Carry a parameter tree, a KV page pool or a dense slot cache, given as
numpy arrays, into the port's layout, and a pool back out.

The JAX package keeps Llama parameters as a nested dict of arrays with
per-layer weights stacked ``[L, ...]``; the port keeps the same keys, the
same shapes and the same layouts as torch tensors. Its page pools are
arrays ``[L, P, ps, Hkv, D]`` or, quantized, an int8 payload plus f32
scales ``[L, P, Hkv]`` -- the port's ``QuantPool`` has the same two fields.
Its dense engine's slot cache is a ``(k, v)`` pair of ``[L, B, S, Hkv,
D]`` arrays, and so is the port's. With these functions both packages can
compute the same thing from the same weights and the same KV: the caller
turns the JAX tree, pool or cache into numpy (``jax.tree.map(np.asarray,
x)``) and hands it here.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from ..ops.paged_kv import QuantPool
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


def pool_from_numpy(pool: Any, device: DeviceLike = None
                    ) -> Union[torch.Tensor, QuantPool]:
    """A page pool as numpy -> the port's pool on ``device``: an array
    stays a tensor of its dtype; anything with ``data`` and ``scale``
    fields (the JAX package's ``QuantPool``), or a ``(data, scale)`` pair,
    becomes a ``QuantPool`` (int8 payload, f32 scales).

    Any 2-tuple is read as ``(data, scale)``: a dense slot cache, which is
    a ``(k, v)`` pair, would silently become a ``QuantPool`` here (its K
    cast to int8, its V taken for scales). Carry a dense cache over with
    ``kv_cache_from_numpy``."""
    dev = resolve_device(device)
    if hasattr(pool, "data") and hasattr(pool, "scale"):
        pool = (pool.data, pool.scale)
    if isinstance(pool, tuple):
        data, scale = pool
        return QuantPool(_to_tensor(np.asarray(data, np.int8), dev),
                         _to_tensor(np.asarray(scale, np.float32), dev))
    return _to_tensor(pool, dev)


def kv_cache_from_numpy(cache: Tuple[Any, Any], device: DeviceLike = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A dense slot cache ``(k, v)`` as numpy (each ``[L, B, S, Hkv, D]``)
    -> the port's pair of tensors on ``device``, each at its own dtype."""
    dev = resolve_device(device)
    k, v = cache
    return _to_tensor(k, dev), _to_tensor(v, dev)


def pool_to_numpy(pool: Union[torch.Tensor, QuantPool]
                  ) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """The port's pool -> numpy: an f32 array (a bf16 pool widens
    exactly), or the ``(data, scale)`` pair of a quantized one."""
    if isinstance(pool, QuantPool):
        return pool.data.cpu().numpy(), pool.scale.cpu().numpy()
    if pool.dtype == torch.bfloat16:
        pool = pool.float()
    return pool.cpu().numpy()
