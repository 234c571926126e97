"""One call from a model and a device list to a serving engine.

The counterpart of the lane branch of
``swarmdb_tpu/parallel/serving.py``'s ``build_serving_engine``: paged
serving over more than one device is a ``ShardLaneGroup``, one paged
engine per device (``parallel/lanes.py``); one device gets the single
engine of ``backend.service.build_backend_engine``. The JAX package's
other branch, one GSPMD program over a mesh (``admit_overlap=False`` /
``SWARMDB_ADMIT_OVERLAP=0``, model, expert or pipeline axes, the dense
engine over several devices), is multi-GPU serving, not ported yet
(ROADMAP.md, queue 1 item 11): it raises.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..models.configs import ModelConfig, get_config
from ..utils.device import DeviceLike, resolve_device
from ..utils.metrics import MetricsRegistry
from .lanes import LaneGroupInfo, build_lane_group

__all__ = ["build_serving_engine"]


def _gspmd(why: str) -> NotImplementedError:
    return NotImplementedError(
        f"{why} needs the single-program sharded engine, which is "
        "multi-GPU serving: not ported yet (ROADMAP.md, queue 1 item 11)")


def build_serving_engine(
    model_name_or_cfg: Any,
    devices: Optional[Sequence[DeviceLike]] = None,
    *,
    max_batch: Optional[int] = None,
    max_seq: int = 1024,
    seed: int = 0,
    paged: Optional[bool] = None,
    page_size: int = 16,
    kv_pool_tokens: Optional[int] = None,
    admit_overlap: Optional[bool] = None,
    model: int = 1,
    expert: int = 1,
    pipe: int = 1,
    metrics: Optional[MetricsRegistry] = None,
    decode_chunk: int = 8,
    prefill_batch: Optional[int] = None,
    flight_dir: Optional[str] = None,
    kv_dtype: Optional[torch.dtype] = None,
    params: Optional[Dict[str, Any]] = None,
) -> Tuple[Any, LaneGroupInfo]:
    """(engine, info). ``devices`` defaults to every visible card (the
    counterpart of a mesh over ``jax.devices()``) and may repeat one;
    ``max_batch`` to 8 slots per device; ``paged=None`` reads
    ``SWARMDB_PAGED`` and ``admit_overlap=None`` ``SWARMDB_ADMIT_OVERLAP``
    (default on). ``model`` / ``expert`` / ``pipe`` are the JAX mesh's
    other axes; above 1 they raise, as does ``admit_overlap=False``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())] or [None]
    devs = [resolve_device(d) for d in devices]
    if paged is None:
        paged = os.environ.get("SWARMDB_PAGED", "0") == "1"
    if admit_overlap is None:
        admit_overlap = os.environ.get("SWARMDB_ADMIT_OVERLAP", "1") != "0"
    for axis, size in (("model", model), ("expert", expert),
                       ("pipe", pipe)):
        if size > 1:
            raise _gspmd(f"a {axis} axis of {size}")
    if not admit_overlap:
        raise _gspmd("admit_overlap=False (SWARMDB_ADMIT_OVERLAP=0)")
    cfg = (model_name_or_cfg if isinstance(model_name_or_cfg, ModelConfig)
           else get_config(model_name_or_cfg))
    n = len(devs)
    if max_batch is None:
        max_batch = 8 * n
    if n == 1:
        from ..backend.service import build_backend_engine

        engine, _tok = build_backend_engine(
            cfg, max_batch=max_batch, max_seq=max_seq, seed=seed,
            decode_chunk=decode_chunk, paged=paged, page_size=page_size,
            kv_pool_tokens=kv_pool_tokens, prefill_batch=prefill_batch,
            metrics=metrics, device=devs[0], kv_dtype=kv_dtype,
            params=params, flight_dir=flight_dir)
        return engine, LaneGroupInfo(cfg=cfg, devices=devs, data_size=1)
    if not paged:
        raise _gspmd("the dense engine over several devices")
    group = build_lane_group(
        cfg, devs, max_batch=max_batch, max_seq=max_seq, seed=seed,
        page_size=page_size, kv_pool_tokens=kv_pool_tokens, metrics=metrics,
        decode_chunk=decode_chunk, prefill_batch=prefill_batch,
        flight_dir=flight_dir, kv_dtype=kv_dtype, params=params)
    return group, group.info
