"""One call from a model and its devices to a serving engine.

The counterpart of ``swarmdb_tpu/parallel/serving.py``. Two shapes:

- Lanes (data parallelism in one process): paged serving over more than
  one device is a ``ShardLaneGroup``, one paged engine per device
  (``parallel/lanes.py``); one device gets the single engine of
  ``backend.service.build_backend_engine``.
- The single program over a model axis (tensor parallelism): the JAX
  package's sharded dense engine, one GSPMD program over a mesh. In the
  port each rank of a ``torch.distributed`` process group is one process
  with one device (``parallel/distributed.py``); ``build_sharded_model``
  gives every rank its share of the weights (``models.llama.param_plan``:
  each rank draws every tensor whole from the seed and keeps its slice,
  so the pod computes with the weights one process would draw) and the
  forwards that meet the other ranks in collectives
  (``parallel/collectives.py``), and ``build_serving_engine`` wraps them
  in the dense engine. Rank 0 then serves (``Engine.enable_multihost``)
  and the other ranks replay its device calls (``Engine.worker_loop``).
  Whether decode chunks replay as CUDA graphs follows the group's
  backend: NCCL collectives can be captured, gloo ones cannot (then the
  chunks run eagerly); the flight recorder's meta names the mesh, the
  backend and the choice. As in the JAX package, this engine has no
  prefix cache.

Not ported yet, and raising ``NotImplementedError`` naming ROADMAP.md
queue 1 item 11: an ``expert`` or ``pipe`` axis (11c keeps pipeline and
sequence parallelism), a ``data`` axis above 1 on the single program, the
paged engine over a model axis or in a pod and ``admit_overlap=False``
(the sharded paged engine: 11b), a Mixtral over a model axis, and the
dense engine over several devices of one process (the port runs it as
one rank per device).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models import llama
from ..models.configs import ModelConfig, get_config
from ..utils.device import DeviceLike, resolve_device
from ..utils.metrics import MetricsRegistry
from .lanes import LaneGroupInfo, build_lane_group
from .mesh import Mesh, make_mesh, plan_leaf, shard_leaf

__all__ = ["ShardedModel", "build_serving_engine", "build_sharded_model",
           "param_shardings_for"]


def _unported(why: str, item: str = "11") -> NotImplementedError:
    return NotImplementedError(
        f"{why} is multi-GPU serving not ported yet (ROADMAP.md, queue 1 "
        f"item {item})")


@dataclass
class ShardedModel:
    """A model family placed on the mesh, engine-ready: this rank's share
    of the weights, its forwards and its cache builders."""

    cfg: ModelConfig
    mesh: Mesh
    params: Any
    forward_fn: Callable   # (params, tokens, positions, cache, logits_at=)
    init_cache_fn: Callable  # (batch, max_seq) -> this rank's (k, v)
    param_shardings: Any   # the shard plan
    # (chunk_forward, init_chunk, merge) of the dense chunked decode
    chunked_fns: Any = None

    @property
    def model_axis(self):
        return self.mesh.axis("model")


def param_shardings_for(cfg: ModelConfig, mesh: Mesh) -> Any:
    """The shard plan of ``cfg``'s parameters over ``mesh`` (Llama's
    ``param_plan`` over the model axis)."""
    if cfg.is_moe:
        raise _unported(f"{cfg.name!r} (a MoE model) over a model axis",
                        "11b")
    return llama.param_plan(cfg, model_axis="model")


def _check_mesh(cfg: ModelConfig, mesh: Mesh) -> None:
    for axis, item in (("expert", "11"), ("pipe", "11c")):
        if mesh.shape[axis] > 1:
            raise _unported(f"a {axis} axis of {mesh.shape[axis]}", item)
    if mesh.shape["data"] > 1:
        raise _unported(f"a data axis of {mesh.shape['data']} on the "
                        "single program", "11b")
    m = mesh.shape["model"]
    for what, n in (("KV heads", cfg.n_kv_heads), ("vocab", cfg.vocab_size),
                    ("FFN width", cfg.ffn_dim)):
        if n % m:
            raise ValueError(f"{cfg.name}: {what} {n} do not split over a "
                             f"model axis of {m}")


def build_sharded_model(
    model_name_or_cfg: Any,
    mesh: Optional[Mesh] = None,
    *,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    params: Optional[Dict[str, Any]] = None,
    kv_dtype: Optional[torch.dtype] = None,
) -> ShardedModel:
    """This rank's share of a model over ``mesh`` (default: every rank of
    the process group on the model axis, this process's card) and its
    engine-ready functions. Weights are drawn from ``seed`` in ``dtype``,
    each tensor whole then sliced (``llama.init_params(keep=)``), unless
    ``params`` (already this rank's shares: ``shard_params``,
    ``restore_params(shardings=)`` or ``params_from_numpy(shardings=)``)
    are given. The slot cache and the chunk buffer hold the rank's KV
    heads, in ``kv_dtype`` (bf16 by default, as the dense engine's)."""
    cfg = (model_name_or_cfg if isinstance(model_name_or_cfg, ModelConfig)
           else get_config(model_name_or_cfg))
    mesh = mesh or make_mesh()
    _check_mesh(cfg, mesh)
    plan = param_shardings_for(cfg, mesh)
    dev = mesh.device
    if params is None:
        params = llama.init_params(
            cfg, seed=seed, device=dev, dtype=dtype,
            keep=lambda key, t: shard_leaf(t, plan_leaf(plan, key), mesh))
    tp = mesh.axis("model")
    kv_heads = cfg.n_kv_heads // mesh.shape["model"]
    want = cfg.n_heads * cfg.head_dim // mesh.shape["model"]
    if params["layers"]["wq"].shape[-1] != want:
        raise ValueError(f"params hold wq {tuple(params['layers']['wq'].shape)}"
                         f", this rank's share is [..., {want}]")
    cache_dtype = kv_dtype or torch.bfloat16

    def forward_fn(p, tokens, positions, cache, logits_at=None):
        return llama.forward(p, cfg, tokens, positions, cache,
                             logits_at=logits_at, tp=tp)

    def init_cache_fn(batch: int, max_seq: int):
        return llama.init_kv_cache(cfg, batch, max_seq, dtype=cache_dtype,
                                   device=dev, kv_heads=kv_heads)

    chunked_fns = (
        lambda p, t, pos, c, hkv, s: llama.forward_chunked(
            p, cfg, t, pos, c, hkv, s, tp=tp),
        lambda b, k: llama.init_chunk_kv(cfg, b, k, device=dev,
                                         kv_heads=kv_heads),
        llama.merge_chunk,
    )
    return ShardedModel(cfg=cfg, mesh=mesh, params=params,
                        forward_fn=forward_fn, init_cache_fn=init_cache_fn,
                        param_shardings=plan, chunked_fns=chunked_fns)


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
    data: int = 1,
    model: Optional[int] = None,
    expert: int = 1,
    pipe: int = 1,
    metrics: Optional[MetricsRegistry] = None,
    decode_chunk: int = 8,
    prefill_batch: Optional[int] = None,
    flight_dir: Optional[str] = None,
    kv_dtype: Optional[torch.dtype] = None,
    params: Optional[Dict[str, Any]] = None,
    tokenizer_path: Optional[str] = None,
) -> Tuple[Any, Any]:
    """(engine, info). ``devices`` defaults to every visible card (the
    counterpart of a mesh over ``jax.devices()``) and may repeat one;
    ``max_batch`` to 8 slots per device (per data shard); ``paged=None``
    reads ``SWARMDB_PAGED`` and ``admit_overlap=None``
    ``SWARMDB_ADMIT_OVERLAP`` (default on).

    In a process group (``init_distributed``), or with ``model`` above 1,
    it builds the dense single program over a model axis of ``model``
    ranks (default: the group's size), one device per rank (``devices``
    names this rank's one): (Engine, ShardedModel). The coordinator then
    calls ``engine.enable_multihost()`` and the other ranks
    ``engine.worker_loop()``. Otherwise a lone engine or a lane group:
    (engine, LaneGroupInfo). ``expert`` / ``pipe`` above 1,
    ``admit_overlap=False``, ``data`` above 1 on the single program and a
    paged one raise naming item 11. ``tokenizer_path`` gives the single
    program's engine its tokenizer's EOS and pad ids."""
    if devices is None:
        # a rank of a pod holds the device it bound; else every card
        devices = ([None] if dist.is_initialized() else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())] or [None])
    devs = [resolve_device(d) for d in devices]
    if paged is None:
        paged = os.environ.get("SWARMDB_PAGED", "0") == "1"
    if admit_overlap is None:
        admit_overlap = os.environ.get("SWARMDB_ADMIT_OVERLAP", "1") != "0"
    for axis, size, item in (("expert", expert, "11"), ("pipe", pipe, "11c")):
        if size > 1:
            raise _unported(f"a {axis} axis of {size}", item)
    if not admit_overlap:
        raise _unported("the sharded paged engine (admit_overlap=False, "
                        "SWARMDB_ADMIT_OVERLAP=0)", "11b")
    cfg = (model_name_or_cfg if isinstance(model_name_or_cfg, ModelConfig)
           else get_config(model_name_or_cfg))
    if dist.is_initialized() or (model or 1) > 1:
        if paged:
            raise _unported("the paged engine over a model axis or in a "
                            "pod", "11b")
        if data > 1:
            raise _unported(f"a data axis of {data} on the single program",
                            "11b")
        if len(devs) != 1:
            raise ValueError("a rank of the single program holds one "
                             f"device, not {len(devs)}")
        if not dist.is_initialized():
            raise ValueError(f"a model axis of {model} needs {model} ranks: "
                             "call parallel.distributed.init_distributed "
                             "in each first")
        return _single_program(cfg, devs[0], model=model,
                               max_batch=max_batch or 8, max_seq=max_seq,
                               seed=seed, metrics=metrics,
                               decode_chunk=decode_chunk,
                               prefill_batch=prefill_batch,
                               flight_dir=flight_dir, kv_dtype=kv_dtype,
                               params=params, tokenizer_path=tokenizer_path)
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
        raise _unported("the dense engine over several devices of one "
                        "process (the port runs the single program as one "
                        "rank per device: init_distributed)")
    group = build_lane_group(
        cfg, devs, max_batch=max_batch, max_seq=max_seq, seed=seed,
        page_size=page_size, kv_pool_tokens=kv_pool_tokens, metrics=metrics,
        decode_chunk=decode_chunk, prefill_batch=prefill_batch,
        flight_dir=flight_dir, kv_dtype=kv_dtype, params=params)
    return group, group.info


def _single_program(cfg: ModelConfig, device: torch.device, *,
                    model: Optional[int], max_batch: int, max_seq: int,
                    seed: int, metrics, decode_chunk: int,
                    prefill_batch: Optional[int], flight_dir: Optional[str],
                    kv_dtype: Optional[torch.dtype],
                    params: Optional[Dict[str, Any]],
                    tokenizer_path: Optional[str]):
    """The dense engine over this rank's share of the model axis."""
    from ..backend.engine import Engine
    from ..backend.service import _pipeline_depth
    from ..backend.tokenizer import default_tokenizer

    mesh = make_mesh(data=1, model=model or dist.get_world_size(),
                     expert=1, device=device)
    sm = build_sharded_model(cfg, mesh, seed=seed, params=params,
                             kv_dtype=kv_dtype)
    tp = sm.model_axis
    tok = default_tokenizer(cfg.vocab_size, tokenizer_path)
    chunked = os.environ.get("SWARMDB_CHUNKED", "1") != "0"
    engine = Engine(
        sm.params, forward_fn=sm.forward_fn, init_cache_fn=sm.init_cache_fn,
        chunked_fns=sm.chunked_fns if chunked else None,
        max_batch=max_batch, max_seq=max_seq, eos_id=tok.eos_id,
        pad_id=tok.pad_id, seed=seed, metrics=metrics,
        decode_chunk=decode_chunk, prefill_batch=prefill_batch,
        device=mesh.device, flight_dir=flight_dir,
        pipeline_depth=_pipeline_depth(), model_config=cfg,
        decode_graphs=tp.capturable)
    # flight-recorder identity: what the ranks are and how chunks run
    engine.flight.meta.update({
        "mesh": dict(mesh.shape),
        "rank": dist.get_rank(),
        "backend": tp.backend,
        "graphs": bool(engine._runner.use_graphs),
        "max_batch": max_batch,
        "max_seq": max_seq,
    })
    return engine, sm
