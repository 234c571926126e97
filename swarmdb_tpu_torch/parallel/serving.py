"""One call from a model and its devices to a serving engine.

The counterpart of ``swarmdb_tpu/parallel/serving.py``. Two shapes:

- Lanes (data parallelism in one process): paged serving over more than
  one device is a ``ShardLaneGroup``, one paged engine per device
  (``parallel/lanes.py``); one device gets the single engine of
  ``backend.service.build_backend_engine``.
- The single program over a ``data`` x ``model`` x ``expert`` x ``pipe``
  mesh: the JAX package's sharded engines, one GSPMD program over a mesh.
  In the port each rank of a ``torch.distributed`` process group is one
  process with one device (``parallel/distributed.py``); rank 0 serves
  (``Engine.enable_multihost``: it owns the queue, the scheduler, the
  allocator and the tokenizer) and the other ranks replay its device
  calls (``Engine.worker_loop``).

  - The model axis (tensor parallelism) and, for Mixtral, the expert
    axis: ``build_sharded_model`` gives every rank its share of the
    weights (the family's ``param_plan``: each rank draws every tensor
    whole from the seed and keeps its slice, so the pod computes with the
    weights one process would draw) and the forwards that meet the other
    ranks of its groups in collectives (``parallel/collectives.py``):
    Llama's over the model axis, and Mixtral's MoE block over the expert
    axis too (``models/mixtral.py``: each rank runs its own experts' F
    slice; one all-reduce over the expert axis combines them).
  - The data axis: each data group holds the slots ``[d * B/dp, (d + 1) *
    B/dp)`` of the engine's ``max_batch`` (the engine's ``data_axis``),
    decodes them and gathers every group's sampled block after each chunk.
    Llama's rows are independent, so its chunk has no collective over the
    axis; a MoE model's capacity counts every row of the JAX call
    (``mixtral.Rows``): the engine names its rows of each global call and
    the block exchanges expert choices over the axis.
  - The dense engine runs over every axis, as the JAX package's
    ``build_sharded_model`` does (its slot cache splits slots over data and
    KV heads over model); as there, it has no prefix cache. A pipe axis
    holds no weight share in serving (the JAX ``param_specs`` name no
    ``pipe``): its ranks replicate the engine. Pipeline parallelism proper
    is the prefill-only ``models.llama.forward_pipelined``.
  - The paged engine (``build_sharded_paged``) needs a pure-DP mesh: its
    pool's pages and its table's slots split over ``data``
    (``ops.paged_kv.ShardedPageAllocator``: slot s on shard s // (B/dp),
    page ids striped per shard), each rank holding its sub-pool and
    running kernels 2 or 3 on its own slots over its localized table
    rows. Its plain prefill waves run packed per shard, its prefix waves
    on global page ids, each rank taking its shard's rows; ragged prefill,
    the resident loop and rolling are off, as in the JAX package, which
    also refuses int8 pools and a model, expert or pipe axis there (the
    port copies both refusals and their words).

  Whether decode chunks replay as CUDA graphs follows the backends of the
  axes whose collectives run inside the chunk: NCCL collectives can be
  captured, gloo ones cannot (then the chunks run eagerly). The model
  axis always has some; the expert axis and, on the dense engine, the
  data axis have some for a MoE model. The flight recorder's meta names
  the mesh, the backend, the choice, the MoE dispatch form and the
  pool's shards (``paged_shards``).

The single program over several devices of one process (the dense
engine over several devices, a data axis there, ``admit_overlap=False``)
is the same program: ``build_serving_engine`` spawns a rank per device
but the first, this process being rank 0 (``parallel/local.py``), and
the engine it returns owns them: its ``stop`` ends them and its
``restart`` replaces them, as the JAX package's one-process engine
restarts in place.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models import llama, mixtral
from ..models.configs import ModelConfig, get_config
from ..ops.layers import attention_dispatchers
from ..ops.paged_kv import (KV_DTYPES, kv_dtype_name,
                             make_sharded_page_allocator, pages_per_slot)
from ..utils.device import DeviceLike, resolve_device
from ..utils.metrics import MetricsRegistry
from .lanes import LaneGroupInfo, build_lane_group
from .mesh import Mesh, make_mesh, plan_leaf, shard_leaf

__all__ = ["ShardedModel", "build_serving_engine", "build_sharded_model",
           "build_sharded_paged", "param_shardings_for"]


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
    def counts_call(self) -> bool:
        """Whether its forwards' rows meet (Mixtral: a MoE block's capacity
        counts every row of a call), so that a data rank tells them its
        rows of a global call (``rows=``, ``_call_rows``); Llama's rows
        never meet."""
        return self.cfg.is_moe

    @property
    def model_axis(self):
        return self.mesh.axis("model")

    @property
    def data_size(self) -> int:
        return self.mesh.shape["data"]


def _family(cfg: ModelConfig):
    return mixtral if cfg.is_moe else llama


def _call_rows(mesh: Mesh, rows) -> Dict[str, Any]:
    """The engine's ``rows`` (a data rank's rows of a global call: the ids
    tensor, the call's rows) as the MoE block's ``rows=`` keyword
    (``mixtral.Rows`` over the data axis); none without them."""
    if rows is None:
        return {}
    return {"rows": mixtral.Rows(mesh.axis("data"), *rows)}


def param_shardings_for(cfg: ModelConfig, mesh: Mesh) -> Any:
    """The shard plan of ``cfg``'s parameters over ``mesh``: the family's
    ``param_plan`` over the model axis (and, for Mixtral, the expert
    axis)."""
    if cfg.is_moe:
        return mixtral.param_plan(cfg, model_axis="model",
                                  expert_axis="expert")
    return llama.param_plan(cfg, model_axis="model")


def _check_mesh(cfg: ModelConfig, shape: Dict[str, int]) -> None:
    m = shape["model"]
    for what, n in (("KV heads", cfg.n_kv_heads), ("vocab", cfg.vocab_size),
                    ("FFN width", cfg.ffn_dim)):
        if n % m:
            raise ValueError(f"{cfg.name}: {what} {n} do not split over a "
                             f"model axis of {m}")
    e = shape["expert"]
    if cfg.is_moe and cfg.n_experts % e:
        raise ValueError(f"{cfg.name}: experts {cfg.n_experts} do not split "
                         f"over an expert axis of {e}")


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
    engine-ready functions. The data and pipe axes split no weight: a
    rank's caches are built for its own slots by the engine
    (``init_cache_fn(B / dp, max_seq)``). Weights are drawn from ``seed``
    in ``dtype``, each tensor whole then sliced (the family's
    ``init_params(keep=)``), unless ``params`` (already this rank's
    shares: ``shard_params``, ``restore_params(shardings=)`` or
    ``params_from_numpy(shardings=)``) are given. The slot cache and the
    chunk buffer hold the rank's KV heads, in ``kv_dtype`` (bf16 by
    default, as the dense engine's).

    The forwards: ``forward_fn(p, tokens, positions, cache, logits_at=,
    rows=)`` and the chunked triple's forward ``(p, t, pos, c, hkv, s,
    rows=)``. ``rows`` (``counts_call`` only: a data rank's rows of a
    global call, as ``(ids tensor, rows of the call)``) makes the MoE
    block count the whole call; without it a call counts its own rows."""
    cfg = (model_name_or_cfg if isinstance(model_name_or_cfg, ModelConfig)
           else get_config(model_name_or_cfg))
    mesh = mesh or make_mesh()
    _check_mesh(cfg, mesh.shape)
    fam = _family(cfg)
    plan = param_shardings_for(cfg, mesh)
    dev = mesh.device
    if params is None:
        params = fam.init_params(
            cfg, seed=seed, device=dev, dtype=dtype,
            keep=lambda key, t: shard_leaf(t, plan_leaf(plan, key), mesh))
    tp = mesh.axis("model")
    kv_heads = cfg.n_kv_heads // mesh.shape["model"]
    want = cfg.n_heads * cfg.head_dim // mesh.shape["model"]
    if params["layers"]["wq"].shape[-1] != want:
        raise ValueError(f"params hold wq {tuple(params['layers']['wq'].shape)}"
                         f", this rank's share is [..., {want}]")
    cache_dtype = kv_dtype or torch.bfloat16
    # Mixtral's MoE block also meets the expert axis
    axes = {"tp": tp, **({"ep": mesh.axis("expert")} if cfg.is_moe else {})}

    def forward_fn(p, tokens, positions, cache, logits_at=None, rows=None):
        return fam.forward(p, cfg, tokens, positions, cache,
                           logits_at=logits_at, **axes,
                           **_call_rows(mesh, rows))

    def chunk_forward(p, t, pos, c, hkv, s, rows=None):
        return fam.forward_chunked(p, cfg, t, pos, c, hkv, s, **axes,
                                   **_call_rows(mesh, rows))

    def init_cache_fn(batch: int, max_seq: int):
        return llama.init_kv_cache(cfg, batch, max_seq, dtype=cache_dtype,
                                   device=dev, kv_heads=kv_heads)

    chunked_fns = (
        chunk_forward,
        lambda b, k: llama.init_chunk_kv(cfg, b, k, device=dev,
                                         kv_heads=kv_heads),
        llama.merge_chunk,
    )
    return ShardedModel(cfg=cfg, mesh=mesh, params=params,
                        forward_fn=forward_fn, init_cache_fn=init_cache_fn,
                        param_shardings=plan, chunked_fns=chunked_fns)


def _refuse_sharded_paged(mesh_shape: Dict[str, int],
                          kv_dtype: Optional[torch.dtype]) -> None:
    """The JAX package's two refusals of the sharded paged engine, in its
    order and words: an int8 pool, then any axis but ``data``."""
    if (kv_dtype or KV_DTYPES[kv_dtype_name()]) == torch.int8:
        raise NotImplementedError(
            "SWARMDB_KV_DTYPE=int8 is single-chip only: the sharded paged "
            "pool's PartitionSpecs do not cover QuantPool scale planes. "
            "Unset SWARMDB_KV_DTYPE (or use f32/bf16) for sharded serving.")
    if any(mesh_shape.get(ax, 1) > 1 for ax in ("model", "expert", "pipe")):
        raise ValueError(
            "sharded paged serving requires a pure-DP mesh (model/expert/"
            "pipe axes of size 1); TP/EP shard KV heads across devices, "
            "which the slot-affine page pool does not support")


def build_sharded_paged(sm: ShardedModel, *, max_batch: int, max_seq: int,
                        page_size: int = 16,
                        kv_pool_tokens: Optional[int] = None,
                        prefix: bool = True,
                        kv_dtype: Optional[torch.dtype] = None):
    """The paged engine's wiring over ``sm``'s pure-DP mesh: (PagedKV,
    prefix_fns or None, chunked_fns), the JAX package's function of that
    name. The pool covers every slot's window plus, with ``prefix``, the
    prefix cache's budget (``SWARMDB_PREFIX_TOKENS``, default max_batch *
    max_seq / 2) unless ``kv_pool_tokens`` bounds it, split into ``dp``
    shards of ``1 + ceil(tokens / (page_size * dp))`` pages (one of them
    the shard's trash page). ``init_pool`` builds this rank's shard: its
    sub-pool in ``kv_dtype`` (None resolves ``SWARMDB_KV_DTYPE``) and the
    table rows of its B/dp slots. The forwards are the single engine's,
    the family's (kernel 2 chunked, kernel 3 single-step), run by each
    rank on its own slots over its localized table rows: as in the JAX
    package's ``shard_map`` bodies, a rank's rows are the whole call
    there. The prefix forward is the JAX package's GSPMD program over the
    whole wave: it takes ``rows`` as ``ShardedModel.forward_fn`` does."""
    cfg, mesh = sm.cfg, sm.mesh
    fam = _family(cfg)
    _refuse_sharded_paged(mesh.shape, kv_dtype)
    from ..backend.engine import PagedKV

    dp = mesh.shape["data"]
    if max_batch % dp:
        raise ValueError(f"max_batch {max_batch} must divide the data "
                         f"axis {dp} (slot->shard affinity)")
    if max_seq % page_size:
        raise ValueError("max_seq must be a page-size multiple")
    if kv_pool_tokens is None:
        kv_pool_tokens = max_batch * pages_per_slot(max_seq, page_size) \
            * page_size
        if prefix:
            kv_pool_tokens += int(os.environ.get("SWARMDB_PREFIX_TOKENS",
                                                 max_batch * max_seq // 2))
    per_shard = 1 + -(-kv_pool_tokens // (page_size * dp))
    allocator = make_sharded_page_allocator(per_shard, dp, page_size,
                                            max_seq, max_batch)
    dev, rows = mesh.device, max_batch // dp
    pool_dtype = kv_dtype or KV_DTYPES[kv_dtype_name()]
    _ragged_attn, decode_attn = attention_dispatchers()
    spec = PagedKV(
        init_pool=lambda: llama.init_paged_cache(
            cfg, rows, max_seq, per_shard, page_size, dtype=pool_dtype,
            device=dev),
        page_size=page_size,
        num_pages=per_shard * dp,
        allocator=allocator,
        decode_forward=lambda p, t, pos, c: fam.forward_paged(
            p, cfg, t, pos, c, attention=decode_attn))
    chunked_fns = (
        lambda p, t, pos, c, hkv, s: fam.forward_paged_chunked(
            p, cfg, t, pos, c, hkv, s),
        lambda b, k: llama.init_chunk_kv(cfg, b, k, device=dev),
        llama.merge_paged_chunk)
    prefix_fns = None
    if prefix:
        prefix_fns = (lambda p, t, tab, pl, pk, pv, logits_at=None, rows=None:
                      fam.forward_prefix_pages(p, cfg, t, tab, pl, pk, pv,
                                               logits_at=logits_at,
                                               **_call_rows(mesh, rows)),
                      None)
    return spec, prefix_fns, chunked_fns


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
    ``max_batch`` to 8 slots per data shard; ``paged=None`` reads
    ``SWARMDB_PAGED`` and ``admit_overlap=None`` ``SWARMDB_ADMIT_OVERLAP``
    (default on).

    The single program, (Engine, ShardedModel), over a mesh of ``data`` x
    ``model`` x ``expert`` x ``pipe`` ranks, one device each (``model``
    defaults to what the other axes leave: every rank of a dense program
    with no axis given is on ``model``, as the JAX package's
    ``plan_mesh_shape`` puts them). Paged, it is the sharded paged engine
    (``build_sharded_paged``: a pure-DP mesh, the prefix cache on unless
    ``SWARMDB_PREFIX=0``); else the dense engine, without a prefix cache.
    Decode is chunked unless ``SWARMDB_CHUNKED=0``. Its ranks are either

    - a process group the caller made (``init_distributed`` in each
      process): ``devices`` names this rank's one device and ``params``
      are its shares; the coordinator then calls
      ``engine.enable_multihost()`` and the other ranks
      ``engine.worker_loop()``. Such a pod cannot restart in place; or
    - several ``devices`` of a process that is no rank of a group: the
      call spawns a rank for each device but the first and returns rank
      0's engine, serving (``parallel/local.py``: NCCL when every device
      is a card of its own, else gloo); ``params`` are the whole weights.
      Its ``stop`` ends the workers and the process group, its
      ``restart`` replaces them. This is the dense engine (every axis),
      and the paged one with ``admit_overlap=False`` (over ``data`` =
      every device).

    Otherwise, outside a group, a lone engine (one device) or, paged over
    several devices, a lane group: (engine, LaneGroupInfo). A paged
    engine over a model, expert or pipe axis raises the JAX package's
    pure-DP ``ValueError`` (and an int8 pool on the single program its
    ``NotImplementedError``); an axis larger than the devices of a
    process without a group says how to get its ranks.
    ``tokenizer_path`` gives the single program's engine its tokenizer's
    EOS and pad ids."""
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
    cfg = (model_name_or_cfg if isinstance(model_name_or_cfg, ModelConfig)
           else get_config(model_name_or_cfg))
    split = {"model": model or 1, "expert": expert, "pipe": pipe}
    if paged and any(n > 1 for n in split.values()):
        _refuse_sharded_paged(split, kv_dtype)
    program = dict(paged=paged, max_seq=max_seq, seed=seed,
                   page_size=page_size, kv_pool_tokens=kv_pool_tokens,
                   metrics=metrics, decode_chunk=decode_chunk,
                   prefill_batch=prefill_batch, flight_dir=flight_dir,
                   kv_dtype=kv_dtype, tokenizer_path=tokenizer_path)
    if dist.is_initialized():
        if len(devs) != 1:
            raise ValueError("a rank of the single program holds one "
                             f"device, not {len(devs)}")
        return _single_program(cfg, devs[0], data=data, model=model,
                               expert=expert, pipe=pipe,
                               max_batch=max_batch or 8 * data,
                               params=params, **program)
    n = len(devs)
    if n == 1:
        axis, size = next(((a, k) for a, k in
                           {"data": data, **split}.items() if k > 1),
                          (None, 1))
        if axis is not None:
            raise ValueError(
                f"a {axis} axis of {size} needs {size} ranks: call "
                "parallel.distributed.init_distributed in each first, or "
                f"give build_serving_engine {size} devices")
        from ..backend.service import build_backend_engine

        engine, _tok = build_backend_engine(
            cfg, max_batch=max_batch or 8, max_seq=max_seq, seed=seed,
            decode_chunk=decode_chunk, paged=paged, page_size=page_size,
            kv_pool_tokens=kv_pool_tokens, prefill_batch=prefill_batch,
            metrics=metrics, device=devs[0], kv_dtype=kv_dtype,
            params=params, flight_dir=flight_dir)
        return engine, LaneGroupInfo(cfg=cfg, devices=devs, data_size=1)
    rest = data * expert * pipe
    if paged and rest == 1 and model is None:
        data = rest = n     # a paged program is pure DP over its devices
    if n % rest or (model and rest * model != n):
        raise ValueError(f"axes data {data} x model {model or '?'} x "
                         f"expert {expert} x pipe {pipe} do not make "
                         f"{n} devices")
    model = n // rest
    if paged and (model > 1 or not admit_overlap):
        _refuse_sharded_paged({"model": model, "expert": expert,
                               "pipe": pipe}, kv_dtype)
    if paged and admit_overlap:
        group = build_lane_group(
            cfg, devs, max_batch=max_batch or 8 * n, max_seq=max_seq,
            seed=seed, page_size=page_size, kv_pool_tokens=kv_pool_tokens,
            metrics=metrics, decode_chunk=decode_chunk,
            prefill_batch=prefill_batch, flight_dir=flight_dir,
            kv_dtype=kv_dtype, params=params)
        return group, group.info
    from .local import build_local_program

    _check_mesh(cfg, {"model": model, "expert": expert})
    return build_local_program(cfg, devs, dict(
        program, data=data, model=model, expert=expert, pipe=pipe,
        max_batch=max_batch or 8 * data), params=params)


def _single_program(cfg: ModelConfig, device: torch.device, *, data: int,
                    model: Optional[int], expert: int, pipe: int,
                    paged: bool, max_batch: int,
                    max_seq: int, seed: int, page_size: int,
                    kv_pool_tokens: Optional[int], metrics,
                    decode_chunk: int, prefill_batch: Optional[int],
                    flight_dir: Optional[str],
                    kv_dtype: Optional[torch.dtype],
                    tokenizer_path: Optional[str],
                    params: Optional[Dict[str, Any]] = None,
                    load: Optional[Callable] = None):
    """This rank's engine: the dense one over its share of the mesh, or
    the paged one over its shard of a pure-DP pool. Its weights are
    ``params`` (its shares), or ``load(plan, mesh)``'s, or drawn from
    ``seed``."""
    from ..backend.engine import Engine
    from ..backend.service import _pipeline_depth
    from ..backend.tokenizer import default_tokenizer

    world = dist.get_world_size()
    rest = data * expert * pipe
    if world % rest:
        raise ValueError(f"data x expert x pipe axes of {rest} do not "
                         f"divide {world} ranks")
    mesh = make_mesh(data=data, model=model or world // rest, expert=expert,
                     pipe=pipe, device=device)
    if paged:
        _refuse_sharded_paged(mesh.shape, kv_dtype)
    if load is not None:
        params = load(param_shardings_for(cfg, mesh), mesh)
    sm = build_sharded_model(cfg, mesh, seed=seed, params=params,
                             kv_dtype=kv_dtype)
    # the axes whose collectives run inside a decode chunk: the model
    # axis's; a MoE block's over the expert axis, and on the dense engine
    # over the data axis (its rows count the whole decode step)
    chunk_axes = [sm.model_axis]
    if cfg.is_moe:
        chunk_axes.append(mesh.axis("expert"))
    if sm.counts_call and not paged:
        chunk_axes.append(mesh.axis("data"))
    tok = default_tokenizer(cfg.vocab_size, tokenizer_path)
    chunked = os.environ.get("SWARMDB_CHUNKED", "1") != "0"
    kw: Dict[str, Any] = {"chunked_fns": sm.chunked_fns if chunked else None}
    if paged:
        prefix = (os.environ.get("SWARMDB_PREFIX", "1") != "0"
                  and max_seq % page_size == 0)
        spec, prefix_fns, paged_chunked = build_sharded_paged(
            sm, max_batch=max_batch, max_seq=max_seq, page_size=page_size,
            kv_pool_tokens=kv_pool_tokens, prefix=prefix, kv_dtype=kv_dtype)
        kw = dict(paged=spec, prefix_fns=prefix_fns,
                  prefix_cache=prefix_fns is not None,
                  chunked_fns=paged_chunked if chunked else None)
    engine = Engine(
        sm.params, forward_fn=sm.forward_fn, init_cache_fn=sm.init_cache_fn,
        max_batch=max_batch, max_seq=max_seq, eos_id=tok.eos_id,
        pad_id=tok.pad_id, seed=seed, metrics=metrics,
        decode_chunk=decode_chunk, prefill_batch=prefill_batch,
        device=mesh.device, flight_dir=flight_dir,
        pipeline_depth=_pipeline_depth(), model_config=cfg,
        decode_graphs=all(a.capturable for a in chunk_axes),
        data_axis=mesh.axis("data"), count_rows=sm.counts_call, **kw)
    # flight-recorder identity: what the ranks are and how chunks run
    engine.flight.meta.update({
        "mesh": dict(mesh.shape),
        "rank": dist.get_rank(),
        "backend": dist.get_backend(),
        "graphs": bool(engine._runner.use_graphs),
        "paged_shards": (engine.paged.allocator.n_shards if paged else 1),
        # the MoE block's form (its expert axis combines by all-reduce)
        "moe_dispatch": (mixtral._default_dispatch() if cfg.is_moe
                         else None),
        "max_batch": max_batch,
        "max_seq": max_seq,
    })
    return engine, sm
