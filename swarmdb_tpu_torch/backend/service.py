"""ServingService: chat messages routed to an LLM backend become engine
requests, and replies come back as messages.

The counterpart of ``swarmdb_tpu/backend/service.py``, over one engine,
dense (the default, as in the JAX package) or paged (``paged=True`` or
``SWARMDB_PAGED=1``), or over a lane group of paged engines
(``parallel.serving.build_serving_engine``, ``parallel/lanes.py``), whose
requests carry the conversation's lane (``shard_hint``, a stable hash of
the sender / receiver pair):

- A consumer thread drains the inboxes of the agents assigned to this
  backend (``SwarmDB.assign_llm_backend``) and turns chat / function_call
  messages into engine requests (prompt = the two-way conversation window
  plus the new message, trimmed to the engine's window).
- Every request goes through a ``LaneSupervisor`` (``SWARMDB_SUPERVISE``,
  default "1"; ``backend/supervisor.py``; a group's own through
  ``attach_supervisor``): a deadline, a retry budget for retryable
  finishes ("shed", "engine_error", "engine_restart"), replay of a request
  cut off mid-stream (on a sibling lane in a group), restart of a dead
  lane. With ``SWARMDB_SUPERVISE=0`` the consumer's watchdog restarts a
  dead loop (a group's dead lanes).
- ``metadata["generation"]["n"]`` (clamped to 1-4) fans a message out
  into n completions with seeds ``seed + i``, each with its own
  stop-sequence watch; the reply's body is completion 0 and
  ``metadata["alternatives"]`` carries the others. A cancel reaches every
  member.
- Replies are emitted through ``SwarmDB.send_message`` as first-class
  messages on a reply worker, off the engine thread. ``stream_reply`` and
  ``stream_group`` bridge the engine's per-token callbacks to an asyncio
  queue for the API's SSE streams.
- A message is generated once: a second ``serve_message`` of it (the
  consumer picking up a message an API stream already serves, or the
  other way round) attaches to the running generation, gets the tokens so
  far and then the live ones, and emits no second reply. (The JAX package
  decodes such a message twice and replies twice.)

The model is Llama or Mixtral (top-k routed MoE, ``models.mixtral``).
The engine decodes in chunks (``SWARMDB_CHUNKED=1``, default) or one step
at a time (``SWARMDB_CHUNKED=0``): the dense engine over a bf16 slot cache
with a side prefix pool, the paged one over a bf16 / f32 or int8 pool
(``SWARMDB_KV_DTYPE``), prefilling Llama in ragged waves and Mixtral in
row-bucketed and prefix waves. The paged engine decodes in device-resident
sessions (``SWARMDB_EMIT_RING``, default "1"), the dense one (and the
paged one under ``SWARMDB_EMIT_RING=0``) with ``SWARMDB_PIPELINE`` chunks
in flight (default 2); on the card every chunk is a CUDA graph replay,
captured at first use or, with ``SWARMDB_PREWARM=1``, at ``start``.

``SWARMDB_ROLLING_KV=1`` keeps a conversation's K/V between turns (both
engines): the rolling registry maps (sender, receiver) to the pages
holding its history, a turn's prompt is then only the delta since the
last turn (rendered by the same line renderers) on top of those pages, and
a conversation that outgrows the window restarts fresh. On the paged
engine a ``TierManager`` (``SWARMDB_TIER``, default "1";
``backend/tiering.py``) spills idle conversations to pinned host memory
under pool pressure and promotes them back on their next turn; a spilled
conversation evicted from host memory re-prefills from the broker log.
An engine that cannot roll logs it and serves without; a lane group
refuses rolling with the JAX package's warning. The runtime's SLO
sentinel is bound to the engine (its flight rings, the tracer and the
flight directory for an alert's dumps), and the engine's loop drives its
windows. Over a pod's coordinator engine (``Engine.enable_multihost``)
every turn is served plain and no tier manager is built, as in the JAX
package: such an engine cannot roll (``Engine.supports_rolling``).
``bind_partition_leadership(ha_node)`` makes a lane group's
conversation pins follow their log partition's leader
(``backend/locality.py``) and re-pin when leadership moves.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
import queue
import random
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

import torch

from ..core.messages import Message, MessageType
from ..core.runtime import SwarmDB
from ..ha.detector import promotion_budget_s
from ..models import llama, mixtral
from ..obs import TRACER
from ..obs.memprof import memprof
from ..models.configs import ModelConfig, get_config
from ..ops.layers import attention_dispatchers
from ..ops.paged_kv import (KV_DTYPES, kv_dtype_name, make_page_allocator,
                            pages_per_slot)
from ..utils.device import DeviceLike, resolve_device
from ..utils.hashing import stable_partition
from ..utils.sync import make_lock
from .engine import Engine, GenRequest, PagedKV, _env_float, _env_int
from .sampling import SamplingParams
from .supervisor import LaneSupervisor
from .tokenizer import Tokenizer, default_tokenizer

logger = logging.getLogger("swarmdb_tpu_torch.serving")

#: Message generations remembered (newest first out of scope): a caller
#: that asks to serve one of them attaches instead of generating again.
_CLAIMS_MAX = 4096


def _body(m: Message) -> str:
    return m.content if isinstance(m.content, str) else json.dumps(m.content)


def _history_line(m: Message) -> str:
    """An exchanged message as a prompt line: the window of
    ``build_prompt`` and a rolling turn's delta render alike."""
    return f"{m.sender_id}: {_body(m)}"


def _current_lines(msg: Message) -> List[str]:
    """The served message's own prompt lines plus the assistant cue."""
    if msg.type == MessageType.FUNCTION_CALL:
        return [f"{msg.sender_id} [tool-call]: {_body(msg)}",
                f"{msg.receiver_id} [tool-result]:"]
    return [f"{msg.sender_id}: {_body(msg)}", f"{msg.receiver_id}:"]


def build_prompt(db: SwarmDB, msg: Message, tokenizer: Tokenizer,
                 history_limit: Optional[int] = None) -> List[int]:
    """Chat-style prompt from the two-way conversation plus the new
    message. The window is anchored in stream coordinates
    (``get_conversation_window``), so consecutive turns share a prefix the
    prefix cache can hit."""
    if history_limit is None:
        history_limit = _env_int("SWARMDB_HISTORY_LIMIT", 64)
    lines: List[str] = []
    if msg.receiver_id:
        for m in db.get_conversation_window(msg.sender_id, msg.receiver_id,
                                            history_limit):
            if m.id != msg.id:
                lines.append(_history_line(m))
    lines.extend(_current_lines(msg))
    return tokenizer.encode("\n".join(lines))


def _history_limit_for(max_seq: int) -> int:
    """History depth rendered per prompt: the env limit, capped near
    max_seq / 8 lines (a line is >= 8 tokens, so the cap still fills the
    token budget)."""
    env = _env_int("SWARMDB_HISTORY_LIMIT", 64)
    return max(1, min(env, max(8, max_seq // 8)))


def sampling_from_message(msg: Message) -> SamplingParams:
    """Sampling knobs from ``metadata["generation"]``, clamped."""
    g = (msg.metadata.get("generation", {})
         if isinstance(msg.metadata, dict) else {})
    raw_stop = g.get("stop", ())
    if isinstance(raw_stop, str):
        raw_stop = (raw_stop,)
    stop = tuple(str(s)[:64] for s in list(raw_stop)[:4] if s)
    seed = g.get("seed")
    return SamplingParams(
        temperature=max(0.0, float(g.get("temperature", 0.0))),
        top_k=max(0, int(g.get("top_k", 0))),
        top_p=min(1.0, max(1e-3, float(g.get("top_p", 1.0)))),
        max_new_tokens=min(4096, max(1, int(g.get("max_new_tokens", 64)))),
        stop=stop,
        seed=int(seed) if seed is not None else None,
    )


def build_backend_engine(
    model_name_or_cfg,
    *,
    max_batch: int = 8,
    max_seq: Optional[int] = None,
    seed: int = 0,
    decode_chunk: int = 8,
    paged: Optional[bool] = None,
    page_size: int = 16,
    kv_pool_tokens: Optional[int] = None,
    prefill_batch: Optional[int] = None,
    metrics=None,
    tokenizer_path: Optional[str] = None,
    device: DeviceLike = None,
    kv_dtype: Optional[torch.dtype] = None,
    params: Optional[Dict[str, Any]] = None,
    flight_dir: Optional[str] = None,
    eos_id: Optional[int] = None,
    pad_id: Optional[int] = None,
    pipeline_depth: Optional[int] = None,
    aging_s: Optional[float] = None,
) -> Tuple[Engine, Tokenizer]:
    """One Engine for a registry config (Llama or Mixtral), on ``device``
    (the card by default). Weights are random bf16 from ``seed`` unless
    ``params`` (the port's dict layout, on ``device``) are given. Decode
    is chunked unless ``SWARMDB_CHUNKED=0``.

    ``paged=None`` resolves ``SWARMDB_PAGED`` as the JAX package does:
    "1" builds the paged engine, anything else (unset included) the dense
    one.

    - Dense: a [L, max_batch, max_seq, Hkv, D] slot cache, bf16 as in the
      JAX package (``SWARMDB_KV_DTYPE`` does not apply; ``kv_dtype``
      may set float32, for tests), bucketed prefill, and a side page pool
      for the prefix cache of ``1 + ceil(SWARMDB_PREFIX_TOKENS /
      page_size)`` pages (default max_batch * max_seq / 2 tokens) in the
      cache's dtype. The port has one chunk merge, so ``SWARMDB_MERGE``
      (the JAX package's einsum or scatter form) is not read.
    - Paged: the pool is ``kv_dtype`` (None resolves SWARMDB_KV_DTYPE,
      bf16 by default; ``torch.int8`` gives a quantized pool) and covers
      every slot's full window plus the prefix-cache budget
      (``SWARMDB_PREFIX_TOKENS``) unless ``kv_pool_tokens`` bounds it.
      Llama prefills in ragged waves; Mixtral, which has no ragged
      forward (as in the JAX package), and any model under
      ``SWARMDB_RAGGED_PREFILL=0`` in row-bucketed waves over a temp
      cache in the pool's logical dtype (bf16 for int8 pages; the JAX
      package's temp cache is bf16 whatever the pool) and prefix waves
      over the pool's pages.

    ``eos_id`` and ``pad_id`` default to the tokenizer's, ``pipeline_depth``
    to ``SWARMDB_PIPELINE`` (2 when unset), and ``aging_s=None`` leaves
    the engine to read ``SWARMDB_AGING_S`` (``engine_knobs``)."""
    cfg = (model_name_or_cfg if isinstance(model_name_or_cfg, ModelConfig)
           else get_config(model_name_or_cfg))
    mod = mixtral if cfg.is_moe else llama
    if paged is None:
        paged = os.environ.get("SWARMDB_PAGED", "0") == "1"
    dev = resolve_device(device)
    seq = max_seq or min(cfg.max_seq_len, 1024)
    prefix_enabled = (
        hasattr(mod, "forward_prefix_pages" if paged
                else "forward_prefix_lane")
        and os.environ.get("SWARMDB_PREFIX", "1") != "0"
        and seq % page_size == 0)
    if params is None:
        params = mod.init_params(cfg, seed=seed, device=dev)
    tokenizer = default_tokenizer(cfg.vocab_size, tokenizer_path)
    knobs = engine_knobs(tokenizer, eos_id=eos_id, pad_id=pad_id,
                         pipeline_depth=pipeline_depth, aging_s=aging_s)
    forward_fn = lambda p, t, pos, c, logits_at=None: mod.forward(
        p, cfg, t, pos, c, logits_at=logits_at)
    if not paged:
        engine = _dense_engine(cfg, mod, params, dev, kv_dtype,
                               prefix_enabled, forward_fn,
                               max_batch=max_batch, max_seq=seq, seed=seed,
                               metrics=metrics, decode_chunk=decode_chunk,
                               prefill_batch=prefill_batch,
                               page_size=page_size, flight_dir=flight_dir,
                               **knobs)
        return engine, tokenizer
    maxp = pages_per_slot(seq, page_size)
    if kv_pool_tokens is None and "SWARMDB_KV_POOL_TOKENS" in os.environ:
        kv_pool_tokens = int(os.environ["SWARMDB_KV_POOL_TOKENS"])
    pool_tokens = kv_pool_tokens or max_batch * maxp * page_size
    if kv_pool_tokens is None and prefix_enabled:
        pool_tokens += _env_int("SWARMDB_PREFIX_TOKENS", max_batch * seq // 2)
    num_pages = 1 + -(-pool_tokens // page_size)  # +1 trash page
    pool_kind = kv_dtype or KV_DTYPES[kv_dtype_name()]
    temp_dtype = torch.bfloat16 if pool_kind == torch.int8 else pool_kind
    # the attention dispatchers (the kernel sanitizer's checked ones under
    # SWARMDB_KERNCHECK=1, read here)
    ragged_attn, decode_attn = attention_dispatchers()
    prefill_ragged = None
    if hasattr(mod, "forward_ragged_prefill"):
        prefill_ragged = (
            lambda p, toks, trow, tpos, tables, st, ln, pl, pk, pv:
                mod.forward_ragged_prefill(p, cfg, toks, trow, tpos, tables,
                                           st, ln, pl, pk, pv,
                                           attention=ragged_attn))
    paged_spec = PagedKV(
        init_pool=lambda: mod.init_paged_cache(
            cfg, max_batch, seq, num_pages, page_size, dtype=pool_kind,
            device=dev),
        page_size=page_size,
        num_pages=num_pages,
        allocator=make_page_allocator(num_pages, page_size, seq,
                                      max_batch),
        prefill_ragged=prefill_ragged,
        decode_forward=lambda p, t, pos, c: mod.forward_paged(
            p, cfg, t, pos, c, attention=decode_attn),
    )
    # two-segment chunked decode (the pool frozen per chunk, one merge);
    # SWARMDB_CHUNKED=0 decodes one step at a time through decode_forward
    # (admission is unchanged either way)
    chunked_fns = None
    if os.environ.get("SWARMDB_CHUNKED", "1") != "0":
        chunked_fns = (
            lambda p, t, pos, c, hkv, s: mod.forward_paged_chunked(
                p, cfg, t, pos, c, hkv, s),
            lambda b, k: mod.init_chunk_kv(cfg, b, k, device=dev),
            mod.merge_paged_chunk,
        )
    # the prefix waves' suffix forward over the pool's pages (the ragged
    # waves read hit pages themselves)
    prefix_fns = None
    if prefix_enabled:
        prefix_fns = (
            lambda p, t, tab, pl, pk, pv, logits_at=None:
                mod.forward_prefix_pages(p, cfg, t, tab, pl, pk, pv,
                                         logits_at=logits_at),
            None)
    engine = Engine(
        params, paged=paged_spec, chunked_fns=chunked_fns,
        forward_fn=forward_fn,
        init_cache_fn=lambda b, s: mod.init_kv_cache(
            cfg, b, s, dtype=temp_dtype, device=dev),
        prefix_fns=prefix_fns,
        max_batch=max_batch, max_seq=seq, seed=seed, metrics=metrics,
        decode_chunk=decode_chunk, prefill_batch=prefill_batch,
        prefix_cache=prefix_enabled, device=dev, flight_dir=flight_dir,
        model_config=cfg, **knobs)
    return engine, tokenizer


def engine_knobs(tokenizer: Tokenizer, *, eos_id: Optional[int] = None,
                 pad_id: Optional[int] = None,
                 pipeline_depth: Optional[int] = None,
                 aging_s: Optional[float] = None) -> Dict[str, Any]:
    """The engine keywords ``build_backend_engine`` and the single
    program's ranks take as plain values (the JAX
    ``build_serving_engine``'s ``engine_kwargs``): each one given wins;
    else ``eos_id`` / ``pad_id`` are the tokenizer's, ``pipeline_depth``
    is ``SWARMDB_PIPELINE`` (default 2, read as the JAX package's
    ``build_backend_engine`` reads it), and ``aging_s`` stays None for
    the engine to read ``SWARMDB_AGING_S``."""
    return dict(
        eos_id=tokenizer.eos_id if eos_id is None else eos_id,
        pad_id=tokenizer.pad_id if pad_id is None else pad_id,
        pipeline_depth=(int(os.environ.get("SWARMDB_PIPELINE", "2"))
                        if pipeline_depth is None else pipeline_depth),
        aging_s=aging_s)


def _dense_engine(cfg: ModelConfig, mod, params: Dict[str, Any],
                  dev: torch.device,
                  kv_dtype: Optional[torch.dtype], prefix_enabled: bool,
                  forward_fn, *, max_batch: int, max_seq: int, seed: int,
                  metrics, decode_chunk: int, prefill_batch: Optional[int],
                  page_size: int, flight_dir: Optional[str],
                  **knobs: Any) -> Engine:
    """The dense engine's wiring (``swarmdb_tpu/backend/service.py``'s
    dense branch of ``build_backend_engine``) over model module ``mod``."""
    dtype = kv_dtype or torch.bfloat16
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the dense slot cache is bfloat16 or float32, "
                         f"not {dtype} (int8 KV is paged-only)")
    chunked_fns = None
    if os.environ.get("SWARMDB_CHUNKED", "1") != "0":
        chunked_fns = (
            lambda p, t, pos, c, hkv, s: mod.forward_chunked(
                p, cfg, t, pos, c, hkv, s),
            lambda b, k: mod.init_chunk_kv(cfg, b, k, device=dev),
            mod.merge_chunk,
        )
    prefix_fns, prefix_pages = None, 0
    if prefix_enabled:
        prefix_tokens = _env_int("SWARMDB_PREFIX_TOKENS",
                                 max_batch * max_seq // 2)
        prefix_pages = 1 + -(-prefix_tokens // page_size)  # +1 trash page
        prefix_fns = (
            lambda p, t, tab, pl, pk, pv, lp, logits_at=None:
                mod.forward_prefix_lane(p, cfg, t, tab, pl, pk, pv, lp,
                                        logits_at=logits_at),
            lambda n, ps: mod.init_prefix_pool(cfg, n, ps, dtype=dtype,
                                               device=dev),
        )
    return Engine(
        params,
        forward_fn=forward_fn,
        init_cache_fn=lambda b, s: mod.init_kv_cache(cfg, b, s, dtype=dtype,
                                                     device=dev),
        chunked_fns=chunked_fns, prefix_fns=prefix_fns,
        prefix_pages=prefix_pages, prefix_page_size=page_size,
        max_batch=max_batch, max_seq=max_seq, seed=seed, metrics=metrics,
        decode_chunk=decode_chunk, prefill_batch=prefill_batch, device=dev,
        flight_dir=flight_dir, model_config=cfg, **knobs)


class _Claim:
    """One message's generation, shared by every ``serve_message`` of it:
    its request id (fixed before the generation is submitted, so a caller
    that attaches meanwhile gets it too), the tokens so far (None once
    finished), the attached listeners, and the final (tokens, reason)."""

    __slots__ = ("rid", "tokens", "listeners", "final")

    def __init__(self) -> None:
        self.rid = str(uuid.uuid4())
        self.tokens: Optional[List[int]] = []
        self.listeners: List[Tuple[Any, Any]] = []
        self.final: Optional[Tuple[List[int], str]] = None


class ServingService:
    """Owns one Engine + its broker consumer; routes messages to
    generation."""

    def __init__(self, db: SwarmDB, engine: Engine, tokenizer: Tokenizer,
                 backend_id: str = "gpu-0",
                 poll_interval: float = 0.05) -> None:
        self.db = db
        self.engine = engine
        self.tokenizer = tokenizer
        self.backend_id = backend_id
        self.poll_interval = poll_interval
        # the runtime's SLO sentinel watches this engine: an alert dumps
        # its flight rings and the process trace, and the engine loop
        # closes windows while no sends flow (a lane group passes it to
        # every lane)
        db.sentinel.bind(flight=engine.flight, tracer=engine.tracer,
                         flight_dir=engine._flight_dir)
        engine.sentinel = db.sentinel
        # request supervision: deadline + retry budget stamped on every
        # request, retryable finishes requeued, a dead loop restarted (a
        # group's lanes quarantined, migrated and re-admitted).
        # SWARMDB_SUPERVISE=0 leaves the consumer's watchdog restart
        self.supervisor: Optional[LaneSupervisor] = None
        if os.environ.get("SWARMDB_SUPERVISE", "1") != "0":
            if getattr(engine, "lanes", None) is not None:
                self.supervisor = engine.attach_supervisor(
                    metrics=db.metrics)
            else:
                self.supervisor = LaneSupervisor(
                    engine, metrics=db.metrics).start()
        self._stop = threading.Event()
        self._consumer_thread: Optional[threading.Thread] = None
        # reply emission (decode + send_message) runs on its own worker,
        # never on the engine thread
        self._reply_queue: "queue.Queue" = queue.Queue()
        self._reply_thread: Optional[threading.Thread] = None
        # n > 1 fan-out: completion 0's rid -> every member's rid, so a
        # cancel reaches all of them (popped when the aggregate is emitted)
        self._fanout: Dict[str, List[str]] = {}
        # message id -> its generation, the newest _CLAIMS_MAX kept so a
        # late caller still finds a finished one
        self._claims: "OrderedDict[str, _Claim]" = OrderedDict()
        self._claims_lock = make_lock(
            "backend.service.ServingService._claims_lock")
        # sink-anchored window heads (see _trim_prompt): conversation pair
        # -> its page-aligned first tokens, captured at the first overflow
        self._anchors: Dict[Tuple[str, str], List[int]] = {}
        self._anchor_lock = make_lock(
            "backend.service.ServingService._anchor_lock")
        self._anchor_cap = _env_int("SWARMDB_ANCHOR_MAX", 4096)
        self._anchor_sep = self.tokenizer.encode("\n[…]\n", add_bos=False)
        # this service's conversation-temperature ledger (touched per
        # served message; the tier manager orders its victims by it)
        self._mem = memprof().conv_ledger()
        # rolling KV (SWARMDB_ROLLING_KV=1): (sender, receiver) -> {pages,
        # len, tail, msg_count, reply_ids, pending_count, epoch,
        # in_flight, last, ...}. Between turns the listed pages are in
        # this registry's custody; the engine only references them while
        # a resumed request runs. A live conversation keeps its replies'
        # raw tokens in K/V where a re-prefill renders "bot: <text>"
        # lines, so its replies drift from a non-rolling serve's by
        # design (the JAX package's StreamingLLM-style trade)
        self._rolling: Optional[Dict[Tuple[str, str], Dict[str, Any]]] = None
        self._rolling_lock = make_lock(
            "backend.service.ServingService._rolling_lock")
        # EMA of the per-turn suffix length (tokens), sizing the restart
        # reserve, seeded relative to the window
        self._rolling_delta_ema = min(64.0, engine.max_seq / 8.0)
        self._tier = None
        # partition-leadership locality (bind_partition_leadership); None
        # keeps the pair-hash lane hint
        self._locality = None
        # how long a retryable reply produce is retried: the promotion
        # budget of the detector's env times, the bound HA node's own
        # once bind_partition_leadership saw it
        self._failover_budget_s = promotion_budget_s()
        rolling_wanted = os.environ.get("SWARMDB_ROLLING_KV") == "1"
        if rolling_wanted and self._n_shards() > 1:
            # a kept conversation's pages pin it to one lane's pool, which
            # a group's routing does not honour for page custody
            logger.warning("SWARMDB_ROLLING_KV=1 ignored: rolling resume "
                           "is not supported on a DP-sharded page pool")
            rolling_wanted = False
        if rolling_wanted:
            if engine.supports_rolling():
                self._rolling = {}
                # idle conversations' kept pages must never starve
                # other traffic: admission evicts (or demotes) them
                engine.on_pool_pressure = self._on_pool_pressure
                if engine.paged is not None:
                    from .tiering import TierManager, tiering_enabled

                    if tiering_enabled():
                        self._tier = TierManager(self, engine)
            else:
                logger.warning("SWARMDB_ROLLING_KV=1 ignored: this engine "
                               "cannot roll (a paged engine needs its "
                               "prefix cache's pages forward, a dense one "
                               "its prefix side pool; SWARMDB_PREFIX=0 "
                               "turns both off)")

    def _n_shards(self) -> int:
        """Lanes behind the engine (1 for a lone engine)."""
        paged = self.engine.paged
        return getattr(paged.allocator, "n_shards", 1) if paged else 1

    def bind_partition_leadership(self, ha_node) -> None:
        """Ride partition leadership: every conversation's ``shard_hint``
        comes from its log partition's current leader
        (``ConversationLocality``), and the service subscribes to the
        node's rebalance stream, so a leadership move (drain handover,
        failover promotion) re-pins the conversation's lane: its anchor
        head and prefix pages re-register on the new lane at the next
        turn, and ``ha.repin`` instants attribute the TTFT spike. A no-op
        unless the node runs partition leadership (but for the reply
        retries' failover budget, taken from the node's detector times);
        without a bind the pair-hash hint is used."""
        if ha_node is None:
            return
        self._failover_budget_s = promotion_budget_s(
            getattr(ha_node, "suspect_s", None),
            getattr(ha_node, "dead_s", None))
        if not getattr(ha_node, "partition_leadership", False):
            return
        from .locality import ConversationLocality

        self._locality = ConversationLocality(
            topic=self.db.topic_name, n_lanes=self._n_shards(),
            leadership=ha_node.assignment_of,
            num_partitions=self.db.num_partitions,
            local_node=ha_node.node_id,
            metrics=self.db.metrics, flight=self.engine.flight)
        ha_node.add_rebalance_listener(self._locality.on_rebalance)

    # ------------------------------------------------------------ lifecycle

    @classmethod
    def from_model_name(
        cls,
        db: SwarmDB,
        model_name: str,
        backend_id: str = "gpu-0",
        max_batch: int = 8,
        max_seq: Optional[int] = None,
        seed: int = 0,
        tokenizer_path: Optional[str] = None,
        decode_chunk: int = 8,
        paged: Optional[bool] = None,
        page_size: int = 16,
        kv_pool_tokens: Optional[int] = None,
        prefill_batch: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "ServingService":
        """Build model + engine for a registry config on ``device`` (the
        card unless ``device="cpu"``); weights are random from ``seed``.
        An engine restart dumps its flight record under
        ``db.save_dir/flight`` (``SWARMDB_FLIGHT_DIR`` overrides)."""
        engine, tokenizer = build_backend_engine(
            model_name, max_batch=max_batch, max_seq=max_seq, seed=seed,
            decode_chunk=decode_chunk, paged=paged, page_size=page_size,
            kv_pool_tokens=kv_pool_tokens, prefill_batch=prefill_batch,
            metrics=db.metrics, tokenizer_path=tokenizer_path,
            device=device, flight_dir=os.path.join(db.save_dir, "flight"))
        engine.flight.meta.update({"backend_id": backend_id,
                                   "model": model_name})
        return cls(db, engine, tokenizer, backend_id=backend_id)

    def start(self, warmup: Optional[bool] = None) -> None:
        """Bring up the engine, the reply worker and the broker consumer.
        ``warmup`` (default: ``SWARMDB_PREWARM`` is "1") prepares every
        decode variant first (``Engine.warmup``: on the card, the chunk
        graphs), before any request can reach the engine."""
        if warmup is None:
            warmup = os.environ.get("SWARMDB_PREWARM", "0") == "1"
        self._stop.clear()
        if warmup:
            self.engine.warmup()
        self.engine.start()
        if self._reply_thread is None:
            self._reply_thread = threading.Thread(
                target=self._reply_loop, daemon=True,
                name=f"gpu-replies-{self.backend_id}")
            self._reply_thread.start()
        if self._consumer_thread is None:
            self._consumer_thread = threading.Thread(
                target=self._consume_loop, daemon=True,
                name=f"gpu-backend-{self.backend_id}")
            self._consumer_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._consumer_thread is not None:
            self._consumer_thread.join(timeout=10)
            self._consumer_thread = None
        if self._tier is not None:
            # before the engine: an order queued after its loop stopped
            # would never drain
            self._tier.stop()
        if self.supervisor is not None:
            # before the engine: an engine stopping must not read as a
            # loop to restart
            self.supervisor.stop()
        self.engine.stop()
        if self._tier is not None:
            # the engine's loop is done: release the warm store's slab
            # now, not at a later cyclic collection
            self._tier.close()
        if self._reply_thread is not None:
            self._reply_queue.put(None)  # after the engine drained
            self._reply_thread.join(timeout=10)
            self._reply_thread = None

    # --------------------------------------------------- broker consumption

    def _consume_loop(self) -> None:
        """Poll the inboxes of this backend's agents and serve new chat /
        function_call messages. Without a supervisor, restart a dead
        engine loop here (the supervisor does it otherwise)."""
        while not self._stop.is_set():
            if self.supervisor is None and not self.engine.alive():
                logger.error("engine loop dead; restarting backend %s",
                             self.backend_id)
                try:
                    self.engine.restart()
                except Exception:
                    logger.exception("engine restart failed; backing off")
                    self._stop.wait(1.0)
                    continue
            served = 0
            for agent in self.db.agents_for_backend(self.backend_id):
                if self._stop.is_set():
                    break
                try:
                    msgs = self.db.receive_messages(agent, max_messages=8,
                                                    timeout=0.0)
                except Exception:
                    logger.exception("backend receive failed for %s", agent)
                    continue
                for msg in msgs:
                    if msg.type not in (MessageType.CHAT,
                                        MessageType.FUNCTION_CALL):
                        self.db.metrics.counters[
                            "backend_skipped_messages"].inc()
                        continue
                    try:
                        self.serve_message(msg)
                    except Exception:
                        logger.exception("serve_message failed for %s",
                                         msg.id)
                        self.db.update_message_status(msg.id, "failed")
                        self.db.metrics.counters[
                            "backend_serve_errors"].inc()
                    served += 1
            if served == 0:
                self._stop.wait(self.poll_interval)

    # ----------------------------------------------------------- rolling KV

    def _rolling_epoch(self) -> int:
        """The engine's pool generation: registry entries of an older
        epoch name page ids a reset reclaimed, and are never resumed or
        freed."""
        return self.engine.pool_epoch()

    def _on_pool_pressure(self, need: int) -> None:
        """Engine thread, the pool could not cover ``need`` pages: spill
        the coldest idle conversations to host memory first (they come
        back by promotion), then evict to nothing for any shortfall (the
        only option with ``SWARMDB_TIER=0`` or a dense engine)."""
        with self._rolling_lock:
            if self._tier is not None:
                need -= self._tier.demote_now(need)
            if need > 0:
                self._rolling_evict(need)

    # swarmlint: holds[self._rolling_lock]
    def _rolling_evict(self, need_free: int) -> None:
        """LRU-evict idle conversations until the pool can cover
        ``need_free`` pages (caller holds ``_rolling_lock``)."""
        eng = self.engine
        epoch = self._rolling_epoch()
        idle = sorted((k for k, st in self._rolling.items()
                       if not st.get("in_flight") and st.get("pages")),
                      key=lambda k: self._rolling[k]["last"])
        for k in idle:
            if eng.rolling_free_count() >= need_free:
                break
            st = self._rolling.pop(k)
            if st["epoch"] == epoch:
                eng.rolling_free(st["pages"])
            self._mem.drop(k)
            self.db.metrics.counters["rolling_evictions"].inc()
            if self._tier is not None:
                # evicted to nothing: its next turn is a cold resume
                self._tier.note_cold(k, len(st["pages"]))

    def _rolling_plan(self, key, msg: Message, sampling: SamplingParams,
                      pre_count: int = 0):
        """How this turn uses the rolling registry: (mode, resume,
        prompt_tokens).

        - ("resume", (pages, len, epoch, promote_payload), tokens):
          continue the kept pages with the delta ``tokens``;
        - ("keep", None, None): a fresh prefill that claims the
          conversation (its retirement stores the new state);
        - ("plain", None, None): a fresh prefill that leaves the registry
          alone, because a concurrent turn of the conversation holds the
          claim (a keep here would leak the pages a later store
          displaces).

        A claim the tier worker holds for a demotion the engine has not
        run yet (``tier_demote``) is taken back: the turn resumes hot and
        ``TierManager.drain_engine`` skips the order. A conversation being
        touched is no longer the coldest; the gate signals again while
        pressure remains.

        ``pre_count`` is the conversation's length read before the prompt
        window was fetched: a message that lands in between renders next
        turn instead of being counted as rendered."""
        eng = self.engine
        ps = eng.rolling_page_size()
        with self._rolling_lock:
            epoch = self._rolling_epoch()
            st = self._rolling.get(key)
            if st is not None and st["epoch"] != epoch and st.get("pages"):
                # the pool was rebuilt: dangling page ids (a warm entry
                # holds none and survives resets)
                self._rolling.pop(key, None)
                st = None
            if st is not None and st.get("in_flight"):
                if not st.pop("tier_demote", None):
                    return "plain", None, None
                st["in_flight"] = False
            # await_store: cleared by _rolling_store; still set at
            # finalize, the turn's K/V was never adopted (a dense
            # extraction came up short) and the state restarts
            placeholder = {"pages": None, "len": 0, "tail": [],
                           "msg_count": 0, "reply_ids": [],
                           "pending_count": pre_count, "epoch": epoch,
                           "in_flight": True, "await_store": True,
                           "last": time.time()}
            warm = (st is not None and not st.get("pages")
                    and st.get("host") and self._tier is not None)
            if st is None or (not st.get("pages") and not warm):
                self._rolling[key] = placeholder
                if self._tier is not None:
                    msg.metadata["tier_origin"] = (
                        "cold" if self._tier.take_cold(key) else "fresh")
                return "keep", None, None

            # swarmlint: holds[self._rolling_lock]
            def restart() -> Tuple[str, None, None]:
                if st.get("pages") and st["epoch"] == epoch:
                    eng.rolling_free(st["pages"])
                elif warm:
                    # the restart rebuilds the prompt from the window
                    self._tier.drop_warm(key)
                self._rolling[key] = placeholder
                self.db.metrics.counters["rolling_restarts"].inc()
                return "keep", None, None

            total, delta = self.db.get_conversation_delta(
                key[0], key[1], st["msg_count"])
            if not any(m.id == msg.id for m in delta):
                # the registry is out of step with the stream (a restore,
                # say): restart fresh
                return restart()
            lines = [_history_line(m) for m in delta
                     if m.id != msg.id and m.id not in st["reply_ids"]]
            # the current message renders last; the replies are in K/V
            # as the model's own tokens
            lines.extend(_current_lines(msg))
            ptoks = list(st["tail"]) + self.tokenizer.encode(
                "".join("\n" + ln for ln in lines), add_bos=False)
            fits = (st["len"] + len(ptoks) + sampling.max_new_tokens
                    + eng.decode_chunk < eng.max_seq
                    and -(-st["len"] // ps) <= eng._prefix_pp_buckets[-1]
                    and len(ptoks) > 0)
            # the suffix EMA moves on restarts too, or a restart-locked
            # conversation could never grow its reserve
            self._rolling_delta_ema = (0.8 * self._rolling_delta_ema
                                       + 0.2 * len(ptoks))
            if not fits:
                return restart()
            # pool headroom: paged needs only the fresh pages past the
            # kept ones (a warm entry's promotion draws them too), dense
            # the whole new page set at its retirement extraction
            total_pages = -(-(st["len"] + len(ptoks)
                              + sampling.max_new_tokens
                              + eng.decode_chunk) // ps)
            kept_n = -(-st["len"] // ps)
            need = (total_pages if warm or eng.paged is None
                    else total_pages - kept_n)
            # claim first: an eviction here must not free this very
            # conversation's pages
            st["in_flight"] = True
            if need > 0:
                self._rolling_evict(need)
            st["pending_count"] = total
            st["await_store"] = True
            st["last"] = time.time()
            self.db.metrics.counters["rolling_resumes"].inc()
            payload = None
            if warm:
                got = self._tier.begin_promote(key, st, epoch)
                if got is None:
                    # the warm copy is gone or the pool cannot host it:
                    # a cold resume from the broker log
                    self._rolling[key] = placeholder
                    msg.metadata["tier_origin"] = (
                        "cold" if self._tier.take_cold(key) else "fresh")
                    self.db.metrics.counters["rolling_restarts"].inc()
                    return "keep", None, None
                ids, payload = got
                st["pages"] = list(ids)
                st["epoch"] = epoch
                st["host"] = False
            if self._tier is not None:
                msg.metadata["tier_origin"] = "warm" if warm else "hot"
            # the epoch travels with the plan: submit and admission check
            # it against the live pool
            return "resume", (st["pages"], st["len"], epoch, payload), ptoks

    def _rolling_store(self, key, pages, written, tail) -> None:
        """``on_pages`` (engine thread, at retirement): the turn's pages
        become the conversation's state. A predecessor's pages were freed
        by the plan (restart) or are a prefix of ``pages`` (resume)."""
        with self._rolling_lock:
            prev = self._rolling.get(key, {})
            self._rolling[key] = {
                "pages": pages, "len": written, "tail": list(tail),
                # stream index < msg_count is in K/V (or was trimmed
                # away by the fresh window); replies are excluded by id
                "msg_count": prev.get("pending_count",
                                      self.db.conversation_length(*key)),
                "reply_ids": list(prev.get("reply_ids", ())),
                "epoch": self._rolling_epoch(),
                "in_flight": True, "last": time.time(),
            }
        self._mem.resident(key, len(pages))

    def _rolling_finalize(self, key, msg: Message, reason: str) -> None:
        """After the reply was sent (reply worker): record its id, which
        later deltas skip (its tokens are in K/V already). A non-clean
        finish, or a clean one whose K/V was never stored, drops the
        state."""
        with self._rolling_lock:
            st = self._rolling.get(key)
            if st is None:
                return
            if (reason in ("length", "eos") and st.get("pages")
                    and not st.get("await_store")):
                rid = (msg.metadata or {}).get("reply_id")
                if rid:
                    # only replies at stream index >= msg_count matter
                    st["reply_ids"] = st["reply_ids"][-3:] + [rid]
                st["in_flight"] = False
                st["last"] = time.time()
                return
            if st.get("await_store") and reason in ("length", "eos"):
                self.db.metrics.counters["rolling_restarts"].inc()
            self._rolling.pop(key, None)
            self._mem.drop(key)
            if st.get("pages") and st["epoch"] == self._rolling_epoch():
                self.engine.rolling_free(st["pages"])
            elif st.get("host") and self._tier is not None:
                self._tier.drop_warm(key)

    # ------------------------------------------------------------- serving

    def _hysteresis_trim(self, prompt: List[int], budget: int,
                         ps: int) -> List[int]:
        """Drop the front in page-aligned steps of ~half the budget, so
        consecutive turns keep a common prefix."""
        frac = min(0.9, max(0.1, _env_float("SWARMDB_TRIM_STEP", 0.5)))
        step = max(ps, int(budget * frac) // ps * ps)
        drop = -(-(len(prompt) - budget) // step) * step
        if len(prompt) - drop >= 16:
            return prompt[drop:]
        return prompt[-budget:]

    def _trim_prompt(self, msg: Message, prompt: List[int],
                     budget: int) -> List[int]:
        """Sink-anchored window once a conversation overflows the budget:
        [head: the first page-aligned tokens, captured once] + [a fixed
        elision marker] + [tail: the newest tokens, trimmed in page-aligned
        steps]. The head keeps positions 0.. in every later turn, so its
        pages hit the prefix cache whatever the tail does.
        ``SWARMDB_ANCHOR_HEAD`` sets the head in pages (default 4; 0 = the
        plain hysteresis trim)."""
        eng = self.engine
        if eng._prefix is None:
            return prompt[-budget:]
        ps = eng._prefix_ps
        head_pages = _env_int("SWARMDB_ANCHOR_HEAD", 4)
        hb = min(head_pages * ps, (budget // 2) // ps * ps)
        if head_pages <= 0 or msg.receiver_id is None or hb < ps:
            return self._hysteresis_trim(prompt, budget, ps)
        key = (msg.sender_id, msg.receiver_id)
        with self._anchor_lock:
            head = self._anchors.get(key)
            if head is None:
                head = prompt[:hb]
                while len(self._anchors) >= self._anchor_cap:
                    self._anchors.pop(next(iter(self._anchors)))
                self._anchors[key] = head
                self._mem.anchor(key, len(head))
                self.db.metrics.counters["window_heads_anchored"].inc()
            else:
                self._anchors[key] = self._anchors.pop(key)  # LRU touch
        tail_budget = budget - len(head) - len(self._anchor_sep)
        if tail_budget < max(ps, budget // 4):
            return self._hysteresis_trim(prompt, budget, ps)
        step = max(ps, (tail_budget // 2) // ps * ps)
        drop = -(-(len(prompt) - tail_budget) // step) * step
        tail = (prompt[drop:] if 0 < len(prompt) - drop <= tail_budget
                else prompt[-tail_budget:])
        self.db.metrics.counters["window_tail_trims"].inc()
        return list(head) + list(self._anchor_sep) + tail

    def serve_message(self, msg: Message, on_token=None,
                      on_done=None) -> str:
        """Submit one message for generation; the reply is emitted on
        completion. Returns the engine request id (completion 0's when
        ``n > 1``). A message already being served (or served) is not
        generated again: the callbacks attach to its generation."""
        return self._serve(msg, on_token, on_done)[0]

    def _serve(self, msg: Message, on_token, on_done) -> Tuple[str, bool]:
        """(request id, whether this call started the generation)."""
        with self._claims_lock:
            claim = self._claims.get(msg.id)
            if claim is not None:
                # attach under the lock the token fan-out takes, so the
                # replayed tokens come before any live one
                toks = (claim.final[0] if claim.final is not None
                        else claim.tokens)
                if on_token is not None:
                    for t in toks:
                        on_token(claim.rid, t)
                if claim.final is None:
                    claim.listeners.append((on_token, on_done))
                elif on_done is not None:
                    on_done(claim.rid, *claim.final)
                return claim.rid, False
            claim = self._claims[msg.id] = _Claim()
            while len(self._claims) > _CLAIMS_MAX:
                self._claims.popitem(last=False)
        t_serve = TRACER.span_begin()
        try:
            self._start(msg, claim, on_token, on_done)
        except Exception:
            # the raise reaches this caller only: finish every listener
            # that attached while the generation was being submitted
            with self._claims_lock:
                if self._claims.get(msg.id) is claim:
                    del self._claims[msg.id]
                claim.final = ([], "engine_error")
                claim.tokens = None
                listeners, claim.listeners = claim.listeners, []
            for _, cb in listeners:
                if cb is not None:
                    try:
                        cb(claim.rid, [], "engine_error")
                    except Exception:
                        logger.exception("on_done callback failed for %s",
                                         msg.id)
            raise
        # the prompt build and the submit; the args join the message id
        # (the runtime's and the broker's rid) to the engine request id
        # (the engine's spans), so one export holds the whole request
        TRACER.span_end(t_serve, "serve.request", cat="serving", rid=msg.id,
                        args={"engine_rid": claim.rid})
        return claim.rid, True

    def _start(self, msg: Message, claim: _Claim, user_on_token,
               user_on_done) -> str:
        """Build the prompt and submit the generation of ``msg``."""

        def on_token(rid: str, token: int) -> None:
            with self._claims_lock:
                claim.tokens.append(token)
                for listen, _ in claim.listeners:
                    if listen is not None:
                        listen(rid, token)
            if user_on_token is not None:
                user_on_token(rid, token)

        def on_done(rid: str, tokens: List[int], reason: str) -> None:
            # reply worker, after the reply was emitted
            with self._claims_lock:
                claim.final = (list(tokens), reason)
                claim.tokens = None
                listeners, claim.listeners = claim.listeners, []
            for cb in [user_on_done] + [d for _, d in listeners]:
                if cb is not None:
                    try:
                        cb(rid, tokens, reason)
                    except Exception:
                        logger.exception("on_done callback failed for %s",
                                         msg.id)

        msg.stage_stamp("admitted")
        # rolling KV reads the stream length before the window fetch (see
        # _rolling_plan)
        pre_count = (self.db.conversation_length(msg.sender_id,
                                                 msg.receiver_id)
                     if self._rolling is not None and msg.receiver_id
                     else 0)
        prompt = build_prompt(self.db, msg, self.tokenizer,
                              history_limit=_history_limit_for(
                                  self.engine.max_seq))
        if msg.receiver_id:
            # one touch per served message, with the untrimmed length (what
            # a cold resume re-prefills)
            self._mem.touch((msg.sender_id, msg.receiver_id), len(prompt))
        sampling = sampling_from_message(msg)
        priority = int(msg.priority.value if hasattr(msg.priority, "value")
                       else msg.priority)
        g = (msg.metadata.get("generation", {})
             if isinstance(msg.metadata, dict) else {})
        want_logprobs = bool(g.get("logprobs"))
        # n completions: each its own slot, sharing the prompt's pages
        # through the prefix cache; completion 0 is the body (and the
        # streamed one), 1..n-1 ride metadata["alternatives"]
        n = min(4, max(1, int(g.get("n", 1))))
        # rolling KV: chat and tool-call turns continue the conversation's
        # kept pages. Not with n > 1 (the completions would fight over the
        # pages) or stop sequences (the truncated reply would differ from
        # the K/V)
        rolling_key = resume = None
        mode = "plain"
        if (self._rolling is not None and msg.receiver_id and n == 1
                and not sampling.stop
                and msg.type in (MessageType.CHAT,
                                 MessageType.FUNCTION_CALL)):
            key = (msg.sender_id, msg.receiver_id)
            mode, resume, rtoks = self._rolling_plan(key, msg, sampling,
                                                     pre_count)
            if mode != "plain":
                rolling_key = key
            if resume is not None:
                prompt = rtoks
            if rolling_key is not None:
                claim_done = on_done

                def on_done(rid, toks, reason, _k=rolling_key):
                    # reply worker, after _emit_reply stamped the reply id
                    self._rolling_finalize(_k, msg, reason)
                    claim_done(rid, toks, reason)
        try:
            if resume is None:
                prompt = self._fit_prompt(msg, prompt, sampling,
                                          restart=mode == "keep")

            def _done(rid: str, tokens: List[int], reason: str) -> None:
                # engine (or supervisor) thread: hand off to _reply_loop
                msg.stage_stamp("done")
                lps = (list(req.metadata.get("logprobs", []))
                       if want_logprobs else None)
                self._reply_queue.put((msg, rid, tokens, reason,
                                       sampling.stop, lps, None, on_done))

            def _tok(rid: str, token: int) -> None:
                if "first_token" not in msg.metadata.get("stages", {}):
                    msg.stage_stamp("first_token")
                    stages = msg.metadata["stages"]
                    if "enqueued" in stages:
                        ttft = stages["first_token"] - stages["enqueued"]
                        lat = self.db.metrics.latencies
                        lat["send_to_first_token_s"].observe(ttft)
                        lat[f"send_to_first_token_prio{priority}_s"].observe(
                            ttft)
                        # per tier of the conversation's state (hot, warm,
                        # cold, fresh)
                        origin = (msg.metadata or {}).get("tier_origin")
                        if origin:
                            lat[f"tier_ttft_{origin}_s"].observe(ttft)
                if on_token is not None:
                    on_token(rid, token)

            req = GenRequest(prompt=prompt, sampling=sampling,
                             priority=priority, on_token=_tok, on_done=_done,
                             metadata={"message_id": msg.id},
                             request_id=claim.rid)
            n_shards = self._n_shards()
            if self._locality is not None and msg.receiver_id:
                # the lane pin follows the conversation's partition
                # leader, so log ownership and serving coincide, and a
                # leadership move re-pins it (ha.repin)
                lpin = self._locality.pin(msg.sender_id, msg.receiver_id)
                if n_shards > 1:
                    req.shard_hint = lpin.lane
            elif n_shards > 1:
                # a lane group: the conversation's turns go to one lane,
                # whose prefix cache holds its pages (the order-insensitive
                # pair is get_conversation's identity)
                pair = "|".join(sorted((msg.sender_id,
                                        msg.receiver_id or "")))
                req.shard_hint = stable_partition(pair, n_shards)
            if rolling_key is not None:
                req.keep_pages = True
                req.on_pages = (lambda rid, pages, written, tail,
                                _k=rolling_key:
                                self._rolling_store(_k, pages, written, tail))
                if resume is not None:
                    (req.resume_pages, req.resume_len, req.resume_epoch,
                     req.promote_payload) = (list(resume[0]), resume[1],
                                             resume[2], resume[3])
            if n > 1:
                return self._serve_n(msg, req, prompt, sampling, priority, n,
                                     want_logprobs, on_done)
            watch = self._make_stop_watch(sampling)
            if watch is not None:
                def _tok_watched(rid: str, token: int) -> None:
                    watch(rid, token)
                    _tok(rid, token)

                req.on_token = _tok_watched
            return self._submit(req)
        except Exception:
            # the plan's claim must not outlive a failed submit, or the
            # conversation never rolls again
            if rolling_key is not None:
                self._rolling_finalize(rolling_key, msg, "submit_error")
            raise

    def _fit_prompt(self, msg: Message, prompt: List[int],
                    sampling: SamplingParams, restart: bool) -> List[int]:
        """A fresh prompt cut to the window. A rolling restart keeps
        headroom for the next turns: at most ``SWARMDB_ROLL_RESTART``
        (default 0.5) of the budget and no more than the budget less ~2.5
        typical turn deltas, with a quarter of the budget as the floor,
        cut from the front; other prompts take the sink-anchored trim."""
        budget = min(max(16, self.engine.max_seq - 1
                         - sampling.max_new_tokens), self.engine.max_seq - 1)
        if restart:
            frac = min(0.9, max(0.1, _env_float("SWARMDB_ROLL_RESTART",
                                                0.5)))
            with self._rolling_lock:
                delta_ema = self._rolling_delta_ema
            reserve = int(2.5 * delta_ema) + self.engine.decode_chunk
            budget = max(16, min(int(budget * frac),
                                 max(budget // 4, budget - reserve)))
            return prompt[-budget:] if len(prompt) > budget else prompt
        if len(prompt) > budget:
            return self._trim_prompt(msg, prompt, budget)
        return prompt

    def _serve_n(self, msg: Message, req0: GenRequest, prompt: List[int],
                 sampling: SamplingParams, priority: int, n: int,
                 want_logprobs: bool, on_done) -> str:
        """Fan ``n`` completions over engine slots; emit ONE reply whose
        body is completion 0 and whose metadata carries the rest.
        Completion i samples with seed ``seed + i`` (a fresh random base
        when the request is sampled but unseeded), so two completions on
        one slot do not replay one key; greedy ones are equal by
        definition."""
        base_seed = sampling.seed
        if base_seed is None and sampling.temperature > 0:
            base_seed = int.from_bytes(os.urandom(8), "little")
        results: Dict[int, Tuple[List[int], str, Optional[List[float]]]] = {}
        lock = make_lock("backend.service.ServingService._serve_n.lock")

        def mk_done(idx: int, reqs: List[GenRequest]):
            def _done_i(rid: str, tokens: List[int], reason: str) -> None:
                lps = (list(reqs[idx].metadata.get("logprobs", []))
                       if want_logprobs else None)
                with lock:
                    results[idx] = (tokens, reason, lps)
                    if len(results) < n:
                        return
                # the last completion emits the aggregate
                self._fanout.pop(reqs[0].request_id, None)
                msg.stage_stamp("done")
                toks0, reason0, lps0 = results[0]
                self._reply_queue.put(
                    (msg, reqs[0].request_id, toks0, reason0, sampling.stop,
                     lps0, [results[i] for i in range(1, n)], on_done))
            return _done_i

        reqs: List[GenRequest] = []
        for i in range(n):
            sp = dataclasses.replace(
                sampling, seed=None if base_seed is None else base_seed + i)
            # every completion watches its own stop match; completion 0
            # also keeps the TTFT / user token callback
            watch = self._make_stop_watch(sp)
            prev = req0.on_token if i == 0 else None

            def on_tok(rid, token, watch=watch, prev=prev):
                if watch is not None:
                    watch(rid, token)
                if prev is not None:
                    prev(rid, token)

            # completion 0 keeps the message's request id
            extra = {"request_id": req0.request_id} if i == 0 else {}
            reqs.append(GenRequest(
                prompt=list(prompt), sampling=sp, priority=priority,
                on_token=on_tok, metadata=dict(req0.metadata, alt=i),
                **extra))
        for i, r in enumerate(reqs):
            r.on_done = mk_done(i, reqs)
        self._fanout[reqs[0].request_id] = [r.request_id for r in reqs]
        submitted: List[GenRequest] = []
        try:
            for r in reqs:
                self._submit(r)
                submitted.append(r)
        except Exception:
            # without the whole group the aggregate would never emit
            self._fanout.pop(reqs[0].request_id, None)
            for r in submitted:
                self.cancel_request(r.request_id)
            raise
        return reqs[0].request_id

    def _make_stop_watch(self, sampling: SamplingParams):
        """Host-side stop-sequence watch for one engine request: a
        bounded tail of decoded tokens (a character is up to 4 bytes, one
        token each), the request cancelled at the first match (at most a
        chunk of extra tokens, truncated at emission). None without stop
        sequences."""
        if not sampling.stop:
            return None
        tail: List[int] = []
        window = 4 * max(len(s) for s in sampling.stop) + 8
        hit = [False]

        def _watch(rid: str, token: int) -> None:
            if hit[0]:
                return
            tail.append(token)
            del tail[:-window]
            text = self.tokenizer.decode(tail)
            if any(s in text for s in sampling.stop):
                hit[0] = True
                self.engine.cancel(rid)  # this completion only

        return _watch

    def _submit(self, req: GenRequest) -> str:
        """Through the supervisor when attached, else to the engine."""
        if self.supervisor is not None:
            return self.supervisor.submit(req)
        return self.engine.submit(req)

    def cancel_request(self, rid: str) -> None:
        """Cancel a request and every member of its fan-out, wherever it
        lives: in the engine, or parked on a supervisor retry timer."""
        for r in self._fanout.pop(rid, [rid]):
            if self.supervisor is not None and self.supervisor.cancel(r):
                continue
            self.engine.cancel(r)

    def _reply_loop(self) -> None:
        """Drain completed generations into reply messages."""
        while True:
            item = self._reply_queue.get()
            if item is None:
                return
            msg, rid, tokens, reason, stop, lps, alts, on_done = item
            self._emit_with_retry(msg, tokens, reason, stop, lps, alts)
            if on_done is not None:
                try:
                    on_done(rid, tokens, reason)
                except Exception:
                    logger.exception("on_done callback failed for %s",
                                     msg.id)

    # swarmlint: retry
    def _emit_with_retry(self, msg: Message, tokens: List[int], reason: str,
                         stop: tuple, lps: Optional[List[float]],
                         alts: Optional[List[Tuple]]) -> None:
        """Emit one reply. A retryable produce failure
        (``LeaderChangedError`` from a partition-routed broker
        mid-failover) is retried with jittered exponential backoff from
        ``SWARMDB_RETRY_BACKOFF_S`` (0.05 s, each sleep at most 0.5 s)
        until ``SWARMDB_REPLY_RETRIES`` attempts (3) are spent and the
        failover budget has passed since the first failure
        (``promotion_budget_s`` of the detector's times): the failover
        re-seats the partition, and the reply lands on the new leader
        instead of ending FAILED. The JAX package stops after the three
        attempts, whose sleeps total 0.35-0.7 s: less than a promotion,
        so a reply produced to a dead leader could be dropped."""
        retries = _env_int("SWARMDB_REPLY_RETRIES", 3)
        backoff = _env_float("SWARMDB_RETRY_BACKOFF_S", 0.05)
        attempt, deadline = 0, None
        while True:
            try:
                self._emit_reply(msg, tokens, reason, stop, lps, alts)
                return
            except Exception as exc:
                if deadline is None:
                    deadline = time.monotonic() + self._failover_budget_s
                if (not getattr(exc, "retryable", False)
                        or self._stop.is_set()
                        or (attempt >= retries
                            and time.monotonic() >= deadline)):
                    logger.exception("failed to emit reply for %s", msg.id)
                    return
            self.db.metrics.counters["reply_retries"].inc()
            time.sleep(min(backoff * 2 ** attempt, 0.5)
                       * (1.0 + random.random()))
            attempt += 1

    def _finish_completion(self, tokens: List[int], reason: str,
                           stop: tuple, logprobs: Optional[List[float]]
                           ) -> Tuple[str, str, Optional[List[float]]]:
        """Decode + stop-truncate one completion (logprobs kept parallel to
        the visible text)."""
        text = self.tokenizer.decode(tokens)
        if stop:
            cut = min((i for i in (text.find(s) for s in stop) if i >= 0),
                      default=-1)
            if cut >= 0:
                text = text[:cut]
                reason = "stop"
                if logprobs is not None:
                    n = 0
                    while (n < len(tokens) and len(
                            self.tokenizer.decode(tokens[:n + 1])) <= cut):
                        n += 1
                    logprobs = logprobs[:n]
        return text, reason, logprobs

    def _emit_reply(self, msg: Message, tokens: List[int], reason: str,
                    stop: tuple = (),
                    logprobs: Optional[List[float]] = None,
                    alts: Optional[List[Tuple]] = None) -> None:
        text, reason, logprobs = self._finish_completion(tokens, reason,
                                                         stop, logprobs)
        reply_meta: Dict[str, Any] = {
            "reply_to": msg.id,
            "backend_id": self.backend_id,
            "finish_reason": reason,
            "completion_tokens": len(tokens),
        }
        if logprobs is not None:
            reply_meta["logprobs"] = [round(x, 6) for x in logprobs]
        if alts:
            rendered = []
            for toks_i, reason_i, lps_i in alts:
                text_i, reason_i, lps_i = self._finish_completion(
                    toks_i, reason_i, stop, lps_i)
                entry = {"text": text_i, "finish_reason": reason_i,
                         "completion_tokens": len(toks_i)}
                if lps_i is not None:
                    entry["logprobs"] = [round(x, 6) for x in lps_i]
                rendered.append(entry)
            reply_meta["alternatives"] = rendered
        reply_type = (MessageType.FUNCTION_RESULT
                      if msg.type == MessageType.FUNCTION_CALL
                      else MessageType.CHAT)
        reply_id = self.db.send_message(
            msg.receiver_id or self.backend_id, msg.sender_id, text,
            message_type=reply_type, priority=msg.priority,
            metadata=reply_meta)
        msg.metadata["reply_id"] = reply_id
        self.db.mark_message_as_processed(msg.id)
        self.db.metrics.rates["completed_messages"].mark()
        self.db.metrics.counters["completed_messages"].inc()
        stages = msg.metadata.get("stages", {})
        if "enqueued" in stages:
            self.db.metrics.latencies["send_to_done_s"].observe(
                time.time() - stages["enqueued"])

    # ------------------------------------------------------------ streaming

    def _backed_here(self, msg: Message) -> bool:
        """True when this backend answers ``msg``'s receiver anyway (its
        consumer serves the message whether or not a client streams it)."""
        return (msg.receiver_id is not None
                and self.db.get_llm_backend(msg.receiver_id)
                == self.backend_id)

    async def stream_reply(self, msg: Message) -> AsyncIterator[str]:
        """Async token-text stream for SSE: engine-thread callbacks reach
        this loop only through ``call_soon_threadsafe``. The stream never
        shows a stop string: a released suffix that could still begin one
        is held back until disproven. A client that leaves cancels the
        generation only if the stream started it for an agent this
        backend does not answer anyway."""
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def _post(item) -> None:
            # the client's loop closes on disconnect while callbacks still
            # land; the cancel is on its way, so a closed loop is expected
            try:
                loop.call_soon_threadsafe(q.put_nowait, item)
            except RuntimeError:
                pass

        def on_token(rid: str, token: int) -> None:
            _post(("token", token))

        def on_done(rid: str, tokens: List[int], reason: str) -> None:
            _post(("done", reason))

        stop = sampling_from_message(msg).stop
        held = ""  # seen but not yet released (a possible stop prefix)

        def _guard(piece: str, flush: bool = False) -> Tuple[str, bool]:
            """(text to yield, matched a stop string)."""
            nonlocal held
            if not stop:
                return piece, False
            buf = held + piece
            cut = min((i for i in (buf.find(s) for s in stop) if i >= 0),
                      default=-1)
            if cut >= 0:
                held = ""
                return buf[:cut], True
            if flush:
                held = ""
                return buf, False
            # longest suffix of buf that is a proper prefix of a stop
            hold = 0
            for s in stop:
                for k in range(min(len(s) - 1, len(buf)), hold, -1):
                    if buf.endswith(s[:k]):
                        hold = k
                        break
            held = buf[len(buf) - hold:] if hold else ""
            return buf[:len(buf) - hold], False

        rid, owner = self._serve(msg, on_token, on_done)
        pending: List[int] = []
        try:
            while True:
                kind, value = await q.get()
                if kind == "token":
                    pending.append(value)
                    # UTF-8 may be split across tokens: release text only
                    # once the pending bytes decode whole
                    text = self.tokenizer.decode(pending)
                    if text and not text.endswith("�"):
                        out, matched = _guard(text)
                        if out:
                            yield out
                        if matched:
                            return
                        pending = []
                else:
                    tail = self.tokenizer.decode(pending) if pending else ""
                    out, _ = _guard(tail, flush=True)
                    if out:
                        yield out
                    return
        finally:
            # a client that disconnects closes this generator mid-stream:
            # stop the generation and its fan-out (a no-op once finished)
            if owner and not self._backed_here(msg):
                self.cancel_request(rid)

    async def stream_group(self, msgs: List[Message]
                           ) -> AsyncIterator[Dict[str, Any]]:
        """Serve every group message at once (distinct slots, one decode
        batch) and interleave token events tagged by message id; each
        member ends with a ``reply_done`` event whose text is its stored
        reply's."""
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        remaining = 0
        rids: List[str] = []   # the generations to cancel on a disconnect

        def _post(item) -> None:
            try:
                loop.call_soon_threadsafe(q.put_nowait, item)
            except RuntimeError:
                pass  # loop closed on disconnect; the cancel is in flight

        def mk(msg_id: str, stop: tuple):
            def on_token(rid: str, token: int) -> None:
                _post({"event": "token", "message_id": msg_id,
                       "token": token})

            def on_done(rid: str, tokens: List[int], reason: str) -> None:
                text, reason, _ = self._finish_completion(tokens, reason,
                                                          stop, None)
                _post({"event": "reply_done", "message_id": msg_id,
                       "finish_reason": reason, "text": text})

            return on_token, on_done

        try:
            # submit inside the try: if a later member fails to submit,
            # the finally still cancels the running ones
            for msg in msgs:
                if msg is None:
                    continue
                remaining += 1
                on_token, on_done = mk(msg.id,
                                       sampling_from_message(msg).stop)
                rid, owner = self._serve(msg, on_token, on_done)
                if owner and not self._backed_here(msg):
                    rids.append(rid)
            while remaining > 0:
                item = await q.get()
                if item.get("event") == "reply_done":
                    remaining -= 1
                yield item
        finally:
            for rid in rids:
                self.cancel_request(rid)

    # --------------------------------------------------------------- health

    def health(self) -> Dict[str, Any]:
        """Device liveness probe: a tiny op on the engine's device, then
        the engine's and the supervisor's state."""
        dev = self.engine.device
        try:
            t0 = time.time()
            ok = float(torch.ones((8, 8), device=dev).mul(2).sum()) == 128.0
            probe_ms = (time.time() - t0) * 1000
            name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu")
        except Exception as exc:
            return {"status": "unhealthy", "error": str(exc)}
        return {
            "status": "healthy" if ok else "degraded",
            "device": name,
            "probe_ms": round(probe_ms, 3),
            "backend_id": self.backend_id,
            "engine": self.engine.stats(),
            "supervisor": (self.supervisor.status()
                           if self.supervisor is not None
                           else {"enabled": False}),
            "tier": (self._tier.status() if self._tier is not None
                     else {"enabled": False}),
        }
