"""ServingService: chat messages routed to an LLM backend become engine
requests, and replies come back as messages.

The counterpart of ``swarmdb_tpu/backend/service.py`` for the
single-lane engines, dense (the default, as in the JAX package) and paged
(``paged=True`` or ``SWARMDB_PAGED=1``):

- A consumer thread drains the inboxes of the agents assigned to this
  backend (``SwarmDB.assign_llm_backend``) and turns chat / function_call
  messages into engine requests (prompt = the two-way conversation window
  plus the new message, trimmed to the engine's window).
- Every request goes through a ``LaneSupervisor`` (``SWARMDB_SUPERVISE``,
  default "1"; ``backend/supervisor.py``): a deadline, a retry budget for
  retryable finishes ("shed", "engine_error", "engine_restart"), replay
  of a request cut off mid-stream, restart of a dead engine loop. With
  ``SWARMDB_SUPERVISE=0`` the consumer's watchdog restarts a dead loop.
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
row-bucketed and prefix waves. Not ported yet (ROADMAP.md, queue 1): rolling KV
and the tiered state hierarchy (item 7), lane groups (item 9), the SLO
sentinel (item 10) and partition locality (item 12).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
import queue
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

import torch

from ..core.messages import Message, MessageType
from ..core.runtime import SwarmDB
from ..models import llama, mixtral
from ..models.configs import ModelConfig, get_config
from ..ops.paged_kv import (KV_DTYPES, PageAllocator, kv_dtype_name,
                            pages_per_slot)
from ..utils.device import DeviceLike, resolve_device
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
                lines.append(f"{m.sender_id}: {_body(m)}")
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
      over the pool's pages."""
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
    forward_fn = lambda p, t, pos, c, logits_at=None: mod.forward(
        p, cfg, t, pos, c, logits_at=logits_at)
    if not paged:
        engine = _dense_engine(cfg, mod, params, dev, tokenizer, kv_dtype,
                               prefix_enabled, forward_fn,
                               max_batch=max_batch, max_seq=seq, seed=seed,
                               metrics=metrics, decode_chunk=decode_chunk,
                               prefill_batch=prefill_batch,
                               page_size=page_size, flight_dir=flight_dir)
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
    prefill_ragged = None
    if hasattr(mod, "forward_ragged_prefill"):
        prefill_ragged = (
            lambda p, toks, trow, tpos, tables, st, ln, pl, pk, pv:
                mod.forward_ragged_prefill(p, cfg, toks, trow, tpos, tables,
                                           st, ln, pl, pk, pv))
    paged_spec = PagedKV(
        init_pool=lambda: mod.init_paged_cache(
            cfg, max_batch, seq, num_pages, page_size, dtype=pool_kind,
            device=dev),
        page_size=page_size,
        num_pages=num_pages,
        allocator=PageAllocator(num_pages, page_size, seq, max_batch),
        prefill_ragged=prefill_ragged,
        decode_forward=lambda p, t, pos, c: mod.forward_paged(
            p, cfg, t, pos, c),
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
        max_batch=max_batch, max_seq=seq, eos_id=tokenizer.eos_id,
        pad_id=tokenizer.pad_id, seed=seed, metrics=metrics,
        decode_chunk=decode_chunk, prefill_batch=prefill_batch,
        prefix_cache=prefix_enabled, device=dev, flight_dir=flight_dir)
    return engine, tokenizer


def _dense_engine(cfg: ModelConfig, mod, params: Dict[str, Any],
                  dev: torch.device, tokenizer: Tokenizer,
                  kv_dtype: Optional[torch.dtype], prefix_enabled: bool,
                  forward_fn, *, max_batch: int, max_seq: int, seed: int,
                  metrics, decode_chunk: int, prefill_batch: Optional[int],
                  page_size: int, flight_dir: Optional[str]) -> Engine:
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
        max_batch=max_batch, max_seq=max_seq, eos_id=tokenizer.eos_id,
        pad_id=tokenizer.pad_id, seed=seed, metrics=metrics,
        decode_chunk=decode_chunk, prefill_batch=prefill_batch, device=dev,
        flight_dir=flight_dir)


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
        # request supervision: deadline + retry budget stamped on every
        # request, retryable finishes requeued, a dead loop restarted.
        # SWARMDB_SUPERVISE=0 leaves the consumer's watchdog restart
        self.supervisor: Optional[LaneSupervisor] = None
        if os.environ.get("SWARMDB_SUPERVISE", "1") != "0":
            self.supervisor = LaneSupervisor(engine,
                                             metrics=db.metrics).start()
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

    def start(self) -> None:
        """Bring up the engine, the reply worker and the broker consumer."""
        self._stop.clear()
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
        if self.supervisor is not None:
            # before the engine: an engine stopping must not read as a
            # loop to restart
            self.supervisor.stop()
        self.engine.stop()
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
        prompt = build_prompt(self.db, msg, self.tokenizer,
                              history_limit=_history_limit_for(
                                  self.engine.max_seq))
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
        budget = min(max(16, self.engine.max_seq - 1
                         - sampling.max_new_tokens), self.engine.max_seq - 1)
        if len(prompt) > budget:
            prompt = self._trim_prompt(msg, prompt, budget)

        def _done(rid: str, tokens: List[int], reason: str) -> None:
            # engine (or supervisor) thread: hand off to _reply_loop
            msg.stage_stamp("done")
            lps = (list(req.metadata.get("logprobs", []))
                   if want_logprobs else None)
            self._reply_queue.put((msg, rid, tokens, reason, sampling.stop,
                                   lps, None, on_done))

        def _tok(rid: str, token: int) -> None:
            if "first_token" not in msg.metadata.get("stages", {}):
                msg.stage_stamp("first_token")
                stages = msg.metadata["stages"]
                if "enqueued" in stages:
                    ttft = stages["first_token"] - stages["enqueued"]
                    self.db.metrics.latencies[
                        "send_to_first_token_s"].observe(ttft)
                    self.db.metrics.latencies[
                        f"send_to_first_token_prio{priority}_s"].observe(
                            ttft)
            if on_token is not None:
                on_token(rid, token)

        req = GenRequest(prompt=prompt, sampling=sampling, priority=priority,
                         on_token=_tok, on_done=_done,
                         metadata={"message_id": msg.id},
                         request_id=claim.rid)
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
            try:
                self._emit_reply(msg, tokens, reason, stop, lps, alts)
            except Exception:
                logger.exception("failed to emit reply for %s", msg.id)
            if on_done is not None:
                try:
                    on_done(rid, tokens, reason)
                except Exception:
                    logger.exception("on_done callback failed for %s",
                                     msg.id)

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
        }
