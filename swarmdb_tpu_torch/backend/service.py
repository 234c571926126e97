"""ServingService: chat messages routed to an LLM backend become engine
requests, and replies come back as messages.

The counterpart of ``swarmdb_tpu/backend/service.py`` for the
single-lane engines, dense (the default, as in the JAX package) and paged
(``paged=True`` or ``SWARMDB_PAGED=1``):

- A consumer thread drains the inboxes of the agents assigned to this
  backend (``SwarmDB.assign_llm_backend``) and turns chat / function_call
  messages into engine requests (prompt = the two-way conversation window
  plus the new message, trimmed to the engine's window).
- Replies are emitted through ``SwarmDB.send_message`` as first-class
  messages on a reply worker, off the engine thread.

The engine decodes in chunks (``SWARMDB_CHUNKED=1``, default) or one step
at a time (``SWARMDB_CHUNKED=0``): the dense engine over a bf16 slot cache
with a side prefix pool, the paged one over a bf16 / f32 or int8 pool
(``SWARMDB_KV_DTYPE``). Not ported yet (ROADMAP.md, queue 1): rolling KV
and the tiered state hierarchy, ``n > 1`` fan-out, the lane supervisor,
partition locality and SSE streaming.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.messages import Message, MessageType
from ..core.runtime import SwarmDB
from ..models import llama
from ..models.configs import ModelConfig, get_config
from ..ops.paged_kv import PageAllocator, pages_per_slot
from ..utils.device import DeviceLike, resolve_device
from ..utils.sync import make_lock
from .engine import Engine, GenRequest, PagedKV, _env_float, _env_int
from .sampling import SamplingParams
from .tokenizer import Tokenizer, default_tokenizer

logger = logging.getLogger("swarmdb_tpu_torch.serving")


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
) -> Tuple[Engine, Tokenizer]:
    """One Engine for a registry config, on ``device`` (the card by
    default). Weights are random bf16 from ``seed`` unless ``params`` (the
    port's dict layout, on ``device``) are given. Decode is chunked
    unless ``SWARMDB_CHUNKED=0``.

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
      (``SWARMDB_PREFIX_TOKENS``) unless ``kv_pool_tokens`` bounds it."""
    cfg = (model_name_or_cfg if isinstance(model_name_or_cfg, ModelConfig)
           else get_config(model_name_or_cfg))
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name!r} is a MoE config: Mixtral serving is the Mixtral "
            "slice of the port (ROADMAP.md, queue 1)")
    if paged is None:
        paged = os.environ.get("SWARMDB_PAGED", "0") == "1"
    dev = resolve_device(device)
    seq = max_seq or min(cfg.max_seq_len, 1024)
    prefix_enabled = (os.environ.get("SWARMDB_PREFIX", "1") != "0"
                      and seq % page_size == 0)
    if params is None:
        params = llama.init_params(cfg, seed=seed, device=dev)
    tokenizer = default_tokenizer(cfg.vocab_size, tokenizer_path)
    if not paged:
        engine = _dense_engine(cfg, params, dev, tokenizer, kv_dtype,
                               prefix_enabled, max_batch=max_batch,
                               max_seq=seq, seed=seed, metrics=metrics,
                               decode_chunk=decode_chunk,
                               prefill_batch=prefill_batch,
                               page_size=page_size)
        return engine, tokenizer
    maxp = pages_per_slot(seq, page_size)
    if kv_pool_tokens is None and "SWARMDB_KV_POOL_TOKENS" in os.environ:
        kv_pool_tokens = int(os.environ["SWARMDB_KV_POOL_TOKENS"])
    pool_tokens = kv_pool_tokens or max_batch * maxp * page_size
    if kv_pool_tokens is None and prefix_enabled:
        pool_tokens += _env_int("SWARMDB_PREFIX_TOKENS", max_batch * seq // 2)
    num_pages = 1 + -(-pool_tokens // page_size)  # +1 trash page
    paged_spec = PagedKV(
        init_pool=lambda: llama.init_paged_cache(
            cfg, max_batch, seq, num_pages, page_size, dtype=kv_dtype,
            device=dev),
        page_size=page_size,
        num_pages=num_pages,
        allocator=PageAllocator(num_pages, page_size, seq, max_batch),
        prefill_ragged=lambda p, toks, trow, tpos, tables, st, ln, pl, pk, pv:
            llama.forward_ragged_prefill(p, cfg, toks, trow, tpos, tables,
                                         st, ln, pl, pk, pv),
        decode_forward=lambda p, t, pos, c: llama.forward_paged(
            p, cfg, t, pos, c),
    )
    # two-segment chunked decode (the pool frozen per chunk, one merge);
    # SWARMDB_CHUNKED=0 decodes one step at a time through decode_forward
    # (admission stays on the ragged prefill either way)
    chunked_fns = None
    if os.environ.get("SWARMDB_CHUNKED", "1") != "0":
        chunked_fns = (
            lambda p, t, pos, c, hkv, s: llama.forward_paged_chunked(
                p, cfg, t, pos, c, hkv, s),
            lambda b, k: llama.init_chunk_kv(cfg, b, k, device=dev),
            llama.merge_paged_chunk,
        )
    engine = Engine(
        params, paged=paged_spec, chunked_fns=chunked_fns,
        max_batch=max_batch, max_seq=seq, eos_id=tokenizer.eos_id,
        pad_id=tokenizer.pad_id, seed=seed, metrics=metrics,
        decode_chunk=decode_chunk, prefill_batch=prefill_batch,
        prefix_cache=prefix_enabled, device=dev)
    return engine, tokenizer


def _dense_engine(cfg: ModelConfig, params: Dict[str, Any],
                  dev: torch.device, tokenizer: Tokenizer,
                  kv_dtype: Optional[torch.dtype], prefix_enabled: bool, *,
                  max_batch: int, max_seq: int, seed: int, metrics,
                  decode_chunk: int, prefill_batch: Optional[int],
                  page_size: int) -> Engine:
    """The dense engine's wiring (``swarmdb_tpu/backend/service.py``'s
    dense branch of ``build_backend_engine``)."""
    dtype = kv_dtype or torch.bfloat16
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the dense slot cache is bfloat16 or float32, "
                         f"not {dtype} (int8 KV is paged-only)")
    chunked_fns = None
    if os.environ.get("SWARMDB_CHUNKED", "1") != "0":
        chunked_fns = (
            lambda p, t, pos, c, hkv, s: llama.forward_chunked(
                p, cfg, t, pos, c, hkv, s),
            lambda b, k: llama.init_chunk_kv(cfg, b, k, device=dev),
            llama.merge_chunk,
        )
    prefix_fns, prefix_pages = None, 0
    if prefix_enabled:
        prefix_tokens = _env_int("SWARMDB_PREFIX_TOKENS",
                                 max_batch * max_seq // 2)
        prefix_pages = 1 + -(-prefix_tokens // page_size)  # +1 trash page
        prefix_fns = (
            lambda p, t, tab, pl, pk, pv, lp, logits_at=None:
                llama.forward_prefix_lane(p, cfg, t, tab, pl, pk, pv, lp,
                                          logits_at=logits_at),
            lambda n, ps: llama.init_prefix_pool(cfg, n, ps, dtype=dtype,
                                                 device=dev),
        )
    return Engine(
        params,
        forward_fn=lambda p, t, pos, c, logits_at=None: llama.forward(
            p, cfg, t, pos, c, logits_at=logits_at),
        init_cache_fn=lambda b, s: llama.init_kv_cache(cfg, b, s,
                                                       dtype=dtype,
                                                       device=dev),
        chunked_fns=chunked_fns, prefix_fns=prefix_fns,
        prefix_pages=prefix_pages, prefix_page_size=page_size,
        max_batch=max_batch, max_seq=max_seq, eos_id=tokenizer.eos_id,
        pad_id=tokenizer.pad_id, seed=seed, metrics=metrics,
        decode_chunk=decode_chunk, prefill_batch=prefill_batch, device=dev)


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
        self._stop = threading.Event()
        self._consumer_thread: Optional[threading.Thread] = None
        # reply emission (decode + send_message) runs on its own worker,
        # never on the engine thread
        self._reply_queue: "queue.Queue" = queue.Queue()
        self._reply_thread: Optional[threading.Thread] = None
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
        card unless ``device="cpu"``); weights are random from ``seed``."""
        engine, tokenizer = build_backend_engine(
            model_name, max_batch=max_batch, max_seq=max_seq, seed=seed,
            decode_chunk=decode_chunk, paged=paged, page_size=page_size,
            kv_pool_tokens=kv_pool_tokens, prefill_batch=prefill_batch,
            metrics=db.metrics, tokenizer_path=tokenizer_path,
            device=device)
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
        self.engine.stop()
        if self._reply_thread is not None:
            self._reply_queue.put(None)  # after the engine drained
            self._reply_thread.join(timeout=10)
            self._reply_thread = None

    # --------------------------------------------------- broker consumption

    def _consume_loop(self) -> None:
        """Poll the inboxes of this backend's agents and serve new chat /
        function_call messages; restart a dead engine loop."""
        while not self._stop.is_set():
            if not self.engine.alive():
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
        completion. Returns the engine request id."""
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
        budget = min(max(16, self.engine.max_seq - 1
                         - sampling.max_new_tokens), self.engine.max_seq - 1)
        if len(prompt) > budget:
            prompt = self._trim_prompt(msg, prompt, budget)

        def _done(rid: str, tokens: List[int], reason: str) -> None:
            # engine thread: hand off, emission runs on _reply_loop
            msg.stage_stamp("done")
            lps = (list(req.metadata.get("logprobs", []))
                   if want_logprobs else None)
            self._reply_queue.put((msg, rid, tokens, reason, sampling.stop,
                                   lps, on_done))

        # stop-sequence watch: a bounded tail of decoded text; the engine
        # request is cancelled at the first match (at most one chunk of
        # extra tokens, truncated at emission)
        stop_tail: List[int] = []
        stop_window = 4 * max((len(s) for s in sampling.stop), default=0) + 8
        stop_hit = [False]

        def _tok(rid: str, token: int) -> None:
            if "first_token" not in msg.metadata.get("stages", {}):
                msg.stage_stamp("first_token")
                stages = msg.metadata["stages"]
                if "enqueued" in stages:
                    ttft = stages["first_token"] - stages["enqueued"]
                    self.db.metrics.latencies[
                        "send_to_first_token_s"].observe(ttft)
            if sampling.stop and not stop_hit[0]:
                stop_tail.append(token)
                del stop_tail[:-stop_window]
                text = self.tokenizer.decode(stop_tail)
                if any(s in text for s in sampling.stop):
                    stop_hit[0] = True
                    self.engine.cancel(rid)
            if on_token is not None:
                on_token(rid, token)

        req = GenRequest(prompt=prompt, sampling=sampling, priority=priority,
                         on_token=_tok, on_done=_done,
                         metadata={"message_id": msg.id})
        return self.engine.submit(req)

    def cancel_request(self, rid: str) -> None:
        self.engine.cancel(rid)

    def _reply_loop(self) -> None:
        """Drain completed generations into reply messages."""
        while True:
            item = self._reply_queue.get()
            if item is None:
                return
            msg, rid, tokens, reason, stop, lps, on_done = item
            try:
                self._emit_reply(msg, tokens, reason, stop, lps)
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
                    logprobs: Optional[List[float]] = None) -> None:
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

    # --------------------------------------------------------------- health

    def health(self) -> Dict[str, Any]:
        """Device liveness probe: a tiny op on the engine's device, then
        the engine's state."""
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
        }
