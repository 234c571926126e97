"""The system under test and the measured window.

The only module of the benchmark that imports the program. It builds what
an agent framework runs in process: one ``SwarmDB`` on the broker the
configuration names, one ``ServingService`` over one paged engine of the
configuration's sizes holding the benchmark's seeded weights, and the
assistants assigned to it. Agents then send through
``SwarmDB.send_message`` and receive their replies as messages through
``SwarmDB.receive_messages``, in closed loops, from one thread.

The service is the program's own, subclassed only to hear each generation:
when its consumer serves a message it calls ``serve_message`` without
callbacks, and the subclass passes the benchmark's token listener and
reply notice through that method's own ``on_token`` / ``on_done``. So
nothing polls for the service to take a message.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from swarmdb_tpu_torch.backend.service import (ServingService,
                                               build_backend_engine)
from swarmdb_tpu_torch.core.messages import BrokerConfig, MessageType
from swarmdb_tpu_torch.core.runtime import SwarmDB
from swarmdb_tpu_torch.models.configs import ModelConfig
from swarmdb_tpu_torch.obs import TRACER

from . import weights
from .devtrace import DeviceTrace, TraceSummary
from .reference import TOKENIZER, render_prompt
from .traffic import Session, Traffic

#: Seconds a run waits after the window for the replies still due.
DRAIN_S = 60.0
#: A reply the service has sent that is not in its agent's inbox yet is
#: looked for again after this long (the runtime delivers it on send, so
#: this is the rare case)
RETRY_S = 0.005
#: The traced stretch: traffic for LEAD_S seconds, then TRACE_S profiled.
LEAD_S = 15.0
TRACE_S = 3.0
#: The engine counters the per-layer metrics read as window deltas.
COUNTERS = ("phase_us_queue_wait", "engine_admitted", "prefix_reused_tokens",
            "prompt_tokens", "phase_us_decode", "engine_decode_chunks",
            "phase_us_host_sync", "tokens_generated")


def model_config(name: str, conf: Dict[str, Any]) -> ModelConfig:
    d = weights.Dims.of(conf)
    return ModelConfig(
        name=name, vocab_size=d.vocab, dim=d.hidden, n_layers=d.layers,
        n_heads=d.heads, n_kv_heads=d.kv_heads, ffn_dim=d.ffn,
        norm_eps=d.eps, rope_theta=d.theta,
        max_seq_len=int(conf["max_position_embeddings"]),
        n_experts=d.experts, experts_per_token=d.top_k or 2,
        sliding_window=d.window)


class _Heard:
    """What the benchmark's listener heard of one generation."""

    __slots__ = ("times",)

    def __init__(self) -> None:
        self.times: List[float] = []


class ObservedService(ServingService):
    """The program's service; the generations its own consumer starts
    carry the benchmark's listener (see the module's docstring)."""

    def serve_message(self, msg, on_token=None, on_done=None) -> str:
        if on_token is None and on_done is None:
            heard = self.heard.setdefault(msg.id, _Heard())
            times, replied, mid = heard.times, self.replied, msg.id
            on_token = lambda rid, tok: times.append(time.time())  # noqa
            on_done = lambda rid, toks, reason: replied.put(mid)  # noqa
        return super().serve_message(msg, on_token, on_done)


class System:
    """SwarmDB, the serving service and its engine, built and started."""

    def __init__(self, name: str, conf: Dict[str, Any], seed: int,
                 device: torch.device, run_dir: str) -> None:
        eng, rt = conf["engine"], conf["runtime"]
        self.dims = weights.Dims.of(conf)
        self.db = SwarmDB(
            BrokerConfig(implementation=rt["broker"],
                         num_partitions=int(rt["num_partitions"])),
            save_dir=os.path.join(run_dir, "history"),
            autosave_interval=1e9)
        params = weights.draw(self.dims, seed, device)
        engine, tok = build_backend_engine(
            model_config(name, conf), max_batch=int(eng["max_batch"]),
            max_seq=int(eng["max_seq"]), seed=seed,
            decode_chunk=int(eng["decode_chunk"]), paged=True,
            page_size=int(eng["page_size"]), kv_dtype=torch.bfloat16,
            params=params, metrics=self.db.metrics, device=device,
            flight_dir=os.path.join(run_dir, "flight"))
        self.max_seq = int(eng["max_seq"])
        self.engine = engine
        self.svc = ObservedService(self.db, engine, tok, backend_id="gpu-0")
        self.svc.heard = {}
        self.svc.replied = queue.Queue()
        self.svc.start(warmup=False)
        # K and V of one token over every layer, in bytes
        d = self.dims
        self.page_bytes = (int(eng["page_size"]) * d.layers * 2 * d.kv_heads
                           * d.head_dim * 2)

    def assistants(self, n: int) -> None:
        for j in range(n):
            self.db.register_agent(f"assistant-{j}")
            self.db.assign_llm_backend(f"assistant-{j}", "gpu-0")

    def counters(self) -> Dict[str, float]:
        c = self.db.metrics.counters
        return {k: float(c[k].value) for k in COUNTERS}

    def pool_pages(self) -> int:
        """Pages of the engine's KV pool (the trash page left out)."""
        return self.engine.paged.num_pages - 1

    def pages_held(self) -> int:
        """Pages of the pool that are not free."""
        return self.pool_pages() - self.engine.paged.allocator.free_count()

    def pages_evictable(self) -> int:
        """Held pages the prefix cache could give back now (a count over
        its entries: read at a new peak only)."""
        pre = self.engine._prefix
        return pre.evictable_count() if pre is not None else 0

    def served(self, message_id: str) -> Optional[Tuple[List[int], str]]:
        """The tokens and finish reason the service generated for a
        message it finished: its ``serve_message`` attaches to a finished
        generation and hands them over at once."""
        msg = self.db.get_message(message_id)
        if msg is None or "done" not in msg.metadata.get("stages", {}):
            return None
        out: List[Tuple[List[int], str]] = []
        ready = threading.Event()

        def done(rid: str, toks: List[int], reason: str) -> None:
            out.append((list(toks), reason))
            ready.set()

        self.svc.serve_message(msg, on_done=done)
        ready.wait(10.0)
        return out[0] if out else None

    def close(self) -> None:
        self.svc.stop()
        self.db.close()
        self.svc = None
        self.db = None


@dataclass
class Req:
    """One message an agent sent, and what came back."""

    mid: str
    turn: int
    sender: str
    receiver: str
    prompt: List[int]            # rendered by the benchmark
    prev: Optional["Req"]        # the session's previous message
    t_send: float
    in_window: bool
    stored: Any = None           # the runtime's copy of the message
    t_recv: Optional[float] = None
    reply_text: Optional[str] = None
    reply_meta: Dict[str, Any] = field(default_factory=dict)
    stamps: Dict[str, float] = field(default_factory=dict)
    served: Optional[List[int]] = None
    reason: Optional[str] = None
    # when each served token reached the benchmark's listener
    tok_times: Optional[List[float]] = None

    @property
    def generated(self) -> int:
        """Tokens the model produced: the served ones and an ending eos."""
        if self.served is None:
            return 0
        return len(self.served) + (1 if self.reason == "eos" else 0)

    def checked_tokens(self) -> List[int]:
        return list(self.served or []) + (
            [TOKENIZER.eos_id] if self.reason == "eos" else [])


class _Agent:
    def __init__(self, start: float) -> None:
        self.next_at = start
        self.session: Optional[Session] = None
        self.turn = 0
        self.history: List[Tuple[str, str]] = []
        self.last: Optional[Req] = None
        self.waiting: Optional[Req] = None


@dataclass
class Window:
    requests: List[Req]
    t0: float
    t1: float
    counters: Dict[str, float]
    misdelivered: int
    trace: Optional[TraceSummary] = None
    # the most KV pool pages held at any reply, with the prefix cache's
    # evictable ones among them then
    pages_peak: Tuple[int, int] = (0, 0)


def drive(system: System, traffic: Traffic, mix: Dict[str, Any],
          t0: float, seconds: float, *, reply_tokens: Optional[int] = None,
          tracer: Optional[DeviceTrace] = None) -> Window:
    """Closed loops of ``mix["agents"]`` agents from ``t0`` for
    ``seconds``: every message sent before the window closes is awaited
    (up to ``DRAIN_S`` more) and recorded. ``reply_tokens`` overrides every
    reply's ``max_new_tokens`` (the warm-up burst sends one message per
    agent with it). With a ``tracer`` (prepared while the engine was idle)
    the last ``TRACE_S`` seconds are its profiled interval.

    The loop sleeps until an agent is due or a reply has been sent: each
    generation's ``on_done`` posts its message, and its agent then
    receives the reply from the runtime."""
    db = system.db
    n = int(mix["agents"])
    spread = float(mix.get("start_spread_s", 0.0))
    cap = int(mix["max_prompt_tokens"])
    agents = [_Agent(t0 + i * spread / n) for i in range(n)]
    t1 = t0 + seconds
    reqs: List[Req] = []
    by_mid: Dict[str, _Agent] = {}
    misdelivered = 0
    tr_state = 0
    before = system.counters()
    after: Optional[Dict[str, float]] = None
    one_each = reply_tokens is not None
    replied = system.svc.replied
    to_receive: List[_Agent] = []   # replied; not in the inbox yet
    peak = (0, 0)

    def send(a: _Agent) -> None:
        while True:
            if a.session is None or a.turn >= len(a.session.lengths):
                a.session = traffic.next_session()
                a.turn, a.history, a.last = 0, [], None
            s = a.session
            max_new = reply_tokens or s.replies[a.turn]
            prompt = render_prompt(a.history, s.kind, s.sender, s.receiver,
                                   s.texts[a.turn])
            if (len(prompt) <= min(cap, system.max_seq - 1 - max_new)
                    or a.turn == 0):
                break
            a.session = None  # too long to go on: a new session
        t_send = time.time()
        mid = db.send_message(
            s.sender, s.receiver, s.texts[a.turn],
            message_type=(MessageType.FUNCTION_CALL
                          if s.kind == "function_call" else MessageType.CHAT),
            metadata={"generation": {"max_new_tokens": max_new,
                                     "temperature": 0.0}})
        r = Req(mid=mid, turn=a.turn, sender=s.sender, receiver=s.receiver,
                prompt=prompt, prev=a.last, t_send=t_send,
                in_window=t_send < t1, stored=db.get_message(mid))
        reqs.append(r)
        a.waiting = r
        by_mid[mid] = a

    def receive(a: _Agent) -> bool:
        nonlocal misdelivered
        r = a.waiting
        got = db.receive_messages(r.sender, max_messages=4, timeout=0)
        t_recv = time.time()
        for m in got:
            if m.metadata.get("reply_to") != r.mid or \
                    m.sender_id != r.receiver or a.waiting is None:
                misdelivered += 1
                continue
            r.t_recv = t_recv
            r.reply_text = (m.content if isinstance(m.content, str)
                            else str(m.content))
            r.reply_meta = dict(m.metadata)
            a.history += [(r.sender, a.session.texts[r.turn]),
                          (r.receiver, r.reply_text)]
            a.turn += 1
            a.last, a.waiting = r, None
            a.next_at = t_recv
            by_mid.pop(r.mid, None)
        return a.waiting is None

    while True:
        now = time.time()
        if tracer is not None and not tr_state and now >= t1 - TRACE_S:
            tracer.begin()
            tr_state = 1
        if after is None and now >= t1:
            after = system.counters()
            if tr_state == 1:
                tracer.end(TRACER.snapshot())
                tr_state = 2
        held = system.pages_held()
        if held > peak[0]:
            peak = (held, system.pages_evictable())
        to_receive = [a for a in to_receive if not receive(a)]
        wake = t1 if now < t1 else now + 0.05
        for a in agents:
            if a.waiting is not None or (one_each and a.last) or now >= t1:
                continue
            if now >= a.next_at:
                send(a)
            else:
                wake = min(wake, a.next_at)
        if tracer is not None and not tr_state:
            wake = min(wake, t1 - TRACE_S)
        if now >= t1 and all(a.waiting is None for a in agents):
            break
        if now >= t1 + DRAIN_S:
            break
        if to_receive:
            wake = min(wake, now + RETRY_S)
        try:
            mid = replied.get(timeout=max(0.0, wake - time.time()))
            while True:
                a = by_mid.get(mid)
                if a is not None:
                    to_receive.append(a)
                mid = replied.get_nowait()
        except queue.Empty:
            pass
    if after is None:
        after = system.counters()
    summary = tracer.finish() if tracer is not None else None
    for r in reqs:
        r.stamps = dict(r.stored.metadata.get("stages", {}))
        heard = system.svc.heard.pop(r.mid, None)
        r.tok_times = heard.times if heard is not None else []
        got = system.served(r.mid)
        if got is not None:
            r.served, r.reason = got
        r.stored = None
    return Window(requests=reqs, t0=t0, t1=t1,
                  counters={k: after[k] - before[k] for k in COUNTERS},
                  misdelivered=misdelivered, trace=summary, pages_peak=peak)
