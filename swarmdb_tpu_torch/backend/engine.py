"""Continuous-batching generation engine: the single-lane paged and
dense paths.

The counterpart of ``swarmdb_tpu/backend/engine.py`` for its two
single-lane serving paths, the paged pool (``paged=PagedKV(...)``) and the
dense slot cache (``paged=None``, the JAX package's default):

- ``max_batch`` slots, each holding one in-flight sequence with its own
  absolute position, sampling params and random key. Inactive slots run
  masked garbage the host ignores (their table rows are all trash page 0;
  a dense slot's lane is rewritten by its next prefill).
- Admission is priority-ordered. Paged: each round allocates pages for
  the admitted requests (reusing prefix-cache pages in place), then packs
  their prompts into ragged waves: one token stream per wave, rows back to
  back, widths off a power-of-two ladder (``SWARMDB_RAGGED_MIN_WIDTH``,
  default 8), a row longer than the wave's room split across waves.
  Dense: prompts of at least one page go through the prefix path (a side
  page pool, ``PrefixLRU`` with its own free list) even on a full miss,
  so that their pages are registered: one fused suffix prefill per round
  over the reused pages, padded to the round's (suffix bucket, prefix
  width), its lanes inserted into the slots; shorter prompts prefill in
  one bucketed wave per bucket (``Engine.prefill_buckets``), padded to
  ``prefill_batch`` rows, inserted at ``cache[:, slot, :bucket]``. Either
  way the sampled first token lands in the device-resident fed-token
  vector and reaches the host as row 0 of the next decode block.
- Decode is a host loop over chunks: ``decode_chunk`` steps of the chunk
  forward + sampling with the cache frozen, then one merge into the cache
  (``merge_paged_chunk`` / ``merge_chunk``), then ONE host read of the
  [K+1, B] token block. Without ``chunked_fns`` (``SWARMDB_CHUNKED=0``)
  a chunk is K single steps (``PagedKV.decode_forward``, or the dense
  ``forward_fn`` at T == 1), each writing its token into the cache before
  attending, and still one host read. The JAX package's device-resident
  while-loop with its emission ring, CUDA graphs, lanes, rolling KV and
  the paged bucketed prefills are later slices of the port (ROADMAP.md).

All tensors live on the engine's explicit ``device``; the worker thread
sets it as its current CUDA device.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.paged_kv import (PageAllocator, paged_write_ragged,
                             set_page_table_rows)
from ..ops.prefix_cache import PrefixLRU, page_chains
from ..utils.device import DeviceLike, resolve_device
from ..utils.metrics import MetricsRegistry
from ..utils.sync import make_condition
from .sampling import (SamplingParams, key_from_seed, make_slot_keys,
                       sample_tokens, token_logprob)

logger = logging.getLogger("swarmdb_tpu_torch.engine")


@dataclass
class GenRequest:
    prompt: List[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    priority: int = 1
    request_id: str = field(default_factory=lambda: str(uuid.uuid4()))
    # on_token(request_id, token_id) fires per sampled token (engine thread)
    on_token: Optional[Callable[[str, int], None]] = None
    # on_done(request_id, token_ids, finish_reason)
    on_done: Optional[Callable[[str, List[int], str], None]] = None
    submitted_at: float = field(default_factory=time.time)
    metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class _Slot:
    active: bool = False
    request: Optional[GenRequest] = None
    position: int = 0           # next absolute position to write
    generated: List[int] = field(default_factory=list)
    logprobs: List[float] = field(default_factory=list)
    pending_first: bool = False  # prefill token not yet surfaced to host
    cancelled: bool = False      # retire at the next processed block
    first_token_at: Optional[float] = None


@dataclass
class PagedKV:
    """Paged-pool wiring: ``init_pool`` builds the {"k","v","page_table"}
    dict (plain or int8 pools), the host-side ``allocator`` hands out
    pages (admission stalls while the pool cannot cover a request's
    worst-case footprint), ``prefill_ragged`` is the packed ragged prefill
    forward: (params, tokens[W], tok_row[W], tok_pos[W], row_tables[R,
    maxp], starts[R], lens[R], prefix_lens[R], k_pool, v_pool) -> ([R, V]
    last-token logits, sfx_k, sfx_v [L, W, Hkv, D]), and
    ``decode_forward`` the single-step decode used when the engine has no
    ``chunked_fns``: (params, tokens[B,1], positions[B,1], cache) ->
    (logits [B, 1, V], cache)."""

    init_pool: Callable[[], Dict[str, Any]]
    page_size: int
    num_pages: int
    allocator: PageAllocator
    prefill_ragged: Callable
    decode_forward: Optional[Callable] = None


class Engine:
    """Slot-based continuous batching over the paged pool or the dense
    slot cache."""

    def __init__(
        self,
        params: Any,
        *,
        paged: Optional[PagedKV] = None,
        chunked_fns: Optional[Tuple[Callable, Callable, Callable]] = None,
        forward_fn: Optional[Callable] = None,
        init_cache_fn: Optional[Callable] = None,
        prefix_fns: Optional[Tuple[Callable, Callable]] = None,
        prefix_pages: int = 0,
        prefix_page_size: int = 16,
        max_batch: int = 8,
        max_seq: int = 1024,
        eos_id: int = 2,
        pad_id: int = 0,
        seed: int = 0,
        metrics: Optional[MetricsRegistry] = None,
        decode_chunk: int = 8,
        prefill_batch: Optional[int] = None,
        prefix_cache: bool = True,
        device: DeviceLike = None,
    ) -> None:
        """``paged`` selects the paged pool (``prefix_cache`` then turns
        its prefix cache on); None the dense slot cache, which needs
        ``forward_fn(params, tokens[B,T], positions[B,T], cache,
        logits_at=None) -> (logits, cache)`` (its single-step decode, and
        with ``logits_at=last_idx[B]`` the prefill, whose head runs at each
        row's last token only: [B, V] logits) and ``init_cache_fn(batch,
        max_seq) -> cache`` (also the prefill's temp cache at (rows,
        bucket)), and takes ``prefix_fns`` = (lane_forward(params, tokens,
        table, prefix_lens, pool_k, pool_v, lane_pages, logits_at=) ->
        (logits, lane_k, lane_v), init_pool(num_pages, page_size) ->
        (pool_k, pool_v)) for a prefix cache over a side pool of
        ``prefix_pages`` pages. Its prefill buckets are a x4 ladder from 64
        at max_seq >= 512, else 16..256, topped by max_seq.

        ``chunked_fns`` = (chunk_forward(params, tokens[B,1],
        positions[B,1], cache, chunk_kv, step) -> (logits, chunk_kv),
        init_chunk(batch, K) -> chunk_kv, merge_chunk(cache, chunk_kv,
        start_positions) -> cache), or None: decode then runs
        ``paged.decode_forward`` (dense: ``forward_fn``) one step at a
        time."""
        if paged is None and None in (forward_fn, init_cache_fn):
            raise ValueError("a dense engine needs forward_fn and "
                             "init_cache_fn")
        self._decode_forward = (paged.decode_forward if paged is not None
                                else forward_fn)
        if chunked_fns is None and self._decode_forward is None:
            raise ValueError("an engine without chunked_fns needs "
                             "paged.decode_forward")
        self.device = resolve_device(device)
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.metrics = metrics or MetricsRegistry()
        self.decode_chunk = max(1, int(decode_chunk))
        self.prefill_batch = max(1, min(prefill_batch or 8, max_batch))
        self.paged = paged
        self._chunked_fns = chunked_fns
        self._init_cache_fn = init_cache_fn
        self.cache = self._new_cache()
        self._chunk_kv = (chunked_fns[1](max_batch, self.decode_chunk)
                          if chunked_fns is not None else None)
        self._aging_s = _env_float("SWARMDB_AGING_S", 5.0)

        # random keys: [B, 2] uint32 words per slot, host-side; a request
        # with an explicit seed rewrites its slot's row for its lifetime
        self._default_keys_np = make_slot_keys(seed, max_batch)
        self._base_keys_np = self._default_keys_np.copy()
        self._temp = np.zeros(max_batch, np.float32)
        self._topk = np.zeros(max_batch, np.int32)
        self._topp = np.ones(max_batch, np.float32)
        self.slots = [_Slot() for _ in range(max_batch)]
        # device-resident fed tokens (+ their raw logprobs): slot i's next
        # input token lives here between chunks. Entry max_batch is a
        # write sink for prefill rows whose sample is discarded, so the
        # scatter needs no mask (and no host sync)
        self._last_tokens = torch.zeros(max_batch + 1, dtype=torch.int32,
                                        device=self.device)
        self._last_lps = torch.zeros(max_batch + 1, dtype=torch.float32,
                                     device=self.device)

        # ragged wave width ladder: largest rung <= the pending tokens
        min_w = _env_int("SWARMDB_RAGGED_MIN_WIDTH", 8)
        ladder = [max(1, min(min_w, max_seq))]
        while ladder[-1] < max_seq:
            ladder.append(min(max_seq, ladder[-1] * 2))
        self._ragged_widths = ladder

        # pool-watermark backpressure over non-reclaimable utilisation
        self._bp_high = _env_float("SWARMDB_POOL_HIGH", 0.92)
        self._bp_low = min(_env_float("SWARMDB_POOL_LOW", 0.80),
                           self._bp_high)
        self._bp_shed = max(_env_float("SWARMDB_POOL_SHED", 0.98),
                            self._bp_high)
        self._bp_paused = False

        # dense prefill buckets: one wave shape per bucket (x4 growth in
        # long context, where padding is bounded by the prefix cache)
        self._long_context = max_seq >= 512
        ladder = ((64, 256, 1024, 4096) if self._long_context
                  else (16, 32, 64, 128, 256))
        self.prefill_buckets = [b for b in ladder if b <= max_seq]
        # the top bucket holds the longest admissible prompt (max_seq - 1)
        if (not self.prefill_buckets
                or self.prefill_buckets[-1] < max_seq - 1):
            self.prefill_buckets.append(max_seq)

        # prefix cache. Paged: hit pages are pinned and referenced in
        # place by the slot's table row; a prompt's freshly written full
        # pages move into cache custody at registration. Dense: a side
        # pool with its own free list; hits are matched without pinning
        # (their content is copied into the slot's lane by the same
        # prefill that reads them) and a prompt's full pages are copied
        # out of its lane into acquired pages
        self._prefix: Optional[PrefixLRU] = None
        self._slot_prefix_pins: Dict[int, List[int]] = {}
        self._prefix_ps = paged.page_size if paged else prefix_page_size
        if paged is not None and prefix_cache:
            if max_seq % paged.page_size:
                raise ValueError("max_seq must be a page-size multiple for "
                                 "prefix caching")
            self._prefix = PrefixLRU(paged.num_pages, paged.page_size,
                                     manage_free=False)
            maxp = paged.allocator.maxp
            self._prefix_max_pages = max(1, maxp - 1)
        elif paged is None and prefix_fns is not None:
            if max_seq % prefix_page_size:
                raise ValueError("max_seq must be a page-size multiple for "
                                 "prefix caching")
            self._prefix_lane_fwd, self._prefix_init_pool = prefix_fns
            self._prefix_num_pages = max(2, prefix_pages)
            self._prefix = PrefixLRU(self._prefix_num_pages,
                                     prefix_page_size)
            self._prefix_pool = self._prefix_init_pool(
                self._prefix_num_pages, prefix_page_size)
            self._prefix_pp_buckets = self._pp_widths(
                max_seq // prefix_page_size)
            self._prefix_max_pages = self._prefix_pp_buckets[-1]

        self._queue: List[Tuple[int, float, int, GenRequest]] = []  # heap
        self._admitting: set = set()
        self._cancel_pending: set = set()
        self._tiebreak = itertools.count()
        self._cv = make_condition("backend.engine.Engine._cv")
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.total_generated = 0
        self.total_requests = 0

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        with self._cv:
            self._stop = False
        # the CPU intra-op thread count is per thread: the worker takes the
        # starting thread's (torch.set_num_threads there) instead of one
        # thread per core
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        args=(torch.get_num_threads(),),
                                        name="swarmdb-torch-engine")
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None

    def alive(self) -> bool:
        """True while the decode loop thread is running."""
        return self._thread is not None and self._thread.is_alive()

    def restart(self) -> None:
        """Stop the loop, fail every request, rebuild the pool and slot
        state, start again (the serving layer's watchdog)."""
        self.stop()
        self._fail_all("engine_restart")
        self._reset_state()
        self.metrics.counters["engine_restarts"].inc()
        self.start()

    def _new_cache(self):
        if self.paged is not None:
            return self.paged.init_pool()
        return self._init_cache_fn(self.max_batch, self.max_seq)

    def _reset_state(self) -> None:
        self.cache = self._new_cache()
        if self.paged is not None:
            self.paged.allocator.reset()
        if self._prefix is not None:
            self._prefix.reset()
            if self.paged is None:
                self._prefix_pool = self._prefix_init_pool(
                    self._prefix_num_pages, self._prefix_ps)
        self._slot_prefix_pins.clear()
        self._last_tokens.zero_()
        self._last_lps.zero_()

    # ------------------------------------------------------------ requests

    def submit(self, request: GenRequest) -> str:
        """Thread-safe enqueue; returns the request id."""
        if len(request.prompt) >= self.max_seq:
            raise ValueError(f"prompt length {len(request.prompt)} >= "
                             f"max_seq {self.max_seq}")
        if not request.prompt:
            raise ValueError("empty prompt")
        if self.paged is not None:
            alloc = self.paged.allocator
            need = alloc.pages_needed(len(request.prompt),
                                      request.sampling.max_new_tokens,
                                      self.decode_chunk)
            if need > alloc.slot_capacity():
                raise ValueError(f"request needs {need} KV pages but a slot "
                                 f"can hold at most {alloc.slot_capacity()}")
        with self._cv:
            heapq.heappush(self._queue, (-request.priority,
                                         request.submitted_at,
                                         next(self._tiebreak), request))
            self.metrics.counters["engine_requests"].inc()
            self._cv.notify_all()
        return request.request_id

    def cancel(self, request_id: str) -> bool:
        """Stop a request early. Queued requests are removed at once
        (on_done fires with "cancelled"); an active or admitting request
        retires at its next processed block. False for unknown ids."""
        with self._cv:
            for i, item in enumerate(self._queue):
                if item[3].request_id == request_id:
                    req = item[3]
                    del self._queue[i]
                    heapq.heapify(self._queue)
                    break
            else:
                req = None
            if req is None:
                found = request_id in self._admitting
                if found:
                    self._cancel_pending.add(request_id)
                for slot in self.slots:
                    if (slot.active and slot.request is not None
                            and slot.request.request_id == request_id):
                        slot.cancelled = found = True
                if found:
                    self.metrics.counters["engine_cancelled"].inc()
                return found
        self.metrics.counters["engine_cancelled"].inc()
        _call(req.on_done, req.request_id, [], "cancelled")
        return True

    def generate_sync(self, prompt: List[int], sampling: SamplingParams,
                      timeout: float = 120.0) -> Tuple[List[int], str]:
        """Blocking convenience API (tests, benches)."""
        done = threading.Event()
        result: Dict[str, Any] = {}

        def on_done(rid, toks, reason):
            result["tokens"], result["reason"] = toks, reason
            done.set()

        self.submit(GenRequest(prompt=prompt, sampling=sampling,
                               on_done=on_done))
        if not done.wait(timeout):
            raise TimeoutError("generation timed out")
        return result["tokens"], result["reason"]

    # ------------------------------------------------------------- the loop

    def _run(self, cpu_threads: int) -> None:
        torch.set_num_threads(cpu_threads)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.no_grad():
            while True:
                with self._cv:
                    while (not self._stop and not self._queue
                           and not self._any_active()):
                        self._cv.wait(timeout=0.25)
                    if self._stop:
                        return
                try:
                    self._admit()
                    if self._any_active():
                        self._process_block(*self._decode_chunk())
                except Exception:
                    logger.exception("engine step failed; failing active "
                                     "requests")
                    self._fail_all("engine_error")
                    try:
                        self._reset_state()
                    except Exception:
                        logger.exception("state rebuild failed; stopping")
                        with self._cv:
                            self._stop = True

    def _any_active(self) -> bool:
        return any(s.active for s in self.slots)

    # ------------------------------------------------------------- admission

    def _age_queue(self) -> None:
        """Anti-starvation: every SWARMDB_AGING_S seconds a queued request
        waits, it competes one priority class higher (recomputed from wait
        time; ``req.priority`` itself never changes)."""
        if self._aging_s <= 0:
            return
        now = time.time()
        with self._cv:
            changed = False
            for i, (negp, sub, tb, req) in enumerate(self._queue):
                boost = int((now - sub) / self._aging_s)
                eff = min(3, req.priority + boost)
                if boost > 0 and eff > -negp:
                    self._queue[i] = (-eff, sub, tb, req)
                    changed = True
            if changed:
                heapq.heapify(self._queue)
                self.metrics.counters["engine_priority_aged"].inc()

    def _pool_headroom(self) -> float:
        """Fraction of the pool still claimable: free pages plus unpinned
        prefix-cache pages."""
        free = self.paged.allocator.free_count()
        if self._prefix is not None:
            free += self._prefix.evictable_count()
        return min(1.0, free / max(1, self.paged.num_pages - 1))

    def _backpressure_gate(self) -> bool:
        """Watermark hysteresis over pool utilisation; True when admission
        may proceed. Past the shed watermark the lowest-priority queued
        class is returned with retryable reason "shed"."""
        if self._bp_high >= 1.0:
            return True
        util = 1.0 - self._pool_headroom()
        if self._bp_paused:
            if util <= self._bp_low:
                self._bp_paused = False
                self.metrics.counters["engine_admission_resumed"].inc()
                return True
        elif util >= self._bp_high:
            self._bp_paused = True
            self.metrics.counters["engine_admission_paused"].inc()
        if not self._bp_paused:
            return True
        if util >= self._bp_shed:
            self._shed_lowest()
        return False

    def _shed_lowest(self) -> None:
        shed: List[GenRequest] = []
        with self._cv:
            prios = {-negp for negp, _, _, _ in self._queue}
            if len(self._queue) < 2 or len(prios) < 2:
                return
            lowest = min(prios)
            keep = []
            for item in self._queue:
                (shed if -item[0] == lowest else keep).append(item)
            shed = [item[3] for item in shed]
            self._queue[:] = keep
            heapq.heapify(self._queue)
        for req in shed:
            self.metrics.counters["requests_shed"].inc()
            _call(req.on_done, req.request_id, [], "shed")

    def _admit(self) -> None:
        """Move queued requests into free slots (highest priority first),
        up to ``prefill_batch`` per round, and prefill them."""
        self._age_queue()
        if self.paged is None:
            self._admit_dense()
        else:
            self._admit_paged()

    def _admit_paged(self) -> None:
        """Paged admission rounds, prefilled in ragged waves. A request
        whose pages the pool cannot cover stops the round (no skip-ahead:
        long prompts do not starve behind short ones)."""
        alloc = self.paged.allocator
        # reclaim retired slots' pages: zero their table rows on device
        # first, then return the pages (a stale row never sees reuse)
        pending = alloc.take_pending_frees()
        if pending:
            try:
                set_page_table_rows(self.cache["page_table"], pending,
                                    np.zeros((len(pending), alloc.maxp),
                                             np.int32))
            except Exception:
                alloc.requeue_pending(pending)
                raise
            alloc.release_taken(pending)
        if not self._backpressure_gate():
            return
        while True:
            popped: List[GenRequest] = []
            rows: List[Tuple[int, np.ndarray]] = []
            plans: Dict[int, Tuple[List[int], Optional[List[bytes]]]] = {}
            with self._cv:
                free = [i for i, s in enumerate(self.slots) if not s.active]
                take = min(len(free), len(self._queue), self.prefill_batch)
                if take == 0:
                    return
                while free and self._queue and len(popped) < take:
                    req = self._queue[0][3]
                    slot_id = free[0]
                    need = alloc.pages_needed(len(req.prompt),
                                              req.sampling.max_new_tokens,
                                              self.decode_chunk)
                    hits: List[int] = []
                    chains: Optional[List[bytes]] = None
                    if (self._prefix is not None
                            and len(req.prompt) >= self._prefix_ps):
                        hits, chains = self._prefix_plan(req.prompt,
                                                         pin=True)
                    row = self._paged_allocate(slot_id, hits,
                                               max(0, need - len(hits)))
                    if row is None:
                        if hits:
                            self._prefix.unpin(hits)
                        break  # pool exhausted; retry after retirements
                    heapq.heappop(self._queue)
                    free.pop(0)
                    self._admitting.add(req.request_id)
                    popped.append(req)
                    rows.append((slot_id, row))
                    plans[slot_id] = (hits, chains)
            if not popped:
                return
            set_page_table_rows(self.cache["page_table"],
                                [r[0] for r in rows],
                                np.stack([r[1] for r in rows]))
            batch = [(sid, req) + plans[sid] + (row,)
                     for (sid, row), req in zip(rows, popped)]
            try:
                self._prefill_ragged_waves(batch)
            except Exception:
                # off the queue and not in slots: fail them here or their
                # on_done never fires
                logger.exception("prefill failed for %s",
                                 [b[1].request_id for b in batch])
                for slot_id, req, hits, _chains, _row in batch:
                    with self._cv:
                        self._admitting.discard(req.request_id)
                        self._cancel_pending.discard(req.request_id)
                    alloc.mark_retired(slot_id)
                    pins = self._slot_prefix_pins.pop(slot_id, None) or hits
                    if pins:
                        self._prefix.unpin(pins)
                    _call(req.on_done, req.request_id, [], "engine_error")

    def _prefix_plan(self, prompt: List[int], pin: bool
                     ) -> Tuple[List[int], List[bytes]]:
        """Longest cached prefix of ``prompt`` -> (hit page ids; chain
        hashes of every full prompt page). Hits stop one page short of a
        page-aligned prompt so at least one token is prefilled (the first
        sample needs logits), and at the widest prefix the path takes
        (paged: maxp - 1 pages; dense: the top gather-width bucket).
        ``pin`` (paged) pins the hits until the slot retires: its table
        row reads them in place. The dense path copies them into the lane
        in the same prefill, so it must not pin: nothing would unpin."""
        ps = self._prefix_ps
        n_full = len(prompt) // ps
        chains = page_chains(prompt, ps, max_pages=n_full)
        cap = n_full - 1 if n_full * ps == len(prompt) else n_full
        cap = min(cap, self._prefix_max_pages)
        if cap <= 0:
            return [], chains
        if pin:
            return self._prefix.match_and_pin(chains[:cap], prompt), chains
        return self._prefix.match(chains[:cap], prompt), chains

    def _paged_allocate(self, slot_id: int, hits: List[int],
                        n_fresh: int) -> Optional[np.ndarray]:
        """A slot's table row = pinned hit pages + fresh pages, evicting
        LRU prefix-cache pages into the free list when the pool runs
        short. None if still uncoverable."""
        alloc = self.paged.allocator
        if self._prefix is not None:
            shortfall = n_fresh - alloc.free_count()
            if shortfall > 0:
                evicted = self._prefix.evict_lru(shortfall)
                if evicted:
                    alloc.add_free(evicted)
        return alloc.allocate_with_prefix(slot_id, hits, n_fresh)

    def _ragged_width_for(self, n: int) -> int:
        """Largest ladder width <= ``n`` (waves are exactly full until the
        remainder drops below the smallest rung)."""
        for w in reversed(self._ragged_widths):
            if w <= n:
                return w
        return self._ragged_widths[0]

    def _set_slot_key(self, slot_id: int, seed) -> None:
        self._base_keys_np[slot_id] = (self._default_keys_np[slot_id]
                                       if seed is None else key_from_seed(seed))

    def _set_slot_sampling(self, slot_id: int, s: SamplingParams) -> None:
        """A slot's sampling params, set before its prefill samples the
        first token (or it would inherit the previous occupant's)."""
        self._temp[slot_id] = s.temperature
        self._topk[slot_id] = s.top_k
        self._topp[slot_id] = s.top_p
        self._set_slot_key(slot_id, s.seed)

    def _sample_into_slots(self, logits: torch.Tensor, gather: np.ndarray,
                           fold_pos: torch.Tensor, scatter: np.ndarray
                           ) -> None:
        """Sample each wave row's first token from its [R, V] logits with
        its slot's (``gather``) params and key folded at ``fold_pos`` (the
        absolute position of its last prompt token, so a cached prefix
        samples as a full prefill would), then scatter token and logprob
        into the fed-token vectors at ``scatter`` (``max_batch`` = the
        sink: rows that do not sample, padding)."""
        nxt = sample_tokens(
            logits, self._tensor(self._base_keys_np[gather].astype(np.int64)),
            fold_pos, self._tensor(self._temp[gather]),
            self._tensor(self._topk[gather]),
            self._tensor(self._topp[gather]))
        lp = token_logprob(logits, nxt)
        scatter_t = self._tensor(scatter.astype(np.int64))
        self._last_tokens.index_copy_(0, scatter_t, nxt)
        self._last_lps.index_copy_(0, scatter_t, lp)

    # ------------------------------------------------------ dense admission

    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    def _pp_widths(self, maxp: int) -> List[int]:
        """Prefix gather-width buckets (pages): {maxp/4, maxp/2, maxp-1},
        the quarter width dropped in long context."""
        widths = ({maxp // 2, maxp - 1} if self._long_context
                  else {maxp // 4, maxp // 2, maxp - 1})
        return sorted({max(1, w) for w in widths})

    def _pp_bucket_for(self, n: int) -> int:
        """Smallest prefix gather-width bucket covering ``n`` hit pages."""
        for b in self._prefix_pp_buckets:
            if n <= b:
                return b
        return self._prefix_pp_buckets[-1]

    def _admit_dense(self) -> None:
        """Dense admission rounds of up to ``prefill_batch`` requests into
        free slots. Prompts of at least one page take the prefix path even
        on a full miss, so that their pages are registered for the next
        turn: ONE fused suffix prefill per round, padded to the round's
        largest (suffix bucket, prefix width); shorter prompts prefill in
        one bucketed wave per bucket."""
        ps = self._prefix_ps
        while True:
            with self._cv:
                free = [i for i, s in enumerate(self.slots) if not s.active]
                take = min(len(free), len(self._queue), self.prefill_batch)
                if take == 0:
                    return
                popped = [heapq.heappop(self._queue)[3] for _ in range(take)]
                self._admitting.update(r.request_id for r in popped)
            groups: Dict[Any, List[Tuple]] = {}
            prefix_batch: List[Tuple] = []
            max_suffix = max_hits = 0
            for slot_id, req in zip(free, popped):
                if self._prefix is not None and len(req.prompt) >= ps:
                    hits, chains = self._prefix_plan(req.prompt, pin=False)
                    prefix_batch.append((slot_id, req, hits, chains))
                    max_suffix = max(max_suffix,
                                     len(req.prompt) - len(hits) * ps)
                    max_hits = max(max_hits, len(hits))
                else:
                    groups.setdefault(self._bucket_for(len(req.prompt)),
                                      []).append((slot_id, req))
            if prefix_batch:
                groups[("prefix", self._bucket_for(max(1, max_suffix)),
                        self._pp_bucket_for(max(1, max_hits)))] = prefix_batch
            for key, batch in groups.items():
                try:
                    if isinstance(key, tuple):
                        self._prefill_prefix_batch(batch, key[1], key[2])
                    else:
                        self._prefill_batch(batch)
                except Exception:
                    # off the queue and not in slots: fail them here or
                    # their on_done never fires
                    logger.exception("prefill failed for %s",
                                     [b[1].request_id for b in batch])
                    for item in batch:
                        req = item[1]
                        with self._cv:
                            self._admitting.discard(req.request_id)
                            self._cancel_pending.discard(req.request_id)
                        _call(req.on_done, req.request_id, [], "engine_error")

    def _prefill_batch(self, batch: List[Tuple[int, GenRequest]]) -> None:
        """One bucketed dense prefill for up to ``prefill_batch`` short
        prompts: forward at [prefill_batch, bucket] into a temp cache, the
        head at each row's last token, the first samples into the fed-token
        vector, and each real row's K/V into ``cache[:, slot, :bucket]``
        (padding rows are dropped). Stale entries a previous occupant left
        past the bucket are never read: decode attends only positions it
        has written."""
        t0 = time.time()
        n, Bp = len(batch), self.prefill_batch
        bucket = self._bucket_for(max(len(req.prompt) for _, req in batch))
        padded = np.full((Bp, bucket), self.pad_id, np.int32)
        lengths = np.ones(Bp, np.int32)
        gather = np.zeros(Bp, np.int64)
        scatter = np.full(Bp, self.max_batch, np.int64)
        for row, (slot_id, req) in enumerate(batch):
            padded[row, :len(req.prompt)] = req.prompt
            lengths[row] = len(req.prompt)
            gather[row] = scatter[row] = slot_id
            self._set_slot_sampling(slot_id, req.sampling)
        positions = torch.arange(bucket, dtype=torch.int32,
                                 device=self.device).expand(Bp, bucket)
        last_idx = self._tensor(lengths - 1)
        last, temp = self._decode_forward(
            self.params, self._tensor(padded), positions,
            self._init_cache_fn(Bp, bucket), logits_at=last_idx)
        slots = self._tensor(gather[:n])
        for full, fresh in zip(self.cache, temp):
            full[:, slots, :bucket] = fresh[:, :n]
        self._sample_into_slots(last, gather, last_idx, scatter)
        self._count_wave(lengths[:n], padded.size)
        self._activate(batch, t0)

    def _prefill_prefix_batch(self, batch: List[Tuple], bucket: int,
                              ppb: int) -> None:
        """One fused dense prefix prefill for the round's prefix-path
        rows (slot_id, req, hits, chains): each row's fresh full pages get
        pool pages (``acquire`` evicts LRU entries; fewer pages register
        less), the suffix forward reads the hits, and after the dispatch
        the new pages' chains are registered."""
        t0 = time.time()
        ps = self._prefix_ps
        rows: List[Tuple] = []
        records: List[Tuple] = []
        acquired: List[int] = []
        for slot_id, req, hits, chains in batch:
            prompt = req.prompt
            new_idx = list(range(len(hits), len(prompt) // ps))
            ids = self._prefix.acquire(len(new_idx)) if new_idx else []
            acquired.extend(ids)
            reg = list(zip(new_idx, ids))
            records.extend((chains[i], tuple(prompt[i * ps:(i + 1) * ps]), p)
                           for i, p in reg)
            p0 = len(hits) * ps
            rows.append((slot_id, req, prompt[p0:], p0, hits, reg))
        try:
            self._prefix_fused_dispatch(rows, bucket, ppb, t0)
        except Exception:
            for pid in acquired:
                self._prefix.release(pid)
            raise
        for rec in records:
            self._prefix.register(*rec)

    def _prefix_fused_dispatch(self, rows: List[Tuple], bucket: int,
                               ppb: int, t0: float) -> None:
        """The dense prefix prefill of ``rows`` (slot_id, req,
        suffix_tokens, prefix_len, hit_pages, [(lane_page, pool_page)] to
        register): the suffix forward over the gathered hits at [Bp,
        bucket] with a ``ppb``-page prefix table, the first samples, each
        real row's composed lane into ``cache[:, slot, :lane]``, and the
        registered pages copied out of the lanes into the side pool --
        after the forward read the pool, so a hit page evicted and
        re-acquired in this round is read before it is rewritten."""
        ps, Bp, n = self._prefix_ps, self.prefill_batch, len(rows)
        lane_pages = min(ppb + -(-bucket // ps), self.max_seq // ps)
        padded = np.full((Bp, bucket), self.pad_id, np.int32)
        lengths = np.ones(Bp, np.int32)
        plens = np.zeros(Bp, np.int32)
        table = np.zeros((Bp, ppb), np.int32)
        gather = np.zeros(Bp, np.int64)
        scatter = np.full(Bp, self.max_batch, np.int64)
        reg_rows, reg_cols, reg_pages = [], [], []
        for r, (slot_id, req, suffix, plen, hits, reg) in enumerate(rows):
            padded[r, :len(suffix)] = suffix
            lengths[r], plens[r] = len(suffix), plen
            table[r, :len(hits)] = hits
            gather[r] = scatter[r] = slot_id
            self._set_slot_sampling(slot_id, req.sampling)
            for lane_page, pid in reg:
                reg_rows.append(r)
                reg_cols.append(lane_page)
                reg_pages.append(pid)
        pool_k, pool_v = self._prefix_pool
        lengths_t, plens_t = self._tensor(lengths), self._tensor(plens)
        logits, lane_k, lane_v = self._prefix_lane_fwd(
            self.params, self._tensor(padded), self._tensor(table), plens_t,
            pool_k, pool_v, lane_pages, logits_at=lengths_t - 1)
        slots = self._tensor(gather[:n])
        lane_t = lane_pages * ps
        for full, lane in zip(self.cache, (lane_k, lane_v)):
            full[:, slots, :lane_t] = lane[:, :n]
        if reg_pages:
            idx = [self._tensor(np.asarray(a, np.int64))
                   for a in (reg_rows, reg_cols, reg_pages)]
            for pool, lane in ((pool_k, lane_k), (pool_v, lane_v)):
                pages = lane.reshape((lane.shape[0], Bp, lane_pages, ps)
                                     + tuple(lane.shape[3:]))
                pool[:, idx[2]] = pages[:, idx[0], idx[1]].to(pool.dtype)
        self._sample_into_slots(logits, gather, plens_t + lengths_t - 1,
                                scatter)
        self.metrics.counters["prefix_reused_tokens"].inc(int(plens.sum()))
        self._count_wave(lengths[:n], padded.size)
        self._activate([(r[0], r[1]) for r in rows], t0)

    def _count_wave(self, lengths: np.ndarray, size: int) -> None:
        """Counters of one bucketed wave: real and padding tokens."""
        packed = int(lengths.sum())
        c = self.metrics.counters
        c["prefill_waves"].inc()
        c["prefill_packed_tokens"].inc(packed)
        c["prefill_padding_tokens"].inc(int(size) - packed)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _prefill_ragged_waves(self, batch: List[Tuple]) -> None:
        """Packed ragged admission waves. ``batch`` rows: (slot_id, req,
        hits, chains, table_row). A row longer than the wave's remaining
        room splits: its head's K/V lands in its pages this wave and the
        tail rides the next wave with prefix_len advanced (the kernel reads
        the written pages back in place, like a prefix hit). Sampling fires
        on a row's final chunk only, folding the key at the absolute
        position of the row's last prompt token."""
        t0 = time.time()
        R = self.max_batch
        ps = self.paged.page_size
        maxp = self.paged.allocator.maxp
        cap = maxp * ps
        pend: List[List[Any]] = []
        for slot_id, req, hits, _chains, row in batch:
            p0 = len(hits) * ps
            pend.append([slot_id, req.prompt[p0:], p0, 0, row])
            self._set_slot_sampling(slot_id, req.sampling)
        packed_n = padding_n = 0
        k_pool, v_pool = self.cache["k"], self.cache["v"]
        while pend:
            wd = self._ragged_width_for(sum(len(it[1]) - it[3]
                                            for it in pend))
            tokens = np.full(wd, self.pad_id, np.int32)
            tok_row = np.full(wd, R, np.int32)   # R = dead-row sentinel
            tok_pos = np.full(wd, cap, np.int32)  # >= coverage -> trash
            starts = np.zeros(R, np.int32)
            lens = np.zeros(R, np.int32)
            plens = np.zeros(R, np.int32)
            tables = np.zeros((R, maxp), np.int32)
            scatter = np.full(R, self.max_batch, np.int64)
            gather = np.zeros(R, np.int64)
            filled = r = 0
            for it in pend:
                if filled >= wd or r >= R:
                    break
                slot_id, suffix, p0, consumed, row = it
                take = min(len(suffix) - consumed, wd - filled)
                if take <= 0:
                    continue
                abs0 = p0 + consumed
                tokens[filled:filled + take] = suffix[consumed:consumed + take]
                tok_row[filled:filled + take] = r
                tok_pos[filled:filled + take] = np.arange(abs0, abs0 + take)
                starts[r], lens[r], plens[r] = filled, take, abs0
                tables[r] = row
                gather[r] = slot_id
                if consumed + take == len(suffix):
                    scatter[r] = slot_id     # final chunk: sample here
                it[3] = consumed + take
                filled += take
                r += 1
            tok_row_t, tok_pos_t = self._tensor(tok_row), self._tensor(tok_pos)
            tables_t = self._tensor(tables)
            plens_t, lens_t = self._tensor(plens), self._tensor(lens)
            logits, sk, sv = self.paged.prefill_ragged(
                self.params, self._tensor(tokens), tok_row_t, tok_pos_t,
                tables_t, self._tensor(starts), lens_t, plens_t,
                k_pool, v_pool)
            self._sample_into_slots(
                logits, gather, torch.clamp(plens_t + lens_t - 1, min=0),
                scatter)
            paged_write_ragged(k_pool, v_pool, sk, sv, tok_row_t, tok_pos_t,
                               tables_t)
            packed_n += filled
            padding_n += wd - filled
            self.metrics.counters["prefill_waves"].inc()
            pend = [it for it in pend if it[3] < len(it[1])]
        self.metrics.counters["prefill_packed_tokens"].inc(packed_n)
        self.metrics.counters["prefill_padding_tokens"].inc(padding_n)
        if self._prefix is not None:
            self._register_prefix(batch)
        self._activate([(b[0], b[1]) for b in batch], t0)

    def _register_prefix(self, batch: List[Tuple]) -> None:
        """Custody of each prompt's fresh FULL pages moves to the prefix
        cache (no copy); matched hits stay pinned until retirement."""
        ps = self._prefix_ps
        alloc = self.paged.allocator
        reused = 0
        for slot_id, req, hits, chains, _row in batch:
            if chains is None:
                continue
            reused += len(hits) * ps
            fresh = alloc.pages_for(slot_id)
            pins: List[int] = []
            for page_idx in range(len(hits), len(req.prompt) // ps):
                f = page_idx - len(hits)
                if f >= len(fresh):
                    break
                toks = tuple(req.prompt[page_idx * ps:(page_idx + 1) * ps])
                if self._prefix.register(chains[page_idx], toks, fresh[f]):
                    alloc.transfer_to_cache(slot_id, [fresh[f]])
                    self._prefix.pin([fresh[f]])
                    pins.append(fresh[f])
            self._slot_prefix_pins[slot_id] = hits + pins
        if reused:
            self.metrics.counters["prefix_reused_tokens"].inc(reused)

    def _activate(self, batch: List[Tuple[int, GenRequest]],
                  t0: float) -> None:
        for slot_id, req in batch:
            slot = self.slots[slot_id]
            slot.active = True
            slot.request = req
            slot.position = len(req.prompt)
            slot.generated = []
            slot.logprobs = []
            slot.pending_first = True
            slot.first_token_at = None
            with self._cv:
                self._admitting.discard(req.request_id)
                slot.cancelled = req.request_id in self._cancel_pending
                self._cancel_pending.discard(req.request_id)
            self.total_requests += 1
            self.metrics.counters["prompt_tokens"].inc(len(req.prompt))
            self.metrics.counters["engine_admitted"].inc()
            self.metrics.latencies["queue_wait_s"].observe(
                t0 - req.submitted_at)
        dt = time.time() - t0
        self.metrics.latencies["prefill_s"].observe(dt)
        self.metrics.counters["phase_us_prefill"].inc(int(dt * 1e6))
        self.metrics.counters["engine_admission_waves"].inc()

    # --------------------------------------------------------------- decode

    def _decode_chunk(self):
        """One chunk of K decode steps: with ``chunked_fns``, K steps with
        the cache frozen and then the merge; without, K single steps that
        each write the cache. Returns the host copy of the [K+1, B] token
        and logprob blocks (row 0 = the fed tokens) and the (slot,
        request, start position) snapshot."""
        t0 = time.perf_counter()
        B, K = self.max_batch, self.decode_chunk
        positions = np.zeros(B, np.int32)
        snapshot: List[Tuple[int, GenRequest, int]] = []
        for i, s in enumerate(self.slots):
            if s.active:
                positions[i] = s.position
                snapshot.append((i, s.request, s.position))
        live = [i for i, _, _ in snapshot]
        use_filters = bool(np.any((self._topk[live] > 0)
                                  | (self._topp[live] < 1.0)))
        greedy = not use_filters and not np.any(self._temp[live] > 0)
        keys = self._tensor(self._base_keys_np.astype(np.int64))
        temp = self._tensor(self._temp)
        topk = self._tensor(self._topk)
        topp = self._tensor(self._topp)
        pos0 = self._tensor(positions)
        pos = pos0
        tok = self._last_tokens[:B].clone()
        toks, lps = [tok], [self._last_lps[:B].clone()]
        chunked = self._chunked_fns is not None
        if chunked:
            chunk_fwd, _init_chunk, merge_chunk = self._chunked_fns
            hk, hv = self._chunk_kv
            hk.zero_()
            hv.zero_()
        for step in range(K):
            if chunked:
                logits, _ = chunk_fwd(self.params, tok[:, None],
                                      pos[:, None], self.cache, (hk, hv),
                                      step)
            else:
                logits, self.cache = self._decode_forward(
                    self.params, tok[:, None], pos[:, None], self.cache)
            tok = sample_tokens(logits[:, -1], keys, pos, temp, topk, topp,
                                use_filters=use_filters,
                                assume_greedy=greedy)
            toks.append(tok)
            lps.append(token_logprob(logits[:, -1], tok))
            pos = pos + 1
        if chunked:
            merge_chunk(self.cache, (hk, hv), pos0)
        self._last_tokens[:B] = tok
        self._last_lps[:B] = lps[-1]
        # the one host sync per chunk
        block = torch.stack(toks).cpu().numpy()
        lp_block = torch.stack(lps).cpu().numpy()
        c = self.metrics.counters
        c["engine_host_syncs"].inc()
        c["engine_decode_chunks"].inc()
        c["phase_us_decode"].inc(int((time.perf_counter() - t0) * 1e6))
        return block, lp_block, snapshot

    def _process_block(self, block: np.ndarray, lps: np.ndarray,
                       snapshot: List[Tuple[int, GenRequest, int]]) -> None:
        """Emit one chunk's tokens: token (s+1, i) was sampled at write
        position pos0_i + s; emission stops at EOS / max_new_tokens /
        max_seq and the rest of the lane is discarded garbage."""
        now = time.time()
        K = self.decode_chunk
        for i, req, pos0 in snapshot:
            s = self.slots[i]
            if not s.active or s.request is not req:
                continue
            if s.cancelled:
                self._retire(i, "cancelled")
                continue
            if s.pending_first:
                s.pending_first = False
                self._emit_token(i, int(block[0, i]), now,
                                 float(lps[0, i]))
            for step in range(K):
                if not s.active:
                    break
                if pos0 + step >= self.max_seq:
                    self._retire(i, "max_seq")
                    break
                self._emit_token(i, int(block[step + 1, i]), now,
                                 float(lps[step + 1, i]))
            if s.active:
                s.position = pos0 + K

    def _emit_token(self, slot_id: int, token: int, now: float,
                    logprob: float) -> None:
        """Record a sampled token, stream it, retire if finished."""
        slot = self.slots[slot_id]
        req = slot.request
        if slot.first_token_at is None:
            slot.first_token_at = now
            self.metrics.latencies["first_token_s"].observe(
                now - req.submitted_at)
        reason = None
        if token == self.eos_id:
            reason = "eos"
        else:
            slot.generated.append(token)
            slot.logprobs.append(logprob)
            self.total_generated += 1
            self.metrics.rates["tokens_generated"].mark(now)
            self.metrics.counters["tokens_generated"].inc()
            if req.on_token is not None:
                try:
                    req.on_token(req.request_id, token)
                except Exception:
                    logger.exception("on_token callback failed")
            if len(slot.generated) >= req.sampling.max_new_tokens:
                reason = "length"
        if reason is not None:
            self._retire(slot_id, reason)

    def _retire(self, slot_id: int, reason: str) -> None:
        slot = self.slots[slot_id]
        req = slot.request
        slot.active = False
        slot.request = None
        if self.paged is not None:
            # pages stay owned until the next admission round zeroes the
            # table row and frees them (a dense lane has none to free)
            self.paged.allocator.mark_retired(slot_id)
            pins = self._slot_prefix_pins.pop(slot_id, None)
            if pins:
                self._prefix.unpin(pins)
        self.metrics.counters["engine_completed"].inc()
        self.metrics.rates["requests_completed"].mark()
        if req is not None:
            req.metadata["logprobs"] = list(slot.logprobs)
            _call(req.on_done, req.request_id, list(slot.generated), reason)

    def _fail_all(self, reason: str) -> None:
        for i, s in enumerate(self.slots):
            if s.active:
                self._retire(i, reason)
        with self._cv:
            pending = [item[3] for item in self._queue]
            self._queue.clear()
            self._admitting.clear()
            self._cancel_pending.clear()
        for req in pending:
            _call(req.on_done, req.request_id, [], reason)

    # ------------------------------------------------------------------ info

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            queued = len(self._queue)
        out = {
            "device": str(self.device),
            "active_slots": sum(1 for s in self.slots if s.active),
            "max_batch": self.max_batch,
            "queued": queued,
            "total_requests": self.total_requests,
            "total_generated": self.total_generated,
            "tokens_per_sec_60s":
                self.metrics.rates["tokens_generated"].rate(),
            "latencies": {
                k: self.metrics.latencies[k].summary()
                for k in ("queue_wait_s", "prefill_s", "first_token_s")
                if k in self.metrics.latencies},
            "cache": "paged" if self.paged is not None else "dense",
        }
        if self.paged is not None:
            out.update(pool=self.paged.allocator.stats(),
                       pool_headroom=round(self._pool_headroom(), 4),
                       admission_paused=self._bp_paused)
        if self._prefix is not None:
            out["prefix_cache"] = self._prefix.stats()
        return out


def _call(fn, *args) -> None:
    """Run a user callback; a failing callback never takes the engine
    down."""
    if fn is None:
        return
    try:
        fn(*args)
    except Exception:
        logger.exception("callback failed")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        logger.warning("%s=%r is not an int; using %d", name,
                       os.environ.get(name), default)
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        logger.warning("%s=%r is not a float; using %g", name,
                       os.environ.get(name), default)
        return default
