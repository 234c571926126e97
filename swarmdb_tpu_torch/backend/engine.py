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
  default 8), a row longer than the wave's room split across waves. A
  model without a ragged forward (Mixtral), or ``SWARMDB_RAGGED_PREFILL=0``,
  prefills in the JAX package's row-bucketed waves instead: prompts with a
  prefix plan in one prefix wave per round (the suffix forward over the
  hit pages in place, its whole pages inserted into the slot's fresh
  pages, which then move into cache custody), the others in one bucketed
  wave per bucket (a dense temp-cache forward whose whole pages are
  inserted), each padded to the round's row bucket. Dense: prompts of at
  least one page go through the prefix path (a side
  page pool, ``PrefixLRU`` with its own free list) even on a full miss,
  so that their pages are registered: one fused suffix prefill per round
  over the reused pages, padded to the round's (suffix bucket, prefix
  width), its lanes inserted into the slots; shorter prompts prefill in
  one bucketed wave per bucket (``Engine.prefill_buckets``), padded to
  ``prefill_batch`` rows, inserted at ``cache[:, slot, :bucket]``. Either
  way the sampled first token lands in the device-resident fed-token
  vector and reaches the host as row 0 of the next decode block.
- Decode runs in chunks of ``decode_chunk`` (K) steps
  (``backend/decode_graphs.py``): with ``chunked_fns``, K steps of the
  chunk forward + sampling with the cache frozen, then one merge into the
  cache (``merge_paged_chunk`` / ``merge_chunk``); without
  (``SWARMDB_CHUNKED=0``), K single steps (``PagedKV.decode_forward``, or
  the dense ``forward_fn`` at T == 1), each writing its token into the
  cache before attending. Each chunk writes a [K+1, B] token and logprob
  block (row 0 = the fed tokens) that the host reads once. On the card a
  chunk is one CUDA graph replay per sampling variant; on the CPU it runs
  eagerly.
- The two loops are the JAX package's defaults. The paged engine runs
  device-resident decode sessions unless ``SWARMDB_EMIT_RING=0`` (read at
  build): a session covers the active slots, runs chunks until every lane
  is done, ``max_chunks`` have run or the host votes to stop after a chunk
  (stopping, a chaos fault armed, nothing active, or queued work meeting a
  free slot), and admission happens only between sessions. Every row's
  position advances by K each chunk, idle rows' (from 0) included. The
  dense engine, and the paged one with ``SWARMDB_EMIT_RING=0``, keep up to
  ``pipeline_depth`` chunks in flight (``SWARMDB_PIPELINE``, default 2,
  read by ``service.build_backend_engine``): a slot's dispatched position
  advances at dispatch, a slot that retires with a chunk in flight decodes
  that chunk's garbage at its own positions (the snapshot tells the host
  to discard it), and idle slots decode at position 0. What idle and
  retired rows feed matters to a MoE model, whose routing counts every
  row of the step: the port gives the JAX package's tokens in both loops.
- Rolling KV (``GenRequest.keep_pages`` / ``resume_pages``, driven by the
  service's registry): a keep request hands its pages to ``on_pages`` at
  retirement (paged: custody moves; dense: the lane is copied into side
  pool pages) with the host-confirmed written extent and the tail tokens
  past it; a resume request references the kept pages and prefills only
  its suffix from ``resume_len`` (mid-page): paged through
  ``forward_prefix_pages`` and ``paged_write_chunk``, dense through the
  prefix lane, in one wave per suffix bucket padded to ``prefill_batch``
  rows. A resume's epoch (``pool_epoch``) is checked at submit and at
  admission ("stale_resume"). Warm-tier promotions copy their host
  payload into the reserved pages first (``_promote_insert``). Every such
  write lands in place, in the tensors the decode graphs read, on the
  engine thread's stream.

The lane supervisor's hooks (``backend/supervisor.py``) are the JAX
engine's: the loop stamps a liveness beat every iteration (idle waits
included) and flags when it is inside a step, ``chaos_step`` is the
fault-injection seam at the top of each iteration
(``backend/chaos.py``), queued requests past their ``deadline`` fail with
"deadline", and finish reasons in ``RETRYABLE_REASONS`` name a request
the engine lost (or returned) through no fault of its own.

Observability, at the JAX engine's sites and with its names: the
process-global tracer gets an ``engine.admit`` retro-span (submit ->
admission) and one ``engine.prefill`` span per admitted row, an
``engine.host_sync`` span for every host wait on the device (a chunk's
block, the fleet prefill lane's fed tokens) and one
``engine.decode_chunk`` span per snapshot slot of each processed chunk;
the histograms ``queue_wait_seconds``, ``decode_chunk_seconds`` and
``ttft_seconds`` (``obs/metrics.py``) take the request id as exemplar;
the counters ``phase_us_queue_wait``, ``phase_us_prefill``,
``phase_us_decode`` (a chunk's share of wall time, which holds the
host's wait for it) and ``phase_us_host_sync`` (the time blocked in
those waits) feed the SLO sentinel. ``flight`` holds a step record after
each admission and dispatch round with work (``_flight_step``, which
also probes the sentinel's window), a request record at each retirement,
and discrete events (backpressure, shedding, chaos, restarts). Spans,
observations and counters all run on the host around the decode chunk,
never inside the callable that a CUDA graph captures. The device-time
profiler (``obs/profiler.py``, the engine's ``_prof`` lane) gets each
variant's cost facts at ``warmup`` (``profile_harvest``), and each decode
chunk's and prefill wave's device time under the JAX engine's keys
(``prof_key``): on the card from a pair of timing events on the engine's
stream, read only after a host wait the engine takes anyway (a chunk's
after its own block; a prefill wave's at the next host wait once its end
event has passed), off the card from the wall clock around the call; each
prefill wave also lands in the dispatch-shape profile. A paged engine
prices its pool pages for the memory accountant (``obs/memprof.py``),
whose residency and reuse hooks sit in ``PageAllocator`` and
``PrefixLRU``.

All tensors live on the engine's explicit ``device``, and on the card
every operation on them runs on the engine's own stream (``stream``): its
state is built there, and the loop thread, ``warmup``'s captures,
restarts and the tier's and the fleet's copies all enqueue there, so
lanes that share a card (``parallel/lanes.py``) never wait on each
other's work, and a copy that another lane reads is published only after
an event on this stream has passed. The worker thread sets the device as
its current CUDA device.

Pod mode (``parallel/multihost.py``, the JAX engine's multi-host mode):
rank 0's engine (``enable_multihost``) publishes each device call before
issuing it -- the dense bucketed prefill and the decode chunk, and the
paged engine's mirrored calls (``_mirrored``: page-table rows, bucketed,
packed and prefix prefill waves) -- and beats while idle; every other
rank's engine replays them (``worker_loop``). Its chunks run as graph
replays unless the model axis's collectives cannot be captured (gloo:
``decode_graphs=False``). A failed step stops the pod, its requests
ending "engine_error"; rolling keep and resume are refused there. A
restart is refused in a pod launched from outside; the single program
over several devices of one process (``parallel/local.py``) owns its
workers (``_owner``): its stop ends them, its restart replaces them.

A data axis (``data_axis``, ``parallel/serving.py``): the host schedules
all ``max_batch`` slots on every rank, but a rank's device state holds
only its own block of them (slots ``[d * B/dp, (d + 1) * B/dp)``: the
fed tokens, the chunk buffer, the dense slot cache, or on a sharded pool
its own sub-pool and its rows of the page table, localized). A chunk's
inputs are cut to the rank's block; after it, the ranks gather their
blocks over the axis (``ChunkRunner``'s ``gather``, outside any graph),
so every rank reads all B slots' tokens. A prefill wave is published
whole and each rank runs its own rows: the dense engine's rows of its
slots, a sharded pool's packed block (``_pack_wave``), or a prefix
wave's rows of its shard. On a sharded pool admission interleaves the
shards and honours a request's shard hint (``_free_slot_ids``), and the
resident loop, row buckets, ragged prefill and rolling are off, as in
the JAX engine.

Lane hooks (``parallel/lanes.py``, ``parallel/fleet.py``), inert on a
lone engine: ``GenRequest.shard_hint`` routes a request to a lane;
``flight_shard`` stamps the engine's events with its lane;
``overlap_probe`` says whether a sibling lane is inside a decode session
(``_lane_busy``) when this one admits, counted in
``engine_admission_overlap_steps``; a fleet ``_role`` of "prefill"
retires admission-only requests straight off the prefill sample
(``_drain_prefill_only``) and captures no decode graph at warmup.
"""

from __future__ import annotations

import contextlib
import functools
import heapq
import itertools
import logging
import os
import threading
import time
import uuid
import zlib
from dataclasses import dataclass, field
from typing import (Any, Callable, ContextManager, Dict, List, Optional,
                    Tuple)

import numpy as np
import torch

from ..obs import cost as prof_cost
from ..obs.flight import FlightRecorder
from ..obs.memprof import memprof
from ..obs.metrics import HIST_DECODE_CHUNK, HIST_QUEUE_WAIT, HIST_TTFT
from ..obs.profiler import NullLane
from ..obs.profiler import profiler as kernel_profiler
from ..obs.tracer import TRACER
from ..ops.attention_cuda import (decode_kernel_name, kerncheck_poll,
                                  kerncheck_record)
from ..ops.layers import kerncheck_enabled
from ..ops.paged_kv import (KV_DTYPES, PageAllocator, QuantPool,
                             canary_check, canary_fill, paged_write_chunk,
                             paged_write_ragged, pool_data, pool_dtype,
                             pool_insert_pages, pool_insert_raw, pool_layer,
                             pool_page_bytes, set_page_table_rows)
from ..ops.prefix_cache import PrefixLRU, make_prefix_lru, page_chains
from ..utils.device import DeviceLike, resolve_device
from ..utils.metrics import MetricsRegistry
from ..utils.sync import make_condition, make_rlock
from .decode_graphs import (ChunkIO, ChunkOut, ChunkRunner, decode_chunk,
                            device_lock, variant_for)
from .sampling import (SamplingParams, key_from_seed, make_slot_keys,
                       sample_tokens, token_logprob)

logger = logging.getLogger("swarmdb_tpu_torch.engine")

#: Finish reasons a client (or the lane supervisor) may retry: the request
#: was fine, the engine lost it (loop death, restart, a failed dispatch)
#: or returned it (pool-pressure shedding). "eos", "length", "cancelled",
#: "deadline" and "max_seq" are final. The JAX engine's set, whose
#: "lane_quarantined" and "stale_resume" come from lanes and rolling KV.
RETRYABLE_REASONS = frozenset({
    "engine_error", "engine_restart", "lane_quarantined", "shed",
    "stale_resume",
})


def is_retryable_reason(reason: str) -> bool:
    """True when a finish reason is safe to requeue."""
    return reason in RETRYABLE_REASONS


# One dispatched program = one profiler key, the JAX engine's names: the
# decode / resident families have one shape each (per sampling variant);
# prefill families key on the shapes of the wave (rows x token bucket, +
# the prefix-gather width). The same helper names the warmup harvest's
# rows and the runtime's dispatches, so cost facts and device time join.

PROF_DECODE_KEYS = ("decode.full", "decode.fast", "decode.greedy")
PROF_RESIDENT_KEYS = ("resident.full", "resident.fast", "resident.greedy")


def prof_key(family: str, tok_shape, ppb: Optional[int] = None) -> str:
    """Profiler variant key for a prefill family + its shape axes."""
    if len(tok_shape) == 1:
        return f"{family}[w{tok_shape[0]}]"
    r, b = tok_shape
    if ppb is None:
        return f"{family}[r{r}xb{b}]"
    return f"{family}[r{r}xb{b}xp{ppb}]"


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
    # absolute wall-clock time past which the request must not be served:
    # a queued request past it fails with "deadline" at admission; the
    # supervisor enforces it end to end. None = no deadline
    deadline: Optional[float] = None
    # how many times the supervisor may requeue a retryable finish
    retries_left: int = 0
    # ---- rolling KV: a conversation continued across turns ----
    # resume_pages: page ids already holding this conversation's K/V (the
    # caller, the service's rolling registry, keeps custody; the engine
    # only references them). resume_len: tokens in those pages; ``prompt``
    # then carries only the new suffix, decoded on from resume_len +
    # len(prompt)
    resume_pages: Optional[List[int]] = None
    resume_len: int = 0
    # keep_pages: at retirement the slot's pages leave engine custody and
    # on_pages(request_id, pages, written_len, tail_tokens) fires instead
    # of a free. tail_tokens are emitted tokens whose K/V the host has not
    # confirmed written (the written extent is chunk-granular): the next
    # resume's prompt starts with them
    keep_pages: bool = False
    on_pages: Optional[Callable[[str, List[int], int, List[int]],
                                None]] = None
    # resume_epoch: Engine.pool_epoch() when the resume was planned;
    # submit and admission both check it, since a pool reset in between
    # hands the page ids to other slots ("stale_resume")
    resume_epoch: Optional[int] = None
    # promote_payload: a warm-tier promotion's host payload ((k, v)
    # ``pool_gather_pages`` outputs), copied into resume_pages (freshly
    # reserved) on the engine thread before the resume prefill reads them
    promote_payload: Optional[Any] = None
    # shard_hint: the lane a lane group routes this request to (mod the
    # lane count), so a conversation's turns meet its prefix-cache pages
    # in one lane's pool. Advisory: a quarantined lane's requests remap
    shard_hint: Optional[int] = None


@dataclass
class _Slot:
    active: bool = False
    request: Optional[GenRequest] = None
    position: int = 0           # next absolute position to write
    # next position to DISPATCH: runs ahead of ``position`` by the chunks
    # in flight
    dispatched_position: int = 0
    generated: List[int] = field(default_factory=list)
    logprobs: List[float] = field(default_factory=list)
    pending_first: bool = False  # prefill token not yet surfaced to host
    cancelled: bool = False      # retire at the next processed block
    first_token_at: Optional[float] = None
    admitted_at: Optional[float] = None
    # the engine's host-sync count at admission (the request record's
    # host_syncs is the difference at retirement)
    admit_syncs: int = 0


@dataclass
class PagedKV:
    """Paged-pool wiring: ``init_pool`` builds the {"k","v","page_table"}
    dict (plain or int8 pools), the host-side ``allocator`` hands out
    pages (admission stalls while the pool cannot cover a request's
    worst-case footprint), ``prefill_ragged`` is the packed ragged prefill
    forward: (params, tokens[W], tok_row[W], tok_pos[W], row_tables[R,
    maxp], starts[R], lens[R], prefix_lens[R], k_pool, v_pool) -> ([R, V]
    last-token logits, sfx_k, sfx_v [L, W, Hkv, D]), or None for a model
    without one (the engine then prefills in row-bucketed waves), and
    ``decode_forward`` the single-step decode used when the engine has no
    ``chunked_fns``: (params, tokens[B,1], positions[B,1], cache) ->
    (logits [B, 1, V], cache)."""

    init_pool: Callable[[], Dict[str, Any]]
    page_size: int
    num_pages: int
    allocator: PageAllocator
    prefill_ragged: Optional[Callable] = None
    decode_forward: Optional[Callable] = None


class Engine:
    """Slot-based continuous batching over the paged pool or the dense
    slot cache."""

    # swarmlint: guarded-by[self._cv]: _queue, _admitting, _cancel_pending, _stop
    # swarmlint: device-state: _last_tokens, _last_lps, cache

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
        flight_dir: Optional[str] = None,
        pipeline_depth: int = 2,
        model_config: Any = None,
        decode_graphs: bool = True,
        data_axis: Any = None,
        count_rows: bool = False,
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

        A paged engine prefills in ragged waves when ``paged.prefill_ragged``
        is set and ``SWARMDB_RAGGED_PREFILL`` is not "0" (read here);
        otherwise in row-bucketed waves, which take ``forward_fn`` and
        ``init_cache_fn`` as the dense prefill does (the temp cache's whole
        pages go into the pool) and, with the prefix cache on,
        ``prefix_fns`` = (pages_forward(params, tokens, table, prefix_lens,
        k_pool, v_pool, logits_at=) -> (logits, sfx_k, sfx_v), None) for
        the suffix forward over hit pages in place. Their rows are
        ``prefill_batch``, or with ``prefill_batch <= 4`` the smallest
        power of two covering the wave, as the JAX package's paged engine
        pads them by default.

        ``chunked_fns`` = (chunk_forward(params, tokens[B,1],
        positions[B,1], cache, chunk_kv, step) -> (logits, chunk_kv),
        init_chunk(batch, K) -> chunk_kv, merge_chunk(cache, chunk_kv,
        start_positions) -> cache), or None: decode then runs
        ``paged.decode_forward`` (dense: ``forward_fn``) one step at a
        time.

        ``pipeline_depth`` chunks may be in flight before the host reads
        the oldest block (the dense engine, and the paged one under
        ``SWARMDB_EMIT_RING=0``); a paged engine otherwise decodes in
        resident sessions (``SWARMDB_EMIT_RING``, read here).

        ``model_config`` (a ``models.configs.ModelConfig``) prices the
        variants for the device-time profiler at ``warmup``; without it
        the harvest registers the variants unpriced (no MFU).

        ``decode_graphs`` (the card only): replay each decode chunk as a
        CUDA graph (the default), or run it eagerly -- a tensor-parallel
        engine whose collectives cannot be captured (gloo) says False
        (``parallel/serving.py`` decides from the process group's
        backend).

        ``data_axis`` (a ``parallel.collectives.Axis`` of more than one
        rank): this rank's device state covers its own block of the slots
        (module docstring); a paged engine then takes a pool sharded over
        the axis (``ShardedPageAllocator``, ``paged.init_pool`` building
        the rank's sub-pool and table rows).

        ``count_rows`` (with ``data_axis``): the forwards' rows meet (a
        MoE block's capacity counts every row of a call;
        ``ShardedModel.counts_call``), so a call whose JAX counterpart is
        one GSPMD program over the data ranks (the dense engine's waves
        and decode steps, a sharded pool's prefix waves) passes them
        ``rows=(ids, n)``: this rank's rows' ids in the global call and
        the call's rows."""
        self.device = resolve_device(device)
        # the engine's stream on the card (module docstring); it first
        # waits for what the building thread enqueued (the weights)
        self.stream: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_stream():
            # the data axis: this rank's slots [_lo, _lo + _rows)
            self._data_axis = (data_axis if data_axis is not None
                               and data_axis.size > 1 else None)
            dp = self._data_axis.size if self._data_axis else 1
            if max_batch % dp:
                raise ValueError(f"max_batch {max_batch} must divide the "
                                 f"data axis {dp} (slot->shard affinity)")
            self._rows = max_batch // dp
            self._lo = self._data_axis.index * self._rows if dp > 1 else 0
            n_shards = (getattr(paged.allocator, "n_shards", 1)
                        if paged is not None else 1)
            if paged is not None and n_shards != dp:
                raise ValueError(f"a paged engine over a data axis of {dp} "
                                 f"needs a pool of {dp} shards, not "
                                 f"{n_shards}")
            self._sharded = n_shards > 1
            self._admit_rr = 0   # rotates the shards' admission interleave
            self._ragged = (paged is not None
                            and paged.prefill_ragged is not None
                            and not self._sharded
                            and os.environ.get("SWARMDB_RAGGED_PREFILL",
                                               "auto") != "0")
            if not self._ragged and None in (forward_fn, init_cache_fn):
                raise ValueError("a dense engine, or a paged one without "
                                 "ragged prefill, needs forward_fn and "
                                 "init_cache_fn")
            self._forward_fn = forward_fn
            self._decode_forward = (paged.decode_forward if paged is not None
                                    else forward_fn)
            # the forwards count every row of a global call (docstring); a
            # decode step's rows are this rank's slot block
            self._count_rows = self._data_axis is not None and count_rows
            if self._count_rows and paged is None:
                block = (torch.arange(self._lo, self._lo + self._rows,
                                      device=self.device), max_batch)
                self._decode_forward = functools.partial(forward_fn,
                                                         rows=block)
                if chunked_fns is not None:
                    chunked_fns = (functools.partial(chunked_fns[0],
                                                     rows=block),
                                   *chunked_fns[1:])
            if chunked_fns is None and self._decode_forward is None:
                raise ValueError("an engine without chunked_fns needs "
                                 "paged.decode_forward")
            self.params = params
            self.max_batch = max_batch
            self.max_seq = max_seq
            self.eos_id = eos_id
            self.pad_id = pad_id
            self.metrics = metrics or MetricsRegistry()
            # bound once, as the JAX engine does: the hot paths observe
            # without a registry lookup per observation (SWL503)
            self._lat_queue_wait = self.metrics.latencies["queue_wait_s"]
            self._lat_prefill = self.metrics.latencies["prefill_s"]
            self._lat_first_token = self.metrics.latencies["first_token_s"]
            self.decode_chunk = max(1, int(decode_chunk))
            self.prefill_batch = max(1, min(prefill_batch or 8, max_batch))
            # rows of a bucketed wave: prefill_batch, or a power-of-two ladder
            # for small paged waves (the JAX package's row-bucketed default)
            self._row_buckets = [self.prefill_batch]
            if (paged is not None and not self._sharded
                    and self.prefill_batch <= 4):
                self._row_buckets = [1]
                while self._row_buckets[-1] < self.prefill_batch:
                    self._row_buckets.append(min(self.prefill_batch,
                                                 2 * self._row_buckets[-1]))
            self.paged = paged
            self.model_config = model_config
            self._chunked_fns = chunked_fns
            self._init_cache_fn = init_cache_fn
            self.cache = self._new_cache()
            if paged is not None:
                # KV bytes per pool page (scale rows included): prices the
                # accountant's warm-tier re-admission
                memprof().set_page_bytes(pool_page_bytes(self.cache["k"])
                                         + pool_page_bytes(self.cache["v"]))
            self._chunk_kv = (chunked_fns[1](self._rows, self.decode_chunk)
                              if chunked_fns is not None else None)
            self.pipeline_depth = max(1, int(pipeline_depth))
            self._graphs = bool(decode_graphs)
            # pod mode (enable_multihost / worker_loop): the control
            # plane, why the pod stopped if it did, and an optional log of
            # every processed chunk's [K+1, B] token block (tests compare
            # the ranks' blocks)
            self._mh = None
            self._pod_failed: Optional[str] = None
            self.block_log: Optional[List[np.ndarray]] = None
            # the workers this coordinator spawned, if it did
            # (parallel/local.py's LocalProgram): start, stop and restart
            # drive them
            self._owner = None
            self._resident = (paged is not None and not self._sharded
                              and os.environ.get("SWARMDB_EMIT_RING",
                                                 "1") != "0")
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
            # input token lives here between chunks (a data axis: this
            # rank's slots only, at i - _lo). The entry past them is a
            # write sink for prefill rows whose sample is discarded, so the
            # scatter needs no mask (and no host sync)
            self._last_tokens = torch.zeros(self._rows + 1,
                                            dtype=torch.int32,
                                            device=self.device)
            self._last_lps = torch.zeros(self._rows + 1, dtype=torch.float32,
                                         device=self.device)
            # the decode chunks' static buffers and their runner (the card's
            # graphs); the monotonic stamp of the last processed chunk
            self._io = ChunkIO.new(self._last_tokens[:self._rows],
                                   self._last_lps[:self._rows],
                                   self.decode_chunk)
            self._runner = self._new_runner()
            self._last_chunk_ns = 0

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
            # the tier manager's demote band, one rung below the pause
            # watermark with the same hysteresis (on until utilisation falls
            # back to the low watermark): SWARMDB_TIER_DEMOTE (default 0.85),
            # clamped into [low, high]; >= 1 turns the early signal off
            demote = _env_float("SWARMDB_TIER_DEMOTE", 0.85)
            self._bp_demote = (demote if demote >= 1.0
                               else max(self._bp_low,
                                        min(demote, self._bp_high)))
            self._tier_demoting = False

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
            self._prefix_pages_fwd: Optional[Callable] = None
            self._slot_prefix_pins: Dict[int, List[int]] = {}
            self._prefix_ps = paged.page_size if paged else prefix_page_size
            if paged is not None and prefix_cache:
                if max_seq % paged.page_size:
                    raise ValueError("max_seq must be a page-size multiple "
                                     "for prefix caching")
                self._prefix = make_prefix_lru(paged.num_pages,
                                               paged.page_size,
                                               manage_free=False,
                                               pool=paged.allocator)
                self._prefix_pp_buckets = self._pp_widths(paged.allocator.maxp)
                self._prefix_max_pages = self._prefix_pp_buckets[-1]
                self._prefix_pages_fwd = prefix_fns[0] if prefix_fns else None
                if not self._ragged and self._prefix_pages_fwd is None:
                    raise ValueError("a paged prefix cache without ragged "
                                     "prefill needs prefix_fns[0], the suffix "
                                     "forward over the pool's pages")
            elif paged is None and prefix_fns is not None:
                if max_seq % prefix_page_size:
                    raise ValueError("max_seq must be a page-size multiple "
                                     "for prefix caching")
                self._prefix_lane_fwd, self._prefix_init_pool = prefix_fns
                self._prefix_num_pages = max(2, prefix_pages)
                self._prefix = make_prefix_lru(self._prefix_num_pages,
                                               prefix_page_size)
                self._prefix_pool = self._prefix_init_pool(
                    self._prefix_num_pages, prefix_page_size)
                self._prefix_pp_buckets = self._pp_widths(
                    max_seq // prefix_page_size)
                self._prefix_max_pages = self._prefix_pp_buckets[-1]

            # lane supervision signals (backend/supervisor.py): a monotonic
            # beat stamped by the loop every iteration, idle waits included,
            # and whether the loop is inside a step. A wedged dispatch stops
            # the beat while the thread stays alive. Single-writer slots,
            # read lock-free
            self._beat_mono = time.monotonic()
            self._in_step = False
            # fault-injection seam (backend/chaos.py): called once per loop
            # iteration on the engine thread, before admission. None in
            # production
            self.chaos_step: Optional[Callable[["Engine"], None]] = None
            # rolling KV's hooks, wired by ServingService (and TierManager):
            # on_pool_pressure(need) when paged admission cannot allocate (or
            # a dense keep finds its side pool short): the service evicts
            # idle conversations; on_tier_pressure(need) from the gate's
            # demote band: the tier worker plans demotions (no device work);
            # on_tier_drain() at the start of each paged admission round,
            # after the pending-free flush: the planned demotions run here,
            # on the engine thread. All three run on the engine thread
            self.on_pool_pressure: Optional[Callable[[int], None]] = None
            self.on_tier_pressure: Optional[Callable[[int], None]] = None
            self.on_tier_drain: Optional[Callable[[], None]] = None
            # promotion copies in flight: (event, pinned source) kept alive
            # until the event has passed
            self._promote_sources: List[Tuple[Any, Any]] = []
            # observability: spans go to the process-global tracer; the
            # flight recorder (last-N steps, last-M requests, events) is
            # the engine's own, dumped on restart and on an SLO alert
            self.tracer = TRACER
            self.flight = FlightRecorder()
            # the runtime sanitizers: the page sanitizer is on when the
            # allocator came from its checked factory, the kernel sanitizer
            # when SWARMDB_KERNCHECK was set at this engine's build (the
            # checked ragged write; the kernels' bounds-checked build is
            # picked per launch); each attaches the flight recorder
            self._pagecheck = (getattr(paged.allocator, "pagecheck", None)
                               if paged is not None else None)
            if self._pagecheck is not None:
                from ..obs.pagecheck import registry as pagecheck_registry

                pagecheck_registry().attach_flight(self.flight)
            self._kerncheck = kerncheck_enabled()
            self._write_ragged = paged_write_ragged
            if self._kerncheck:
                from ..obs import kerncheck

                kerncheck.registry().attach_flight(self.flight)
                self._write_ragged = kerncheck.checked_paged_write_ragged(
                    paged_write_ragged)
                if self.device.type == "cuda":
                    kerncheck_record(self.device)  # before any capture
            self._flight_dir = flight_dir
            self._flight_last_had_work = False
            # the SLO sentinel (obs/sentinel.py): the runtime owns it and
            # ServingService points it here, so the loop drives window
            # closes; None = an unmonitored engine
            self.sentinel = None
            # host syncs of this engine alone (a lane group's lanes share
            # one registry, so a request's count must not take a
            # sibling's)
            self._host_sync_n = 0
            # the prefill family of the latest wave ("ragged" or
            # "bucketed") and the decode kernel, stamped on flight steps
            self._last_wave_kind: Optional[str] = None
            self._decode_kernel = decode_kernel_name(
                paged=paged is not None, chunked=chunked_fns is not None,
                quant=isinstance(self.cache, dict)
                and isinstance(self.cache.get("k"), QuantPool))
            # lane hooks (module docstring), set by a lane group and its
            # fleet: the lane index stamped on events, the sibling-session
            # probe, whether a decode session is running, the fleet role
            self.flight_shard: Optional[int] = None
            self.overlap_probe: Optional[Callable[[], bool]] = None
            self._lane_busy = False
            self._role: Optional[str] = None
            # the longest step so far (admission + the iteration's decode: a
            # chunk, or a resident session, which beats after every chunk)
            self.max_step_s = 0.0
            # the device-time profiler's lane (the shared NullLane under
            # SWARMDB_PROFILE=0), and the prefill waves whose timing events
            # the host has not read yet: (key, t0_ns, start, end), read at
            # the next host wait once complete
            self._prof = kernel_profiler().lane()
            self._prof_waves: List[Tuple[str, int, Any, Any]] = []

            self._queue: List[Tuple[int, float, int, GenRequest]] = []  # heap
            self._admitting: set = set()
            self._cancel_pending: set = set()
            self._tiebreak = itertools.count()
            self._cv = make_condition("backend.engine.Engine._cv")
            self._stop = False
            self._thread: Optional[threading.Thread] = None
            # start / stop / restart, one at a time (a supervisor's restart
            # may race a caller's stop)
            self._lifecycle = make_rlock("backend.engine.Engine._lifecycle")
            self.total_generated = 0
            self.total_requests = 0

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        """Start the loop thread. On the card the kernels are built (or
        found built) first, so that no step spends a kernel build under
        the supervisor's in-step grace."""
        with self._lifecycle:
            if self._thread is not None:
                return
            if self._owner is not None and not self._owner.running:
                # a stopped program's workers are gone and new ones start
                # from nothing: so does this rank (its queue stays)
                with self._on_stream():
                    for i, slot in enumerate(self.slots):
                        if slot.active:
                            self._retire(i, "engine_restart")
                self._reset_state()
                self._pod_failed = None
                self._owner.respawn(self)
            if self.device.type == "cuda":
                from ..ops import build

                build.build_all()
            if self._owner is not None:
                self._owner.go()
            with self._cv:
                self._stop = False
            # the CPU intra-op thread count is per thread: the worker takes
            # the starting thread's (torch.set_num_threads there) instead
            # of one thread per core
            thread = threading.Thread(target=self._run, daemon=True,
                                      args=(torch.get_num_threads(),),
                                      name="swarmdb-torch-engine")
            thread.start()
            self._thread = thread

    def stop(self) -> None:
        with self._lifecycle:
            with self._cv:
                self._stop = True
                self._cv.notify_all()
            if self._thread is not None:
                self._thread.join(timeout=60)
                self._thread = None
            # release the workers blocked in worker_loop's receive
            mh, self._mh = self._mh, None
            if self._owner is not None:
                # and end them and the process group: they were ours
                self._owner.close(mh)
            elif mh is not None:
                try:
                    mh.publish_stop()
                except Exception:
                    logger.exception("pod stop broadcast failed")

    def alive(self) -> bool:
        """True while the decode loop thread is running. One read of the
        thread: ``stop()`` may clear it between two (then ``None``'s
        ``is_alive`` raised in the supervisor's watch)."""
        thread = self._thread  # swarmlint: disable=SWL303 -- one reference read, atomic; the lock would make the supervisor's poll wait out a 60 s stop
        return thread is not None and thread.is_alive()

    def restart(self) -> None:
        """Recover a dead or failing loop: stop it, fail every request
        (active, admitting and queued) with retryable "engine_restart",
        rebuild the cache or pool, the page tables, the prefix cache, the
        fed tokens and the backpressure state, and start again. A replayed
        request then starts from nothing a lost one left behind.

        A single program that spawned its workers (``parallel/local.py``)
        restarts as the JAX package's one-process engine does: its
        workers are ended and new ones spawned on a new process group
        (``start`` after ``stop`` does it), this rank's state rebuilt.
        Refused in a pod launched from outside, as in the JAX package's
        multi-host mode: the workers cannot be told to rebuild their
        shares, so a local restart would silently desynchronise the pod;
        such a pod recovers by restarting its processes."""
        if self._owner is None and (self._mh is not None
                                    or self._pod_failed is not None):
            raise RuntimeError(
                "a pod engine cannot restart in place; restart the pod's "
                "processes (worker state cannot be rebuilt remotely)")
        with self._lifecycle:
            self.stop()
            self.metrics.counters["engine_restarts"].inc()
            self.flight.record_event({"kind": "engine.restart",
                                      "shard": self.flight_shard})
            self.flight.auto_dump("engine_restart", self._flight_dir)
            with self._on_stream():
                # retirement callbacks (a kept request's pages) may copy
                # from the pool: on this engine's stream, as in the loop
                self._fail_all("engine_restart")
            if self._owner is None:
                # (an owned program's start rebuilds it with its workers)
                self._reset_state()
            self.start()

    def warmup(self) -> float:
        """Prepare every decode variant the loop can hit, before traffic
        (``ServingService.start`` with ``SWARMDB_PREWARM=1``, as the JAX
        package's warmup compiles its decode variants): on the card, build
        the kernels and capture the three sampling variants' chunk graphs;
        on the CPU, where chunks run eagerly, there is nothing to prepare.
        Either way the device-time profiler's lane is suspended meanwhile
        (captures and builds are not device time; resuming re-anchors the
        lane's duty cycle at serving start) and its cost facts are
        harvested here, the one place ``profile_harvest`` runs. Call it on
        an idle engine, before ``start``. Returns the seconds spent."""
        if self._thread is not None or self._any_active():
            raise RuntimeError("warmup needs an idle engine, before start()")
        t0 = time.perf_counter()
        self._prof.suspend()
        try:
            if self.device.type == "cuda":
                from ..ops import build

                # before the harvest: the variants' meta carries the
                # builds' ptxas facts
                build.build_all()
            if not isinstance(self._prof, NullLane):
                self.profile_harvest()
            if (self.device.type == "cuda" and self._graphs
                    and self._role_warms_decode()):
                with self._on_stream():
                    self._runner.capture_all()
        finally:
            self._prof.resume()
        return time.perf_counter() - t0

    # ------------------------------------------------------------- pod mode
    # A pod (parallel/multihost.py): rank 0's engine owns the queue, the
    # scheduler, the allocator and the tokenizer and publishes each device
    # call before issuing it; every other rank's engine replays them in
    # worker_loop. The decode chunk (OP_DECODE: K single steps, or the
    # chunk forward and its merge) and the dense bucketed prefill
    # (OP_PREFILL) have records of their own; the paged engine's device
    # calls go through _mirrored (OP_CALL). Slot state is reset only by a
    # restart, so no other call is mirrored: a pod launched from outside
    # refuses one, and a program that spawned its workers
    # (parallel/local.py) replaces them instead, new workers starting
    # from the state this rank's reset rebuilds.

    def enable_multihost(self) -> None:
        """Publish every device call to the pod's workers (coordinator
        side, in a process group: ``init_distributed``, or the one a
        single program over several devices of one process made for its
        workers, whose build calls this). A dense engine's prefix lane
        and a paged engine's ragged waves are not mirrored: a pod engine
        has neither (``parallel.serving.build_serving_engine`` builds it
        so)."""
        from ..parallel.multihost import ControlPlane, pod_axis

        if self.paged is None and self._prefix is not None:
            raise ValueError("a dense pod engine has no prefix cache (build "
                             "it with parallel.serving.build_serving_engine)")
        if self._ragged:
            raise ValueError("a paged pod engine prefills in bucketed and "
                             "prefix waves: its ragged waves are not "
                             "mirrored (SWARMDB_RAGGED_PREFILL=0)")
        self._mh = ControlPlane(self.max_batch, pod_axis(self.device))

    def worker_loop(self) -> None:
        """Run on every rank but the coordinator: replay its device calls
        in order until it publishes stop. The state must start identical
        on every rank (``build_serving_engine`` draws, or restores, the
        same weights everywhere); each call then leaves it identical. A
        chunk's block is read back here (the worker's one wait per chunk)
        and kept in ``block_log`` when that is a list. Raises when a
        collective fails (the coordinator died, or the group's timeout
        passed)."""
        from ..parallel import multihost as mh

        if self._thread is not None:
            raise RuntimeError("worker_loop runs instead of start()")
        plane = self._mh or mh.ControlPlane(self.max_batch,
                                            mh.pod_axis(self.device))
        self._mh = None   # a worker publishes nothing
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.no_grad(), self._on_stream():
            while True:
                op, args = plane.receive()
                if op == mh.OP_STOP:
                    return
                if op == mh.OP_BEAT:
                    continue
                if op == mh.OP_DECODE:
                    out = self._launch(args[0], args[1:])
                    block, _lps = out.host()
                    if self.block_log is not None:
                        self.block_log.append(block)
                elif op == mh.OP_CALL:
                    self._replay_call(args[0], args[1:])
                else:   # OP_PREFILL (receive raises on any other op)
                    self._prefill_dense(*args)

    # The paged engine's mirrored device calls, with the JAX engine's ids.
    # Each handler takes host arrays alone (global slot and page ids) and
    # the rank's device state, never the coordinator's allocator or prefix
    # table, so a worker replaying it reproduces its rank's share of the
    # coordinator's state. Ids 2 (a rolling resume), 4 (the dense prefix
    # lane) and 6 (a ragged wave) have no handler: no pod engine makes
    # them.
    CALL_PAGED_PREFILL = 0
    CALL_PAGED_PREFIX_PREFILL = 1
    CALL_SET_PT_ROWS = 3
    CALL_PAGED_PREFILL_PACKED = 5
    _UNMIRRORED = {
        2: "the rolling resume prefill (rolling is off in a pod)",
        4: "the dense prefix prefill (a pod engine has no dense prefix "
           "lane)",
        6: "the ragged prefill (off in a pod and on a sharded pool)",
    }

    # swarmlint: borrows[page]: args
    # swarmlint: hot
    def _mirrored(self, call_id: int, *args) -> None:
        """Publish (pod mode) then run one mirrored device call. Publish
        first, as the decode and the dense prefill do: if the local call
        raises, the pod is already failing through the loop's pod-fatal
        stop."""
        if self._mh is not None:
            self._mh.publish_call(call_id, args)
        self._MH_CALLS[call_id](self, *args)

    def _replay_call(self, call_id: int, args: List[np.ndarray]) -> None:
        """A worker's side of ``_mirrored``."""
        fn = self._MH_CALLS.get(call_id)
        if fn is None:
            why = self._UNMIRRORED.get(call_id, "an unknown call")
            raise ValueError(f"mirrored call {call_id}, {why}, cannot "
                             "arise on a pod engine")
        fn(self, *args)

    # swarmlint: hot
    def _call_paged_prefill(self, tokens, lengths, target, scatter, keys,
                            temp, topk, topp) -> None:
        """A bucketed paged wave: the forward into a temp cache, its whole
        pages into ``target`` (a row's page per chunk, trash 0 past its
        pages), the first samples into the fed tokens."""
        last, kv = self._prefill_forward(tokens, lengths)
        self._insert_target(kv, target)
        self._sample_into_slots(last, (keys, temp, topk, topp),
                                self._tensor(lengths - 1), scatter)

    # swarmlint: hot
    def _call_paged_prefill_packed(self, tokens, lengths, target, scatter,
                                   keys, temp, topk, topp) -> None:
        """A packed wave over a sharded pool (``_pack_wave``): this rank
        runs its own block of rows as a bucketed wave on its sub-pool."""
        per = tokens.shape[0] // self._data_axis.size
        mine = slice(self._data_axis.index * per,
                     (self._data_axis.index + 1) * per)
        self._call_paged_prefill(*(a[mine] for a in (
            tokens, lengths, target, scatter, keys, temp, topk, topp)))

    # swarmlint: hot
    def _call_paged_prefix_prefill(self, tokens, lengths, plens, table,
                                   target, scatter, keys, temp, topk,
                                   topp) -> None:
        """The paged prefix wave: the suffix forward reads the hit pages
        (``table``) in place, its whole pages go into ``target``, the
        first samples into the fed tokens. On a sharded pool a rank runs
        the rows of its own slots (their hits are its shard's pages), and
        with a MoE model its share of the wave (``_wave_rows``)."""
        kw = {}
        if self._sharded:
            n = len(scatter)
            rows, ids = self._wave_rows(scatter)
            if not rows.size:
                return
            tokens, lengths, plens, table, target, scatter, keys, temp, \
                topk, topp = (a[rows] for a in (
                    tokens, lengths, plens, table, target, scatter, keys,
                    temp, topk, topp))
            if ids is not None:
                # an uncounted row reads and writes trash, samples to the
                # sink
                idle = ids < 0
                scatter = np.where(idle, self.max_batch, scatter)
                plens = np.where(idle, 0, plens)
                table = np.where(idle[:, None], 0, table)
                target = np.where(idle[:, None], 0, target)
                kw["rows"] = (self._tensor(ids), n)
        lengths_t, plens_t = self._tensor(lengths), self._tensor(plens)
        logits, sk, sv = self._prefix_pages_fwd(
            self.params, self._tensor(tokens),
            self._tensor(self._localize(table)), plens_t, self.cache["k"],
            self.cache["v"], logits_at=lengths_t - 1, **kw)
        self._insert_target((sk, sv), target)
        self._sample_into_slots(logits, (keys, temp, topk, topp),
                                plens_t + lengths_t - 1, scatter)

    # swarmlint: hot
    def _call_set_pt_rows(self, rows, vals) -> None:
        """Page-table rows by slot (admission assigns, retirement zeroes):
        a sharded rank writes its own slots' rows, localized."""
        own = self._own_rows(rows)
        set_page_table_rows(self.cache["page_table"],
                            self._local_slots(np.asarray(rows)[own]),
                            self._localize(np.asarray(vals)[own]))

    _MH_CALLS = {
        CALL_PAGED_PREFILL: _call_paged_prefill,
        CALL_PAGED_PREFIX_PREFILL: _call_paged_prefix_prefill,
        CALL_SET_PT_ROWS: _call_set_pt_rows,
        CALL_PAGED_PREFILL_PACKED: _call_paged_prefill_packed,
    }

    def _pod_fatal(self, exc: BaseException) -> None:
        """A failed step in pod mode stops the pod: the workers may have
        run a call this rank did not finish, so nothing can continue in
        step. Its requests already failed; later submits raise. The
        workers are told to stop when they can still hear it (a dead
        peer makes the broadcast fail too)."""
        logger.error("pod engine failure is fatal; stopping the pod's "
                     "decode program")
        self._pod_failed = f"{type(exc).__name__}: {exc}"
        self.flight.record_event({"kind": "engine.pod_fatal",
                                  "error": self._pod_failed})
        with self._cv:
            self._stop = True
        mh, self._mh = self._mh, None
        try:
            mh.publish_stop()
        except Exception:
            logger.exception("pod stop broadcast failed")
        self._fail_all("engine_error")

    def profile_harvest(self) -> int:
        """Register every dispatchable variant's cost facts (FLOPs, bytes,
        ``obs/cost.py``) with the process profiler -- warmup only. Lane
        groups share the registry: the first lane to harvest a variant
        covers its siblings. Returns the number of variants harvested."""
        prof = kernel_profiler()
        if self.device.type == "cuda":
            prof.set_platform("gpu", torch.cuda.get_device_name(self.device))
        else:
            prof.set_platform(self.device.type, "")
        harvested = 0
        for key, cost, meta in self._prof_plan():
            if prof.harvested(key):
                continue
            prof.record_variant(key, cost and cost["flops"],
                                cost and cost["bytes"], meta)
            harvested += 1
        return harvested

    def _prof_plan(self) -> List[Tuple[str, Optional[Dict[str, int]],
                                       Dict[str, Any]]]:
        """(key, cost or None, meta) of every variant this engine can
        dispatch: the families and shapes of the JAX engine's warmup plan
        (``warmup_call_plan`` through ``_prof_families``). Decode chunks
        (and paged resident sessions) per sampling variant; ragged waves
        per width, or row-bucketed waves per (rows, bucket); prefix and
        resume waves per (rows, bucket, prefix width). A fleet prefill
        lane has no decode side, a decode lane no admission side but its
        resumes. Costs need ``model_config``."""
        cfg = self.model_config
        B, Bp, K = self.max_batch, self.prefill_batch, self.decode_chunk
        pb = next(iter(self.params["layers"].values())).element_size()
        kvt = self._kv_bytes_per_token()
        price = dict(bytes_per_param=pb, kv_bytes_per_token=kvt)

        def fwd(**kw):
            return (None if cfg is None
                    else prof_cost.forward_cost(cfg, **kw, **price))

        meta: Dict[str, Any] = {"kv_bytes_per_token": kvt}
        quant = False
        if self.paged is not None:
            quant = isinstance(self.cache["k"], QuantPool)
            meta["kv_dtype"] = "int8" if quant else next(
                k for k, v in KV_DTYPES.items()
                if v == pool_dtype(self.cache["k"]))
        plan: List[Tuple[str, Optional[Dict[str, int]], Dict[str, Any]]] = []
        if self._role_warms_decode():
            cost = None if cfg is None else prof_cost.decode_chunk_cost(
                cfg, rows=B, steps=K, ctx=self.max_seq, **price)
            keys = PROF_DECODE_KEYS + (PROF_RESIDENT_KEYS if self._resident
                                       else ())
            kmeta = self._kernel_meta(self._decode_kernel)
            for key in keys:
                plan.append((key, cost, dict(meta, **kmeta)))
        warms_prefill = self._role != "decode"
        if self.paged is not None and self._ragged and warms_prefill:
            kmeta = self._kernel_meta(
                "ragged_prefill_quant" if quant else "ragged_prefill")
            for wd in self._ragged_widths:
                plan.append((prof_key("prefill.ragged", (wd,)),
                             fwd(rows=1, tokens=wd, head_rows=B,
                                 ragged=True),
                             dict(meta, **kmeta)))
        for bucket in self.prefill_buckets:
            if not warms_prefill:
                break
            if self.paged is None:
                plan.append((prof_key("prefill.dense", (Bp, bucket)),
                             fwd(rows=Bp, tokens=bucket, head_rows=Bp),
                             dict(meta)))
            elif self._sharded:
                # the rows one rank runs of a packed wave
                per = self._packed_rows()
                plan.append((prof_key("prefill.packed",
                                      (per * self._data_axis.size, bucket)),
                             fwd(rows=per, tokens=bucket, head_rows=per),
                             dict(meta)))
            elif not self._ragged:
                for rb in self._row_buckets:
                    plan.append((prof_key("prefill.paged", (rb, bucket)),
                                 fwd(rows=rb, tokens=bucket, head_rows=rb),
                                 dict(meta)))
        if self._prefix is None:
            return plan
        ps = self._prefix_ps
        for bucket in self.prefill_buckets:
            for ppb in self._prefix_pp_buckets:
                if self.paged is None:
                    if warms_prefill:
                        plan.append((
                            prof_key("prefill.dense_prefix", (Bp, bucket),
                                     ppb),
                            fwd(rows=Bp, tokens=bucket, prefix=ppb * ps,
                                head_rows=Bp), dict(meta)))
                    continue
                if not self._ragged and warms_prefill:
                    for rb in self._row_buckets:
                        plan.append((
                            prof_key("prefill.paged_prefix", (rb, bucket),
                                     ppb),
                            fwd(rows=rb, tokens=bucket, prefix=ppb * ps,
                                head_rows=rb), dict(meta)))
                if self._warm_resume():
                    plan.append((
                        prof_key("prefill.resume", (Bp, bucket), ppb),
                        fwd(rows=Bp, tokens=bucket, prefix=ppb * ps,
                            head_rows=Bp), dict(meta)))
        return plan

    def _kernel_meta(self, kernel: str) -> Dict[str, Any]:
        """A variant's kernel (a ``build.KERNELS`` name) and, on the card,
        its build's ptxas facts for the instances at this engine's head
        dim and page type (``ops.build.ptxas_info``: registers, spill
        stores and loads, stack, static shared memory), under
        ``"ptxas"``."""
        meta: Dict[str, Any] = {"kernel": kernel}
        if self.device.type != "cuda":
            return meta
        from ..ops import build

        k = self.cache["k"] if self.paged is not None else self.cache[0]
        data = pool_data(k)
        page = build.PAGE_TYPES[str(data.dtype).removeprefix("torch.")]
        meta["ptxas"] = [
            {f: r[f] for f in ("instance", "regs", "spill_stores",
                               "spill_loads", "stack", "smem_static")}
            for r in build.ptxas_instances(kernel, page, data.shape[-1])]
        return meta

    def _warm_resume(self) -> bool:
        """Whether the resume waves are in the profiler's plan: the JAX
        engine's gate (a paged engine with the pages forward, under
        ``SWARMDB_ROLLING_KV=1`` or on a fleet decode lane, whose
        admission path is the resume)."""
        if self._role == "prefill":
            return False
        return (self.paged is not None
                and self._prefix_pages_fwd is not None
                and (os.environ.get("SWARMDB_ROLLING_KV") == "1"
                     or self._role == "decode"))

    def _kv_bytes_per_token(self) -> int:
        """Device bytes of one token's K and V across layers (scale rows
        included for an int8 pool)."""
        if self.paged is not None:
            return ((pool_page_bytes(self.cache["k"])
                     + pool_page_bytes(self.cache["v"]))
                    // self.paged.page_size)
        k, v = self.cache
        per_slot_pos = k.shape[1] * k.shape[2]
        return (k.numel() * k.element_size()
                + v.numel() * v.element_size()) // per_slot_pos

    def _role_warms_decode(self) -> bool:
        """Whether warmup captures the decode graphs: not on a fleet
        prefill lane, which decodes only what a quarantined decode pool
        leaves it (captured at first use then). The prefill waves are
        eager, so there is no prefill side to warm."""
        return self._role != "prefill"

    def _new_cache(self):
        if self.paged is not None:
            return self.paged.init_pool()
        return self._init_cache_fn(self._rows, self.max_seq)

    def _new_runner(self) -> ChunkRunner:
        """The decode chunks' runner over the engine's current tensors
        (its graphs are captured at first use); on a data axis it gathers
        every rank's block after each chunk."""
        return ChunkRunner(self._chunk_body, self._io,
                           ring=self.pipeline_depth, stream=self.stream,
                           graphs=self._graphs,
                           gather=(self._gather_block if self._data_axis
                                   else None), width=self.max_batch)

    def _gather_block(self, block: torch.Tensor, lps: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every data rank's [K+1, B/dp] block as the [K+1, B] block of all
        slots, in slot order: one all-gather of the tokens (their int32
        bits carried as float32) stacked with the logprobs."""
        both = torch.stack((block.view(torch.float32), lps))
        full = self._data_axis.gather_last(both)
        return full[0].contiguous().view(torch.int32), full[1]

    # ----------------------------------------------- the rank's own slots

    def _local_slots(self, slots: np.ndarray) -> np.ndarray:
        """Global slot ids as indices into this rank's device state; slots
        of other ranks and the discard sentinel (``max_batch``) map to
        the sink past them."""
        local = np.asarray(slots, np.int64) - self._lo
        return np.where((local >= 0) & (local < self._rows), local,
                        self._rows)

    def _own_rows(self, slots: np.ndarray) -> np.ndarray:
        """Indices of the wave rows whose slot is this rank's."""
        local = np.asarray(slots, np.int64) - self._lo
        return np.nonzero((local >= 0) & (local < self._rows))[0]

    def _wave_rows(self, scatter: np.ndarray
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """This data rank's rows of a global wave, and (``_count_rows``)
        their ids in the wave for the forward's ``rows``, else None. Its
        own slots' rows; when the forward counts the wave, also its share
        of the padding rows (the discard slot's, dealt round the data
        ranks), so that each row of the wave is run and counted by exactly
        one rank, and, on a rank left with none, one uncounted row (id -1,
        to be pointed at the sink and trash) so that it meets the wave's
        collectives."""
        rows = self._own_rows(scatter)
        if not self._count_rows:
            return rows, None
        ax = self._data_axis
        pad = np.nonzero(np.asarray(scatter) >= self.max_batch)[0]
        rows = np.sort(np.concatenate([rows, pad[ax.index::ax.size]]))
        if not rows.size:
            return np.zeros(1, np.int64), np.full(1, -1, np.int64)
        return rows, rows.astype(np.int64)

    def _localize(self, table: np.ndarray) -> np.ndarray:
        """Global page ids as this rank's sub-pool ids, the JAX package's
        ``clip(table - d * Pl, 0, Pl - 1)``: its own ids to [1, Pl),
        trash and zeroed entries to its trash page 0. Identity on one
        pool."""
        table = np.asarray(table, np.int32)
        if not self._sharded:
            return table
        pl = self.paged.allocator.pages_per_shard
        return np.clip(table - self._data_axis.index * pl, 0, pl - 1)

    def _own_pages(self, pages: List[int]) -> List[int]:
        """This rank's sub-pool ids of the pages of its shard in
        ``pages`` (all of them on one pool)."""
        if not self._sharded:
            return list(pages)
        alloc = self.paged.allocator
        mine = [p for p in pages
                if alloc.shard_of_page(p) == self._data_axis.index]
        return self._localize(np.asarray(mine, np.int32)).tolist()

    def _chunk_body(self, variant: int) -> None:
        """The decode chunk over the engine's state: what every graph
        captures, and what the CPU runs."""
        decode_chunk(self.params, self.cache, self._io, variant,
                     chunked_fns=self._chunked_fns, chunk_kv=self._chunk_kv,
                     decode_forward=self._decode_forward)

    def _reset_state(self) -> None:
        """Rebuild the device state on the engine's stream, holding the
        device's graph lock: dropping the runner destroys its graphs,
        which must not happen inside a sibling lane's capture. The
        allocator's reset tells the page sanitizer the pool was rebuilt
        (every page free, no stamps, no poison)."""
        with device_lock(self.device), self._on_stream():
            self._rebuild_state()

    def _rebuild_state(self) -> None:
        # the pool generation moves first: a rolling plan racing the
        # rebuild reads the new epoch and fails closed ("stale_resume"),
        # never the old epoch over a rebuilt pool
        if self.paged is not None:
            self.paged.allocator.reset()
        if self._prefix is not None:
            self._prefix.reset()
            if self.paged is None:
                self._prefix_pool = self._prefix_init_pool(
                    self._prefix_num_pages, self._prefix_ps)
        self.cache = self._new_cache()
        # the graphs read the old cache: capture again at next use
        self._runner = self._new_runner()
        self._promote_sources.clear()
        self._slot_prefix_pins.clear()
        self._last_tokens.zero_()
        self._last_lps.zero_()
        self._bp_paused = False
        if self._chunk_kv is not None:
            for t in self._chunk_kv:
                t.zero_()

    # ------------------------------------------------------ rolling KV
    # The service's rolling registry holds page custody between turns;
    # these hide which pool the pages come from (the paged engine's pool,
    # or the dense engine's prefix side pool).

    def pool_epoch(self) -> int:
        """Epoch of page ids held outside the engine: the pool's own
        generation, bumped by every reset (restart and error recovery
        alike). Paged engines stamp the page allocator, dense ones the
        prefix side pool (where dense rolling custody comes from); an
        engine with neither has no page ids to hold."""
        if self.paged is not None:
            return self.paged.allocator.generation
        if self._prefix is not None:
            return self._prefix.generation
        return self.metrics.counters["engine_restarts"].value

    def supports_rolling(self) -> bool:
        """A paged engine with the pages forward (its prefix cache on),
        or a dense one with its prefix side pool; never a pod's
        coordinator (it refuses keep and resume) nor a sharded pool (a
        kept conversation's pages would pin it to one shard)."""
        if self._mh is not None:
            return False
        if self.paged is not None:
            return self._prefix_pages_fwd is not None and not self._sharded
        return self._prefix is not None

    def rolling_page_size(self) -> int:
        return self.paged.page_size if self.paged is not None \
            else self._prefix_ps

    def rolling_free(self, pages) -> None:
        """Return registry-custody pages to their pool (the caller checks
        the epoch first)."""
        if self.paged is not None:
            self.paged.allocator.add_free(list(pages))
        else:
            for p in pages:
                self._prefix.release(p)

    def rolling_free_count(self) -> int:
        if self.paged is not None:
            return self.paged.allocator.free_count()
        return self._prefix.free_count()

    # ------------------------------------------------------------ requests

    def submit(self, request: GenRequest) -> str:
        """Thread-safe enqueue; returns the request id."""
        total = request.resume_len + len(request.prompt)
        if total >= self.max_seq:
            raise ValueError(f"prompt length {total} (resumed included) >= "
                             f"max_seq {self.max_seq}")
        if not request.prompt:
            raise ValueError("empty prompt")
        if self._pod_failed is not None:
            raise RuntimeError(f"the pod's decode program stopped: "
                               f"{self._pod_failed}")
        if self._mh is not None and (request.resume_pages is not None
                                     or request.keep_pages):
            # as in the JAX package: page custody lives in the serving
            # layer's registry, which a pod's restart-based recovery would
            # orphan, and the dense keep extraction is not mirrored
            raise ValueError("rolling-KV keep_pages and resume are not "
                             "supported in multi-host (pod) mode")
        if request.resume_pages is not None:
            if not self.supports_rolling():
                raise ValueError("resume_pages needs the rolling-KV "
                                 "machinery (a paged engine with its pages "
                                 "forward, or a dense one with the prefix "
                                 "cache)")
            if not request.resume_pages or request.resume_len <= 0:
                raise ValueError("resume needs pages and resume_len > 0")
            if len(request.resume_pages) > self._prefix_pp_buckets[-1]:
                raise ValueError(
                    f"{len(request.resume_pages)} resume pages exceed the "
                    f"widest prefix-gather bucket "
                    f"{self._prefix_pp_buckets[-1]}")
            ps = self.rolling_page_size()
            if -(-request.resume_len // ps) != len(request.resume_pages):
                raise ValueError("resume_pages must exactly cover "
                                 "resume_len")
            if (request.resume_epoch is not None
                    and request.resume_epoch != self.pool_epoch()):
                raise ValueError(
                    "stale resume epoch: the page pool was rebuilt since "
                    "these pages were planned (engine restart); the "
                    "conversation must restart fresh")
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

    def _on_stream(self) -> ContextManager:
        """Make the engine's stream current (a no-op off the card)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # swarmlint: hot
    def _run(self, cpu_threads: int) -> None:
        torch.set_num_threads(cpu_threads)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with self._on_stream():
            self._loop()

    # swarmlint: hot
    def _loop(self) -> None:
        # (block on its way, snapshot, dispatch stamp, profiler key) per
        # chunk in flight, oldest first
        in_flight: List[Tuple[ChunkOut, List[Tuple[int, GenRequest, int]],
                              int, Optional[str]]] = []
        with torch.no_grad():
            while True:
                self._in_step = False
                self._beat()
                mh = self._mh
                with self._cv:
                    while (not self._stop and not self._queue
                           and not self._any_active() and not in_flight
                           and not self._chaos_pending()
                           and not (mh is not None and mh.beat_due())):
                        # idle engines beat too, or the supervisor would
                        # read "no work" as "wedged"; an armed chaos fault
                        # leaves the wait to land at the seam below
                        self._beat()
                        self._cv.wait(timeout=0.25)
                    stopping = self._stop
                if not stopping and mh is not None and mh.beat_due():
                    # an idle pod coordinator keeps its workers' receive
                    # inside the process group's timeout
                    try:
                        mh.publish_beat()
                    except Exception as exc:
                        logger.exception("pod beat failed")
                        self._pod_fatal(exc)
                        return
                    continue
                if stopping:
                    # drain the chunks in flight so their requests
                    # complete, outside the lock: processing waits on the
                    # device and runs user callbacks, which may re-enter
                    # submit() or stop()
                    for entry in in_flight:
                        try:
                            self._process_block(*entry)
                        except Exception:
                            logger.exception("drain on stop failed")
                    in_flight.clear()
                    return
                cs = self.chaos_step
                if cs is not None:
                    # a kill raises a BaseException the handler below
                    # does not catch (the thread dies); a wedge blocks
                    # here, starving the beat
                    cs(self)
                self._in_step = True
                t_step = time.perf_counter()
                try:
                    self._admit()
                    if self._role == "prefill":
                        # a fleet prefill lane retires admission-only work
                        # off the prefill sample; decode never runs for it
                        self._drain_prefill_only()
                    if self._resident:
                        # a session runs chunks until its lanes finish or
                        # the host votes to stop; admission waits for its
                        # end. The flight step is taken after admission,
                        # before the session, as in the JAX package (a
                        # session's end is when occupancy is transiently
                        # low); once the session leaves no work, one more
                        # step settles the ring's counters
                        self._flight_step(0)
                        if self._any_active():
                            self._run_resident()
                            self._flight_step(0, settle=True)
                    else:
                        if self._any_active():
                            in_flight.append(self._dispatch_decode())
                        while in_flight and (
                                len(in_flight) >= self.pipeline_depth
                                or not self._any_active()):
                            self._process_block(*in_flight.pop(0))
                        self._flight_step(len(in_flight))
                    self.max_step_s = max(self.max_step_s,
                                          time.perf_counter() - t_step)
                    if self._bp_paused and not self._any_active():
                        # paused admission with nothing decoding: wait for
                        # a retirement, a heal or a submit instead of
                        # spinning through the gate
                        with self._cv:
                            self._cv.wait(timeout=0.01)
                except Exception as exc:
                    in_flight.clear()
                    logger.exception("engine step failed; failing active "
                                     "requests")
                    self.flight.record_event({"kind": "engine.error"})
                    if self._mh is not None:
                        self._pod_fatal(exc)
                        return
                    self._fail_all("engine_error")
                    try:
                        self._reset_state()
                    except Exception:
                        logger.exception("state rebuild failed; stopping")
                        with self._cv:
                            self._stop = True

    def _any_active(self) -> bool:
        return any(s.active for s in self.slots)

    # swarmlint: hot
    def _flight_step(self, in_flight_n: int, settle: bool = False) -> None:
        """One flight-recorder step per loop iteration that has work, as
        in the JAX engine: idle iterations are skipped, and the first one
        after work drains is recorded once, so the ring's last step holds
        the settled counters (a dump taken while idle matches the metrics
        registry). ``settle`` records only that trailing step: the
        resident loop calls it after a session, where the JAX loop, which
        records before sessions only, leaves the ring's last step short
        of the session's counters. Also the sentinel's window probe."""
        if self.sentinel is not None:
            self.sentinel.maybe_tick()
        with self._cv:
            queued = len(self._queue)
            by_prio: Dict[int, int] = {}
            for negp, _, _, _ in self._queue:
                by_prio[-negp] = by_prio.get(-negp, 0) + 1
        active = sum(1 for s in self.slots if s.active)
        has_work = bool(active or queued or in_flight_n)
        if settle and has_work:
            return
        if not has_work and not self._flight_last_had_work:
            return
        self._flight_last_had_work = has_work
        c = self.metrics.counters
        rec: Dict[str, Any] = {
            "ts": time.time(),
            "active": active,
            "max_batch": self.max_batch,
            "queued": queued,
            "queued_by_priority": by_prio,
            "in_flight_chunks": in_flight_n,
            # cumulative counters: deltas between steps place tokens,
            # padding and syncs in time
            "tokens_generated": c["tokens_generated"].value,
            "prompt_tokens": c["prompt_tokens"].value,
            "prefill_padding_tokens": c["prefill_padding_tokens"].value,
            "prefill_packed_tokens": c["prefill_packed_tokens"].value,
            "host_syncs": c["engine_host_syncs"].value,
            "restarts": c["engine_restarts"].value,
            # the JAX engine counts compiled executables here; the card's
            # counterpart is the captured decode graphs (a new one
            # mid-traffic is a capture that warmup did not take)
            "compiled_variants": len(self._runner.graphs),
        }
        if self._last_wave_kind is not None:
            rec["wave_kind"] = self._last_wave_kind
        rec["decode_kernel"] = self._decode_kernel
        if self._resident:
            # resident-loop steps sample occupancy right after admission:
            # the analyzer's admission-stall split trusts only these
            rec["occ_at_admit"] = True
        if self.flight_shard is not None:
            rec["shard"] = self.flight_shard
        if self._prefix is not None:
            ps = self._prefix.stats()
            rec["prefix_hit_tokens"] = ps["hit_tokens"]
            rec["prefix_miss_tokens"] = ps["miss_tokens"]
        if self._sharded:
            # per-shard occupancy: one starved or crowded shard shows here
            shard_of = self.paged.allocator.shard_of
            by_shard: Dict[int, int] = {}
            for i, s in enumerate(self.slots):
                if s.active:
                    by_shard[shard_of(i)] = by_shard.get(shard_of(i), 0) + 1
            rec["active_by_shard"] = by_shard
        self.flight.record_step(rec)

    # ------------------------------------------------- supervision signals

    # swarmlint: heartbeat
    def _beat(self) -> None:
        """Liveness proof: one monotonic read into a single-writer slot."""
        self._beat_mono = time.monotonic()

    # swarmlint: heartbeat
    def beat_age_s(self, now: float = 0.0) -> float:
        """Seconds since the loop last proved progress; only a dead or
        wedged loop lets it grow."""
        return (now or time.monotonic()) - self._beat_mono

    def _chaos_pending(self) -> bool:
        cs = self.chaos_step
        return cs is not None and getattr(cs, "pending", lambda: False)()

    # ------------------------------------------------------------- admission

    # swarmlint: hot
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

    # swarmlint: hot
    def _expire_deadlines(self) -> None:
        """Fail queued requests whose deadline has passed with the final
        reason "deadline"; an active request is never cut mid-stream (the
        supervisor cancels those)."""
        now = time.time()
        with self._cv:
            expired = [item[3] for item in self._queue
                       if item[3].deadline is not None
                       and now > item[3].deadline]
            if expired:
                gone = {r.request_id for r in expired}
                self._queue[:] = [it for it in self._queue
                                  if it[3].request_id not in gone]
                heapq.heapify(self._queue)
        for req in expired:
            self.metrics.counters["requests_deadline_expired"].inc()
            _call(req.on_done, req.request_id, [], "deadline")

    def _pool_headroom(self) -> float:
        """Fraction of the pool still claimable: free pages plus unpinned
        prefix-cache pages."""
        free = self.paged.allocator.free_count()
        if self._prefix is not None:
            free += self._prefix.evictable_count()
        return min(1.0, free / max(1, self.paged.num_pages - 1))

    # swarmlint: hot
    def _backpressure_gate(self) -> bool:
        """Watermark hysteresis over pool utilisation; True when admission
        may proceed. Past the demote watermark the tier manager is
        signalled (until utilisation falls back to the low watermark);
        paused, the pool-pressure hook may evict idle conversations, and
        past the shed watermark the lowest-priority queued class is
        returned with retryable reason "shed"."""
        if self._bp_high >= 1.0:
            return True
        util = 1.0 - self._pool_headroom()
        cap = max(1, self.paged.num_pages - 1)
        if self.on_tier_pressure is not None and self._bp_demote < 1.0:
            if self._tier_demoting:
                if util <= self._bp_low:
                    self._tier_demoting = False
            elif util >= self._bp_demote:
                self._tier_demoting = True
                self.flight.record_event({"kind": "tier.pressure",
                                          "util": round(util, 3),
                                          "shard": self.flight_shard})
                self.tracer.instant("tier.pressure", cat="engine",
                                    args={"util": round(util, 3)})
            if self._tier_demoting:
                try:
                    self.on_tier_pressure(
                        max(1, int((util - self._bp_low) * cap)))
                except Exception:
                    logger.exception("tier-pressure callback failed")
        if self._bp_paused:
            if util <= self._bp_low:
                self._bp_paused = False
                self.metrics.counters["engine_admission_resumed"].inc()
                self.flight.record_event(
                    {"kind": "pool.backpressure_resumed",
                     "util": round(util, 3), "shard": self.flight_shard})
                return True
        elif util >= self._bp_high:
            self._bp_paused = True
            self.metrics.counters["engine_admission_paused"].inc()
            self.flight.record_event(
                {"kind": "pool.backpressure_paused",
                 "util": round(util, 3), "shard": self.flight_shard})
            self.tracer.instant("pool.backpressure", cat="engine",
                                args={"util": round(util, 3)})
        if not self._bp_paused:
            return True
        if self.on_pool_pressure is not None:
            try:
                self.on_pool_pressure(max(1, int((util - self._bp_low) * cap)))
            except Exception:
                logger.exception("pool-pressure callback failed")
        if util >= self._bp_shed:
            self._shed_lowest()
        return False

    # swarmlint: hot
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
            self.flight.record_event(
                {"kind": "pool.request_shed", "rid": req.request_id,
                 "priority": req.priority, "shard": self.flight_shard})
            _call(req.on_done, req.request_id, [], "shed")

    # swarmlint: hot
    def _admit(self) -> None:
        """Move queued requests into free slots (highest priority first),
        up to ``prefill_batch`` per round, and prefill them."""
        self._age_queue()
        self._expire_deadlines()
        if self.paged is None:
            self._admit_dense()
        else:
            self._admit_paged()

    # swarmlint: hot
    def _admit_paged(self) -> None:
        """Paged admission rounds. A request whose pages the pool cannot
        cover stops the round (no skip-ahead: long prompts do not starve
        behind short ones); the pool-pressure hook then gets one call per
        round to evict idle rolling conversations. A rolling resume
        references its kept pages and takes fresh pages for the rest; one
        planned against an older pool epoch fails "stale_resume" here."""
        alloc = self.paged.allocator
        # reclaim retired slots' pages: zero their table rows on device
        # first, then return the pages (a stale row never sees reuse)
        pending = alloc.take_pending_frees()
        if pending:
            freed_pages: List[int] = []
            if self._pagecheck is not None:
                for sid in pending:
                    freed_pages.extend(alloc.pages_for(sid))
            try:
                self._mirrored(self.CALL_SET_PT_ROWS,
                               np.asarray(pending, np.int32),
                               np.zeros((len(pending), alloc.maxp),
                                        np.int32))
            except Exception:
                alloc.requeue_pending(pending)
                raise
            alloc.release_taken(pending)
            if freed_pages:
                self._pagecheck_poison(freed_pages)
        self._promote_sources = [(ev, src) for ev, src
                                 in self._promote_sources if not ev.query()]
        if self.on_tier_drain is not None:
            # the tier worker's planned demotions, on this thread
            try:
                self.on_tier_drain()
            except Exception:
                logger.exception("tier drain failed")
        if not self._backpressure_gate():
            return
        pressure_called = False
        while True:
            popped: List[GenRequest] = []
            rows: List[Tuple[int, np.ndarray]] = []
            plans: Dict[int, Tuple[List[int], Optional[List[bytes]]]] = {}
            stale: List[GenRequest] = []
            pressure_need = 0
            with self._cv:
                free = self._free_slot_ids()
                take = min(len(free), len(self._queue), self.prefill_batch)
                if take == 0:
                    return
                while free and self._queue and len(popped) < take:
                    req = self._queue[0][3]
                    if (req.resume_pages is not None
                            and req.resume_epoch is not None
                            and req.resume_epoch != alloc.generation):
                        # the pool was reset while it sat queued: its
                        # page ids belong to others now (no slot used)
                        heapq.heappop(self._queue)
                        stale.append(req)
                        continue
                    slot_id, hinted = self._slot_for(req, free)
                    hits: List[int] = []
                    chains: Optional[List[bytes]] = None
                    if req.resume_pages is not None:
                        # kept pages referenced in place (registry
                        # custody); fresh pages past resume_len only
                        worst = min(alloc.max_seq,
                                    req.resume_len + len(req.prompt)
                                    + req.sampling.max_new_tokens
                                    + self.decode_chunk)
                        n_fresh = max(0, -(-worst // self.paged.page_size)
                                      - len(req.resume_pages))
                        row = alloc.allocate_with_prefix(
                            slot_id, req.resume_pages, n_fresh)
                        if row is None:
                            pressure_need = n_fresh
                            break
                    else:
                        need = alloc.pages_needed(len(req.prompt),
                                                  req.sampling.max_new_tokens,
                                                  self.decode_chunk)
                        # a keep_pages (rolling) request bypasses the hash
                        # prefix cache both ways: a hit would reference
                        # cache pages retirement cannot hand over, and
                        # registration would take the slot's own pages
                        for attempt in range(2):
                            hits, chains = [], None
                            if (self._prefix is not None
                                    and len(req.prompt) >= self._prefix_ps
                                    and not req.keep_pages):
                                hits, chains = self._prefix_plan(req.prompt,
                                                                 pin=True)
                                # a sharded pool: a slot references only
                                # its own shard's pages
                                keep = alloc.usable_prefix(slot_id, hits)
                                if keep < len(hits):
                                    self._prefix.unpin(hits[keep:])
                                    hits = hits[:keep]
                            row = self._paged_allocate(
                                slot_id, hits, max(0, need - len(hits)))
                            if row is not None:
                                break
                            if hits:
                                self._prefix.unpin(hits)
                            # a shard hint is advisory: a shard that cannot
                            # cover the request must not block the queue,
                            # so retry once on the free slot of the most
                            # free pages (the JAX engine's fallback)
                            others = [i for i in free if i != slot_id]
                            if attempt or not hinted or not others:
                                break
                            slot_id = max(others, key=alloc.free_count)
                        if row is None:
                            pressure_need = max(0, need - len(hits))
                            break  # pool exhausted; retry after retirements
                    heapq.heappop(self._queue)
                    free.remove(slot_id)
                    self._admitting.add(req.request_id)
                    popped.append(req)
                    rows.append((slot_id, row))
                    plans[slot_id] = (hits, chains)
            # outside the lock: the callbacks and the pressure hook may
            # re-enter submit() or take the service's locks
            for req in stale:
                self.metrics.counters["engine_stale_resumes"].inc()
                _call(req.on_done, req.request_id, [], "stale_resume")
            if not popped:
                if (pressure_need > 0 and not pressure_called
                        and self.on_pool_pressure is not None):
                    # one eviction attempt per round, then wait for
                    # retirements as before
                    pressure_called = True
                    try:
                        self.on_pool_pressure(pressure_need)
                    except Exception:
                        logger.exception("pool-pressure callback failed")
                    continue
                if stale:
                    continue  # the stale pops may have unblocked the head
                return
            if self._pagecheck is not None:
                # stamp owners, then verify the canary of every re-
                # allocated page: an overwritten canary is a write landed
                # between free and re-allocation
                for (sid, _row), req in zip(rows, popped):
                    self._pagecheck_admit(sid, req)
            self._mirrored(self.CALL_SET_PT_ROWS,
                           np.asarray([r[0] for r in rows], np.int32),
                           np.stack([r[1] for r in rows]))
            for req in popped:
                if req.promote_payload is not None:
                    self._promote_insert(req)
            batch = [(sid, req) + plans[sid] + (row,)
                     for (sid, row), req in zip(rows, popped)]
            for key, group in self._paged_groups(batch):
                try:
                    if key == "ragged":
                        self._prefill_ragged_waves(group)
                    elif isinstance(key, tuple) and key[0] == "resume":
                        self._prefill_paged_resume_batch(group, *key[1:])
                    elif isinstance(key, tuple):
                        self._prefill_paged_prefix_batch(group, *key[1:])
                    else:
                        self._prefill_batch(group)
                except Exception:
                    # off the queue and not in slots: fail them here or
                    # their on_done never fires
                    logger.exception("prefill failed for %s",
                                     [b[1].request_id for b in group])
                    for slot_id, req, hits, _chains, _row in group:
                        with self._cv:
                            self._admitting.discard(req.request_id)
                            self._cancel_pending.discard(req.request_id)
                        alloc.mark_retired(slot_id)
                        pins = (self._slot_prefix_pins.pop(slot_id, None)
                                or hits)
                        if pins:
                            self._prefix.unpin(pins)
                        _call(req.on_done, req.request_id, [],
                              "engine_error")
                    if self._mh is not None:
                        # pod mode: the workers may have applied a call
                        # this rank did not finish -- the loop's pod-fatal
                        # stop, as on the dense path
                        raise

    # swarmlint: hot
    def _free_slot_ids(self) -> List[int]:
        """The free slots in admission order: id order on one pool; on a
        sharded pool interleaved across the shards, rotated by an
        admission counter, so that light or serial traffic spreads over
        the sub-pools instead of piling onto shard 0's."""
        free = [i for i, s in enumerate(self.slots) if not s.active]
        if not free or not self._sharded:
            return free
        alloc = self.paged.allocator
        by_shard: Dict[int, List[int]] = {}
        for i in free:
            by_shard.setdefault(alloc.shard_of(i), []).append(i)
        lanes = list(by_shard.values())
        rot = self._admit_rr % len(lanes)
        self._admit_rr += 1
        lanes = lanes[rot:] + lanes[:rot]
        return [lane[k] for k in range(max(map(len, lanes)))
                for lane in lanes if k < len(lane)]

    def _slot_for(self, req: GenRequest, free: List[int]
                  ) -> Tuple[int, bool]:
        """(the free slot a request takes, whether a hint chose its
        shard): on a sharded pool a slot of the shard its hint names
        (``shard_hint``, or for a prompt the prefix cache may match, a
        stable hash of its first page, so identical prefixes meet on one
        shard), when that shard has one free; else the first free
        slot."""
        if not self._sharded:
            return free[0], False
        hint = req.shard_hint
        if (hint is None and self._prefix is not None
                and len(req.prompt) >= self._prefix_ps
                and not req.keep_pages):
            hint = zlib.crc32(np.asarray(req.prompt[:self._prefix_ps],
                                         np.int32).tobytes())
        if hint is None:
            return free[0], False
        alloc = self.paged.allocator
        want = hint % alloc.n_shards
        return next((sid for sid in free if alloc.shard_of(sid) == want),
                    free[0]), True

    def _paged_groups(self, batch: List[Tuple]) -> List[Tuple[Any, List]]:
        """A paged round's prefill waves, as the JAX engine's ``_admit``
        groups them. Rolling resumes go to resume waves, one per suffix
        bucket (``("resume", bucket, prefix width)``: a one-turn delta is
        not padded to a long straggler's bucket). The rest go into ragged
        waves; or, without them, the rows with a prefix plan (prompts of a
        page or more, prefix cache on, no keep_pages) into ONE prefix wave
        padded to the round's largest (suffix bucket, prefix width) and
        the others into one bucketed wave per bucket (keyed by the
        bucket). ``batch`` rows: (slot_id, req, hits, chains,
        table_row)."""
        groups: Dict[Any, List[Tuple]] = {}
        prefix: List[Tuple] = []
        resume: Dict[int, List[Tuple]] = {}
        rest: List[Tuple] = []
        max_suffix = max_hits = 0
        for item in batch:
            _sid, req, hits, chains, _row = item
            if req.resume_pages is not None:
                resume.setdefault(self._bucket_for(max(1, len(req.prompt))),
                                  []).append(item)
            elif self._ragged:
                rest.append(item)
            elif chains is None:
                groups.setdefault(self._bucket_for(len(req.prompt)),
                                  []).append(item)
            else:
                prefix.append(item)
                max_suffix = max(max_suffix,
                                 len(req.prompt) - len(hits) * self._prefix_ps)
                max_hits = max(max_hits, len(hits))
        if prefix:
            groups[("prefix", self._bucket_for(max(1, max_suffix)),
                    self._pp_bucket_for(max(1, max_hits)))] = prefix
        for bucket, items in resume.items():
            width = max(max(1, len(it[1].resume_pages)) for it in items)
            groups.setdefault(("resume", bucket, self._pp_bucket_for(width)),
                              []).extend(items)
        if rest:
            groups["ragged"] = rest
        return list(groups.items())

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
            # a sharded pool: only the slot's shard's free pages count, and
            # only its cached pages are worth evicting
            shortfall = n_fresh - alloc.free_count(slot_id)
            if shortfall > 0:
                evicted = self._prefix.evict_lru(
                    shortfall, want=alloc.evictable(slot_id))
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

    def _rows_sampling(self, gather: np.ndarray) -> Tuple[np.ndarray, ...]:
        """The sampling params of the slots ``gather`` names, one row each:
        (keys int64 [R, 2], temperature, top-k, top-p)."""
        return (self._base_keys_np[gather].astype(np.int64),
                self._temp[gather], self._topk[gather], self._topp[gather])

    def _sample_into_slots(self, logits: torch.Tensor,
                           sampling: Tuple[np.ndarray, ...],
                           fold_pos: torch.Tensor, scatter: np.ndarray
                           ) -> None:
        """Sample each wave row's first token from its [R, V] logits with
        its row's ``sampling`` (``_rows_sampling``) and key folded at
        ``fold_pos`` (the absolute position of its last prompt token, so a
        cached prefix samples as a full prefill would), then scatter token
        and logprob into the fed-token vectors at ``scatter``
        (``max_batch`` = the sink: rows that do not sample, padding; on a
        data axis, rows of other ranks' slots too)."""
        keys, temp, topk, topp = sampling
        nxt = sample_tokens(logits, self._tensor(keys), fold_pos,
                            self._tensor(temp), self._tensor(topk),
                            self._tensor(topp))
        lp = token_logprob(logits, nxt)
        scatter_t = self._tensor(self._local_slots(scatter))
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

    # swarmlint: hot
    def _admit_dense(self) -> None:
        """Dense admission rounds of up to ``prefill_batch`` requests into
        free slots. Prompts of at least one page take the prefix path even
        on a full miss, so that their pages are registered for the next
        turn: ONE fused suffix prefill per round, padded to the round's
        largest (suffix bucket, prefix width); shorter prompts prefill in
        one bucketed wave per bucket; rolling resumes in one wave per
        suffix bucket, their kept side-pool pages composed into the lane.
        A resume planned against an older pool epoch fails
        "stale_resume"."""
        ps = self._prefix_ps
        while True:
            stale: List[GenRequest] = []
            with self._cv:
                free = [i for i, s in enumerate(self.slots) if not s.active]
                take = min(len(free), len(self._queue), self.prefill_batch)
                if take == 0:
                    return
                popped = []
                for _ in range(take):
                    if not self._queue:
                        break
                    req = heapq.heappop(self._queue)[3]
                    if (req.resume_pages is not None
                            and req.resume_epoch is not None
                            and req.resume_epoch != self.pool_epoch()):
                        stale.append(req)
                    else:
                        popped.append(req)
                self._admitting.update(r.request_id for r in popped)
            for req in stale:
                self.metrics.counters["engine_stale_resumes"].inc()
                _call(req.on_done, req.request_id, [], "stale_resume")
            groups: Dict[Any, List[Tuple]] = {}
            prefix_batch: List[Tuple] = []
            resume: Dict[int, List[Tuple]] = {}
            max_suffix = max_hits = 0
            for slot_id, req in zip(free, popped):
                if req.resume_pages is not None:
                    resume.setdefault(self._bucket_for(max(1, len(req.prompt))),
                                      []).append((slot_id, req))
                elif self._prefix is not None and len(req.prompt) >= ps:
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
            for bucket, items in resume.items():
                width = max(max(1, len(it[1].resume_pages)) for it in items)
                groups.setdefault(("resume", bucket,
                                   self._pp_bucket_for(width)),
                                  []).extend(items)
            for key, batch in groups.items():
                try:
                    if isinstance(key, tuple) and key[0] == "resume":
                        self._prefill_dense_resume_batch(batch, *key[1:])
                    elif isinstance(key, tuple):
                        self._prefill_prefix_batch(batch, *key[1:])
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
                    if self._mh is not None:
                        # pod mode: the workers may have applied a prefill
                        # this rank did not finish; carrying on would
                        # desynchronise the pod -- escalate to the loop's
                        # pod-fatal stop (as the JAX engine does)
                        raise

    def _rows_for(self, n: int) -> int:
        """Rows of a bucketed wave of ``n`` admissions: the smallest row
        bucket covering it (``prefill_batch`` unless row-bucketed)."""
        for rb in self._row_buckets:
            if n <= rb:
                return rb
        return self._row_buckets[-1]

    # swarmlint: hot
    def _prefill_batch(self, batch: List[Tuple]) -> None:
        """One bucketed prefill of short prompts (dense), or of the
        prompts without a prefix plan (paged, row-bucketed): forward at
        [rows, bucket] into a temp cache, the head at each row's last
        token, the first samples into the fed-token vector. Dense: each
        real row's K/V into ``cache[:, slot, :bucket]``; stale entries a
        previous occupant left past the bucket are never read (decode
        attends only positions it has written). Paged: the temp cache's
        whole pages into the slot's pages (``pool_insert_pages``; chunks
        past a slot's pages, and padding rows, go to trash page 0).
        ``batch`` rows start (slot_id, req)."""
        t0 = time.time()
        n, Bp = len(batch), self._rows_for(len(batch))
        bucket = self._bucket_for(max(len(it[1].prompt) for it in batch))
        padded = np.full((Bp, bucket), self.pad_id, np.int32)
        lengths = np.ones(Bp, np.int32)
        gather = np.zeros(Bp, np.int64)
        scatter = np.full(Bp, self.max_batch, np.int64)
        for row, (slot_id, req, *_rest) in enumerate(batch):
            padded[row, :len(req.prompt)] = req.prompt
            lengths[row] = len(req.prompt)
            gather[row] = scatter[row] = slot_id
            self._set_slot_sampling(slot_id, req.sampling)
        mark = self._wave_begin()
        sampling = self._rows_sampling(gather)
        real = lengths[:n].copy()
        family = "prefill.dense"
        if self.paged is None:
            if self._mh is not None:
                self._mh.publish_prefill(padded, lengths, scatter, *sampling)
            self._prefill_dense(padded, lengths, scatter, *sampling)
        else:
            alloc = self.paged.allocator
            target = self._page_targets(
                [alloc.pages_for(it[0]) for it in batch], Bp, bucket)
            call, family = self.CALL_PAGED_PREFILL, "prefill.paged"
            if self._sharded:
                padded, lengths, target, scatter, sampling = \
                    self._pack_wave(padded, lengths, target, scatter,
                                    sampling)
                call, family = (self.CALL_PAGED_PREFILL_PACKED,
                                "prefill.packed")
            self._mirrored(call, padded, lengths, target, scatter,
                           *sampling)
        self._count_wave(real, padded.size)
        packed = int(real.sum())
        self._wave_end(mark, prof_key(family, padded.shape), "bucketed",
                       bucket, packed, int(padded.size) - packed)
        self._activate([(it[0], it[1]) for it in batch], t0)

    def _packed_rows(self) -> int:
        """Rows of one shard's block of a packed wave: the most distinct
        slots of one shard a wave can hold."""
        return max(1, min(self.prefill_batch, self._rows))

    def _pack_wave(self, padded: np.ndarray, lengths: np.ndarray,
                   target: np.ndarray, scatter: np.ndarray,
                   sampling: Tuple[np.ndarray, ...]) -> Tuple[Any, ...]:
        """A bucketed wave over a sharded pool laid out as per-shard row
        blocks (the JAX engine's packed wave): block d holds shard d's
        rows, so each rank runs its own block on its own sub-pool. A
        block has min(prefill_batch, B/dp) rows, the most one wave can
        give a shard; padding rows (length 1, trash pages, the discard
        slot) fill the rest."""
        n_sh, per = self.paged.allocator.n_shards, self._packed_rows()
        R, bucket = n_sh * per, padded.shape[1]
        p_tokens = np.full((R, bucket), self.pad_id, np.int32)
        p_lengths = np.ones(R, np.int32)
        p_target = np.zeros((R, target.shape[1]), np.int32)
        p_scatter = np.full(R, self.max_batch, np.int64)
        p_sampling = [np.repeat(a[:1], R, axis=0) for a in sampling]
        fill = [0] * n_sh
        for row in np.nonzero(scatter < self.max_batch)[0]:
            sh = self.paged.allocator.shard_of(int(scatter[row]))
            r = sh * per + fill[sh]
            fill[sh] += 1
            p_tokens[r], p_lengths[r] = padded[row], lengths[row]
            p_target[r], p_scatter[r] = target[row], scatter[row]
            for dst, src in zip(p_sampling, sampling):
                dst[r] = src[row]
        return p_tokens, p_lengths, p_target, p_scatter, tuple(p_sampling)

    def _prefill_forward(self, padded: np.ndarray, lengths: np.ndarray,
                         rows: Optional[Tuple[torch.Tensor, int]] = None
                         ) -> Tuple[torch.Tensor, Any]:
        """The bucketed wave's forward into a temp cache: (fp32 logits
        [rows, V] at each row's last token, the temp cache). ``rows``:
        these rows' ids in the global wave, for a forward that counts it
        (``_wave_rows``)."""
        Bp, bucket = padded.shape
        positions = torch.arange(bucket, dtype=torch.int32,
                                 device=self.device).expand(Bp, bucket)
        kw = {} if rows is None else {"rows": rows}
        return self._forward_fn(
            self.params, self._tensor(padded), positions,
            self._init_cache_fn(Bp, bucket),
            logits_at=self._tensor(lengths - 1), **kw)

    # swarmlint: hot
    def _prefill_dense(self, padded: np.ndarray, lengths: np.ndarray,
                       scatter: np.ndarray, keys: np.ndarray,
                       temp: np.ndarray, topk: np.ndarray,
                       topp: np.ndarray) -> None:
        """The device half of a dense bucketed wave, from host arrays
        alone (what a pod's workers replay, ``OP_PREFILL``): the forward,
        each real row's K/V into ``cache[:, slot, :bucket]``, and the
        first samples with the rows' own keys and params into the
        fed-token vector."""
        count = None
        if self._data_axis is not None:
            # this rank's slots' rows (ranks of one model group run the
            # same ones, so their collectives meet), and its share of the
            # wave when a MoE forward counts all of it (``_wave_rows``)
            n = len(scatter)
            rows, ids = self._wave_rows(scatter)
            if not rows.size:
                return
            padded, lengths, scatter, keys, temp, topk, topp = (
                a[rows] for a in (padded, lengths, scatter, keys, temp,
                                  topk, topp))
            if ids is not None:
                scatter = np.where(ids < 0, self.max_batch, scatter)
                count = (self._tensor(ids), n)
        bucket = padded.shape[1]
        last, fresh_kv = self._prefill_forward(padded, lengths, count)
        local = self._local_slots(scatter)
        live = np.nonzero(local < self._rows)[0]
        slots, src = self._tensor(local[live]), self._tensor(live)
        for full, fresh in zip(self.cache, fresh_kv):
            full[:, slots, :bucket] = fresh[:, src]
        self._sample_into_slots(last, (keys, temp, topk, topp),
                                self._tensor(lengths - 1), scatter)

    def _page_targets(self, pages: List[List[int]], rows: int,
                      width: int) -> np.ndarray:
        """A wave's page targets [rows, chunks] for K/V ``width`` tokens
        wide: row r's chunk c (positions c * ps ..) goes to
        ``pages[r][c]``; chunks past a row's pages, and rows past
        ``len(pages)``, to trash page 0."""
        chunks = -(-width // self.paged.page_size)
        target = np.zeros((rows, chunks), np.int32)
        for r, row_pages in enumerate(pages):
            m = min(len(row_pages), chunks)
            target[r, :m] = row_pages[:m]
        return target

    def _insert_target(self, kv: Tuple[torch.Tensor, torch.Tensor],
                       target: np.ndarray) -> None:
        """Whole-page insert of a wave's K/V ``kv`` (each [L, rows, T,
        Hkv, D]) into the pages ``target`` names (``_page_targets``,
        localized to this rank's sub-pool). T is padded up to whole pages
        (the pad is prompt padding, never read)."""
        ps = self.paged.page_size
        T = kv[0].shape[2]
        Bp, chunks = target.shape
        flat = self._tensor(self._localize(target).reshape(-1))
        for pool, fresh in zip((self.cache["k"], self.cache["v"]), kv):
            if chunks * ps != T:
                fresh = torch.nn.functional.pad(
                    fresh, (0, 0, 0, 0, 0, chunks * ps - T))
            L = fresh.shape[0]
            pool_insert_pages(pool, flat, fresh.reshape(
                (L, Bp * chunks, ps) + tuple(fresh.shape[3:])))

    # swarmlint: hot
    def _prefill_paged_prefix_batch(self, batch: List[Tuple], bucket: int,
                                    ppb: int) -> None:
        """The paged prefix wave: the rows with a prefix plan (slot_id,
        req, hits, chains, table_row), padded to [rows, bucket] with a
        ``ppb``-page prefix table. The suffix forward reads the hit pages
        in place; the suffix's whole pages go into the slot's fresh pages
        (the reuse boundary is page-aligned, so suffix chunk c is fresh
        page c); then the prompt's fresh full pages are registered (their
        custody moves to the cache, pinned while the slot reads them)."""
        t0 = time.time()
        ps = self._prefix_ps
        n, Bp = len(batch), self._rows_for(len(batch))
        padded = np.full((Bp, bucket), self.pad_id, np.int32)
        lengths = np.ones(Bp, np.int32)
        plens = np.zeros(Bp, np.int32)
        table = np.zeros((Bp, ppb), np.int32)
        gather = np.zeros(Bp, np.int64)
        scatter = np.full(Bp, self.max_batch, np.int64)
        for r, (slot_id, req, hits, _chains, _row) in enumerate(batch):
            p0 = len(hits) * ps
            suffix = req.prompt[p0:]
            padded[r, :len(suffix)] = suffix
            lengths[r], plens[r] = len(suffix), p0
            table[r, :len(hits)] = hits
            gather[r] = scatter[r] = slot_id
            self._set_slot_sampling(slot_id, req.sampling)
        alloc = self.paged.allocator
        target = self._page_targets([alloc.pages_for(it[0]) for it in batch],
                                    Bp, bucket)
        mark = self._wave_begin()
        self._mirrored(self.CALL_PAGED_PREFIX_PREFILL, padded, lengths, plens,
                       table, target, scatter, *self._rows_sampling(gather))
        self._count_wave(lengths[:n], padded.size)
        packed = int(lengths[:n].sum())
        self._wave_end(mark, prof_key("prefill.paged_prefix", padded.shape,
                                      ppb),
                       "bucketed", bucket, packed, int(padded.size) - packed)
        self._register_prefix(batch)
        self._activate([(it[0], it[1]) for it in batch], t0)

    def _promote_insert(self, req: GenRequest) -> None:
        """A warm-tier promotion: copy the host payload into the request's
        freshly reserved resume pages, in place, before the resume prefill
        reads them. The exact storage-width bytes that left the pool come
        back (``pool_insert_raw``), so the resumed decode is the one that
        never spilled. One batched copy per pool on the engine's stream;
        the page-locked source stays referenced until an event recorded
        after the copy has passed."""
        payload, req.promote_payload = req.promote_payload, None
        if payload is None or not req.resume_pages:
            return
        t0 = time.perf_counter()
        ids = self._tensor(np.asarray(req.resume_pages, np.int64))
        pool_insert_raw(self.cache["k"], ids, payload[0])
        pool_insert_raw(self.cache["v"], ids, payload[1])
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self._promote_sources.append((event, payload))
        self.metrics.counters["engine_tier_promote_inserts"].inc()
        self.metrics.latencies["tier_promote_s"].observe(
            time.perf_counter() - t0)

    def release_promote_sources(self) -> None:
        """Wait for the promotion copies in flight and drop their host
        sources (the tier's warm-store views), on a stopped engine."""
        for event, _ in self._promote_sources:
            event.synchronize()
        self._promote_sources.clear()

    # swarmlint: hot
    def _prefill_paged_resume_batch(self, batch: List[Tuple], bucket: int,
                                    ppb: int) -> None:
        """One suffix prefill continuing kept conversations (rolling KV,
        ``GenRequest.resume_pages``), padded to [prefill_batch, bucket]
        with a ``ppb``-page table of kept pages: the suffix forward
        attends the kept pages in place plus the suffix causally, its K/V
        is written positionally from resume_len (mid-page,
        ``paged_write_chunk``, one layer at a time) through the slot's
        table row, and the first tokens are sampled. Nothing is registered:
        the kept pages stay in the registry's custody. ``batch`` rows:
        (slot_id, req, hits, chains, table_row)."""
        t0 = time.time()
        Bp = self.prefill_batch
        maxp = self.paged.allocator.maxp
        padded = np.full((Bp, bucket), self.pad_id, np.int32)
        lengths = np.ones(Bp, np.int32)
        rlens = np.zeros(Bp, np.int32)
        table = np.zeros((Bp, ppb), np.int32)
        row_tables = np.zeros((Bp, maxp), np.int32)
        gather = np.zeros(Bp, np.int64)
        scatter = np.full(Bp, self.max_batch, np.int64)
        for r, (slot_id, req, _hits, _chains, row) in enumerate(batch):
            padded[r, :len(req.prompt)] = req.prompt
            lengths[r], rlens[r] = len(req.prompt), req.resume_len
            table[r, :len(req.resume_pages)] = req.resume_pages
            row_tables[r] = row
            gather[r] = scatter[r] = slot_id
            self._set_slot_sampling(slot_id, req.sampling)
        mark = self._wave_begin()
        lengths_t, rlens_t = self._tensor(lengths), self._tensor(rlens)
        k_pool, v_pool = self.cache["k"], self.cache["v"]
        logits, sk, sv = self._prefix_pages_fwd(
            self.params, self._tensor(padded), self._tensor(table), rlens_t,
            k_pool, v_pool, logits_at=lengths_t - 1)
        self._sample_into_slots(logits, self._rows_sampling(gather),
                                rlens_t + lengths_t - 1, scatter)
        tables_t = self._tensor(row_tables)
        dtype = pool_dtype(k_pool)
        for l in range(sk.shape[0]):
            # a layer at a time: an int8 pool's requant windows over all
            # layers of a wide wave would take GiBs at a full-size shape
            lk = pool_layer(k_pool, l)
            lv = pool_layer(v_pool, l)
            paged_write_chunk(
                QuantPool(lk.data[None], lk.scale[None])
                if isinstance(lk, QuantPool) else lk[None],
                QuantPool(lv.data[None], lv.scale[None])
                if isinstance(lv, QuantPool) else lv[None],
                sk[l:l + 1].to(dtype), sv[l:l + 1].to(dtype), rlens_t,
                tables_t)
        n = len(batch)
        packed = int(lengths[:n].sum())
        self._wave_end(mark, prof_key("prefill.resume", padded.shape, ppb),
                       "bucketed", bucket, packed, int(padded.size) - packed)
        c = self.metrics.counters
        c["prefill_packed_tokens"].inc(packed)
        c["prefill_padding_tokens"].inc(int(padded.size) - packed)
        c["prefix_reused_tokens"].inc(int(rlens.sum()))
        self._last_wave_kind = "bucketed"
        self._activate([(it[0], it[1]) for it in batch], t0)

    # swarmlint: hot
    def _prefill_dense_resume_batch(self, batch: List[Tuple], bucket: int,
                                    ppb: int) -> None:
        """Dense rolling resume: each row's kept side-pool pages compose
        into the slot's lane with a mid-page boundary at resume_len
        (``forward_prefix_lane`` is token-granular in prefix_lens), only
        the suffix is computed, and nothing is registered (the kept pages
        stay in the registry's custody). ``batch`` rows: (slot_id,
        req)."""
        self._prefix_fused_dispatch(
            [(slot_id, req, req.prompt, req.resume_len, req.resume_pages, [])
             for slot_id, req in batch], bucket, ppb, time.time())

    # swarmlint: hot
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

    # swarmlint: hot
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
        mark = self._wave_begin()
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
        self._sample_into_slots(logits, self._rows_sampling(gather),
                                plens_t + lengths_t - 1, scatter)
        packed = int(lengths[:n].sum())
        self._wave_end(mark, prof_key("prefill.dense_prefix", padded.shape,
                                      ppb),
                       "bucketed", bucket, packed, int(padded.size) - packed)
        self.metrics.counters["prefix_reused_tokens"].inc(int(plens.sum()))
        self._count_wave(lengths[:n], padded.size)
        self._activate([(r[0], r[1]) for r in rows], t0)

    def _count_wave(self, lengths: np.ndarray, size: int) -> None:
        """Counters of one bucketed wave: real and padding tokens."""
        self._last_wave_kind = "bucketed"
        packed = int(lengths.sum())
        c = self.metrics.counters
        c["prefill_waves"].inc()
        c["prefill_packed_tokens"].inc(packed)
        c["prefill_padding_tokens"].inc(int(size) - packed)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _wave_begin(self) -> Optional[Tuple[int, Any]]:
        """Open one prefill wave's device-time bracket: (monotonic ns, a
        timing event recorded on the engine's stream, None off the
        card), or None with the profiler off."""
        if not self._prof.enabled:
            return None
        t0 = time.monotonic_ns()
        if self.stream is None:
            return t0, None
        start = torch.cuda.Event(enable_timing=True)
        start.record(self.stream)
        return t0, start

    def _wave_end(self, mark: Optional[Tuple[int, Any]], key: str,
                  kind: str, width: int, packed: int, padding: int) -> None:
        """Close a wave's bracket: its shape into the dispatch profile
        and its device time to ``key`` -- off the card the wall time
        around the (synchronous) wave, on the card an end event whose
        pair the next host wait reads once complete (no wait is added)."""
        if mark is None:
            return
        self._prof.wave(kind, width, packed, padding, key)
        t0, start = mark
        if start is None:
            self._prof.dispatch(key, t0, time.monotonic_ns() - t0)
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record(self.stream)
        self._prof_waves.append((key, t0, start, end))

    def _drain_wave_times(self) -> None:
        """Attribute the device time of every bracketed prefill wave whose
        end event has passed (a non-blocking query; the rest wait for a
        later host wait)."""
        left = []
        for key, t0, start, end in self._prof_waves:
            if end.query():
                self._prof.dispatch(key, t0,
                                    int(start.elapsed_time(end) * 1e6))
            else:
                left.append((key, t0, start, end))
        self._prof_waves = left

    # swarmlint: hot
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
            if self._kerncheck:
                # descriptor audit before the wave ships: a bad page id, a
                # trash-page target or a duplicate (page, offset) cell is
                # an engine bug the write would silently scatter
                from ..obs.kerncheck import check_wave_descriptors

                check_wave_descriptors(tok_row, tok_pos, tables,
                                       self.paged.allocator.num_pages, ps)
            mark = self._wave_begin()
            tok_row_t, tok_pos_t = self._tensor(tok_row), self._tensor(tok_pos)
            tables_t = self._tensor(tables)
            plens_t, lens_t = self._tensor(plens), self._tensor(lens)
            logits, sk, sv = self.paged.prefill_ragged(
                self.params, self._tensor(tokens), tok_row_t, tok_pos_t,
                tables_t, self._tensor(starts), lens_t, plens_t,
                k_pool, v_pool)
            self._sample_into_slots(
                logits, self._rows_sampling(gather),
                torch.clamp(plens_t + lens_t - 1, min=0), scatter)
            self._write_ragged(k_pool, v_pool, sk, sv, tok_row_t, tok_pos_t,
                               tables_t)
            # the dispatch profile's (ragged, width) row: tiny flush waves
            # are the ones the ragged min width is to be set from
            self._wave_end(mark, prof_key("prefill.ragged", tokens.shape),
                           "ragged", wd, filled, wd - filled)
            packed_n += filled
            padding_n += wd - filled
            self.metrics.counters["prefill_waves"].inc()
            self._last_wave_kind = "ragged"
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

    # swarmlint: hot
    def _activate(self, batch: List[Tuple[int, GenRequest]],
                  t0: float) -> None:
        if self._pagecheck is not None:
            # dispatch-time page validation: every page the slot's row was
            # stamped with at allocation is still live at the same alloc
            # epoch (a page freed and re-allocated in between is the
            # stale-table race)
            for slot_id, _req in batch:
                self._pagecheck.validate_row(slot_id)
        for slot_id, req in batch:
            slot = self.slots[slot_id]
            slot.active = True
            slot.request = req
            # next write position: a rolling resume continues past the
            # tokens already in its kept pages
            slot.position = req.resume_len + len(req.prompt)
            slot.dispatched_position = slot.position
            slot.generated = []
            slot.logprobs = []
            slot.pending_first = True
            slot.first_token_at = None
            slot.admitted_at = t0
            slot.admit_syncs = self._host_sync_n
            with self._cv:
                self._admitting.discard(req.request_id)
                slot.cancelled = req.request_id in self._cancel_pending
                self._cancel_pending.discard(req.request_id)
            self.total_requests += 1
            # the logical prompt includes a resume's kept tokens (their
            # reuse is counted in prefix_reused_tokens)
            self.metrics.counters["prompt_tokens"].inc(
                len(req.prompt) + req.resume_len)
            self.metrics.counters["engine_admitted"].inc()
            wait = t0 - req.submitted_at
            self._lat_queue_wait.observe(wait)
            HIST_QUEUE_WAIT.observe(wait, req.request_id)
            self.metrics.counters["phase_us_queue_wait"].inc(
                max(0, int(wait * 1e6)))
            # a retro-span: the wait ended before any call site could
            # open one, so it is recorded from its wall-clock ends
            self.tracer.span_at("engine.admit", req.submitted_at, t0,
                                cat="engine", rid=req.request_id)
        dt = time.time() - t0
        self._lat_prefill.observe(dt)
        self.metrics.counters["phase_us_prefill"].inc(max(0, int(dt * 1e6)))
        self.metrics.counters["engine_admission_waves"].inc()
        if self.overlap_probe is not None and self.overlap_probe():
            # a lane admitted while a sibling lane was inside a decode
            # session: the overlap lanes exist for
            self.metrics.counters["engine_admission_overlap_steps"].inc()
        for slot_id, req in batch:
            self.tracer.span_at(
                "engine.prefill", t0, t0 + dt, cat="engine",
                rid=req.request_id,
                args={"slot": slot_id,
                      "mid": req.metadata.get("message_id")})

    # --------------------------------------------------------------- decode

    def _chunk_inputs(self, positions: np.ndarray) -> Tuple[np.ndarray, ...]:
        """A chunk's host inputs: positions, then every slot's key words,
        temperature, top-k and top-p."""
        return (positions, self._base_keys_np.astype(np.int64), self._temp,
                self._topk, self._topp)

    # swarmlint: hot
    def _dispatch_decode(self) -> Tuple[ChunkOut,
                                        List[Tuple[int, GenRequest, int]],
                                        int, Optional[str]]:
        """Launch one chunk over the active slots, without waiting for it,
        and return (its block on the way to the host, the (slot, request,
        start position) snapshot, the dispatch stamp, its profiler key or
        None with the profiler off: then the chunk is untimed). Each
        active slot's
        dispatched position advances by K here; idle slots decode at 0.
        With chunks in flight a slot can retire and be re-admitted before
        this one is processed: the snapshot's request tells the host to
        discard the old occupant's lane."""
        K = self.decode_chunk
        positions = np.zeros(self.max_batch, np.int32)
        snapshot: List[Tuple[int, GenRequest, int]] = []
        for i, s in enumerate(self.slots):
            if s.active:
                positions[i] = s.dispatched_position
                snapshot.append((i, s.request, s.dispatched_position))
                s.dispatched_position += K
        variant = variant_for(self._temp, self._topk, self._topp,
                              [i for i, _, _ in snapshot])
        key = PROF_DECODE_KEYS[variant] if self._prof.enabled else None
        t_ns = time.monotonic_ns()
        inputs = self._chunk_inputs(positions)
        if self._mh is not None:
            self._mh.publish_decode(variant, *inputs)
        out = self._launch(variant, inputs, timed=key is not None)
        self.metrics.counters["engine_decode_chunks"].inc()
        return out, snapshot, t_ns, key

    # swarmlint: hot
    def _launch(self, variant: int,
                inputs: Optional[Tuple[np.ndarray, ...]],
                timed: bool = False) -> ChunkOut:
        """One chunk on the runner, the host's [B] inputs cut to this
        rank's slots on a data axis (the block comes back whole)."""
        if inputs is not None and self._data_axis is not None:
            inputs = tuple(a[self._lo:self._lo + self._rows] for a in inputs)
        return self._runner.launch(variant, inputs, timed=timed)

    # swarmlint: hot
    def _process_block(self, out: ChunkOut,
                       snapshot: List[Tuple[int, GenRequest, int]],
                       t_dispatch_ns: int, key: Optional[str]) -> None:
        """Wait for one dispatched chunk's block (the host's one wait on
        it), attribute its device time and emit its tokens."""
        block, lps = self._host_wait(out.host)
        if self.block_log is not None:
            self.block_log.append(block)
        if key is not None:
            self._prof.dispatch(key, t_dispatch_ns, out.device_ns())
        self._process_host_block(block, lps, snapshot, t_dispatch_ns)

    # ------------------------------------------------- page sanitizer
    # Both helpers run only under SWARMDB_PAGECHECK=1 (self._pagecheck set
    # by the checked allocator); the flag-off path never reaches them. The
    # canary read-back is the sanitizer's own sync: it is not a host wait
    # of the serving loop and does not count into engine_host_syncs.

    def _pagecheck_poison(self, pages: List[int]) -> None:
        """Stamp freed pages' K/V with the canary, in place on the
        engine's stream: after every gather already enqueued there that
        reads them (a tier demotion, the fleet's stage-1 gather). On a
        sharded pool the coordinator stamps and checks the pages of its
        own sub-pool (the others are its workers')."""
        canary_fill(self.cache["k"], self.cache["v"], self._own_pages(pages))
        self._pagecheck.mark_poisoned(pages)

    def _pagecheck_admit(self, slot_id: int, req: GenRequest) -> None:
        """Stamp the slot's owner (the aliasing reports name both
        requests), then verify the canary of every poisoned page the
        slot was just handed: a mismatch means something WROTE to the
        page while it was free."""
        pc = self._pagecheck
        pc.set_owner(slot_id, req.request_id)
        poisoned = pc.poisoned_pages(self.paged.allocator.pages_for(slot_id))
        if not poisoned:
            return
        local = self._own_pages(poisoned)
        bad = canary_check(self.cache["k"], self.cache["v"], local)
        if bad and self._sharded:
            # the sub-pool ids back to the global ids the reports name
            pl = self.paged.allocator.pages_per_shard
            bad = [p + self._data_axis.index * pl for p in bad]
        if bad:
            pc.canary_violation(bad,
                                detail=f"at admission of {req.request_id}")
        pc.clear_poison(poisoned)

    # swarmlint: hot
    def _host_wait(self, fetch: Callable[[], Any]) -> Any:
        """One host wait on the device (``fetch``), counted as a host
        sync: an ``engine.host_sync`` span, ``engine_host_syncs`` and the
        time blocked in ``phase_us_host_sync``. The JAX engine's three
        sync sites do the same around ``jax.device_get``."""
        t0 = time.monotonic_ns()
        out = fetch()
        t1 = time.monotonic_ns()
        self.tracer.span_end(t0, "engine.host_sync", cat="engine")
        self.metrics.counters["engine_host_syncs"].inc()
        self._host_sync_n += 1
        self.metrics.counters["phase_us_host_sync"].inc((t1 - t0) // 1000)
        if self._prof_waves:
            self._drain_wave_times()
        if self._kerncheck:
            # the checked kernels' violation record, copied to host memory
            # behind every checked launch: complete up to this wait
            kerncheck_poll(self.device)
        return out

    # swarmlint: hot
    def _process_host_block(self, block: np.ndarray, lps: np.ndarray,
                            snapshot: List[Tuple[int, GenRequest, int]],
                            t_dispatch_ns: int) -> None:
        """Host half of block processing, fed by both loops: beat, count
        the chunk's wall time, emit. Token (s+1, i) was sampled at write
        position pos0_i + s; emission stops at EOS / max_new_tokens /
        max_seq and the rest of the lane is discarded garbage, as is every
        lane whose slot no longer holds the snapshot's request."""
        self._beat()
        now_ns = time.monotonic_ns()
        # the chunk's share of wall time: since its dispatch (a session's
        # first chunk: the session's start; a later one: the previous
        # chunk's processing), or since the previous chunk was processed
        # if that came later (chunks in flight overlap). The host's wait
        # for the block lies inside this share, so phase_us_decode and
        # phase_us_host_sync overlap (as in the JAX package, whose sums
        # may exceed wall time too)
        self.metrics.counters["phase_us_decode"].inc(
            (now_ns - max(t_dispatch_ns, self._last_chunk_ns)) // 1000)
        self._last_chunk_ns = now_ns
        # dispatch -> processed (in flight chunks overlap; in a session
        # this is the chunk's own wall time). The exemplar is the first
        # snapshot slot's request, a representative trace
        HIST_DECODE_CHUNK.observe(
            (now_ns - t_dispatch_ns) / 1e9,
            snapshot[0][1].request_id if snapshot else None)
        now = time.time()
        K = self.decode_chunk
        for i, req, pos0 in snapshot:
            # one decode-chunk span per snapshot slot, retired or not:
            # the leaves of a request's exported timeline
            self.tracer.span_end(t_dispatch_ns, "engine.decode_chunk",
                                 cat="engine", rid=req.request_id)
            s = self.slots[i]
            if not s.active or s.request is not req:
                continue  # retired with the chunk in flight
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

    # swarmlint: hot
    def _resident_should_continue(self) -> bool:
        """The host's vote after each chunk of a session: stop when the
        engine is stopping, a chaos fault is armed (it must land at the
        loop-top seam), nothing is active, or queued work meets a free
        slot (end the session, admit, start another). Lock-light as in
        the JAX package: a stale verdict costs one chunk."""
        if self._stop or self._chaos_pending():  # swarmlint: disable=SWL301 -- chunk-granular race is benign
            return False
        if not self._any_active():
            return False
        with self._cv:
            queued = len(self._queue)
        return not (queued and any(not s.active for s in self.slots))

    # swarmlint: hot
    def _run_resident(self) -> None:
        """One device-resident decode session over the active slots: live
        slots start at their dispatched positions, idle rows at 0, and
        every row advances by K each chunk on the device. It runs until
        ``max_chunks`` have run, every lane is done (its stop position
        reached, or an EOS anywhere in its block) or the host's vote after
        a chunk says stop; that vote decides whether the next chunk runs.
        The host waits on each chunk's block (one host sync per chunk)."""
        B, K = self.max_batch, self.decode_chunk
        positions = np.zeros(B, np.int32)
        stop_pos = np.zeros(B, np.int64)
        live = np.zeros(B, bool)
        snap: List[Tuple[int, GenRequest, int]] = []
        max_rem = 0
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            pos0 = s.dispatched_position
            positions[i] = pos0
            live[i] = True
            # +1 covers the pending first token (row 0 of the first
            # block); the host still owns exact retirement
            rem = s.request.sampling.max_new_tokens - len(s.generated) + 1
            stop_pos[i] = min(self.max_seq, pos0 + max(1, rem))
            snap.append((i, s.request, pos0))
            max_rem = max(max_rem, int(stop_pos[i]) - pos0)
        if not snap:
            return
        max_chunks = -(-max(1, max_rem) // K) + 1
        variant = variant_for(self._temp, self._topk, self._topp,
                              [i for i, _, _ in snap])
        c = self.metrics.counters
        c["engine_resident_sessions"].inc()
        # the JAX engine's resident keys: a session's chunks are billed to
        # its variant's resident.* row
        key = PROF_RESIDENT_KEYS[variant] if self._prof.enabled else None
        done = ~live
        inputs: Optional[Tuple[np.ndarray, ...]] = self._chunk_inputs(
            positions)
        # each chunk's start: the session's for the first, then the
        # previous chunk's processing (which launches the next)
        t_chunk = time.monotonic_ns()
        n, cont = 0, True
        self._lane_busy = True
        try:
            while n < max_chunks and cont and not done.all():
                t_launch = time.monotonic_ns()
                out = self._launch(variant, inputs, timed=key is not None)
                block, lps = self._host_wait(out.host)
                if key is not None:
                    self._prof.dispatch(key, t_launch, out.device_ns())
                inputs = None  # later chunks read what this one left
                c["engine_decode_chunks"].inc()
                done |= ((positions.astype(np.int64) + (n + 1) * K
                          >= stop_pos)
                         | np.any(block == self.eos_id, axis=0))
                try:
                    self._process_host_block(
                        block, lps,
                        [(i, req, pos0 + n * K) for i, req, pos0 in snap],
                        t_chunk)
                    t_chunk = self._last_chunk_ns
                    cont = self._resident_should_continue()
                except Exception:
                    logger.exception("resident block processing failed; "
                                     "ending the session")
                    cont = False
                n += 1
        finally:
            self._lane_busy = False
            c["engine_resident_chunks"].inc(n)
        for i, req, _pos0 in snap:
            s = self.slots[i]
            if s.active and s.request is req:
                # the device's next fed token follows exactly the
                # processed extent
                s.dispatched_position = s.position

    # swarmlint: hot
    def _drain_prefill_only(self) -> None:
        """Fleet prefill lanes: retire admission-only (max_new_tokens <=
        1) requests straight off the prefill sample. The fed-token vector
        holds the token the colocated decode would emit as row 0 of its
        next block, so the handoff emits what colocated serving does. One
        host wait per admission round, counted as a host sync. Other slots
        (a quarantined decode pool's work served here) decode as usual."""
        rows = [i for i, s in enumerate(self.slots)
                if s.active and s.pending_first and s.request is not None
                and s.request.sampling.max_new_tokens <= 1]
        if not rows:
            return
        toks, lps = self._host_wait(
            # swarmlint: sanctioned-drain -- the admission round's one wait
            lambda: (self._last_tokens.cpu().numpy(),
                     self._last_lps.cpu().numpy()))  # swarmlint: sanctioned-drain
        now = time.time()
        for i in rows:
            s = self.slots[i]
            if not s.active:
                continue
            if s.cancelled:
                self._retire(i, "cancelled")
                continue
            s.pending_first = False
            self._emit_token(i, int(toks[i]), now, float(lps[i]))
            if s.active:
                # only a max_new_tokens 0 request gets here
                self._retire(i, "length")

    # swarmlint: hot
    def _emit_token(self, slot_id: int, token: int, now: float,
                    logprob: float) -> None:
        """Record a sampled token, stream it, retire if finished."""
        slot = self.slots[slot_id]
        req = slot.request
        if slot.first_token_at is None:
            slot.first_token_at = now
            self._lat_first_token.observe(
                now - req.submitted_at)
            HIST_TTFT.observe(now - req.submitted_at, req.request_id)
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

    # swarmlint: hot
    def _retire(self, slot_id: int, reason: str) -> None:
        slot = self.slots[slot_id]
        req = slot.request
        slot.active = False
        slot.request = None
        if self.paged is not None:
            if req is not None and req.keep_pages:
                self._paged_keep(slot_id, slot, req)
            # pages stay owned until the next admission round zeroes the
            # table row and frees them (a dense lane has none to free)
            self.paged.allocator.mark_retired(slot_id)
            pins = self._slot_prefix_pins.pop(slot_id, None)
            if pins:
                self._prefix.unpin(pins)
        elif (req is not None and req.keep_pages
              and reason in ("length", "eos") and self._prefix is not None):
            # clean finishes only: a failure retirement runs before the
            # error recovery rebuilds the cache and the side pool
            try:
                self._dense_keep_extract(slot_id, slot, req)
            except Exception:
                logger.exception("dense keep extraction failed")
        self.metrics.counters["engine_completed"].inc()
        self.metrics.rates["requests_completed"].mark()
        if req is not None:
            # the request's timeline in the flight ring (engine thread)
            self.flight.record_request({
                "rid": req.request_id,
                "priority": req.priority,
                "prompt_len": len(req.prompt) + req.resume_len,
                "generated": len(slot.generated),
                "reason": reason,
                "submitted_at": req.submitted_at,
                "admitted_at": slot.admitted_at,
                "first_token_at": slot.first_token_at,
                "retired_at": time.time(),
                # host syncs since admission + 1: the JAX package's
                # formula, whose +1 is its resident session's one wait,
                # taken after this record. The port waits once per chunk
                # in both loops, before the chunk is processed, so here
                # it reads the request's chunks + 1 (JAX: at most 3)
                "host_syncs": self._host_sync_n - slot.admit_syncs + 1,
            })
            req.metadata["logprobs"] = list(slot.logprobs)
            _call(req.on_done, req.request_id, list(slot.generated), reason)

    def _paged_keep(self, slot_id: int, slot: _Slot, req: GenRequest) -> None:
        """Rolling KV at a paged retirement: the conversation's pages go
        to the caller instead of the free list. ``written`` is the
        host-confirmed extent (chunk-granular); emitted tokens past it
        have no confirmed K/V and go back as the tail, which the next
        turn's suffix starts with (re-fed, they write the same K/V). Pages
        past the written extent are freed now: a chunk in flight may still
        write garbage into them, but every later writer comes after it on
        the engine's one stream."""
        alloc = self.paged.allocator
        fresh = alloc.pages_for(slot_id)
        alloc.transfer_to_cache(slot_id, fresh)
        pages = list(req.resume_pages or []) + fresh
        written = slot.position
        start = req.resume_len + len(req.prompt)
        tail = list(slot.generated[max(0, written - start):])
        covering = -(-written // self.paged.page_size) if written > 0 else 0
        kept, extras = pages[:covering], pages[covering:]
        if extras:
            alloc.add_free(extras)
        _call(req.on_pages, req.request_id, kept, written, tail)

    # swarmlint: hot
    def _dense_keep_extract(self, slot_id: int, slot: _Slot,
                            req: GenRequest) -> None:
        """Rolling KV at a dense retirement: copy the lane's written K/V
        (positions < written, page by page) into pages acquired from the
        prefix side pool, in place, and hand them to ``on_pages``. The
        last page may be partial; its tail is lane garbage that the resume
        masks (prefix_lens = written). Short of pages, the ladder is: the
        conversation's own superseded source pages (their last reader, the
        resume prefill, came earlier on the stream), then the pool-pressure
        hook; still short, the turn does not roll (no ``on_pages``, or an
        empty one when the source pages were already released)."""
        ps = self._prefix_ps
        written = slot.position
        start = req.resume_len + len(req.prompt)
        tail = list(slot.generated[max(0, written - start):])
        n = -(-written // ps) if written > 0 else 0
        if not 0 < n <= self._prefix_pp_buckets[-1]:
            return
        released_source = False
        pages = self._prefix.acquire(n)
        if len(pages) != n and req.resume_pages:
            for p in pages + list(req.resume_pages):
                self._prefix.release(p)
            released_source = True
            pages = self._prefix.acquire(n)
        if len(pages) != n and self.on_pool_pressure is not None:
            for p in pages:
                self._prefix.release(p)
            try:
                self.on_pool_pressure(n)
            except Exception:
                logger.exception("pool-pressure callback failed")
            pages = self._prefix.acquire(n)
        if len(pages) != n:
            for p in pages:
                self._prefix.release(p)
            if released_source:
                # the registry's state names freed pages: hand it an empty
                # one (restart next turn) instead of dangling ids
                _call(req.on_pages, req.request_id, [], 0, [])
            return
        try:
            ids = self._tensor(np.asarray(pages, np.int64))
            for pool, full in zip(self._prefix_pool, self.cache):
                lane = full[:, slot_id, :n * ps]
                pool.index_copy_(1, ids, lane.reshape(
                    (lane.shape[0], n, ps) + tuple(lane.shape[2:])
                ).to(pool.dtype))
        except Exception:
            for p in pages:
                self._prefix.release(p)
            if released_source:
                _call(req.on_pages, req.request_id, [], 0, [])
            raise
        if req.resume_pages and not released_source:
            for p in req.resume_pages:
                self._prefix.release(p)
        _call(req.on_pages, req.request_id, pages, written, tail)

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
            "decode_loop": ("resident" if self._resident
                            else f"pipeline {self.pipeline_depth}"),
            "decode_chunks": self._runner.stats(),
            "pod": ("failed" if self._pod_failed is not None
                    else "coordinator" if self._mh is not None else None),
            "max_step_s": round(self.max_step_s, 4),
            "beat_age_s": round(self.beat_age_s(), 4),
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
