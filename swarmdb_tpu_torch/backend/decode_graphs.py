"""Decode chunks as CUDA graphs: the card's vehicle for both decode loops.

The counterpart of the JAX engine's ``jax.jit`` of ``_decode`` and of the
body of its device-resident ``_decode_resident`` loop
(``swarmdb_tpu/backend/engine.py``). A chunk is K decode steps -- the
chunk forward with the cache frozen and one merge at the end, or K single
steps that each write the cache -- with sampling and logprobs after every
step, its ``[K+1, B]`` token and logprob block written into static output
buffers (row 0 = the fed tokens), the last sample written back as the next
fed tokens, and every row's position advanced by K.

- ``decode_chunk`` is the chunk itself, a plain function on tensors. On
  CPU tensors the engine runs it eagerly; that eager run is the chunk's
  plain version, and the tests hold it against the JAX package.
- ``ChunkRunner`` runs one engine's chunks. On the card it captures one
  ``torch.cuda.CUDAGraph`` per sampling variant (0 = filters, 1 =
  sampling, 2 = greedy, the JAX engine's three decode variants), at the
  variant's first use or in ``capture_all`` (``Engine.warmup``), all in
  one memory pool (``torch.cuda.graph_pool_handle()``), and replays it:
  one host call per chunk. A capture or a replay that fails raises; no
  chunk falls back to eager. A runner built with ``graphs=False`` runs
  every chunk eagerly on the card instead: a tensor-parallel engine whose
  collectives cannot be captured (gloo) asks for it when it is built. The host's inputs reach the static
  buffers through pinned memory (``copy_(..., non_blocking=True)``), and
  the block comes back through an async copy into a pinned ring slot and
  an event, which ``ChunkOut.host`` waits on.
- On a data axis (``parallel/serving.py``) a rank's chunk covers only its
  own slots; the runner's ``gather`` then joins every rank's block into
  the [K+1, B] block of all slots, after the chunk and outside any graph,
  before the block leaves for the host.
- The graphs read the engine's own tensors in place (the pool or dense
  cache, the page table, the chunk K/V buffer, the fed-token vectors), so
  whatever rebuilds one of them must drop the runner (``Engine``'s
  ``_reset_state`` does).
- A capture is device-wide: it synchronizes the device and empties the
  allocator's cache, and a graph destroyed, or device memory freed, during
  another thread's capture invalidates that capture. Lanes on one card
  therefore take turns through ``device_lock``: a capture holds it, and
  so does an engine's state rebuild, which destroys its graphs.

``attention_cuda.LAUNCHES`` counts Python calls of the kernel wrappers. A
capture runs no kernel and a replay calls no Python, so a capture records
the graph's launches per kernel aside (``attention_cuda.launches_into``),
and every replay adds them: the counts stay kernel executions.
"""

from __future__ import annotations

import contextlib
import gc
import time
import weakref
from dataclasses import dataclass
from typing import (Any, Callable, ContextManager, Dict, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..ops import attention_cuda
from ..ops.layers import flush_static_smem
from ..utils.sync import make_lock
from .sampling import sample_tokens, token_logprob

#: (use_filters, assume_greedy) of variants 0, 1 and 2, as the JAX engine
#: orders its decode variants (filters, sampling, greedy).
VARIANTS: Tuple[Tuple[bool, bool], ...] = ((True, False), (False, False),
                                           (False, True))


# one per CUDA device index: the device is the process's, so is its lock
_DEVICE_LOCKS: Dict[int, Any] = {}
_DEVICE_LOCKS_GUARD = make_lock("backend.decode_graphs._DEVICE_LOCKS_GUARD")


def device_lock(device: torch.device) -> ContextManager:
    """The lock that graph captures and graph teardown on ``device``
    take (a no-op context off the card)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    with _DEVICE_LOCKS_GUARD:
        lock = _DEVICE_LOCKS.get(device.index)
        if lock is None:
            lock = _DEVICE_LOCKS[device.index] = make_lock(
                "backend.decode_graphs.device_lock")
        return lock


def variant_for(temp: np.ndarray, topk: np.ndarray, topp: np.ndarray,
                live: Sequence[int]) -> int:
    """The chunk's variant from the live slots' sampling params: 0 when
    any filters (top-k or top-p), else 1 when any samples (temperature
    > 0), else 2 (greedy)."""
    live = list(live)
    if np.any((topk[live] > 0) | (topp[live] < 1.0)):
        return 0
    return 1 if np.any(temp[live] > 0) else 2


@dataclass
class ChunkIO:
    """The static buffers a chunk reads and writes. ``tokens`` and ``lps``
    are the engine's fed-token vectors (written by prefill too);
    ``positions``, ``keys`` ([B, 2] uint32 words in int64), ``temp``,
    ``topk`` and ``topp`` are the host's inputs; ``block`` and
    ``block_lps`` ([K+1, B]) the chunk's output."""

    tokens: torch.Tensor
    lps: torch.Tensor
    positions: torch.Tensor
    keys: torch.Tensor
    temp: torch.Tensor
    topk: torch.Tensor
    topp: torch.Tensor
    block: torch.Tensor
    block_lps: torch.Tensor

    @classmethod
    def new(cls, tokens: torch.Tensor, lps: torch.Tensor,
            chunk: int) -> "ChunkIO":
        B, dev = tokens.shape[0], tokens.device
        z = lambda *shape, dtype: torch.zeros(shape, dtype=dtype, device=dev)
        return cls(tokens=tokens, lps=lps,
                   positions=z(B, dtype=torch.int32),
                   keys=z(B, 2, dtype=torch.int64),
                   temp=z(B, dtype=torch.float32),
                   topk=z(B, dtype=torch.int32),
                   topp=torch.ones(B, dtype=torch.float32, device=dev),
                   block=z(chunk + 1, B, dtype=torch.int32),
                   block_lps=z(chunk + 1, B, dtype=torch.float32))

    def inputs(self) -> Tuple[torch.Tensor, ...]:
        """The host-filled inputs, in ``ChunkRunner.launch``'s order."""
        return self.positions, self.keys, self.temp, self.topk, self.topp


def decode_chunk(params, cache, io: ChunkIO, variant: int, *,
                 chunked_fns: Optional[Tuple[Callable, Callable,
                                             Callable]] = None,
                 chunk_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 decode_forward: Optional[Callable] = None) -> None:
    """One decode chunk of K = ``io.block.shape[0] - 1`` steps on the
    static buffers ``io``. With ``chunked_fns`` (chunk_forward,
    init_chunk, merge) the cache stays frozen, each step's K/V goes into
    ``chunk_kv`` (zeroed first) and one merge folds them in at the chunk's
    start positions; without, ``decode_forward(params, tokens[B, 1],
    positions[B, 1], cache)`` writes each step's K/V into the cache in
    place before attending. Token (s+1, i) of the block was sampled at
    position ``positions[i] + s`` with slot i's key folded there. Every
    row's position, idle rows' included, ends K further on."""
    use_filters, greedy = VARIANTS[variant]
    K = io.block.shape[0] - 1
    io.block[0].copy_(io.tokens)
    io.block_lps[0].copy_(io.lps)
    if chunked_fns is not None:
        chunk_fwd, _init, merge = chunked_fns
        for t in chunk_kv:
            t.zero_()
    pos0 = io.positions
    tok, pos = io.tokens, pos0
    for step in range(K):
        if chunked_fns is not None:
            logits, _ = chunk_fwd(params, tok[:, None], pos[:, None], cache,
                                  chunk_kv, step)
        else:
            # writes the cache in place (PagedKV.decode_forward, or the
            # dense forward at T == 1): the graph's writes land in the
            # engine's own storage
            logits, _ = decode_forward(params, tok[:, None], pos[:, None],
                                       cache)
        logits = logits[:, -1]
        tok = sample_tokens(logits, io.keys, pos, io.temp, io.topk, io.topp,
                            use_filters=use_filters, assume_greedy=greedy)
        io.block[step + 1].copy_(tok)
        io.block_lps[step + 1].copy_(token_logprob(logits, tok))
        pos = pos + 1
    if chunked_fns is not None:
        merge(cache, chunk_kv, pos0)
    io.tokens.copy_(io.block[K])
    io.lps.copy_(io.block_lps[K])
    io.positions.add_(K)


class ChunkOut:
    """One launched chunk's block on its way to the host: ``host()``
    waits for it (on the card, the ring slot's event) and returns numpy
    copies of the [K+1, B] tokens and logprobs. A chunk launched with
    ``timed=True`` then has its ``device_ns()``."""

    __slots__ = ("_slot",)

    def __init__(self, slot: "_RingSlot") -> None:
        self._slot = slot

    # swarmlint: hot
    def host(self) -> Tuple[np.ndarray, np.ndarray]:
        slot = self._slot
        if slot.event is not None:
            # swarmlint: sanctioned-drain -- the chunk's one host wait
            slot.event.synchronize()
        slot.busy = False
        return slot.block.numpy().copy(), slot.block_lps.numpy().copy()

    def device_ns(self) -> int:
        """The chunk's device time, read after ``host()`` returned: on the
        card the elapsed time between the timing event recorded before
        its input copies and the block's event (both complete once the
        host wait passed, so the read does not wait); on the CPU the wall
        time of the eager chunk. Raises for an untimed launch."""
        slot = self._slot
        if slot.timed_ns is not None:
            return slot.timed_ns
        if slot.start is None or not slot.timed:
            raise RuntimeError("device_ns() of a chunk launched untimed")
        return int(slot.start.elapsed_time(slot.event) * 1e6)


class _RingSlot:
    """Host staging of one chunk in flight: its inputs and its block, in
    pinned memory on the card, the event that follows the block's copy
    and, for a timed launch, the timing event before its inputs."""

    def __init__(self, io: ChunkIO, cuda: bool, width: int) -> None:
        host = lambda t, shape=None: torch.empty(
            shape or t.shape, dtype=t.dtype, device="cpu", pin_memory=cuda)
        self.inputs = tuple(host(t) for t in io.inputs())
        shape = (io.block.shape[0], width)
        self.block = host(io.block, shape)
        self.block_lps = host(io.block_lps, shape)
        self.event = torch.cuda.Event(enable_timing=True) if cuda else None
        self.start = torch.cuda.Event(enable_timing=True) if cuda else None
        self.timed = False
        # the CPU's wall time of a timed eager chunk
        self.timed_ns: Optional[int] = None
        self.busy = False


class ChunkRunner:
    """One engine's decode chunks: ``body(variant)`` (``decode_chunk``
    over the engine's state) run eagerly on CPU tensors, replayed as one
    CUDA graph per variant on the card, captured on ``stream`` (the
    engine's). ``ring`` pinned slots hold the chunks in flight (the
    engine keeps at most its pipeline depth).

    ``body`` is a bound method of the runner's owner, held weakly: an
    engine and its runner then form no reference cycle, so a dropped
    engine frees its graphs at once, never from a garbage collection
    that another engine's capture happens to trigger (destroying a graph
    inside a capture invalidates the capture).

    ``gather`` (a data axis): (block, block_lps) of this rank's slots ->
    the same of every slot, [K+1, ``width``], called after each chunk."""

    def __init__(self, body: Callable[[int], None], io: ChunkIO,
                 ring: int,
                 stream: Optional[torch.cuda.Stream] = None,
                 graphs: bool = True,
                 gather: Optional[Callable[[torch.Tensor, torch.Tensor],
                                           Tuple[torch.Tensor,
                                                 torch.Tensor]]] = None,
                 width: Optional[int] = None) -> None:
        self._body = weakref.WeakMethod(body)
        self._gather = gather
        #: host seconds spent in ``gather`` calls, and their number
        self.gather_s = 0.0
        self.gathers = 0
        self.io = io
        self.device = io.tokens.device
        self.cuda = self.device.type == "cuda"
        #: chunks replay as CUDA graphs (on the card, unless built eager)
        self.use_graphs = self.cuda and graphs
        self.graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        #: each graph's kernel launches per replay, recorded at capture
        self.graph_launches: Dict[int, Dict[str, int]] = {}
        #: device memory the captures reserved (the shared pool's growth)
        self.pool_bytes = 0
        self.capture_s = 0.0
        self.chunks = 0
        self._pool = torch.cuda.graph_pool_handle() if self.cuda else None
        # captures run on the owner's stream (the engine's): engines
        # capturing at once must not share torch.cuda.graph's class-wide
        # capture stream, and a stream of the runner's own, from PyTorch's
        # pool of 32 per device, could come back as a sibling lane's
        self._stream = stream
        if self.cuda and stream is None:
            raise ValueError("a runner on the card needs its owner's stream")
        width = width or io.block.shape[1]
        self._ring = [_RingSlot(io, self.cuda, width)
                      for _ in range(max(2, ring))]
        self._next = 0

    def capture(self, variant: int) -> None:
        """Capture ``variant``'s chunk into a graph in the shared pool,
        holding the device's lock. A capture runs nothing on the card; it
        records which kernels the chunk launches, outside ``LAUNCHES``."""
        if not self.cuda:
            raise RuntimeError("CUDA graphs are captured on the card only")
        t0 = time.perf_counter()
        with device_lock(self.device), torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            # the capturing thread's cuBLAS handle: PyTorch creates one per
            # thread at its first GEMM, and cublasCreate fails inside a
            # capture (warmup() may capture before this thread ran any)
            torch.cuda.current_blas_handle()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            # no automatic collection while capturing: tearing down a
            # collected graph inside a capture invalidates the capture
            # (torch.cuda.graph collects just before it begins)
            gc_on = gc.isenabled()
            gc.disable()
            try:
                with attention_cuda.launches_into({}) as launches, \
                        torch.no_grad(), torch.cuda.graph(
                            graph, pool=self._pool, stream=self._stream,
                            capture_error_mode="thread_local"):
                    self.body(variant)
            finally:
                if gc_on:
                    gc.enable()
            # the shared-memory estimates the body's dispatchers computed
            # under the capture
            flush_static_smem()
            self.pool_bytes += (torch.cuda.memory_reserved(self.device)
                                - reserved)
        self.graphs[variant] = graph
        self.graph_launches[variant] = launches
        self.capture_s += time.perf_counter() - t0

    def body(self, variant: int) -> None:
        """Run ``variant``'s chunk eagerly: the CPU's chunk, and what a
        capture records."""
        self._body()(variant)

    def capture_all(self) -> None:
        """Capture every variant not captured yet (card only)."""
        for variant in range(len(VARIANTS)):
            if variant not in self.graphs:
                self.capture(variant)

    # swarmlint: hot
    def launch(self, variant: int,
               inputs: Optional[Sequence[np.ndarray]] = None,
               timed: bool = False) -> ChunkOut:
        """Run one chunk of ``variant``: ``inputs`` (positions, keys,
        temperature, top-k, top-p as numpy arrays), when given, are copied
        into the static buffers first; None keeps the buffers as the last
        chunk left them (a resident session's later chunks). On the card
        the variant's graph is captured at first use, then replayed; on
        the CPU the chunk runs eagerly. ``timed`` (the device-time
        profiler) brackets the chunk: on the card a timing event on the
        runner's stream before the input copies, after any capture, and
        the block's event after its copy; on the CPU the wall clock."""
        slot = self._ring[self._next]
        if slot.busy:
            raise RuntimeError("every decode ring slot holds a chunk in "
                               "flight: read one (ChunkOut.host) first")
        self._next = (self._next + 1) % len(self._ring)
        slot.busy = True
        if self.use_graphs and variant not in self.graphs:
            self.capture(variant)
        slot.timed, slot.timed_ns = timed, None
        t0 = time.monotonic_ns() if timed and not self.cuda else 0
        if timed and self.cuda:
            slot.start.record()
        if inputs is not None:
            for stage, buf, a in zip(slot.inputs, self.io.inputs(), inputs):
                stage.copy_(torch.from_numpy(np.ascontiguousarray(a)))
                buf.copy_(stage, non_blocking=self.cuda)
        if self.use_graphs:
            self.graphs[variant].replay()
            attention_cuda.count_launches(self.graph_launches[variant])
        else:
            self.body(variant)
            if timed and not self.cuda:
                slot.timed_ns = time.monotonic_ns() - t0
        self.chunks += 1
        block, block_lps = self.io.block, self.io.block_lps
        if self._gather is not None:
            t_g = time.perf_counter()
            block, block_lps = self._gather(block, block_lps)
            self.gather_s += time.perf_counter() - t_g
            self.gathers += 1
        slot.block.copy_(block, non_blocking=self.cuda)
        slot.block_lps.copy_(block_lps, non_blocking=self.cuda)
        if slot.event is not None:
            slot.event.record()
        return ChunkOut(slot)

    def stats(self) -> Dict[str, object]:
        """Graphs captured, their launches per replay, the pool's bytes,
        capture seconds and chunks run."""
        return {"mode": "graphs" if self.use_graphs
                else "eager",
                "graphs": sorted(self.graphs),
                "launches_per_replay": {str(v): d for v, d in
                                        sorted(self.graph_launches.items())},
                "pool_bytes": self.pool_bytes,
                "capture_s": round(self.capture_s, 4),
                "chunks": self.chunks,
                "gathers": self.gathers,
                "gather_s": round(self.gather_s, 4)}
