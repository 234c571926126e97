#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``swarmdb_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives the port on the card in phases, prints one JSON line per phase
and exits non-zero at the first failure:

1. device   -- the card's name and power limit (``nvidia-smi``).
2. build    -- compiles the eight CUDA kernels from
               ``swarmdb_tpu_torch/csrc`` (one ``nvcc`` per source, started
               together).
3. kernels  -- each kernel at the serving path's shapes (Llama-3-8B heads:
               Hq 32, Hkv 8, D 128; 8 slots of 64 pages of 16, or a dense
               slot cache of 8 x 1024 positions) against its plain PyTorch
               version on the same inputs (the same int8 payload and
               scales for the int8 kernels): bf16 query / chunk / suffix
               within 2e-2 absolute, f32 within 1e-4, an f32 query over
               bf16 pages or lanes within 2e-2, each with a windowed case;
               the two prefill kernels (whose bf16 calls run the tensor-
               core body) also on a seeded sweep of 16 waves over their
               edges (``prefill_sweep``), within 2e-2, and the six decode
               kernels (one cluster-split body) on a seeded sweep of 14
               waves over theirs (``decode_sweep``), bf16 within 2e-2 and
               f32 within 1e-4 (and the single-step paged decode once
               more with all slots at lengths 0, 32, 256 and 1024: its
               fixed cost and its cost per tile, ``decode_lengths``);
               then timed with
               CUDA events (median of 30 after warm-up): the kernel, its
               plain version, and one PyTorch
               ``scaled_dot_product_attention`` call over the gathered
               (for int8: already dequantized) dense view, or straight
               over the dense lanes (``library_ms``, gather and
               dequantization excluded); the prefill kernels once more on
               a 1024-token turn-1 wave, held against their plain
               versions within 2e-2 and timed (its own ``kernels``
               line).
4. parity   -- tiny-debug in f32 with the same weights, served on the card
               (kernels) and on the CPU (plain versions): the paged engine
               chunked and single-step over an f32 pool (logits within
               1e-4), a bf16 pool single-step and an int8 pool both ways
               (logits within the bounds in ``PARITY_CASES``), and the
               dense engine chunked and single-step over an f32 slot cache
               (1e-4); greedy tokens equal in every case. Then tiny-moe
               (Mixtral's family) in f32 the same way (``MOE_PARITY_CASES``):
               both engines, chunked and single-step, one paged case with
               ``SWARMDB_MOE_DISPATCH=einsum``; the paged engine prefills it
               in row-bucketed and prefix waves, so only the decode kernel
               launches; logits of the bucketed prefill, the prefix wave
               and the decode steps within 1e-4. Last, the binding-
               capacity case (tiny-moe with 8 experts, where idle and
               retired rows take capacity) at the default decode loops,
               both engines chunked and single-step: the card's graph
               replays and the CPU's eager chunks give equal greedy
               tokens (``run_binding_parity``). Last, rolling KV
               (``run_rolling_parity``, ``ROLL_PARITY_CASES``): one
               tiny-debug f32 conversation of five chat and
               ``function_call`` turns, on the paged engine (f32 and int8
               pools, chunked with an f32 and with the engine's bf16
               chunk buffer, and single-step) with the tier manager --
               demoted to host memory before turn 3 (a warm promotion)
               and into a store too small for it before turn 4 (a cold
               resume) -- and on the dense engine (chunked and single-
               step, kept pages composed into the lane): origins equal on
               both sides, greedy tokens equal, every prefill row's
               logits and the decode logprobs within each case's bound,
               and the bf16 chunk buffer's cases within 1e-4 of the CPU
               served the kernels' way (weights unrounded).
5. serve    -- Llama-3-8B at full width (32 layers, bf16 weights from seed
               0, built once) through SwarmDB + LocalBroker +
               ServingService, six times, each at the default decode
               loop (paged: resident sessions; dense: two chunks in
               flight), every chunk a CUDA graph replay, the graphs
               captured by ``start(warmup=True)`` (SWARMDB_PREWARM's path;
               the api phase captures at first use): the paged engine (``paged=True``)
               over a bf16 pool chunked (4 users x 2 turns), an int8 pool
               chunked (4 x 2: turn 2 reads int8 prefix pages), a bf16
               pool single-step and an int8 pool single-step (4 x 1); then
               the dense engine, built with ``paged=None`` and
               ``SWARMDB_PAGED`` unset (the default), chunked (4 x 2: turn
               2 reads the side prefix pool) and single-step (4 x 1); 32
               new tokens each, one request sampled (temperature 0.8,
               top-p 0.9, seed 7). Checks every reply, prefix reuse on
               turn 2, and that the path's kernels (and no other) advanced
               by 32 launches per prefill wave (paged; dense prefill
               attention is plain PyTorch, as in the JAX package) and by
               exactly 32 per decode step (counted from the replays);
               prints TTFT, decode tokens/s, KV bytes per token, the
               cache's (and side pool's) size, peak device memory, the
               decode loop, its graphs and counters per serve. Each serve then runs one more turn under
               ``torch.profiler`` (device time by kernel, the device's
               idle share, the prefill's time in each of its two bodies,
               the decode kernels' time by name); a paged serve fails if
               its prefill ran in the fp32 body, and any serve fails if
               its decode kernel shows no device time.
6. api      -- the wire API and supervised serving on the same weights:
               (a) ``create_app`` served on 127.0.0.1:0 (aiohttp
               ``AppRunner``) over the default dense engine (its
               tokenizer renders ids outside the byte range as ``<id>``,
               or random weights would stream empty text): four users
               each stream one ``POST /messages`` at once, 32 new tokens;
               every stream's text must equal its reply's body (client
               TTFT printed beside the service's ``send_to_first_token_s``);
               (b) a seeded message with ``n = 2`` must come back with one
               alternative of 32 tokens that differs from the body; (c) a
               group of two LLM-backed members streams through
               ``/groups/message``; (d) ``ServingChaos.kill_lane(0)`` at
               the 8th token of a decode: the service's supervisor must
               finish it "length" with 32 tokens, the streamed tokens equal
               to the final ones and at least one retry; then, on the paged
               bf16 engine, ``squeeze_pool(1.0)`` must shed the
               low-priority request and, after ``heal_pool()``, a
               supervisor built with a wider retry budget and backoff
               (printed) must serve it before its deadline; (e)
               ``python -m swarmdb_tpu_torch.api.server`` with
               ``SERVE_MODEL=tiny-debug`` and ``SWARMDB_PREWARM=1`` as a
               subprocess: ``/health`` must name the card and show the
               three variants' graphs captured at start, one message is
               answered, then SIGTERM.
               Kernels 7 (dense chunked decode), 1 and 2 must launch in
               the phase (its in-process steps; the subprocess's launches
               are its own).
6b. obs     -- the observability feeds on the same weights, in process
               through ``create_app`` as in the api phase: the default
               dense engine and the paged bf16 engine, both chunked, each
               with the tracer, histograms and SLO sentinel on
               (``OBS_SLO_ENV``: 2 s windows, one warm-up window, four
               completions a window; ``SWARMDB_FLIGHT_DIR`` a temporary
               directory), 4 users x 2 streamed turns of ~400-token chat
               messages, 32 new tokens. Fails unless every message's
               spans are there (``runtime.send``, ``broker.publish``,
               ``serve.request`` by message id; ``engine.admit``,
               ``engine.prefill`` and at least two ``engine.decode_chunk``
               by engine request id; an ``api.request`` per POST and an
               ``engine.host_sync`` in the process), the decode-chunk
               spans equal the live snapshot slots of every processed
               chunk (counted outside the engine), ``/admin/flight`` has
               both rings and its last step's counters equal the
               registry's, ``/metrics`` has the six histogram blocks and
               ``ttft_seconds_count`` equals the requests served,
               ``phase_us_queue_wait`` and ``phase_us_host_sync`` are
               positive, ``/admin/cluster/trace`` gives the span count of
               ``/admin/trace/export``, and, with
               ``SWARMDB_SLO_TTFT_P95_S=0.001`` for a third round,
               ``/admin/slo`` reports the breach with an alert whose shares
               sum to 1 and whose flight and trace dumps land in the
               directory. The paged engine then prints one profiled
               turn's idle share beside its phase counters, and
               ``tracer_overhead_pct`` from three alternating on / off
               turn pairs (fails above 20%); then an echo-loop A/B on the
               runtime alone (``bench.py``'s ``_echo_loop``).
7. decode_loop -- graph against eager on Llama-3-8B (``LOOP_LLAMA``: paged
               bf16 and int8 chunked, dense chunked, paged bf16 and dense
               single-step): per mode one engine whose ``warmup`` (on a
               fresh thread) captures the three variants, four requests
               admitted, then one greedy chunk replayed and the same chunk
               run eagerly from the same saved state: greedy tokens equal,
               logprobs within 2e-2, the ms per chunk each way (CUDA
               events, median of 20), launches per replay, the graph
               pool's bytes; in the paged single-step mode the decode
               kernel's device time inside a replayed chunk beside its
               time alone and its fixed cost.

7b. rolling -- rolling KV and the three conversation tiers on Llama-3-8B
               at full width (the serve phase's weights and settings:
               max_batch 8, max_seq 1024, chunk 8, pages of 16, graphs
               captured at start): ``bench.py``'s ``bench_swarm1M`` cut to
               one card -- 12 users x 4 assistants, one ~600-token context
               turn each, then three rounds of 48 ~40-token deltas drawn
               Zipf(1.1) (numpy seed 0), 32 new tokens, at most 10 in
               flight -- on the paged engine over bf16 and int8 pools (769
               pages; ``SWARMDB_TIER_WARM_MB=1024``, min idle 0.05 s) and
               the dense engine (rolling and eviction only). Prints turns
               and prefill tokens by origin (hot / warm / cold / fresh /
               keep / plain), TTFT by origin, restarts, evictions, tier
               counters, pages by tier, ms per page of demotion and of
               promotion, pinned host bytes, peak device memory and the
               launches. Fails unless every reply ends length / eos, each
               paged engine shows a hot, a warm and a cold resume, and page
               custody balances (free + registry + retired slots + prefix
               cache = the pool). Each paged engine then runs ``tier_ab``:
               a conversation demoted to pinned host memory and promoted
               back must have its pool bytes equal (``torch.equal``) and
               its next greedy turn equal to the same turn kept hot; the
               engine otherwise idle, the turn's TTFT kept hot, promoted
               (warm) and re-prefilled whole (cold) is printed.
               PyTorch's page-locked bytes are read before each engine and
               after it stopped: a stopped engine may leave at most
               ``ROLL_PINNED_SLACK`` (64 MiB) behind.
7c. lanes -- lane groups and the fleet on Llama-3-8B at full width, the
               serve phase's weights shared by two lanes on one card
               (``build_serving_engine`` over ``["cuda:0", "cuda:0"]``: 2
               lanes x 4 slots, 513 pages of 16 per lane, each lane its
               own CUDA stream, graphs captured by ``warmup()``): (1) the
               supervised group through SwarmDB + LocalBroker +
               ServingService, 8 users x 2 turns of ~400 tokens, 32 new
               tokens: every reply length / eos, both lanes serving, each
               conversation's turns on one lane, turn 2 reusing pages on
               both, lanes 0 and 1 equal on a greedy prompt; per lane its
               requests, ragged waves, chunks and waves admitted while the
               sibling decoded; flight steps stamped with lanes 0 and 1
               and the runtime's sentinel on both lane engines; TTFT,
               tokens/s, peak memory; one profiled
               turn (device busy as the union of both streams' kernel
               intervals, beside their sum). (2) 4 greedy streams on lane
               1, ``ServingChaos.kill_lane(1)`` at the 8th token: they
               migrate to lane 0 and end "length" with the undisturbed
               tokens, lane 1 is restarted, probed and re-admitted,
               custody balances on both lanes. (3)
               ``SWARMDB_FLEET=prefill:1,decode:1`` with a 1 GiB transit
               store over bf16 and int8 pools: 8 requests of ~400 tokens
               hand off with no fallback, the prefill lane runs no decode
               chunk and the decode lane no ragged wave, custody balances
               and the transit store empties; handoff ms, gather and
               insert ms per page, page-locked bytes before and after,
               staged against colocated TTFT. Greedy streams that part
               from their reference (migrated, or handed off) must part
               where the plain forward's top-2 gap is below the measured
               max logit difference of the two paths at the first step
               (``first_step_logit_diff``), a near tie.
8. mixtral -- Mixtral-8x7B at full width (dim 4096, 32 / 8 heads of 128,
               8 experts of FFN 14336, top-2, vocab 32000, rope theta 1e6)
               and 16 of its 32 layers (``reduced``: all 32 do not fit one
               80 GB card), bf16 weights from seed 0, after Llama-3-8B's
               are freed. Layer 0's MoE block timed at a decode step and
               an 8 x 256 prefill wave, whole and its expert products alone,
               with the kernels each launches. Then six serves through
               SwarmDB + LocalBroker + ServingService (max_batch 8,
               max_seq 1024, decode_chunk 8, page 16, prefix cache on) of
               ``function_call`` messages (``bench.py``'s tool-use payload),
               4 users, 32 new tokens: the default dense engine chunked
               (3 turns) and single-step (1), the paged engine over bf16
               and int8 pools, chunked (3 turns) and single-step (1). A
               tool call renders differently in its own turn and in later
               history, so turn 2 shares no full page with turn 1 and turn
               3 reuses turn 2's pages. Checks every reply is a
               ``function_result`` ending length/eos, prefix reuse by turn
               3, the path's decode kernel (7, 8, 2, 5, 3, 6) and no other
               launched 16 times per decode step, kernels 1 and 4 never
               (Mixtral prefills in row-bucketed waves); prints TTFT,
               decode tokens/s, weight, KV and cache sizes, peak memory and
               the decode step (engine wall, and one step timed alone)
               beside its byte bound. The dense and paged bf16 chunked
               serves profile one more turn (device time by kernel, GEMMs,
               indexing, the decode kernel, idle share). Then the
               decode_loop comparison on Mixtral (``LOOP_MIXTRAL``: dense
               and paged bf16 chunked), its step beside the byte bound. A
               seventh serve repeats the paged bf16 chunked one with
               ``SWARMDB_ROLLING_KV=1``; the tokens each turn prefilled are
               printed beside the non-rolling serve's.

Then one ``{"kernels": [...]}`` line (launches summed over the six Llama
serves, the api, obs, rolling and lanes phases and the seven Mixtral
serves,
each counted from zero
just before it and read just after; a graph replay adds the launches its
capture recorded) and, last,
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
PEAK_BF16_FLOPS = 989e12        # dense tensor cores, same data sheet


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ------------------------------------------------------------------ timing


def time_graph(fn, reps: int = 10, iters: int = 30) -> float:
    """Median device ms of one ``fn()`` call: ``reps`` calls captured in a
    CUDA graph (no host launch gaps), replayed ``iters`` times between
    CUDA events after warm-up."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_events(graph.replay, iters) / reps


def time_events(fn, iters: int = 30) -> float:
    """Median ms of one eager ``fn()`` call between CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return _median_events(fn, iters)


def _median_events(fn, iters: int) -> float:
    import torch

    pairs = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, flops: float) -> tuple:
    """(least ms the card could take for bf16 work, what bounds it)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_BF16_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------- kernel cases


HQ, HKV, D, PS, MAXP, NPAGES = 32, 8, 128, 16, 64, 769
LANE = MAXP * PS                                   # dense slot length
STARTS = [37, 300, 1000, 5, 513, 128, 777, 250]   # the decode slots


def page_args(pdt, dev, g):
    """K/V pages of the 769-page pool as the wrappers take them: plain
    pages in ``pdt``, or for ``torch.int8`` the port's quantization of
    the same draws (``k_pages``/``k_scale``/``v_pages``/``v_scale``)."""
    import torch

    from swarmdb_tpu_torch.ops.paged_kv import _quantize_pages

    kp = torch.randn(NPAGES, PS, HKV, D, generator=g)
    vp = torch.randn(NPAGES, PS, HKV, D, generator=g)
    if pdt == torch.int8:
        (kq, ks), (vq, vs) = _quantize_pages(kp), _quantize_pages(vp)
        return dict(k_pages=kq.to(dev), k_scale=ks.to(dev),
                    v_pages=vq.to(dev), v_scale=vs.to(dev))
    return dict(k_pages=kp.to(pdt).to(dev), v_pages=vp.to(pdt).to(dev))


def side_dtype(qdt, pdt):
    """The chunk buffer / packed suffix dtype of a case: the pages' for
    plain pages, the query's for int8 pages (their logical dtype is bf16;
    an f32 case keeps the whole check in f32)."""
    import torch

    return qdt if pdt == torch.int8 else pdt


def decode_case(qdt, pdt, dev, window=None):
    """The chunked decode step's inputs at the serving shape: 8 slots with
    mixed chunk starts, pages drawn from the 769-page pool, chunk of 8 at
    step 5."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(1)
    B, Kc, step = 8, 8, 5
    perm = torch.randperm(NPAGES - 1, generator=g)[:B * MAXP] + 1
    table = perm.reshape(B, MAXP).to(torch.int32)
    cdt = side_dtype(qdt, pdt)
    r = lambda dt, *s: torch.randn(*s, generator=g).to(dt).to(dev)
    return dict(q=r(qdt, B, HQ, D), **page_args(pdt, dev, g),
                page_table=table.to(dev), chunk_k=r(cdt, B, Kc, HKV, D),
                chunk_v=r(cdt, B, Kc, HKV, D),
                starts=torch.tensor(STARTS, dtype=torch.int32).to(dev),
                step=step, window=window)


def single_case(qdt, pdt, dev, window=None):
    """The single-step decode's inputs: the same slots, each attending its
    pages up to its position (lengths = start + 6, as after step 5)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(3)
    B = 8
    perm = torch.randperm(NPAGES - 1, generator=g)[:B * MAXP] + 1
    table = perm.reshape(B, MAXP).to(torch.int32)
    q = torch.randn(B, HQ, D, generator=g).to(qdt).to(dev)
    return dict(q=q, **page_args(pdt, dev, g), page_table=table.to(dev),
                lengths=torch.tensor([s + 6 for s in STARTS],
                                     dtype=torch.int32).to(dev),
                window=window)


def prefill_case(qdt, pdt, dev, window=None):
    """A 512-token ragged wave over 8 rows: prefix rows (96 and 512 cached
    tokens), a fresh row, a split row (its head already written, 250
    tokens), dead rows."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(2)
    R, W = 8, 512
    lens = torch.tensor([150, 0, 120, 130, 112, 0, 0, 0], dtype=torch.int32)
    plens = torch.tensor([96, 0, 0, 250, 512, 0, 0, 0], dtype=torch.int32)
    starts = torch.zeros(R, dtype=torch.int32)
    starts[1:] = torch.cumsum(lens, 0)[:-1].to(torch.int32)
    perm = torch.randperm(NPAGES - 1, generator=g)[:R * MAXP] + 1
    tables = perm.reshape(R, MAXP).to(torch.int32)
    sdt = side_dtype(qdt, pdt)
    r = lambda dt, *s: torch.randn(*s, generator=g).to(dt).to(dev)
    to = lambda t: t.to(dev)
    q, sk, sv = r(qdt, W, HQ, D), r(sdt, W, HKV, D), r(sdt, W, HKV, D)
    return dict(q=q, sfx_k=sk, sfx_v=sv, **page_args(pdt, dev, g),
                row_tables=to(tables), starts=to(starts), lens=to(lens),
                prefix_lens=to(plens), window=window)


def wide_prefill_case(qdt, pdt, dev, window=None):
    """A turn-1 wave of width 1024: four fresh rows of ~250 tokens, no
    prefix, four dead rows (the compute-heavy end of the prefill)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(8)
    R, W = 8, 1024
    lens = torch.tensor([250, 262, 241, 255, 0, 0, 0, 0], dtype=torch.int32)
    starts = torch.zeros(R, dtype=torch.int32)
    starts[1:] = torch.cumsum(lens, 0)[:-1].to(torch.int32)
    perm = torch.randperm(NPAGES - 1, generator=g)[:R * MAXP] + 1
    sdt = side_dtype(qdt, pdt)
    r = lambda dt, *s: torch.randn(*s, generator=g).to(dt).to(dev)
    return dict(q=r(qdt, W, HQ, D), sfx_k=r(sdt, W, HKV, D),
                sfx_v=r(sdt, W, HKV, D), **page_args(pdt, dev, g),
                row_tables=perm.reshape(R, MAXP).to(torch.int32).to(dev),
                starts=starts.to(dev), lens=lens.to(dev),
                prefix_lens=torch.zeros(R, dtype=torch.int32).to(dev),
                window=window)


#: Rows of query heads x tokens per block of the tensor-core prefill body
#: (csrc/ragged_prefill_mma.cuh): a query tile holds 64 // G tokens.
MMA_ROWS = 64


def prefill_sweep():
    """Sixteen waves that walk the prefill's edges, as (label, spec)
    pairs; ``sweep_case`` turns a spec into wrapper arguments. Specs name
    the GQA group G, the head dim, the KV heads, the table width (maxp
    pages of 16), the rows' lengths and prefix lengths, the stream width W
    and the window. Covered: row lengths 1, QT - 1, QT, QT + 1 (QT = 64 //
    G tokens per query tile) and a row filling the stream; prefixes ending
    mid-page, mid-tile and past the table's coverage; dead rows; W not a
    multiple of QT; windows of 1, below the 64-key tile and above the
    prefix; G 1 / 2 / 4 / 8; every head dim the body is built for (16, 32,
    64, 128), each in a wave the launch runs with one warp group per block
    and in one it runs with two."""
    import random

    def spec(G, Dh, Hkv, maxp, lens, plens, window, pad=3):
        return dict(G=G, D=Dh, Hkv=Hkv, maxp=maxp, lens=list(lens),
                    plens=list(plens), W=sum(lens) + pad, window=window)

    edges = lambda QT: [1, QT - 1, QT, QT + 1]
    waves = [
        ("g4_d128_edges", spec(4, 128, 8, 32, edges(16) + [0, 37],
                               [0, 24, 64, 100, 0, 1000], None)),
        ("g4_d128_edges_w1", spec(4, 128, 8, 32, edges(16) + [0, 37],
                                  [0, 24, 64, 100, 0, 1000], 1)),
        ("g1_d64_w40", spec(1, 64, 4, 32, edges(64) + [200],
                            [130, 0, 31, 512, 700], 40)),
        ("g8_d128_w700", spec(8, 128, 2, 40, edges(8) + [0, 0, 50],
                              [80, 5, 0, 640, 0, 0, 333], 700)),
        ("g4_d128_full_row", spec(4, 128, 8, 32, [300, 0, 0], [77, 0, 0],
                                  None, pad=0)),
        ("g8_d64_full_row_w1", spec(8, 64, 4, 16, [0, 203], [0, 256], 1,
                                    pad=0)),
        ("g2_d16_edges", spec(2, 16, 2, 16, edges(32) + [0, 45],
                              [0, 15, 16, 33, 0, 300], None)),
        ("g2_d16_full_row_w40", spec(2, 16, 8, 16, [0, 700], [0, 100], 40,
                                     pad=0)),
        ("g2_d32_w1", spec(2, 32, 4, 24, edges(32) + [150],
                           [17, 0, 200, 64, 500], 1)),
        ("g8_d32_full_row", spec(8, 32, 8, 16, [0, 700], [0, 100], None,
                                 pad=0)),
    ]
    rnd = random.Random(20)
    while len(waves) < 16:
        G, Dh = rnd.choice((1, 4, 8)), rnd.choice((64, 128))
        R, maxp = 8, rnd.choice((16, 32, 48))
        lens = [rnd.choice((0, 1, rnd.randint(2, 160))) for _ in range(R)]
        lens[rnd.randrange(R)] = rnd.randint(64 // G + 1, 200)
        plens = [rnd.choice((0, rnd.randint(1, maxp * 16),
                             maxp * 16 + rnd.randint(1, 300)))
                 for _ in range(R)]
        window = rnd.choice((None, 1, 40, 700))
        waves.append((f"random{len(waves)}_g{G}_d{Dh}",
                      spec(G, Dh, 32 // max(G, 4), maxp, lens, plens, window,
                           pad=rnd.randint(0, 20))))
    return waves


def sweep_case(sp, quant, dev, seed):
    """Wrapper arguments of one sweep wave: bf16 query and suffix over bf16
    pages, or over int8 pages (the port's quantization of the same draws)
    for ``quant``; each row's table a fresh draw of the pool's pages."""
    import torch

    from swarmdb_tpu_torch.ops.paged_kv import _quantize_pages

    g = torch.Generator(device="cpu").manual_seed(seed)
    G, Dh, Hkv, maxp = sp["G"], sp["D"], sp["Hkv"], sp["maxp"]
    R, W = len(sp["lens"]), sp["W"]
    lens = torch.tensor(sp["lens"], dtype=torch.int32)
    starts = torch.zeros(R, dtype=torch.int32)
    starts[1:] = torch.cumsum(lens, 0)[:-1].to(torch.int32)
    n_pages = R * maxp + 1
    tables = (torch.randperm(n_pages - 1, generator=g) + 1).reshape(R, maxp)
    r = lambda *s: torch.randn(*s, generator=g)
    bf = torch.bfloat16
    kp, vp = r(n_pages, PS, Hkv, Dh), r(n_pages, PS, Hkv, Dh)
    if quant:
        (kq, ks), (vq, vs) = _quantize_pages(kp), _quantize_pages(vp)
        pages = dict(k_pages=kq.to(dev), k_scale=ks.to(dev),
                     v_pages=vq.to(dev), v_scale=vs.to(dev))
    else:
        pages = dict(k_pages=kp.to(bf).to(dev), v_pages=vp.to(bf).to(dev))
    return dict(q=r(W, G * Hkv, Dh).to(bf).to(dev),
                sfx_k=r(W, Hkv, Dh).to(bf).to(dev),
                sfx_v=r(W, Hkv, Dh).to(bf).to(dev), **pages,
                row_tables=tables.to(torch.int32).to(dev),
                starts=starts.to(dev), lens=lens.to(dev),
                prefix_lens=torch.tensor(sp["plens"],
                                         dtype=torch.int32).to(dev),
                window=sp["window"])


def run_prefill_sweep(dev, name, sp_kernel, tol=2e-2):
    """The prefill kernel ``name`` against its plain version on every
    sweep wave; fails on an error above ``tol``. Returns the errors."""
    return {label: check_kernel(
                name, sp_kernel, sweep_case(sp, sp_kernel["quant"], dev,
                                            seed=100 + i), tol,
                f"sweep {label}")
            for i, (label, sp) in enumerate(prefill_sweep())}


#: Positions per key tile and cluster ranks per (slot, KV head) of the
#: decode body (csrc/decode.cuh): a slot's tiles go to the ranks in turn.
DECODE_KT, DECODE_SPLIT = 32, 8


def decode_sweep():
    """Waves that walk the decode body's edges, as (label, spec) pairs;
    ``decode_sweep_case`` turns a spec into the arguments of any of the six
    decode entry points. A spec names the GQA group G, the head dim, the
    KV heads, the table width (maxp pages of 16: the coverage, also the
    dense lanes' length), the slots' lengths (a single step's lengths, a
    chunked step's starts), the chunk (Kc entries, this step's index), the
    window and the page table's kind (``perm``: a permutation of the pool;
    ``repeat``: ids repeated within and across rows; ``wild``: ids below 0
    and past the pool, which the kernels clamp). Covered: lengths 0, 1, <
    KT, NS * KT, NS * KT + 1, at and past the coverage; slots shorter than
    NS tiles (empty ranks); windows of 1, below a tile and spanning several
    ranks; step 0 and Kc - 1; G 1 / 2 / 4 / 8; D 16 / 32 / 64 / 128; one
    slot, and a batch whose grid has more clusters than the H100 has SMs;
    repeated and out-of-range page ids."""
    import random

    def spec(G, Dh, Hkv, maxp, lens, Kc=8, step=5, window=None,
             table="perm"):
        return dict(G=G, D=Dh, Hkv=Hkv, maxp=maxp, lens=list(lens), Kc=Kc,
                    step=step, window=window, table=table)

    edges = [1, 17, 256, 257, 384, 400, 40, 0]   # coverage 24 * 16 = 384
    rnd = random.Random(21)
    waves = [
        ("g4_d128_lengths", spec(4, 128, 2, 24, edges, step=0)),
        ("g4_d128_w1_last_step", spec(4, 128, 2, 24, edges, step=7,
                                      window=1)),
        ("g1_d64_w20", spec(1, 64, 4, 20, [300, 33, 257, 320, 5], Kc=4,
                            step=3, window=20)),
        ("g8_d32_w200", spec(8, 32, 2, 24, [384, 256, 100, 500, 1], step=2,
                             window=200)),
        ("g2_d16_repeat", spec(2, 16, 4, 16, [256, 257, 31, 32, 200],
                               Kc=16, step=15, table="repeat")),
        ("g4_d64_wild", spec(4, 64, 2, 16, [256, 100, 3, 257], step=0,
                             table="wild")),
        ("b1_g4_d128_w96", spec(4, 128, 8, 64, [1006], window=96)),
        ("b20_g4_d64", spec(4, 64, 8, 20, [rnd.randint(1, 320)
                                           for _ in range(20)], step=3)),
        ("g8_d128_w1", spec(8, 128, 1, 32, [512, 7, 258], step=7,
                            window=1)),
        ("g2_d32_w33", spec(2, 32, 8, 8, [128, 129, 64, 0], Kc=4, step=0,
                            window=33)),
    ]
    while len(waves) < 14:
        G, Dh = rnd.choice((1, 2, 4, 8)), rnd.choice((16, 32, 64, 128))
        maxp, Kc = rnd.choice((8, 16, 40)), rnd.choice((4, 8, 16))
        cov = maxp * PS
        lens = [rnd.choice((0, 1, rnd.randint(2, cov), cov + 7,
                            DECODE_KT * rnd.randint(1, 9)))
                for _ in range(rnd.randint(1, 9))]
        waves.append((f"random{len(waves)}_g{G}_d{Dh}", spec(
            G, Dh, rnd.choice((1, 2, 4)), maxp, lens, Kc=Kc,
            step=rnd.randrange(Kc), window=rnd.choice((None, 1, 20, 300)),
            table=rnd.choice(("perm", "repeat", "wild")))))
    return waves


#: The six decode entry points: (paged, int8 pages, chunked).
DECODE_KINDS = {
    "paged_decode_chunked": (True, False, True),
    "paged_decode": (True, False, False),
    "paged_decode_chunked_quant": (True, True, True),
    "paged_decode_quant": (True, True, False),
    "dense_decode_chunked": (False, False, True),
    "dense_decode": (False, False, False),
}


def decode_sweep_case(sp, name, dt, dev, seed):
    """Arguments of decode entry point ``name`` on sweep wave ``sp``: query,
    chunk buffer and plain pages or lanes in ``dt`` (torch.bfloat16 or
    torch.float32), or int8 pages (the port's quantization of the same
    draws) for the ``_quant`` entry points."""
    import torch

    from swarmdb_tpu_torch.ops.paged_kv import _quantize_pages

    paged, quant, chunked = DECODE_KINDS[name]
    g = torch.Generator(device="cpu").manual_seed(seed)
    G, Dh, Hkv, maxp = sp["G"], sp["D"], sp["Hkv"], sp["maxp"]
    B, cov = len(sp["lens"]), maxp * PS
    r = lambda *s: torch.randn(*s, generator=g)
    to = lambda t, d=dt: t.to(d).to(dev)
    c = dict(q=to(r(B, G * Hkv, Dh)), window=sp["window"])
    if paged:
        n_pages = B * maxp + 1
        if sp["table"] == "repeat":
            table = torch.randint(1, 4, (B, maxp), generator=g)
        else:
            table = torch.randperm(n_pages - 1, generator=g) + 1
            table = table.reshape(B, maxp)
            if sp["table"] == "wild":
                table[:, ::3] = -5
                table[:, 1::4] = n_pages + 7
        kp, vp = r(n_pages, PS, Hkv, Dh), r(n_pages, PS, Hkv, Dh)
        if quant:
            (kq, ks), (vq, vs) = _quantize_pages(kp), _quantize_pages(vp)
            c.update(k_pages=kq.to(dev), k_scale=ks.to(dev),
                     v_pages=vq.to(dev), v_scale=vs.to(dev))
        else:
            c.update(k_pages=to(kp), v_pages=to(vp))
        c["page_table"] = to(table, torch.int32)
    else:
        c.update(cache_k=to(r(B, cov, Hkv, Dh)),
                 cache_v=to(r(B, cov, Hkv, Dh)))
    lens = to(torch.tensor(sp["lens"]), torch.int32)
    if chunked:
        Kc = sp["Kc"]
        c.update(chunk_k=to(r(B, Kc, Hkv, Dh)), chunk_v=to(r(B, Kc, Hkv, Dh)),
                 starts=lens, step=sp["step"])
    else:
        c["lengths"] = lens
    return c


def run_decode_sweep(dev, name, sp_kernel):
    """Decode entry point ``name`` against its plain version on every sweep
    wave, bf16 within 2e-2 and f32 within 1e-4 (int8 pages under a bf16
    or an f32 query); fails on a larger error. Returns the errors."""
    import torch

    errs = {}
    for i, (label, sp) in enumerate(decode_sweep()):
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            key = f"{label}_{str(dt)[6:]}"
            errs[key] = check_kernel(
                name, sp_kernel, decode_sweep_case(sp, name, dt, dev,
                                                   seed=200 + i),
                tol, f"sweep {key}")
    return errs


def check_kernel(name, sp, c, tol, key):
    """Kernel ``name`` against its plain version on case ``c``: fails if
    the output's dtype is not the query's or the largest absolute error is
    above ``tol``; returns the error."""
    import torch

    got = sp["kernel"](**c)
    want = sp["plain"](**c)
    torch.cuda.synchronize()
    if got.dtype != c["q"].dtype:
        fail(f"{name} {key}: output {got.dtype}, query {c['q'].dtype}")
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        fail(f"{name} {key}: max abs err {err} > {tol}")
    return err


def dense_chunked_case(qdt, cdt, dev, window=None):
    """The dense chunked decode step at the serving shape: 8 slots of a
    [8, 1024, 8, 128] slot cache with the same chunk starts (each lane
    full of draws past its start: a prefill's padding garbage), chunk of
    8 at step 5."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(4)
    B, Kc, step = 8, 8, 5
    r = lambda dt, *s: torch.randn(*s, generator=g).to(dt).to(dev)
    return dict(q=r(qdt, B, HQ, D), cache_k=r(cdt, B, LANE, HKV, D),
                cache_v=r(cdt, B, LANE, HKV, D),
                chunk_k=r(cdt, B, Kc, HKV, D), chunk_v=r(cdt, B, Kc, HKV, D),
                starts=torch.tensor(STARTS, dtype=torch.int32).to(dev),
                step=step, window=window)


def dense_single_case(qdt, cdt, dev, window=None):
    """The dense single-step decode: the same slots, each attending its
    lane up to its position (lengths = start + 6, as after step 5)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(5)
    B = 8
    r = lambda dt, *s: torch.randn(*s, generator=g).to(dt).to(dev)
    return dict(q=r(qdt, B, HQ, D), cache_k=r(cdt, B, LANE, HKV, D),
                cache_v=r(cdt, B, LANE, HKV, D),
                lengths=torch.tensor([s + 6 for s in STARTS],
                                     dtype=torch.int32).to(dev),
                window=window)


def _nbytes(t):
    return t.numel() * t.element_size()


def _lane_rows_bytes(c, positions):
    """Bytes of ``positions`` K and V rows of the case's dense lanes."""
    return sum(positions) * HKV * D * c["cache_k"].element_size() * 2


def _page_rows_bytes(c, positions):
    """Bytes of ``positions`` K and V rows of the case's pages, plus the
    scale rows of the pages they lie in (int8 pools)."""
    kp = c["k_pages"]
    rows = sum(positions) * HKV * D * kp.element_size() * 2
    if "k_scale" in c:
        pages = sum(-(-p // PS) for p in positions)
        rows += pages * HKV * c["k_scale"].element_size() * 2
    return rows


def decode_work(c):
    B = c["q"].shape[0]
    keys = sum(c["starts"].tolist()) + B * (c["step"] + 1)
    chunk_rows = B * (c["step"] + 1) * HKV * D * c["chunk_k"].element_size()
    nbytes = (2 * _nbytes(c["q"])                       # q in, out
              + _page_rows_bytes(c, c["starts"].tolist())
              + 2 * chunk_rows
              + _nbytes(c["page_table"]) + _nbytes(c["starts"]))
    return nbytes, 4.0 * HQ * D * keys


def single_work(c):
    lengths = c["lengths"].tolist()
    nbytes = (2 * _nbytes(c["q"]) + _page_rows_bytes(c, lengths)
              + _nbytes(c["page_table"]) + _nbytes(c["lengths"]))
    return nbytes, 4.0 * HQ * D * sum(lengths)


def dense_chunked_work(c):
    B = c["q"].shape[0]
    keys = sum(c["starts"].tolist()) + B * (c["step"] + 1)
    chunk_rows = B * (c["step"] + 1) * HKV * D * c["chunk_k"].element_size()
    nbytes = (2 * _nbytes(c["q"]) + _lane_rows_bytes(c, c["starts"].tolist())
              + 2 * chunk_rows + _nbytes(c["starts"]))
    return nbytes, 4.0 * HQ * D * keys


def dense_single_work(c):
    lengths = c["lengths"].tolist()
    nbytes = (2 * _nbytes(c["q"]) + _lane_rows_bytes(c, lengths)
              + _nbytes(c["lengths"]))
    return nbytes, 4.0 * HQ * D * sum(lengths)


def prefill_work(c):
    lens = c["lens"].tolist()
    plens = c["prefix_lens"].tolist()
    keys = sum(n * p + n * (n + 1) // 2 for n, p in zip(lens, plens))
    nbytes = (2 * _nbytes(c["q"]) + _nbytes(c["sfx_k"]) + _nbytes(c["sfx_v"])
              + _page_rows_bytes(c, [p for p, n in zip(plens, lens) if n])
              + _nbytes(c["row_tables"]) + 3 * len(lens) * 4)
    return nbytes, 4.0 * HQ * D * keys


def dense_pages(c):
    """The case with int8 pages replaced by their dequantized values in
    the query's dtype (what one library call would read); plain pages as
    they are."""
    from swarmdb_tpu_torch.ops.paged_kv import _dequantize_pages

    if "k_scale" not in c:
        return c
    out = {k: v for k, v in c.items() if k not in ("k_scale", "v_scale")}
    for x in "kv":
        out[f"{x}_pages"] = _dequantize_pages(
            c[f"{x}_pages"], c[f"{x}_scale"]).to(c["q"].dtype)
    return out


def decode_library(c):
    """SDPA over the gathered dense view: pages + chunk buffer per slot,
    a boolean mask for the live positions (the gather is done here, once,
    outside the timed call)."""
    import torch

    from swarmdb_tpu_torch.ops.paged_kv import paged_gather_kv

    c = dense_pages(c)
    kg, vg = paged_gather_kv(c["k_pages"], c["v_pages"], c["page_table"])
    k = torch.cat([kg, c["chunk_k"].to(kg.dtype)], 1)   # [B, S+Kc, Hkv, D]
    v = torch.cat([vg, c["chunk_v"].to(vg.dtype)], 1)
    S = kg.shape[1]
    Kc = c["chunk_k"].shape[1]
    pos = torch.arange(S + Kc, device=k.device)
    st = c["starts"].long()[:, None]
    live = torch.where(pos < S, pos[None] < st, pos[None] - S <= c["step"])
    return _sdpa_decode(c["q"], k, v, live)


def single_library(c):
    """SDPA over the gathered dense pages, masked to each slot's length."""
    import torch

    from swarmdb_tpu_torch.ops.paged_kv import paged_gather_kv

    c = dense_pages(c)
    k, v = paged_gather_kv(c["k_pages"], c["v_pages"], c["page_table"])
    pos = torch.arange(k.shape[1], device=k.device)
    return _sdpa_decode(c["q"], k, v,
                        pos[None] < c["lengths"].long()[:, None])


def dense_chunked_library(c):
    """SDPA straight over each slot's lane plus its chunk buffer (the
    concatenation is done here, once, outside the timed call), masked to
    positions < start and chunk entries <= step."""
    import torch

    k = torch.cat([c["cache_k"], c["chunk_k"].to(c["cache_k"].dtype)], 1)
    v = torch.cat([c["cache_v"], c["chunk_v"].to(c["cache_v"].dtype)], 1)
    Kc = c["chunk_k"].shape[1]
    pos = torch.arange(LANE + Kc, device=k.device)
    st = c["starts"].long()[:, None]
    live = torch.where(pos < LANE, pos[None] < st,
                       pos[None] - LANE <= c["step"])
    return _sdpa_decode(c["q"], k, v, live)


def dense_single_library(c):
    """SDPA straight over the lanes (no gather), masked to each slot's
    length."""
    import torch

    pos = torch.arange(LANE, device=c["q"].device)
    return _sdpa_decode(c["q"], c["cache_k"], c["cache_v"],
                        pos[None] < c["lengths"].long()[:, None])


def _sdpa_decode(q, k, v, live):
    import torch.nn.functional as F

    G = HQ // HKV
    q = q[:, :, None]                                   # [B, Hq, 1, D]
    k = k.transpose(1, 2).repeat_interleave(G, 1).contiguous()
    v = v.transpose(1, 2).repeat_interleave(G, 1).contiguous()
    mask = live[:, None, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def prefill_library(c):
    """SDPA over a dense [rows, Hq, L, S] view of the wave: each live row's
    prefix keys then its suffix keys, a causal-plus-prefix mask."""
    import torch
    import torch.nn.functional as F

    c = dense_pages(c)
    lens = c["lens"].tolist()
    plens = c["prefix_lens"].tolist()
    starts = c["starts"].tolist()
    rows = [r for r, n in enumerate(lens) if n]
    Lm = max(lens[r] for r in rows)
    Sm = max(plens[r] + lens[r] for r in rows)
    dev, dt = c["q"].device, c["q"].dtype
    G = HQ // HKV
    q = torch.zeros(len(rows), HQ, Lm, D, device=dev, dtype=dt)
    k = torch.zeros(len(rows), HQ, Sm, D, device=dev, dtype=dt)
    v = torch.zeros_like(k)
    mask = torch.zeros(len(rows), 1, Lm, Sm, device=dev, dtype=torch.bool)
    for i, r in enumerate(rows):
        n, p, s = lens[r], plens[r], starts[r]
        pages = c["row_tables"][r, :(p + PS - 1) // PS].long()
        pk = c["k_pages"][pages].reshape(-1, HKV, D)[:p].to(dt)
        pv = c["v_pages"][pages].reshape(-1, HKV, D)[:p].to(dt)
        kk = torch.cat([pk, c["sfx_k"][s:s + n].to(dt)]).transpose(0, 1)
        vv = torch.cat([pv, c["sfx_v"][s:s + n].to(dt)]).transpose(0, 1)
        q[i, :, :n] = c["q"][s:s + n].transpose(0, 1)
        k[i, :, :p + n] = kk.repeat_interleave(G, 0)
        v[i, :, :p + n] = vv.repeat_interleave(G, 0)
        qi = torch.arange(n, device=dev)[:, None]
        kj = torch.arange(Sm, device=dev)[None]
        mask[i, 0, :n] = kj <= p + qi
    mask[:, :, :, 0] |= True   # padded query rows: keep softmax finite
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def kernel_specs():
    """The eight kernels: wrapper, plain version, case, work, library
    call, source and the TPU kernel each replaces."""
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    pallas = "swarmdb_tpu/ops/attention_pallas.py"
    csrc = "swarmdb_tpu_torch/csrc"
    pre = dict(case=prefill_case, work=prefill_work, library=prefill_library)
    chk = dict(case=decode_case, work=decode_work, library=decode_library)
    one = dict(case=single_case, work=single_work, library=single_library)
    dchk = dict(case=dense_chunked_case, work=dense_chunked_work,
                library=dense_chunked_library)
    done = dict(case=dense_single_case, work=dense_single_work,
                library=dense_single_library)
    return {
        "ragged_prefill": dict(
            pre, quant=False, kernel=ac.ragged_paged_prefill_attention,
            plain=ac.ragged_prefill_plain,
            source=f"{csrc}/ragged_prefill.cu", replaces=f"{pallas}:356"),
        "paged_decode_chunked": dict(
            chk, quant=False, kernel=ac.paged_decode_gqa_attention_chunked,
            plain=ac.paged_decode_chunked_plain,
            source=f"{csrc}/paged_decode_chunked.cu",
            replaces=f"{pallas}:211"),
        "paged_decode": dict(
            one, quant=False, kernel=ac.paged_decode_gqa_attention,
            plain=ac.paged_decode_plain, source=f"{csrc}/paged_decode.cu",
            replaces=f"{pallas}:180"),
        "ragged_prefill_quant": dict(
            pre, quant=True, kernel=ac.ragged_paged_prefill_attention_quant,
            plain=ac.ragged_prefill_quant_plain,
            source=f"{csrc}/ragged_prefill_quant.cu",
            replaces=f"{pallas}:909"),
        "paged_decode_chunked_quant": dict(
            chk, quant=True,
            kernel=ac.paged_decode_gqa_attention_chunked_quant,
            plain=ac.paged_decode_chunked_quant_plain,
            source=f"{csrc}/paged_decode_chunked_quant.cu",
            replaces=f"{pallas}:791"),
        "paged_decode_quant": dict(
            one, quant=True, kernel=ac.paged_decode_gqa_attention_quant,
            plain=ac.paged_decode_quant_plain,
            source=f"{csrc}/paged_decode_quant.cu",
            replaces=f"{pallas}:696"),
        "dense_decode_chunked": dict(
            dchk, quant=False, kernel=ac.decode_gqa_attention_chunked,
            plain=ac.decode_chunked_plain,
            source=f"{csrc}/dense_decode_chunked.cu",
            replaces=f"{pallas}:513"),
        "dense_decode": dict(
            done, quant=False, kernel=ac.decode_gqa_attention,
            plain=ac.decode_plain, source=f"{csrc}/dense_decode.cu",
            replaces=f"{pallas}:43"),
    }


def run_kernels(dev):
    """Each kernel against its plain version (every dtype case, with and
    without a window), then timed in bf16 beside its plain version, one
    library call and its bound."""
    import torch

    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    rows = {}
    for name, sp in kernel_specs().items():
        checks = ([(bf, i8, 2e-2), (f32, i8, 1e-4)] if sp["quant"] else
                  [(bf, bf, 2e-2), (f32, f32, 1e-4), (f32, bf, 2e-2)])
        errs = {}
        for qdt, pdt, tol in checks:
            for window in (None, 96):
                key = f"q{str(qdt)[6:]}_p{str(pdt)[6:]}_w{window or 0}"
                errs[key] = check_kernel(
                    name, sp, sp["case"](qdt, pdt, dev, window), tol, key)
        prefill = sp["case"] is prefill_case
        if prefill:
            errs["sweep"] = run_prefill_sweep(dev, name, sp)
        else:
            errs["sweep"] = run_decode_sweep(dev, name, sp)
        pdt = i8 if sp["quant"] else bf
        rows[name] = time_kernel(name, sp, sp["case"](bf, pdt, dev), errs)
        if prefill:
            c = wide_prefill_case(bf, pdt, dev)
            key = f"qbfloat16_p{str(pdt)[6:]}_w0"
            wide = {key: check_kernel(name, sp, c, 2e-2, f"w1024 {key}")}
            time_kernel(name, sp, c, wide, shape="w1024_turn1")
        if name == "paged_decode":
            time_decode_lengths(dev, sp)
    return rows


def time_decode_lengths(dev, sp):
    """The bf16 single-step paged decode with all 8 slots at one length: 0
    (no live key: launch, cluster and merge alone), one key tile, one tile
    per cluster rank, four per rank (the table's whole coverage); each
    checked against the plain version, timed and emitted beside its bound
    in one ``decode_lengths`` line -- a call's fixed cost and its cost per
    tile."""
    import torch

    bf = torch.bfloat16
    out = {}
    for n in (0, DECODE_KT, DECODE_SPLIT * DECODE_KT, LANE):
        c = single_case(bf, bf, dev)
        c["lengths"] = torch.full_like(c["lengths"], n)
        err = check_kernel("paged_decode", sp, c, 2e-2, f"length {n}")
        out[f"L{n}"] = dict(ms=time_graph(lambda: sp["kernel"](**c)),
                            bound_ms=bound(*single_work(c))[0],
                            max_abs_err=err)
    emit("decode_lengths", kernel="paged_decode", **out)


def time_kernel(name, sp, c, errs, shape="serving"):
    """One kernel timed on case ``c`` beside its plain version, one library
    call and its bound; emits a ``kernels`` line and returns the kernel's
    row of the final ``{"kernels": [...]}`` line."""
    nbytes, flops = sp["work"](c)
    b_ms, b_by = bound(nbytes, flops)
    ms = time_graph(lambda: sp["kernel"](**c))
    plain_ms = time_events(lambda: sp["plain"](**c), iters=20)
    library_ms = time_graph(sp["library"](c))
    emit("kernels", kernel=name, shape=shape, errors=errs, ms=ms,
         plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
         bound_by=b_by, bytes=nbytes, flops=flops)
    return {
        "name": name, "route": "cuda", "source": sp["source"],
        "replaces": sp["replaces"], "launches": 0,
        "max_abs_err": errs[next(iter(errs))] if errs else None, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms}


# ------------------------------------------------------------------ parity


#: (name, cache dtype, chunked, logits bound, paged). An f32 pool or slot
#: cache holds 1e-4 (float32 sums in another order; the chunked step
#: there uses an f32 chunk buffer). A bf16 pool: the plain version
#: rounds the softmax weights to the pages' bf16 before the value product,
#: the kernels keep them in fp32 (the Pallas kernels' way); emulated on the
#: CPU this moves tiny-debug's logits by up to 1.4e-2. An int8 pool dequan-
#: tizes to f32 on both sides, but the packed suffix and the chunk buffer
#: are bf16, whose weights the plain version rounds (up to 3.5e-3 emulated),
#: and a K/V value that differs by float32 rounding between the card's and
#: the CPU's matmuls can flip one int8 code (amax / 127 of its page) where a
#: write requantizes a page.
PARITY_CASES = (("f32_chunked", "float32", True, 1e-4, True),
                ("f32_single_step", "float32", False, 1e-4, True),
                ("bf16_single_step", "bfloat16", False, 3e-2, True),
                ("int8_chunked", "int8", True, 2e-2, True),
                ("int8_single_step", "int8", False, 2e-2, True),
                ("dense_f32_chunked", "float32", True, 1e-4, False),
                ("dense_f32_single_step", "float32", False, 1e-4, False))


@contextlib.contextmanager
def env_scope(**values):
    """Environment variables set (a value of None: unset) for the block,
    restored after it."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def engine_env(chunked: bool, **values):
    """SWARMDB_CHUNKED set, and SWARMDB_PAGED unset, while an engine is
    built (both are read there), with any further ``values``."""
    return env_scope(SWARMDB_CHUNKED="1" if chunked else "0",
                     SWARMDB_PAGED=None, **values)


def parity_logits(p, cfg, d, kind, chunked):
    """Logits of one prefill wave and of decode steps (one chunked step
    with an f32 chunk buffer, or three single steps that write the pool)
    from the same seeded pool, on device ``d``."""
    import numpy as np
    import torch

    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.ops.paged_kv import QuantPool, _quantize_pages

    rng = np.random.default_rng(6)
    W, ps, maxp = 96, 16, 16
    toks = torch.from_numpy(rng.integers(3, 259, W).astype(np.int32))
    tok_row = torch.zeros(W, dtype=torch.int32)
    tok_row[60:] = 1
    tok_pos = torch.cat([torch.arange(60), torch.arange(36) + 20]).int()
    tables = torch.arange(1, 2 * maxp + 1, dtype=torch.int32).reshape(2, -1)
    starts = torch.tensor([0, 60], dtype=torch.int32)
    lens = torch.tensor([60, 36], dtype=torch.int32)
    plens = torch.tensor([0, 20], dtype=torch.int32)
    shape = (cfg.n_layers, 2 * maxp + 1, ps, cfg.n_kv_heads, cfg.head_dim)
    t = lambda x: x.to(d)

    def pools():
        kf, vf = (torch.randn(shape, generator=torch.Generator().manual_seed(
            s)) for s in (3, 13))
        if kind == "int8":
            return tuple(QuantPool(*map(t, _quantize_pages(x)))
                         for x in (kf, vf))
        return tuple(t(x.to(getattr(torch, kind))) for x in (kf, vf))

    kp, vp = pools()
    out = [llama.forward_ragged_prefill(
        p, cfg, t(toks), t(tok_row), t(tok_pos), t(tables), t(starts),
        t(lens), t(plens), kp, vp)[0]]
    kp, vp = pools()
    cache = {"k": kp, "v": vp, "page_table": t(tables)}
    if chunked:
        hk = torch.randn((cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.head_dim),
                         generator=torch.Generator().manual_seed(4))
        out.append(llama.forward_paged_chunked(
            p, cfg, t(toks[:2, None].long()), t(torch.tensor([[70], [90]])),
            cache, (t(hk), t(hk.clone())), 3)[0])
    else:
        for s in range(3):
            logits, cache = llama.forward_paged(
                p, cfg, t(toks[s:s + 2, None].long()),
                t(torch.tensor([[70 + s], [90 + s]])), cache)
            out.append(logits)
    return [x.cpu() for x in out]


def dense_parity_logits(p, cfg, d, chunked):
    """Logits of one bucketed dense prefill (two rows, the head at each
    row's last token) and of decode steps over a seeded f32 slot cache
    (one chunked step with an f32 chunk buffer, or three single steps that
    write the cache), on device ``d``."""
    import numpy as np
    import torch

    from swarmdb_tpu_torch.models import llama

    rng = np.random.default_rng(7)
    T, S = 64, 128
    toks = torch.from_numpy(rng.integers(3, 259, (2, T)).astype(np.int32))
    pos = torch.arange(T, dtype=torch.int32).expand(2, T)
    t = lambda x: x.to(d)
    temp = llama.init_kv_cache(cfg, 2, T, torch.float32, device=d)
    out = [llama.forward(p, cfg, t(toks), t(pos), temp,
                         logits_at=t(torch.tensor([T - 1, 40])))[0]]
    shape = (cfg.n_layers, 2, S, cfg.n_kv_heads, cfg.head_dim)
    cache = tuple(t(torch.randn(shape, generator=torch.Generator()
                                .manual_seed(s))) for s in (3, 13))
    if chunked:
        hk = torch.randn((cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.head_dim),
                         generator=torch.Generator().manual_seed(4))
        out.append(llama.forward_chunked(
            p, cfg, t(toks[:, :1]), t(torch.tensor([[70], [90]])), cache,
            (t(hk), t(hk.clone())), 3)[0])
    else:
        for s in range(3):
            logits, cache = llama.forward(
                p, cfg, t(toks[:, s:s + 1]),
                t(torch.tensor([[70 + s], [90 + s]])), cache)
            out.append(logits)
    return [x.cpu() for x in out]


def path_kernels(kind: str, chunked: bool, paged: bool,
                 ragged: bool = True) -> tuple:
    """The kernels an engine runs. Paged, over a ``kind`` pool: ragged
    prefill at admission (Llama; Mixtral's row-bucketed and prefix waves
    attend in plain PyTorch, as in the JAX package), then chunked or
    single-step decode. Dense: the dense decode kernel only (its prefill
    attention is plain PyTorch, as in the JAX package)."""
    if not paged:
        return ("dense_decode_chunked" if chunked else "dense_decode",)
    quant = "_quant" if kind == "int8" else ""
    decode = "paged_decode_chunked" if chunked else "paged_decode"
    return (("ragged_prefill" + quant,) if ragged else ()) + (decode + quant,)


#: (name, paged, chunked, SWARMDB_MOE_DISPATCH): tiny-moe in f32 served on
#: the card and on the CPU through both engines (logits within 1e-4, like
#: the f32 Llama cases), the last case with the einsum dispatch form.
MOE_PARITY_CASES = (("moe_dense_f32_chunked", False, True, "scatter"),
                    ("moe_dense_f32_single_step", False, False, "scatter"),
                    ("moe_paged_f32_chunked", True, True, "scatter"),
                    ("moe_paged_f32_single_step", True, False, "scatter"),
                    ("moe_paged_f32_chunked_einsum", True, True, "einsum"))


def moe_parity_logits(p, cfg, d, paged, chunked, dispatch):
    """tiny-moe logits on device ``d``: a bucketed prefill (two rows, the
    head at each row's last token; a padded row whose padding takes
    capacity), then, paged, a prefix wave over a seeded f32 pool and
    decode steps over it (one chunked step with an f32 chunk buffer, or
    three single steps that write the pool); dense, decode steps over a
    seeded f32 slot cache."""
    import numpy as np
    import torch

    from swarmdb_tpu_torch.models import mixtral

    rng = np.random.default_rng(9)
    T, ps, maxp = 64, 16, 16
    toks = torch.from_numpy(rng.integers(3, 259, (2, T)).astype(np.int32))
    toks[1, 41:] = 0
    pos = torch.arange(T, dtype=torch.int32).expand(2, T)
    t = lambda x: x.to(d)
    temp = mixtral.init_kv_cache(cfg, 2, T, torch.float32, device=d)
    out = [mixtral.forward(p, cfg, t(toks), t(pos), temp,
                           logits_at=t(torch.tensor([T - 1, 40])),
                           moe_dispatch=dispatch)[0]]
    hk = torch.randn((cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.head_dim),
                     generator=torch.Generator().manual_seed(4))
    chunk = (t(hk), t(hk.clone()))
    if paged:
        shape = (cfg.n_layers, 2 * maxp + 1, ps, cfg.n_kv_heads,
                 cfg.head_dim)
        kp, vp = (t(torch.randn(shape, generator=torch.Generator()
                                .manual_seed(s))) for s in (3, 13))
        tables = t(torch.arange(1, 2 * maxp + 1, dtype=torch.int32)
                   .reshape(2, -1))
        out.append(mixtral.forward_prefix_pages(
            p, cfg, t(toks[:, :24]), tables[:, :4],
            t(torch.tensor([32, 48], dtype=torch.int32)), kp, vp,
            logits_at=t(torch.tensor([23, 10])), moe_dispatch=dispatch)[0])
        cache = {"k": kp, "v": vp, "page_table": tables}
        if chunked:
            out.append(mixtral.forward_paged_chunked(
                p, cfg, t(toks[:, :1].long()), t(torch.tensor([[70], [90]])),
                cache, chunk, 3, moe_dispatch=dispatch)[0])
        else:
            for s in range(3):
                logits, cache = mixtral.forward_paged(
                    p, cfg, t(toks[:, s:s + 1].long()),
                    t(torch.tensor([[70 + s], [90 + s]])), cache,
                    moe_dispatch=dispatch)
                out.append(logits)
        return [x.cpu() for x in out]
    shape = (cfg.n_layers, 2, 128, cfg.n_kv_heads, cfg.head_dim)
    cache = tuple(t(torch.randn(shape, generator=torch.Generator()
                                .manual_seed(s))) for s in (3, 13))
    if chunked:
        out.append(mixtral.forward_chunked(
            p, cfg, t(toks[:, :1]), t(torch.tensor([[70], [90]])), cache,
            chunk, 3, moe_dispatch=dispatch)[0])
    else:
        for s in range(3):
            logits, cache = mixtral.forward(
                p, cfg, t(toks[:, s:s + 1]),
                t(torch.tensor([[70 + s], [90 + s]])), cache,
                moe_dispatch=dispatch)
            out.append(logits)
    return [x.cpu() for x in out]


def run_parity(dev):
    """tiny-debug f32: the same weights served on the card and on the CPU,
    over each engine, cache kind and decode mode of ``PARITY_CASES``."""
    import numpy as np
    import torch

    from swarmdb_tpu_torch.backend.sampling import SamplingParams
    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("tiny-debug")
    p_cpu = llama.init_params(cfg, seed=11, device="cpu", dtype=torch.float32)
    p_gpu = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in p_cpu.items()}
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 259, n).tolist() for n in (40, 9, 200, 77)]
    for name, kind, chunked, tol, paged in PARITY_CASES:
        kv = getattr(torch, kind)
        engines = {}
        with engine_env(chunked):
            for where, d, p in (("gpu", dev, p_gpu), ("cpu", "cpu", p_cpu)):
                engines[where], _ = build_backend_engine(
                    "tiny-debug", max_batch=4, max_seq=256, device=d,
                    params=p, kv_dtype=kv, paged=paged)
                engines[where].start()
        ac.reset_launches()
        try:
            for pr in prompts:
                a = engines["gpu"].generate_sync(pr, SamplingParams(
                    max_new_tokens=16))
                b = engines["cpu"].generate_sync(pr, SamplingParams(
                    max_new_tokens=16))
                if a != b:
                    fail(f"parity {name}: greedy tokens differ card vs "
                         f"cpu: {a} {b}")
        finally:
            for e in engines.values():
                e.stop()
        launches = {k: n for k, n in ac.LAUNCHES.items() if n}
        if set(launches) != set(path_kernels(kind, chunked, paged)):
            fail(f"parity {name}: the card engine launched {launches}")
        outs = {where: (parity_logits(p, cfg, d, kind, chunked) if paged
                        else dense_parity_logits(p, cfg, d, chunked))
                for where, d, p in (("gpu", dev, p_gpu),
                                    ("cpu", "cpu", p_cpu))}
        errs = [float((a - b).abs().max())
                for a, b in zip(outs["gpu"], outs["cpu"])]
        if max(errs) > tol:
            fail(f"parity {name}: logits card vs cpu differ by {errs} > "
                 f"{tol}")
        emit("parity", case=name, cache=kind, paged=paged, chunked=chunked,
             prompts=len(prompts), greedy_equal=True,
             prefill_logits_max_abs_err=errs[0],
             decode_logits_max_abs_err=max(errs[1:]), bound=tol,
             launches=launches)
    run_moe_parity(dev, prompts)
    run_binding_parity(dev)
    run_rolling_parity(dev)


def run_moe_parity(dev, prompts):
    """tiny-moe f32 (``MOE_PARITY_CASES``): the same weights served on the
    card and on the CPU, greedy tokens equal, only the decode kernel of
    the path launched (tiny-moe has no ragged prefill), logits within
    1e-4."""
    import torch

    from swarmdb_tpu_torch.backend.sampling import SamplingParams
    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.models import mixtral
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    cfg, tol = get_config("tiny-moe"), 1e-4
    p_cpu = mixtral.init_params(cfg, seed=11, device="cpu",
                                dtype=torch.float32)
    p_gpu = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in p_cpu.items()}
    old = os.environ.get("SWARMDB_MOE_DISPATCH")
    for name, paged, chunked, dispatch in MOE_PARITY_CASES:
        os.environ["SWARMDB_MOE_DISPATCH"] = dispatch
        engines = {}
        with engine_env(chunked):
            for where, d, p in (("gpu", dev, p_gpu), ("cpu", "cpu", p_cpu)):
                engines[where], _ = build_backend_engine(
                    "tiny-moe", max_batch=4, max_seq=256, device=d,
                    params=p, kv_dtype=torch.float32, paged=paged)
                engines[where].start()
        ac.reset_launches()
        try:
            for pr in prompts:
                a = engines["gpu"].generate_sync(pr, SamplingParams(
                    max_new_tokens=16))
                b = engines["cpu"].generate_sync(pr, SamplingParams(
                    max_new_tokens=16))
                if a != b:
                    fail(f"parity {name}: greedy tokens differ card vs "
                         f"cpu: {a} {b}")
        finally:
            for e in engines.values():
                e.stop()
        launches = {k: n for k, n in ac.LAUNCHES.items() if n}
        want = path_kernels("float32", chunked, paged, ragged=False)
        if set(launches) != set(want):
            fail(f"parity {name}: the card engine launched {launches}")
        outs = {where: moe_parity_logits(p, cfg, d, paged, chunked, dispatch)
                for where, d, p in (("gpu", dev, p_gpu),
                                    ("cpu", "cpu", p_cpu))}
        errs = [float((a - b).abs().max())
                for a, b in zip(outs["gpu"], outs["cpu"])]
        if max(errs) > tol:
            fail(f"parity {name}: logits card vs cpu differ by {errs} > "
                 f"{tol}")
        emit("parity", case=name, model="tiny-moe", cache="float32",
             paged=paged, chunked=chunked, moe_dispatch=dispatch,
             prompts=len(prompts), greedy_equal=True,
             prefill_logits_max_abs_err=errs[0],
             prefix_logits_max_abs_err=errs[1] if paged else None,
             decode_logits_max_abs_err=max(errs[2 if paged else 1:]),
             bound=tol, launches=launches)
    if old is None:
        os.environ.pop("SWARMDB_MOE_DISPATCH", None)
    else:
        os.environ["SWARMDB_MOE_DISPATCH"] = old


#: (paged: True / None = the default dense engine, chunked) of the
#: binding-capacity parity case (``run_binding_parity``).
BINDING_MODES = ((None, True), (None, False), (True, True), (True, False))


def run_together(eng, prompts, news, timeout=120.0) -> list:
    """Submit greedy requests before the loop starts (one admission
    round), start, wait for all, stop: [(tokens, reason)] in order."""
    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams

    done = {}
    ids = [eng.submit(GenRequest(
        prompt=p, sampling=SamplingParams(max_new_tokens=n),
        on_done=lambda rid, toks, why: done.__setitem__(rid, (toks, why))))
        for p, n in zip(prompts, news)]
    eng.start()
    try:
        deadline = time.time() + timeout
        while len(done) < len(ids) and time.time() < deadline:
            time.sleep(0.02)
    finally:
        eng.stop()
    return [done.get(i) for i in ids]


def run_binding_parity(dev):
    """The binding-capacity case of ``tests/test_torch_decode_loop_*.py``
    on the card: tiny-moe with 8 experts (C = N / 2, so idle and retired
    rows take capacity and tokens drop) in f32, max_batch 4, max_seq 96,
    page 16, three requests submitted before start (prompt seeds 2, 3
    and 4; 21, 40 and 33 tokens; 6, 20 and 13 new), both engines chunked
    and single-step at the default loops (paged: resident sessions; dense:
    two chunks in flight). The card decodes through graph replays, the
    CPU eagerly: greedy tokens equal."""
    import numpy as np
    import torch

    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.models import mixtral
    from swarmdb_tpu_torch.models.configs import get_config

    cfg = get_config("tiny-moe", n_experts=8)
    p_cpu = mixtral.init_params(cfg, seed=1, device="cpu",
                                dtype=torch.float32)
    p_gpu = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in p_cpu.items()}
    for paged, chunked in BINDING_MODES:
        loops, graphs = set(), 0
        for seed in (2, 3, 4):
            rng = np.random.default_rng(seed)
            prompts = [rng.integers(3, 259, n).tolist() for n in (21, 40, 33)]
            outs = {}
            for where, d, p in (("gpu", dev, p_gpu), ("cpu", "cpu", p_cpu)):
                with engine_env(chunked):
                    eng, _ = build_backend_engine(
                        cfg, max_batch=4, max_seq=96, page_size=16, device=d,
                        params=p, kv_dtype=torch.float32, paged=paged)
                outs[where] = run_together(eng, prompts, (6, 20, 13))
                st = eng.stats()
                loops.add(st["decode_loop"])
                if where == "gpu":
                    graphs += st["decode_chunks"]["chunks"]
            if outs["gpu"] != outs["cpu"] or None in outs["gpu"]:
                fail(f"parity moe8 binding paged={paged} chunked={chunked} "
                     f"seed={seed}: card {outs['gpu']} cpu {outs['cpu']}")
        want = {"resident" if paged else "pipeline 2"}
        if loops != want:
            fail(f"parity moe8 binding: decode loops {loops}, not {want}")
        emit("parity", case="moe8_binding_default_loops",
             model="tiny-moe, 8 experts", cache="float32",
             paged=bool(paged), chunked=chunked, seeds=[2, 3, 4],
             decode_loop=want.pop(), greedy_equal=True,
             card_graph_replays=graphs)


# ---------------------------------------------------------------- rolling


class RollTrace:
    """What a rolling service did per message: the plan's mode and tier
    origin (``_rolling_plan``), the prompt it submitted (its length and
    resume length), and the request's tokens and logprobs; optionally the
    first-token logits of every prefill row (``_sample_into_slots``)."""

    def __init__(self, svc, logits: bool = False) -> None:
        self.plans, self.prompts, self.done = {}, {}, {}
        self.logits = []
        self.order = []
        plan, submit = svc._rolling_plan, svc.engine.submit

        def traced_plan(key, msg, sampling, pre_count=0):
            out = plan(key, msg, sampling, pre_count)
            self.plans[msg.id] = (out[0], msg.metadata.get("tier_origin"))
            return out

        def traced_submit(req):
            mid = req.metadata.get("message_id")
            self.prompts[mid] = (len(req.prompt), req.resume_len)
            self.order.append(mid)
            user_done = req.on_done

            def on_done(rid, toks, reason, req=req):
                self.done[mid] = (list(toks), reason,
                                  list(req.metadata.get("logprobs", [])))
                if user_done is not None:
                    user_done(rid, toks, reason)

            req.on_done = on_done
            return submit(req)

        svc._rolling_plan = traced_plan
        svc.engine.submit = traced_submit
        if logits:
            eng = svc.engine
            sample = eng._sample_into_slots

            def traced_sample(lg, gather, fold_pos, scatter):
                rows = [r for r in range(len(scatter))
                        if scatter[r] < eng.max_batch]
                if rows:   # a wave of split rows' heads samples nothing
                    self.logits.append(lg[rows].float().cpu())
                return sample(lg, gather, fold_pos, scatter)

            eng._sample_into_slots = traced_sample

    def by_origin(self, ids=None) -> dict:
        """origin (tier origin, else the plan's mode) -> the prefill
        tokens of each of its turns."""
        out: dict = {}
        for mid in ids if ids is not None else self.prompts:
            if mid not in self.prompts:
                continue
            mode, origin = self.plans.get(mid, ("plain", None))
            key = origin or ("hot" if mode == "resume" else mode)
            out.setdefault(key, []).append(self.prompts[mid][0])
        return out


def roll_send(db, user, assistant, content, max_new=32, function=False):
    from swarmdb_tpu_torch.core.messages import MessageType

    kw = ({"message_type": MessageType.FUNCTION_CALL} if function else {})
    return db.send_message(user, assistant, content, metadata={
        "generation": {"max_new_tokens": max_new, "temperature": 0.0}}, **kw)


def roll_wait(db, completed_target, timeout=300.0) -> None:
    completed = db.metrics.counters["completed_messages"]
    deadline = time.time() + timeout
    while completed.value < completed_target and time.time() < deadline:
        time.sleep(0.005)
    if completed.value < completed_target:
        fail(f"rolling: {completed.value} of {completed_target} replies "
             f"within {timeout} s")


def wait_parked(svc, key, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with svc._rolling_lock:
            st = svc._rolling.get(key)
            if st is not None and st.get("pages") and not st["in_flight"]:
                return st
        time.sleep(0.01)
    fail(f"rolling: {key} never parked its pages")


ROLL_PARITY_TURNS = ("chat", "function", "chat", "function", "chat")

#: (name, cache dtype, paged, chunked, f32 chunk buffer, bound): the
#: rolling parity cases, tiny-debug f32 weights on the card and on the
#: CPU. Paged cases run the tier manager (a warm promotion before turn 3,
#: a cold resume before turn 4); dense ones keep and resume through the
#: side pool (its lane composed from kept pages). Bounds on the first-token
#: logits and the decode logprobs: 1e-4 where both sides see the same
#: f32 operands (an f32 pool single-step, or chunked with an f32 chunk
#: buffer swapped in after the build). The engine's own chunk buffer is
#: bf16, as in the JAX package: its plain version rounds the chunk's
#: softmax weights to bf16 before the value product and the kernels keep
#: them in f32, a relative 2^-9 on each weight (``layers.py``
#: ``gqa_attention_chunked_reference``). Served on the CPU both ways
#: (``scripts/rolling_parity_emulation.py``), tiny-debug's rolling
#: logits and logprobs part by up to ROLL_BF16_GAP; those cases are held
#: to 4x it, and, against the CPU served the kernels' way
#: (``kernel_weights``), to 1e-4 with an f32 pool. The int8 cases add a
#: requantized page's int8 code flipping where the card's and the CPU's
#: K/V differ by float32 rounding (``PARITY_CASES``); tiny-debug's flat
#: logits then meet near ties, and their tokens may part once, at a tie
#: within the bound (``rolling_parity_errors``).
ROLL_BF16_GAP = 7.5e-4
ROLL_PARITY_CASES = (
    ("paged_f32_chunked_f32_buffer", "float32", True, True, True, 1e-4),
    ("paged_f32_chunked", "float32", True, True, False, 4 * ROLL_BF16_GAP),
    ("paged_f32_single_step", "float32", True, False, False, 1e-4),
    ("paged_int8_chunked", "int8", True, True, False, 2e-2),
    ("paged_int8_single_step", "int8", True, False, False, 2e-2),
    ("dense_f32_chunked", "float32", False, True, False, 4 * ROLL_BF16_GAP),
    ("dense_f32_single_step", "float32", False, False, False, 1e-4))


@contextlib.contextmanager
def kernel_weights():
    """The plain two-segment decode run the kernels' way for the block:
    its operands upcast to float32 first, so the softmax weights meet the
    (bf16-valued) chunk and page values unrounded."""
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    plain = ac.gqa_attention_chunked_reference

    def unrounded(q, cache_k, cache_v, chunk_k, chunk_v, *args, **kw):
        return plain(q, cache_k.float(), cache_v.float(), chunk_k.float(),
                     chunk_v.float(), *args, **kw)

    ac.gqa_attention_chunked_reference = unrounded
    try:
        yield
    finally:
        ac.gqa_attention_chunked_reference = plain


def rolling_parity_run(d, params, kind, paged, chunked, f32_buffer):
    """tiny-debug with rolling KV on device ``d`` (one
    ``ROLL_PARITY_CASES`` case): one 5-turn conversation
    (``ROLL_PARITY_TURNS``). Paged, with the tier manager: every idle
    conversation demoted before turn 3 (a warm promotion) and demoted
    into a store too small to hold it before turn 4 (a cold resume).
    Returns per turn (tokens, reason, logprobs), the origins, the prefill
    rows' first-token logits and the tier counters."""
    import tempfile

    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    import torch

    db = SwarmDB(broker=LocalBroker(),
                 save_dir=tempfile.mkdtemp(prefix="swarm_rollpar_"))
    with engine_env(chunked, SWARMDB_ROLLING_KV="1", SWARMDB_TIER="1"):
        eng, tok = build_backend_engine(
            "tiny-debug", max_batch=2, max_seq=256, page_size=8, device=d,
            params=params, kv_dtype=getattr(torch, kind), paged=paged,
            metrics=db.metrics)
        svc = ServingService(db, eng, tok, backend_id="b0")
    if f32_buffer:
        # an f32 chunk K/V buffer: the card's kernel and the CPU's plain
        # version then see the same f32 operands
        eng._chunk_kv = tuple(t.float() for t in eng._chunk_kv)
    if svc._rolling is None or paged != (svc._tier is not None):
        fail("rolling parity: rolling KV or the tier manager did not attach")
    if paged:
        svc._tier.min_idle_s = 0.0
    trace = RollTrace(svc, logits=True)
    key = ("user", "assistant")
    try:
        for a in key:
            db.register_agent(a)
        db.assign_llm_backend("assistant", "b0")
        svc.start(warmup=d != "cpu")
        for t, turn in enumerate(ROLL_PARITY_TURNS):
            if paged and t in (2, 3):
                wait_parked(svc, key)
                if t == 3:
                    svc._tier.store.capacity_bytes = 1   # falls to cold
                with svc._rolling_lock:
                    svc._tier.demote_now(10 ** 6)
            content = ({"name": "lookup_weather",
                        "arguments": {"city": f"city_{t}"}}
                       if turn == "function" else f"turn {t}: tell me more")
            roll_send(db, *key, content, max_new=12,
                      function=turn == "function")
            roll_wait(db, t + 1)
        origins = [trace.plans[m][1] or ("hot" if trace.plans[m][0]
                                         == "resume" else trace.plans[m][0])
                   for m in trace.order]
        turns = [trace.done[m] for m in trace.order]
        return turns, origins, trace.logits, (
            dict(svc._tier.status()["counters"]) if paged else None)
    finally:
        svc.stop()
        db.close()


def rolling_parity_errors(gpu, cpu, tol=None):
    """Compare two ``rolling_parity_run`` results turn by turn: (first-
    token logits, decode logprobs) max abs differences and where the
    greedy tokens part, (turn, token) or None.

    With ``tol`` (the int8 cases) the tokens may part once, at a near
    tie: a first token whose two choices each sit within ``tol`` of the
    top of the other side's logits, or a decode token whose two choices'
    logprobs differ by at most ``tol``. Past that point the conversations
    differ and nothing more is compared. Without ``tol`` they must not
    part."""
    if len(gpu[2]) != len(cpu[2]) or (tol is not None
                                      and len(gpu[2]) != len(gpu[0])):
        fail(f"rolling parity: {len(gpu[2])} prefill waves on the card, "
             f"{len(cpu[2])} on the CPU, {len(gpu[0])} turns")

    def logits_err(waves):
        return max((float((a - b).abs().max()) for a, b in
                    zip(gpu[2][:waves], cpu[2][:waves])), default=0.0)

    lp = 0.0
    for t, (a, b) in enumerate(zip(gpu[0], cpu[0])):
        i = next((j for j, (x, y) in enumerate(zip(a[0], b[0])) if x != y),
                 None)
        upto = len(a[2]) if i is None else i + 1
        lp = max([lp] + [abs(x - y) for x, y in zip(a[2][:upto],
                                                     b[2][:upto])])
        if i is None and a[:2] == b[:2]:
            continue
        if i is None or tol is None:
            fail(f"rolling parity: tokens differ card vs cpu at turn {t}: "
                 f"{a[:2]} {b[:2]}")
        if i == 0:
            ga, gb = gpu[2][t][0], cpu[2][t][0]
            if not (ga[b[0][0]] >= ga.max() - tol
                    and gb[a[0][0]] >= gb.max() - tol):
                fail(f"rolling parity: turn {t}'s first token parts card "
                     f"{a[0][0]} vs cpu {b[0][0]} with no near tie")
        # turn t's prefill still saw the same inputs on both sides
        return logits_err(t + 1), lp, (t, i)
    return logits_err(len(gpu[2])), lp, None


def run_rolling_parity(dev):
    """The rolling parity cases (``ROLL_PARITY_CASES``): each served on the
    card and on the CPU with the same f32 weights; greedy tokens equal
    (int8: until they part at a near tie, if they do), first-token
    logits and the decode logprobs within the case's bound
    (and within 1e-4 of the CPU served the kernels' way, for the bf16
    chunk buffer over an f32 cache), origins fresh, hot, warm, cold, hot
    (paged) or keep, hot, hot, keep, hot (dense), and the card engine
    launching its path's kernels."""
    import torch

    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    p_cpu = llama.init_params(get_config("tiny-debug"), seed=11,
                              device="cpu", dtype=torch.float32)
    p_gpu = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in p_cpu.items()}
    for name, kind, paged, chunked, f32_buffer, tol in ROLL_PARITY_CASES:
        ac.reset_launches()
        gpu = rolling_parity_run(dev, p_gpu, kind, paged, chunked,
                                 f32_buffer)
        launches = {k: n for k, n in ac.LAUNCHES.items() if n}
        cpu = rolling_parity_run("cpu", p_cpu, kind, paged, chunked,
                                 f32_buffer)
        # dense: turn 4 would overflow the 256-token window (211 kept
        # tokens), so the conversation restarts there
        want = (["fresh", "hot", "warm", "cold", "hot"] if paged
                else ["keep", "hot", "hot", "keep", "hot"])
        if gpu[1] != want or cpu[1] != want:
            fail(f"rolling parity {name}: origins card {gpu[1]} cpu "
                 f"{cpu[1]}, not {want}")
        lg_err, lp_err, parted = rolling_parity_errors(
            gpu, cpu, tol if kind == "int8" else None)
        if max(lp_err, lg_err) > tol:
            fail(f"rolling parity {name}: card vs cpu logits {lg_err}, "
                 f"logprobs {lp_err} > {tol}")
        kernel_way = None
        if chunked and not f32_buffer and kind == "float32":
            # the gap is the plain version's rounding: served the
            # kernels' way, the CPU meets the card at float32 rounding
            with kernel_weights():
                emul = rolling_parity_run("cpu", p_cpu, kind, paged,
                                          chunked, f32_buffer)
            kernel_way = rolling_parity_errors(gpu, emul)[:2]
            if max(kernel_way) > 1e-4:
                fail(f"rolling parity {name}: card vs the cpu served the "
                     f"kernels' way: logits, logprobs {kernel_way} > 1e-4")
        if set(launches) != set(path_kernels(kind, chunked, paged)):
            fail(f"rolling parity {name}: the card engine launched "
                 f"{launches}")
        emit("parity", case=f"rolling_{name}", model="tiny-debug",
             cache=kind, paged=paged, chunked=chunked,
             chunk_buffer=(None if not chunked else "float32"
                           if f32_buffer else "bfloat16"),
             turns=list(ROLL_PARITY_TURNS),
             origins=gpu[1], greedy_equal=parted is None,
             tokens_part_at_near_tie=parted,
             prefill_logits_max_abs_err=lg_err,
             decode_logprobs_max_abs_err=lp_err, bound=tol,
             kernel_way_max_abs_err=kernel_way, tier_counters=gpu[3],
             launches=launches)


#: the rolling phase's scenario (bench.py's bench_swarm1M cut to one card):
#: 12 users x 4 assistants, one ~600-token context turn per conversation,
#: then ROLL_ROUNDS rounds of 48 ~40-token deltas drawn Zipf(1.1) from
#: numpy seed 0, 32 new tokens each, at most ROLL_OUTSTANDING in flight
ROLL_USERS, ROLL_ASSISTANTS, ROLL_ROUNDS = 12, 4, 3
ROLL_OUTSTANDING = 10
ROLL_WARM_MB = 1024
#: (name, cache dtype, paged): the three engines of the rolling phase
#: Page-locked bytes a stopped rolling engine may leave behind.
ROLL_PINNED_SLACK = 64 << 20
ROLL_MODES = (("paged_bf16", "bfloat16", True),
              ("paged_int8", "int8", True),
              ("dense", "bfloat16", None))


def zipf_indices(k: int, exponent: float, count: int, seed: int):
    """``bench.py``'s ``_zipf_indices``: ``count`` indices in [0, k) from
    a bounded Zipf (inverse CDF over rank ** -exponent)."""
    import numpy as np

    ranks = np.arange(1, k + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -exponent)
    cdf /= cdf[-1]
    rng = np.random.default_rng(seed)
    return np.searchsorted(cdf, rng.random(count)).astype(np.int64)


def run_rolling(card: str, params):
    """The rolling phase on Llama-3-8B at full width (``ROLL_MODES``).
    Returns the launches summed over its engines."""
    total = {}
    for name, kind, paged in ROLL_MODES:
        before = host_pinned_bytes()
        for k, n in rolling_serve(card, params, name, kind, paged).items():
            total[k] = total.get(k, 0) + n
        # the stopped engine's warm store must not stay page-locked: the
        # next engine's would sit beside it
        after = host_pinned_bytes()
        emit("rolling", serve=name, part="stopped",
             page_locked_bytes_before_engine=before,
             page_locked_bytes_after_stop=after, card=card)
        if (before is not None and after is not None
                and after - before > ROLL_PINNED_SLACK):
            fail(f"rolling {name}: {after - before} page-locked bytes "
                 f"outlived the stopped engine (at most "
                 f"{ROLL_PINNED_SLACK})")
    return total


def _summary(xs):
    xs = sorted(xs)
    return ({"n": len(xs), "median": statistics.median(xs), "max": xs[-1]}
            if xs else {"n": 0})


def rolling_serve(card, params, name, kind, paged):
    """One engine of the rolling phase: build it with rolling KV (and,
    paged, the tier manager with a ``ROLL_WARM_MB`` warm store), capture
    its graphs, serve the scenario, check and print. Paged: then the
    demote -> promote A/B (``tier_ab``)."""
    import gc
    import tempfile

    import torch

    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    db = SwarmDB(broker=LocalBroker(),
                 save_dir=tempfile.mkdtemp(prefix="swarm_roll_"))
    backend = "h100-0"
    with env_scope(SWARMDB_ROLLING_KV="1", SWARMDB_TIER="1",
                   SWARMDB_TIER_WARM_MB=ROLL_WARM_MB,
                   SWARMDB_TIER_MIN_IDLE_S="0.05", SWARMDB_CHUNKED="1",
                   SWARMDB_PAGED=None):
        eng, tok = build_backend_engine(
            "llama3-8b", seed=0, device="cuda", params=params, paged=paged,
            kv_dtype=getattr(torch, kind) if paged else None,
            metrics=db.metrics)
        svc = ServingService(db, eng, tok, backend_id=backend)
    if svc._rolling is None or (paged and svc._tier is None):
        fail(f"rolling {name}: rolling KV or the tier manager did not "
             f"attach")
    users = [f"user{i}" for i in range(ROLL_USERS)]
    assistants = [f"assistant{j}" for j in range(ROLL_ASSISTANTS)]
    convs = [(u, a) for a in assistants for u in users]
    trace = RollTrace(svc)
    promote_s = [0.0, 0]
    insert = eng._promote_insert

    def timed_insert(req):
        n = len(req.resume_pages or ())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        insert(req)
        torch.cuda.synchronize()
        promote_s[0] += time.perf_counter() - t0
        promote_s[1] += n

    eng._promote_insert = timed_insert
    ctx = " ".join(f"ctx{j}" for j in range(100))
    pinned_peak = [0]
    pinned_before = host_pinned_bytes()
    try:
        for a in users + assistants:
            db.register_agent(a)
        for a in assistants:
            db.assign_llm_backend(a, backend)
        svc.start(warmup=True)
        ac.reset_launches()
        sent = 0
        draws = zipf_indices(len(convs), 1.1, ROLL_ROUNDS * len(convs), 0)
        plan = [(c, f"Conversation {c} context: {ctx}") for c in
                range(len(convs))] + [
            (int(c), f"Continue conversation {int(c)}, step {i}. d0 d1 d2")
            for i, c in enumerate(draws)]
        t_serve = time.perf_counter()
        for c, text in plan:
            roll_wait(db, sent - ROLL_OUTSTANDING + 1)
            roll_send(db, *convs[c], text)
            sent += 1
            if svc._tier is not None:
                pinned_peak[0] = max(pinned_peak[0],
                                     svc._tier.store.stats()["bytes"])
        roll_wait(db, sent)
        serve_s = time.perf_counter() - t_serve
        launches = dict(ac.LAUNCHES)
        replies = []
        for u in users:
            replies.extend(db.receive_messages(u, max_messages=10 ** 4,
                                               timeout=0.5))
        reasons = [m.metadata.get("finish_reason") for m in replies]
        # idle: every claim settled
        deadline = time.time() + 30
        while time.time() < deadline and (eng._any_active() or any(
                st.get("in_flight") for st in list(svc._rolling.values()))):
            time.sleep(0.01)
        c = db.metrics.counters
        lat = db.metrics.latencies
        by_origin = trace.by_origin()
        origins = {k: len(v) for k, v in by_origin.items()}
        custody = rolling_custody(svc)
        record = dict(
            serve=name, model="llama3-8b", cache=kind,
            engine="paged" if paged else "dense (default)",
            conversations=len(convs), turns=sent, replies=len(replies),
            finish_reasons={r: reasons.count(r) for r in set(reasons)},
            turns_by_origin=origins,
            prefill_tokens_per_turn={k: statistics.mean(v) for k, v in
                                     by_origin.items()},
            rolling_resumes=c["rolling_resumes"].value,
            rolling_restarts=c["rolling_restarts"].value,
            rolling_evictions=c["rolling_evictions"].value,
            custody=custody, serve_wall_s=serve_s,
            ttft_all_s=_summary(lat["send_to_first_token_s"].values()),
            launches={k: n for k, n in launches.items() if n},
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
            card=card)
        checks = {
            f"{sent} replies, length/eos": len(replies) == sent and all(
                r in ("length", "eos") for r in reasons),
            "custody balances": custody["balanced"],
            "resumed turns": c["rolling_resumes"].value > 0,
        }
        if paged:
            tier = svc._tier
            st = tier.status()
            record.update(
                tier_counters=st["counters"], pages_by_tier=st["pages"],
                warm_store=st["warm_store"],
                ttft_by_origin_s={o: _summary(lat[f"tier_ttft_{o}_s"]
                                              .values())
                                  for o in ("hot", "warm", "cold", "fresh")
                                  if f"tier_ttft_{o}_s" in lat},
                demote_ms_per_page=(tier.demote_s * 1e3 / tier.demoted_pages
                                    if tier.demoted_pages else None),
                promote_ms_per_page=(promote_s[0] * 1e3 / promote_s[1]
                                     if promote_s[1] else None),
                pinned_host_bytes_peak=pinned_peak[0],
                pinned_host_bytes_end=st["warm_store"]["bytes"],
                warm_slab=tier.store.slab_stats())
            # PyTorch's page-locked host allocator (pin_memory): what this
            # engine added is its store's slab, not a block per demotion
            pinned_after = host_pinned_bytes()
            record["pinned_host_allocator_bytes"] = [pinned_before,
                                                     pinned_after]
            if pinned_after is not None:
                checks["page-locked growth within the warm slab + 64 MiB"] \
                    = (pinned_after - pinned_before
                       <= tier.store.slab_stats()["bytes"] + (64 << 20))
            for o in ("hot", "warm", "cold"):
                checks[f"at least one {o} resume"] = origins.get(o, 0) > 0
        bad = [k for k, ok in checks.items() if not ok]
        emit("rolling", **record)
        if bad:
            fail(f"rolling {name} checks failed: {bad}")
        if paged:
            tier_ab(svc, eng, tok, name, card)
        return launches
    finally:
        svc.stop()
        db.close()
        # the trace and the timed insert hold the service and the engine:
        # drop them before the collection, not after it
        del eng._promote_insert
        del svc, eng, trace, insert, timed_insert
        gc.collect()
        torch.cuda.empty_cache()


def host_pinned_bytes():
    """Bytes PyTorch's page-locked host allocator holds (None where this
    PyTorch does not report them)."""
    import torch

    stats = (torch.cuda.host_memory_stats()
             if hasattr(torch.cuda, "host_memory_stats") else {})
    return stats.get("allocated_bytes.current")


def rolling_custody(svc) -> dict:
    """Every page of the pool (paged) or side pool (dense) accounted for,
    the engine idle: free + the registry's device pages + pages still
    owned by retired slots (paged) + prefix-cache pages == all but the
    trash page (``tests/test_rolling.py``'s custody equation)."""
    eng = svc.engine
    with svc._rolling_lock:
        held = sum(len(st["pages"]) for st in svc._rolling.values()
                   if st.get("pages"))
    cached = eng._prefix.stats()["cached_pages"]
    if eng.paged is not None:
        alloc = eng.paged.allocator
        with alloc._lock:
            in_slot = sum(len(sp.pages) for sp in alloc._by_slot.values())
        free, pool = alloc.free_count(), alloc.num_pages - 1
    else:
        in_slot = 0
        free, pool = eng._prefix.free_count(), eng._prefix.num_pages - 1
    return dict(free=free, registry=held, in_slot=in_slot,
                prefix_cached=cached, pool=pool,
                balanced=free + held + in_slot + cached == pool)


def tier_ab(svc, eng, tok, name, card):
    """Demote -> promote against the hot path on one engine, the same
    inputs: a ~600-token conversation kept, its next greedy turn (a
    ~40-token delta) resumed hot; the same conversation again, its pages
    demoted through the tier manager into pinned host memory and promoted
    back into freshly reserved pages before the same turn. The promoted
    pages must equal (``torch.equal``) the demoted ones, and the turn's
    tokens the hot turn's. Times one demotion and one promotion per
    page (synchronized)."""
    import threading

    import torch

    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams
    from swarmdb_tpu_torch.ops.paged_kv import QuantPool

    prompt = tok.encode("probe: Conversation ab context: " + " ".join(
        f"ctx{j}" for j in range(100)) + "\nassistant0:")
    delta = tok.encode("\nprobe: Continue conversation ab. d0 d1 d2"
                       "\nassistant0:", add_bos=False)

    def keep(p, resume=None, payload=None):
        done = threading.Event()
        out = {}
        req = GenRequest(prompt=list(p), sampling=SamplingParams(
            max_new_tokens=32), keep_pages=True,
            on_token=lambda r, t: out.setdefault(
                "ttft_s", time.perf_counter() - t_submit),
            on_pages=lambda r, pg, w, t: out.update(pages=pg, written=w,
                                                    tail=t),
            on_done=lambda r, t, why: (out.update(toks=t, reason=why),
                                       done.set()))
        if resume is not None:
            req.resume_pages, req.resume_len = list(resume[0]), resume[1]
            req.promote_payload = payload
        t_submit = time.perf_counter()
        eng.submit(req)
        if not done.wait(300):
            fail(f"tier A/B {name}: a turn timed out")
        return out

    def snap(ids):
        idx = torch.tensor(ids, device=eng.device)
        out = []
        for pool in (eng.cache["k"], eng.cache["v"]):
            if isinstance(pool, QuantPool):
                out += [pool.data[:, idx].clone(), pool.scale[:, idx].clone()]
            else:
                out.append(pool[:, idx].clone())
        return out

    first = keep(prompt)
    hot = keep(first["tail"] + delta, (first["pages"], first["written"]))
    eng.rolling_free(hot["pages"])
    again = keep(prompt)
    if (again["written"], again["tail"]) != (first["written"],
                                             first["tail"]):
        fail(f"tier A/B {name}: the repeated turn 1 differs")
    before = snap(again["pages"])
    key = ("probe", "ab")
    st = {"pages": list(again["pages"]), "len": again["written"],
          "tail": list(again["tail"]), "epoch": eng.pool_epoch(),
          "in_flight": False, "last": time.time()}
    n = len(st["pages"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with svc._rolling_lock:
        svc._rolling[key] = st
        freed = svc._tier._demote_locked(key, st)
    demote_s = time.perf_counter() - t0
    if freed != n or not svc._tier.store.has(key):
        fail(f"tier A/B {name}: the demotion did not land in host memory")
    with svc._rolling_lock:
        got = svc._tier.begin_promote(key, st, eng.pool_epoch())
        svc._rolling.pop(key, None)
    if got is None:
        fail(f"tier A/B {name}: the promotion found no pages")
    ids, payload = got
    pinned = all(t.is_pinned() for side in payload
                 for t in (side if isinstance(side, tuple) else (side,)))
    after, t_promote = [], [0.0]
    insert = eng._promote_insert

    def watched(req):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        insert(req)
        torch.cuda.synchronize()
        t_promote[0] = time.perf_counter() - t1
        after.extend(snap(req.resume_pages))

    eng._promote_insert = watched
    try:
        warm = keep(again["tail"] + delta, (ids, again["written"]), payload)
    finally:
        eng._promote_insert = insert
    eng.rolling_free(warm["pages"])
    # the same turn as a cold resume: the whole history prefilled fresh
    cold = keep(prompt + first["toks"] + delta)
    eng.rolling_free(cold["pages"])
    equal = len(after) == len(before) and all(
        torch.equal(a, b) for a, b in zip(after, before))
    emit("rolling", step="tier_ab", serve=name, pages=n,
         page_bytes=sum(t.numel() * t.element_size() for t in before) // n,
         pinned_payload=pinned, promoted_bytes_equal=equal,
         warm_tokens_equal_hot=warm["toks"] == hot["toks"],
         demote_ms_per_page=demote_s * 1e3 / n,
         promote_ms_per_page=t_promote[0] * 1e3 / n,
         ttft_s={"hot": hot["ttft_s"], "warm": warm["ttft_s"],
                 "cold": cold["ttft_s"]},
         prefill_tokens={"hot": len(first["tail"] + delta),
                         "warm": len(again["tail"] + delta),
                         "cold": len(prompt) + len(first["toks"])
                         + len(delta)}, card=card)
    if not (equal and pinned and warm["toks"] == hot["toks"]):
        fail(f"tier A/B {name}: promoted bytes equal {equal}, pinned "
             f"{pinned}, warm {warm['toks']} hot {hot['toks']}")


# ------------------------------------------------------------------- serve


USER_TEXT = (
    "I am planning a three-day trip to a city I have never visited and I "
    "want a schedule that balances museums, long walks and good food. "
    "Please suggest a plan for each morning, afternoon and evening, keep "
    "travel between places short, and mention one rainy-day alternative. "
    "My name is {u} and I prefer quiet places over crowded ones.")
FOLLOW_UP = ("Thanks. Now shorten the second day to a half day and add "
             "one place for coffee, {u} speaking again.")

#: (name, cache dtype, chunked, turns, paged): the six serves, in order.
#: ``paged=None`` builds the default engine (``SWARMDB_PAGED`` unset):
#: the dense one, with its bf16 slot cache.
SERVES = (("bf16_chunked", "bfloat16", True, 2, True),
          ("int8_chunked", "int8", True, 2, True),
          ("bf16_single_step", "bfloat16", False, 1, True),
          ("int8_single_step", "int8", False, 1, True),
          ("dense_chunked", "bfloat16", True, 2, None),
          ("dense_single_step", "bfloat16", False, 1, None))


def run_serves(card: str):
    """Llama-3-8B at full width, weights built once, served six times
    (``SERVES``); each engine is freed before the next. Returns the
    launches summed over the serves, and the weights."""
    import torch

    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    params = llama.init_params(get_config("llama3-8b"), seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    total = {}
    for spec in SERVES:
        launches = run_serve(card, params, init_s, *spec)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total, params


def run_serve(card, params, init_s, name, kind, chunked, turns, paged):
    import gc
    import tempfile

    import torch

    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.ops import attention_cuda as ac
    from swarmdb_tpu_torch.ops.paged_kv import (is_quantized, pool_data,
                                                pool_page_bytes)

    quant = kind == "int8"
    kernels = path_kernels(kind, chunked, bool(paged))
    prefill_k, decode_k = kernels[0] if paged else None, kernels[-1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    db = SwarmDB(broker=LocalBroker(),
                 save_dir=tempfile.mkdtemp(prefix="swarm_serve_"))
    backend = "h100-0"
    with engine_env(chunked):
        eng, tok = build_backend_engine(
            "llama3-8b", seed=0, device="cuda", params=params, paged=paged,
            kv_dtype=getattr(torch, kind) if paged else None,
            metrics=db.metrics)
    svc = ServingService(db, eng, tok, backend_id=backend)
    users = [f"user{i}" for i in range(4)]
    try:
        for a in users + ["assistant"]:
            db.register_agent(a)
        db.assign_llm_backend("assistant", backend)
        t_start = time.perf_counter()
        svc.start(warmup=True)   # SWARMDB_PREWARM's path: graphs first
        start_s = time.perf_counter() - t_start
        c = db.metrics.counters
        base = {k: c[k].value for k in ("prefill_waves",
                                        "engine_decode_chunks",
                                        "tokens_generated",
                                        "phase_us_decode")}
        ac.reset_launches()
        replies = []
        t_serve = time.perf_counter()
        for turn, text in enumerate((USER_TEXT, FOLLOW_UP)[:turns]):
            for i, u in enumerate(users):
                gen = {"max_new_tokens": 32}
                if turn == 0 and i == 3:
                    gen.update(temperature=0.8, top_p=0.9, seed=7)
                db.send_message(u, "assistant", text.format(u=u),
                                metadata={"generation": gen})
            got = await_replies(db, users)
            if len(got) < len(users):
                fail(f"serve {name} turn {turn + 1}: {len(got)} of "
                     f"{len(users)} replies")
            replies.extend(got.values())
        serve_s = time.perf_counter() - t_serve
        launches = dict(ac.LAUNCHES)
        loop = eng.stats()["decode_chunks"]
        waves = c["prefill_waves"].value - base["prefill_waves"]
        chunks = c["engine_decode_chunks"].value - base["engine_decode_chunks"]
        steps = chunks * eng.decode_chunk
        L = eng.params["layers"]["wq"].shape[0]
        reasons = [m.metadata.get("finish_reason") for m in replies]
        reused = eng.metrics.counters["prefix_reused_tokens"].value
        checks = {
            f"{len(users) * turns} replies, length/eos":
                len(replies) == len(users) * turns
                and all(r in ("length", "eos") for r in reasons),
            "prefix reuse on turn 2": turns < 2 or reused > 0,
            f"{decode_k} launches == 32 per step":
                chunks > 0 and launches[decode_k] == L * steps,
            "decode through CUDA graph replays": loop["chunks"] > 0
                and bool(loop["graphs"]),
            "only this path's kernels": all(
                n == 0 for k, n in launches.items() if k not in kernels),
            "params on cuda": eng.params["layers"]["wq"].is_cuda,
        }
        if paged:
            checks.update({
                f"{prefill_k} launches == 32 per wave":
                    waves > 0 and launches[prefill_k] >= L * waves,
                "pool kind": is_quantized(eng.cache["k"]) == quant,
                "pool on cuda": pool_data(eng.cache["k"]).is_cuda})
        else:
            checks["the default builds the dense engine, bf16 on cuda"] = (
                eng.paged is None and waves > 0 and all(
                    t.is_cuda and t.dtype == torch.bfloat16
                    for t in (*eng.cache, *eng._prefix_pool)))
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"serve {name} checks failed: {bad}; reasons={reasons} "
                 f"reused={reused} waves={waves} chunks={chunks} "
                 f"launches={launches}")
        ttft = sorted(db.metrics.latencies["send_to_first_token_s"].values())
        dec_s = (c["phase_us_decode"].value - base["phase_us_decode"]) / 1e6
        gen_tok = c["tokens_generated"].value - base["tokens_generated"]
        if paged:
            sizes = dict(
                kv_bytes_per_token=pool_page_bytes(eng.cache["k"]) * 2
                // eng.paged.page_size,
                pool_gib=2 * pool_page_bytes(eng.cache["k"])
                * eng.paged.num_pages / 2**30)
        else:
            ck = eng.cache[0]
            sizes = dict(
                kv_bytes_per_token=2 * ck[:, 0, 0].numel()
                * ck.element_size(),
                slot_cache_gib=sum(map(_nbytes, eng.cache)) / 2**30,
                side_pool_gib=sum(map(_nbytes, eng._prefix_pool)) / 2**30)
        record = dict(
            serve=name, model="llama3-8b", layers=L, weights="bfloat16",
            engine="paged" if paged else "dense (default)", cache=kind,
            chunked=chunked, turns=turns, replies=len(replies),
            finish_reasons=reasons, prefix_reused_tokens=reused,
            prefill_waves=waves, decode_chunks=chunks, launches={
                k: n for k, n in launches.items() if n},
            ttft_p50_s=statistics.median(ttft), ttft_max_s=ttft[-1],
            decode_tokens_per_s=gen_tok / dec_s if dec_s else None,
            generated_tokens=gen_tok, serve_wall_s=serve_s, **sizes,
            weight_init_s=init_s, card=card, max_step_s=eng.max_step_s,
            start_with_warmup_s=start_s, **loop_record(eng),
            logits_mm_out_dtype=llama._MM_OUT_DTYPE.get(eng.device),
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        emit("serve", **record)
        prof = profile_turn(db, users, text=FOLLOW_UP)
        # tracing slows the profiled turn; its device time against the
        # untraced turns' mean wall time gives the idle share of serving
        prof["untraced_turn_wall_ms"] = serve_s / turns * 1e3
        prof["device_idle_share_vs_untraced"] = 1.0 - prof[
            "device_busy_ms"] / prof["untraced_turn_wall_ms"]
        emit("profile", serve=name, **prof)
        attn = prof["attention_ms"]
        if paged and not (attn["ragged_prefill_fp32"] == 0
                          and attn["ragged_prefill_mma"] > 0):
            fail(f"serve {name}: the profiled turn's prefill ran outside "
                 f"the tensor-core body: {attn}")
        if not attn[decode_k.replace("_quant", "")] > 0:
            fail(f"serve {name}: no device time under the decode kernel "
                 f"{decode_k} in the profiled turn: {attn}")
        return launches
    finally:
        svc.stop()
        db.close()
        del svc, eng
        gc.collect()
        torch.cuda.empty_cache()


def loop_record(eng) -> dict:
    """A serve's decode loop: which loop, its chunk graphs (captured
    variants, launches per replay, pool bytes, chunks run) and its
    counters (resident sessions and chunks, host waits on the device)."""
    st = eng.stats()
    c = eng.metrics.counters
    return dict(decode_loop=st["decode_loop"],
                decode_graphs=st["decode_chunks"],
                resident_sessions=c["engine_resident_sessions"].value,
                resident_chunks=c["engine_resident_chunks"].value,
                host_syncs=c["engine_host_syncs"].value)


def await_replies(db, users, timeout=300.0):
    got = {}
    deadline = time.time() + timeout
    while len(got) < len(users) and time.time() < deadline:
        for u in users:
            for m in db.receive_messages(u, timeout=0.05):
                got[u] = m
    return got


#: Profiler names of the two ragged-prefill bodies: the fp32 one (any
#: float32 operand) and the tensor-core one (bf16 query and suffix).
PREFILL_BODIES = ("ragged_prefill_kernel<", "ragged_prefill_mma_kernel<")
#: Profiler names of the decode body's four kernels (csrc/decode.cuh),
#: by the profile key their device time is summed under; the int8 entry
#: points run the paged kernels.
DECODE_BODIES = {
    "paged_decode_chunked": ("paged_decode_chunked_cluster_kernel<",),
    "paged_decode": ("paged_decode_cluster_kernel<",),
    "dense_decode_chunked": ("dense_decode_chunked_cluster_kernel<",),
    "dense_decode": ("dense_decode_cluster_kernel<",)}


def profile_turn(db, users, text):
    """One more greedy turn (after the main path's counts were read) under
    ``torch.profiler`` tracing the device only: device time by kernel, and
    the device's idle share of the turn's wall time (kernels run on one
    stream, so their device times add up without overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for u in users:
            db.send_message(u, "assistant", text.format(u=u),
                            metadata={"generation": {"max_new_tokens": 32}})
        got = await_replies(db, users)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if len(got) < len(users):
        fail(f"profiled turn: {len(got)} of {len(users)} replies")

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    kernels = [(e.key, dev_us(e) / 1e3, e.count)
               for e in prof.key_averages() if dev_us(e) > 0]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    attn = {"ragged_prefill": PREFILL_BODIES, **DECODE_BODIES}
    attn.update({f"ragged_prefill_{body}": (pat,)
                 for body, pat in zip(("fp32", "mma"), PREFILL_BODIES)})
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "attention_ms": {k: sum(t for n, t, _ in kernels
                                if any(p in n for p in v))
                         for k, v in attn.items()},
        "top": [{"kernel": n[:90], "ms": t, "calls": c}
                for n, t, c in kernels[:12]],
    }


# ------------------------------------------------------------ decode_loop


#: (name, engine: True = paged / None = the default dense one, cache kind,
#: chunked): the decode_loop phase's modes, run on Llama-3-8B, then the
#: ``LOOP_MIXTRAL`` ones on Mixtral-8x7B.
LOOP_LLAMA = (("paged_bf16_chunked", True, "bfloat16", True),
              ("paged_int8_chunked", True, "int8", True),
              ("dense_chunked", None, "bfloat16", True),
              ("paged_bf16_single_step", True, "bfloat16", False),
              ("dense_single_step", None, "bfloat16", False))
LOOP_MIXTRAL = (("dense_chunked", None, "bfloat16", True),
                ("paged_bf16_chunked", True, "bfloat16", True))
#: Largest |logprob| difference allowed between a chunk replayed as a
#: graph and the same chunk run eagerly (same kernels, same inputs; bf16
#: GEMMs may pick other algorithms inside a capture).
LOOP_LP_TOL = 2e-2
#: The single-step paged decode kernel alone (kernels phase, PERF.md
#: section 6): its time at the serving shape and its fixed cost (all
#: slots at length 0), NVIDIA H100 80GB HBM3 at 700 W.
PAGED_DECODE_ALONE_MS, PAGED_DECODE_FIXED_MS = 0.0158, 0.0063
#: Mixtral-8x7B's decode step (16 layers) beside which its graph step is
#: printed: its byte bound, and the step the eager decode loop took
#: (engine wall and alone, PERF.md section 6), on the same card.
MIXTRAL_STEP_BOUND_MS, MIXTRAL_STEP_EAGER_MS = 13.96, (23.0, 87.0)


def _state_tensors(eng) -> list:
    """Every tensor a decode chunk writes: the fed-token vectors, the
    positions and the cache (pool payload, scales and table, or the dense
    slot cache)."""
    from swarmdb_tpu_torch.ops.paged_kv import QuantPool

    out = [eng._last_tokens, eng._last_lps, eng._io.positions]
    parts = (eng.cache.values() if isinstance(eng.cache, dict)
             else eng.cache)
    for t in parts:
        out.extend((t.data, t.scale) if isinstance(t, QuantPool) else (t,))
    return out


def graph_vs_eager(model, params, paged, kind, chunked, card) -> dict:
    """One engine (max_batch 8, max_seq 1024, decode_chunk 8) on
    ``params``: ``warmup`` captures its three variants' chunk graphs
    before any request (SWARMDB_PREWARM's path), on a fresh thread, four
    greedy requests
    (prompts of 300, 180, 420 and 90 tokens) are admitted, and from that
    saved state one greedy chunk is replayed as a graph and then run
    eagerly (``Engine._chunk_body``, the function the graph captured).
    Returns the comparison, the ms per chunk each way (CUDA events,
    median of 20 after 3; the positions reset before each run) and the
    graph's launches per replay."""
    import gc

    import numpy as np
    import torch

    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams
    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    with engine_env(chunked):
        eng, _tok = build_backend_engine(
            model, seed=0, device="cuda", params=params, paged=paged,
            kv_dtype=getattr(torch, kind) if paged else None)
    try:
        # on a thread of its own, as a server's start() may run it: one
        # that has run no GEMM yet (the capture must create its handles)
        warm = {}
        th = threading.Thread(target=lambda: warm.update(s=eng.warmup()))
        th.start()
        th.join()
        if "s" not in warm:
            fail(f"decode_loop: warmup failed on a fresh thread "
                 f"({model}, paged={paged}, {kind}, chunked={chunked})")
        warm_s = warm["s"]
        runner, io, K = eng._runner, eng._io, eng.decode_chunk
        rng = np.random.default_rng(3)
        for n in (300, 180, 420, 90):
            eng.submit(GenRequest(prompt=rng.integers(3, 30000, n).tolist(),
                                  sampling=SamplingParams(max_new_tokens=64)))
        eng._admit()
        live = [i for i, s in enumerate(eng.slots) if s.active]
        positions = np.array([s.dispatched_position if s.active else 0
                              for s in eng.slots], np.int32)
        inputs = eng._chunk_inputs(positions)
        saved = [t.clone() for t in _state_tensors(eng)]
        variant = 2
        ac.reset_launches()
        g_tok, g_lp = runner.launch(variant, inputs).host()
        replay_launches = dict(ac.LAUNCHES)
        for t, v in zip(_state_tensors(eng), saved):
            t.copy_(v)
        for buf, a in zip(io.inputs(), inputs):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        eng._chunk_body(variant)
        e_tok = io.block.cpu().numpy()
        e_lp = io.block_lps.cpu().numpy()
        equal = bool(np.array_equal(g_tok[:, live], e_tok[:, live]))
        lp_err = float(np.abs(g_lp[:, live] - e_lp[:, live]).max())
        pos0 = saved[2]
        graph = runner.graphs[variant]

        def replay():
            io.positions.copy_(pos0)
            graph.replay()

        def eager():
            io.positions.copy_(pos0)
            eng._chunk_body(variant)

        graph_ms = time_events(replay, iters=20)
        eager_ms = time_events(eager, iters=20)
        rec = dict(
            live_slots=len(live), variant=variant, greedy_equal=equal,
            logprob_max_abs_err=lp_err, logprob_bound=LOOP_LP_TOL,
            graph_ms_per_chunk=graph_ms, eager_ms_per_chunk=eager_ms,
            graph_ms_per_step=graph_ms / K, eager_ms_per_step=eager_ms / K,
            eager_over_graph=eager_ms / graph_ms,
            launches_per_replay=runner.graph_launches[variant],
            launches_counted_by_one_replay={k: n for k, n in
                                            replay_launches.items() if n},
            graphs=sorted(runner.graphs), capture_s=runner.capture_s,
            warmup_s=warm_s, graph_pool_bytes=runner.pool_bytes, card=card)
        if paged and not chunked and kind == "bfloat16":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    replay()
                torch.cuda.synchronize()
            hits = [(t, c) for n, t, c in _kernel_times(prof)
                    if DECODE_BODIES["paged_decode"][0] in n]
            calls = sum(c for _, c in hits)
            rec.update(
                paged_decode_in_graph_ms=(sum(t for t, _ in hits) / calls
                                          if calls else None),
                paged_decode_in_graph_calls=calls,
                paged_decode_alone_ms=PAGED_DECODE_ALONE_MS,
                paged_decode_fixed_ms=PAGED_DECODE_FIXED_MS)
        return rec
    finally:
        del eng
        gc.collect()
        torch.cuda.empty_cache()


def run_decode_loop(card, model, params, modes) -> None:
    """The decode_loop phase on one model: graph against eager in every
    mode of ``modes`` (``graph_vs_eager``); fails on unequal greedy
    tokens, logprobs past ``LOOP_LP_TOL`` or a replay that counted other
    launches than its capture recorded."""
    from swarmdb_tpu_torch.models.configs import ModelConfig

    name = model.name if isinstance(model, ModelConfig) else model
    for mode, paged, kind, chunked in modes:
        rec = graph_vs_eager(model, params, paged, kind, chunked, card)
        if name.startswith("mixtral"):
            rec.update(step_byte_bound_ms=MIXTRAL_STEP_BOUND_MS,
                       eager_loop_step_ms=MIXTRAL_STEP_EAGER_MS)
        emit("decode_loop", model=name, mode=mode, **rec)
        if not rec["greedy_equal"]:
            fail(f"decode_loop {name} {mode}: greedy tokens differ graph "
                 f"vs eager")
        if not rec["logprob_max_abs_err"] <= LOOP_LP_TOL:
            fail(f"decode_loop {name} {mode}: logprobs differ by "
                 f"{rec['logprob_max_abs_err']} > {LOOP_LP_TOL}")
        if rec["launches_counted_by_one_replay"] != rec["launches_per_replay"]:
            fail(f"decode_loop {name} {mode}: a replay counted "
                 f"{rec['launches_counted_by_one_replay']}, its capture "
                 f"recorded {rec['launches_per_replay']}")
        if "paged_decode_in_graph_calls" in rec and not rec[
                "paged_decode_in_graph_calls"]:
            fail(f"decode_loop {name} {mode}: the profiler saw no "
                 f"paged_decode kernel inside the replays")


# --------------------------------------------------------------------- api


API_GEN = {"max_new_tokens": 32}


def visible_tokenizer(vocab_size: int):
    """The byte tokenizer, except that an id outside the byte range
    decodes to ``<id>`` instead of nothing. Random Llama-3-8B weights
    sample from 128256 ids, 256 of them bytes: with the plain byte
    tokenizer a reply is nearly always empty text, and a stream carries
    no token event to compare or to time."""
    from swarmdb_tpu_torch.backend.tokenizer import ByteTokenizer

    class VisibleIds(ByteTokenizer):
        def decode(self, ids):
            out, run = [], []
            for i in ids:
                if self._OFFSET <= i < 256 + self._OFFSET:
                    run.append(i)
                    continue
                if run:
                    out.append(super().decode(run))
                    run = []
                if i >= 256 + self._OFFSET:
                    out.append(f"<{i}>")
            if run:
                out.append(super().decode(run))
            return "".join(out)

    return VisibleIds(vocab_size)


def _sse_events(lines):
    """(event, JSON data) pairs from an SSE body's lines."""
    out, event = [], None
    for ln in lines:
        if ln.startswith("event: "):
            event = ln[7:]
        elif ln.startswith("data: ") and event is not None:
            out.append((event, json.loads(ln[6:])))
            event = None
    return out


async def _stream_post(session, url, path, headers, body):
    """POST one streamed request; returns (events, seconds from the send
    to the first token event, or None)."""
    t0 = time.perf_counter()
    first = None
    lines = []
    async with session.post(url + path, json=body, headers=headers) as r:
        if r.status != 200:
            fail(f"api: POST {path} gave {r.status}: {await r.text()}")
        async for raw in r.content:
            ln = raw.decode().rstrip("\r\n")
            if first is None and ln == "event: token":
                first = time.perf_counter() - t0
            lines.append(ln)
    return _sse_events(lines), first


async def _api_http(db, svc, backend, then):
    """Steps (a)-(c) over HTTP: create_app served on 127.0.0.1:0 with
    aiohttp's AppRunner, driven by an aiohttp client; then ``then()`` off
    the loop, before the app's shutdown stops the service and closes the
    runtime."""
    import aiohttp
    from aiohttp import web

    from swarmdb_tpu_torch.api.app import ApiConfig, create_app

    app = create_app(db, ApiConfig(jwt_secret_key="chip-smoke",
                                   rate_limit_per_minute=100_000),
                     serving=svc)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    out = {}
    try:
        async with aiohttp.ClientSession() as s:
            async def token(user):
                async with s.post(url + "/auth/token", json={
                        "username": user, "password": "pw"}) as r:
                    return {"Authorization":
                            f"Bearer {(await r.json())['access_token']}"}

            admin = await token("admin")
            users = [f"user{i}" for i in range(4)]
            hdr = {u: await token(u) for u in users}
            for a in users + ["assistant", "helper"]:
                async with s.post(url + "/agents/register",
                                  json={"agent_id": a}, headers=admin) as r:
                    assert r.status == 200
            for a in ("assistant", "helper"):
                async with s.post(url + "/admin/llm_backend", json={
                        "agent_id": a, "backend_id": backend},
                        headers=admin) as r:
                    if r.status != 200:
                        fail(f"api: llm_backend gave {r.status}")
            # (a) one streamed message per user, all at once
            runs = await asyncio.gather(*[
                _stream_post(s, url, "/messages", hdr[u], {
                    "receiver_id": "assistant", "stream": True,
                    "content": USER_TEXT.format(u=u),
                    "metadata": {"generation": API_GEN}})
                for u in users])
            streams = []
            for u, (events, ttft) in zip(users, runs):
                text = "".join(d for e, d in events if e == "token")
                reply = [d for e, d in events if e == "reply"]
                sent = [d for e, d in events if e == "message"][0]
                stages = db.get_message(sent["id"]).metadata["stages"]
                streams.append(dict(
                    user=u, client_ttft_s=ttft,
                    service_send_to_first_token_s=(
                        stages["first_token"] - stages["enqueued"]),
                    tokens_streamed=sum(e == "token" for e, _ in events),
                    reply_tokens=(reply[0]["metadata"]["completion_tokens"]
                                  if reply else None),
                    finish_reason=(reply[0]["metadata"]["finish_reason"]
                                   if reply else None),
                    streamed_equals_reply=bool(reply)
                    and text == reply[0]["content"]))
            out["a"] = streams
            # (b) n = 2, seeded and sampled
            events, _ = await _stream_post(s, url, "/messages", hdr["user0"], {
                "receiver_id": "assistant", "stream": True,
                "content": FOLLOW_UP.format(u="user0"),
                "metadata": {"generation": dict(
                    API_GEN, n=2, temperature=0.8, top_p=0.9, seed=11)}})
            reply = [d for e, d in events if e == "reply"][0]
            out["b"] = dict(body=reply["content"],
                            body_tokens=reply["metadata"]["completion_tokens"],
                            alternatives=reply["metadata"].get(
                                "alternatives"))
            # (c) a group of two LLM-backed members, streamed
            async with s.post(url + "/groups", json={
                    "group_name": "crew",
                    "agent_ids": ["user1", "assistant", "helper"]},
                    headers=hdr["user1"]) as r:
                assert r.status == 200
            events, ttft = await _stream_post(
                s, url, "/groups/message", hdr["user1"], {
                    "group_name": "crew", "stream": True,
                    "content": FOLLOW_UP.format(u="user1"),
                    "metadata": {"generation": API_GEN}})
            done = [d for e, d in events if e == "reply_done"]
            stored = {}
            for d in done:
                rid = db.get_message(d["message_id"]).metadata.get(
                    "reply_id")
                stored[d["message_id"]] = db.get_message(rid).content
            out["c"] = dict(
                members=len([e for e, _ in events if e == "message"]),
                token_events=sum(e == "token" for e, _ in events),
                client_ttft_s=ttft,
                replies=[dict(finish_reason=d["finish_reason"],
                              text_equals_stored=d["text"]
                              == stored[d["message_id"]])
                         for d in done])
            async with s.get(url + "/metrics") as r:
                out["metrics_lane_state"] = [
                    ln for ln in (await r.text()).splitlines()
                    if ln.startswith("swarmdb_lane_state")]
        report_http(out)
        await asyncio.get_running_loop().run_in_executor(None, then)
    finally:
        await runner.cleanup()


def _served_once(svc, msg, on_token=None, timeout=300.0):
    """serve_message through the service; returns (tokens, reason,
    streamed)."""
    import threading

    done = threading.Event()
    got, streamed = {}, []

    def tok(rid, t):
        streamed.append(t)
        if on_token is not None:
            on_token(streamed)

    def fin(rid, toks, reason):
        got.update(toks=toks, reason=reason)
        done.set()

    svc.serve_message(msg, on_token=tok, on_done=fin)
    if not done.wait(timeout):
        fail("api: a supervised request never finished")
    return got["toks"], got["reason"], streamed


def report_http(out):
    """Print and check steps (a)-(c)."""
    emit("api", step="a_http_streams", streams=out["a"])
    b = out["b"]
    emit("api", step="b_n2", body_tokens=b["body_tokens"],
         alternatives=[dict(finish_reason=a["finish_reason"],
                            completion_tokens=a["completion_tokens"],
                            differs=a["text"] != b["body"])
                       for a in (b["alternatives"] or [])])
    emit("api", step="c_group_stream", **out["c"],
         metrics_lane_state=out["metrics_lane_state"])
    checks = {
        "(a) 4 of 4 streams equal their reply, 32 tokens": all(
            s["streamed_equals_reply"] and s["reply_tokens"] == 32
            and s["client_ttft_s"] is not None for s in out["a"])
        and len(out["a"]) == 4,
        "(b) one alternative of 32 tokens, not the body": (
            len(b["alternatives"] or []) == 1
            and b["alternatives"][0]["completion_tokens"] == 32
            and b["alternatives"][0]["text"] != b["body"]),
        "(c) two members streamed, replies stored": (
            out["c"]["members"] == 2 and out["c"]["token_events"] > 0
            and len(out["c"]["replies"]) == 2
            and all(r["text_equals_stored"] for r in out["c"]["replies"])),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"api: {bad}")


def kill_replay(svc, eng):
    """(d), dense: a decode killed mid-stream, replayed by the service's
    supervisor."""
    from swarmdb_tpu_torch.backend.chaos import ServingChaos, wait_until
    from swarmdb_tpu_torch.core.messages import Message

    chaos = ServingChaos(eng)
    try:
        killed = []

        def kill_at_8(streamed):
            if len(streamed) == 8 and not killed:
                killed.append(True)
                chaos.kill_lane(0)

        msg = Message(sender_id="user2", receiver_id="assistant",
                      content=FOLLOW_UP.format(u="user2"),
                      metadata={"generation": dict(API_GEN)})
        t0 = time.perf_counter()
        toks, reason, streamed = _served_once(svc, msg, kill_at_8)
        took = time.perf_counter() - t0
        st = svc.supervisor.status()
        wait_until(lambda: svc.supervisor.status()["lanes"][0]["state"]
                   == "alive", 120.0, what="the engine re-admitted")
        after = svc.supervisor.status()
        emit("api", step="d_kill_replay", killed=bool(killed),
             reason=reason, tokens=len(toks),
             streamed_equals_final=streamed == toks, seconds=took,
             requests_retried=st["requests_retried"],
             requests_migrated=st["requests_migrated"],
             restarts=after["lanes"][0]["restarts"],
             readmissions=after["lane_readmissions"],
             dense_max_step_s=eng.max_step_s)
        if not (killed and reason == "length" and len(toks) == 32
                and streamed == toks and st["requests_retried"] >= 1):
            fail(f"api (d): kill/replay failed: reason={reason} "
                 f"tokens={len(toks)} streamed={len(streamed)} "
                 f"status={st}")
    finally:
        chaos.stop()


def shed_heal(params):
    """(d), paged bf16: a squeezed pool sheds the low-priority request;
    the supervisor's retries (budget and backoff from its constructor,
    covering the squeeze) serve it after heal_pool."""
    import threading

    import torch

    from swarmdb_tpu_torch.backend.chaos import ServingChaos, wait_until
    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams
    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.backend.supervisor import LaneSupervisor

    eng, tok = build_backend_engine("llama3-8b", seed=0, device="cuda",
                                    params=params, paged=True,
                                    kv_dtype=torch.bfloat16)
    retries, backoff_s = 8, 0.25
    sup = LaneSupervisor(eng, retries=retries, backoff_s=backoff_s,
                         deadline_s=120.0)
    chaos = ServingChaos(eng)
    try:
        eng.start()
        sup.start()
        results = {}
        events = {k: threading.Event() for k in ("low", "high")}

        def mk(name):
            def fin(rid, toks, reason):
                results[name] = (toks, reason, time.time())
                events[name].set()
            return fin

        prompt = tok.encode(USER_TEXT.format(u="user3"))
        squeezed = chaos.squeeze_pool(1.0)
        low = GenRequest(prompt=list(prompt), priority=0,
                         sampling=SamplingParams(max_new_tokens=32),
                         on_done=mk("low"))
        sup.submit(low)
        sup.submit(GenRequest(prompt=list(prompt), priority=3,
                              sampling=SamplingParams(max_new_tokens=32),
                              on_done=mk("high")))
        wait_until(lambda: eng.metrics.counters["requests_shed"].value >= 1,
                   30.0, what="a shed request")
        time.sleep(0.5)
        t_heal = time.time()
        chaos.heal_pool()
        for k, e in events.items():
            if not e.wait(120):
                fail(f"api (d): the {k}-priority request never finished")
        st = sup.status()
        low_toks, low_reason, low_t = results["low"]
        emit("api", step="d_shed_heal", squeezed_pages=squeezed,
             supervisor_retries=retries, supervisor_backoff_s=backoff_s,
             requests_shed=st["requests_shed"],
             requests_retried=st["requests_retried"],
             low=dict(reason=low_reason, tokens=len(low_toks),
                      served_s_after_heal=low_t - t_heal,
                      within_deadline=low_t < low.deadline),
             high=dict(reason=results["high"][1],
                       tokens=len(results["high"][0])),
             paged_max_step_s=eng.max_step_s)
        if not (st["requests_shed"] >= 1 and st["requests_retried"] >= 1
                and low_reason == "length" and len(low_toks) == 32
                and low_t < low.deadline
                and results["high"][1] == "length"):
            fail(f"api (d): shed/heal failed: {results} status={st}")
    finally:
        chaos.stop()
        sup.stop()
        eng.stop()


def run_api(card, params):
    """The api phase: the wire API and supervised serving on Llama-3-8B
    (the serves' weights), then the server entry point as a subprocess.
    Returns the launches of the in-process steps (counted from zero)."""
    import gc
    import tempfile

    import torch

    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    try:
        import aiohttp  # noqa: F401
        import yaml  # noqa: F401
        have_http = True
    except ImportError as exc:
        emit("api", step="imports", missing=str(exc))
        have_http = False
    emit("api", step="start", card=card)
    backend = "h100-0"
    save_dir = tempfile.mkdtemp(prefix="swarm_api_")
    launches_before = dict(ac.LAUNCHES)
    ac.reset_launches()
    # the default (dense) engine, supervised by the service
    db = SwarmDB(broker=LocalBroker(), save_dir=save_dir)
    with engine_env(chunked=True):
        eng, tok = build_backend_engine(
            "llama3-8b", seed=0, device="cuda", params=params,
            metrics=db.metrics)
    svc = ServingService(db, eng, visible_tokenizer(tok.vocab_size),
                         backend_id=backend)
    try:
        if eng.paged is not None or svc.supervisor is None:
            fail("api: expected the dense engine under a supervisor")
        svc.start()
        db.register_agent("assistant")
        if have_http:
            asyncio.run(_api_http(db, svc, backend,
                                  lambda: kill_replay(svc, eng)))
        else:
            kill_replay(svc, eng)
    finally:
        svc.stop()
        db.close()
        del svc, eng
        gc.collect()
        torch.cuda.empty_cache()
    shed_heal(params)
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict(ac.LAUNCHES)
    emit("api", step="kernels", launches_before_phase={
        k: n for k, n in launches_before.items() if n},
        launches_in_phase={k: n for k, n in launches.items() if n})
    need = ("dense_decode_chunked", "ragged_prefill", "paged_decode_chunked")
    if not all(launches[k] > 0 for k in need):
        fail(f"api: kernels {need} must launch in the phase: {launches}")
    if have_http:
        run_server_process(save_dir)
    return launches


def run_server_process(save_dir):
    """(e) ``python -m swarmdb_tpu_torch.api.server`` with SERVE_MODEL =
    tiny-debug on the card: /health names it, one message is answered,
    then the server stops on SIGTERM."""
    import socket
    import urllib.request

    import torch

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, SERVE_MODEL="tiny-debug", API_HOST="127.0.0.1",
               API_PORT=str(port), SAVE_DIR=os.path.join(save_dir, "srv"),
               JWT_SECRET_KEY="chip-smoke", SERVE_MAX_SEQ="256",
               SWARMDB_PREWARM="1", PYTHONPATH=str(ROOT))
    env.pop("SWARMDB_PAGED", None)
    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "swarmdb_tpu_torch.api.server"], cwd=str(ROOT),
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)

    def call(path, body=None, headers=None):
        req = urllib.request.Request(
            url + path, data=None if body is None else
            json.dumps(body).encode(), headers={
                "Content-Type": "application/json", **(headers or {})},
            method="GET" if body is None else "POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read().decode()

    try:
        health = None
        while time.perf_counter() - t0 < 180:
            if proc.poll() is not None:
                fail(f"api (e): the server exited with {proc.returncode}: "
                     f"{proc.stderr.read().decode()[-2000:]}")
            try:
                health = json.loads(call("/health"))
                break
            except OSError:
                time.sleep(0.5)
        if health is None:
            fail("api (e): the server never answered /health")
        up_s = time.perf_counter() - t0
        device = (health.get("tpu") or {}).get("device", "")
        # SWARMDB_PREWARM=1: start() captured every variant's graph on the
        # server's main thread, before any request
        prewarmed = health["tpu"]["engine"]["decode_chunks"]["graphs"]
        tokn = json.loads(call("/auth/token", {"username": "admin",
                                               "password": "pw"}))
        hdr = {"Authorization": f"Bearer {tokn['access_token']}"}
        call("/agents/register", {"agent_id": "assistant"}, hdr)
        call("/admin/llm_backend", {"agent_id": "assistant",
                                    "backend_id": "gpu-0"}, hdr)
        body = call("/messages", {
            "receiver_id": "assistant", "content": "hello from the smoke",
            "stream": True,
            "metadata": {"generation": {"max_new_tokens": 8}}}, hdr)
        events = _sse_events(body.splitlines())
        reply = [d for e, d in events if e == "reply"]
        emit("api", step="e_server_process", seconds_to_health=up_s,
             health_device=device, engine=health["tpu"]["engine"]["cache"],
             reply_finish_reason=(reply[0]["metadata"]["finish_reason"]
                                  if reply else None),
             token_events=sum(e == "token" for e, _ in events),
             prewarmed_graphs=prewarmed)
        if torch.cuda.get_device_name(0) not in device or not reply:
            fail(f"api (e): /health device {device!r}, reply {reply}")
        if prewarmed != [0, 1, 2]:
            fail(f"api (e): SWARMDB_PREWARM=1 captured graphs {prewarmed}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


# --------------------------------------------------------------------- obs


#: The obs phase's two engines: (name, paged), the default dense one and
#: the paged one over a bf16 pool, both chunked.
OBS_MODES = (("dense_chunked", None), ("paged_bf16_chunked", True))
#: The SLO sentinel's settings while the obs phase serves.
OBS_SLO_ENV = dict(SWARMDB_SLO_WINDOW_S="2", SWARMDB_SLO_WARMUP="1",
                   SWARMDB_SLO_MIN_COMPLETIONS="4")
OBS_USERS = 4
#: Spans every served message's trace must hold, by the id they carry:
#: the message id, and the engine request id (``serve.request`` joins
#: them); ``api.request`` and ``engine.host_sync`` carry neither.
OBS_MSG_SPANS = ("runtime.send", "broker.publish", "serve.request")
OBS_ENGINE_SPANS = ("engine.admit", "engine.prefill")
#: The six histogram blocks of /metrics, as the JAX package's server has
#: them.
OBS_HISTOGRAMS = ("broker_publish_seconds", "dataplane_rtt_seconds",
                  "decode_chunk_seconds", "queue_wait_seconds",
                  "replication_commit_seconds", "ttft_seconds")
#: The overhead A/B: alternating pairs of turns with the tracer, the
#: histograms and the sentinel on and off; the phase fails above the
#: bound of the JAX package's own smoke test (its budget is 5%).
OBS_AB_PAIRS = 3
OBS_OVERHEAD_FAIL_PCT = 20.0
OBS_ECHO_SEGMENT_S = 1.0
#: Turns a round may take to close a window of the sentinel's minimum
#: completions (a window boundary can fall inside a round's burst).
OBS_ROUND_TRIES = 3
OBS_THIRD = ("One more thing from {u}: which of the three days is best "
             "for a museum pass, and why?")
OBS_LAST = "Last question from {u}: how long is the walk?"


def _obs_set(db, on: bool) -> None:
    """Tracer, histograms (with exemplars) and sentinel, together."""
    from swarmdb_tpu_torch.obs import HISTOGRAMS, TRACER

    TRACER.set_enabled(on)
    HISTOGRAMS.set_enabled(on)
    HISTOGRAMS.set_exemplars_enabled(on)
    db.sentinel.set_enabled(on)


def _echo_loop(db, seconds: float) -> float:
    """``bench.py``'s ``_echo_loop``: ping-pong round trips through the
    runtime alone (no engine); messages per second."""
    db.register_agent("ping")
    db.register_agent("pong")
    for _ in range(50):
        db.send_message("ping", "pong", "warm")
        db.receive_messages("pong", max_messages=10, timeout=0.0)
    t0 = time.time()
    roundtrips = 0
    while time.time() - t0 < seconds:
        db.send_message("ping", "pong", "ping!")
        got = db.receive_messages("pong", max_messages=1, timeout=1.0)
        if got:
            db.send_message("pong", "ping", "pong!")
            back = db.receive_messages("ping", max_messages=1, timeout=1.0)
            if back:
                roundtrips += 1
    return 2 * roundtrips / (time.time() - t0)


def echo_ab() -> dict:
    """The host-only A/B: the echo loop in segments with the
    observability on and off (on, off, off, on, on, off) over one
    runtime, the sentinel's window short enough to close inside each
    segment; medians."""
    import tempfile

    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    db = SwarmDB(broker=LocalBroker(), autosave_interval=1e9,
                 save_dir=tempfile.mkdtemp(prefix="swarm_echo_"))
    db.sentinel.config.window_s = 0.25
    rates = {True: [], False: []}
    try:
        for on in (True, False, False, True, True, False):
            _obs_set(db, on)
            rates[on].append(_echo_loop(db, OBS_ECHO_SEGMENT_S))
    finally:
        _obs_set(db, True)
        db.close()
    on, off = (statistics.median(rates[True]),
               statistics.median(rates[False]))
    return {"echo_msgs_per_s_on": rates[True],
            "echo_msgs_per_s_off": rates[False],
            "echo_overhead_pct": (off - on) / off * 100 if off else None}


def run_obs(card, params):
    """The obs phase (Llama-3-8B at full width on the serve phase's
    weights): both engines through the wire API with the tracer,
    histograms and sentinel on, then the echo A/B. Returns the phase's
    launches."""
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    t0 = time.perf_counter()
    ac.reset_launches()
    for name, paged in OBS_MODES:
        obs_serve(card, params, name, paged)
    launches = dict(ac.LAUNCHES)
    echo = echo_ab()
    emit("obs", part="done", seconds=time.perf_counter() - t0,
         launches={k: n for k, n in launches.items() if n}, card=card,
         **echo)
    need = ("dense_decode_chunked", "ragged_prefill", "paged_decode_chunked")
    if not all(launches[k] > 0 for k in need):
        fail(f"obs: kernels {need} must launch in the phase: {launches}")
    return launches


def obs_serve(card, params, name, paged):
    """One engine of the obs phase, served in process through
    ``create_app`` on 127.0.0.1:0 (the api phase's way)."""
    import gc
    import tempfile

    import torch

    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.obs import HISTOGRAMS, TRACER

    flight_dir = tempfile.mkdtemp(prefix="swarm_obs_flight_")
    TRACER.reset()
    HISTOGRAMS.reset()
    with env_scope(SWARMDB_FLIGHT_DIR=flight_dir, SWARMDB_SENTINEL=None,
                   SWARMDB_TRACE=None, SWARMDB_HISTOGRAMS=None,
                   SWARMDB_SLO_TTFT_P95_S=None, **OBS_SLO_ENV):
        db = SwarmDB(broker=LocalBroker(),
                     save_dir=tempfile.mkdtemp(prefix="swarm_obs_"))
        _obs_set(db, True)
        with engine_env(chunked=True):
            eng, tok = build_backend_engine(
                "llama3-8b", seed=0, device="cuda", params=params,
                paged=paged, kv_dtype=torch.bfloat16 if paged else None,
                metrics=db.metrics)
        svc = ServingService(db, eng, visible_tokenizer(tok.vocab_size),
                             backend_id="h100-obs")
        # the live snapshot slots of every processed chunk, counted
        # outside the engine's own span code
        slots = [0]
        process = eng._process_host_block

        def counted(block, lps, snapshot, t_dispatch_ns):
            slots[0] += len(snapshot)
            return process(block, lps, snapshot, t_dispatch_ns)

        eng._process_host_block = counted
        try:
            svc.start(warmup=True)
            asyncio.run(_obs_http(db, svc, eng, slots, name, bool(paged),
                                  flight_dir, card))
        finally:
            svc.stop()
            db.close()
            del eng._process_host_block
            del svc, eng, process, counted
            gc.collect()
            torch.cuda.empty_cache()


async def _obs_http(db, svc, eng, slots, name, paged, flight_dir, card):
    import aiohttp
    from aiohttp import web

    from swarmdb_tpu_torch.api.app import ApiConfig, create_app
    from swarmdb_tpu_torch.obs.sentinel import SLOConfig

    app = create_app(db, ApiConfig(jwt_secret_key="chip-smoke",
                                   rate_limit_per_minute=100_000),
                     serving=svc)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    url = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
    c = db.metrics.counters
    try:
        async with aiohttp.ClientSession() as s:
            async def token(user):
                async with s.post(url + "/auth/token", json={
                        "username": user, "password": "pw"}) as r:
                    return {"Authorization":
                            f"Bearer {(await r.json())['access_token']}"}

            async def get(path):
                async with s.get(url + path, headers=admin) as r:
                    if r.status != 200:
                        fail(f"obs {name}: GET {path} gave {r.status}")
                    if path.startswith("/metrics"):
                        return await r.text()
                    return await r.json()

            admin = await token("admin")
            hdr = {}

            async def turn(users, text, one_wave=False):
                """One message per user at once, streamed; every reply
                must end length / eos. Returns (message ids, wall s).
                ``one_wave``: the engine's loop is held at its chaos seam
                until every message is queued, so the turn admits in one
                wave (the A/B's turns then differ by the observability,
                not by how the arrivals met the loop); the wall starts
                at the release."""
                for u in users:
                    if u not in hdr:
                        hdr[u] = await token(u)
                        db.register_agent(u)
                gate = threading.Event()
                if one_wave:
                    eng.chaos_step = lambda e: gate.wait(30)
                t0 = time.perf_counter()
                runs = [asyncio.ensure_future(_stream_post(
                    s, url, "/messages", hdr[u], {
                        "receiver_id": "assistant", "stream": True,
                        "content": text.format(u=u),
                        "metadata": {"generation": API_GEN}}))
                    for u in users]
                if one_wave:
                    deadline = time.time() + 30
                    while time.time() < deadline:
                        with eng._cv:
                            if len(eng._queue) >= len(users):
                                break
                        await asyncio.sleep(0.002)
                    eng.chaos_step = None
                    t0 = time.perf_counter()
                    gate.set()
                runs = await asyncio.gather(*runs)
                wall = time.perf_counter() - t0
                ids = []
                for events, _ in runs:
                    reply = [d for e, d in events if e == "reply"]
                    if not reply or reply[0]["metadata"].get(
                            "finish_reason") not in ("length", "eos"):
                        fail(f"obs {name}: a reply did not end length/eos")
                    ids.append([d for e, d in events
                                if e == "message"][0]["id"])
                return ids, wall

            async def close_window():
                """Wait out the sentinel's window, then close it
                (``?tick=1``)."""
                wait = db.sentinel._deadline - time.monotonic()
                await asyncio.sleep(max(0.0, wait) + 0.05)
                return await get("/admin/slo?tick=1")

            async def idle():
                deadline = time.time() + 60
                while (eng._any_active() or eng._in_step) and \
                        time.time() < deadline:
                    await asyncio.sleep(0.02)
                await asyncio.sleep(0.3)

            db.register_agent("assistant")
            db.assign_llm_backend("assistant", "h100-obs")
            users = [f"user{i}" for i in range(OBS_USERS)]
            # rounds 1-2: 4 users x 2 turns; a round repeats (at most
            # OBS_ROUND_TRIES) while no window of the sentinel's minimum
            # completions has closed to train the baseline
            ids, tries = [], 0
            for text in (USER_TEXT, FOLLOW_UP):
                got, _ = await turn(users, text)
                ids += got
                slo = await close_window()
            while slo["baseline"] is None and tries < OBS_ROUND_TRIES:
                tries += 1
                got, _ = await turn(users, FOLLOW_UP)
                ids += got
                slo = await close_window()
            await idle()
            served = len(ids)
            # spans, by message id and engine request id
            trace = await get("/admin/trace/export")
            spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
            by_rid = {}
            for e in spans:
                rid = (e.get("args") or {}).get("rid")
                by_rid.setdefault(rid, []).append(e)
            names = [e["name"] for e in spans]
            missing, engine_rids = [], []
            for mid in ids:
                mnames = [e["name"] for e in by_rid.get(mid, [])]
                serve = [e for e in by_rid.get(mid, [])
                         if e["name"] == "serve.request"]
                rid = serve[0]["args"]["engine_rid"] if serve else None
                engine_rids.append(rid)
                enames = [e["name"] for e in by_rid.get(rid, [])]
                if (not all(n in mnames for n in OBS_MSG_SPANS)
                        or not all(n in enames for n in OBS_ENGINE_SPANS)
                        or enames.count("engine.decode_chunk") < 2):
                    missing.append((mid, sorted(set(mnames)),
                                    sorted(set(enames))))
            api_posts = sum(1 for e in spans if e["name"] == "api.request"
                            and e["args"].get("path") == "/messages")
            # the same trace through the cluster merge, trace by trace
            cluster_equal = True
            for tid in ids[:2] + engine_rids[:2]:
                a = await get(f"/admin/trace/export?trace_id={tid}")
                b = await get(f"/admin/cluster/trace?trace_id={tid}")
                cluster_equal &= (
                    sum(e.get("ph") == "X" for e in a["traceEvents"])
                    == sum(e.get("ph") == "X" for e in b["traceEvents"])
                    and b["metadata"]["unreachable"] == [])
            flight = await get("/admin/flight")
            last = flight["steps"][-1] if flight["steps"] else {}
            settled = {k: (last.get(k), c[ctr].value) for k, ctr in (
                ("tokens_generated", "tokens_generated"),
                ("prompt_tokens", "prompt_tokens"),
                ("prefill_packed_tokens", "prefill_packed_tokens"),
                ("host_syncs", "engine_host_syncs"),
                ("restarts", "engine_restarts"))}
            metrics = await get("/metrics")
            hist_blocks = sorted(
                ln.split()[2][len("swarmdb_"):] for ln in
                metrics.splitlines() if ln.startswith("# TYPE swarmdb_")
                and ln.endswith(" histogram"))
            ttft_count = next(int(ln.split()[1]) for ln in
                              metrics.splitlines()
                              if ln.startswith("swarmdb_ttft_seconds_count"))
            phase = {k: c[f"phase_us_{k}"].value for k in
                     ("queue_wait", "prefill", "decode", "host_sync")}
            checks = {
                "every message's spans": not missing,
                f"api.request per POST /messages ({served})":
                    api_posts >= served,
                "engine.host_sync in the process":
                    names.count("engine.host_sync") >= 1,
                "export not truncated": not trace["metadata"].get(
                    "truncated"),
                "decode_chunk spans == live snapshot slots":
                    names.count("engine.decode_chunk") == slots[0] > 0,
                "flight step and request rings": bool(
                    flight["steps"]) and bool(flight["requests"]),
                "last step's counters == db.metrics": all(
                    a == b for a, b in settled.values()),
                "six histogram blocks": hist_blocks == list(OBS_HISTOGRAMS),
                "ttft_seconds_count == requests served": ttft_count
                    == served,
                "phase_us_queue_wait > 0": phase["queue_wait"] > 0,
                "phase_us_host_sync > 0": phase["host_sync"] > 0,
                "cluster trace == trace export": cluster_equal,
                "baseline learned": slo["baseline"] is not None,
            }
            emit("obs", serve=name, model="llama3-8b", served=served,
                 extra_rounds=tries, spans={n: names.count(n) for n in
                                            sorted(set(names))},
                 decode_chunk_slots=slots[0], api_message_posts=api_posts,
                 flight_steps=len(flight["steps"]),
                 flight_requests=len(flight["requests"]),
                 last_step=last, settled=settled,
                 request_record=flight["requests"][-1]
                 if flight["requests"] else None,
                 histograms=hist_blocks, ttft_seconds_count=ttft_count,
                 phase_us=phase, host_syncs=c["engine_host_syncs"].value,
                 decode_chunks=c["engine_decode_chunks"].value,
                 sentinel=dict(windows_total=slo["windows_total"],
                               baseline=slo["baseline"],
                               last_window=slo["last_window"],
                               alerts_total=slo["alerts_total"]),
                 missing=missing[:4], card=card, checks=checks)
            bad = [k for k, ok in checks.items() if not ok]
            if bad:
                fail(f"obs {name} checks failed: {bad}")
            # a forced breach: TTFT p95 over 1 ms
            alerts_before = slo["alerts_total"]
            with env_scope(SWARMDB_SLO_TTFT_P95_S="0.001"):
                db.sentinel.config.ttft_p95_s = SLOConfig().ttft_p95_s
            third, tries = 0, 0
            while tries < OBS_ROUND_TRIES:
                tries += 1
                got, _ = await turn(users, OBS_THIRD)
                third += len(got)
                slo = await close_window()
                if slo["alerts_total"] > alerts_before:
                    break
            alert = next((a for a in reversed(slo["alerts"]) if any(
                b["slo"] == "ttft_p95_s" and b["limit"] == 0.001
                for b in a["breaches"])), None)
            shares = alert["diagnosis"]["shares"] if alert else {}
            dumps = sorted(os.listdir(flight_dir))
            breach = {
                "/admin/slo breached": slo["breached"] is True,
                "an alert on ttft_p95_s > 0.001": alert is not None,
                "shares sum to 1 within 1e-3": bool(shares) and abs(
                    sum(shares.values()) - 1.0) <= 1e-3,
                "dominant contributor named": bool(alert) and alert[
                    "dominant"] in shares,
                "flight dump with the alert id": bool(alert) and bool(
                    alert["flight_dump"]) and alert["id"] in
                    os.path.basename(alert["flight_dump"])
                    and os.path.exists(alert["flight_dump"]),
                "trace dump with the alert id": bool(alert) and bool(
                    alert["trace_dump"]) and alert["id"] in
                    os.path.basename(alert["trace_dump"])
                    and os.path.exists(alert["trace_dump"]),
            }
            emit("obs", serve=name, part="forced_breach", turns=third,
                 tries=tries, breached=slo["breached"],
                 alerts_total=slo["alerts_total"],
                 alert=None if alert is None else dict(
                     id=alert["id"], breaches=alert["breaches"],
                     dominant=alert["dominant"], shares=shares,
                     explanation=alert["diagnosis"]["explanation"],
                     flight_dump=alert["flight_dump"],
                     trace_dump=alert["trace_dump"]),
                 flight_dir_files=dumps, card=card, checks=breach)
            bad = [k for k, ok in breach.items() if not ok]
            if bad:
                fail(f"obs {name} forced breach failed: {bad}")
            with env_scope(SWARMDB_SLO_TTFT_P95_S=None):
                db.sentinel.config.ttft_p95_s = SLOConfig().ttft_p95_s
            if not paged:
                return
            # the idle share split: one untraced turn's wall and phase
            # counters, then the same turn profiled (on this thread: the
            # profiler registers with the device here) for the device's
            # busy time; the streamed turns' replies are read first, so
            # each turn waits for its own
            await idle()
            for u in users:
                db.receive_messages(u, max_messages=10 ** 4, timeout=0.05)
            before = {k: c[f"phase_us_{k}"].value for k in phase}
            syncs0 = c["engine_host_syncs"].value
            t0 = time.perf_counter()
            for u in users:
                db.send_message(u, "assistant", OBS_LAST.format(u=u),
                                metadata={"generation": API_GEN})
            if len(await_replies(db, users)) < len(users):
                fail(f"obs {name}: the untraced turn lost a reply")
            wall_ms = (time.perf_counter() - t0) * 1e3
            await idle()
            split = {k: (c[f"phase_us_{k}"].value - before[k]) / 1e3
                     for k in phase}
            syncs = c["engine_host_syncs"].value - syncs0
            prof = profile_turn(db, users, OBS_LAST)
            emit("obs", serve=name, part="turn_split",
                 untraced_turn_wall_ms=wall_ms, phase_ms=split,
                 host_syncs=syncs,
                 profiled_turn_wall_ms=prof["wall_ms"],
                 device_busy_ms=prof["device_busy_ms"],
                 device_idle_share_vs_untraced=1.0
                 - prof["device_busy_ms"] / wall_ms,
                 note="queue_wait sums over the turn's requests; decode "
                      "holds the host's waits (host_sync)",
                 card=card)
            # the overhead A/B: one-wave turns of fresh users (no history)
            # with the observability on and off, alternating in the order
            # on-off, off-on, on-off (an order effect cancels)
            walls, turns_ab = {True: [], False: []}, []
            order = [(True, False), (False, True), (True, False)]
            for i, pair in enumerate(order[:OBS_AB_PAIRS]):
                for on in pair:
                    await idle()
                    _obs_set(db, on)
                    c0 = {k: c[k].value for k in (
                        "engine_admission_waves", "engine_decode_chunks",
                        "phase_us_queue_wait", "phase_us_prefill",
                        "phase_us_decode", "phase_us_host_sync")}
                    _, wall = await turn(
                        [f"ab{i}_{int(on)}_{j}" for j in range(OBS_USERS)],
                        USER_TEXT, one_wave=True)
                    walls[on].append(wall)
                    turns_ab.append(dict(on=on, wall_s=wall, **{
                        k: c[k].value - v for k, v in c0.items()}))
            _obs_set(db, True)
            on, off = (statistics.median(walls[True]),
                       statistics.median(walls[False]))
            pct = (on - off) / off * 100
            emit("obs", serve=name, part="overhead_ab",
                 turn_wall_s_on=walls[True], turn_wall_s_off=walls[False],
                 tracer_overhead_pct=pct,
                 spread_pct=[(max(walls[True]) - min(walls[False]))
                             / min(walls[False]) * 100,
                             (min(walls[True]) - max(walls[False]))
                             / max(walls[False]) * 100],
                 turns=turns_ab, budget_pct=5.0,
                 fail_above_pct=OBS_OVERHEAD_FAIL_PCT, card=card)
            if pct > OBS_OVERHEAD_FAIL_PCT:
                fail(f"obs {name}: tracer_overhead_pct {pct:.2f} above "
                     f"{OBS_OVERHEAD_FAIL_PCT}")
    finally:
        await runner.cleanup()


# ------------------------------------------------------------------- lanes


#: The lanes phase's group: ``build_serving_engine``'s lane defaults on
#: one card, two lanes of four slots sharing the serve phase's weights.
LANE_MODEL = "llama3-8b"
LANE_DEVICES = ("cuda:0", "cuda:0")
LANE_BATCH = 8
LANE_USERS = 8
LANE_NEW = 32
LANE_TRANSIT_MB = 1024


def lane_prompt(tok, i: int) -> list:
    """A ~400-token chat prompt that differs from every other from its
    first page on (no prefix-cache hit between them)."""
    return tok.encode(f"Message {i} from lane_user{i}. "
                      + USER_TEXT.format(u=f"lane_user{i}"))


def build_lanes(params, kind: str, metrics, fleet: bool = False):
    """A 2-lane Llama-3-8B group on ``LANE_DEVICES`` (pools of 512 pages
    of 16 per lane, the default rule), its graphs captured by
    ``warmup()``, and per-lane counters the engine does not keep apart
    (its metrics are the group's): ragged waves (calls of the lane's
    ragged forward) and waves admitted while the sibling decoded.
    ``fleet``: ``SWARMDB_FLEET=prefill:1,decode:1`` with a
    ``LANE_TRANSIT_MB`` transit store."""
    import torch

    from swarmdb_tpu_torch.parallel import build_serving_engine

    with env_scope(
            SWARMDB_FLEET="prefill:1,decode:1" if fleet else None,
            SWARMDB_FLEET_TRANSIT_MB=LANE_TRANSIT_MB if fleet else None,
            SWARMDB_FLEET_TIERS=None, SWARMDB_CHUNKED="1",
            SWARMDB_PAGED=None, SWARMDB_PREFIX_TOKENS=None,
            SWARMDB_EMIT_RING=None):
        g, info = build_serving_engine(
            LANE_MODEL, list(LANE_DEVICES), max_batch=LANE_BATCH,
            max_seq=1024, paged=True, page_size=16, decode_chunk=8,
            params=params, kv_dtype=getattr(torch, kind), metrics=metrics)
    if info.data_size != 2 or (g.fleet is not None) != fleet:
        fail(f"lanes: build gave {info.data_size} lanes, fleet "
             f"{g.fleet is not None}")
    waves = [0] * len(g.lanes)
    overlaps = [0] * len(g.lanes)
    for j, e in enumerate(g.lanes):
        fwd, probe = e.paged.prefill_ragged, e.overlap_probe

        def counted_fwd(*a, _f=fwd, _j=j):
            waves[_j] += 1
            return _f(*a)

        def counted_probe(_p=probe, _j=j):
            hit = _p()
            overlaps[_j] += bool(hit)
            return hit

        e.paged.prefill_ragged, e.overlap_probe = counted_fwd, counted_probe
    t0 = time.perf_counter()
    g.warmup()
    return g, waves, overlaps, time.perf_counter() - t0


def lane_custody(g) -> list:
    """Per lane, the engine idle: pages not free, in no slot and in no
    prefix-cache entry (0 when custody balances)."""
    out = []
    for e in g.lanes:
        alloc = e.paged.allocator
        held = sum(len(alloc.pages_for(s)) for s in range(e.max_batch))
        cached = e._prefix.stats()["cached_pages"]
        out.append(e.paged.num_pages - 1 - alloc.free_count() - held
                   - cached)
    return out


def lane_run(g, prompts, hints=None, on_token=None, timeout=300.0):
    """Submit greedy requests of ``LANE_NEW`` tokens through the group
    at once and wait: per request its tokens, reason, streamed tokens,
    logprobs and TTFT (first streamed token after submit)."""
    import threading

    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams

    n = len(prompts)
    done = [threading.Event() for _ in range(n)]
    outs = [{"streamed": []} for _ in range(n)]
    reqs = []
    for i, p in enumerate(prompts):
        def tok(rid, t, _o=outs[i], _i=i):
            if not _o["streamed"]:
                _o["ttft_s"] = time.perf_counter() - _o["t0"]
            _o["streamed"].append(t)
            if on_token is not None:
                on_token(_i, _o["streamed"])

        req = GenRequest(prompt=list(p), on_token=tok,
                         sampling=SamplingParams(max_new_tokens=LANE_NEW),
                         shard_hint=None if hints is None else hints[i])

        def fin(rid, toks, reason, _o=outs[i], _d=done[i], _r=req):
            # the finishing attempt's logprobs (a migration's replay, or
            # the fleet's two stages merged), read before any later
            # retirement of a killed attempt can overwrite them
            _o.update(toks=toks, reason=reason, logprobs=list(
                _r.metadata.get("logprobs") or []))
            _d.set()

        req.on_done = fin
        reqs.append(req)
    for o, r in zip(outs, reqs):
        o["t0"] = time.perf_counter()
        g.submit(r)
    for i, d in enumerate(done):
        if not d.wait(timeout):
            fail(f"lanes: request {i} never finished")
    return outs


def path_logprob_diffs(ref, got, start):
    """|logprob difference| of the chosen token at each step from
    ``start`` on while the two runs' tokens agree: ``ref`` and ``got`` are
    ``lane_run`` outputs; ``got``'s logprobs may cover only its last
    steps (a migration's replay)."""
    off = LANE_NEW - len(got["logprobs"])
    out = []
    for s in range(max(start, off), LANE_NEW):
        if ref["toks"][:s + 1] != got["toks"][:s + 1]:
            break
        out.append(abs(ref["logprobs"][s] - got["logprobs"][s - off]))
    return out


def first_step_logit_diff(eng, prompt) -> float:
    """Max |logit difference| of the two paths that decode the first
    token after ``prompt`` on lane ``eng`` (idle), over the same pages:
    the colocated decode's first step (the chunked paged forward, kernel 2
    over the pages and the chunk buffer) and the fleet's first stage-2
    step (the resume prefill, plain attention over the pages). The prompt's
    K/V comes from one kept admission of it (``keep_pages``); its pages are
    freed after. Kernel launches here are a measurement's, kept out of
    ``LAUNCHES``."""
    import threading

    import torch

    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams
    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    done, got = threading.Event(), {}
    eng.submit(GenRequest(
        prompt=list(prompt), sampling=SamplingParams(max_new_tokens=1),
        keep_pages=True,
        on_pages=lambda rid, pages, written, tail: got.update(
            pages=pages, written=written),
        on_done=lambda rid, toks, reason: (got.update(toks=toks),
                                           done.set())))
    if not done.wait(120) or "pages" not in got or not got["toks"]:
        fail(f"lanes: the kept admission for the logit check failed: {got}")
    cfg, dev = get_config(LANE_MODEL), eng.device
    pages, P = got["pages"], got["written"]
    i32 = dict(dtype=torch.int32, device=dev)
    tok = torch.tensor([[got["toks"][0]]], **i32)
    table = torch.zeros((1, eng.paged.allocator.maxp), **i32)
    table[0, :len(pages)] = torch.tensor(pages, **i32)
    ptab = torch.zeros((1, eng._pp_bucket_for(len(pages))), **i32)
    ptab[0, :len(pages)] = torch.tensor(pages, **i32)
    try:
        with ac.launches_into({}):
            a, _ = llama.forward_paged_chunked(
                eng.params, cfg, tok, torch.tensor([[P]], **i32),
                {"k": eng.cache["k"], "v": eng.cache["v"],
                 "page_table": table},
                llama.init_chunk_kv(cfg, 1, eng.decode_chunk, device=dev), 0)
            b, _, _ = llama.forward_prefix_pages(
                eng.params, cfg, tok, ptab, torch.tensor([P], **i32),
                eng.cache["k"], eng.cache["v"],
                logits_at=torch.zeros(1, dtype=torch.long, device=dev))
        return float((a[:, 0].float() - b.float()).abs().max())
    finally:
        eng.rolling_free(pages)


def first_parting(params, prompt, ref, got, tol):
    """Where ``got`` first parts from the greedy ``ref`` after ``prompt``:
    None when they are equal; else the step, the top-2 logit gap there
    (and the two parting tokens' gap) from a plain bf16 forward over the
    prompt and ``ref``'s tokens before the step, and whether the top-2 gap
    is below ``tol``, the difference this run measured between the two
    paths where they agree: then the parting is a near tie."""
    import torch

    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config

    i = next((k for k, (a, b) in enumerate(zip(ref, got)) if a != b), None)
    if i is None:
        return None
    cfg = get_config(LANE_MODEL)
    ctx = list(prompt) + list(ref[:i])
    T, dev = len(ctx), params["embed"].device
    logits, _ = llama.forward(
        params, cfg, torch.tensor([ctx], dtype=torch.int32, device=dev),
        torch.arange(T, dtype=torch.int32, device=dev)[None],
        llama.init_kv_cache(cfg, 1, T, device=dev),
        logits_at=torch.tensor([T - 1], device=dev))
    lg = logits[0].float()
    top2 = torch.topk(lg, 2).values
    pair = abs(float(lg[ref[i]] - lg[got[i]]))
    gap = float(top2[0] - top2[1])
    return dict(step=i, top2_gap=gap, pair_gap=pair, tol=tol,
                near_tie=gap < tol)


def profile_lanes_turn(db, users, text):
    """One more turn under ``torch.profiler`` (device only). Two lanes'
    kernels run on two streams and may overlap, so the device's busy time
    is the union of the kernels' intervals; the sum of their times is
    printed beside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for u in users:
            db.send_message(u, "assistant", text.format(u=u),
                            metadata={"generation": {
                                "max_new_tokens": LANE_NEW}})
        got = await_replies(db, users)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if len(got) < len(users):
        fail(f"lanes: profiled turn: {len(got)} of {len(users)} replies")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    union_us, cur = 0.0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                union_us += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        union_us += cur[1] - cur[0]
    sum_ms = sum(t for t in (
        (getattr(e, "self_device_time_total", 0)
         or getattr(e, "self_cuda_time_total", 0)) / 1e3
        for e in prof.key_averages()) if t > 0)
    if not spans:
        fail("lanes: the profiled turn shows no device interval")
    return dict(wall_ms=wall_ms, device_busy_union_ms=union_us / 1e3,
                device_kernel_sum_ms=sum_ms, kernel_intervals=len(spans))


def lanes_colocated(card, params, tok):
    """(1) the colocated group, supervised, through SwarmDB + LocalBroker
    + ServingService; then (2) chaos on the same group. Returns the group,
    its service and the bf16 reference of (3)."""
    import tempfile

    import torch

    from swarmdb_tpu_torch.backend.service import ServingService
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    torch.cuda.reset_peak_memory_stats()
    db = SwarmDB(broker=LocalBroker(),
                 save_dir=tempfile.mkdtemp(prefix="swarm_lanes_"))
    g, waves, overlaps, warm_s = build_lanes(params, "bfloat16", db.metrics)
    lanes_of = []   # (message id, lane) of every submission
    for j, e in enumerate(g.lanes):
        def recorded(r, _s=e.submit, _j=j):
            lanes_of.append((r.metadata.get("message_id"), _j))
            return _s(r)
        e.submit = recorded
    svc = ServingService(db, g, tok, backend_id="h100-lanes")
    if svc.supervisor is None or svc.supervisor is not g.supervisor:
        fail("lanes: the service did not attach the group's supervisor")
    users = [f"user{i}" for i in range(LANE_USERS)]
    for a in users + ["assistant"]:
        db.register_agent(a)
    db.assign_llm_backend("assistant", "h100-lanes")
    svc.start(warmup=False)   # warmup() ran in build_lanes
    c = db.metrics.counters
    replies = []
    t_serve = time.perf_counter()
    for turn, text in enumerate((USER_TEXT, FOLLOW_UP)):
        for u in users:
            db.send_message(u, "assistant", text.format(u=u),
                            metadata={"generation": {
                                "max_new_tokens": LANE_NEW}})
        got = await_replies(db, users)
        if len(got) < len(users):
            fail(f"lanes (1) turn {turn + 1}: {len(got)} of {len(users)} "
                 "replies")
        replies.extend(got.values())
    serve_s = time.perf_counter() - t_serve
    conv = {}
    for mid, lane in lanes_of:
        if mid is not None:
            conv.setdefault(db.get_message(mid).sender_id, set()).add(lane)
    fixed = lane_prompt(tok, 99)
    same = lane_run(g, [fixed, fixed], hints=[0, 1])
    reasons = [m.metadata.get("finish_reason") for m in replies]
    hits = [e._prefix.stats()["hit_tokens"] for e in g.lanes]
    checks = {
        "16 replies, length/eos": len(replies) == 2 * LANE_USERS
            and all(r in ("length", "eos") for r in reasons),
        "both lanes serve": all(e.total_requests > 0 for e in g.lanes),
        "each conversation on one lane": len(conv) == LANE_USERS
            and all(len(v) == 1 for v in conv.values()),
        "turn 2 reuses turn 1's pages on both lanes": all(h > 0
                                                          for h in hits),
        "lane 0 and lane 1 give equal greedy tokens": same[0]["toks"]
            == same[1]["toks"] and same[0]["reason"] == "length",
        "decode through graph replays on both lanes": all(
            e._runner.chunks > 0 and e._runner.graphs for e in g.lanes),
        "flight steps carry shard 0 and 1": {0, 1} <= {
            st.get("shard") for st in g.flight.steps()},
        "group.sentinel is the runtime's on every lane": g.sentinel
            is db.sentinel and all(e.sentinel is db.sentinel
                                   for e in g.lanes),
    }
    ttft = sorted(db.metrics.latencies["send_to_first_token_s"].values())
    gen_tok = c["tokens_generated"].value
    rec = dict(
        part="colocated", model=LANE_MODEL, lanes=len(g.lanes),
        devices=list(LANE_DEVICES), slots_per_lane=g.lanes[0].max_batch,
        pages_per_lane=[e.paged.num_pages for e in g.lanes],
        warmup_s=warm_s, users=LANE_USERS, turns=2, replies=len(replies),
        finish_reasons=sorted(set(reasons)),
        lane_of_conversation={u: sorted(v)[0] for u, v in conv.items()},
        per_lane=[dict(requests=e.total_requests, ragged_waves=waves[j],
                       decode_chunks=e._runner.chunks,
                       overlap_waves=overlaps[j],
                       prefix_hit_tokens=hits[j])
                  for j, e in enumerate(g.lanes)],
        engine_admission_overlap_steps=c[
            "engine_admission_overlap_steps"].value,
        ttft_p50_s=statistics.median(ttft), ttft_max_s=ttft[-1],
        decode_tokens_per_s_wall=gen_tok / serve_s,
        decode_tokens_per_s_chunks=(
            gen_tok / (c["phase_us_decode"].value / 1e6)
            if c["phase_us_decode"].value else None),
        serve_wall_s=serve_s,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        card=card, checks=checks)
    emit("lanes", **rec)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"lanes (1) checks failed: {bad}")
    prof = profile_lanes_turn(db, users, FOLLOW_UP)
    prof["untraced_turn_wall_ms"] = serve_s / 2 * 1e3
    prof["device_idle_share_vs_untraced"] = 1.0 - prof[
        "device_busy_union_ms"] / prof["untraced_turn_wall_ms"]
    emit("lanes", part="profile", card=card, **prof)
    lanes_chaos(card, params, tok, g, svc)
    return g, svc, db


def lanes_chaos(card, params, tok, g, svc):
    """(2) four greedy streams hinted to lane 1, lane 1 killed mid-stream:
    the requests migrate to lane 0 and end "length" with the undisturbed
    run's tokens (or part at a checked near tie), lane 1 is restarted,
    probed and re-admitted, and custody balances on both lanes."""
    from swarmdb_tpu_torch.backend.chaos import ServingChaos, wait_until

    sup = svc.supervisor
    sup.poll_s = 0.1
    prompts = [lane_prompt(tok, 10 + i) for i in range(4)]
    ref = lane_run(g, prompts, hints=[1] * 4)
    st0 = sup.status()
    c = g.metrics.counters
    migrated0 = c["requests_migrated"].value
    chaos = ServingChaos(g)
    killed = []

    def kill_at_8(i, streamed):
        if len(streamed) == 8 and not killed:
            killed.append(time.perf_counter())
            chaos.kill_lane(1)

    try:
        got = lane_run(g, prompts, hints=[1] * 4, on_token=kill_at_8)
        t_done = time.perf_counter()
        wait_until(lambda: sup.status()["lanes"][1]["state"] == "alive",
                   120.0, what="lane 1 re-admitted")
        readmit_s = time.perf_counter() - killed[0] if killed else None
    finally:
        chaos.stop()
    st = sup.status()
    moves = [e for e in g.flight.events()
             if e.get("kind") == "request.migrated"]
    # a replay re-prefills on lane 0 what the undisturbed run decoded: the
    # chosen tokens' logprob differences where the runs agree measure the
    # two paths' rounding
    diffs = [path_logprob_diffs(r, o, 0) for r, o in zip(ref, got)]
    wait_until(lambda: all(not any(s.active for s in e.slots)
                           for e in g.lanes), 60.0, what="idle lanes")
    logit_diff = max(first_step_logit_diff(g.lanes[0], p)
                     for p in prompts[:2])
    tol = max([logit_diff] + [d for ds in diffs for d in ds])
    partings = [first_parting(params, p, r["toks"], o["toks"], tol)
                for p, r, o in zip(prompts, ref, got)]
    custody = lane_custody(g)
    checks = {
        "killed mid-stream": bool(killed),
        "4 replies length, 32 tokens, stream == reply": all(
            o["reason"] == "length" and len(o["toks"]) == LANE_NEW
            and o["streamed"] == o["toks"] for o in got),
        "migrated to lane 0": c["requests_migrated"].value > migrated0
            and all(m["to_lane"] == 0 for m in moves[-4:]),
        "tokens equal the undisturbed run's, or part at a near tie": all(
            p is None or p["near_tie"] for p in partings),
        "lane 1 restarted, probed, re-admitted":
            st["lanes"][1]["restarts"] > st0["lanes"][1]["restarts"]
            and st["lane_readmissions"] > st0["lane_readmissions"]
            and st["lanes"][1]["state"] == "alive",
        "custody balances on both lanes": custody == [0, 0],
    }
    emit("lanes", part="chaos", card=card,
         requests_migrated=c["requests_migrated"].value - migrated0,
         migrations=[(m["from_lane"], m["to_lane"], m["emitted"])
                     for m in moves[-4:]],
         equal_to_undisturbed=[o["toks"] == r["toks"]
                               for r, o in zip(ref, got)],
         first_step_max_logit_diff=logit_diff,
         replay_logprob_diff_max=[max(d, default=None) for d in diffs],
         replay_first_token_logprob_diff=[d[0] if d else None
                                          for d in diffs],
         partings=partings,
         lane_states=[lane["state"] for lane in st["lanes"]],
         restarts=[lane["restarts"] for lane in st["lanes"]],
         readmissions=st["lane_readmissions"],
         kill_to_readmitted_s=readmit_s,
         kill_to_last_reply_s=(t_done - killed[0]) if killed else None,
         custody=custody, checks=checks)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"lanes (2) checks failed: {bad}")


def lanes_fleet(card, params, tok, kind, colo):
    """(3) ``SWARMDB_FLEET=prefill:1,decode:1`` over ``kind`` pools: 8
    greedy requests handed off prefill lane -> pinned transit store ->
    decode lane, against ``colo`` (the colocated group of the same pool
    kind) on the same prompts."""
    import gc

    import torch

    from swarmdb_tpu_torch.ops.paged_kv import (pool_gather_pages,
                                                pool_insert_raw)
    from swarmdb_tpu_torch.utils.metrics import MetricsRegistry

    prompts = [lane_prompt(tok, 20 + i) for i in range(8)]
    ref = lane_run(colo, prompts, hints=[i % 2 for i in range(8)])
    pinned_before = host_pinned_bytes()
    metrics = MetricsRegistry()
    f, waves, _, warm_s = build_lanes(params, kind, metrics, fleet=True)
    f.start()
    try:
        got = lane_run(f, prompts)
        wait_until_idle(f)
        waves = list(waves)   # the run's, before the measurements below
        chunks = [e._runner.chunks for e in f.lanes]
        fst = f.fleet.stats()
        pinned_after = host_pinned_bytes()
        custody = lane_custody(f)
        pre, dec = f.lanes
        # the two paths' difference where they agree, from the first
        # stage-2 step on (the decode lane's resume prefill of the first
        # token, against the colocated lane's first decode step)
        diffs = [path_logprob_diffs(r, o, 1) for r, o in zip(ref, got)]
        logit_diff = max(first_step_logit_diff(dec, p) for p in prompts[:2])
        tol = max([logit_diff] + [d for ds in diffs for d in ds])
        partings = [first_parting(params, p, r["toks"], o["toks"], tol)
                    for p, r, o in zip(prompts, ref, got)]
        lat = sorted(metrics.latencies["fleet_handoff_s"].values())
        # the decode lane's promote insert alone: a payload of the first
        # prompt's pages, copied from page-locked memory into reserved
        # pages and synchronized (the lanes are idle)
        n_pages = -(-len(prompts[0]) // dec.paged.page_size)
        src = dec.paged.allocator.reserve(n_pages)
        pinned = lambda shape, dt: torch.empty(
            shape, dtype=dt, pin_memory=dec.device.type == "cuda")
        payload = [pool_gather_pages(dec.cache[n], src, pinned)
                   for n in ("k", "v")]
        ids = torch.tensor(src, device=pre.device)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for n, pay in zip(("k", "v"), payload):
            pool_insert_raw(dec.cache[n], ids, pay)
        ev[1].record()
        ev[1].synchronize()
        dec.paged.allocator.add_free(src)
        insert_ms_page = ev[0].elapsed_time(ev[1]) / n_pages
        checks = {
            "8 handoffs, no fallback": fst["handoffs"] == 8
                and fst["handoff_fallbacks"] == 0,
            "8 replies length, 32 tokens, stream == reply": all(
                o["reason"] == "length" and len(o["toks"]) == LANE_NEW
                and o["streamed"] == o["toks"] for o in got),
            "the prefill lane ran no decode chunk": chunks[0] == 0
                and not pre._runner.graphs,
            "the decode lane ran no ragged wave": waves[1] == 0
                and waves[0] > 0,
            "tokens equal colocated, or part at a near tie": all(
                p is None or p["near_tie"] for p in partings),
            "custody balances, transit store empty": custody == [0, 0]
                and fst["transit_store"]["entries"] == 0
                and fst["in_flight"] == 0,
        }
        emit("lanes", part=f"fleet_{kind}", card=card, warmup_s=warm_s,
             handoffs=fst["handoffs"], fallbacks=fst["handoff_fallbacks"],
             handoff_ms_p50=1e3 * statistics.median(lat) if lat else None,
             handoff_ms_max=1e3 * lat[-1] if lat else None,
             gather_ms_per_page=fst["gather_ms_per_page"],
             insert_ms_per_page=insert_ms_page, insert_pages=n_pages,
             transit_store=fst["transit_store"],
             transit_slab=fst["transit_slab"],
             pinned_bytes_before=pinned_before,
             pinned_bytes_after=pinned_after,
             prefill_lane=dict(ragged_waves=waves[0],
                               decode_chunks=chunks[0]),
             decode_lane=dict(ragged_waves=waves[1],
                              decode_chunks=chunks[1],
                              promote_inserts=metrics.counters[
                                  "engine_tier_promote_inserts"].value),
             ttft_staged=_summary([o["ttft_s"] for o in got]),
             ttft_colocated=_summary([r["ttft_s"] for r in ref]),
             equal_to_colocated=[o["toks"] == r["toks"]
                                 for r, o in zip(ref, got)],
             first_stage2_max_logit_diff=logit_diff,
             first_stage2_logprob_diff=[d[0] if d else None
                                        for d in diffs],
             path_logprob_diff_max=[max(d, default=None) for d in diffs],
             partings=partings,
             custody=custody, checks=checks)
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"lanes (3) fleet {kind} checks failed: {bad}")
    finally:
        f.stop()
        del f
        gc.collect()


def wait_until_idle(g, timeout=60.0):
    from swarmdb_tpu_torch.backend.chaos import wait_until

    wait_until(lambda: all(not any(s.active for s in e.slots)
                           for e in g.lanes), timeout, what="idle lanes")


def run_lanes(card, params):
    """The lanes phase (Llama-3-8B at full width on the serve phase's
    weights): (1) the colocated group through the service, profiled; (2)
    a lane killed mid-stream; (3) the fleet over bf16 and int8 pools.
    Returns the phase's launches."""
    import gc

    import torch

    from swarmdb_tpu_torch.backend.tokenizer import default_tokenizer
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.ops import attention_cuda as ac
    from swarmdb_tpu_torch.utils.metrics import MetricsRegistry

    tok = default_tokenizer(get_config(LANE_MODEL).vocab_size)
    t0 = time.perf_counter()
    ac.reset_launches()
    g, svc, db = lanes_colocated(card, params, tok)
    try:
        lanes_fleet(card, params, tok, "bfloat16", g)
    finally:
        svc.stop()
        db.close()
        del svc, g
        gc.collect()
    colo8, _, _, _ = build_lanes(params, "int8", MetricsRegistry())
    colo8.start()
    try:
        lanes_fleet(card, params, tok, "int8", colo8)
    finally:
        colo8.stop()
        del colo8
        gc.collect()
    launches = dict(ac.LAUNCHES)
    torch.cuda.empty_cache()
    emit("lanes", part="done", seconds=time.perf_counter() - t0,
         launches={k: n for k, n in launches.items() if n}, card=card)
    return launches


# ----------------------------------------------------------------- mixtral


#: Mixtral-8x7B at full width, 16 of its 32 layers: all 32 (~87 GiB of
#: bf16 layers by their shapes) do not fit one 80 GB card (ROADMAP.md
#: queue 1 item 11).
MIXTRAL_LAYERS = 16

#: (name, cache dtype, chunked, turns, paged, profiled): the six Mixtral
#: serves, in order. ``paged=None`` builds the default (dense) engine.
MIXTRAL_SERVES = (
    ("dense_chunked", "bfloat16", True, 3, None, True),
    ("dense_single_step", "bfloat16", False, 1, None, False),
    ("paged_bf16_chunked", "bfloat16", True, 3, True, True),
    ("paged_int8_chunked", "int8", True, 3, True, False),
    ("paged_bf16_single_step", "bfloat16", False, 1, True, False),
    ("paged_int8_single_step", "int8", False, 1, True, False),
    # SWARMDB_ROLLING_KV=1: each turn prefills only its delta on top of
    # the conversation's kept pages (printed beside the serve above)
    ("paged_bf16_chunked_rolling", "bfloat16", True, 3, True, False))


def send_tool_call(db, user, turn, i, **gen):
    """One ``function_call`` message of the tool-use workload (the payload
    shape of ``bench.py``'s tool-use mode) to the assistant."""
    from swarmdb_tpu_torch.core.messages import MessageType

    k = turn * 4 + i
    db.send_message(
        user, "assistant",
        {"name": "lookup_weather",
         "arguments": {"city": f"city_{k % 7}", "unit": "C"}},
        message_type=MessageType.FUNCTION_CALL,
        metadata={"generation": {"max_new_tokens": 32, **gen}})


def free_weights(params) -> None:
    """Release a weight tree's device memory now: every tensor's storage
    shrinks to nothing, whoever still holds the tensors (the stopped
    engines of earlier phases may), then the allocator's cache is
    emptied. Emits the device memory still allocated."""
    import gc

    import torch

    before = torch.cuda.memory_allocated()
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            node.untyped_storage().resize_(0)
    gc.collect()
    torch.cuda.empty_cache()
    emit("mixtral", step="free_llama_weights",
         allocated_gib_before=before / 2**30,
         allocated_gib_after=torch.cuda.memory_allocated() / 2**30)


def run_mixtral(card: str):
    """The mixtral phase: Mixtral-8x7B (``MIXTRAL_LAYERS`` layers, bf16
    weights from seed 0, built once) served six times through SwarmDB +
    ServingService on ``function_call`` messages. Returns the launches
    summed over the serves."""
    import gc

    import torch

    from swarmdb_tpu_torch.models import mixtral
    from swarmdb_tpu_torch.models.configs import get_config

    dev = torch.device("cuda", 0)
    full = get_config("mixtral-8x7b")
    cfg = get_config("mixtral-8x7b", n_layers=MIXTRAL_LAYERS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = mixtral.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    layer_bytes = sum(_nbytes(t) for t in params["layers"].values())
    weights_gib = (layer_bytes + _nbytes(params["embed"])
                   + _nbytes(params["lm_head"])
                   + _nbytes(params["final_norm"])) / 2**30
    emit("mixtral", step="weights", model=full.name, layers=cfg.n_layers,
         reduced=f"depth {cfg.n_layers} of {full.n_layers} layers",
         full_depth_layer_gib=layer_bytes / cfg.n_layers * full.n_layers
         / 2**30,
         dim=cfg.dim, heads=[cfg.n_heads, cfg.n_kv_heads],
         experts=[cfg.n_experts, cfg.experts_per_token],
         ffn=cfg.ffn_dim, vocab=cfg.vocab_size, rope_theta=cfg.rope_theta,
         weights_gib=weights_gib, weight_init_s=init_s, card=card)
    expert_gemms = moe_layer_breakdown(params, cfg, card)
    total = {}
    try:
        for spec in MIXTRAL_SERVES:
            launches = run_moe_serve(card, cfg, params, weights_gib,
                                     expert_gemms, *spec)
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
        emit("mixtral", step="rolling_vs_plain",
             prefill_tokens_per_turn={
                 k: MOE_PREFILL_PER_TURN[k] for k in (
                     "paged_bf16_chunked", "paged_bf16_chunked_rolling")})
        run_decode_loop(card, cfg, params, LOOP_MIXTRAL)
    finally:
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return total


#: serve name -> tokens prefilled per turn (all users), by run_moe_serve
MOE_PREFILL_PER_TURN: dict = {}


def run_moe_serve(card, cfg, params, weights_gib, expert_gemms, name, kind,
                  chunked, turns, paged, profiled):
    """One Mixtral serve of ``MIXTRAL_SERVES`` (a name ending in
    "_rolling" turns on ``SWARMDB_ROLLING_KV``). Records the tokens each
    turn prefilled (prompt tokens less the reused ones) in
    ``MOE_PREFILL_PER_TURN``."""
    import gc
    import tempfile

    import torch

    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.messages import MessageType
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.ops import attention_cuda as ac
    from swarmdb_tpu_torch.ops.paged_kv import (is_quantized, pool_data,
                                                pool_page_bytes)

    quant = kind == "int8"
    decode_k = path_kernels(kind, chunked, bool(paged), ragged=False)[-1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    db = SwarmDB(broker=LocalBroker(),
                 save_dir=tempfile.mkdtemp(prefix="swarm_moe_"))
    backend = "h100-0"
    rolling = name.endswith("_rolling")
    with engine_env(chunked, SWARMDB_ROLLING_KV="1" if rolling else "0"):
        eng, tok = build_backend_engine(
            cfg, seed=0, device="cuda", params=params, paged=paged,
            kv_dtype=getattr(torch, kind) if paged else None,
            metrics=db.metrics)
        svc = ServingService(db, eng, tok, backend_id=backend)
    if rolling != (svc._rolling is not None):
        fail(f"mixtral {name}: rolling KV {'off' if rolling else 'on'}")
    users = [f"user{i}" for i in range(4)]
    try:
        for a in users + ["assistant"]:
            db.register_agent(a)
        db.assign_llm_backend("assistant", backend)
        t_start = time.perf_counter()
        svc.start(warmup=True)   # SWARMDB_PREWARM's path: graphs first
        start_s = time.perf_counter() - t_start
        c = db.metrics.counters
        keys = ("prefill_waves", "engine_decode_chunks", "tokens_generated",
                "phase_us_decode", "prompt_tokens", "engine_admitted")
        base = {k: c[k].value for k in keys}
        ac.reset_launches()
        replies = []
        per_turn = []
        t_serve = time.perf_counter()
        for turn in range(turns):
            seen = (c["prompt_tokens"].value
                    - eng.metrics.counters["prefix_reused_tokens"].value)
            for i, u in enumerate(users):
                gen = ({"temperature": 0.8, "top_p": 0.9, "seed": 7}
                       if turn == 0 and i == 3 and not rolling else {})
                send_tool_call(db, u, turn, i, **gen)
            got = await_replies(db, users)
            if len(got) < len(users):
                fail(f"mixtral {name} turn {turn + 1}: {len(got)} of "
                     f"{len(users)} replies")
            replies.extend(got.values())
            per_turn.append(c["prompt_tokens"].value
                            - eng.metrics.counters[
                                "prefix_reused_tokens"].value - seen)
        MOE_PREFILL_PER_TURN[name] = per_turn
        serve_s = time.perf_counter() - t_serve
        launches = dict(ac.LAUNCHES)
        loop = eng.stats()["decode_chunks"]
        d = {k: c[k].value - base[k] for k in keys}
        steps = d["engine_decode_chunks"] * eng.decode_chunk
        L = cfg.n_layers
        reasons = [m.metadata.get("finish_reason") for m in replies]
        reused = eng.metrics.counters["prefix_reused_tokens"].value
        checks = {
            f"{len(users) * turns} function_result replies, length/eos":
                len(replies) == len(users) * turns
                and all(r in ("length", "eos") for r in reasons)
                and all(m.type == MessageType.FUNCTION_RESULT
                        for m in replies),
            "prefix reuse by the last turn": turns < 3 or reused > 0,
            f"{decode_k} launches == {L} per decode step":
                steps > 0 and launches[decode_k] == L * steps,
            "no ragged prefill (row-bucketed waves)": not any(
                launches[k] for k in ("ragged_prefill",
                                      "ragged_prefill_quant")),
            "only the decode kernel": all(
                n == 0 for k, n in launches.items() if k != decode_k),
            "decode through CUDA graph replays": loop["chunks"] > 0
                and bool(loop["graphs"]),
            "params on cuda": eng.params["layers"]["w_gate"].is_cuda,
        }
        if paged:
            checks.update({
                "paged without a ragged forward":
                    eng.paged.prefill_ragged is None and not eng._ragged,
                "pool kind": is_quantized(eng.cache["k"]) == quant,
                "pool on cuda": pool_data(eng.cache["k"]).is_cuda})
        else:
            checks["the default builds the dense engine, bf16 on cuda"] = (
                eng.paged is None and d["prefill_waves"] > 0 and all(
                    t.is_cuda and t.dtype == torch.bfloat16
                    for t in (*eng.cache, *eng._prefix_pool)))
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"mixtral {name} checks failed: {bad}; reasons={reasons} "
                 f"reused={reused} waves={d['prefill_waves']} "
                 f"steps={steps} launches={launches}")
        ttft = sorted(db.metrics.latencies["send_to_first_token_s"].values())
        dec_s = d["phase_us_decode"] / 1e6
        if paged:
            kv_tok = pool_page_bytes(eng.cache["k"]) * 2 // eng.paged.page_size
            cache_gib = (2 * pool_page_bytes(eng.cache["k"])
                         * eng.paged.num_pages / 2**30)
        else:
            ck = eng.cache[0]
            kv_tok = 2 * ck[:, 0, 0].numel() * ck.element_size()
            cache_gib = sum(map(_nbytes, (*eng.cache, *eng._prefix_pool))
                            ) / 2**30
        # a decode step reads every layer's weights (each expert computes
        # its queue) and the head, plus each live slot's KV
        mean_ctx = d["prompt_tokens"] / max(1, d["engine_admitted"]) + 16
        step_bytes = (sum(_nbytes(t) for t in eng.params["layers"].values())
                      + _nbytes(eng.params["lm_head"])
                      + len(users) * mean_ctx * kv_tok)
        record = dict(
            serve=name, model=cfg.name, layers=L, weights="bfloat16",
            engine="paged" if paged else "dense (default)", cache=kind,
            chunked=chunked, turns=turns, replies=len(replies),
            reply_type="function_result", finish_reasons=reasons,
            prefix_reused_tokens=reused, prefill_waves=d["prefill_waves"],
            prefill_tokens_per_turn=per_turn,
            rolling_resumes=c["rolling_resumes"].value,
            decode_steps=steps, launches={k: n for k, n in launches.items()
                                          if n},
            ttft_p50_s=statistics.median(ttft), ttft_max_s=ttft[-1],
            decode_tokens_per_s=(d["tokens_generated"] / dec_s
                                 if dec_s else None),
            generated_tokens=d["tokens_generated"], serve_wall_s=serve_s,
            weights_gib=weights_gib, kv_bytes_per_token=kv_tok,
            cache_gib=cache_gib, mean_prompt_tokens=mean_ctx - 16,
            decode_step_wall_ms=dec_s * 1e3 / steps if steps else None,
            decode_step_bytes=step_bytes,
            decode_step_byte_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
            card=card, max_step_s=eng.max_step_s, **loop_record(eng),
            start_with_warmup_s=start_s, eager_loop_step_ms=MIXTRAL_STEP_EAGER_MS,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        if profiled:
            prof = profile_moe_turn(
                db, users, lambda u, i: send_tool_call(db, u, turns, i),
                decode_k, expert_gemms)
            prof["untraced_turn_wall_ms"] = serve_s / turns * 1e3
            prof["device_idle_share_vs_untraced"] = 1.0 - prof[
                "device_busy_ms"] / prof["untraced_turn_wall_ms"]
            emit("profile", serve=f"mixtral_{name}", **prof)
            if not prof["decode_kernel_ms"] > 0:
                fail(f"mixtral {name}: no device time under the decode "
                     f"kernel {decode_k} in the profiled turn")
        record["decode_step_ms"] = time_moe_step(eng, len(users))
        emit("mixtral", step="serve", **record)
        return launches
    finally:
        svc.stop()
        db.close()
        del svc, eng
        gc.collect()
        torch.cuda.empty_cache()


def time_moe_step(eng, live: int, ctx: int = 300) -> float:
    """Median ms (CUDA events, 5 eager calls after 2) of one decode step of
    the serve's own forward over its cache, the engine idle: ``live``
    slots at position ``ctx``, the rest at 0, as the engine feeds idle
    slots. Run after the serve (it writes garbage K/V)."""
    import torch

    B = eng.max_batch
    pos = torch.zeros((B, 1), dtype=torch.int32, device=eng.device)
    pos[:live] = ctx
    tok = torch.zeros((B, 1), dtype=torch.int32, device=eng.device)
    if eng._chunked_fns is not None:
        fwd = eng._chunked_fns[0]
        step = lambda: fwd(eng.params, tok, pos, eng.cache, eng._chunk_kv, 0)
    else:
        step = lambda: eng._decode_forward(eng.params, tok, pos, eng.cache)
    with torch.no_grad():
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        return _median_events(step, 5)


def profile_moe_turn(db, users, send, decode_k, expert_gemms):
    """One more turn under ``torch.profiler`` (device only; the engine's
    host ops run on its own thread, which the profiler does not follow):
    device time by kernel and summed by kind -- the GEMMs (attention
    projections, the head and the expert products), among them the
    kernels named ``expert_gemms`` (the GEMM kernels the expert products
    launched in ``moe_layer_breakdown``; by name, so a projection that
    picks one of them counts too), the indexing kernels (the MoE scatter
    and gather, cache and page writes), the router's top-k and scan, the
    decode attention kernel -- and the device's idle share of the turn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i, u in enumerate(users):
            send(u, i)
        got = await_replies(db, users)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if len(got) < len(users):
        fail(f"mixtral profiled turn: {len(got)} of {len(users)} replies")
    kernels = _kernel_times(prof)
    busy_ms = sum(k[1] for k in kernels)

    def of(pats):
        return sum(t for n, t, _ in kernels if any(p in n for p in pats))

    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "gemm_ms": of(GEMM_NAMES),
        "expert_gemm_ms": sum(t for n, t, _ in kernels if n in expert_gemms),
        "indexing_ms": of(INDEX_NAMES), "routing_ms": of(ROUTE_NAMES),
        "decode_kernel": decode_k,
        "decode_kernel_ms": of(DECODE_BODIES[decode_k.replace("_quant",
                                                              "")]),
        "top": [{"kernel": n[:90], "ms": t, "calls": c}
                for n, t, c in kernels[:12]],
    }


#: Kernel-name fragments of the GEMMs (cuBLAS's nvjet / xmma, CUTLASS),
#: of the indexing kernels (index_put / index_add / gather: the MoE
#: dispatch and combine, and cache and page writes) and of the router's
#: top-k and queue-position scan.
GEMM_NAMES = ("gemm", "Gemm", "xmma", "cutlass", "nvjet")
INDEX_NAMES = ("index", "Index", "scatter", "gather")
ROUTE_NAMES = ("scan", "TopK", "topk", "Sort", "sort")


def _kernel_times(prof):
    """[(kernel name, device ms, calls)] of a profile, longest first."""
    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    out = [(e.key, dev_us(e) / 1e3, e.count) for e in prof.key_averages()
           if dev_us(e) > 0]
    return sorted(out, key=lambda k: -k[1])


def moe_layer_breakdown(params, cfg, card):
    """Layer 0's MoE block on the card at the serves' two shapes -- a
    decode step of 8 slots and an 8-row prefill wave of 256 -- timed whole
    and its expert products alone (CUDA events, eager, median of 20), each
    beside its bound, with the kernels each launches named (one profiled
    call): the expert GEMMs, and the routing, scatter and gather ops.
    Returns the names of the GEMM kernels the expert products launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from swarmdb_tpu_torch.models import mixtral

    lp = params["layers"]
    w = [lp[k][0] for k in ("router", "w_gate", "w_up", "w_down")]
    E, D, Fd, k = cfg.n_experts, cfg.dim, cfg.ffn_dim, cfg.experts_per_token
    g = torch.Generator(device="cuda").manual_seed(5)
    out, gemms = {}, set()
    for shape, (B, T) in (("decode_8", (8, 1)), ("prefill_8x256", (8, 256))):
        x = torch.randn((B, T, D), generator=g, device="cuda").bfloat16()
        C = max(1, int(B * T * k * mixtral.DEFAULT_CAPACITY_FACTOR / E))
        xe = torch.randn((E, C, D), generator=g, device="cuda").bfloat16()
        block = lambda: mixtral.moe_block(x, *w, top_k=k)
        experts = lambda: mixtral._experts(xe, *w[1:])
        names = {}
        for part, fn in (("block", block), ("experts", experts)):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            times = _kernel_times(prof)
            names[part] = [{"kernel": n[:90], "ms": t, "calls": c}
                           for n, t, c in times]
            if part == "experts":
                gemms.update(n for n, _, _ in times
                             if any(p in n for p in GEMM_NAMES))
        exp_bytes = 3 * E * D * Fd * 2 + 2 * E * C * D * 2
        exp_flops = 3 * 2 * E * C * D * Fd
        block_ms = time_events(block, iters=20)
        experts_ms = time_events(experts, iters=20)
        b_ms, b_by = bound(exp_bytes, exp_flops)
        out[shape] = dict(
            tokens=B * T, capacity=C, block_ms=block_ms,
            experts_ms=experts_ms,
            route_dispatch_combine_ms=block_ms - experts_ms,
            experts_bound_ms=b_ms, experts_bound_by=b_by,
            block_kernels=names["block"], expert_kernels=names["experts"])
    emit("mixtral", step="moe_layer", card=card, **out)
    return gemms


# -------------------------------------------------------------------- main


def ptxas_summary(log: str) -> list:
    """One line per kernel entry of an ``nvcc -Xptxas -v`` log: the
    entry's mangled name without the ``swarm`` namespace and argument
    list, its registers and its spill bytes (stores / loads)."""
    import re

    out, name, spills = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN5swarm\d+(\w+?EE)v", ln)
        if m:
            name = m.group(1).rstrip("E")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spills = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, spills {spills}")
            name = None
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    if not (ROOT / "swarmdb_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository (no "
              "swarmdb_tpu_torch/ next to it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from swarmdb_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        smi = []
    card = smi[0] if smi else "nvidia-smi gave no answer"
    print(card, flush=True)
    emit("device", name=name, nvidia_smi=card,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    logs = build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: ptxas_summary(v) for k, v in logs.items()})

    with torch.no_grad():
        rows = run_kernels(dev)
        run_parity(dev)
        launches, params = run_serves(card)
        for k, n in run_api(card, params).items():
            launches[k] = launches.get(k, 0) + n
        for k, n in run_obs(card, params).items():
            launches[k] = launches.get(k, 0) + n
        run_decode_loop(card, "llama3-8b", params, LOOP_LLAMA)
        for k, n in run_rolling(card, params).items():
            launches[k] = launches.get(k, 0) + n
        for k, n in run_lanes(card, params).items():
            launches[k] = launches.get(k, 0) + n
        free_weights(params)   # Llama-3-8B's weights go before Mixtral's
        del params
        for k, n in run_mixtral(card).items():
            launches[k] = launches.get(k, 0) + n
    for k, n in launches.items():
        rows[k]["launches"] = n
    idle = [k for k, row in rows.items() if not row["launches"]]
    if idle:
        fail(f"kernels never launched by the serves: {idle}")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
