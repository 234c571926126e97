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
               and the decode steps within 1e-4.
5. serve    -- Llama-3-8B at full width (32 layers, bf16 weights from seed
               0, built once) through SwarmDB + LocalBroker +
               ServingService, six times: the paged engine (``paged=True``)
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
               attention is plain PyTorch, as in the JAX package) and per
               decode step; prints TTFT, decode tokens/s, KV bytes per
               token, the cache's (and side pool's) size and peak device
               memory per serve. Each serve then runs one more turn under
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
               ``SERVE_MODEL=tiny-debug`` as a subprocess: ``/health`` must
               name the card and one message is answered, then SIGTERM.
               Kernels 7 (dense chunked decode), 1 and 2 must launch in
               the phase (its in-process steps; the subprocess's launches
               are its own).

7. mixtral -- Mixtral-8x7B at full width (dim 4096, 32 / 8 heads of 128,
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
               indexing, the decode kernel, idle share).

Then one ``{"kernels": [...]}`` line (launches summed over the six Llama
serves, the api phase and the six Mixtral serves, each counted from zero
just before it and read just after) and, last,
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
def engine_env(chunked: bool):
    """SWARMDB_CHUNKED set, and SWARMDB_PAGED unset, while an engine is
    built (both are read there)."""
    old = {k: os.environ.get(k) for k in ("SWARMDB_CHUNKED", "SWARMDB_PAGED")}
    os.environ["SWARMDB_CHUNKED"] = "1" if chunked else "0"
    os.environ.pop("SWARMDB_PAGED", None)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
        svc.start()
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
                chunks > 0 and launches[decode_k] >= L * steps,
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
        wait_until(lambda: svc.supervisor.status()["state"]
                   == "alive", 120.0, what="the engine re-admitted")
        after = svc.supervisor.status()
        emit("api", step="d_kill_replay", killed=bool(killed),
             reason=reason, tokens=len(toks),
             streamed_equals_final=streamed == toks, seconds=took,
             requests_retried=st["requests_retried"],
             requests_migrated=st["requests_migrated"],
             restarts=after["restarts"],
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
               PYTHONPATH=str(ROOT))
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
             token_events=sum(e == "token" for e, _ in events))
        if torch.cuda.get_device_name(0) not in device or not reply:
            fail(f"api (e): /health device {device!r}, reply {reply}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


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
    ("paged_int8_single_step", "int8", False, 1, True, False))


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
    finally:
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return total


def run_moe_serve(card, cfg, params, weights_gib, expert_gemms, name, kind,
                  chunked, turns, paged, profiled):
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
    with engine_env(chunked):
        eng, tok = build_backend_engine(
            cfg, seed=0, device="cuda", params=params, paged=paged,
            kv_dtype=getattr(torch, kind) if paged else None,
            metrics=db.metrics)
    svc = ServingService(db, eng, tok, backend_id=backend)
    users = [f"user{i}" for i in range(4)]
    try:
        for a in users + ["assistant"]:
            db.register_agent(a)
        db.assign_llm_backend("assistant", backend)
        svc.start()
        c = db.metrics.counters
        keys = ("prefill_waves", "engine_decode_chunks", "tokens_generated",
                "phase_us_decode", "prompt_tokens", "engine_admitted")
        base = {k: c[k].value for k in keys}
        ac.reset_launches()
        replies = []
        t_serve = time.perf_counter()
        for turn in range(turns):
            for i, u in enumerate(users):
                gen = ({"temperature": 0.8, "top_p": 0.9, "seed": 7}
                       if turn == 0 and i == 3 else {})
                send_tool_call(db, u, turn, i, **gen)
            got = await_replies(db, users)
            if len(got) < len(users):
                fail(f"mixtral {name} turn {turn + 1}: {len(got)} of "
                     f"{len(users)} replies")
            replies.extend(got.values())
        serve_s = time.perf_counter() - t_serve
        launches = dict(ac.LAUNCHES)
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
            card=card, max_step_s=eng.max_step_s,
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
