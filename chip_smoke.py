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
               (1e-4); greedy tokens equal in every case.
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

Then one ``{"kernels": [...]}`` line (launches summed over the six serves,
each counted from zero just before it and read just after) and, last,
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

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


def path_kernels(kind: str, chunked: bool, paged: bool) -> tuple:
    """The kernels an engine runs. Paged, over a ``kind`` pool: ragged
    prefill at admission, then chunked or single-step decode. Dense: the
    dense decode kernel only (its prefill attention is plain PyTorch, as
    in the JAX package)."""
    if not paged:
        return ("dense_decode_chunked" if chunked else "dense_decode",)
    quant = "_quant" if kind == "int8" else ""
    decode = "paged_decode_chunked" if chunked else "paged_decode"
    return "ragged_prefill" + quant, decode + quant


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
    launches summed over the serves."""
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
    return total


def run_serve(card, params, init_s, name, kind, chunked, turns, paged):
    import gc

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
    db = SwarmDB(broker=LocalBroker())
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
            weight_init_s=init_s, card=card,
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
        launches = run_serves(card)
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
