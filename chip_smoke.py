#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``swarmdb_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives the port on the card in phases, prints one JSON line per phase
and exits non-zero at the first failure:

1. device   -- the card's name and power limit (``nvidia-smi``).
2. build    -- compiles both CUDA kernels from ``swarmdb_tpu_torch/csrc``
               (one ``nvcc`` per source, started together).
3. kernels  -- each kernel at the serving path's shapes (Llama-3-8B heads:
               Hq 32, Hkv 8, D 128, page 16) against its plain PyTorch
               version, in bf16 (tolerance 2e-2 absolute) and f32 (1e-4),
               with a windowed case; then timed with CUDA events (median of
               30 after warm-up): the kernel, its plain version, and one
               PyTorch ``scaled_dot_product_attention`` call over the
               gathered dense view (``library_ms``, gather excluded).
4. parity   -- tiny-debug in f32 with the same weights, served on the card
               (kernels) and on the CPU (plain versions): greedy tokens
               equal, prefill and decode logits within 1e-4.
5. serve    -- Llama-3-8B at full width (32 layers, bf16, random weights
               from a seed) through SwarmDB + LocalBroker +
               ServingService.from_model_name(..., paged=True): 4 users x 2
               turns, 32 new tokens each, one request sampled (temperature
               0.8, top-p 0.9, seed 7). Checks every reply, prefix reuse
               on turn 2, and that the kernels' launch counts advanced by
               32 per prefill wave and 32 per decode step.

Then one ``{"kernels": [...]}`` line (launches are the serve phase's) and,
last, ``{"ok": true, "device": {...}}``. Without CUDA, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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


def decode_case(dtype, dev, window=None):
    """The decode step's inputs at the serving shape: 8 slots with mixed
    chunk starts, pages drawn from the 769-page pool, chunk of 8 at step
    5."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(1)
    B, Kc, step = 8, 8, 5
    starts = torch.tensor([37, 300, 1000, 5, 513, 128, 777, 250],
                          dtype=torch.int32)
    perm = torch.randperm(NPAGES - 1, generator=g)[:B * MAXP] + 1
    table = perm.reshape(B, MAXP).to(torch.int32)
    r = lambda *s: torch.randn(*s, generator=g).to(dtype)
    q = r(B, HQ, D)
    kp, vp = r(NPAGES, PS, HKV, D), r(NPAGES, PS, HKV, D)
    ck, cv = r(B, Kc, HKV, D), r(B, Kc, HKV, D)
    to = lambda t: t.to(dev)
    return dict(q=to(q), k_pages=to(kp), v_pages=to(vp),
                page_table=to(table), chunk_k=to(ck), chunk_v=to(cv),
                starts=to(starts), step=step, window=window)


def prefill_case(dtype, dev, window=None):
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
    r = lambda *s: torch.randn(*s, generator=g).to(dtype)
    to = lambda t: t.to(dev)
    return dict(q=to(r(W, HQ, D)), sfx_k=to(r(W, HKV, D)),
                sfx_v=to(r(W, HKV, D)), k_pages=to(r(NPAGES, PS, HKV, D)),
                v_pages=to(r(NPAGES, PS, HKV, D)), row_tables=to(tables),
                starts=to(starts), lens=to(lens), prefix_lens=to(plens),
                window=window)


def decode_work(c):
    B = c["q"].shape[0]
    keys = int(c["starts"].sum()) + B * (c["step"] + 1)
    es = c["q"].element_size()
    nbytes = (c["q"].numel() * es * 2            # q in, out
              + keys * HKV * D * es * 2          # live K and V rows
              + c["page_table"].numel() * 4 + B * 4)
    return nbytes, 4.0 * HQ * D * keys


def prefill_work(c):
    lens = c["lens"].tolist()
    plens = c["prefix_lens"].tolist()
    es = c["q"].element_size()
    W = c["q"].shape[0]
    keys = sum(n * p + n * (n + 1) // 2 for n, p in zip(lens, plens))
    nbytes = (W * (2 * HQ + 2 * HKV) * D * es    # q, out, suffix K/V
              + sum(p for p, n in zip(plens, lens) if n) * HKV * D * es * 2
              + c["row_tables"].numel() * 4 + 3 * len(lens) * 4)
    return nbytes, 4.0 * HQ * D * keys


def decode_library(c):
    """SDPA over the gathered dense view: pages + chunk buffer per slot,
    a boolean mask for the live positions (the gather is done here, once,
    outside the timed call)."""
    import torch
    import torch.nn.functional as F

    from swarmdb_tpu_torch.ops.paged_kv import paged_gather_kv

    kg, vg = paged_gather_kv(c["k_pages"], c["v_pages"], c["page_table"])
    k = torch.cat([kg, c["chunk_k"]], 1)          # [B, S+Kc, Hkv, D]
    v = torch.cat([vg, c["chunk_v"]], 1)
    S, Kc = kg.shape[1], c["chunk_k"].shape[1]
    pos = torch.arange(S + Kc, device=k.device)
    st = c["starts"].long()[:, None]
    live = torch.where(pos < S, pos[None] < st, pos[None] - S <= c["step"])
    G = HQ // HKV
    q = c["q"][:, :, None]                         # [B, Hq, 1, D]
    k = k.transpose(1, 2).repeat_interleave(G, 1).contiguous()
    v = v.transpose(1, 2).repeat_interleave(G, 1).contiguous()
    mask = live[:, None, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def prefill_library(c):
    """SDPA over a dense [rows, Hq, L, S] view of the wave: each live row's
    prefix keys then its suffix keys, a causal-plus-prefix mask."""
    import torch
    import torch.nn.functional as F

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
        pk = c["k_pages"][pages].reshape(-1, HKV, D)[:p]
        pv = c["v_pages"][pages].reshape(-1, HKV, D)[:p]
        kk = torch.cat([pk, c["sfx_k"][s:s + n]]).transpose(0, 1)
        vv = torch.cat([pv, c["sfx_v"][s:s + n]]).transpose(0, 1)
        q[i, :, :n] = c["q"][s:s + n].transpose(0, 1)
        k[i, :, :p + n] = kk.repeat_interleave(G, 0)
        v[i, :, :p + n] = vv.repeat_interleave(G, 0)
        qi = torch.arange(n, device=dev)[:, None]
        kj = torch.arange(Sm, device=dev)[None]
        mask[i, 0, :n] = kj <= p + qi
    mask[:, :, :, 0] |= True   # padded query rows: keep softmax finite
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def run_kernels(dev):
    import torch

    from swarmdb_tpu_torch.ops import attention_cuda as ac

    specs = {
        "ragged_prefill": dict(
            case=prefill_case, work=prefill_work, library=prefill_library,
            kernel=ac.ragged_paged_prefill_attention,
            plain=ac.ragged_prefill_plain,
            source="swarmdb_tpu_torch/csrc/ragged_prefill.cu",
            replaces="swarmdb_tpu/ops/attention_pallas.py:356"),
        "paged_decode_chunked": dict(
            case=decode_case, work=decode_work, library=decode_library,
            kernel=ac.paged_decode_gqa_attention_chunked,
            plain=ac.paged_decode_chunked_plain,
            source="swarmdb_tpu_torch/csrc/paged_decode_chunked.cu",
            replaces="swarmdb_tpu/ops/attention_pallas.py:211"),
    }
    rows = {}
    for name, sp in specs.items():
        errs = {}
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            for window in (None, 96):
                c = sp["case"](dtype, dev, window)
                got = sp["kernel"](**c)
                want = sp["plain"](**c)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                errs[f"{str(dtype)[6:]}_w{window or 0}"] = err
                if not err <= tol:
                    fail(f"{name} {dtype} window={window}: max abs err "
                         f"{err} > {tol}")
        c = sp["case"](torch.bfloat16, dev)
        nbytes, flops = sp["work"](c)
        b_ms, b_by = bound(nbytes, flops)
        ms = time_graph(lambda: sp["kernel"](**c))
        plain_ms = time_events(lambda: sp["plain"](**c), iters=20)
        library_ms = time_graph(sp["library"](c))
        rows[name] = {
            "name": name, "route": "cuda", "source": sp["source"],
            "replaces": sp["replaces"], "launches": 0,
            "max_abs_err": errs["bfloat16_w0"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}
        emit("kernels", kernel=name, errors=errs, ms=ms, plain_ms=plain_ms,
             library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
             bytes=nbytes, flops=flops)
    return rows


# ------------------------------------------------------------------ parity


def run_parity(dev):
    """tiny-debug f32: the same weights served on the card and on the CPU."""
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
    engines = {}
    for name, d, p in (("gpu", dev, p_gpu), ("cpu", "cpu", p_cpu)):
        engines[name], tok = build_backend_engine(
            "tiny-debug", max_batch=4, max_seq=256, device=d, params=p,
            kv_dtype=torch.float32)
        engines[name].start()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 259, n).tolist() for n in (40, 9, 200, 77)]
    ac.reset_launches()
    try:
        for p in prompts:
            a = engines["gpu"].generate_sync(p, SamplingParams(
                max_new_tokens=16))
            b = engines["cpu"].generate_sync(p, SamplingParams(
                max_new_tokens=16))
            if a != b:
                fail(f"tiny-debug greedy tokens differ card vs cpu: {a} {b}")
    finally:
        for e in engines.values():
            e.stop()
    if not all(ac.LAUNCHES.values()):
        fail(f"the card engine did not launch both kernels: {ac.LAUNCHES}")
    # logits of one prefill wave and one decode step, card vs cpu
    W, ps, maxp = 96, 16, 16
    toks = torch.from_numpy(rng.integers(3, 259, W).astype(np.int32))
    tok_row = torch.zeros(W, dtype=torch.int32)
    tok_row[60:] = 1
    tok_pos = torch.cat([torch.arange(60), torch.arange(36) + 20]).int()
    tables = torch.arange(1, 2 * maxp + 1, dtype=torch.int32).reshape(2, -1)
    starts = torch.tensor([0, 60], dtype=torch.int32)
    lens = torch.tensor([60, 36], dtype=torch.int32)
    plens = torch.tensor([0, 20], dtype=torch.int32)
    g = torch.Generator().manual_seed(3)
    shape = (cfg.n_layers, 2 * maxp + 1, ps, cfg.n_kv_heads, cfg.head_dim)
    kpool, vpool = torch.randn(shape, generator=g), torch.randn(shape,
                                                               generator=g)
    outs = {}
    for name, d, p in (("gpu", dev, p_gpu), ("cpu", "cpu", p_cpu)):
        t = lambda x: x.to(d)
        logits, _, _ = llama.forward_ragged_prefill(
            p, cfg, t(toks), t(tok_row), t(tok_pos), t(tables), t(starts),
            t(lens), t(plens), t(kpool), t(vpool))
        cache = {"k": t(kpool), "v": t(vpool), "page_table": t(tables)}
        hk = torch.randn((cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.head_dim),
                         generator=torch.Generator().manual_seed(4))
        step_logits, _ = llama.forward_paged_chunked(
            p, cfg, t(toks[:2, None].long()), t(torch.tensor([[70], [90]])),
            cache, (t(hk), t(hk.clone())), 3)
        outs[name] = (logits.cpu(), step_logits.cpu())
    errs = [float((a - b).abs().max()) for a, b in zip(outs["gpu"],
                                                        outs["cpu"])]
    if max(errs) > 1e-4:
        fail(f"tiny-debug logits card vs cpu differ by {errs} > 1e-4")
    emit("parity", prompts=len(prompts), greedy_equal=True,
         prefill_logits_max_abs_err=errs[0],
         decode_logits_max_abs_err=errs[1], launches=dict(ac.LAUNCHES))


# ------------------------------------------------------------------- serve


USER_TEXT = (
    "I am planning a three-day trip to a city I have never visited and I "
    "want a schedule that balances museums, long walks and good food. "
    "Please suggest a plan for each morning, afternoon and evening, keep "
    "travel between places short, and mention one rainy-day alternative. "
    "My name is {u} and I prefer quiet places over crowded ones.")
FOLLOW_UP = ("Thanks. Now shorten the second day to a half day and add "
             "one place for coffee, {u} speaking again.")


def run_serve(card: str):
    import torch

    from swarmdb_tpu_torch.backend.service import ServingService
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    db = SwarmDB(broker=LocalBroker())
    backend = "h100-0"
    t0 = time.perf_counter()
    svc = ServingService.from_model_name(db, "llama3-8b", backend_id=backend,
                                         paged=True, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = svc.engine
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
        for turn, text in enumerate((USER_TEXT, FOLLOW_UP)):
            for i, u in enumerate(users):
                gen = {"max_new_tokens": 32}
                if turn == 0 and i == 3:
                    gen.update(temperature=0.8, top_p=0.9, seed=7)
                db.send_message(u, "assistant", text.format(u=u),
                                metadata={"generation": gen})
            got = await_replies(db, users)
            if len(got) < len(users):
                fail(f"turn {turn + 1}: {len(got)} of {len(users)} replies")
            replies.extend(got.values())
        serve_s = time.perf_counter() - t_serve
        launches = dict(ac.LAUNCHES)
        waves = c["prefill_waves"].value - base["prefill_waves"]
        chunks = c["engine_decode_chunks"].value - base["engine_decode_chunks"]
        steps = chunks * eng.decode_chunk
        L = eng.cache["k"].shape[0]
        reasons = [m.metadata.get("finish_reason") for m in replies]
        reused = eng.metrics.counters["prefix_reused_tokens"].value
        checks = {
            "8 replies, length/eos": len(replies) == 8 and all(
                r in ("length", "eos") for r in reasons),
            "prefix reuse on turn 2": reused > 0,
            "prefill launches == 32 per wave": waves > 0 and launches[
                "ragged_prefill"] >= L * waves,
            "decode launches == 32 per step": chunks > 0 and launches[
                "paged_decode_chunked"] >= L * steps,
            "pool on cuda": eng.cache["k"].is_cuda,
            "params on cuda": eng.params["layers"]["wq"].is_cuda,
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"serve checks failed: {bad}; reasons={reasons} "
                 f"reused={reused} waves={waves} chunks={chunks} "
                 f"launches={launches}")
        ttft = sorted(db.metrics.latencies["send_to_first_token_s"].values())
        dec_s = (c["phase_us_decode"].value - base["phase_us_decode"]) / 1e6
        gen_tok = c["tokens_generated"].value - base["tokens_generated"]
        prof = profile_turn(db, users, text=FOLLOW_UP)
        # tracing slows the profiled turn; its device time against the
        # untraced turns' mean wall time gives the idle share of serving
        prof["untraced_turn_wall_ms"] = serve_s / 2 * 1e3
        prof["device_idle_share_vs_untraced"] = 1.0 - prof[
            "device_busy_ms"] / prof["untraced_turn_wall_ms"]
        emit("serve", model="llama3-8b", layers=L, dtype="bfloat16",
             replies=len(replies), finish_reasons=reasons,
             prefix_reused_tokens=reused, prefill_waves=waves,
             decode_chunks=chunks, launches=launches,
             ttft_p50_s=statistics.median(ttft), ttft_max_s=ttft[-1],
             decode_tokens_per_s=gen_tok / dec_s if dec_s else None,
             generated_tokens=gen_tok, serve_wall_s=serve_s,
             weight_init_s=init_s, card=card,
             logits_mm_out_dtype=llama._MM_OUT_DTYPE.get(eng.device),
             peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        emit("profile", **prof)
        return launches
    finally:
        svc.stop()
        db.close()


def await_replies(db, users, timeout=300.0):
    got = {}
    deadline = time.time() + timeout
    while len(got) < len(users) and time.time() < deadline:
        for u in users:
            for m in db.receive_messages(u, timeout=0.05):
                got[u] = m
    return got


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
    attn = {"ragged_prefill": "ragged_prefill_kernel",
            "paged_decode_chunked": "paged_decode_chunked_kernel"}
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "attention_ms": {k: sum(t for n, t, _ in kernels if v in n)
                         for k, v in attn.items()},
        "top": [{"kernel": n[:90], "ms": t, "calls": c}
                for n, t, c in kernels[:12]],
    }


# -------------------------------------------------------------------- main


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
         ptxas={k: [ln.strip() for ln in v.splitlines()
                    if "registers" in ln or "spill" in ln][:8]
                for k, v in logs.items()})

    with torch.no_grad():
        rows = run_kernels(dev)
        run_parity(dev)
        launches = run_serve(card)
    for k, n in launches.items():
        rows[k]["launches"] = n
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
