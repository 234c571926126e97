"""Offline trace / flight analyzer: a copy of
``swarmdb_tpu/obs/analyze.py`` for the files the port emits.

It reads span exports (Chrome trace-event JSON, as written by
``SpanTracer.to_chrome_trace``, ``/admin/trace/export`` and
``/admin/cluster/trace``) and flight-recorder dumps, and writes a
machine-readable diagnosis::

    python -m swarmdb_tpu_torch.obs.analyze base_trace.json test_trace.json

With two traces the report is a comparison (the first is the base): the
per-completion engine cost is split by span category (queue wait,
prefill, decode, host sync), the growth is attributed across named
contributors whose shares sum to 1, and the dominant one is named with
numbers. With one trace it reports that run's own cost mix. Flight dumps
passed alongside add what only the rings carry: per-shard occupancy
imbalance, padding waste, host syncs per step and the admission-stall
evidence.

The contributors:

- ``admission_serialization``: queue-wait (``engine.admit``) growth
  while free slots existed, the admission machinery's fault;
- ``capacity_wait``: queue wait that is demand above the achieved
  service rate (every slot busy while the queue was deep). Split from
  the above by the paired flight dump's per-step (active, queued)
  evidence, trusted only for steps sampled right after admission
  (``occ_at_admit``, which resident-loop engines stamp); without that
  evidence the whole wait stays on admission_serialization;
- ``prefill_compute``: ``engine.prefill`` span growth;
- ``per_shard_imbalance``: decode growth explained by uneven
  ``active_by_shard`` occupancy (needs flight dumps, else 0);
- ``host_sync``: ``engine.host_sync`` growth, the host's waits on the
  device;
- ``decode``: the rest of the decode-chunk growth.

It also reads the device-time profiler's and the memory accountant's
dumps (``profile_*.json``, ``mem_*.json``, the JAX package's schemas, so
either package's analyzer reads the other's): ``--roofline`` (with the
on-chip memory column under the JAX package's VMEM keys: on the card a
CUDA kernel's shared memory per block against the device's opt-in
limit), ``--memory``, and their one-line listings beside an analyzed
trace, and the three runtime sanitizers' dumps
(``lockcheck_*.json``, ``pagecheck_*.json``, ``kerncheck_*.json``) beside
an analyzed trace, with their cycle and violation counts and kinds.
``--self-check`` runs the pipeline on synthetic traces and checks its own
invariants.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["analyze_files", "summarize_trace", "summarize_flight",
           "diagnose", "roofline_report", "memory_report", "self_check",
           "main"]

#: span name -> cost category (everything engine-side that serializes
#: the loop; routing spans are microseconds and excluded by design)
SPAN_CATEGORIES = {
    "engine.admit": "queue_wait",
    "engine.prefill": "prefill",
    "engine.decode_chunk": "decode",
    "engine.host_sync": "host_sync",
}

#: diagnosis contributors, reported in this order; shares sum to ~1
CONTRIBUTORS = ("admission_serialization", "capacity_wait",
                "prefill_compute", "per_shard_imbalance", "host_sync",
                "decode")

_WAVE_GAP_US = 2000.0  # prefill starts closer than this = same wave


# ------------------------------------------------------------------ loading


def load_file(path: str) -> Tuple[str, Any]:
    """('trace', events) for Chrome trace JSON, ('flight', dump) for a
    flight-recorder dump, ('profile', dump) for a device-time profiler
    dump, ('mem', dump) for a memory accountant dump; raises ValueError
    for anything else."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict) and "traceEvents" in data:
        return "trace", [e for e in data["traceEvents"]
                         if e.get("ph") == "X"]
    if isinstance(data, dict) and "steps" in data and "requests" in data:
        return "flight", data
    if isinstance(data, dict) and data.get("kind") == "swarmdb.profile":
        return "profile", data
    if isinstance(data, dict) and data.get("kind") == "swarmdb.mem":
        return "mem", data
    raise ValueError(f"{path}: not a Chrome trace export (traceEvents), "
                     "a flight dump (steps/requests), a profile dump "
                     "(kind=swarmdb.profile), or a mem dump "
                     "(kind=swarmdb.mem)")


# --------------------------------------------------------------- summaries


def summarize_trace(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-category cost decomposition of one trace export."""
    completed = sum(1 for e in events if e.get("name") == "stage.done")
    if completed == 0:
        completed = len({(e.get("args") or {}).get("rid")
                         for e in events
                         if e.get("name") == "engine.decode_chunk"})
    completed = max(1, completed)
    cost_ms: Dict[str, float] = {c: 0.0 for c in SPAN_CATEGORIES.values()}
    count: Dict[str, int] = {c: 0 for c in SPAN_CATEGORIES.values()}
    prefill_starts: List[float] = []
    t_lo, t_hi = float("inf"), float("-inf")
    for e in events:
        ts = float(e.get("ts", 0.0))
        dur = float(e.get("dur", 0.0))
        t_lo = min(t_lo, ts)
        t_hi = max(t_hi, ts + dur)
        cat = SPAN_CATEGORIES.get(e.get("name", ""))
        if cat is None:
            continue
        cost_ms[cat] += dur / 1e3
        count[cat] += 1
        if e["name"] == "engine.prefill":
            prefill_starts.append(ts)
    # admission-wave detection: prefill spans that start within the gap
    # threshold are one wave (every slot in a prefill batch records the
    # same window) — many small waves with long queue waits between
    # them is the serialization signature
    prefill_starts.sort()
    waves: List[int] = []
    prev = float("-inf")
    for ts in prefill_starts:
        if not waves or ts - prev > _WAVE_GAP_US:
            waves.append(1)
        else:
            waves[-1] += 1
        prev = ts
    out: Dict[str, Any] = {
        "completed": completed,
        "wall_s": round(max(0.0, (t_hi - t_lo)) / 1e6, 3)
        if t_hi > t_lo else 0.0,
        "per_completion_ms": {
            c: round(cost_ms[c] / completed, 3) for c in cost_ms},
        "span_counts": count,
        "mean_ms": {c: round(cost_ms[c] / count[c], 3) if count[c] else 0.0
                    for c in cost_ms},
        "admission_waves": len(waves),
        "mean_wave_size": round(sum(waves) / len(waves), 2) if waves
        else 0.0,
    }
    return out


def summarize_flight(dump: Dict[str, Any]) -> Dict[str, Any]:
    """Ring-only signals a trace cannot carry: per-shard occupancy
    imbalance, padding waste, host-syncs per step, and the request-ring
    median timeline decomposition."""
    steps = dump.get("steps") or []
    reqs = dump.get("requests") or []
    imbalances: List[float] = []
    # admission-stall evidence: over steps with a non-empty queue, the
    # queue-weighted fraction of capacity sitting FREE. ~0 = the queue
    # waits because every slot is busy (capacity); ~1 = requests wait
    # while slots idle (the admission machinery is the bottleneck).
    stall_w = 0.0
    stall_total = 0.0
    stall_evidence = False
    for step in steps:
        shards = step.get("active_by_shard") or {}
        vals = [int(v) for v in shards.values()]
        if len(vals) >= 2 and sum(vals) > 0:
            mean = sum(vals) / len(vals)
            imbalances.append((max(vals) - min(vals)) / max(1.0, mean))
        queued = int(step.get("queued", 0))
        cap = int(step.get("max_batch", 0))
        if step.get("occ_at_admit"):
            # occupancy sampled right after admission (resident-path
            # engines mark their steps): the one sampling point where
            # free-while-queued really means the admission path stalled
            stall_evidence = True
        if queued > 0 and cap > 0:
            free = max(0, cap - int(step.get("active", 0)))
            stall_w += queued * (free / cap)
            stall_total += queued
    first, last = (steps[0], steps[-1]) if steps else ({}, {})

    def delta(key: str) -> int:
        return int(last.get(key, 0)) - int(first.get(key, 0))

    prompt = delta("prompt_tokens")
    padding = delta("prefill_padding_tokens")

    def med(values: List[float]) -> float:
        if not values:
            return 0.0
        values = sorted(values)
        return values[len(values) // 2]

    queue = [r["admitted_at"] - r["submitted_at"] for r in reqs
             if r.get("admitted_at") and r.get("submitted_at")]
    ttft = [r["first_token_at"] - r["submitted_at"] for r in reqs
            if r.get("first_token_at") and r.get("submitted_at")]
    # which attention paths served these steps: a regression
    # whose base and test dumps disagree here is a PATH change
    # (one decode kernel for another, ragged<->bucketed), not a drift of
    # one path
    kernels = sorted({s["decode_kernel"] for s in steps
                      if s.get("decode_kernel")})
    wave_kinds = sorted({s["wave_kind"] for s in steps
                         if s.get("wave_kind")})
    # leadership churn: ha.repin instants in the event ring
    # tie a TTFT spike to conversations whose lane pin moved with a
    # leadership change (drain handover / failover) — a dump whose
    # p50_ttft regressed WITH repins in-window is churn, not engine drift
    events = dump.get("events") or []
    repins = sum(1 for e in events if e.get("kind") == "ha.repin")
    promotions = sum(1 for e in events
                     if e.get("kind") == "ha.partition_promoted")
    return {
        "steps": len(steps),
        "requests": len(reqs),
        "shard_imbalance": round(med(imbalances), 4) if imbalances else 0.0,
        "shards": len((steps[0].get("active_by_shard") or {})) if steps
        else 0,
        "decode_kernels": kernels,
        "wave_kinds": wave_kinds,
        "padding_ratio": round(padding / prompt, 4) if prompt > 0 else 0.0,
        "admission_stall_frac": round(stall_w / stall_total, 4)
        if stall_total > 0 else 0.0,
        "stall_evidence": stall_evidence,
        "host_syncs_per_step": round(
            delta("host_syncs") / max(1, len(steps) - 1), 3),
        "p50_queue_wait_s": round(med(queue), 4),
        "p50_ttft_s": round(med(ttft), 4),
        "leadership_repins": repins,
        "partition_promotions": promotions,
        "meta": dump.get("meta", {}),
    }


# --------------------------------------------------------------- diagnosis


def _attribute(base: Dict[str, Any], test: Dict[str, Any],
               base_flight: Optional[Dict[str, Any]],
               test_flight: Optional[Dict[str, Any]]) -> Dict[str, float]:
    """Per-completion cost growth (ms), attributed per contributor."""
    b = base["per_completion_ms"]
    t = test["per_completion_ms"]
    decode_delta = max(0.0, t["decode"] - b["decode"])
    # imbalance-attributable decode growth: idle shards pace at the
    # slowest shard, so the imbalance index bounds the decode fraction
    # it can explain
    imb = (test_flight or {}).get("shard_imbalance", 0.0)
    imbalance_ms = min(decode_delta, decode_delta * min(1.0, float(imb)))
    # queue-wait growth: serialization by default (equal offered load,
    # equal slots — growth is the machinery), UNLESS the test dump
    # carries post-admission occupancy evidence saying the slots were
    # in fact busy whenever the queue was non-empty, in which case the
    # wait is demand exceeding the run's achieved service rate
    # (capacity_wait — e.g. lanes sharing a starved host core)
    queue_growth = max(0.0, t["queue_wait"] - b["queue_wait"])
    admit_ms, cap_ms = _queue_split(queue_growth, test_flight)
    return {
        "admission_serialization": admit_ms,
        "capacity_wait": cap_ms,
        "prefill_compute": max(0.0, t["prefill"] - b["prefill"]),
        "per_shard_imbalance": imbalance_ms,
        "host_sync": max(0.0, t["host_sync"] - b["host_sync"]),
        "decode": decode_delta - imbalance_ms,
    }


def _queue_split(queue_ms: float,
                 flight: Optional[Dict[str, Any]]) -> Tuple[float, float]:
    """(admission_ms, capacity_ms) of a queue-wait quantity. The split
    is trusted ONLY when the dump's steps were sampled post-admission
    (``stall_evidence`` — resident-path engines mark their step
    records): occupancy sampled anywhere else reads transient session
    boundaries as stall. Without that evidence every ms stays on
    admission_serialization — the pre-split behavior, which the online
    sentinel (no flight pairing) and unmarked dumps keep."""
    if (flight is None or not flight.get("stall_evidence")
            or "admission_stall_frac" not in flight):
        return queue_ms, 0.0
    frac = min(1.0, max(0.0, float(flight["admission_stall_frac"])))
    return queue_ms * frac, queue_ms * (1.0 - frac)


def diagnose(base: Dict[str, Any], test: Dict[str, Any],
             base_flight: Optional[Dict[str, Any]] = None,
             test_flight: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
    """Name the dominant contributor to test-vs-base slowdown, with
    shares that sum to ~1."""
    deltas = _attribute(base, test, base_flight, test_flight)
    total = sum(deltas.values())
    regressed = total > 0.0
    if regressed:
        shares = {c: deltas[c] / total for c in CONTRIBUTORS}
    else:
        # no regression: shares describe the TEST run's own cost mix so
        # the report stays schema-stable (and still sums to 1). The
        # queue wait splits into admission-machinery stall vs plain
        # capacity wait using the flight rings' occupancy evidence.
        t = test["per_completion_ms"]
        admit_ms, cap_ms = _queue_split(t["queue_wait"], test_flight)
        mix = {
            "admission_serialization": admit_ms,
            "capacity_wait": cap_ms,
            "prefill_compute": t["prefill"],
            "per_shard_imbalance": 0.0,
            "host_sync": t["host_sync"],
            "decode": t["decode"],
        }
        mix_total = sum(mix.values()) or 1.0
        shares = {c: mix[c] / mix_total for c in CONTRIBUTORS}
    dominant = max(CONTRIBUTORS, key=lambda c: shares[c])
    b_cost = sum(base["per_completion_ms"].values())
    t_cost = sum(test["per_completion_ms"].values())
    slowdown = round(t_cost / b_cost, 2) if b_cost > 0 else None
    explanation = (
        f"per-completion engine cost {b_cost:.0f}ms -> {t_cost:.0f}ms "
        f"({slowdown}x); dominant contributor: {dominant} "
        f"({shares[dominant]:.0%} of the growth). "
        f"queue_wait {base['per_completion_ms']['queue_wait']:.0f}ms -> "
        f"{test['per_completion_ms']['queue_wait']:.0f}ms, "
        f"prefill mean {base['mean_ms']['prefill']:.1f}ms -> "
        f"{test['mean_ms']['prefill']:.1f}ms over "
        f"{test['admission_waves']} admission waves "
        f"(mean {test['mean_wave_size']:.1f} requests/wave)."
        if regressed else
        f"no per-completion regression ({b_cost:.0f}ms -> {t_cost:.0f}ms); "
        f"shares describe the test run's own cost mix.")
    return {
        "regressed": regressed,
        "dominant": dominant,
        "shares": {c: round(shares[c], 4) for c in CONTRIBUTORS},
        "slowdown_x": slowdown,
        "delta_per_completion_ms": {c: round(deltas[c], 2)
                                    for c in CONTRIBUTORS},
        "explanation": explanation,
    }


def _solo_diagnosis(summary: Dict[str, Any],
                    flight: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """One-run report: where did this
    run's per-completion engine time go?"""
    t = summary["per_completion_ms"]
    imb = (flight or {}).get("shard_imbalance", 0.0)
    imbalance_ms = t["decode"] * min(1.0, float(imb))
    admit_ms, cap_ms = _queue_split(t["queue_wait"], flight)
    mix = {
        "admission_serialization": admit_ms,
        "capacity_wait": cap_ms,
        "prefill_compute": t["prefill"],
        "per_shard_imbalance": imbalance_ms,
        "host_sync": t["host_sync"],
        "decode": t["decode"] - imbalance_ms,
    }
    total = sum(mix.values()) or 1.0
    shares = {c: round(mix[c] / total, 4) for c in CONTRIBUTORS}
    dominant = max(CONTRIBUTORS, key=lambda c: shares[c])
    return {
        "regressed": None,
        "dominant": dominant,
        "shares": shares,
        "slowdown_x": None,
        "delta_per_completion_ms": None,
        "explanation": (
            f"per-completion engine cost {total:.0f}ms; largest share: "
            f"{dominant} ({shares[dominant]:.0%})."),
    }


# ------------------------------------------------------------- files in


def analyze_files(paths: Sequence[str]) -> Dict[str, Any]:
    """Analyze trace / flight files. Two traces give a comparison (the
    first is the base); one trace its own cost decomposition. Flight
    dumps pair with the traces in the order given."""
    traces: List[Tuple[str, Dict[str, Any]]] = []
    flights: List[Tuple[str, Dict[str, Any]]] = []
    profiles: List[Tuple[str, Dict[str, Any]]] = []
    mems: List[Tuple[str, Dict[str, Any]]] = []
    inputs = []
    for path in paths:
        kind, data = load_file(path)
        inputs.append({"path": path, "kind": kind})
        if kind == "trace":
            traces.append((path, summarize_trace(data)))
        elif kind == "profile":
            profiles.append((path, data))
        elif kind == "mem":
            mems.append((path, data))
        else:
            flights.append((path, summarize_flight(data)))
    if not traces:
        raise ValueError("need at least one Chrome trace export "
                         "(use --roofline for profile dumps alone, "
                         "--memory for mem dumps alone)")
    report: Dict[str, Any] = {
        "kind": "swarmdb.obs.analyze",
        "version": 1,
        "inputs": inputs,
    }
    lockchecks = _lockcheck_dumps(paths)
    if lockchecks:
        report["lockcheck_dumps"] = lockchecks
    pagechecks = _pagecheck_dumps(paths)
    if pagechecks:
        report["pagecheck_dumps"] = pagechecks
    kernchecks = _kerncheck_dumps(paths)
    if kernchecks:
        report["kerncheck_dumps"] = kernchecks
    profile_list = ([_profile_summary(p, d) for p, d in profiles]
                    + _profile_dumps(paths))
    if profile_list:
        report["profile_dumps"] = profile_list
    mem_list = ([_mem_summary(p, d) for p, d in mems]
                + _mem_dumps(paths))
    if mem_list:
        report["mem_dumps"] = mem_list
    base_flight = flights[0][1] if flights else None
    test_flight = flights[-1][1] if flights else None
    if len(traces) >= 2:
        base, test = traces[0][1], traces[1][1]
        report["base"] = {"path": traces[0][0], **base,
                          "flight": base_flight}
        report["test"] = {"path": traces[1][0], **test,
                          "flight": test_flight}
        report["diagnosis"] = diagnose(base, test, base_flight,
                                       test_flight)
    else:
        summary = traces[0][1]
        report["summary"] = {"path": traces[0][0], **summary,
                             "flight": test_flight}
        report["diagnosis"] = _solo_diagnosis(summary, test_flight)
    return report


def _lockcheck_dumps(paths: Sequence[str]) -> List[Dict[str, Any]]:
    """Lock-sanitizer dumps (``lockcheck_<node>.json``, ``obs/lockcheck.py``)
    sitting next to the analyzed flight/trace files: the flight dump
    says what the node was doing, the lockcheck dump says which lock
    orders it exercised doing it -- an inversion cycle here IS the
    diagnosis. Listed with their cycle counts so a report reader never
    has to know the files exist to notice a detected deadlock order."""
    seen: set = set()
    out: List[Dict[str, Any]] = []
    for p in paths:
        d = os.path.dirname(os.path.abspath(p))
        if d in seen:
            continue
        seen.add(d)
        for cand in sorted(glob.glob(os.path.join(d,
                                                  "lockcheck_*.json"))):
            try:
                with open(cand, "r", encoding="utf-8") as f:
                    dump = json.load(f)
            except (OSError, ValueError):
                continue
            cycles = dump.get("cycles") or []
            out.append({
                "path": cand,
                "node": dump.get("node"),
                "cycles": len(cycles),
                "cycle_sites": [c.get("sites") for c in cycles],
                "sites_tracked": len(dump.get("sites") or {}),
            })
    return out


def _pagecheck_dumps(paths: Sequence[str]) -> List[Dict[str, Any]]:
    """Page-sanitizer dumps (``pagecheck_<node>.json``, ``obs/pagecheck.py``)
    sitting next to the analyzed flight/trace files -- the page twin of
    the lockcheck listing above: the flight dump says what the node was
    doing, the pagecheck dump says which page custody it violated doing
    it. Listed with violation counts/kinds so a detected use-after-free
    is never invisible in a report."""
    seen: set = set()
    out: List[Dict[str, Any]] = []
    for p in paths:
        d = os.path.dirname(os.path.abspath(p))
        if d in seen:
            continue
        seen.add(d)
        for cand in sorted(glob.glob(os.path.join(d,
                                                  "pagecheck_*.json"))):
            try:
                with open(cand, "r", encoding="utf-8") as f:
                    dump = json.load(f)
            except (OSError, ValueError):
                continue
            violations = dump.get("violations") or []
            out.append({
                "path": cand,
                "node": dump.get("node"),
                "violations": len(violations),
                "violation_kinds": sorted(
                    {v.get("kind") for v in violations}),
                "pools": len(dump.get("pools") or []),
            })
    return out


def _kerncheck_dumps(paths: Sequence[str]) -> List[Dict[str, Any]]:
    """Kernel-sanitizer dumps (``kerncheck_<node>.json``, ``obs/kerncheck.py``)
    sitting next to the analyzed flight/trace files -- the kernel twin
    of the lockcheck/pagecheck listings above: the flight dump says
    what the node was doing, the kerncheck dump says which kernel
    contract it broke doing it (out-of-bounds block, write race,
    short-written output row, parity break).
    Listed with violation counts/kinds so a detected kernel crime is
    never invisible in a report."""
    seen: set = set()
    out: List[Dict[str, Any]] = []
    for p in paths:
        d = os.path.dirname(os.path.abspath(p))
        if d in seen:
            continue
        seen.add(d)
        for cand in sorted(glob.glob(os.path.join(d,
                                                  "kerncheck_*.json"))):
            try:
                with open(cand, "r", encoding="utf-8") as f:
                    dump = json.load(f)
            except (OSError, ValueError):
                continue
            violations = dump.get("violations") or []
            out.append({
                "path": cand,
                "node": dump.get("node"),
                "violations": len(violations),
                "violation_kinds": sorted(
                    {v.get("kind") for v in violations}),
                "kernels": sorted(
                    {v.get("kernel") for v in violations}),
            })
    return out


def _profile_summary(path: str, dump: Dict[str, Any]) -> Dict[str, Any]:
    """One line per profile dump for the main report: enough to spot
    "the decode chunk ate 80% of device time at MFU 0.004" without
    opening the file (the --roofline mode prints the full table)."""
    variants = dump.get("variants") or []
    top = variants[0] if variants else {}
    return {
        "path": path,
        "node": dump.get("node"),
        "platform": dump.get("platform"),
        "mfu": dump.get("mfu"),
        "variants": len(variants),
        "top_variant": top.get("variant"),
        "top_device_s": top.get("device_s"),
        "tiny_flush_waves": dump.get("tiny_flush_waves", 0),
    }


def _profile_dumps(paths: Sequence[str]) -> List[Dict[str, Any]]:
    """Profile dumps (``profile_*.json``) sitting next to the analyzed
    flight/trace files: the flight dump says what the node was doing,
    the profile dump which programs the device spent that time in."""
    given = {os.path.abspath(p) for p in paths}
    seen: set = set()
    out: List[Dict[str, Any]] = []
    for p in paths:
        d = os.path.dirname(os.path.abspath(p))
        if d in seen:
            continue
        seen.add(d)
        for cand in sorted(glob.glob(os.path.join(d, "profile_*.json"))):
            if os.path.abspath(cand) in given:
                continue
            try:
                with open(cand, "r", encoding="utf-8") as f:
                    dump = json.load(f)
            except (OSError, ValueError):
                continue
            if dump.get("kind") != "swarmdb.profile":
                continue
            out.append(_profile_summary(cand, dump))
    return out


def _mem_summary(path: str, dump: Dict[str, Any]) -> Dict[str, Any]:
    """One line per mem dump for the main report: enough to spot
    "the pool sat full of cold pages at a 40% prefix hit rate" without
    opening the file (the --memory mode prints the full picture)."""
    occ = dump.get("occupancy") or {}
    conv = dump.get("conversations") or {}
    prefix = dump.get("prefix") or {}
    return {
        "path": path,
        "node": dump.get("node"),
        "prefix_hit_rate": prefix.get("hit_rate"),
        "total_pages": occ.get("total_pages"),
        "headroom_pages": occ.get("headroom_pages"),
        "conversations": conv.get("by_state"),
        "tier_validation": dump.get("tier_validation"),
        "verdict": dump.get("verdict"),
    }


def _mem_dumps(paths: Sequence[str]) -> List[Dict[str, Any]]:
    """Mem dumps (``mem_*.json``) sitting next to the analyzed
    flight/trace files: the flight dump says what the node was doing,
    the mem dump where its KV pages and prefix-cache hit rate stood
    while it did it."""
    given = {os.path.abspath(p) for p in paths}
    seen: set = set()
    out: List[Dict[str, Any]] = []
    for p in paths:
        d = os.path.dirname(os.path.abspath(p))
        if d in seen:
            continue
        seen.add(d)
        for cand in sorted(glob.glob(os.path.join(d, "mem_*.json"))):
            if os.path.abspath(cand) in given:
                continue
            try:
                with open(cand, "r", encoding="utf-8") as f:
                    dump = json.load(f)
            except (OSError, ValueError):
                continue
            if dump.get("kind") != "swarmdb.mem":
                continue
            out.append(_mem_summary(cand, dump))
    return out


# ------------------------------------------------------------------- memory


def memory_report(paths: Sequence[str]) -> Dict[str, Any]:
    """``--memory``: the full memory-accounting report over mem dumps
    (``mem_*.json``). For each dump: the pool occupancy decomposition
    with residency ages, the hot/warm/cold conversation temperature
    distribution (plus the heaviest resident conversations, the tier's
    demotion candidates), the sampled miss-ratio curve at the standard
    capacity multiples, the what-if warm-tier model with re-admission
    cost, the cold-resume TTFT model, ``tier_validation`` and the sizing
    verdict."""
    dumps: List[Dict[str, Any]] = []
    for path in paths:
        kind, data = load_file(path)
        if kind != "mem":
            raise ValueError(f"{path}: --memory takes mem dumps "
                             "(kind=swarmdb.mem)")
        conv = data.get("conversations") or {}
        reuse = data.get("reuse") or {}
        dumps.append({
            "path": path,
            "node": data.get("node"),
            "enabled": data.get("enabled"),
            "page_bytes": data.get("page_bytes"),
            "occupancy": data.get("occupancy"),
            "prefix": data.get("prefix"),
            "temperature": {
                "hot_s": data.get("hot_s"),
                "warm_s": data.get("warm_s"),
                "tracked": conv.get("tracked"),
                "by_state": conv.get("by_state"),
                "resident_pages_by_state":
                    conv.get("resident_pages_by_state"),
                "top_resident": conv.get("top_resident"),
            },
            "miss_ratio_curve": reuse.get("curve"),
            "sampling": {k: reuse.get(k) for k in
                         ("accesses", "sampled", "cold", "sample_rate",
                          "stack_overflowed",
                          "device_capacity_pages")},
            "warm_tier": data.get("warm_tier"),
            "cold_resume": data.get("cold_resume"),
            # predicted-vs-measured warm tier: the what-if model's
            # promised hit-rate gain against the promotion share the
            # live tier delivered, with a drift flag when the model has
            # gone stale
            "tier_validation": data.get("tier_validation"),
            "verdict": data.get("verdict"),
        })
    return {
        "kind": "swarmdb.obs.memory",
        "version": 1,
        "dumps": dumps,
        # dumps whose live tier disagreed with the what-if model by
        # more than SWARMDB_MEM_TIER_DRIFT — re-run sizing before
        # trusting the verdict line
        "tier_drift_flagged": [
            d["path"] for d in dumps
            if (d.get("tier_validation") or {}).get("drifted")],
    }


# ----------------------------------------------------------------- roofline


def roofline_report(paths: Sequence[str],
                    top_n: int = 10) -> Dict[str, Any]:
    """``--roofline``: the device-time report over profile dumps. For
    each dump: the platform peak table, the top-N variants by cumulative
    device seconds (invocations, device_s, per-call FLOPs and bytes,
    achieved FLOP/s, MFU, arithmetic intensity, compute- vs
    memory-bound), per-lane duty cycles and per-pool rows, and the
    dispatch-shape profile with tiny ragged flush waves called out (what
    ``SWARMDB_RAGGED_MIN_WIDTH`` is to be set from, ROADMAP item 3), and
    the on-chip memory column: each variant whose dispatch recorded a
    static estimate (``vmem_est_bytes``; on the card, shared memory per
    block) against its budget, the dump's own per-variant budget or, for
    the dump as a whole, ``analysis.kernelcheck.smem_budget`` of its
    device kind (the card's opt-in limit, or a TPU's VMEM)."""
    from ..analysis.kernelcheck import smem_budget

    dumps: List[Dict[str, Any]] = []
    for path in paths:
        kind, data = load_file(path)
        if kind != "profile":
            raise ValueError(f"{path}: --roofline takes profile dumps "
                             "(kind=swarmdb.profile)")
        variants = list(data.get("variants") or [])
        variants.sort(key=lambda v: -(v.get("device_s") or 0.0))
        total_dev = sum(v.get("device_s") or 0.0 for v in variants)
        top = []
        for v in variants[:top_n]:
            row = dict(v)
            if total_dev > 0:
                row["device_share"] = round(
                    (v.get("device_s") or 0.0) / total_dev, 4)
            top.append(row)
        tiny = [w for w in (data.get("dispatch_profile") or [])
                if w.get("tiny_flush")]
        # the static on-chip memory view: variants whose dispatch recorded
        # an estimate, shown against the budget — how close a kernel is
        # to a refused launch belongs next to its roofline class
        budget = smem_budget(data.get("device_kind") or "")
        vm_rows = []
        for v in variants:
            est = v.get("vmem_est_bytes")
            if est is None:
                continue
            b = v.get("vmem_budget_bytes") or budget
            vm_rows.append({
                "variant": v.get("variant"),
                "vmem_est_bytes": est,
                "vmem_budget_bytes": b,
                "vmem_utilization": (round(est / b, 4) if b else None),
            })
        # per-pool section (the fleet): pool idleness is a first-class
        # number. Prefer the dump's own pools rollup; reconstruct it from
        # pool-labelled lane rows for dumps written mid-transition.
        pools = [dict(p) for p in (data.get("pools") or [])]
        if not pools:
            by_pool: Dict[str, List[Dict[str, Any]]] = {}
            for lrow in (data.get("lanes") or []):
                p = lrow.get("pool")
                if p:
                    by_pool.setdefault(p, []).append(lrow)
            for p, rows in sorted(by_pool.items()):
                duties = [r.get("duty_cycle") or 0.0 for r in rows]
                pools.append({
                    "pool": p,
                    "lanes": [r.get("lane") for r in rows],
                    "duty_cycle_min": round(min(duties), 6),
                    "duty_cycle_mean": round(sum(duties) / len(duties), 6),
                })
        fam = {"prefill": ("prefill",), "decode": ("decode", "resident")}
        for prow in pools:
            # each pool's variant family grouped out of the same device-
            # time table: role-typed pools partition the variant names,
            # so the share split is exact in fleet mode
            fams = fam.get(str(prow.get("pool")))
            if not fams:
                continue
            pv = [v for v in variants
                  if str(v.get("variant") or "").startswith(fams)]
            dev = sum(v.get("device_s") or 0.0 for v in pv)
            prow["device_s"] = round(dev, 6)
            if total_dev > 0:
                prow["device_share"] = round(dev / total_dev, 4)
            prow["top_variants"] = [v.get("variant") for v in pv[:3]]
        dumps.append({
            "path": path,
            "node": data.get("node"),
            "platform": data.get("platform"),
            "device_kind": data.get("device_kind"),
            "peaks": data.get("peaks"),
            "mfu": data.get("mfu"),
            "device_s_total": round(total_dev, 6),
            "top_variants": top,
            "lanes": data.get("lanes"),
            "pools": pools,
            "tiny_flush_waves": data.get("tiny_flush_waves", 0),
            "tiny_flush_rows": tiny,
            "vmem_budget_bytes": budget,
            "vmem_variants": vm_rows,
        })
    return {
        "kind": "swarmdb.obs.roofline",
        "version": 1,
        "dumps": dumps,
    }


# --------------------------------------------------------------- self-check


def _synthetic_trace(queue_ms: float, prefill_ms: float, decode_ms: float,
                     n: int = 16) -> List[Dict[str, Any]]:
    events = []
    t = 0.0
    for i in range(n):
        rid = f"r{i}"
        events.append({"name": "engine.admit", "ph": "X", "ts": t,
                       "dur": queue_ms * 1e3, "args": {"rid": rid}})
        t += queue_ms * 1e3
        events.append({"name": "engine.prefill", "ph": "X", "ts": t,
                       "dur": prefill_ms * 1e3, "args": {"rid": rid}})
        t += prefill_ms * 1e3 + 2 * _WAVE_GAP_US
        events.append({"name": "engine.decode_chunk", "ph": "X", "ts": t,
                       "dur": decode_ms * 1e3, "args": {"rid": rid}})
        events.append({"name": "engine.host_sync", "ph": "X", "ts": t,
                       "dur": 100.0, "args": None})
        t += decode_ms * 1e3
        events.append({"name": "stage.done", "ph": "X", "ts": t,
                       "dur": 0.0, "args": {"rid": rid}})
    return events


def self_check() -> Dict[str, Any]:
    """Run the pipeline on synthetic data and verify its invariants;
    raises AssertionError on any violation (``--self-check``)."""
    base = summarize_trace(_synthetic_trace(5.0, 10.0, 20.0))
    test = summarize_trace(_synthetic_trace(400.0, 80.0, 25.0))
    verdict = diagnose(base, test)
    shares_sum = sum(verdict["shares"].values())
    assert abs(shares_sum - 1.0) < 1e-3, shares_sum  # 4dp rounding
    assert verdict["dominant"] == "admission_serialization", verdict
    assert verdict["regressed"] is True
    assert set(verdict["shares"]) == set(CONTRIBUTORS)
    # flat A/B: schema-stable, still sums to 1; without flight evidence
    # the whole queue wait stays on admission_serialization (pre-split
    # behavior — what the online sentinel keeps seeing)
    flat = diagnose(base, base)
    assert flat["regressed"] is False
    assert abs(sum(flat["shares"].values()) - 1.0) < 1e-3
    assert flat["shares"]["capacity_wait"] == 0.0
    # with flight evidence of FULL occupancy while queued, the own-mix
    # queue wait is capacity, not admission serialization
    busy_flight = summarize_flight({
        "steps": [{"active": 8, "max_batch": 8, "queued": 5,
                   "occ_at_admit": True, "prompt_tokens": 0,
                   "prefill_padding_tokens": 0, "host_syncs": 0},
                  {"active": 8, "max_batch": 8, "queued": 7,
                   "occ_at_admit": True, "prompt_tokens": 100,
                   "prefill_padding_tokens": 0, "host_syncs": 1}],
        "requests": [],
    })
    assert busy_flight["admission_stall_frac"] == 0.0
    assert busy_flight["stall_evidence"] is True
    split = diagnose(base, base, test_flight=busy_flight)
    assert split["shares"]["admission_serialization"] == 0.0
    assert split["shares"]["capacity_wait"] > 0.0
    # a REGRESSED pair with busy-occupancy evidence puts the queue
    # growth on capacity, not the admission machinery; without the
    # post-admission marker the growth stays on admission (the legacy
    # fixture behavior)
    grow = diagnose(base, test, None, busy_flight)
    assert grow["regressed"] is True
    assert grow["shares"]["admission_serialization"] < 0.05
    assert grow["shares"]["capacity_wait"] > 0.5
    unmarked = dict(busy_flight, stall_evidence=False)
    legacy = diagnose(base, test, None, unmarked)
    assert legacy["dominant"] == "admission_serialization"
    # flight summary invariants on a synthetic imbalanced dump
    fl = summarize_flight({
        "steps": [
            {"active_by_shard": {"0": 8, "1": 0}, "prompt_tokens": 0,
             "prefill_padding_tokens": 0, "host_syncs": 0},
            {"active_by_shard": {"0": 8, "1": 0}, "prompt_tokens": 100,
             "prefill_padding_tokens": 25, "host_syncs": 2},
        ],
        "requests": [{"submitted_at": 0.0, "admitted_at": 0.5,
                      "first_token_at": 0.7, "retired_at": 1.0}],
    })
    assert fl["shard_imbalance"] == 2.0
    assert fl["padding_ratio"] == 0.25
    json.dumps(verdict)  # the whole report must be JSON-serializable
    return {"ok": True, "synthetic_diagnosis": verdict}


# --------------------------------------------------------------------- CLI


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swarmdb_tpu_torch.obs.analyze",
        description="Offline analyzer for swarmdb trace exports and "
                    "flight dumps: per-completion cost decomposition, "
                    "A/B regression attribution (shares sum to 1), "
                    "shard imbalance / padding / host-sync signals.")
    ap.add_argument("paths", nargs="*",
                    help="trace exports and/or flight dumps; with two "
                         "traces the first is the base of the A/B")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the full report to PATH")
    ap.add_argument("--self-check", action="store_true",
                    help="run the pipeline on synthetic data and verify "
                         "its invariants")
    ap.add_argument("--roofline", action="store_true",
                    help="device-time roofline report over profile dumps "
                         "(profile_*.json): top device-time variants, "
                         "MFU, compute- vs memory-bound, lane duty "
                         "cycles, tiny ragged flush waves")
    ap.add_argument("--memory", action="store_true",
                    help="memory-accounting report over mem dumps "
                         "(mem_*.json): pool occupancy + residency ages, "
                         "conversation temperature, sampled miss-ratio "
                         "curve, warm-tier / cold-resume models, "
                         "tier_validation and the sizing verdict")
    args = ap.parse_args(argv)

    if args.self_check:
        result = self_check()
        print(json.dumps(result["synthetic_diagnosis"], indent=2))
        print("analyze self-check: ok")
        return 0
    if not args.paths:
        ap.error("no input files (or use --self-check)")
    try:
        if args.memory:
            report = memory_report(args.paths)
        elif args.roofline:
            report = roofline_report(args.paths)
        else:
            report = analyze_files(args.paths)
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(f"analyze: {exc}", file=sys.stderr)
        return 2
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
