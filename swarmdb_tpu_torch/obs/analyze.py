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

The readers of the device-time profiler's, the memory accountant's and
the sanitizers' dumps (``--roofline``, ``--memory``, the lockcheck /
pagecheck / kerncheck listings) come with the subsystems that write
them (ROADMAP.md, queue 1 items 10b and 10c). ``--self-check`` runs the
pipeline on synthetic traces and checks its own invariants.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["analyze_files", "summarize_trace", "summarize_flight",
           "diagnose", "self_check", "main"]

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
    flight-recorder dump; raises ValueError for anything else."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict) and "traceEvents" in data:
        return "trace", [e for e in data["traceEvents"]
                         if e.get("ph") == "X"]
    if isinstance(data, dict) and "steps" in data and "requests" in data:
        return "flight", data
    raise ValueError(f"{path}: not a Chrome trace export (traceEvents) "
                     "or a flight dump (steps/requests)")


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
    inputs = []
    for path in paths:
        kind, data = load_file(path)
        inputs.append({"path": path, "kind": kind})
        if kind == "trace":
            traces.append((path, summarize_trace(data)))
        else:
            flights.append((path, summarize_flight(data)))
    if not traces:
        raise ValueError("need at least one Chrome trace export")
    report: Dict[str, Any] = {
        "kind": "swarmdb.obs.analyze",
        "version": 1,
        "inputs": inputs,
    }
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
    args = ap.parse_args(argv)

    if args.self_check:
        result = self_check()
        print(json.dumps(result["synthetic_diagnosis"], indent=2))
        print("analyze self-check: ok")
        return 0
    if not args.paths:
        ap.error("no input files (or use --self-check)")
    try:
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
