"""One run of one cell on the card it is started on.

    python3 -m swarmbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (timed as ``setup_s`` from the process's start): the seeded weights
drawn on the card, SwarmDB and the serving service built and started, one
warm-up burst of the cell's own first messages (every agent at once, a
short reply each). Then the window: the cell's agents in closed loops for
``--seconds``; every message sent in it is awaited. With ``--trace 1`` the
window runs exactly so, the profiler not yet loaded, and the per-layer
metrics of the host, the stamps and the counters are read from it; then,
the engine idle, the profiler is prepared and a traced stretch follows
(fresh sessions of the same mix for ``drive.LEAD_S`` seconds, then
``drive.TRACE_S`` profiled, then drained), which the device metrics
read. Then the peak memory is read, the program is stopped and freed,
and the plain reference judges the window's run.

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer ones), ``device``
(``--trace 1``: with ``busy_s`` and ``window_s``), ``breakdown`` with
``--trace 1``, and last ``checks``: each number compared with its limit,
also the last lines of standard error. Without a card, or with fewer
cards than the cell asks for, the run fails and prints no result; so it
does when the process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

#: Top-level modules the process must not hold once the window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "swarmdb_tpu")


def process_start() -> float:
    """This process's start on the ``time.time`` clock (Linux: its start
    in clock ticks since boot)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        since = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks
        return time.time() - since
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = process_start()


def checkout_dirs(root: str) -> str:
    """Every cache and file a run writes stays under ``.swarmbench`` in
    the checkout, at fixed paths. Returns the runs' directory."""
    base = os.path.join(root, ".swarmbench")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(base, "cache", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(base, "cache", "triton"))
    # a library that would load JAX by itself (transformers) must not
    os.environ.setdefault("USE_FLAX", "0")
    return os.path.join(base, "run")


def log(msg: str) -> None:
    print(f"swarmbench: {time.time() - T_PROCESS:8.2f} s {msg}",
          file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(cell, seed: int, seconds: float, trace: bool, device,
        run_dir: str, t_process: float) -> Dict[str, Any]:
    """Set up, measure, judge; returns the result line's object."""
    import torch

    from . import correct, drive, spec
    from .devtrace import DeviceTrace
    from .traffic import Traffic
    from .view import RunView, agent_view

    os.makedirs(run_dir, exist_ok=True)
    mix = cell.mix
    on_card = device.type == "cuda"
    log("program imported")
    system = drive.System(cell.config_name, cell.config, seed, device,
                          run_dir)
    system.assistants(int(mix["assistants"]))
    log("weights drawn, service started")
    burst = dict(mix, start_spread_s=0.0, agents=mix["warmup_agents"])
    drive.drive(system, Traffic(mix, seed, stream=1), burst, time.time(),
                0.5, reply_tokens=int(mix["warmup_reply_tokens"]))
    t0 = time.time()
    setup_s = t0 - t_process
    log("warm-up burst served; the window opens")
    window = drive.drive(system, Traffic(mix, seed), mix, t0, seconds)
    log(f"window closed, {len(window.requests)} requests awaited; "
        f"{system.db.sentinel.alerts_total} SLO alerts")
    stretch = None
    if trace:
        tracer = DeviceTrace()
        tracer.prepare()
        log("profiler prepared; the traced stretch starts")
        stretch = drive.drive(system, Traffic(mix, seed, stream=2), mix,
                              time.time(), drive.LEAD_S + drive.TRACE_S,
                              tracer=tracer)
        log(f"traced stretch drained and read, {len(stretch.requests)} "
            f"requests; stopping and reading the trace took "
            f"{stretch.trace.read_s if stretch.trace else 0:.1f} s")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    pool = {"pages": system.pool_pages(), "page_bytes": system.page_bytes,
            "peak_pages_held": window.pages_peak[0],
            "peak_evictable": window.pages_peak[1]}
    dims = system.dims
    system.close()
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        log(f"program freed: {torch.cuda.memory_allocated(device)} bytes "
            f"still allocated, peak {peak}")
    log(f"KV pool: {pool['peak_pages_held']} of {pool['pages']} pages held "
        f"at the peak ({pool['peak_evictable']} of them the prefix cache's "
        f"evictable), {pool['page_bytes']} bytes a page")

    view = RunView(dims, window, stretch)
    values = correct.structural(window)
    lim = cell.limits
    sample = correct.pick(view.reqs, int(lim["sample_requests"]),
                          int(lim["sample_tokens"]), seed)
    gaps = correct.logit_gaps(dims, seed, device, sample)
    log(f"reference ran over {len(sample)} requests")
    values["max_logit_gap"] = max((g for g, _ in gaps), default=1e9)
    checks = correct.judge(values, lim["checks"])

    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        e2e = dict(agent_view(view), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            got = spec.reader(m["name"])(view)
            if got is None:
                continue
            entry = got if isinstance(got, dict) else {"value": got}
            metrics[m["name"]] = dict(entry, unit=m["unit"])

    attempted = len(view.reqs)
    failed = sum(not correct.finished(r) for r in view.reqs)
    dev: Dict[str, Any] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": (torch.cuda.get_device_name(device) if on_card
                 else "cpu"),
        "count": cell.chips if on_card else 0,
        "memory_peak_bytes": int(peak),
    }
    result: Dict[str, Any] = {
        "correct": correct.passed(checks),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if view.trace is not None:
        dev["busy_s"] = view.trace.busy_s
        dev["window_s"] = view.trace.window_s
        result["breakdown"] = {"device_ops": view.trace.device_ops,
                               "idle_gaps": view.trace.idle_gaps}
        log(f"profiler's effect, window (off) against the traced stretch "
            f"(recording): {view.profiler_effect()}")
    result["kv_pool"] = pool
    result["checks"] = {k: {"value": v, "limit": l}
                        for k, (v, l) in checks.items()}
    result["sample"] = [[r.turn, len(r.prompt), r.generated, g]
                        for r, (g, _) in zip(sample, gaps)]
    return result


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="swarmbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    root = os.getcwd()
    run_dir = checkout_dirs(root)
    from . import spec

    cell = spec.cell(os.path.join(root, "BENCHMARK.json"), args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"swarmbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"swarmbench: {args.workload} seed {args.seed} on "
          f"{power_limit()}", file=sys.stderr)
    result = run(cell, args.seed, args.seconds, bool(args.trace), device,
                 os.path.join(run_dir, args.workload), T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"swarmbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    sample = result.pop("sample")
    checks = result.pop("checks")
    result["checks"] = checks
    print(f"swarmbench: sample (turn, prompt, generated, gap) {sample}",
          file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
