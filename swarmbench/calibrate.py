"""The two readings a cell's ``max_logit_gap`` limit is set from.

    python3 -m swarmbench.calibrate --workload <cell> --seconds <s> \\
        --seeds <n,n,...> --control-seeds <k> [--set mix.agents=1 ...]

For each seed, in one process: the cell's system is built from the seed,
warmed up and driven for a short window at the cell's own load; then, once
the program is freed, the run's sample is judged by the plain reference
(the program's reading) and, on the first ``k`` seeds, by the fp8 control
put in the program's place on the same prompts and tokens (the control's
reading: at each position the gap of the token the control puts first).
Each reading is judged as a run is, by ``correct.judge`` against the
cell's committed limits (``correct`` for the program, ``control_correct``
for the control in its place, which has to come out false). One JSON line
per seed on standard output, then a summary: the largest program reading,
the smallest control reading, their ratio, and how many of each were
judged correct.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time

from .run import checkout_dirs, log


def calibrate_seed(cell, seed: int, seconds: float, control: bool, device,
                   run_dir: str):
    import torch

    from . import correct, drive
    from .traffic import Traffic

    mix = cell.mix
    system = drive.System(cell.config_name, cell.config, seed, device,
                          run_dir)
    system.assistants(int(mix["assistants"]))
    drive.drive(system, Traffic(mix, seed, stream=1),
                dict(mix, start_spread_s=0.0, agents=mix["warmup_agents"]),
                time.time(), 0.5,
                reply_tokens=int(mix["warmup_reply_tokens"]))
    window = drive.drive(system, Traffic(mix, seed), mix, time.time(),
                         seconds)
    dims = system.dims
    system.close()
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reqs = [r for r in window.requests if r.in_window]
    lim = cell.limits
    sample = correct.pick(reqs, int(lim["sample_requests"]),
                          int(lim["sample_tokens"]), seed)
    gaps = correct.logit_gaps(dims, seed, device, sample, control=control)
    out = dict(correct.structural(window))
    out.update(
        seed=seed, requests=len(reqs),
        served_tokens=sum(r.generated for r in sample),
        max_logit_gap=max(g for g, _ in gaps),
        per_request=[[r.turn, len(r.prompt), r.generated, g, c]
                     for r, (g, c) in zip(sample, gaps)])
    checks = lim.get("checks", {})
    out["correct"] = correct.passed(correct.judge(
        {k: v for k, v in out.items() if k in checks}, checks))
    if control:
        out["control_gap"] = max(c for _, c in gaps)
        values = dict(correct.structural(window),
                      max_logit_gap=out["control_gap"])
        out["control_correct"] = correct.passed(
            correct.judge(values, checks))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="swarmbench.calibrate")
    p.add_argument("--workload", required=True,
                   help="a cell of BENCHMARK.json, or with --config and "
                   "--traffic the name of a cell that is not (yet) there")
    p.add_argument("--config", help="a configuration file, for a cell "
                   "not in BENCHMARK.json")
    p.add_argument("--traffic", help="a mix under mixes/, with --config")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--set", action="append", default=[],
                   metavar="mix.KEY=N|engine.KEY=N",
                   help="run the cell with one mix or engine number "
                   "changed (a witness run, not a limit's reading)")
    args = p.parse_args(argv)
    root = os.getcwd()
    run_dir = checkout_dirs(root)
    from . import spec

    if args.config:
        conf = spec.load_json(args.config)
        cell = spec.Cell(
            name=args.workload, chips=1, config_name=conf["name"],
            config=conf, traffic=args.traffic,
            mix=spec.load_json(os.path.join(spec.HERE, "mixes",
                                            args.traffic + ".json")),
            limits={"sample_requests": 8, "sample_tokens": 600},
            end_to_end=[], per_layer=[])
    else:
        cell = spec.cell(os.path.join(root, "BENCHMARK.json"),
                         args.workload)
    for item in args.set:
        key, value = item.split("=", 1)
        part, name = key.split(".", 1)
        if part == "mix":
            cell.mix = dict(cell.mix, **{name: int(value)})
        elif part == "engine":
            cell.config = dict(cell.config, engine=dict(
                cell.config["engine"], **{name: int(value)}))
        else:
            raise SystemExit(f"--set {item}: mix.KEY or engine.KEY")
    import torch

    if not torch.cuda.is_available():
        print("swarmbench.calibrate needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    lows, highs, runs = [], [], []
    for i, seed in enumerate(seeds):
        res = calibrate_seed(cell, seed, args.seconds,
                             i < args.control_seeds, device,
                             os.path.join(run_dir, "calibrate"))
        runs.append(res)
        lows.append(res["max_logit_gap"])
        if "control_gap" in res:
            highs.append(res["control_gap"])
        log(f"seed {seed} done")
        print(json.dumps(res), flush=True)
    low, high = max(lows), (min(highs) if highs else math.nan)
    print(json.dumps({"workload": args.workload, "set": args.set,
                      "seeds": len(seeds),
                      "program_max": low, "control_min": high,
                      "ratio": high / low if low > 0 else math.inf,
                      "program_correct": sum(r["correct"] for r in runs),
                      "control_correct": sum(
                          r.get("control_correct", False) for r in runs),
                      "controls": len(highs)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
