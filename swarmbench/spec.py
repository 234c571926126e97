"""A cell of ``BENCHMARK.json`` and the files it is found by.

- the configuration: the ``file`` its ``configs`` entry names;
- the traffic mix: ``mixes/<traffic>.json``;
- the correctness limits: ``limits/<workload>.json``;
- each per-layer metric: ``metrics/<name>.py``, whose ``read(run)``
  returns the metric's value (or a dict with its ``value`` and further
  keys), or None when it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic: str
    mix: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def cell(bench_path: str, workload: str) -> Cell:
    """The cell ``workload`` of the benchmark file at ``bench_path``."""
    bench = load_json(bench_path)
    root = os.path.dirname(os.path.abspath(bench_path))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def applies(m: Dict[str, Any]) -> bool:
        return workload in m.get("workloads", [workload])

    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"],
        config=load_json(os.path.join(root, conf["file"])),
        traffic=w["traffic"],
        mix=load_json(os.path.join(HERE, "mixes", w["traffic"] + ".json")),
        limits=load_json(os.path.join(HERE, "limits", workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def reader(metric: str) -> Callable:
    """``read`` of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "swarmbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_names(group: str) -> List[str]:
    """Every kernel named in ``metrics/kernels/<group>/*.txt`` (one base
    name a line; ``#`` starts a comment): a kernel that takes over a
    metric's work adds a file here."""
    folder = os.path.join(HERE, "metrics", "kernels", group)
    names: List[str] = []
    for f in sorted(os.listdir(folder)):
        if f.endswith(".txt"):
            with open(os.path.join(folder, f)) as fh:
                for line in fh:
                    line = line.split("#", 1)[0].strip()
                    if line:
                        names.append(line)
    return names
