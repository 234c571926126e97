"""What the benchmark may import, and the runs it must refuse."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from swarmbench import run, spec

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)
#: the one module that drives the program
PROGRAM_SIDE = {"drive.py"}


def harness_files():
    for folder, _, files in os.walk(PKG):
        if os.path.basename(folder) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(folder, f)


def top_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(harness_files()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_imports(path):
    names = set(top_imports(path))
    assert not names & set(run.FORBIDDEN), names
    if os.path.basename(path) not in PROGRAM_SIDE:
        # the reference, the yardstick and the readers work out again
        # whatever the program derived: none of them imports it
        assert "swarmdb_tpu_torch" not in names, path


def test_forbidden_modules_compare_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "swarmdb_tpu_torch_probe.x", object())
    assert "swarmdb_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "swarmdb_tpu.probe", object())
    assert "swarmdb_tpu" in run.forbidden_modules()


def _bench(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "-m", "swarmbench.run", "--workload",
         "mistral7b.agent_sessions", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result():
    p = _bench(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_the_benchmark_files_alone_cannot_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / "swarmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _bench(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", "import swarmbench.drive"],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and "swarmdb_tpu_torch" in p.stderr


def test_a_new_mix_is_only_new_files(tmp_path):
    """A later cell adds a mix, its limits and a BENCHMARK.json entry; no
    file the benchmark has changes."""
    shutil.copytree(PKG, tmp_path / "swarmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read()
              for p in map(str, (tmp_path / "swarmbench").rglob("*"))
              if os.path.isfile(p)}
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    mix = json.load(open(os.path.join(PKG, "mixes", "agent_sessions.json")))
    mix.update(agents=16, turns=[2, 2])
    (tmp_path / "swarmbench" / "mixes" / "throwaway.json").write_text(
        json.dumps(mix))
    limits = json.load(open(os.path.join(
        PKG, "limits", "mistral7b.agent_sessions.json")))
    (tmp_path / "swarmbench" / "limits" /
     "mistral7b.throwaway.json").write_text(json.dumps(limits))
    bench["workloads"].append(
        {"name": "mistral7b.throwaway", "config": "mistral-7b-v0.3",
         "traffic": "throwaway", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    # the copy's spec module finds the copy's files
    code = ("import json, swarmbench.spec as s; "
            "c = s.cell('BENCHMARK.json', 'mistral7b.throwaway'); "
            "print(json.dumps([c.mix['agents'], c.config['name'], "
            "len(c.end_to_end), len(c.per_layer), c.limits['checks']]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    agents, conf, n_e2e, n_layer, checks = json.loads(p.stdout)
    assert (agents, conf) == (16, "mistral-7b-v0.3")
    assert n_e2e == len(bench["end_to_end"])
    assert checks == limits["checks"]
    for path, data in before.items():
        assert open(path, "rb").read() == data


def test_every_cell_finds_its_files():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        c = spec.cell(os.path.join(ROOT, "BENCHMARK.json"), w["name"])
        assert c.mix and c.limits["checks"]
        for m in c.per_layer:
            assert callable(spec.reader(m["name"]))
    for g in ("decode_attn", "prefill_attn"):
        assert spec.kernel_names(g)
