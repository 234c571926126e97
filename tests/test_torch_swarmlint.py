"""swarmlint for the port (``swarmdb_tpu_torch/analysis``) against the JAX
package's (``swarmdb_tpu/analysis``).

- The families copied as they are (lock-discipline, span-discipline,
  heartbeat-safety, retry-discipline, page-lifetime) give the JAX
  analyzer's (rule, line) findings on every fixture of
  ``tests/test_swarmlint.py``.
- The card's families: host syncs (``torch.cuda.synchronize``,
  ``.synchronize()``, ``.item()`` / ``.cpu()`` / ``if`` on a CUDA tensor,
  quieted by ``sanctioned-drain``, never in a loop), graph-capture hazards
  (SWL201 / 203 / 204) and capture leaks (SWL401).
- Two faults of the JAX copy are not inherited: a ``**`` splat binds to
  no parameter (the JAX copy raises IndexError, or binds it to the last
  positional parameter), and a ``with`` in an ``except`` clause holds its
  lock.
- The port's tree is clean with no baseline; the CLI exits 0 from the
  repository root and from elsewhere; ``chip_smoke.py`` scans; the JAX
  package's directives are carried to the port's counterpart functions.
- A race the port's lint found is repaired: ``Engine.alive`` reads the
  loop thread once.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from swarmdb_tpu.analysis import analyze_file as jax_analyze_file
from swarmdb_tpu.analysis import pagelife as jax_pagelife
from swarmdb_tpu_torch.analysis import analyze_file, analyze_paths
from swarmdb_tpu_torch.analysis import pagelife
from swarmdb_tpu_torch.analysis.callgraph import CallGraph
from swarmdb_tpu_torch.analysis.core import (DEFAULT_BASELINE, RULES,
                                             SourceFile, expand_rule_names,
                                             load_baseline_entries)
from swarmdb_tpu_torch.analysis.explain import EXPLAIN

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "swarmdb_tpu_torch"
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "lint"
COPIED = expand_rule_names(["lock-discipline", "span-discipline",
                            "heartbeat-safety", "retry-discipline",
                            "page-lifetime"])
COPIED_FIXTURES = [
    "lock_bad.py", "span_bad.py", "metrics_bad.py", "exemplar_bad.py",
    "profile_bad.py", "memprof_bad.py", "heartbeat_bad.py", "fence_bad.py",
    "retry_bad.py", "deadlock_bad.py", "deadlock_ok.py", "guarded_bad.py",
    "callback_lock_bad.py", "lockwait_snapshot.py", "pageleak_bad.py",
    "page_uaf_bad.py", "page_doublefree_bad.py", "pin_bad.py",
    "pagelife_snapshot.py", "replica_prefix_snapshot.py", "clean.py",
]


@pytest.fixture(scope="module")
def port_findings():
    """One scan of the port's tree, without a baseline."""
    return analyze_paths([str(PORT)])


def rules_at(text: str, tmp_path: Path, name: str = "snippet.py"):
    path = tmp_path / name
    path.write_text(text)
    return sorted((f.rule, f.line) for f in analyze_file(str(path)))


def line_of(text: str, marker: str) -> int:
    return next(i for i, ln in enumerate(text.splitlines(), 1)
                if marker in ln)


@pytest.mark.parametrize("name", COPIED_FIXTURES)
def test_copied_families_agree_with_jax(name):
    path = str(FIXTURES / name)
    want = {(f.rule, f.line) for f in jax_analyze_file(path, select=COPIED)}
    got = {(f.rule, f.line) for f in analyze_file(path, select=COPIED)}
    assert got == want
    if name not in ("clean.py", "deadlock_ok.py"):
        assert got, f"{name} seeds findings of a copied family"


HOST_SYNC = '''
import numpy as np
import torch


class Eng:
    # swarmlint: device-state: _last, cache

    def __init__(self):
        self._last = torch.zeros(8, device="cuda")
        self.cache = None
        self._host = np.zeros(8)

    # swarmlint: hot
    def step(self, out, ev):
        torch.cuda.synchronize()  # S101a
        ev.synchronize()  # S101b
        n = self._last.item()  # M1
        rows = self._last[:4].cpu()  # M2
        arr = np.asarray(self._last + 1)  # M3
        if self._last[0] > 3:  # M4
            pass
        t = torch.ones(4, device="cuda")
        v = t.tolist()  # M5
        w = t.to("cpu")  # M6
        ok = self._host[0] > 1
        if ok and self.cache is None:
            pass
        shape = self._last.shape[0]
        # swarmlint: sanctioned-drain -- the chunk's one wait
        out.event.synchronize()
        toks = self._last.numpy()  # swarmlint: sanctioned-drain
        for i in range(3):
            ev.synchronize()  # L1
            while not ev.query():  # L2
                pass
            # swarmlint: sanctioned-drain -- never in a loop
            self._last.cpu()  # L3
        return n, rows, arr, v, w, ok, shape, toks

    def cold(self):
        torch.cuda.synchronize()
        return self._last.item()
'''


def test_host_sync_rules_know_the_cards_syncs(tmp_path):
    got = rules_at(HOST_SYNC, tmp_path)
    want = sorted(
        [("SWL101", line_of(HOST_SYNC, m)) for m in ("S101a", "S101b")]
        + [("SWL102", line_of(HOST_SYNC, f"M{i}")) for i in range(1, 7)]
        + [("SWL105", line_of(HOST_SYNC, f"L{i}")) for i in range(1, 4)])
    assert got == want


GRAPHS = '''
import torch


class ChunkRunner:
    def __init__(self, body, io):
        self.body = body

    def capture_all(self):
        pass

    def launch(self, v):
        pass


class Good:
    def __init__(self):
        self._runner = ChunkRunner(self._chunk_body, None)

    def warmup(self):
        self._runner.capture_all()

    def serve(self):
        self._runner.launch(0)

    def _chunk_body(self, v):
        self._io.block.copy_(self._forward(self._io.tokens))


class Cold:
    def __init__(self):
        self._runner = ChunkRunner(self._body2, None)
        self.graph = torch.cuda.CUDAGraph()

    def warmup(self):
        pass

    def serve(self):
        self._runner.launch(0)  # G203a
        self.graph.replay()  # G203b

    def _body2(self, v):
        mask = torch.zeros(len(self._live), device="cuda")  # G204
        self._scratch = mask * 2  # C401a
        return mask


def per_call(fn):
    for _ in range(3):
        g = torch.cuda.CUDAGraph()  # G201a
        with torch.cuda.graph(g):  # G201c
            fn()


# swarmlint: hot
def hot_capture(fn):
    g = torch.cuda.CUDAGraph()  # G201b
    return g
'''


def test_graph_capture_rules(tmp_path):
    got = rules_at(GRAPHS, tmp_path)
    want = sorted([
        ("SWL201", line_of(GRAPHS, "G201a")),
        ("SWL201", line_of(GRAPHS, "G201b")),
        ("SWL201", line_of(GRAPHS, "G201c")),
        ("SWL203", line_of(GRAPHS, "G203a")),
        ("SWL203", line_of(GRAPHS, "G203b")),
        ("SWL204", line_of(GRAPHS, "G204")),
        ("SWL401", line_of(GRAPHS, "C401a")),
    ])
    assert got == want


LEAKS = '''
import torch

_LAST = None


class ChunkRunner:
    def __init__(self, body, io):
        self.body = body


class Eng:
    def __init__(self):
        self.cache = torch.zeros(4)
        self._flag = False
        self._runner = self._new_runner()

    def _new_runner(self):
        return ChunkRunner(self._chunk_body, None)

    def _chunk_body(self, v):
        global _LAST
        out = self.cache + 1
        _LAST = out  # C401b
        self._flag = True
        self.cache.copy_(out)

    def reset(self):
        self.cache = torch.zeros(4)
        self._runner = self._new_runner()

    def grow(self):
        self.cache = torch.zeros(8)  # C401c

    def refill(self):
        self.cache.copy_(torch.ones(4))


def capture(g, x):
    with torch.cuda.graph(g):
        y = x * 2
        x.copy_(y)
'''


def test_capture_leaks(tmp_path):
    got = rules_at(LEAKS, tmp_path)
    assert got == sorted([("SWL401", line_of(LEAKS, "C401b")),
                          ("SWL401", line_of(LEAKS, "C401c"))])


SPLAT = '''
def env_scope(**values):
    return dict(values)


def emit(phase, **fields):
    return phase, fields


def caller(values, fields):
    emit("x", **fields)
    return env_scope(**values)
'''


def test_a_kwargs_splat_binds_no_parameter(tmp_path):
    path = tmp_path / "splat.py"
    path.write_text(SPLAT)
    with pytest.raises(IndexError):
        jax_analyze_file(str(path))       # the JAX copy's fault
    assert analyze_file(str(path)) == []
    src = SourceFile(str(path))
    graph = CallGraph([src])
    emit = next(f for f in graph.functions.values() if f.name == "emit")
    call = next(n for n in ast.walk(src.tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", "") == "emit")
    assert jax_pagelife._param_of_arg(call, -1, None, emit) == "phase"
    assert pagelife._param_of_arg(call, -1, None, emit) is None
    assert pagelife._param_of_arg(call, -1, "k", emit) == "k"
    assert pagelife._param_of_arg(call, 0, None, emit) == "phase"


EXCEPT_WITH = '''
import threading


class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = {}

    def put(self, k, v):
        with self._lock:
            self._items = dict(self._items, **{k: v})

    def get(self, k):
        with self._lock:
            return self._items.get(k)

    def drop(self, k):
        try:
            return k + 1
        except TypeError:
            with self._lock:
                self._items = {}  # held
'''


def test_a_with_in_an_except_clause_holds_its_lock(tmp_path):
    path = tmp_path / "exc.py"
    path.write_text(EXCEPT_WITH)
    jax = [(f.rule, f.line) for f in jax_analyze_file(str(path))]
    assert jax == [("SWL303", line_of(EXCEPT_WITH, "# held"))]
    assert analyze_file(str(path)) == []


def test_port_tree_is_clean_without_a_baseline(port_findings):
    assert [f.render() for f in port_findings] == []
    assert load_baseline_entries(DEFAULT_BASELINE) == []


@pytest.mark.parametrize("where", ["root", "elsewhere"])
def test_cli_exits_zero_from_any_directory(where, tmp_path):
    cwd = ROOT if where == "root" else tmp_path
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "swarmdb_tpu_torch.analysis",
                          "--select", "host-sync,graph-capture,"
                          "capture-leak,kernel-check"],
                         cwd=str(cwd), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert out.stdout.strip().endswith("swarmlint: clean")


def test_chip_smoke_scans_where_the_jax_copy_raises():
    path = str(ROOT / "chip_smoke.py")
    assert analyze_file(path) == []
    with pytest.raises(IndexError):
        jax_analyze_file(path)


def test_every_rule_explained_and_void_ones_say_so():
    assert set(EXPLAIN) == set(RULES)
    void = {"SWL202", "SWL205", "SWL901", "SWL902", "SWL904", "SWL905"}
    for rid in void:
        assert RULES[rid].summary.startswith("not applicable on the card")
        assert EXPLAIN[rid]["doc"].startswith("Not applicable on the card")
    for rid in set(RULES) - void:
        assert "not applicable" not in RULES[rid].summary


def _directives(path: Path):
    """{(qualified function, directive)} of the ``# swarmlint:`` comments
    directly above (or on) each def of ``path``."""
    src = SourceFile(str(path))
    d = src.directives
    out = set()
    for node in ast.walk(src.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        name = src.qualname(node)
        if src.is_hot(node):
            out.add((name, "hot"))
        if src.is_heartbeat(node):
            out.add((name, "heartbeat"))
        if src.is_retry(node):
            out.add((name, "retry"))
        for g in src.held_guards(node):
            out.add((name, f"holds[{g}]"))
    assert d is not None
    return out


def _defs(path: Path):
    src = SourceFile(str(path))
    return {src.qualname(n) for n in ast.walk(src.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


@pytest.mark.parametrize("rel", [
    "backend/engine.py", "backend/service.py", "backend/supervisor.py",
    "core/runtime.py", "obs/lockcheck.py", "obs/memprof.py",
    "obs/metrics.py", "obs/pagecheck.py", "obs/profiler.py",
    "obs/sentinel.py", "ops/paged_kv.py"])
def test_jax_directives_carry_over(rel):
    """Each def-level directive of the JAX package whose function the
    port has (same module, same qualified name) is on the port's too."""
    jax_path = ROOT / "swarmdb_tpu" / rel
    port_path = PORT / rel
    port_defs = _defs(port_path)
    want = {(f, d) for f, d in _directives(jax_path) if f in port_defs}
    got = _directives(port_path)
    assert want, f"no JAX directive of {rel} has a port counterpart"
    assert want <= got, sorted(want - got)


def test_alive_reads_the_loop_thread_once():
    """``Engine.alive`` raced ``stop()``: it read ``_thread`` twice, and a
    stop clearing it in between made the supervisor's poll raise on
    ``None.is_alive()``. The JAX package's ``alive`` still reads twice."""
    import threading

    from swarmdb_tpu.backend.engine import Engine as JaxEngine
    from swarmdb_tpu_torch.backend.engine import Engine

    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()

    class Stopping:
        """The loop thread as a racing ``stop()`` leaves it: the first
        read sees the thread, every later one None."""
        reads = 0

        @property
        def _thread(self):
            self.reads += 1
            return t if self.reads == 1 else None

    with pytest.raises(AttributeError):
        JaxEngine.alive(Stopping())
    probe = Stopping()
    assert Engine.alive(probe) is False
    assert probe.reads == 1
