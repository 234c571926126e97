"""The port's offline analyzer against the JAX package's
(``obs/analyze.py``).

The same trace exports and flight dumps -- the repository's checked-in
ones, and a trace and flight dump that the port's own paged engine emits
on the CPU -- must give equal ``summarize_trace``, ``summarize_flight``,
``diagnose`` and ``analyze_files`` output in both packages. Files are
copied into a fresh directory first: the JAX package's report also lists
profile and sanitizer dumps lying beside its inputs, whose readers the
port does not have yet. ``self_check()`` passes, and the CLI runs.
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from swarmdb_tpu.obs import analyze as ja
from swarmdb_tpu_torch.obs import analyze as ta

REPO = Path(__file__).resolve().parent.parent
LOGS = REPO / "bench_logs"
SETS = {
    # the regression pair with its flight dumps (base first)
    "r05-pair": ["dpserve_dp1_trace_r05.json", "dpserve_dp8_trace_r05.json",
                 "flight_1785852451827_bench_dpserve_dp1.json",
                 "flight_1785852414700_bench_dpserve_dp8.json"],
    # the resident-loop pair, whose flights carry occ_at_admit
    "r07-pair": ["dpserve_dp1_trace_r07.json", "dpserve_dp8_trace_r07.json",
                 "flight_dpserve_dp1_r07.json", "flight_dpserve_dp8_r07.json"],
    # one trace alone, and one with a flight dump
    "solo": ["tooluse_trace.json"],
    "solo-flight": ["tooluse_trace.json",
                    "flight_1785852372489_bench_tooluse.json"],
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _copy(names, tmp_path):
    out = []
    for name in names:
        dst = tmp_path / name
        shutil.copy(LOGS / name, dst)
        out.append(str(dst))
    return out


@pytest.mark.parametrize("name", sorted(SETS))
def test_analyze_files_equals_jax(name, tmp_path):
    paths = _copy(SETS[name], tmp_path)
    report = ta.analyze_files(paths)
    assert report == ja.analyze_files(paths)
    diag = report["diagnosis"]
    assert set(diag["shares"]) == set(ta.CONTRIBUTORS)
    assert abs(sum(diag["shares"].values()) - 1.0) < 5e-3
    if name.endswith("pair"):
        assert diag["regressed"] is True
    for path in paths:
        kind, data = ta.load_file(path)
        jkind, jdata = ja.load_file(path)
        assert kind == jkind
        if kind == "trace":
            assert ta.summarize_trace(data) == ja.summarize_trace(jdata)
        else:
            assert ta.summarize_flight(data) == ja.summarize_flight(jdata)


def test_diagnose_equals_jax_on_synthetic_summaries():
    base = ta.summarize_trace(ta._synthetic_trace(5.0, 10.0, 20.0))
    for q, p, d in ((400.0, 80.0, 25.0), (5.0, 10.0, 20.0),
                    (1.0, 90.0, 80.0), (2.0, 3.0, 4.0)):
        test = ta.summarize_trace(ta._synthetic_trace(q, p, d))
        assert test == ja.summarize_trace(ja._synthetic_trace(q, p, d))
        for flight in (None, {"stall_evidence": True,
                              "admission_stall_frac": 0.25,
                              "shard_imbalance": 0.5}):
            assert ta.diagnose(base, test, None, flight) == \
                ja.diagnose(base, test, None, flight)
            assert ta._solo_diagnosis(test, flight) == \
                ja._solo_diagnosis(test, flight)
            assert ta._queue_split(q, flight) == ja._queue_split(q, flight)
            assert ta._attribute(base, test, None, flight) == \
                ja._attribute(base, test, None, flight)


def test_engine_trace_and_flight_analyze_as_in_jax(tmp_path):
    """What the port's engine writes (a trace export and a flight dump
    of a short paged serve) reads the same through both analyzers."""
    from swarmdb_tpu_torch.backend.sampling import SamplingParams
    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.obs import TRACER

    TRACER.reset()
    eng, tok = build_backend_engine("tiny-debug", max_batch=2, max_seq=64,
                                    paged=True, page_size=8, decode_chunk=4,
                                    device="cpu")
    eng.start()
    try:
        for i in range(3):
            eng.generate_sync(tok.encode(f"prompt {i} " * (i + 1)),
                              SamplingParams(max_new_tokens=6))
        deadline = time.time() + 10
        while eng._any_active() and time.time() < deadline:
            time.sleep(0.01)
    finally:
        eng.stop()
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps(TRACER.to_chrome_trace()))
    flight = eng.flight.dump_to(str(tmp_path), "test")
    report = ta.analyze_files([str(trace), flight])
    assert report == ja.analyze_files([str(trace), flight])
    summary = report["summary"]
    assert summary["span_counts"]["queue_wait"] == 3
    assert summary["span_counts"]["prefill"] == 3
    assert summary["span_counts"]["decode"] >= 3
    assert summary["span_counts"]["host_sync"] >= 3
    assert summary["flight"]["requests"] == 3
    assert summary["flight"]["stall_evidence"] is True
    assert summary["flight"]["decode_kernels"] == ["paged_decode_chunked"]


def test_self_check_and_cli(tmp_path):
    assert ta.self_check()["ok"] is True
    out = subprocess.run(
        [sys.executable, "-m", "swarmdb_tpu_torch.obs.analyze",
         "--self-check"], cwd=str(REPO), capture_output=True, text=True,
        timeout=60)
    assert out.returncode == 0 and "self-check: ok" in out.stdout
    paths = _copy(SETS["r05-pair"][:2], tmp_path)
    report_path = tmp_path / "report.json"
    out = subprocess.run(
        [sys.executable, "-m", "swarmdb_tpu_torch.obs.analyze", *paths,
         "--json", str(report_path)], cwd=str(REPO), capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(report_path.read_text()) == ja.analyze_files(paths)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"kind": "swarmdb.profile"}))
    out = subprocess.run(
        [sys.executable, "-m", "swarmdb_tpu_torch.obs.analyze", str(bad)],
        cwd=str(REPO), capture_output=True, text=True, timeout=60)
    assert out.returncode == 2 and "not a Chrome trace" in out.stderr
