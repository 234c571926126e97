"""The port's SLO sentinel against the JAX package's (``obs/sentinel.py``).

Hand-built windows (the JAX package's own test windows: a healthy one,
an admission-serialized one, idle ones) go through both sentinels'
deterministic ``ingest`` core, and counter deltas through both window
closes: the alerts must name the same dominant contributor with shares
within 1e-9, breach the same SLOs and agree on ``status()``'s keys. The
port's alert writes its flight and trace dumps tagged with the alert id.
``GET /admin/slo`` answers 403 to a user and the JAX package's keys to
the admin, and ``/metrics`` carries the ``swarmdb_slo_*`` gauges and the
six histogram blocks.
"""

import asyncio
import json
import os
import time
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer

from swarmdb_tpu.api.app import ApiConfig as JApiConfig
from swarmdb_tpu.api.app import create_app as jcreate_app
from swarmdb_tpu.broker.local import LocalBroker as JBroker
from swarmdb_tpu.core.runtime import SwarmDB as JSwarmDB
from swarmdb_tpu.obs import TRACER as JTRACER
from swarmdb_tpu.obs import FlightRecorder as JFlight
from swarmdb_tpu.obs.sentinel import SLOConfig as JConfig
from swarmdb_tpu.obs.sentinel import SLOSentinel as JSentinel
from swarmdb_tpu.utils.metrics import MetricsRegistry as JMetrics
from swarmdb_tpu_torch.api.app import ApiConfig, create_app
from swarmdb_tpu_torch.broker.local import LocalBroker
from swarmdb_tpu_torch.core.runtime import SwarmDB
from swarmdb_tpu_torch.obs import TRACER, FlightRecorder
from swarmdb_tpu_torch.obs.sentinel import SLOConfig, SLOSentinel
from swarmdb_tpu_torch.utils.metrics import MetricsRegistry

HEALTHY = {
    "completed": 20,
    "per_completion_ms": {"queue_wait": 5.0, "prefill": 10.0,
                          "decode": 20.0, "host_sync": 0.5},
    "mean_ms": {"queue_wait": 5.0, "prefill": 10.0,
                "decode": 2.0, "host_sync": 0.1},
    "admission_waves": 10,
    "mean_wave_size": 2.0,
    "p95_ttft_s": 0.25,
    "p95_queue_wait_s": 0.05,
}
SERIALIZED = {
    "completed": 18,
    "per_completion_ms": {"queue_wait": 900.0, "prefill": 80.0,
                          "decode": 25.0, "host_sync": 0.6},
    "mean_ms": {"queue_wait": 900.0, "prefill": 40.0,
                "decode": 2.1, "host_sync": 0.1},
    "admission_waves": 9,
    "mean_wave_size": 2.0,
    "p95_ttft_s": 5.0,
    "p95_queue_wait_s": 2.5,
}
# host-sync and decode growth with a retry storm and a slow handoff
HOST_BOUND = {
    "completed": 12,
    "per_completion_ms": {"queue_wait": 6.0, "prefill": 11.0,
                          "decode": 60.0, "host_sync": 90.0},
    "retried": 9,
    "p95_ttft_s": 1.0,
    "p95_queue_wait_s": 0.01,
    "handoff_p95_ms": 400.0,
}

PKGS = {"jax": (JConfig, JSentinel, JMetrics, JFlight, JTRACER),
        "torch": (SLOConfig, SLOSentinel, MetricsRegistry, FlightRecorder,
                  TRACER)}


def make(pkg, tmp_path, **overrides):
    Config, Sentinel, Metrics, Flight, tracer = PKGS[pkg]
    cfg = Config(window_s=10.0, warmup_windows=1, min_completions=8,
                 ttft_p95_s=2.5, queue_p95_s=1.0, cost_growth_x=2.0,
                 max_alerts=64, enabled=True)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    flight = Flight(n_steps=16, n_requests=16, n_events=16)
    flight.record_step({"ts": time.time(), "active": 2, "queued": 7})
    flight.record_request({"rid": "r-seed", "submitted_at": 1.0,
                           "admitted_at": 1.9, "first_token_at": 2.0,
                           "retired_at": 2.5})
    d = tmp_path / pkg
    return Sentinel(metrics=Metrics(), config=cfg, flight=flight,
                    tracer=tracer, flight_dir=str(d)), d


def _alert_view(alert):
    if alert is None:
        return None
    return (alert["dominant"], sorted(b["slo"] for b in alert["breaches"]),
            alert["diagnosis"]["regressed"], alert["diagnosis"]["shares"],
            alert["window"]["cost_growth_x"])


@pytest.mark.parametrize("windows", [
    [HEALTHY, SERIALIZED, HEALTHY],
    [dict(HEALTHY, completed=2), HEALTHY,
     dict(SERIALIZED, completed=3), SERIALIZED],
    [HEALTHY, HOST_BOUND, HEALTHY, HOST_BOUND],
], ids=["serialized", "idle-windows", "host-bound"])
def test_ingest_alerts_equal_jax(windows, tmp_path, monkeypatch):
    monkeypatch.delenv("SWARMDB_FLIGHT_DIR", raising=False)
    out = {}
    for pkg in PKGS:
        sent, _ = make(pkg, tmp_path)
        alerts = [sent.ingest(dict(w)) for w in windows]
        st = sent.status()
        out[pkg] = (alerts, st, sent.baseline, sent.breached,
                    sent.windows_total, sent.alerts_total)
    (jal, jst, jbase, *jrest), (tal, tst, tbase, *trest) = \
        out["jax"], out["torch"]
    assert trest == jrest and tbase == jbase
    assert set(tst) == set(jst)
    assert set(tst["config"]) == set(jst["config"])
    assert tst["last_window"] == jst["last_window"]
    for ja, ta in zip(jal, tal):
        assert (ta is None) == (ja is None)
        if ta is None:
            continue
        jv, tv = _alert_view(ja), _alert_view(ta)
        assert tv[:3] == jv[:3] and tv[4] == jv[4]
        assert set(tv[3]) == set(jv[3])
        for c in jv[3]:
            assert abs(tv[3][c] - jv[3][c]) <= 1e-9
        assert abs(sum(tv[3].values()) - 1.0) < 1e-3
        assert set(ta) == set(ja)
    assert any(a is not None for a in tal)


def test_alert_dumps_flight_and_trace_tagged_with_its_id(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("SWARMDB_FLIGHT_DIR", str(tmp_path / "torch"))
    sent, d = make("torch", tmp_path)
    assert sent.ingest(HEALTHY) is None and sent.baseline is not None
    alert = sent.ingest(SERIALIZED)
    assert alert["dominant"] == "admission_serialization"
    assert {b["slo"] for b in alert["breaches"]} == {
        "ttft_p95_s", "queue_wait_p95_s", "cost_growth_x"}
    assert alert["id"] in os.path.basename(alert["flight_dump"])
    dump = json.loads(Path(alert["flight_dump"]).read_text())
    assert dump["reason"] == alert["id"] and dump["steps"]
    trace = json.loads(Path(alert["trace_dump"]).read_text())
    assert trace["metadata"]["alert_id"] == alert["id"]
    ring = json.loads(next(d.glob("slo_alerts_*.json")).read_text())
    assert ring["alerts_total"] == 1
    assert ring["alerts"][0]["id"] == alert["id"]
    assert sent.ingest(HEALTHY) is None and sent.breached is False


def test_window_close_from_counters_equals_jax(tmp_path, monkeypatch):
    """The online path: counter deltas between two forced closes become
    the same window in both packages. Both packages' device-time
    profilers and memory accountants are switched off for it: with them
    on, each window also carries what other engines of this process left
    in those process-global subsystems (their folds have tests of their
    own, tests/test_torch_profiler.py and tests/test_torch_memprof.py)."""
    import importlib

    # the modules, not the same-named functions obs/__init__ exports
    for pkg in ("swarmdb_tpu", "swarmdb_tpu_torch"):
        mp_mod = importlib.import_module(f"{pkg}.obs.memprof")
        prof_mod = importlib.import_module(f"{pkg}.obs.profiler")
        monkeypatch.setattr(prof_mod, "profile_enabled", lambda: False)
        monkeypatch.setattr(mp_mod, "memprof_enabled", lambda: False)
    out = {}
    for pkg in PKGS:
        sent, _ = make(pkg, tmp_path, min_completions=1)
        m = sent.metrics
        sent._deadline = 0.0
        sent.maybe_tick(now=1.0)                 # anchor close
        assert sent.windows_total == 0
        for name, n in (("engine_completed", 10), ("engine_admitted", 10),
                        ("engine_admission_waves", 5),
                        ("engine_host_syncs", 20), ("requests_retried", 2),
                        ("phase_us_queue_wait", 50_000),
                        ("phase_us_prefill", 100_000),
                        ("phase_us_decode", 200_000),
                        ("phase_us_host_sync", 5_000)):
            m.counters[name].inc(n)
        sent._deadline = 0.0
        sent.maybe_tick(now=2.0)
        w = dict(sent.last_window)
        for k in ("closed_at", "span_s"):
            w.pop(k)
        out[pkg] = (w, sent.windows_total, sent.baseline)
    assert out["torch"] == out["jax"]
    w = out["torch"][0]
    assert w["per_completion_ms"] == {"queue_wait": 5.0, "prefill": 10.0,
                                      "decode": 20.0, "host_sync": 0.5}
    assert w["retry_rate"] == 0.2 and w["mfu"] is None


def test_disabled_sentinel_never_closes(monkeypatch):
    monkeypatch.setenv("SWARMDB_SENTINEL", "0")
    sent = SLOSentinel(metrics=MetricsRegistry())
    assert sent.enabled is False
    sent._deadline = 0.0
    sent.maybe_tick(now=time.monotonic() + 100.0)
    assert sent.windows_total == 0 and sent.status()["enabled"] is False


def _drive(pkg, tmp_path, fn):
    DB = JSwarmDB if pkg == "jax" else SwarmDB
    Broker = JBroker if pkg == "jax" else LocalBroker
    make_app = jcreate_app if pkg == "jax" else create_app
    Cfg = JApiConfig if pkg == "jax" else ApiConfig

    async def run():
        db = DB(broker=Broker(), save_dir=str(tmp_path / pkg))
        client = TestClient(TestServer(make_app(db, Cfg(
            jwt_secret_key="s", rate_limit_per_minute=10_000))))
        await client.start_server()
        try:
            hdrs = {}
            for user in ("u", "admin"):
                r = await client.post("/auth/token", json={
                    "username": user, "password": "pw"})
                hdrs[user] = {"Authorization":
                              f"Bearer {(await r.json())['access_token']}"}
            return await fn(client, db, hdrs)
        finally:
            await client.close()
            db.close()

    return asyncio.run(run())


def test_admin_slo_and_metrics_gauges_match_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("SWARMDB_FLIGHT_DIR", raising=False)

    async def fn(client, db, hdrs):
        r = await client.get("/admin/slo", headers=hdrs["u"])
        user_status = r.status
        db.sentinel.config.warmup_windows = 1
        db.sentinel.enabled = True
        db.sentinel.ingest(dict(HEALTHY))
        db.sentinel.ingest(dict(SERIALIZED))
        r = await client.get("/admin/slo?tick=1", headers=hdrs["admin"])
        slo = await r.json()
        text = await (await client.get("/metrics")).text()
        return user_status, r.status, slo, text

    out = {pkg: _drive(pkg, tmp_path, fn) for pkg in PKGS}
    (ju, ja, jslo, jtext), (tu, ta, tslo, ttext) = out["jax"], out["torch"]
    assert (tu, ta) == (ju, ja) == (403, 200)
    assert set(tslo) == set(jslo)
    assert set(tslo["config"]) == set(jslo["config"])
    assert tslo["breached"] is jslo["breached"] is True
    assert tslo["alerts"][0]["dominant"] == jslo["alerts"][0]["dominant"]
    assert set(tslo["alerts"][0]) == set(jslo["alerts"][0])

    def slo_lines(text):
        return [ln.split(" ")[0] for ln in text.splitlines()
                if "swarmdb_slo_" in ln]

    def hist_types(text):
        return sorted(ln for ln in text.splitlines()
                      if ln.startswith("# TYPE") and "histogram" in ln)

    assert slo_lines(ttext) == slo_lines(jtext)
    assert "swarmdb_slo_breached 1" in ttext
    assert 'swarmdb_slo_per_completion_ms{category="queue_wait"}' in ttext
    assert hist_types(ttext) == hist_types(jtext) and len(
        hist_types(ttext)) == 6


def test_exemplar_resolves_via_trace_export(tmp_path):
    """A tail TTFT bucket's exemplar opens the request's timeline through
    /admin/slo's export link."""
    from swarmdb_tpu_torch.obs.metrics import HIST_TTFT

    rid = "req-exemplar-torch"
    t0 = time.time() - 45.0
    TRACER.span_at("engine.admit", t0, t0 + 44.0, cat="engine", rid=rid)
    HIST_TTFT.observe(45.0, rid)

    async def fn(client, db, hdrs):
        slo = await (await client.get("/admin/slo",
                                      headers=hdrs["admin"])).json()
        entry = next(e for e in slo["exemplars"]["ttft_seconds"]
                     if e["trace_id"] == rid)
        trace = await (await client.get(entry["export"],
                                        headers=hdrs["admin"])).json()
        text = await (await client.get("/metrics")).text()
        return entry, trace, text

    entry, trace, text = _drive("torch", tmp_path, fn)
    assert entry["le"] == "60" and entry["value_s"] == pytest.approx(45.0)
    assert entry["export"] == f"/admin/trace/export?trace_id={rid}"
    assert rid in {(e.get("args") or {}).get("rid")
                   for e in trace["traceEvents"] if e.get("ph") == "X"}
    assert f'# {{trace_id="{rid}"}}' in text
