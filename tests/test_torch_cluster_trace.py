"""Cluster-wide tracing tests of the port: the cases of
``tests/test_cluster_trace.py`` (the port's nodes, server and CPU engine),
plus spans that cross between the packages' data planes.

Units: trace-context wire roundtrip, data-plane propagation, the
replication G frame, and the multi-node Chrome-trace merge.

Acceptance: a streamed request sent through the remote data-plane
client during a scripted leader kill produces a SINGLE merged trace
from ``GET /admin/cluster/trace`` containing client, data-plane,
broker, and engine spans from >= 2 node processes plus the promotion
instant — parsed and asserted event by event.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer

from swarmdb_tpu_torch.api.app import ApiConfig, create_app
from swarmdb_tpu_torch.broker.local import LocalBroker
from swarmdb_tpu_torch.core.runtime import SwarmDB
from swarmdb_tpu_torch.ha import (ClusterBroker, FileClusterMap, RemoteBroker,
                            data_plane_opener, wait_until)
from swarmdb_tpu_torch.ha.dataplane import DataPlaneServer
from swarmdb_tpu_torch.obs import TRACER, propagate

REPO = Path(__file__).resolve().parent.parent
CFG = ApiConfig(jwt_secret_key="test-secret", rate_limit_per_minute=100_000)

SUSPECT_S = 1.0
DEAD_S = 2.0
HEARTBEAT_S = 0.1
# convergence deadline: several times the expected time on a machine
# loaded by the other test workers
WAIT_S = 30.0
PROMOTE_BUDGET_S = DEAD_S + 6 * SUSPECT_S


# ------------------------------------------------------------------- units


def test_trace_context_wire_roundtrip():
    ctx = propagate.TraceContext("trace-1", origin="node-a")
    wire = propagate.inject(ctx)
    assert wire == {"t": "trace-1", "s": ctx.span_id, "o": "node-a"}
    back = propagate.extract(wire)
    assert back.trace_id == "trace-1" and back.origin == "node-a"
    # malformed wire forms never raise
    assert propagate.extract(None) is None
    assert propagate.extract({"t": 7}) is None
    assert propagate.extract("nope") is None
    # thread-local activation nests and restores
    assert propagate.current() is None
    with propagate.use(ctx):
        assert propagate.current() is ctx
        with propagate.use(None):
            assert propagate.current() is ctx  # None = passthrough
    assert propagate.current() is None


def test_merge_chrome_traces_reanchors_and_dedups():
    def trace(anchor, pid, name, ts):
        return {
            "traceEvents": [
                {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": "swarmdb_tpu_torch"}},
                {"name": name, "cat": "x", "ph": "X", "pid": pid,
                 "tid": 1, "ts": ts, "dur": 5.0},
            ],
            "metadata": {"anchor_epoch_s": anchor},
        }

    # node B's anchor is 1s later: its ts must shift +1e6 us in the merge
    merged = propagate.merge_chrome_traces([
        ("a", trace(1000.0, 1, "ev-a", 100.0)),
        ("b", trace(1001.0, 2, "ev-b", 100.0)),
        ("a-dup", trace(1000.0, 1, "ev-a", 100.0)),  # shared-ring dedup
    ])
    evs = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    assert [(e["name"], e["ts"]) for e in evs] == [
        ("ev-a", 100.0), ("ev-b", 100.0 + 1e6)]
    assert merged["metadata"]["anchor_epoch_s"] == 1000.0
    assert merged["metadata"]["nodes"] == ["a", "b", "a-dup"]
    # process_name rows survive once per pid, labeled per node
    procs = [e for e in merged["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"]
    assert {p["args"]["name"] for p in procs} == {"swarmdb_tpu:a",
                                                  "swarmdb_tpu:b"}


def test_data_plane_propagates_trace_context():
    """A traced client op must land a dataplane.<op> span under the same
    trace id on the serving node, and trace_export must return it."""
    TRACER.reset()
    broker = LocalBroker()
    server = DataPlaneServer(lambda: broker, node_id="dp-test").start()
    rb = RemoteBroker(server.addr, timeout_s=5.0)
    try:
        rb.create_topic("t", 1)
        ctx = propagate.TraceContext("trace-dp", origin="client-proc")
        with propagate.use(ctx):
            off = rb.append("t", 0, b"payload")
        assert off == 0
        names = {e["name"] for e in TRACER.events_for("trace-dp")}
        assert "dataplane.append" in names  # server side
        assert "dataplane.call" in names    # client side
        server_spans = [e for e in TRACER.events_for("trace-dp")
                        if e["name"] == "dataplane.append"]
        assert server_spans[0]["args"]["origin"] == "client-proc"
        assert server_spans[0]["args"]["node"] == "dp-test"
        # untraced ops stay untraced (no context active): the quiet
        # append must not add events under the trace id
        seen_before = len(TRACER.events_for("trace-dp"))
        rb.append("t", 0, b"quiet")
        assert len(TRACER.events_for("trace-dp")) == seen_before
        out = rb.trace_export(trace_id="trace-dp")
        assert out["node"] == "dp-test"
        exported = [e for e in out["trace"]["traceEvents"]
                    if e.get("ph") == "X"]
        assert {"dataplane.append", "dataplane.call"} <= {
            e["name"] for e in exported}
        for e in exported:
            assert (e.get("args", {}).get("rid") == "trace-dp"
                    or e.get("cat") == "ha")
    finally:
        rb.close()
        server.stop()
        broker.close()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_trace_context_crosses_between_the_packages(server_pkg):
    """A port client traced into a JAX data plane, and a JAX client into
    the port's: the serving side records ``dataplane.append`` under the
    caller's trace id and origin, and ``trace_export`` returns it with
    ``dataplane_rtt_seconds`` observed on the client."""
    from swarmdb_tpu.broker.local import LocalBroker as JaxLocalBroker
    from swarmdb_tpu.ha.dataplane import DataPlaneServer as JaxServer
    from swarmdb_tpu.ha.dataplane import RemoteBroker as JaxRemote
    from swarmdb_tpu.obs import TRACER as JAX_TRACER
    from swarmdb_tpu.obs import propagate as jax_propagate
    from swarmdb_tpu.obs.metrics import HIST_DATAPLANE_RTT as JAX_RTT
    from swarmdb_tpu_torch.obs.metrics import HIST_DATAPLANE_RTT

    if server_pkg == "port":
        broker, server_cls, server_tracer = LocalBroker(), DataPlaneServer, \
            TRACER
        client_cls, client_prop, rtt = JaxRemote, jax_propagate, JAX_RTT
    else:
        broker, server_cls, server_tracer = JaxLocalBroker(), JaxServer, \
            JAX_TRACER
        client_cls, client_prop, rtt = RemoteBroker, propagate, \
            HIST_DATAPLANE_RTT
    TRACER.reset()
    JAX_TRACER.reset()
    server = server_cls(lambda: broker, node_id="dp-x").start()
    rb = client_cls(server.addr, timeout_s=5.0)
    try:
        rb.create_topic("t", 1)
        before = rtt.total
        with client_prop.use(client_prop.TraceContext("trace-x",
                                                      origin="caller")):
            assert rb.append("t", 0, b"payload") == 0
        assert rtt.total > before
        spans = [e for e in server_tracer.events_for("trace-x")
                 if e["name"] == "dataplane.append"]
        assert spans and spans[0]["args"]["origin"] == "caller"
        assert spans[0]["args"]["node"] == "dp-x"
        out = rb.trace_export(trace_id="trace-x")
        assert out["node"] == "dp-x"
        assert "dataplane.append" in {
            e["name"] for e in out["trace"]["traceEvents"]
            if e.get("ph") == "X"}
    finally:
        rb.close()
        server.stop()
        broker.close()


def test_replication_g_frame_marks_follower_apply():
    """A traced leader append ships a G frame; the follower's ring gains
    a replica.apply instant under the same trace id."""
    from swarmdb_tpu_torch.broker.replica import ReplicaServer, ReplicatedBroker

    TRACER.reset()
    follower = LocalBroker()
    server = ReplicaServer(follower).start()
    leader = ReplicatedBroker(LocalBroker(),
                              [f"{server.host}:{server.port}"],
                              allow_no_targets=True)
    try:
        leader.create_topic("t", 1)
        ctx = propagate.TraceContext("trace-repl", origin="leader-proc")
        with propagate.use(ctx):
            off = leader.append("t", 0, b"v")
        assert leader.wait_durable("t", 0, off, WAIT_S)
        wait_until(
            lambda: any(e["name"] == "replica.apply"
                        for e in TRACER.events_for("trace-repl")),
            WAIT_S, what="replica.apply instant from the G frame")
        ev = next(e for e in TRACER.events_for("trace-repl")
                  if e["name"] == "replica.apply")
        assert ev["args"]["origin"] == "leader-proc"
    finally:
        leader.close()
        server.stop()
        follower.close()


def test_replication_commit_histogram_observes():
    from swarmdb_tpu_torch.broker.replica import ReplicaServer, ReplicatedBroker
    from swarmdb_tpu_torch.obs.metrics import HIST_REPLICATION_COMMIT

    follower = LocalBroker()
    server = ReplicaServer(follower).start()
    leader = ReplicatedBroker(LocalBroker(),
                              [f"{server.host}:{server.port}"],
                              allow_no_targets=True)
    try:
        leader.create_topic("t", 1)
        before = HIST_REPLICATION_COMMIT.snapshot()["count"]
        off = leader.append("t", 0, b"v")
        assert leader.wait_durable("t", 0, off, WAIT_S)
        assert HIST_REPLICATION_COMMIT.snapshot()["count"] == before + 1
    finally:
        leader.close()
        server.stop()
        follower.close()


# -------------------------------------------------------------- acceptance


def _spawn_node(procs, tmp_path, cluster_path, env, node_id, role):
    proc = subprocess.Popen(
        [sys.executable, "-m", "swarmdb_tpu_torch.ha.node",
         "--node-id", node_id, "--role", role,
         "--log-dir", str(tmp_path / node_id),
         "--cluster", cluster_path,
         "--listen", "127.0.0.1:0", "--liveness", "127.0.0.1:0",
         "--data", "127.0.0.1:0",
         "--advertise-host", "127.0.0.1",],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(REPO), env=env)
    line = proc.stdout.readline()
    assert line.startswith(f"HA_NODE_READY {node_id}"), line
    procs[node_id] = proc
    return proc


@pytest.mark.skipif(sys.platform == "win32", reason="POSIX signals")
def test_cluster_trace_merges_failover_across_processes(tmp_path):
    """streamed request through the remote data
    plane, scripted leader SIGKILL mid-run, one merged trace from
    /admin/cluster/trace with client + data-plane + broker + engine
    spans from >= 2 processes and the promotion instant."""
    from swarmdb_tpu_torch.backend.service import ServingService

    env = dict(os.environ,
               SWARMDB_HA_SUSPECT_S=str(SUSPECT_S),
               SWARMDB_HA_DEAD_S=str(DEAD_S),
               SWARMDB_HA_HEARTBEAT_S=str(HEARTBEAT_S),
               JAX_PLATFORMS="cpu")
    cluster_path = str(tmp_path / "cluster.json")
    procs = {}
    TRACER.reset()
    _spawn_node(procs, tmp_path, cluster_path, env, "p0", "leader")
    _spawn_node(procs, tmp_path, cluster_path, env, "p1", "follower")
    cmap = FileClusterMap(cluster_path)
    wait_until(lambda: cmap.read()["leader"] == "p0", WAIT_S,
               what="subprocess bootstrap")
    wait_until(lambda: all(
        (cmap.read()["nodes"].get(n) or {}).get("data_addr")
        for n in ("p0", "p1")), WAIT_S, what="data planes registered")

    broker = ClusterBroker(cmap, data_plane_opener(timeout_s=2.0),
                           refresh_s=0.05)
    db = SwarmDB(broker=broker, save_dir=str(tmp_path / "hist"),
                 autosave_interval=1e9)
    svc = ServingService.from_model_name(
        db, "tiny-debug", backend_id="gpu-0", device="cpu",
        max_batch=2, max_seq=64, decode_chunk=2)
    svc.start()

    async def drive():
        app = create_app(db, CFG, serving=svc)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/auth/token", json={
                "username": "alice", "password": "pw"})
            hdrs = {"Authorization":
                    f"Bearer {(await r.json())['access_token']}"}
            r = await client.post("/auth/token", json={
                "username": "admin", "password": "pw"})
            admin = {"Authorization":
                     f"Bearer {(await r.json())['access_token']}"}

            async def stream_message(text):
                r = await client.post("/messages", json={
                    "receiver_id": "assistant", "content": text,
                    "stream": True,
                    "metadata": {"generation": {"max_new_tokens": 6,
                                                "temperature": 0.0}},
                }, headers=hdrs)
                if r.status != 200:
                    return None
                body = await r.text()
                first = next((l for l in body.splitlines()
                              if l.startswith("data: ") and '"id"' in l),
                             None)
                return (json.loads(first[len("data: "):])["id"]
                        if first else None)

            # pre-kill streamed request proves the remote plumbing
            msg_a = await stream_message("hello across the data plane")
            assert msg_a, "pre-kill streamed request failed"

            # scripted leader kill while the stack is live
            procs["p0"].send_signal(signal.SIGKILL)
            procs["p0"].wait(timeout=10)
            deadline = time.monotonic() + 6 * PROMOTE_BUDGET_S
            while time.monotonic() < deadline:
                if cmap.read().get("leader") == "p1":
                    break
                await asyncio.sleep(0.05)
            assert cmap.read()["leader"] == "p1", "no promotion"

            # the retried request lands on the promoted follower: its
            # broker/data-plane spans now come from p1's process
            msg_b = None
            deadline = time.monotonic() + 30.0
            while msg_b is None and time.monotonic() < deadline:
                msg_b = await stream_message("hello to the new leader")
                if msg_b is None:
                    await asyncio.sleep(0.2)
            assert msg_b, "post-failover streamed request never landed"

            r = await client.get("/admin/cluster/trace", headers=admin)
            assert r.status == 200
            merged = await r.json()

            # trace_id filter: one request's merged cross-process trace
            r = await client.get(
                f"/admin/cluster/trace?trace_id={msg_b}", headers=admin)
            assert r.status == 200
            filtered = await r.json()
            return merged, filtered, msg_b
        finally:
            await client.close()

    try:
        merged, filtered, msg_b = asyncio.run(drive())
    finally:
        svc.stop()
        db.close()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)

    events = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    names = {e["name"] for e in events}
    # client-side spans (this process)
    assert {"api.request", "runtime.send", "broker.publish",
            "serve.request"} <= names, names
    # engine spans (this process's serving engine)
    assert {"engine.admit", "engine.prefill",
            "engine.decode_chunk"} <= names, names
    # data-plane spans from the node processes
    assert any(n.startswith("dataplane.") for n in names), names
    # the promotion instant, recorded in p1's ring, made the merge
    promoted = [e for e in events if e["name"] == "ha.promoted"]
    assert promoted, "promotion instant missing from the merged trace"
    # >= 2 distinct processes contributed span events
    pids = {e["pid"] for e in events}
    assert len(pids) >= 2, f"merged trace spans only {pids}"
    # p1's dataplane spans carry msg_b's trace id — the cross-process
    # join for the post-failover request
    local_pid = os.getpid()
    remote_b = [e for e in events
                if e["name"] == "dataplane.append"
                and (e.get("args") or {}).get("rid") == msg_b
                and e["pid"] != local_pid]
    assert remote_b, "no node-side span under the failover trace id"
    assert merged["metadata"]["nodes"], merged["metadata"]
    # dead leader is skipped, not fatal
    assert isinstance(merged["metadata"]["unreachable"], list)

    # the filtered view: msg_b's spans + HA instants only
    fevents = [e for e in filtered["traceEvents"] if e.get("ph") == "X"]
    assert fevents
    for e in fevents:
        assert ((e.get("args") or {}).get("rid") == msg_b
                or e.get("cat") == "ha"), e
    fnames = {e["name"] for e in fevents}
    assert {"runtime.send", "broker.publish"} <= fnames
    assert any(n.startswith("dataplane.") for n in fnames)
    assert any(e["name"] == "ha.promoted" for e in fevents)
