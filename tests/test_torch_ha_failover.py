"""HA control-plane fault-injection tests of the port
(``swarmdb_tpu_torch/ha/``): the cases of ``tests/test_ha_failover.py``,
plus nodes of both packages on one cluster map and the promotion race the
port repairs.

Every scenario is driven through ``ha/chaos.py`` — scripted kills,
partitions and heals against an in-process 3-node cluster — so the only
real sleeping is bounded by the detector thresholds under test (suspect
1.0 s / dead 2.0 s here, sized for a machine loaded by the other test
workers; the JAX copy's 0.3 / 0.6 s fail under that load; CPU-only, no
LLM backend, tier-1).

The acceptance matrix:

- leader kill under concurrent producers: a follower auto-promotes
  within the detector budget, acked-durable loss is exactly 0, and
  producers resume through the re-pointed ClusterBroker;
- deposed-leader fencing: a stale-epoch leader's appends are refused
  with the fencing epoch in the error, and its mirror connects get F
  frames;
- partition flap: exactly ONE promotion per failover — a flapping old
  leader can never seat a second one (epoch CAS + stand-down);
- offset preservation: consumer-group committed offsets and retention
  trims cross the replication stream, so a promoted follower serves
  groups from their committed offsets, not the log start;
- /metrics + /health + /admin/ha contract over a real HANode;
- the `python -m swarmdb_tpu_torch.ha.node` CLI end-to-end with subprocess
  nodes and a SIGKILLed leader (the compose-stack shape).

On failure the chaos event log + flight rings are dumped through the
flight recorder (SWARMDB_FLIGHT_DIR — the same artifact path CI uploads
engine dumps from).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from swarmdb_tpu_torch.broker.base import FencedError, LeaderChangedError
from swarmdb_tpu_torch.broker.local import LocalBroker
from swarmdb_tpu_torch.ha import (FileClusterMap, HANode, InMemoryClusterMap,
                            NodeBroker, build_local_cluster, probe_liveness,
                            read_log_epoch, wait_until)

REPO = Path(__file__).resolve().parent.parent

SUSPECT_S = 1.0
DEAD_S = 2.0
HEARTBEAT_S = 0.1
# convergence deadline: several times the expected time on a machine
# loaded by the other test workers
WAIT_S = 30.0
# kill -> confirmed-dead (DEAD_S) + candidate probing + CAS + client
# re-point; generous vs the ~0.7 s typically observed so a loaded CI
# worker doesn't flake, but still asserting "seconds, not operators"
PROMOTE_BUDGET_S = DEAD_S + 6 * SUSPECT_S


@pytest.fixture(autouse=True)
def _fast_heartbeat(monkeypatch):
    monkeypatch.setenv("SWARMDB_HA_HEARTBEAT_S", str(HEARTBEAT_S))


@pytest.fixture
def cluster3(request):
    """3-node in-process cluster + ClusterBroker client; dumps the chaos
    event log through the flight recorder if the test fails."""
    harness, cluster, client = build_local_cluster(
        ["n0", "n1", "n2"], suspect_s=SUSPECT_S, dead_s=DEAD_S,
        heartbeat_s=HEARTBEAT_S)
    wait_until(lambda: cluster.read()["leader"] == "n0", WAIT_S,
               what="bootstrap leader")
    try:
        yield harness, cluster, client
    finally:
        failed = getattr(request.node, "rep_call", None)
        if failed is not None and failed.failed:
            harness.flight.auto_dump(f"ha_test_{request.node.name}")
        harness.stop()
        client.close()


def _promotions(harness):
    return [ev for ev in harness.flight.events()
            if ev.get("kind") == "ha.promoted"]


def _wait_replicating(harness, leader, n=2):
    wait_until(
        lambda: len(harness.nodes[leader].broker_facade.replicators) == n,
        WAIT_S, what="followers adopted by the leader")


def test_leader_kill_zero_acked_loss(cluster3):
    """The headline: kill the leader under concurrent producers —
    promotion lands inside the detector budget, every acked-durable
    record survives on the new leader, and producers resume."""
    harness, cluster, client = cluster3
    client.create_topic("t", 1)
    _wait_replicating(harness, "n0")

    acked, acked_lock = [], threading.Lock()
    stop = threading.Event()
    resumed = threading.Event()
    killed = threading.Event()

    def produce(worker):
        i = 0
        while not stop.is_set():
            payload = f"w{worker}-m{i}"
            try:
                off = client.append("t", 0, payload.encode())
                if client.wait_durable("t", 0, off, 2.0):
                    with acked_lock:
                        acked.append(payload)
                    i += 1
                    if killed.is_set():
                        resumed.set()
            except LeaderChangedError:
                stop.wait(0.02)  # retryable: re-send the same payload

    threads = [threading.Thread(target=produce, args=(w,), daemon=True)
               for w in range(3)]
    for t in threads:
        t.start()
    wait_until(lambda: len(acked) >= 20, WAIT_S, what="steady-state acks")

    epoch_before = cluster.read()["epoch"]
    t_kill = time.monotonic()
    harness.kill("n0")
    killed.set()
    wait_until(lambda: cluster.read()["epoch"] > epoch_before,
               PROMOTE_BUDGET_S, what="promotion within detector budget")
    promote_s = time.monotonic() - t_kill
    wait_until(resumed.is_set, WAIT_S, what="producers resumed post-failover")
    stop.set()
    for t in threads:
        t.join(timeout=WAIT_S)

    assert promote_s < PROMOTE_BUDGET_S
    state = cluster.read()
    assert state["leader"] in ("n1", "n2")
    # zero acked loss: every acked payload is in the new leader's log
    survived = {r.value.decode() for r in client.fetch("t", 0, 0, 100000)}
    with acked_lock:
        lost = [p for p in acked if p not in survived]
    assert lost == [], (f"{len(lost)} acked-durable records lost", state,
                        harness.events)
    # exactly one failover promotion (plus the bootstrap one)
    promotions = _promotions(harness)
    assert len(promotions) == 2, (promotions, harness.events)


def test_deposed_leader_is_fenced(cluster3):
    """A partitioned-then-healed old leader must fail LOUD: appends raise
    FencedError carrying the new epoch, never fork a local-only log."""
    harness, cluster, client = cluster3
    client.create_topic("t", 1)
    _wait_replicating(harness, "n0")
    # acked by every follower before the partition, the topic included:
    # the JAX copy isolates without waiting and, under load, the winner
    # may not have the topic yet (UnknownTopicError after the failover)
    off = client.append("t", 0, b"before")
    assert client.wait_durable("t", 0, off, WAIT_S)

    epoch_before = cluster.read()["epoch"]
    harness.isolate("n0")
    wait_until(lambda: cluster.read()["epoch"] > epoch_before,
               PROMOTE_BUDGET_S, what="promotion past the partition")
    new_epoch = cluster.read()["epoch"]

    harness.heal("n0")
    old = harness.nodes["n0"]
    wait_until(lambda: old.role == "deposed", WAIT_S,
               what="old leader notices it was deposed")
    with pytest.raises(FencedError) as err:
        old.broker_facade.append("t", 0, b"stale-write")
    assert str(new_epoch) in str(err.value), (
        "fencing error must carry the fencing epoch")
    # the new leader keeps serving through the client re-point
    off = client.append("t", 0, b"after-failover")
    assert client.wait_durable("t", 0, off, WAIT_S)


def test_partition_flap_no_dueling_promotions(cluster3):
    """Flap the old leader's partition: the epoch CAS + the promotion
    loop's stand-down must produce exactly ONE new leader, and the epoch
    must not churn after convergence."""
    harness, cluster, client = cluster3
    client.create_topic("t", 1)
    _wait_replicating(harness, "n0")

    epoch_before = cluster.read()["epoch"]
    # scripted flap: partition the leader, heal it mid-detection, cut it
    # again — the detector must not promote off a half-healed blip, and
    # the healed old leader must never grab the cluster back
    harness.run_script([
        (0.0, "isolate", "n0"),
        (DEAD_S / 2, "heal", "n0"),
        (DEAD_S / 2 + 0.1, "isolate", "n0"),
    ])
    wait_until(lambda: cluster.read()["epoch"] > epoch_before,
               2 * PROMOTE_BUDGET_S, what="eventual promotion")
    state = cluster.read()
    winner, epoch = state["leader"], state["epoch"]
    assert winner in ("n1", "n2")

    harness.heal("n0")
    time.sleep(2 * DEAD_S)  # would-be dueling promotions get their shot
    state = cluster.read()
    assert state["leader"] == winner, "leadership flapped after failover"
    assert state["epoch"] == epoch, "epoch churned after failover"
    assert len(_promotions(harness)) == 2  # bootstrap + exactly one


def test_consumer_offsets_and_trims_survive_failover(cluster3):
    """Committed offsets and
    retention trims now cross the stream, so a promoted follower serves
    groups from their replicated offsets — not the log beginning."""
    harness, cluster, client = cluster3
    client.create_topic("t", 1)
    _wait_replicating(harness, "n0")
    for i in range(40):
        # two timestamp eras so the trim has a meaningful cutoff
        off = client.append("t", 0, f"m{i}".encode(),
                            timestamp=1000.0 if i < 10 else 2000.0)
    # followers fully mirrored BEFORE the trim: trimming records a
    # follower has not seen yet would (correctly) gap the partition
    assert client.wait_durable("t", 0, off, WAIT_S)
    client.commit_offset("workers", "t", 0, 30)
    client.trim_older_than("t", 1500.0)

    def follower_converged(nid):
        b = harness.nodes[nid].broker
        return (b.committed_offset("workers", "t", 0) == 30
                and b.begin_offset("t", 0) >= 10)

    wait_until(lambda: follower_converged("n1") and follower_converged("n2"),
               WAIT_S, what="commit+trim replication")

    harness.kill("n0")
    wait_until(lambda: cluster.read()["leader"] in ("n1", "n2"),
               PROMOTE_BUDGET_S, what="promotion")
    # the group resumes where it committed, on whichever node won
    assert client.committed_offset("workers", "t", 0) == 30
    assert client.begin_offset("t", 0) >= 10
    # records past the committed offset are all there
    got = [r.value.decode() for r in client.fetch("t", 0, 30, 100)]
    assert got == [f"m{i}" for i in range(30, 40)]


def test_remote_data_plane_client_survives_failover(cluster3):
    """Cross-process client shape: a ClusterBroker over the TCP data
    plane (RemoteBroker) — NOT the in-process facade — writes through
    the leader node, so its appends replicate and survive a leader kill.
    (A second engine handle over the leader's log dir would snapshot at
    open and bypass replication entirely — the data plane is the fix.)"""
    from swarmdb_tpu_torch.ha import ClusterBroker, data_plane_opener

    harness, cluster, _ = cluster3
    remote = ClusterBroker(cluster, data_plane_opener(timeout_s=2.0),
                           refresh_s=0.05)
    try:
        remote.create_topic("t", 1)
        _wait_replicating(harness, "n0")
        acked = []
        for i in range(20):
            off = remote.append("t", 0, f"r{i}".encode())
            if remote.wait_durable("t", 0, off, WAIT_S):
                acked.append(f"r{i}")
        assert len(acked) == 20
        remote.commit_offset("workers", "t", 0, 15)
        # the remote write landed in the NODE's engine (not a client-side
        # one): the leader's own broker has it, and so do the followers
        assert harness.nodes["n0"].broker.end_offset("t", 0) == 20
        wait_until(lambda: all(
            harness.nodes[n].broker.end_offset("t", 0) == 20
            and harness.nodes[n].broker.committed_offset("workers", "t", 0)
            == 15 for n in ("n1", "n2")),
            WAIT_S, what="replication of remote appends + commit")

        harness.kill("n0")
        wait_until(lambda: cluster.read()["leader"] in ("n1", "n2"),
                   PROMOTE_BUDGET_S, what="promotion")
        # writes resume against the new leader's data plane (retryable
        # mid-failover, never lost)
        deadline = time.monotonic() + WAIT_S
        sent = False
        while not sent:
            assert time.monotonic() < deadline, "post-failover append"
            try:
                remote.append("t", 0, b"post-failover")
                sent = True
            except LeaderChangedError:
                time.sleep(0.05)
        survived = {r.value.decode() for r in remote.fetch("t", 0, 0, 1000)}
        assert set(acked) <= survived
        assert "post-failover" in survived
        assert remote.committed_offset("workers", "t", 0) == 15
    finally:
        remote.close()


def test_consumer_group_continuity_across_partition_move():
    """committed offsets and retention trims are
    served by a partition's NEW leader from the replicated C/X state —
    not log start — after a leadership MOVE (no node died, the
    assignment just changed hands)."""
    from swarmdb_tpu_torch.ha import tp_key

    harness, cluster, client = build_local_cluster(
        ["n0", "n1", "n2"], suspect_s=SUSPECT_S, dead_s=DEAD_S,
        heartbeat_s=HEARTBEAT_S, partition_leadership=True)
    try:
        wait_until(lambda: cluster.read()["leader"] == "n0", WAIT_S,
                   what="bootstrap leader")
        client.create_topic("t", 3)
        wait_until(lambda: len(cluster.read()["assignments"]) == 3, WAIT_S,
                   what="assignment")
        part = 0
        deadline = time.monotonic() + WAIT_S
        off = -1
        for i in range(40):
            while True:
                try:
                    off = client.append(
                        "t", part, f"m{i}".encode(),
                        timestamp=1000.0 if i < 10 else 2000.0)
                    break
                except LeaderChangedError:
                    assert time.monotonic() < deadline
                    time.sleep(0.02)
        assert client.wait_durable("t", part, off, WAIT_S)

        def mirrored(nid):
            try:
                return harness.nodes[nid].broker.end_offset("t", part) == 40
            except Exception:
                return False

        # every node holds the 40 records before the trim: quorum acks
        # cover two nodes of three, and a trim that reaches a node before
        # the records it cuts leaves that node's head behind for good
        # (the JAX copy races this, and times out under load)
        wait_until(lambda: all(mirrored(n) for n in ("n0", "n1", "n2")),
                   WAIT_S, what="all 40 records on every node")
        client.commit_offset("workers", "t", part, 30)
        client.trim_older_than("t", 1500.0)
        old_leader = cluster.read()["assignments"][tp_key("t", part)]

        def converged(nid):
            b = harness.nodes[nid].broker
            try:
                return (b.committed_offset("workers", "t", part) == 30
                        and b.begin_offset("t", part) >= 10)
            except Exception:
                return False

        followers = [n for n in ("n0", "n1", "n2")
                     if n != old_leader["leader"]]
        wait_until(lambda: all(converged(n) for n in followers), WAIT_S,
                   what="C/X replication to every peer")

        # MOVE the leadership (epoch CAS, no failure involved)
        target = followers[0]
        assert cluster.try_promote_partition(
            "t", part, target, old_leader["epoch"] + 1,
            expect_epoch=old_leader["epoch"])
        wait_until(
            lambda: harness.nodes[target]._pbroker.leases.epoch_of(
                "t", part) is not None,
            WAIT_S, what="new leader leases the partition")

        # the group resumes where it committed, via the client (which
        # routes to the CURRENT leader — the anti-entropy shed pass may
        # legally move the now-imbalanced leadership again, so reads are
        # retried through any in-progress handover), and retention
        # survived the move
        def _retrying(op):
            deadline = time.monotonic() + WAIT_S
            while True:
                try:
                    return op()
                except LeaderChangedError:
                    assert time.monotonic() < deadline
                    time.sleep(0.05)

        assert _retrying(
            lambda: client.committed_offset("workers", "t", part)) == 30
        assert _retrying(lambda: client.begin_offset("t", part)) >= 10
        got = [r.value.decode() for r in
               _retrying(lambda: client.fetch("t", part, 30, 100))]
        assert got == [f"m{i}" for i in range(30, 40)]
    finally:
        harness.stop()
        client.close()


def test_stale_epoch_mirror_connect_refused(tmp_path):
    """Epoch persistence end-to-end: a leader's epoch lands in its OWN
    segment log and replicates to followers, so a follower restarted
    from disk still fences the deposed leader's mirror connects."""
    from swarmdb_tpu_torch.broker.replica import persist_epoch

    broker = LocalBroker()
    persist_epoch(broker, 7, "old-follower")
    assert read_log_epoch(broker) == 7
    # a fresh ReplicaServer over that log inherits the floor: epoch 3 is
    # fenced before any cluster map ever says so
    from swarmdb_tpu_torch.broker.replica import ReplicaServer, Replicator

    server = ReplicaServer(broker).start()
    try:
        fenced_at = []
        repl = Replicator(LocalBroker(), f"{server.host}:{server.port}",
                          get_epoch=lambda: 3,
                          on_fenced=fenced_at.append)
        try:
            wait_until(repl.fenced.is_set, WAIT_S, what="F frame")
            assert repl.fenced_epoch == 7
            assert fenced_at == [7]
        finally:
            repl.stop()
    finally:
        server.stop()
        broker.close()


def test_metrics_and_admin_ha_contract(tmp_path):
    """The /metrics + /health + /admin/ha surface over a real HANode:
    swarmdb_ha_role / swarmdb_ha_epoch / detector-state gauges, HA block
    in /health, full status + event ring at /admin/ha."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from swarmdb_tpu_torch.api.app import ApiConfig, create_app
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    cluster = InMemoryClusterMap()
    leader = HANode("api-leader", LocalBroker(), cluster,
                    suspect_s=SUSPECT_S, dead_s=DEAD_S,
                    heartbeat_s=HEARTBEAT_S).start(role="leader")
    follower = HANode("api-follower", LocalBroker(), cluster,
                      suspect_s=SUSPECT_S, dead_s=DEAD_S,
                      heartbeat_s=HEARTBEAT_S).start(role="follower")

    async def drive():
        db = SwarmDB(broker=NodeBroker(leader),
                     save_dir=str(tmp_path / "hist"))
        cfg = ApiConfig(jwt_secret_key="t", rate_limit_per_minute=10_000)
        for node, expectations in (
            (leader, ['swarmdb_ha_role{node="api-leader",role="leader"} 1',
                      "swarmdb_ha_epoch 1",
                      "swarmdb_ha_cluster_epoch 1"]),
            (follower, ['swarmdb_ha_role{node="api-follower",'
                        'role="follower"} 0',
                        "swarmdb_ha_detector_state",
                        "swarmdb_ha_detector_signal_age_seconds"]),
        ):
            app = create_app(db, cfg, ha_node=node)
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                r = await client.get("/metrics")
                assert r.status == 200
                body = await r.text()
                for needle in expectations:
                    assert needle in body, f"missing {needle!r}:\n{body}"

                r = await client.get("/health")
                health = await r.json()
                assert health["ha"]["role"] == node.role
                assert health["ha"]["epoch"] == node.current_epoch()

                r = await client.post("/auth/token", json={
                    "username": "admin", "password": "x"})
                hdrs = {"Authorization":
                        f"Bearer {(await r.json())['access_token']}"}
                r = await client.get("/admin/ha", headers=hdrs)
                assert r.status == 200
                status = await r.json()
                assert status["node_id"] == node.node_id
                assert status["leader"] == "api-leader"
                assert any(ev["kind"] == "ha.start"
                           for ev in status["events"])
                # non-admin is refused
                r = await client.post("/auth/token", json={
                    "username": "peon", "password": "x"})
                hdrs = {"Authorization":
                        f"Bearer {(await r.json())['access_token']}"}
                r = await client.get("/admin/ha", headers=hdrs)
                assert r.status == 403
            finally:
                await client.close()
        db.close()

    try:
        asyncio.run(drive())
    finally:
        follower.stop()
        leader.stop()


@pytest.mark.skipif(sys.platform == "win32", reason="POSIX signals")
def test_subprocess_nodes_promote_after_sigkill(tmp_path):
    """The compose-stack shape end-to-end: real `python -m
    swarmdb_tpu_torch.ha.node` processes over a shared FileClusterMap, leader
    SIGKILLed, a follower promotes, and the healthcheck CLI agrees."""
    env = dict(os.environ,
               SWARMDB_HA_SUSPECT_S=str(SUSPECT_S),
               SWARMDB_HA_DEAD_S=str(DEAD_S),
               SWARMDB_HA_HEARTBEAT_S=str(HEARTBEAT_S),
               JAX_PLATFORMS="cpu")
    cluster_path = str(tmp_path / "cluster.json")
    procs = {}

    def spawn(node_id, role):
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

    cmap = FileClusterMap(cluster_path)
    try:
        spawn("p0", "leader")
        spawn("p1", "follower")
        wait_until(lambda: cmap.read()["leader"] == "p0", WAIT_S,
                   what="subprocess bootstrap")
        nodes = cmap.read()["nodes"]
        leader_liveness = nodes["p0"]["liveness_addr"]
        # the compose healthcheck: --probe exits 0 against a live node
        probe = subprocess.run(
            [sys.executable, "-m", "swarmdb_tpu_torch.ha.node",
             "--probe", nodes["p1"]["liveness_addr"]],
            cwd=str(REPO), env=env, capture_output=True, text=True,
            timeout=30)
        assert probe.returncode == 0, probe.stdout
        assert json.loads(probe.stdout)["ok"] is True

        procs["p0"].send_signal(signal.SIGKILL)
        procs["p0"].wait(timeout=10)
        wait_until(lambda: cmap.read()["leader"] == "p1", 4 * PROMOTE_BUDGET_S,
                   poll_s=0.05, what="subprocess failover")
        assert cmap.read()["epoch"] >= 2
        # probing the DEAD node fails — what the compose healthcheck
        # turns into a container restart
        assert probe_liveness(leader_liveness, 1.0) is None
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


# ------------------------------------------------ across the two packages


@pytest.mark.skipif(sys.platform == "win32", reason="POSIX signals")
@pytest.mark.parametrize("leader_pkg,follower_pkg",
                         [("swarmdb_tpu_torch", "swarmdb_tpu"),
                          ("swarmdb_tpu", "swarmdb_tpu_torch")],
                         ids=["port-leads", "jax-leads"])
def test_mixed_package_nodes_fail_over(tmp_path, leader_pkg, follower_pkg):
    """A port node and a JAX-package node on one cluster map: the leader
    streams to the follower of the other package, the port's
    ClusterBroker writes through the leader's data plane, the leader is
    SIGKILLed and the follower promotes with every acked record. The
    port's nodes run on their native broker; the JAX ones on LocalBroker
    (the JAX native broker refuses the HA epoch topic, ROADMAP.md
    queue 3)."""
    from swarmdb_tpu_torch.ha import ClusterBroker, data_plane_opener

    env = dict(os.environ, PYTHONPATH=str(REPO),
               SWARMDB_HA_SUSPECT_S=str(SUSPECT_S),
               SWARMDB_HA_DEAD_S=str(DEAD_S),
               SWARMDB_HA_HEARTBEAT_S=str(HEARTBEAT_S),
               SWARMDB_HA_PARTITION_LEADERSHIP="0",
               JAX_PLATFORMS="cpu")
    cluster_path = str(tmp_path / "cluster.json")
    procs = {}

    def spawn(node_id, role, pkg):
        broker = ["--broker", "local"] if pkg == "swarmdb_tpu" else []
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.ha.node", "--node-id", node_id,
             "--role", role, "--log-dir", str(tmp_path / node_id),
             "--cluster", cluster_path, "--listen", "127.0.0.1:0",
             "--liveness", "127.0.0.1:0", "--data", "127.0.0.1:0",
             "--advertise-host", "127.0.0.1", *broker],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            cwd=str(REPO), env=env)
        line = proc.stdout.readline()
        assert line.startswith(f"HA_NODE_READY {node_id}"), line
        procs[node_id] = proc

    cmap = FileClusterMap(cluster_path)
    client = None
    try:
        spawn("p0", "leader", leader_pkg)
        wait_until(lambda: cmap.read()["leader"] == "p0", WAIT_S,
                   what="bootstrap")
        spawn("p1", "follower", follower_pkg)
        client = ClusterBroker(cmap, data_plane_opener(timeout_s=5.0),
                               refresh_s=0.05)
        client.create_topic("t", 1)

        def mirrored():
            # the follower holds everything the leader has (the epoch
            # record included): the stream is up, so acks are acks=all
            nodes = cmap.read()["nodes"]
            if "p1" not in nodes:
                return False
            lead = probe_liveness(nodes["p0"]["liveness_addr"], 5.0)
            foll = probe_liveness(nodes["p1"]["liveness_addr"], 5.0)
            return (lead is not None and foll is not None and lead[1] > 0
                    and foll[1] == lead[1])

        wait_until(mirrored, WAIT_S, poll_s=0.05,
                   what="the follower mirrors the leader")
        acked = []
        deadline = time.monotonic() + WAIT_S
        while len(acked) < 20:
            assert time.monotonic() < deadline, "acks before the kill"
            payload = f"m{len(acked)}"
            try:
                off = client.append("t", 0, payload.encode())
                if client.wait_durable("t", 0, off, WAIT_S):
                    acked.append(payload)
            except LeaderChangedError:
                time.sleep(0.05)
        epoch = cmap.read()["epoch"]
        procs["p0"].send_signal(signal.SIGKILL)
        procs["p0"].wait(timeout=10)
        wait_until(lambda: cmap.read()["leader"] == "p1"
                   and cmap.read()["epoch"] > epoch, WAIT_S, poll_s=0.05,
                   what="the other package's follower promotes")
        deadline = time.monotonic() + WAIT_S
        while True:
            try:
                off = client.append("t", 0, b"after")
                assert client.wait_durable("t", 0, off, WAIT_S)
                break
            except LeaderChangedError:
                assert time.monotonic() < deadline, "append after failover"
                time.sleep(0.05)
        survived = [r.value.decode() for r in client.fetch("t", 0, 0, 1000)]
        assert survived == acked + ["after"]
    finally:
        if client is not None:
            client.close()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_late_dead_verdict_does_not_depose_the_new_leader(pkg):
    """A follower whose detector reaches DEAD after another follower has
    already won the failover, but before its own watch loop noticed the
    new leader, must stand down. The port fails over only from the
    leader its detector was judging; the JAX package's promotion loop
    takes the map's leader at its first read as the dead one and deposes
    the fresh winner (ROADMAP.md queue 3)."""
    if pkg == "port":
        from swarmdb_tpu_torch.ha.detector import DetectorState
        from swarmdb_tpu_torch.ha.node import HANode as Node
        Map, Broker = InMemoryClusterMap, LocalBroker
    else:
        from swarmdb_tpu.broker.local import LocalBroker as Broker
        from swarmdb_tpu.ha import HANode as Node
        from swarmdb_tpu.ha import InMemoryClusterMap as Map
        from swarmdb_tpu.ha.detector import DetectorState

    cluster = Map()
    # detector times long enough that nothing fires on its own, and a
    # watch loop (suspect_s / 2) too slow to see the change first
    knobs = dict(suspect_s=60.0, dead_s=120.0, heartbeat_s=HEARTBEAT_S)
    nodes = [Node("n0", Broker(), cluster, **knobs).start(role="leader")]
    nodes += [Node(n, Broker(), cluster, **knobs).start(role="follower")
              for n in ("n1", "n2")]
    n1 = nodes[1]
    try:
        wait_until(lambda: n1._last_leader_seen == "n0"
                   or cluster.read()["leader"] == "n0", WAIT_S,
                   what="n1 follows n0")
        epoch = cluster.read()["epoch"]
        nodes[0].kill()
        # n2 wins the failover from n0 (the map moves; n1 has not looked)
        assert cluster.try_promote("n2", epoch + 1, expect_epoch=epoch)
        if pkg == "port":
            n1._last_leader_seen = "n0"   # what n1's watch loop last saw
        # ...and n1's detector, still judging n0, reaches DEAD
        n1._detector._state = DetectorState.DEAD
        n1._on_detector_state(DetectorState.SUSPECT, DetectorState.DEAD)
        wait_until(lambda: not n1._promoting.is_set(), WAIT_S,
                   what="n1's promotion loop ends")
        state = cluster.read()
        if pkg == "port":
            assert (state["leader"], state["epoch"]) == ("n2", epoch + 1)
            assert n1.role == "follower"
        else:
            assert (state["leader"], state["epoch"]) == ("n1", epoch + 2)
    finally:
        for node in nodes:
            node.stop()
