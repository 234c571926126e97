"""Partition-level leadership fault-injection tests of the port: the
cases of ``tests/test_partition_leadership.py`` with detector times sized
for a loaded machine.

The HA cluster's write path is sharded: every ``(topic, partition)`` has
its own leader from the cluster map's epoch-versioned assignments table,
fenced per-partition on the replication wire (Q/N frames) and at the
facade (partition-scoped FencedError). The acceptance matrix:

- spread: a topic's partitions are assigned across all live nodes, and
  writes to every partition land acked (majority-quorum durability);
- partition-scoped kill: killing one node of three stalls ONLY that
  node's partitions (blast radius <= 1/cluster_size + one partition),
  acked-durable loss is exactly 0 over concurrent producers, and every
  orphaned partition re-seats within the node-level promotion budget;
- dueling promotions on the SAME partition seat exactly one winner per
  partition-epoch (the per-assignment expect_epoch CAS);
- FileClusterMap regression: concurrent CASes on DIFFERENT partitions
  neither serialize on nor clobber each other's epoch bumps (the
  stale-read/lost-update window a load-outside-the-lock implementation
  would have);
- a deposed partition leader is fenced on exactly that partition — its
  other leaderships keep writing;
- anti-entropy: a healed node re-joins and leaderships re-spread onto
  it (the shed/drain-handover path).

Same chaos discipline as tests/test_ha_failover.py: scripted faults,
bounded convergence waits, flight-ring dumps on failure.
"""

import threading
import time

import pytest

from swarmdb_tpu_torch.broker.base import FencedError, LeaderChangedError
from swarmdb_tpu_torch.ha import (FileClusterMap, build_local_cluster, tp_key,
                            wait_until)

SUSPECT_S = 1.0
DEAD_S = 2.0
HEARTBEAT_S = 0.1
# convergence deadline: several times the expected time on a machine
# loaded by the other test workers
WAIT_S = 30.0
# kill -> confirmed-dead (DEAD_S) + per-partition probe round + CAS;
# same budget shape as test_torch_ha_failover.py
PROMOTE_BUDGET_S = DEAD_S + 6 * SUSPECT_S

TOPIC = "t"
PARTS = 6


@pytest.fixture(autouse=True)
def _fast_heartbeat(monkeypatch):
    monkeypatch.setenv("SWARMDB_HA_HEARTBEAT_S", str(HEARTBEAT_S))


@pytest.fixture
def cluster3p(request):
    """3-node partition-leadership cluster + per-partition-routing
    client, with a 6-partition topic assigned and spread."""
    harness, cluster, client = build_local_cluster(
        ["n0", "n1", "n2"], suspect_s=SUSPECT_S, dead_s=DEAD_S,
        heartbeat_s=HEARTBEAT_S, partition_leadership=True)
    try:
        wait_until(lambda: cluster.read()["leader"] == "n0", WAIT_S,
                   what="bootstrap leader")
        client.create_topic(TOPIC, PARTS)
        wait_until(
            lambda: len(cluster.read()["assignments"]) == PARTS, WAIT_S,
            what="partition assignment")
        wait_until(lambda: _all_leased(harness, cluster), WAIT_S,
                   what="leases granted")
        yield harness, cluster, client
    finally:
        failed = getattr(request.node, "rep_call", None)
        if failed is not None and failed.failed:
            harness.flight.auto_dump(f"plead_test_{request.node.name}")
        harness.stop()
        client.close()


def _all_leased(harness, cluster) -> bool:
    for key, a in cluster.read()["assignments"].items():
        node = harness.nodes.get(a["leader"])
        if node is None or node._pbroker is None:
            return False
        topic, _, part = key.rpartition(":")
        if node._pbroker.leases.epoch_of(topic, int(part)) is None:
            return False
    return True


def _leaderships(cluster):
    counts = {}
    for a in cluster.read()["assignments"].values():
        counts[a["leader"]] = counts.get(a["leader"], 0) + 1
    return counts


def _acked_append(client, part, payload, deadline_s=WAIT_S):
    """Append + quorum-ack with the retryable-error loop a real
    producer runs; raises on deadline."""
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            off = client.append(TOPIC, part, payload)
            if client.wait_durable(TOPIC, part, off, 2.0):
                return off
        except LeaderChangedError:
            pass
        if time.monotonic() > deadline:
            raise AssertionError(
                f"append to {TOPIC}[{part}] not acked in {deadline_s}s")
        time.sleep(0.02)


def test_spread_and_quorum_acked_writes(cluster3p):
    """Every partition gets a leader, leadership is spread across all
    three nodes, and a write to every partition lands quorum-acked."""
    harness, cluster, client = cluster3p
    counts = _leaderships(cluster)
    assert sum(counts.values()) == PARTS
    assert set(counts) == {"n0", "n1", "n2"}, f"not spread: {counts}"
    assert max(counts.values()) - min(counts.values()) <= 1
    for p in range(PARTS):
        _acked_append(client, p, f"hello-{p}".encode())
    # the observability block agrees
    status = harness.nodes["n0"].status()["partition_leadership"]
    assert status["leaderships"] == counts
    assert status["leaderless"] == 0
    assert len(status["partitions"]) == PARTS


def test_partition_kill_bounded_blast_radius_zero_loss(cluster3p):
    """The headline: kill one node under concurrent per-partition
    producers — only its partitions stall (blast radius <= 1/3 + one
    partition), every orphan re-seats within the promotion budget,
    acked-durable loss is exactly 0, and the unaffected partitions'
    producers keep acking THROUGH the failover."""
    harness, cluster, client = cluster3p
    acked = {p: [] for p in range(PARTS)}
    lock = threading.Lock()
    stop = threading.Event()
    errors = []

    def produce(p):
        i = 0
        while not stop.is_set():
            payload = f"p{p}-m{i}"
            try:
                off = client.append(TOPIC, p, payload.encode())
                if client.wait_durable(TOPIC, p, off, 2.0):
                    with lock:
                        acked[p].append((time.monotonic(), payload))
                    i += 1
            except LeaderChangedError:
                stop.wait(0.02)
            except Exception as exc:  # non-retryable: fail the test
                errors.append((p, repr(exc)))
                return

    threads = [threading.Thread(target=produce, args=(p,), daemon=True)
               for p in range(PARTS)]
    for t in threads:
        t.start()
    wait_until(lambda: all(len(acked[p]) >= 10 for p in range(PARTS)),
               20.0, what="steady-state acks on every partition")

    victim = "n1"
    victim_parts = {
        int(k.rpartition(":")[2])
        for k, a in cluster.read()["assignments"].items()
        if a["leader"] == victim}
    assert victim_parts, "victim leads nothing — spread broke"
    t_kill = time.monotonic()
    harness.kill(victim)
    wait_until(
        lambda: all(
            cluster.read()["assignments"][tp_key(TOPIC, p)]["leader"]
            != victim for p in victim_parts),
        PROMOTE_BUDGET_S,
        what="every orphaned partition re-seated within budget")
    t_reseated = time.monotonic()
    time.sleep(1.0)  # post-failover steady state
    stop.set()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert errors == [], f"producers died non-retryably: {errors}"

    # zero acked loss, per partition, audited through the client (routes
    # to each partition's CURRENT leader)
    for p in range(PARTS):
        survived = {r.value.decode()
                    for r in client.fetch(TOPIC, p, 0, 200000)}
        lost = [pay for _, pay in acked[p] if pay not in survived]
        assert lost == [], (
            f"{len(lost)} acked-durable records lost on partition {p}")

    # blast radius: partitions whose ack stream stalled > DEAD_S inside
    # the fault window
    stalled = set()
    for p in range(PARTS):
        with lock:
            times = [t for t, _ in acked[p]
                     if t_kill - 0.5 <= t <= t_reseated + 1.0]
        gaps = [b - a for a, b in zip(times, times[1:])]
        if not times or (gaps and max(gaps) > DEAD_S):
            stalled.add(p)
    assert len(stalled) <= len(victim_parts) + 1, (
        f"blast radius {stalled} exceeds victim partitions "
        f"{victim_parts} + 1")
    assert len(stalled) / PARTS <= 1 / 3 + 1 / PARTS + 1e-9
    # unaffected partitions flowed THROUGH the failover window
    for p in set(range(PARTS)) - victim_parts - stalled:
        with lock:
            in_window = [t for t, _ in acked[p]
                         if t_kill <= t <= t_reseated + 0.5]
        assert in_window, f"partition {p} (unaffected) stopped acking"

    # per-partition promotions recorded with elapsed times
    promoted = [ev for ev in harness.flight.events()
                if ev.get("kind") == "ha.partition_promoted"]
    assert {ev["partition"] for ev in promoted} >= {
        tp_key(TOPIC, p) for p in victim_parts}
    assert (t_reseated - t_kill) < PROMOTE_BUDGET_S

    # rebalance convergence is a first-class number: some
    # survivor observed the orphan episode open and close, recorded it
    # (flight + status block) within the same promotion budget
    survivors = [harness.nodes[n] for n in ("n0", "n2")]
    wait_until(
        lambda: any(n.last_convergence_s is not None for n in survivors),
        PROMOTE_BUDGET_S, what="a survivor recorded convergence")
    observer = next(n for n in survivors
                    if n.last_convergence_s is not None)
    assert 0 < observer.last_convergence_s < 4 * PROMOTE_BUDGET_S
    pl_block = observer.status()["partition_leadership"]
    assert pl_block["rebalance_convergence_s"] == \
        observer.last_convergence_s
    assert pl_block["orphans"] == 0 and pl_block["rebalancing"] is False
    converged = [ev for ev in harness.flight.events()
                 if ev.get("kind") == "ha.rebalance_converged"]
    assert converged and converged[-1]["orphans_peak"] >= 1


def test_dueling_partition_promotion_exactly_one_winner(cluster3p):
    """Dueling-promotion injection: every live node races the CAS for
    the SAME partition at the same ranked-at epoch — exactly one wins
    each epoch, across repeated duels."""
    harness, cluster, client = cluster3p
    for _ in range(5):
        before = cluster.read()["assignments"][tp_key(TOPIC, 0)]["epoch"]
        result = harness.duel_promotion(TOPIC, 0)
        assert len(result["winners"]) == 1, (
            f"dueling promotion seated {result['winners']}")
        after = cluster.read()["assignments"][tp_key(TOPIC, 0)]
        # >= not ==: the anti-entropy shed may legally move the (now
        # imbalanced) leadership again between duel and read — the
        # invariant under test is one WINNER per epoch, not map stasis
        assert after["epoch"] >= before + 1
    # the cluster converges: the final winner leases it, writes flow
    wait_until(lambda: _all_leased(harness, cluster), WAIT_S,
               what="post-duel lease convergence")
    _acked_append(client, 0, b"post-duel")


@pytest.mark.parametrize("second", ["port", "jax"])
def test_file_cluster_map_concurrent_partition_cas(tmp_path, second):
    """REGRESSION: two coordinators CASing
    DIFFERENT partitions through the shared FileClusterMap — separate
    map handles, like separate processes — must neither serialize on
    nor clobber each other's epoch bumps. A stale-read implementation
    (load outside the flock, store inside) loses updates here. The
    second handle may be the JAX package's: both take the same lock on
    the same file format."""
    from swarmdb_tpu.ha import FileClusterMap as JaxFileClusterMap

    path = str(tmp_path / "cluster.json")
    maps = [FileClusterMap(path),
            (FileClusterMap if second == "port" else JaxFileClusterMap)(path)]
    rounds = 40
    results = [[], []]

    barrier = threading.Barrier(2)

    def coordinator(i):
        cmap = maps[i]
        barrier.wait()
        for epoch in range(1, rounds + 1):
            # every CAS is pinned to the previous epoch of OUR partition:
            # a failure here means someone else's bump leaked into our
            # epoch space (serialization) or ours was clobbered
            ok = cmap.try_promote_partition(
                "t", i, f"coord-{i}", epoch, expect_epoch=epoch - 1)
            results[i].append(ok)

    threads = [threading.Thread(target=coordinator, args=(i,))
               for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)

    assert all(results[0]) and all(results[1]), (
        "per-partition CASes serialized across partitions: "
        f"{results[0].count(False)} + {results[1].count(False)} spurious "
        "failures")
    state = maps[0].read()
    for i in (0, 1):
        a = state["assignments"][tp_key("t", i)]
        assert a["epoch"] == rounds, (
            f"partition {i} lost epoch bumps: {a['epoch']} != {rounds}")
        assert a["leader"] == f"coord-{i}"
    # ...and the SAME-partition CAS still admits exactly one winner
    wins = [maps[i].try_promote_partition("t", 0, f"dueler-{i}",
                                          rounds + 1,
                                          expect_epoch=rounds)
            for i in (0, 1)]
    assert wins.count(True) == 1


def test_deposed_partition_leader_fenced_partition_scoped(cluster3p):
    """Moving ONE leadership away from a node fences exactly that
    partition: the old leader's direct append raises a FencedError
    carrying (topic, partition, epoch), while its other leaderships
    keep writing."""
    harness, cluster, client = cluster3p
    counts = _leaderships(cluster)
    victim = max(counts, key=lambda n: counts[n])
    parts = [int(k.rpartition(":")[2])
             for k, a in cluster.read()["assignments"].items()
             if a["leader"] == victim]
    assert len(parts) >= 2
    moved, kept = parts[0], parts[1]
    a = cluster.read()["assignments"][tp_key(TOPIC, moved)]
    target = next(n for n in ("n0", "n1", "n2") if n != victim)
    assert cluster.try_promote_partition(
        TOPIC, moved, target, a["epoch"] + 1, expect_epoch=a["epoch"])

    node = harness.nodes[victim]
    wait_until(
        lambda: node._pbroker.leases.epoch_of(TOPIC, moved) is None,
        WAIT_S, what="old leader notices the move")
    with pytest.raises(FencedError) as err:
        node._pbroker.append(TOPIC, moved, b"stale-write")
    assert err.value.topic == TOPIC
    assert err.value.partition == moved
    assert err.value.epoch is not None and err.value.epoch >= a["epoch"] + 1, (
        "partition-scoped FencedError must carry the fencing epoch")
    # the SAME node's other leadership is untouched
    node._pbroker.append(TOPIC, kept, b"still-the-leader")
    # and the moved partition serves through the client once the new
    # leader picks the lease up
    _acked_append(client, moved, b"after-move")


def test_partition_metrics_and_admin_ha_contract(tmp_path):
    """/metrics exports the per-node
    ``swarmdb_partition_leaderships`` gauge + ``swarmdb_partition_
    leaderless`` count, and /admin/ha carries the per-partition
    leadership table (leader, epoch, replica lag)."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from swarmdb_tpu_torch.api.app import ApiConfig, create_app
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.ha import HANode, InMemoryClusterMap

    cluster = InMemoryClusterMap()
    leader = HANode("pl-leader", LocalBroker(), cluster,
                    suspect_s=SUSPECT_S, dead_s=DEAD_S, heartbeat_s=HEARTBEAT_S,
                    partition_leadership=True).start(role="leader")
    follower = HANode("pl-follower", LocalBroker(), cluster,
                      suspect_s=SUSPECT_S, dead_s=DEAD_S,
                      heartbeat_s=HEARTBEAT_S,
                      partition_leadership=True).start(role="follower")
    try:
        leader.broker_facade.create_topic("mt", 4)
        wait_until(lambda: len(cluster.read()["assignments"]) == 4, WAIT_S,
                   what="assignment")

        # serving-locality surfaces: a stub serving object
        # carrying a real ConversationLocality — the app reads it via
        # getattr, exactly like a full ServingService
        from types import SimpleNamespace

        from swarmdb_tpu_torch.backend.locality import ConversationLocality

        wait_until(
            lambda: leader.assignment_of("mt:0") is not None, WAIT_S,
            what="leader index caught up")
        locality = ConversationLocality(
            topic="mt", n_lanes=2, leadership=leader.assignment_of,
            num_partitions=lambda: 4, local_node="pl-leader")
        locality.pin("u", "agent-0")
        locality.pin("u", "agent-1")
        # (the port's app stops its serving object at shutdown)
        serving_stub = SimpleNamespace(engine=None, supervisor=None,
                                       _locality=locality,
                                       stop=lambda: None)
        # a closed convergence episode so the gauge renders
        leader.last_convergence_s = 0.42

        async def drive():
            db = SwarmDB(broker=LocalBroker(),
                         save_dir=str(tmp_path / "hist"))
            cfg = ApiConfig(jwt_secret_key="t",
                            rate_limit_per_minute=10_000)
            app = create_app(db, cfg, ha_node=leader,
                             serving=serving_stub)
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                r = await client.get("/metrics")
                body = await r.text()
                assert "# TYPE swarmdb_partition_leaderships gauge" in body
                assert 'swarmdb_partition_leaderships{node="pl-leader"}' \
                    in body
                assert 'swarmdb_partition_leaderships{node="pl-follower"}' \
                    in body
                assert "swarmdb_partition_leaderless 0" in body
                # rebalance convergence + the
                # conversation-locality local/remote split
                assert ("swarmdb_rebalance_convergence_seconds 0.42"
                        in body)
                assert ('swarmdb_conversation_locality{state="local"}'
                        in body)
                assert ('swarmdb_conversation_locality{state="remote"}'
                        in body)
                assert "swarmdb_conversation_repins_total 0" in body

                r = await client.post("/auth/token", json={
                    "username": "admin", "password": "x"})
                hdrs = {"Authorization":
                        f"Bearer {(await r.json())['access_token']}"}
                r = await client.get("/admin/ha", headers=hdrs)
                assert r.status == 200
                status = await r.json()
                pl = status["partition_leadership"]
                assert pl["enabled"] is True
                assert len(pl["partitions"]) == 4
                for row in pl["partitions"].values():
                    assert row["leader"] in ("pl-leader", "pl-follower")
                    assert row["epoch"] >= 1
                # locally-led partitions carry the replica-lag column
                led_here = [row for row in pl["partitions"].values()
                            if row["leader"] == "pl-leader"]
                assert led_here and all("replica_lag" in row
                                        for row in led_here)
                assert pl["rebalance_convergence_s"] == 0.42
                # partition_serving block: conversations
                # pinned per leader + leaderless count
                ps = status["partition_serving"]
                assert ps["conversations"] == 2
                assert ps["leaderless"] == 0
                assert sum(ps["by_leader"].values()) == 2
                assert ps["local"] + ps["remote"] == 2
            finally:
                await client.close()
            db.close()

        asyncio.run(drive())
    finally:
        follower.stop()
        leader.stop()


def test_healed_node_receives_leaderships_again(cluster3p):
    """Anti-entropy: isolate a node (its partitions fail over), heal it
    — it re-registers and the shed pass re-spreads leaderships onto it;
    writes to every partition flow end to end afterwards."""
    harness, cluster, client = cluster3p
    harness.isolate("n1")
    wait_until(lambda: _leaderships(cluster).get("n1", 0) == 0,
               4 * PROMOTE_BUDGET_S, what="failover off the isolated node")
    # survivors keep serving every partition meanwhile
    for p in range(PARTS):
        _acked_append(client, p, f"during-isolation-{p}".encode())
    harness.heal("n1")
    wait_until(lambda: _leaderships(cluster).get("n1", 0) >= 1,
               20.0, what="leaderships re-spread onto the healed node")
    for p in range(PARTS):
        _acked_append(client, p, f"post-heal-{p}".encode())
    rebalances = [ev for ev in harness.flight.events()
                  if ev.get("kind") == "ha.rebalance"
                  and ev.get("action") == "shed"]
    assert rebalances, "no shed events recorded for the re-spread"


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_dead_controller_is_replaced(pkg):
    """Killing the controller (the node-level leader) of a three-node
    partition-leadership cluster seats a new controller. Every peer
    streams into every node under partition leadership, so the
    controller's detector must beat only from the controller's own
    stream: the JAX package beats it from any stream, and its dead
    controller is never replaced (ROADMAP.md queue 3)."""
    if pkg == "port":
        make = build_local_cluster
    else:
        from swarmdb_tpu.ha import build_local_cluster as make
    # the JAX case waits out a fixed window: its own (short) detector
    # times keep it brief
    suspect, dead = (SUSPECT_S, DEAD_S) if pkg == "port" else (0.3, 0.6)
    harness, cluster, client = make(
        ["n0", "n1", "n2"], suspect_s=suspect, dead_s=dead,
        heartbeat_s=HEARTBEAT_S, partition_leadership=True)
    try:
        wait_until(lambda: cluster.read()["leader"] == "n0", WAIT_S,
                   what="bootstrap leader")
        client.create_topic(TOPIC, PARTS)
        wait_until(lambda: len(cluster.read()["assignments"]) == PARTS,
                   WAIT_S, what="partition assignment")
        epoch = cluster.read()["epoch"]
        harness.kill("n0")
        if pkg == "port":
            wait_until(lambda: cluster.read()["leader"] in ("n1", "n2")
                       and cluster.read()["epoch"] > epoch, WAIT_S,
                       what="a new controller")
            # the new controller assigns a topic created after the kill
            wait_until(lambda: _create_retrying(client, "after", 2), WAIT_S,
                       what="a topic created after the kill")
            wait_until(lambda: sum(k.startswith("after:") for k in
                                   cluster.read()["assignments"]) == 2,
                       WAIT_S, what="the new topic's assignment")
        else:
            time.sleep(6 * dead)
            assert cluster.read()["leader"] == "n0"
    finally:
        harness.stop()
        client.close()


def _create_retrying(client, topic, parts) -> bool:
    try:
        client.create_topic(topic, parts)
        return True
    except LeaderChangedError:
        return False
