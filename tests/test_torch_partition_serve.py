"""Serving on partition leadership, the port's copy: the cases of
``tests/test_partition_serve.py``, plus a tiny-debug lane group on CPU
lanes bound to partition leadership, its tokens equal to the JAX
package's on the same weights.

Two halves meet here: partition-level broker leadership and the
serving/runtime tier. Pinned contracts:

- the stale-facade class of bug, once and for all: an embedded runtime
  writes through ``HANode.client_broker()`` (per-call leader lookup) —
  deposing a partition's leader MID-STREAM means the very next produce
  lands on the NEW leader, the deposed node's direct append is fenced,
  and nothing requires a rebind;
- conversation-locality convergence (property test): 50 conversations
  driven through a leadership MOVE (drain-handover-shaped CAS) and a
  FAILOVER promotion (node kill) end with every conversation's shard
  hint, lane pin, and partition leader in agreement, with ``ha.repin``
  flight instants recorded for exactly the affected partitions;
- cluster-mode defaults: ``partition_leadership_default`` flips ON for
  cluster-mode entry points only — harness/embedded construction is
  bit-identical to the node-level default.
"""

import threading
import time

import pytest

from swarmdb_tpu_torch.broker.base import FencedError, LeaderChangedError
from swarmdb_tpu_torch.core.messages import BrokerConfig
from swarmdb_tpu_torch.core.runtime import SwarmDB
from swarmdb_tpu_torch.ha import build_local_cluster, tp_key, wait_until
from swarmdb_tpu_torch.ha.partition import partition_leadership_default
from swarmdb_tpu_torch.backend.locality import ConversationLocality
from swarmdb_tpu_torch.obs.flight import FlightRecorder
from swarmdb_tpu_torch.utils.hashing import stable_partition
from swarmdb_tpu_torch.utils.metrics import MetricsRegistry

SUSPECT_S = 1.0
DEAD_S = 2.0
HEARTBEAT_S = 0.1
# convergence deadline: several times the expected time on a machine
# loaded by the other test workers
WAIT_S = 30.0
PROMOTE_BUDGET_S = DEAD_S + 6 * SUSPECT_S


@pytest.fixture(autouse=True)
def _fast_heartbeat(monkeypatch):
    monkeypatch.setenv("SWARMDB_HA_HEARTBEAT_S", str(HEARTBEAT_S))


@pytest.fixture
def cluster3(request):
    harness, cluster, client = build_local_cluster(
        ["n0", "n1", "n2"], suspect_s=SUSPECT_S, dead_s=DEAD_S,
        heartbeat_s=HEARTBEAT_S, partition_leadership=True)
    try:
        wait_until(lambda: cluster.read()["leader"] == "n0", WAIT_S,
                   what="bootstrap leader")
        yield harness, cluster, client
    finally:
        failed = getattr(request.node, "rep_call", None)
        if failed is not None and failed.failed:
            harness.flight.auto_dump(f"pserve_test_{request.node.name}")
        harness.stop()
        client.close()


def test_cluster_mode_defaults(monkeypatch):
    """Default matrix: cluster-mode entry points get partition
    leadership ON, everything else keeps the node-level default; the
    env knob overrides both ways."""
    monkeypatch.delenv("SWARMDB_HA_PARTITION_LEADERSHIP", raising=False)
    assert partition_leadership_default() is False
    assert partition_leadership_default(cluster_mode=True) is True
    monkeypatch.setenv("SWARMDB_HA_PARTITION_LEADERSHIP", "0")
    assert partition_leadership_default(cluster_mode=True) is False
    monkeypatch.setenv("SWARMDB_HA_PARTITION_LEADERSHIP", "1")
    assert partition_leadership_default() is True


def _send_retry(db, sender, receiver, body, deadline_s=WAIT_S):
    """The runtime client contract: retryable failures re-send."""
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return db.send_message(sender, receiver, body)
        except LeaderChangedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def test_runtime_rides_partition_leaders_through_deposal(
        cluster3, tmp_path):
    """The stale-facade regression: an embedded runtime produced
    through n1's client_broker keeps landing writes on each partition's
    CURRENT leader across a mid-stream deposal — the deposed node's
    direct append is fenced, and no handle rebind is needed."""
    harness, cluster, _client = cluster3
    node = harness.nodes["n1"]
    db = SwarmDB(config=BrokerConfig(num_partitions=6),
                 topic_name="t_serve", save_dir=str(tmp_path / "hist"),
                 broker=node.client_broker())
    try:
        wait_until(
            lambda: sum(1 for k in cluster.read()["assignments"]
                        if k.startswith("t_serve:")) == 6,
            WAIT_S, what="t_serve assignment")
        receiver = "agent-a"
        part = stable_partition(receiver, 6)
        key = tp_key("t_serve", part)

        mid1 = _send_retry(db, "user", receiver, "before-deposal")
        wait_until(
            lambda: db.get_message(mid1).status.value in
            ("delivered", "read"),
            WAIT_S, what="first message delivered")

        a = cluster.read()["assignments"][key]
        old_leader = a["leader"]
        target = next(n for n in ("n0", "n1", "n2") if n != old_leader)
        assert cluster.try_promote_partition(
            "t_serve", part, target, a["epoch"] + 1,
            expect_epoch=a["epoch"])
        old_node = harness.nodes[old_leader]
        wait_until(
            lambda: old_node._pbroker.leases.epoch_of("t_serve", part)
            is None,
            PROMOTE_BUDGET_S, what="old leader fenced")
        wait_until(
            lambda: harness.nodes[target]._pbroker.leases.epoch_of(
                "t_serve", part) == a["epoch"] + 1,
            PROMOTE_BUDGET_S, what="new leader leased")

        # the fenced node refuses direct writes on exactly that
        # partition — nothing can silently land in its log
        with pytest.raises(FencedError):
            old_node._pbroker.append("t_serve", part, b"stale-write")

        # ...while the runtime's next produce resolves the NEW leader
        # (per-call lookup; at worst one retryable raise mid-window)
        mid2 = _send_retry(db, "user", receiver, "after-deposal")
        wait_until(
            lambda: db.get_message(mid2).status.value in
            ("delivered", "read"),
            WAIT_S, what="post-deposal message delivered")

        # both turns durable and readable through the cluster, exactly
        # once each, served by the new leader
        import json as _json

        recs = harness.nodes[target].broker.fetch("t_serve", part, 0,
                                                  100000)
        ids = [_json.loads(r.value.decode()).get("id") for r in recs]
        assert ids.count(mid1) == 1 and ids.count(mid2) == 1
    finally:
        db.close()


N_CONVS = 50
N_LANES = 4
TOPIC = "t"
PARTS = 12


def _expected_lane(part, leader):
    return stable_partition(f"{part}@{leader}", N_LANES)


def _pins_agree(cluster, locality, convs):
    assigns = cluster.read()["assignments"]
    for conv in convs:
        part = stable_partition(conv, PARTS)
        a = assigns.get(tp_key(TOPIC, part))
        if a is None:
            return False
        pin = locality.pin("u", conv)
        if pin.leader != a["leader"] or pin.epoch != a["epoch"]:
            return False
        if pin.lane != _expected_lane(part, a["leader"]):
            return False
    return True


def test_locality_convergence_across_move_and_failover(cluster3):
    """Property test: 50 conversations through a
    leadership move and a failover promotion — afterwards every
    conversation's shard hint, lane pin, and partition leader agree,
    and the re-pins were deterministic and scoped to the affected
    partitions (ha.repin instants name them)."""
    harness, cluster, client = cluster3
    client.create_topic(TOPIC, PARTS)
    wait_until(
        lambda: sum(1 for k in cluster.read()["assignments"]
                    if k.startswith(f"{TOPIC}:")) == PARTS,
        WAIT_S, what="assignment")

    flight = FlightRecorder()
    metrics = MetricsRegistry()
    controller = harness.nodes["n0"]
    locality = ConversationLocality(
        topic=TOPIC, n_lanes=N_LANES,
        leadership=controller.assignment_of,
        num_partitions=lambda: PARTS, local_node="n0",
        metrics=metrics, flight=flight)
    for node in harness.nodes.values():
        node.add_rebalance_listener(locality.on_rebalance)

    # the leadership view is the controller's index — synced per watch
    # tick; let it catch up before pinning so the baseline is repin-free
    wait_until(
        lambda: all(controller.assignment_of(tp_key(TOPIC, p)) is not None
                    for p in range(PARTS)),
        WAIT_S, what="controller index caught up")
    convs = [f"c{i}" for i in range(N_CONVS)]
    for conv in convs:
        locality.pin("u", conv)
    assert _pins_agree(cluster, locality, convs)
    assert locality.stats()["repins"] == 0
    assert locality.stats()["conversations"] == N_CONVS

    # --- leadership MOVE (the drain-handover CAS shape) -------------
    assigns = cluster.read()["assignments"]
    moved_part = next(
        stable_partition(c, PARTS) for c in convs
        if assigns[tp_key(TOPIC, stable_partition(c, PARTS))]["leader"]
        == "n1")
    a = assigns[tp_key(TOPIC, moved_part)]
    assert cluster.try_promote_partition(
        TOPIC, moved_part, "n2", a["epoch"] + 1, expect_epoch=a["epoch"])
    wait_until(lambda: _pins_agree(cluster, locality, convs),
               PROMOTE_BUDGET_S, what="pins agree after the move")
    moved_convs = [c for c in convs
                   if stable_partition(c, PARTS) == moved_part]
    assert locality.stats()["repins"] >= len(moved_convs)

    # --- FAILOVER promotion (node kill) -----------------------------
    victim = "n1"
    victim_parts = {
        int(k.rpartition(":")[2])
        for k, a in cluster.read()["assignments"].items()
        if a["leader"] == victim and k.startswith(f"{TOPIC}:")}
    assert victim_parts
    harness.kill(victim)
    wait_until(
        lambda: all(
            cluster.read()["assignments"][tp_key(TOPIC, p)]["leader"]
            != victim for p in victim_parts),
        4 * PROMOTE_BUDGET_S, what="failover re-seating")
    wait_until(lambda: _pins_agree(cluster, locality, convs),
               4 * PROMOTE_BUDGET_S, what="pins agree after failover")

    # determinism: recomputing every pin yields the same lanes again
    lanes1 = {c: locality.pin("u", c).lane for c in convs}
    lanes2 = {c: locality.pin("u", c).lane for c in convs}
    assert lanes1 == lanes2

    # ha.repin instants were recorded, scoped to affected partitions
    repins = [ev for ev in flight.events()
              if ev.get("kind") == "ha.repin"]
    assert repins, "no ha.repin flight instants recorded"
    affected = {tp_key(TOPIC, p) for p in victim_parts} | {
        tp_key(TOPIC, moved_part)}
    assert {ev["partition"] for ev in repins} <= affected
    assert metrics.counters["conversation_repins"].value \
        == locality.stats()["repins"]
    # every surviving leader now also serves its conversations' stats
    st = locality.stats()
    assert st["leaderless"] == 0
    assert victim not in st["by_leader"]
    assert sum(st["by_leader"].values()) == N_CONVS


def test_locality_concurrent_pins_and_rebalances():
    """Thread-safety smoke: pin() from serving threads racing
    on_rebalance() from HA threads must neither deadlock nor corrupt
    the registry."""
    leadership = {"leader": "a", "epoch": 1}
    locality = ConversationLocality(
        topic=TOPIC, n_lanes=4,
        leadership=lambda key: dict(leadership),
        num_partitions=lambda: 8)
    stop = threading.Event()

    def pinner(w):
        i = 0
        while not stop.is_set():
            locality.pin("u", f"c{(w * 37 + i) % 64}")
            i += 1

    def rebalancer():
        i = 0
        while not stop.is_set():
            leadership["leader"] = f"n{i % 3}"
            leadership["epoch"] = i + 2
            for p in range(8):
                locality.on_rebalance(tp_key(TOPIC, p),
                                      dict(leadership))
            i += 1

    threads = [threading.Thread(target=pinner, args=(w,), daemon=True)
               for w in range(3)]
    threads.append(threading.Thread(target=rebalancer, daemon=True))
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=WAIT_S)
    st = locality.stats()
    assert 0 < st["conversations"] <= 64
    assert st["repins"] > 0


# ------------------------------------- a lane group on partition leadership

USERS = ("u0", "u1", "u2", "u3")
BOTS = tuple(f"bot{i}" for i in range(len(USERS)))


def _groups(monkeypatch):
    """(JAX group, port group) of two tiny-debug lanes on one set of
    float32 weights over float32 pools (the port's on CPU lanes)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from swarmdb_tpu.models import llama as jl
    from swarmdb_tpu.models.configs import get_config
    from swarmdb_tpu.parallel.mesh import make_mesh
    from swarmdb_tpu.parallel.serving import build_serving_engine as jbuild
    from swarmdb_tpu_torch.parallel.serving import \
        build_serving_engine as tbuild
    from swarmdb_tpu_torch.utils.convert import params_from_numpy

    monkeypatch.setenv("SWARMDB_KV_DTYPE", "f32")
    for k in ("SWARMDB_FLEET", "SWARMDB_PAGED", "SWARMDB_ROLLING_KV",
              "SWARMDB_SUPERVISE"):
        monkeypatch.delenv(k, raising=False)
    cfg = get_config("tiny-debug")
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jl.init_params(cfg, jax.random.PRNGKey(0)))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jl, "init_params", lambda c, k: jax.device_put(
            params, jax.config.jax_default_device))
        jg, _ = jbuild(cfg, make_mesh(2, data=2, model=1, expert=1),
                       max_batch=4, max_seq=128, paged=True, page_size=8,
                       decode_chunk=4)
    tg, _ = tbuild("tiny-debug", ["cpu"] * 2, max_batch=4, max_seq=128,
                   paged=True, page_size=8, decode_chunk=4,
                   params=params_from_numpy(
                       jax.tree.map(np.asarray, params), device="cpu"))
    return cfg, jg, tg


def _chat(db, user, bot, text, timeout=120.0):
    """One greedy turn: the reply's (content, finish_reason)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            mid = db.send_message(user, bot, text, metadata={
                "generation": {"max_new_tokens": 6, "temperature": 0.0}})
            break
        except LeaderChangedError:
            assert time.monotonic() < deadline, "send kept failing over"
            time.sleep(0.05)
    while time.monotonic() < deadline:
        for m in db.receive_messages(user, timeout=0.2):
            if m.metadata.get("reply_to") == mid:
                return m.content, m.metadata["finish_reason"]
    raise AssertionError(f"no reply to {text!r}")


def _turns(db, turn):
    out = {}
    threads = []
    for u, b in zip(USERS, BOTS):
        def go(u=u, b=b):
            out[u] = _chat(db, u, b, f"{u} says hello, turn {turn}, "
                           f"about the number {turn * 7}")
        threads.append(threading.Thread(target=go))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return [out[u] for u in USERS]


def test_lane_group_rides_partition_leadership(monkeypatch, tmp_path):
    """A tiny-debug group of two CPU lanes serves through a 3-node
    partition-leadership cluster on the port's native brokers: lane pins
    follow partition leaders, re-pin after a leadership move and after a
    node kill, each conversation's pin, shard hint and partition leader
    agree, and every greedy reply equals the JAX package's (same
    weights, its group over a plain LocalBroker)."""
    from swarmdb_tpu.backend.service import ServingService as JService
    from swarmdb_tpu.backend.tokenizer import default_tokenizer as jtok
    from swarmdb_tpu.broker.local import LocalBroker as JBroker
    from swarmdb_tpu.core.runtime import SwarmDB as JDB
    from swarmdb_tpu_torch.backend.service import ServingService
    from swarmdb_tpu_torch.backend.tokenizer import default_tokenizer
    from swarmdb_tpu_torch.broker.native import NativeBroker

    cfg, jg, tg = _groups(monkeypatch)
    harness, cluster, client = build_local_cluster(
        ["n0", "n1", "n2"], suspect_s=SUSPECT_S, dead_s=DEAD_S,
        heartbeat_s=HEARTBEAT_S, partition_leadership=True,
        broker_factory=lambda nid: NativeBroker(
            log_dir=str(tmp_path / nid)))
    n0 = harness.nodes["n0"]
    dbs = []
    svcs = []
    try:
        wait_until(lambda: cluster.read()["leader"] == "n0", WAIT_S,
                   what="bootstrap leader")
        jdb = JDB(broker=JBroker(), save_dir=str(tmp_path / "jax"))
        tdb = SwarmDB(config=BrokerConfig(num_partitions=6),
                      save_dir=str(tmp_path / "port"),
                      broker=n0.client_broker())
        dbs += [jdb, tdb]
        wait_until(lambda: sum(1 for k in cluster.read()["assignments"]
                               if k.startswith(tdb.topic_name + ":")) == 6,
                   WAIT_S, what="the messages topic's assignment")
        for db in dbs:
            for a in USERS + BOTS:
                db.register_agent(a)
            for b in BOTS:
                db.assign_llm_backend(b, "b0")
        jsvc = JService(jdb, jg, jtok(cfg.vocab_size), backend_id="b0")
        tsvc = ServingService(tdb, tg, default_tokenizer(cfg.vocab_size),
                              backend_id="b0")
        tsvc.bind_partition_leadership(n0)
        assert tsvc._locality is not None
        hints = {}
        submit = tsvc._submit

        def recording_submit(req):
            hints[req.metadata.get("message_id")] = req.shard_hint
            return submit(req)

        monkeypatch.setattr(tsvc, "_submit", recording_submit)
        svcs = [jsvc, tsvc]
        for s in svcs:
            s.start(warmup=False)

        def agree():
            """Every conversation's pin names its partition's leader in
            the map, and the lane derived from it."""
            assignments = cluster.read()["assignments"]
            for u, b in zip(USERS, BOTS):
                pin = tsvc._locality.pin(u, b)
                a = assignments.get(tp_key(tdb.topic_name, pin.partition))
                if a is None or pin.leader != a["leader"]:
                    return False
                if pin.lane != tsvc._locality._lane_for(pin.partition,
                                                        a["leader"]):
                    return False
            return True

        for turn in (1, 2, 3):
            if turn == 2:
                # move the leadership of the first conversation's
                # partition through its leader's drain handover (appends
                # stop, the target's mirror acks the whole log, then the
                # CAS): a bare CAS onto a target whose mirror lags forks
                # the partition's log, and a later failover may seat the
                # shorter copy under a consumer already past its end
                part = tsvc._locality.pin(USERS[0], BOTS[0]).partition
                a = cluster.read()["assignments"][tp_key(tdb.topic_name,
                                                         part)]
                target = next(n for n in ("n1", "n2", "n0")
                              if n != a["leader"])
                addr = cluster.read()["nodes"][target]["replica_addr"]
                wait_until(lambda: harness.nodes[a["leader"]]._handover(
                    tdb.topic_name, part, a["epoch"], target, addr),
                    WAIT_S, what="drain handover of the moved partition")
                assert cluster.read()["assignments"][tp_key(
                    tdb.topic_name, part)]["leader"] == target
                wait_until(agree, WAIT_S, what="locality after the move")
            if turn == 3:
                # kill the non-controller leading most partitions
                counts = {}
                for k, a in cluster.read()["assignments"].items():
                    if k.startswith(tdb.topic_name + ":"):
                        counts[a["leader"]] = counts.get(a["leader"], 0) + 1
                victim = max(("n1", "n2"), key=lambda n: counts.get(n, 0))
                harness.kill(victim)
                wait_until(lambda: all(
                    a["leader"] != victim for k, a in
                    cluster.read()["assignments"].items()
                    if k.startswith(tdb.topic_name + ":")),
                    WAIT_S, what="orphans re-seated")
                wait_until(agree, WAIT_S, what="locality after the kill")
            jout = _turns(jdb, turn)
            tout = _turns(tdb, turn)
            assert all(r == "length" for _, r in tout), tout
            assert tout == jout, (turn, tout, jout)
        assert agree()
        # the hint each conversation's last turn carried is its pin's lane
        last = {}
        for m in sorted(tdb.messages.values(), key=lambda m: m.timestamp):
            if m.receiver_id in BOTS and m.id in hints:
                last[(m.sender_id, m.receiver_id)] = hints[m.id]
        for u, b in zip(USERS, BOTS):
            assert last[(u, b)] == tsvc._locality.pin(u, b).lane
        st = tsvc._locality.stats()
        assert st["conversations"] == len(USERS) and st["repins"] >= 1
        repins = [ev for ev in tg.flight.events()
                  if ev.get("kind") == "ha.repin"]
        assert repins
    finally:
        for s in svcs:
            s.stop()
        for db in dbs:
            db.close()
        harness.stop()
        client.close()
        for node in harness.nodes.values():
            try:
                node.broker.close()
            except Exception:
                pass


def _reply_loop_outcome(service_cls, metrics, fail_s, **extra):
    """Run ``service_cls._reply_loop`` over one completion whose produce
    raises the retryable ``LeaderChangedError`` for ``fail_s`` seconds
    (a partition whose leader died, until its promotion): whether the
    reply landed, and the produce attempts. ``extra`` adds the attributes
    the loop reads besides the queue, the stop event and the runtime."""
    import queue
    import types

    calls = []

    def emit(msg, tokens, reason, stop, lps, alts):
        calls.append(time.monotonic())
        if calls[-1] - calls[0] < fail_s:
            raise LeaderChangedError("the partition's leader died")

    svc = types.SimpleNamespace(
        db=types.SimpleNamespace(metrics=metrics),
        _reply_queue=queue.Queue(), _stop=threading.Event(),
        _emit_reply=emit, **extra)
    if hasattr(service_cls, "_emit_with_retry"):
        svc._emit_with_retry = service_cls._emit_with_retry.__get__(svc)
    done = []
    svc._reply_queue.put((types.SimpleNamespace(id="m1"), "r1", [5],
                          "length", (), None, None,
                          lambda *a: done.append(a)))
    svc._reply_queue.put(None)
    service_cls._reply_loop(svc)
    assert done, "the completion's on_done ran"
    return calls[-1] - calls[0] >= fail_s, len(calls)


def test_a_reply_outlasts_its_partition_promotion(monkeypatch):
    """A completion whose reply produce hits a dead partition leader
    lands once the partition is re-seated: the port retries until the
    promotion budget of the bound node's detector times has passed
    (``promotion_budget_s``: dead + 6 x suspect, 8 s at 1.0 / 2.0 s).
    The JAX package stops after ``SWARMDB_REPLY_RETRIES`` (3) attempts,
    whose sleeps total at most 0.7 s, and drops a reply whose produce
    failed for the 5 s here (ROADMAP queue 3)."""
    import types

    from swarmdb_tpu.backend.service import ServingService as JService
    from swarmdb_tpu.utils.metrics import MetricsRegistry as JMetrics
    from swarmdb_tpu_torch.backend.service import ServingService
    from swarmdb_tpu_torch.ha.detector import promotion_budget_s

    for k in ("SWARMDB_REPLY_RETRIES", "SWARMDB_RETRY_BACKOFF_S"):
        monkeypatch.delenv(k, raising=False)
    node = types.SimpleNamespace(suspect_s=SUSPECT_S, dead_s=DEAD_S,
                                 partition_leadership=False)
    assert promotion_budget_s(SUSPECT_S, DEAD_S) == PROMOTE_BUDGET_S
    svc = types.SimpleNamespace(_locality=None)
    ServingService.bind_partition_leadership(svc, node)
    assert svc._failover_budget_s == PROMOTE_BUDGET_S and svc._locality is None
    fail_s = 5.0
    metrics = MetricsRegistry()
    landed, attempts = _reply_loop_outcome(
        ServingService, metrics, fail_s,
        _failover_budget_s=svc._failover_budget_s)
    assert landed and attempts > 4
    assert metrics.counters["reply_retries"].value == attempts - 1
    landed, attempts = _reply_loop_outcome(JService, JMetrics(), fail_s)
    assert not landed and attempts == 4


def test_consumer_rereads_from_the_end_of_a_shorter_copy():
    """A failover that seats a copy of a partition's log shorter than the
    offset a consumer reached (the seated copy holds 2 records, the
    consumer read 4 from the old leader): the next record appended to the
    new leader, at offset 2, still reaches the consumer. The JAX
    package's consumer rewinds only past a trim and waits at offset 4
    forever: the port's re-reads from the new end."""
    from swarmdb_tpu_torch.broker.base import Consumer
    from swarmdb_tpu_torch.broker.local import LocalBroker

    old, new = LocalBroker(), LocalBroker()
    for b in (old, new):
        b.create_topic("t", 1)
    for i in range(4):
        old.append("t", 0, f"m{i}".encode())
        if i < 2:
            new.append("t", 0, f"m{i}".encode())

    class Failover:
        """Reads go to whichever broker leads the partition now."""

        leader = old

        def __getattr__(self, name):
            return getattr(self.leader, name)

    routed = Failover()
    consumer = Consumer(routed, "g", auto_commit=False)
    consumer.assign([("t", 0)])
    got = [consumer.poll(timeout=0.5).value for _ in range(4)]
    assert got == [b"m0", b"m1", b"m2", b"m3"]
    routed.leader = new
    assert consumer.poll(timeout=0.2) is None
    new.append("t", 0, b"after the failover")
    rec = consumer.poll(timeout=1.0)
    assert rec is not None and rec.offset == 2
    assert rec.value == b"after the failover"


def test_orphan_sweep_waits_for_a_registered_peer_whose_probe_missed(
        monkeypatch):
    """The orphan sweep of a survivor (n0, holding 2 records of the
    orphaned partition) whose probe of the other survivor (n2, holding 4)
    goes unanswered twice: it probes again instead of ranking itself
    alone, finds n2 ahead and leaves the partition to n2 -- it never
    seats its own, shorter copy. The JAX package ranks whoever answered
    and seats n0's copy at once."""
    import types

    from swarmdb_tpu_torch.ha import node as hn

    n = object.__new__(hn.HANode)
    n.node_id, n.suspect_s, n.dead_s = "n0", 0.02, 0.2
    n._stop, n._sweeping = threading.Event(), threading.Event()
    n._sync_index = lambda: None
    n._local_partition_ends = lambda: {"t": {"0": 2}}
    passes = []

    class Index:
        def nodes(self):
            return {"n0": {"liveness_addr": "127.0.0.1:1"},
                    "n2": {"liveness_addr": "127.0.0.1:2"}}

        def orphans(self):
            passes.append(1)
            if len(passes) > 4:
                return []
            return [("t:0", {"leader": "n1", "epoch": 3})]

    n._index = Index()
    seated = []
    n.cluster = types.SimpleNamespace(
        try_promote_partition=lambda *a, **k: seated.append(a) or True)
    answers = iter([None, None])
    monkeypatch.setattr(hn, "probe_ends", lambda addr, timeout: next(
        answers, {"ends": {"t": {"0": 4}}}))
    n._sweeping.set()
    n._orphan_sweep_loop()
    assert seated == []
    assert len(passes) == 5 and not n._sweeping.is_set()


def test_a_send_retried_across_a_failover_is_once_in_its_conversation(
        tmp_path):
    """A send whose produce fails over (a retryable LeaderChangedError)
    leaves the conversation: the caller's retry, a new message, is the
    one copy a prompt's history holds. The JAX package keeps the failed
    copy there too, so a lane group's reply after a failover parted from
    its fault-free reference (the lane-group case above)."""
    from swarmdb_tpu_torch.backend.service import build_prompt
    from swarmdb_tpu_torch.backend.tokenizer import default_tokenizer
    from swarmdb_tpu_torch.broker.local import LocalBroker

    class FailsOver(LocalBroker):
        fail = 0

        def append(self, topic, partition, value, key=None, timestamp=None):
            if self.fail and topic == "swarm_messages":
                self.fail -= 1
                raise LeaderChangedError("injected: failover in progress")
            return super().append(topic, partition, value, key, timestamp)

    broker = FailsOver()
    db = SwarmDB(broker=broker, save_dir=str(tmp_path))
    try:
        for a in ("u", "bot"):
            db.register_agent(a)
        db.send_message("u", "bot", "turn 1")
        db.send_message("bot", "u", "reply 1")
        broker.fail = 1
        with pytest.raises(LeaderChangedError):
            db.send_message("u", "bot", "turn 2")
        mid = _send_retry(db, "u", "bot", "turn 2")
        failed = [m for m in db.messages.values()
                  if m.status.value == "failed"]
        assert len(failed) == 1 and failed[0].metadata["retryable"]
        convo = db.get_conversation("u", "bot")
        assert [m.content for m in convo] == ["turn 1", "reply 1", "turn 2"]
        assert convo[-1].id == mid
        window = db.get_conversation_window("u", "bot", 64)
        assert [m.id for m in window] == [m.id for m in convo]
        tok = default_tokenizer(512)
        text = tok.decode(build_prompt(db, db.get_message(mid), tok))
        assert text.count("turn 2") == 1, text
    finally:
        db.close()
