"""The port's segment-log replication (``swarmdb_tpu_torch/broker/replica.py``)
against the JAX package's: a port leader streams to a JAX follower and the
other way round with byte-equal logs, acks=all delivery gating, follower
catch-up and resync, the follower CLI, the runtime's
``replication_factor``, and (over raw sockets speaking the JAX package's
frame layouts) the follower's single-active-leader, epoch and
partition-scoped fencing, as in ``tests/test_replication.py`` and
``tests/test_replica_split_brain.py``.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import swarmdb_tpu.broker.replica as jax_replica
import swarmdb_tpu_torch.broker.replica as port_replica
from swarmdb_tpu.broker.native import NativeBroker as JaxNativeBroker
from swarmdb_tpu.broker.native import native_available as jax_native_available
from swarmdb_tpu_torch.broker.base import BrokerError
from swarmdb_tpu_torch.broker.local import LocalBroker
from swarmdb_tpu_torch.broker.native import NativeBroker, native_available
from swarmdb_tpu_torch.broker.replica import ReplicatedBroker, ReplicaServer

ROOT = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(
    not (native_available() and jax_native_available()),
    reason="no C++17 compiler to build the native brokers")

PKGS = {"port": (NativeBroker, port_replica),
        "jax": (JaxNativeBroker, jax_replica)}

# (leader package, follower package)
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mk_pair(tmp_path, leader_pkg="port", follower_pkg="port"):
    lb, lrep = PKGS[leader_pkg]
    fb, frep = PKGS[follower_pkg]
    follower = fb(log_dir=str(tmp_path / "follower"), sync_interval_ms=1)
    server = frep.ReplicaServer(follower).start()
    leader = lrep.ReplicatedBroker(
        lb(log_dir=str(tmp_path / "leader"), sync_interval_ms=1),
        [f"127.0.0.1:{server.port}"])
    return leader, follower, server


def test_frames_are_the_jax_packages():
    """Every frame header and the epoch topic are the JAX package's."""
    for name in ("_REC_HDR", "_ACK_HDR", "_LEN", "_EPOCH", "_CMT_HDR",
                 "_TRIM_HDR", "_PART_HDR"):
        assert (getattr(port_replica, name).format
                == getattr(jax_replica, name).format), name
    assert port_replica.HA_EPOCH_TOPIC == jax_replica.HA_EPOCH_TOPIC


@pytest.mark.parametrize("leader_pkg,follower_pkg", PAIRS,
                         ids=["-".join(p) for p in PAIRS])
def test_replicates_log_and_gates_delivery(tmp_path, leader_pkg,
                                           follower_pkg):
    """Records, commits and trims stream across; the follower's segment
    files are byte-equal to the leader's, whichever package leads."""
    leader, follower, server = _mk_pair(tmp_path, leader_pkg, follower_pkg)
    try:
        leader.create_topic("t", 2)
        now = time.time()
        for i in range(40):
            leader.append("t", i % 2, f"m{i}".encode(),
                          key=None if i % 5 == 0 else f"k{i}".encode(),
                          timestamp=now + i)
        leader.commit_offset("g", "t", 1, 7)
        for part in (0, 1):
            end = leader.end_offset("t", part)
            assert leader.wait_durable("t", part, end - 1, timeout_s=30)
            mine = leader.fetch("t", part, 0, 100)
            theirs = follower.fetch("t", part, 0, 100)
            assert ([(r.offset, r.key, r.value, r.timestamp) for r in mine]
                    == [(r.offset, r.key, r.value, r.timestamp)
                        for r in theirs])
            assert leader.durable_offset("t", part) == end
        deadline = time.time() + 30
        while (time.time() < deadline
               and follower.committed_offset("g", "t", 1) != 7):
            time.sleep(0.01)
        assert follower.committed_offset("g", "t", 1) == 7
    finally:
        leader.close()
        server.stop()
        follower.close()
    for part in (0, 1):
        a = (tmp_path / "leader" / "t" / f"{part}.log").read_bytes()
        b = (tmp_path / "follower" / "t" / f"{part}.log").read_bytes()
        assert a == b


def test_replication_lag_stats_drain_and_stall(tmp_path):
    """Per-follower lag drains to 0 while the follower keeps up; a dead
    follower shows growing lag_records and an aging lag_seconds."""
    leader, follower, server = _mk_pair(tmp_path)
    try:
        leader.create_topic("t", 1)
        for i in range(20):
            leader.append("t", 0, f"m{i}".encode())
        deadline = time.time() + 30
        stats = None
        while time.time() < deadline:
            stats = leader.replication_stats()
            if stats[0]["lag_records"] == 0:
                break
            time.sleep(0.02)
        assert stats and stats[0]["lag_records"] == 0, stats
        assert stats[0]["target"].endswith(f":{server.port}")
        assert stats[0]["connected"] is True
        assert stats[0]["lag_seconds"] == 0.0
        assert stats[0]["gapped"] == 0
        server.stop()
        follower.close()
        for i in range(7):
            leader.append("t", 0, f"late{i}".encode())
        deadline = time.time() + 30
        while time.time() < deadline:
            stats = leader.replication_stats()
            if stats[0]["lag_records"] >= 7 and stats[0]["lag_seconds"] > 0:
                break
            time.sleep(0.05)
        assert stats[0]["lag_records"] >= 7, stats
        assert stats[0]["lag_seconds"] > 0.0
    finally:
        leader.close()
        try:
            server.stop()
            follower.close()
        except Exception:
            pass


def test_delivery_stalls_without_follower(tmp_path):
    raw = NativeBroker(log_dir=str(tmp_path / "leader"), sync_interval_ms=1)
    leader = ReplicatedBroker(raw, ["127.0.0.1:1"])  # nothing listens
    try:
        leader.create_topic("t", 1)
        leader.append("t", 0, b"v")
        assert raw.wait_durable("t", 0, 0, timeout_s=10)
        assert not leader.wait_durable("t", 0, 0, timeout_s=0.3)
        assert leader.durable_offset("t", 0) == 0
    finally:
        leader.close()


def test_follower_catches_up_after_late_start(tmp_path):
    raw = NativeBroker(log_dir=str(tmp_path / "leader"), sync_interval_ms=1)
    follower = NativeBroker(log_dir=str(tmp_path / "follower"),
                            sync_interval_ms=1)
    server = ReplicaServer(follower)  # not started yet
    leader = ReplicatedBroker(raw, [f"127.0.0.1:{server.port}"])
    try:
        leader.create_topic("t", 1)
        for i in range(10):
            leader.append("t", 0, f"early{i}".encode())
        assert not leader.wait_durable("t", 0, 9, timeout_s=0.3)
        server.start()
        assert leader.wait_durable("t", 0, 9, timeout_s=30)
        assert [r.value for r in follower.fetch("t", 0, 0, 100)] == \
               [f"early{i}".encode() for i in range(10)]
    finally:
        leader.close()
        server.stop()
        follower.close()


@pytest.mark.parametrize("cli_pkg", ["swarmdb_tpu_torch", "swarmdb_tpu"])
def test_delivered_survives_leader_loss(tmp_path, cli_pkg):
    """After wait_durable, the leader's whole log directory can go: the
    follower CLI's directory serves every acked record. The port's leader
    streams to the follower CLI of either package."""
    fdir = str(tmp_path / "follower")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{cli_pkg}.broker.replica", "--log-dir",
         fdir, "--listen", "127.0.0.1:0", "--sync-interval-ms", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)))
    try:
        line = proc.stdout.readline()
        assert line.startswith("REPLICA_READY "), line
        addr = line.split()[1].strip()
        ldir = tmp_path / "leader"
        leader = ReplicatedBroker(
            NativeBroker(log_dir=str(ldir), sync_interval_ms=1), [addr])
        leader.create_topic("t", 1)
        for i in range(25):
            leader.append("t", 0, f"precious{i}".encode())
        assert leader.wait_durable("t", 0, 24, timeout_s=30)
        leader.close()
        shutil.rmtree(ldir)
    finally:
        proc.kill()
        proc.wait()
    recovered = NativeBroker(log_dir=fdir)
    try:
        assert [r.value for r in recovered.fetch("t", 0, 0, 100)] == \
            [f"precious{i}".encode() for i in range(25)]
    finally:
        recovered.close()


def test_runtime_wiring(tmp_path, monkeypatch):
    """SwarmDB takes replication_factor > 1 iff its followers are named;
    DELIVERED then rides the replicated watermark."""
    from swarmdb_tpu_torch.core.messages import BrokerConfig, MessageStatus
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    cfg = BrokerConfig(replication_factor=2)
    monkeypatch.delenv("SWARMDB_REPLICA_TARGETS", raising=False)
    with pytest.raises(ValueError, match="SWARMDB_REPLICA_TARGETS"):
        SwarmDB(config=cfg, save_dir=str(tmp_path / "h0"))
    follower = NativeBroker(log_dir=str(tmp_path / "follower"),
                            sync_interval_ms=1)
    server = ReplicaServer(follower).start()
    monkeypatch.setenv("SWARMDB_REPLICA_TARGETS",
                       f"127.0.0.1:{server.port}")
    db = SwarmDB(config=cfg, broker=NativeBroker(
        log_dir=str(tmp_path / "leader"), sync_interval_ms=1),
        save_dir=str(tmp_path / "h1"))
    try:
        assert isinstance(db.broker, ReplicatedBroker)
        db.register_agent("a")
        db.register_agent("b")
        mid = db.send_message("a", "b", "replicated hello")
        deadline = time.time() + 30
        while (time.time() < deadline
               and db.messages[mid].status != MessageStatus.DELIVERED):
            time.sleep(0.02)
        assert db.messages[mid].status == MessageStatus.DELIVERED
        found = []
        for name, meta in follower.list_topics().items():
            for p in range(meta.num_partitions):
                found += [r.value for r in follower.fetch(name, p, 0, 1000)]
        assert any(b"replicated hello" in v for v in found)
    finally:
        db.close()
        server.stop()
        follower.close()


def test_leader_restart_acks_idle_partitions(tmp_path):
    """A restarted leader's fresh Replicator gets the follower's whole
    fsync watermark, idle partitions included."""
    follower = NativeBroker(log_dir=str(tmp_path / "follower"),
                            sync_interval_ms=1)
    server = ReplicaServer(follower).start()
    target = f"127.0.0.1:{server.port}"
    leader1 = ReplicatedBroker(
        NativeBroker(log_dir=str(tmp_path / "leader"), sync_interval_ms=1),
        [target])
    try:
        leader1.create_topic("t", 1)
        leader1.append("t", 0, b"old")
        assert leader1.wait_durable("t", 0, 0, timeout_s=30)
    finally:
        leader1.close()
    leader2 = ReplicatedBroker(
        NativeBroker(log_dir=str(tmp_path / "leader"), sync_interval_ms=1),
        [target])
    try:
        assert leader2.wait_durable("t", 0, 0, timeout_s=30)
    finally:
        leader2.close()
        server.stop()
        follower.close()


def test_wiped_follower_clamps_watermark_and_resyncs(tmp_path):
    port = _free_port()
    f1 = NativeBroker(log_dir=str(tmp_path / "f"), sync_interval_ms=1)
    srv1 = ReplicaServer(f1, port=port).start()
    leader = ReplicatedBroker(
        NativeBroker(log_dir=str(tmp_path / "leader"), sync_interval_ms=1),
        [f"127.0.0.1:{port}"])
    try:
        leader.create_topic("t", 1)
        for i in range(10):
            leader.append("t", 0, f"m{i}".encode())
        assert leader.wait_durable("t", 0, 9, timeout_s=30)
        srv1.stop()
        f1.close()
        shutil.rmtree(tmp_path / "f")
        f2 = NativeBroker(log_dir=str(tmp_path / "f"), sync_interval_ms=1)
        srv2 = ReplicaServer(f2, port=port).start()
        try:
            off = leader.append("t", 0, b"post-wipe")
            assert leader.wait_durable("t", 0, off, timeout_s=30)
            assert [r.value for r in f2.fetch("t", 0, 0, 100)] == \
                [f"m{i}".encode() for i in range(10)] + [b"post-wipe"]
        finally:
            srv2.stop()
            f2.close()
    finally:
        leader.close()


def test_concurrent_writers_follower_restart_converges(tmp_path):
    """Writers on three partitions while the follower restarts on its
    port: afterwards every record is mirrored in order, no gap, no
    duplicate."""
    port = _free_port()
    f1 = NativeBroker(log_dir=str(tmp_path / "f"), sync_interval_ms=1)
    srv1 = ReplicaServer(f1, port=port).start()
    leader = ReplicatedBroker(
        NativeBroker(log_dir=str(tmp_path / "leader"), sync_interval_ms=1),
        [f"127.0.0.1:{port}"])
    leader.create_topic("t", 3)
    counts = [0, 0, 0, 0]
    half = threading.Barrier(5)

    def writer(tid: int) -> None:
        for i in range(300):
            leader.append("t", (tid + i) % 3, f"w{tid}-{i}".encode())
            counts[tid] = i + 1
            if i == 150:
                half.wait(timeout=60)
            if i % 50 == 0:
                time.sleep(0.005)

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    srv2 = f2 = None
    try:
        srv1.stop()        # the follower dies mid-traffic
        f1.close()
        half.wait(timeout=60)   # writers are past halfway while it is down
        f2 = NativeBroker(log_dir=str(tmp_path / "f"), sync_interval_ms=1)
        srv2 = ReplicaServer(f2, port=port).start()
        for t in threads:
            t.join(timeout=120)
        assert all(not t.is_alive() for t in threads)
        for part in range(3):
            end = leader.end_offset("t", part)
            assert leader.wait_durable("t", part, end - 1, timeout_s=60)
            assert ([(r.offset, r.value)
                     for r in leader.fetch("t", part, 0, 5000)]
                    == [(r.offset, r.value)
                        for r in f2.fetch("t", part, 0, 5000)])
        assert sum(counts) == 1200
    finally:
        leader.close()
        if srv2 is not None:
            srv2.stop()
            f2.close()


# --------------------------------------- the follower's fencing, on the wire
# (raw sockets with the JAX package's frame layouts against the port's
# follower, as a JAX leader would speak to it)

_EPOCH, _LEN, _REC_HDR = jax_replica._EPOCH, jax_replica._LEN, \
    jax_replica._REC_HDR
_PART_HDR, _ACK_HDR = jax_replica._PART_HDR, jax_replica._ACK_HDR
_recv_exact = jax_replica._recv_exact


def _connect_and_hello(server, epoch=0):
    sock = socket.create_connection((server.host, server.port), timeout=10)
    sock.settimeout(10)
    sock.sendall(b"E" + _EPOCH.pack(epoch))
    assert _recv_exact(sock, 1) == b"H"
    (jlen,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    hello = json.loads(_recv_exact(sock, jlen))
    return sock, hello["ends"]


def _send_topic(sock, name, parts=1):
    spec = json.dumps({"name": name, "parts": parts}).encode()
    sock.sendall(b"T" + _LEN.pack(len(spec)) + spec)


def _send_record(sock, topic, part, offset, value):
    t = topic.encode()
    sock.sendall(b"R" + _REC_HDR.pack(len(t), part, offset, time.time(), -1,
                                      len(value)) + t + value)


def _send_lease(sock, topic, part, epoch):
    t = topic.encode()
    sock.sendall(b"Q" + _PART_HDR.pack(len(t), part, epoch) + t)


def _end_offset(broker, topic, part):
    try:
        return broker.end_offset(topic, part)
    except BrokerError:
        return 0


def _wait_end(broker, topic, part, n, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline and _end_offset(broker, topic, part) < n:
        time.sleep(0.01)
    return _end_offset(broker, topic, part)


def _recv_partition_fence(sock):
    """The next N frame, skipping the ack loop's A frames."""
    while True:
        ftype = _recv_exact(sock, 1)
        if ftype == b"A":
            tlen, _, _ = _ACK_HDR.unpack(_recv_exact(sock, _ACK_HDR.size))
            _recv_exact(sock, tlen)
            continue
        assert ftype == b"N"
        tlen, part, epoch = _PART_HDR.unpack(
            _recv_exact(sock, _PART_HDR.size))
        return _recv_exact(sock, tlen).decode(), part, epoch


def test_second_leader_supersedes_stale_stream():
    broker = LocalBroker()
    server = ReplicaServer(broker).start()
    try:
        stale, _ = _connect_and_hello(server)
        fresh, _ = _connect_and_hello(server)
        closed = False
        deadline = time.time() + 10
        while time.time() < deadline and not closed:
            try:
                closed = stale.recv(4096) == b""
            except OSError:
                closed = True
        assert closed, "the stale stream was not closed"
        try:
            _send_topic(stale, "ghost")
            _send_record(stale, "ghost", 0, 0, b"from-the-dead")
        except OSError:
            pass
        _send_topic(fresh, "t")
        _send_record(fresh, "t", 0, 0, b"alive")
        assert _wait_end(broker, "t", 0, 1) == 1
        assert [r.value for r in broker.fetch("t", 0, 0, 10)] == [b"alive"]
        time.sleep(0.1)
        assert "ghost" not in broker.list_topics()
    finally:
        server.stop()
        broker.close()


def test_stale_epoch_leader_is_fenced_without_disturbing_active():
    broker = LocalBroker()
    server = ReplicaServer(broker).start()
    try:
        active, _ = _connect_and_hello(server, epoch=5)
        stale = socket.create_connection((server.host, server.port),
                                         timeout=10)
        stale.settimeout(10)
        stale.sendall(b"E" + _EPOCH.pack(3))
        assert _recv_exact(stale, 1) == b"F"
        assert _EPOCH.unpack(_recv_exact(stale, _EPOCH.size)) == (5,)
        assert stale.recv(4096) == b""
        stale.close()
        _send_topic(active, "t")
        _send_record(active, "t", 0, 0, b"still-leader")
        _wait_end(broker, "t", 0, 1)
        assert [r.value for r in broker.fetch("t", 0, 0, 10)] == \
            [b"still-leader"]
        # the floor is sticky once the active stream drops
        active.close()
        time.sleep(0.1)
        late = socket.create_connection((server.host, server.port),
                                        timeout=10)
        late.settimeout(10)
        late.sendall(b"E" + _EPOCH.pack(3))
        assert _recv_exact(late, 1) == b"F"
        late.close()
    finally:
        server.stop()
        broker.close()


def test_partition_scoped_fencing_on_the_wire():
    """Q frames: a stale lease epoch gets an N frame and its records are
    dropped, for that partition only; a higher epoch takes over."""
    broker = LocalBroker()
    server = ReplicaServer(broker, partition_mode=True).start()
    socks = []
    try:
        fresh, _ = _connect_and_hello(server, epoch=0)
        stale, _ = _connect_and_hello(server, epoch=0)
        socks += [fresh, stale]
        _send_topic(fresh, "t", 2)
        _send_lease(fresh, "t", 0, 5)
        _send_record(fresh, "t", 0, 0, b"owner-write")
        assert _wait_end(broker, "t", 0, 1) == 1
        _send_lease(stale, "t", 0, 3)
        assert _recv_partition_fence(stale) == ("t", 0, 5)
        _send_record(stale, "t", 0, 1, b"from-the-dead")
        _send_lease(stale, "t", 1, 1)
        _send_record(stale, "t", 1, 0, b"other-partition-fine")
        assert _wait_end(broker, "t", 1, 1) == 1
        time.sleep(0.1)
        assert [r.value for r in broker.fetch("t", 0, 0, 10)] == \
            [b"owner-write"]
        _send_record(fresh, "t", 0, 1, b"owner-write-2")
        assert _wait_end(broker, "t", 0, 2) == 2
        _send_lease(stale, "t", 0, 7)
        _send_record(stale, "t", 0, 2, b"new-leader-write")
        _wait_end(broker, "t", 0, 3)
        assert [r.value for r in broker.fetch("t", 0, 2, 10)] == \
            [b"new-leader-write"]
    finally:
        for s in socks:
            s.close()
        server.stop()
        broker.close()


def test_flapping_leader_reconnect_keeps_mirroring():
    broker = LocalBroker()
    server = ReplicaServer(broker).start()
    socks = []
    try:
        offset = 0
        for _ in range(3):
            sock, ends = _connect_and_hello(server)
            socks.append(sock)
            assert int(ends.get("t", {}).get("0", 0)) == offset
            _send_topic(sock, "t")
            for _ in range(4):
                _send_record(sock, "t", 0, offset, b"m%d" % offset)
                offset += 1
            assert _wait_end(broker, "t", 0, offset) == offset
        assert [r.value for r in broker.fetch("t", 0, 0, 100)] == \
            [b"m%d" % i for i in range(offset)]
    finally:
        for s in socks:
            s.close()
        server.stop()
        broker.close()


@pytest.mark.parametrize("leader_pkg,follower_pkg",
                         [("port", "jax"), ("jax", "port")],
                         ids=["port-jax", "jax-port"])
def test_an_epoch_fences_across_packages(tmp_path, leader_pkg,
                                         follower_pkg):
    """A follower of either package that has seen epoch 5 refuses the
    other package's leader at epoch 3 (its appends raise FencedError),
    and takes one at epoch 6."""
    lb, lrep = PKGS[leader_pkg]
    fb, frep = PKGS[follower_pkg]
    follower = fb(log_dir=str(tmp_path / "f"), sync_interval_ms=1)
    server = frep.ReplicaServer(follower).start()
    target = [f"127.0.0.1:{server.port}"]
    brokers = []
    try:
        first = lrep.ReplicatedBroker(
            lb(log_dir=str(tmp_path / "l5"), sync_interval_ms=1), target,
            epoch=5)
        brokers.append(first)
        first.create_topic("t", 1)
        first.append("t", 0, b"e5")
        assert first.wait_durable("t", 0, 0, timeout_s=30)
        stale = lrep.ReplicatedBroker(
            lb(log_dir=str(tmp_path / "l3"), sync_interval_ms=1), target,
            epoch=3)
        brokers.append(stale)
        deadline = time.time() + 30
        fenced = False
        while time.time() < deadline and not fenced:
            try:
                stale.create_topic("t", 1)
                stale.append("t", 0, b"e3")
                time.sleep(0.05)
            except Exception as exc:
                fenced = type(exc).__name__ == "FencedError"
        assert fenced
        fresh = lrep.ReplicatedBroker(
            lb(log_dir=str(tmp_path / "l6"), sync_interval_ms=1), target,
            epoch=6)
        brokers.append(fresh)
        fresh.create_topic("u", 1)
        fresh.append("u", 0, b"e6")
        assert fresh.wait_durable("u", 0, 0, timeout_s=30)
        assert [r.value for r in follower.fetch("u", 0, 0)] == [b"e6"]
        assert [r.value for r in follower.fetch("t", 0, 0)] == [b"e5"]
    finally:
        for b in brokers:
            b.close()
        server.stop()
        follower.close()
