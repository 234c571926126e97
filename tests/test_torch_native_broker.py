"""The port's native broker (``swarmdb_tpu_torch/broker/native.py`` over its
own ``broker/cpp/broker.cpp``) against the JAX package's: the engine's
durability, crash recovery and concurrency cases of
``tests/test_native_broker.py``, the same seeded operations giving the same
offsets, records, committed offsets and trims in both, a log directory
written by either opening in the other, a first build that two processes
race, and ``BROKER_IMPL`` picking the same broker class in both packages.
"""

import os
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from swarmdb_tpu.broker.native import NativeBroker as JaxNativeBroker
from swarmdb_tpu.broker.native import native_available as jax_native_available
from swarmdb_tpu_torch.broker import native as port_native
from swarmdb_tpu_torch.broker.base import BrokerError, Producer
from swarmdb_tpu_torch.broker.native import NativeBroker, native_available

ROOT = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(
    not (native_available() and jax_native_available()),
    reason="no C++17 compiler to build the native brokers")


# ------------------------------------------------- the engine's own cases


def test_reopen_restores_log_and_offsets(tmp_path):
    d = str(tmp_path / "log")
    b = NativeBroker(log_dir=d)
    b.create_topic("t", 2, retention_ms=12345)
    for i in range(5):
        b.append("t", 1, f"v{i}".encode(), key=f"k{i}".encode())
    b.commit_offset("grp", "t", 1, 3)
    b.close()

    b2 = NativeBroker(log_dir=d)
    meta = b2.list_topics()["t"]
    assert meta.num_partitions == 2
    assert meta.retention_ms == 12345
    recs = b2.fetch("t", 1, 0, 100)
    assert [r.value for r in recs] == [b"v0", b"v1", b"v2", b"v3", b"v4"]
    assert recs[2].key == b"k2"
    assert b2.end_offset("t", 1) == 5
    assert b2.committed_offset("grp", "t", 1) == 3
    b2.close()


def test_torn_tail_truncated_on_reopen(tmp_path):
    d = str(tmp_path / "log")
    b = NativeBroker(log_dir=d)
    b.create_topic("t", 1)
    b.append("t", 0, b"good-1")
    b.append("t", 0, b"good-2")
    b.close()
    # a crash mid-append: half a record at the log's tail
    with open(os.path.join(d, "t", "0.log"), "ab") as f:
        f.write(struct.pack("<IqdiI", 0x53574252, 2, time.time(), -1,
                            999)[:20])
    b2 = NativeBroker(log_dir=d)
    assert [r.value for r in b2.fetch("t", 0, 0, 10)] == [b"good-1",
                                                         b"good-2"]
    assert b2.append("t", 0, b"good-3") == 2
    assert b2.fetch("t", 0, 2)[0].value == b"good-3"
    b2.close()


@pytest.mark.parametrize("full", [False, True], ids=["partial", "full"])
def test_trim_then_reopen_keeps_offsets(tmp_path, full):
    """A trimmed head stays trimmed and offsets never restart, even when
    every record was trimmed (committed consumers would be stranded)."""
    d = str(tmp_path / "log")
    b = NativeBroker(log_dir=d)
    b.create_topic("t", 1)
    now = time.time()
    n_old = 5 if full else 1
    for i in range(n_old):
        b.append("t", 0, f"old{i}".encode(), timestamp=now - 100)
    if not full:
        b.append("t", 0, b"new", timestamp=now)
    b.commit_offset("g", "t", 0, n_old)
    assert b.trim_older_than("t", now - 50) == n_old
    assert b.begin_offset("t", 0) == n_old
    b.close()
    b2 = NativeBroker(log_dir=d)
    assert b2.begin_offset("t", 0) == n_old
    if full:
        assert b2.end_offset("t", 0) == n_old
        assert b2.append("t", 0, b"fresh") == n_old
        recs = b2.fetch("t", 0, b2.committed_offset("g", "t", 0))
        assert [r.value for r in recs] == [b"fresh"]
    else:
        recs = b2.fetch("t", 0, 0, 10)
        assert [(r.offset, r.value) for r in recs] == [(1, b"new")]
    b2.close()


def test_large_values_and_fetch_regrowth(tmp_path):
    b = NativeBroker(log_dir=str(tmp_path / "log"))
    b.create_topic("t", 1)
    big = os.urandom(3 << 20)  # larger than the first fetch buffer
    b.append("t", 0, big)
    assert b.fetch("t", 0, 0)[0].value == big
    b.close()


def test_concurrent_producers_consumers(tmp_path):
    b = NativeBroker(log_dir=str(tmp_path / "log"))
    b.create_topic("t", 4)
    n_producers, per = 6, 150
    errors, seen = [], []
    stop = threading.Event()

    def produce(i):
        try:
            for j in range(per):
                b.append("t", j % 4, f"{i}:{j}".encode())
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def consume(part):
        off = 0
        while not stop.is_set() or b.end_offset("t", part) > off:
            recs = b.fetch("t", part, off, 64)
            if not recs:
                b.wait_for_data("t", part, off, 0.01)
                continue
            seen.extend(r.value for r in recs)
            off = recs[-1].offset + 1

    producers = [threading.Thread(target=produce, args=(i,))
                 for i in range(n_producers)]
    consumers = [threading.Thread(target=consume, args=(p,))
                 for p in range(4)]
    for t in consumers + producers:
        t.start()
    for t in producers:
        t.join()
    stop.set()
    for t in consumers:
        t.join(timeout=30)
    assert not errors
    assert len(seen) == len(set(seen)) == n_producers * per
    b.close()


def test_swarmdb_over_native_broker(tmp_path):
    """The port's runtime on the C++ engine, restart included."""
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    d = str(tmp_path / "log")
    db = SwarmDB(broker=NativeBroker(log_dir=d),
                 save_dir=str(tmp_path / "hist"))
    db.register_agent("a")
    db.register_agent("b")
    mid = db.send_message("a", "b", "over native")
    assert [m.id for m in db.receive_messages("b", max_messages=5,
                                              timeout=1.0)] == [mid]
    db.broadcast_message("a", "all hands")
    assert len(db.receive_messages("b", max_messages=5, timeout=1.0)) == 1
    snap = db.save_message_history()
    db.close()

    db2 = SwarmDB(broker=NativeBroker(log_dir=d),
                  save_dir=str(tmp_path / "hist"))
    db2.load_message_history(snap)
    assert db2.get_message(mid).content == "over native"
    # committed offsets survived: nothing is redelivered
    assert db2.receive_messages("b", max_messages=5, timeout=0.3) == []
    db2.close()


def test_delivered_means_durable_across_kill(tmp_path):
    """A child produces with delivery reports, prints the acked offsets
    and dies with ``os._exit`` (no flush, no close): every acked offset is
    in the log when it is reopened."""
    d = str(tmp_path / "log")
    child = (
        "import os, sys, time\n"
        "from swarmdb_tpu_torch.broker.native import NativeBroker\n"
        "from swarmdb_tpu_torch.broker.base import Producer\n"
        "b = NativeBroker(log_dir=sys.argv[1], sync_interval_ms=2)\n"
        "b.create_topic('t', 1)\n"
        "p = Producer(b)\n"
        "acked = []\n"
        "for i in range(50):\n"
        "    p.produce('t', b'v%d' % i, partition=0,\n"
        "              on_delivery=lambda e, r: acked.append(r.offset))\n"
        "    p.poll(0)\n"
        "deadline = time.time() + 20\n"
        "while len(acked) < 10 and time.time() < deadline:\n"
        "    time.sleep(0.005); p.poll(0)\n"
        "sys.stdout.write(','.join(map(str, acked)))\n"
        "sys.stdout.flush()\n"
        "os._exit(1)\n")
    proc = subprocess.run([sys.executable, "-c", child, d],
                          capture_output=True, text=True, timeout=120,
                          cwd=str(ROOT),
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    acked = [int(x) for x in proc.stdout.split(",") if x]
    assert len(acked) >= 10, proc.stderr[-2000:]
    b = NativeBroker(log_dir=d)
    present = {r.offset for r in b.fetch("t", 0, 0, 100)}
    assert set(acked) <= present
    b.close()


def test_unacked_callbacks_defer_until_durable(tmp_path):
    b = NativeBroker(log_dir=str(tmp_path / "log"), sync_interval_ms=2000)
    b.create_topic("t", 1)
    p = Producer(b)
    acked = []
    p.produce("t", b"v", partition=0, on_delivery=lambda e, r: acked.append(r))
    # the flusher runs every 2 s: an immediate poll fires nothing
    assert p.poll(0) == 0 and acked == []
    assert p.pending_count == 1
    p.flush()  # forces the group commit
    assert len(acked) == 1
    assert b.durable_offset("t", 0) == 1
    b.close()


def test_wait_durable(tmp_path):
    b = NativeBroker(log_dir=str(tmp_path / "log"), sync_interval_ms=2)
    b.create_topic("t", 1)
    off = b.append("t", 0, b"v")
    assert b.wait_durable("t", 0, off, timeout_s=10.0)
    assert b.durable_offset("t", 0) > off
    b.close()


def test_topic_name_sanitization(tmp_path):
    b = NativeBroker(log_dir=str(tmp_path / "log"))
    for bad in ["../evil", "a/b", "a\\b", "__offsets__", "__offsets__.log",
                "a\tb", "a\nb", "", "x" * 256, "."]:
        with pytest.raises(BrokerError):
            b.create_topic(bad, 1)
    assert b.create_topic("fine-topic.v1", 1)
    b.close()


def test_offsets_log_escaping_roundtrip(tmp_path):
    d = str(tmp_path / "log")
    b = NativeBroker(log_dir=d)
    b.create_topic("t", 1)
    nasty = "agent\twith\nnasty%chars" + "x" * 600
    b.commit_offset(nasty, "t", 0, 7)
    b.commit_offset("plain", "t", 0, 3)
    b.close()
    b2 = NativeBroker(log_dir=d)  # reopen parses and compacts the log
    assert b2.committed_offset(nasty, "t", 0) == 7
    assert b2.committed_offset("plain", "t", 0) == 3
    b2.close()


def test_explicit_flush_racing_background_flusher(tmp_path):
    """A flush returns only once its records are durable, even against a
    1 ms background flusher."""
    b = NativeBroker(log_dir=str(tmp_path / "log"), sync_interval_ms=1)
    b.create_topic("t", 1)
    p = Producer(b)
    acked = []
    for i in range(200):
        p.produce("t", b"v%d" % i, partition=0,
                  on_delivery=lambda e, r: acked.append(r.offset))
        p.flush()
        assert len(acked) == i + 1, f"flush returned without ack {i}"
    b.close()


# ------------------------------------------------- against the JAX package


def _seeded_ops(broker, seed: int):
    """One seeded sequence of operations; returns everything observable."""
    rng = np.random.default_rng(seed)
    out = {"created": [broker.create_topic("alpha", 3, retention_ms=9000),
                       broker.create_topic("beta.v1", 2),
                       broker.create_topic("alpha", 3)]}
    now = 1_700_000_000.0
    offs = []
    for i in range(120):
        topic, nparts = (("alpha", 3), ("beta.v1", 2))[int(rng.integers(2))]
        part = int(rng.integers(nparts))
        n = int(rng.integers(0, 300))
        value = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        key = (None if rng.random() < 0.3
               else f"k{int(rng.integers(50))}".encode())
        ts = now + float(rng.integers(-500, 500))
        offs.append((topic, part, broker.append(topic, part, value, key=key,
                                                timestamp=ts)))
    out["offsets"] = offs
    for g in range(6):
        broker.commit_offset(f"grp{g % 3}", "alpha", g % 3,
                             int(rng.integers(0, 40)))
    out["trimmed"] = [broker.trim_older_than("alpha", now - 100),
                      broker.trim_older_than("beta.v1", now - 400)]
    broker.create_partitions("beta.v1", 4)
    out["appended_after"] = broker.append("beta.v1", 3, b"late", key=b"z",
                                          timestamp=now)
    out["state"] = _observe(broker)
    return out


def _observe(broker):
    topics = broker.list_topics()
    state = {"topics": {n: (m.num_partitions, m.retention_ms)
                        for n, m in sorted(topics.items())
                        if not n.startswith("__")}}
    for name in state["topics"]:
        for p in range(topics[name].num_partitions):
            state[f"{name}[{p}]"] = (
                broker.begin_offset(name, p), broker.end_offset(name, p),
                [(r.offset, r.key, r.value, r.timestamp)
                 for r in broker.fetch(name, p, 0, 1000)])
    state["committed"] = [broker.committed_offset(f"grp{g}", "alpha", p)
                          for g in range(3) for p in range(3)]
    return state


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_ops_agree_with_jax(tmp_path, seed):
    port = NativeBroker(log_dir=str(tmp_path / "port"))
    jax = JaxNativeBroker(log_dir=str(tmp_path / "jax"))
    try:
        assert _seeded_ops(port, seed) == _seeded_ops(jax, seed)
    finally:
        port.close()
        jax.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_log_opens_in_the_other_package(tmp_path, writer):
    """A log directory written by either package opens in the other with
    the same topics, records and committed offsets, and the segment files
    are byte-equal to those the other package writes from the same ops."""
    make = {"port": NativeBroker, "jax": JaxNativeBroker}
    reader = "jax" if writer == "port" else "port"
    b = make[writer](log_dir=str(tmp_path / "a"))
    _seeded_ops(b, 3)
    written = _observe(b)
    b.close()
    b = make[reader](log_dir=str(tmp_path / "a"))
    try:
        assert _observe(b) == written
        # and it keeps appending where the writer stopped
        end = b.end_offset("alpha", 0)
        assert b.append("alpha", 0, b"more") == end
    finally:
        b.close()
    other = make[reader](log_dir=str(tmp_path / "b"))
    _seeded_ops(other, 3)
    other.close()
    for topic, parts in (("alpha", 3), ("beta.v1", 4)):
        for p in range(parts):
            a = (tmp_path / "a" / topic / f"{p}.log").read_bytes()
            bb = (tmp_path / "b" / topic / f"{p}.log").read_bytes()
            if topic == "alpha" and p == 0:
                assert a.startswith(bb) and len(a) > len(bb)
            else:
                assert a == bb, (topic, p)


def test_the_ha_epoch_topic_lives_in_a_native_log(tmp_path):
    """The port's engine takes ``__swarmdb_ha`` (the HA epoch topic) and
    keeps it across a reopen; the JAX engine refuses it, so its HA node on
    a native broker cannot persist an epoch (ROADMAP.md queue 3). A JAX
    engine opening the port's log skips that topic and reads the rest."""
    from swarmdb_tpu.broker.replica import persist_epoch as jax_persist
    from swarmdb_tpu_torch.broker.replica import (persist_epoch,
                                                  read_log_epoch)

    d = str(tmp_path / "log")
    b = NativeBroker(log_dir=d)
    b.create_topic("t", 1)
    b.append("t", 0, b"x")
    persist_epoch(b, 7, "n0")
    b.close()
    b = NativeBroker(log_dir=d)
    assert read_log_epoch(b) == 7
    b.close()
    j = JaxNativeBroker(log_dir=d)
    try:
        assert "__swarmdb_ha" not in j.list_topics()
        assert [r.value for r in j.fetch("t", 0, 0)] == [b"x"]
    finally:
        j.close()
    j = JaxNativeBroker(log_dir=str(tmp_path / "jax"))
    try:
        with pytest.raises(Exception):
            jax_persist(j, 1, "n0")
    finally:
        j.close()


def test_two_processes_racing_the_first_build_load_one_library(tmp_path):
    """Two processes build into an empty build folder at once: one
    compiles, the other waits on the lock; both load the same file and no
    temporary file is left."""
    build = tmp_path / "build"
    code = (
        "import sys, time\n"
        "from pathlib import Path\n"
        "from swarmdb_tpu_torch.broker import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "while time.time() < float(sys.argv[2]):\n"
        "    time.sleep(0.001)\n"
        "assert native.build_native()\n"
        "b = native.NativeBroker(log_dir=sys.argv[3])\n"
        "b.create_topic('t', 1)\n"
        "assert b.append('t', 0, b'v') == 0\n"
        "b.close()\n"
        "print(native.library_path())\n")
    start = time.time() + 3.0
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("SWARMDB_BROKER_LIB", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(build), str(start),
         str(tmp_path / f"log{i}")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    lib = Path(paths.pop())
    assert lib.parent == build and lib.exists()
    assert sorted(f.name for f in build.iterdir()) == sorted(
        [lib.name, "libswarmbroker.lock"])


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    """The library's name carries a hash of its source: an edited
    ``broker.cpp`` never loads a stale build; ``SWARMDB_BROKER_LIB`` is
    loaded as it is, with no build."""
    edited = tmp_path / "broker.cpp"
    edited.write_bytes(port_native.SOURCE.read_bytes() + b"\n// edit\n")
    before = port_native.library_path()
    monkeypatch.setattr(port_native, "SOURCE", edited)
    assert port_native.library_path() != before
    assert port_native.library_path().parent == port_native.BUILD_DIR
    monkeypatch.setenv("SWARMDB_BROKER_LIB", str(tmp_path / "missing.so"))
    assert port_native.library_path() == tmp_path / "missing.so"
    assert not port_native.build_native()
    assert not (tmp_path / "missing.so").exists()


@pytest.mark.parametrize("impl", ["auto", "native", "python"])
def test_broker_impl_picks_the_jax_packages_class(impl, tmp_path,
                                                  monkeypatch):
    """``implementation`` / ``BROKER_IMPL`` choose the same broker class
    in both packages, through the runtime's default and the servers'
    ``build_db``."""
    from swarmdb_tpu.api import server as jax_server
    from swarmdb_tpu.core.messages import BrokerConfig as JaxConfig
    from swarmdb_tpu.core.runtime import _default_broker as jax_default
    from swarmdb_tpu_torch.api import server as port_server
    from swarmdb_tpu_torch.core.messages import BrokerConfig
    from swarmdb_tpu_torch.core.runtime import _default_broker

    jb = jax_default(JaxConfig(implementation=impl))
    pb = _default_broker(BrokerConfig(implementation=impl))
    try:
        assert type(pb).__name__ == type(jb).__name__
        assert type(pb).__name__ == ("LocalBroker" if impl == "python"
                                     else "NativeBroker")
    finally:
        jb.close()
        pb.close()
    monkeypatch.setenv("BROKER_IMPL", impl)
    names = []
    for i, srv in enumerate((jax_server, port_server)):
        monkeypatch.setenv("SAVE_DIR", str(tmp_path / f"h{i}"))
        db = srv.build_db()
        names.append(type(db.broker).__name__)
        db.close()
    assert names[0] == names[1]


def test_native_raises_where_the_library_cannot_build(tmp_path,
                                                      monkeypatch):
    """``native`` never falls back: with no library it raises; ``auto``
    then takes LocalBroker, as in the JAX package."""
    from swarmdb_tpu_torch.core.messages import BrokerConfig
    from swarmdb_tpu_torch.core.runtime import _default_broker

    monkeypatch.setenv("SWARMDB_BROKER_LIB", str(tmp_path / "none.so"))
    with pytest.raises(RuntimeError, match="native broker"):
        _default_broker(BrokerConfig(implementation="native"))
    b = _default_broker(BrokerConfig(implementation="auto"))
    assert type(b).__name__ == "LocalBroker"
    b.close()
