"""Cross-host segment-log replication (acks=all over DCN).

A copy of ``swarmdb_tpu/broker/replica.py``: the same frames on the
wire, so a port leader streams to a JAX-package follower and the other
way round. Kafka's ``replication_factor`` with ``acks=all`` means a
DELIVERED report implies the record survives the loss of a broker node.
The in-tree native broker (broker/cpp/broker.cpp) is a single-node
fsynced log; this module adds replication the Kafka way, at the
broker-replication layer, not inside the storage engine:

- A FOLLOWER host runs ``python -m swarmdb_tpu_torch.broker.replica --log-dir D
  --listen H:P``: a :class:`ReplicaServer` wrapping its own (native)
  broker. On leader connect it reports its per-partition end offsets,
  then appends every streamed record at exactly that offset (the log is
  byte-identical by construction: same records, same order, same
  offsets) and acks each partition's **local fsync watermark** — not
  receipt. An ack therefore means "this record survives MY crash".
- The LEADER wraps its broker in :class:`ReplicatedBroker`, which tails
  the log and streams to every follower (one :class:`Replicator` each).
  ``durable_offset`` becomes ``min(local fsync watermark, every
  follower's acked watermark)`` — the Producer's delivery reports
  (broker/base.py Producer.poll) then fire only when the record is
  fsynced on ``replication_factor`` machines, which is STRONGER than
  Kafka's acks=all (Kafka acks on replica receipt, not replica fsync).
- A follower that disconnects freezes the watermark: sends keep working
  (the leader's log absorbs them) but DELIVERED reports stall until the
  follower returns and catches up — honest acks=all back-pressure, the
  same stall a Kafka producer sees when an ISR shrinks below min.insync.

Failover is AUTOMATIC when the nodes run under the HA control plane
(``swarmdb_tpu_torch/ha/``): a failure detector watches the leader (heartbeat
frames on this stream + an out-of-band liveness probe), a promotion
coordinator promotes the most-caught-up follower under a **fencing
epoch**, and clients re-point through a cluster-map handle
(``ha.client.ClusterBroker``). The epoch machinery lives HERE because it
is part of the wire contract:

- Every leader connection starts with an epoch announce (``E``). The
  follower refuses (``F`` + its epoch) any leader whose epoch is lower
  than the highest it has seen — "highest epoch wins", the strict
  upgrade of the single-active-leader guard's last-writer-wins (a
  deposed leader coming back can never interleave appends, and its
  ``ReplicatedBroker`` turns the refusal into :class:`FencedError` on
  every subsequent append).
- Epochs are persisted in the segment log itself (``__swarmdb_ha``
  topic, :func:`persist_epoch` / :func:`read_log_epoch`), so they
  survive restarts and replicate to followers like any other record.
- Consumer-group committed offsets (``C`` frames) and retention trims
  (``X`` frames) now cross the stream too: a promoted follower serves
  consumers from their replicated offsets, not the log beginning, and
  its retention matches the leader's. (Commit replication is
  best-effort/at-least-once: commits are idempotent latest-wins
  metadata, a reconnect re-sends the full commit map, and a failover in
  the commit-propagation window replays at most one commit interval.)

Resync: on (re)connect the leader streams from the follower's end
offset. If retention trimming has advanced the leader's begin offset
past it — or the follower is AHEAD of the leader (a deposed leader's
un-acked divergent tail) — that partition can no longer be mirrored
contiguously: the leader marks it GAPPED, keeps it out of the watermark
(so nothing is falsely acked), and the operator re-seeds the follower
from a copy of the leader's log directory.

Wire format (all little-endian, one TCP stream per leader->follower
pair): 1-byte frame type, fixed struct header, then payload bytes.
  E  leader epoch:   <q>      fencing epoch (first frame on connect)
  F  fenced:         <q>      follower's higher epoch; stream refused
  H  follower hello: u32 json_len + JSON {ends: {topic: {part: end}},
                     epoch: highest_seen}
  T  ensure topic:   u32 json_len + JSON {name, parts, retention_ms}
  R  record:         <HHqdii> topic_len, partition, offset, timestamp,
                     key_len (-1 = null), val_len; + topic + key + value
  A  ack:            <HHq>    topic_len, partition, durable_end; + topic
  P  heartbeat:      <q>      leader epoch (idle-stream liveness)
  C  commit:         <HHHq>   group_len, topic_len, partition, offset;
                     + group + topic
  X  trim:           <Hd>     topic_len, cutoff_ts; + topic
  G  trace context:  u32 json_len + JSON {t: trace_id, s: span_id,
                     o: origin} — the trace context of the most recent
                     traced leader append: the follower marks
                     a ``replica.apply`` instant under that trace id in
                     its OWN span ring, so a cluster-merged trace shows
                     the replication hop. Best-effort like C/X frames;
                     consecutive duplicates are elided.

Partition-level leadership extends the fencing protocol from
connection scope to ``(topic, partition)`` scope, because under
partition leadership a follower mirrors from SEVERAL leaders at once
(each node streams the partitions it leases) and deposing one lease
must not touch the same node's other leaderships:

  I  peer identity:  u32 json_len + JSON {node: node_id} — sent once
                     after the hello so the follower can feed a
                     PER-PEER failure detector from this stream's
                     frames (partition mode runs one detector per peer,
                     not one for "the" leader).
  Q  partition lease: <HHq> topic_len, partition, lease_epoch; + topic.
                     Leader->follower, sent before the first record of
                     a partition on this connection and again whenever
                     the lease epoch changes. Highest epoch wins
                     ownership of that partition's mirror; records from
                     a non-owner connection are dropped, never applied.
  N  partition fence: same layout, follower->leader (shares the ack
                     channel): the announced epoch is stale — the
                     follower has seen a higher lease epoch for that
                     partition. The leader revokes ONLY that lease
                     (appends to it raise a partition-scoped
                     :class:`FencedError`); its other partitions keep
                     streaming on the same connection.

In partition mode (``ReplicaServer(partition_mode=True)``) the
connection-level E/F refusal and single-active-stream supersede are
disabled — many concurrent leader streams are the point — and fencing
is entirely per-partition via Q/N.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..obs import TRACER, propagate
from ..obs.metrics import HIST_REPLICATION_COMMIT
from .base import Broker, BrokerError, FencedError, Record, TopicMeta
from ..utils.sync import make_condition, make_lock

logger = logging.getLogger("swarmdb_tpu_torch.replica")

_REC_HDR = struct.Struct("<HHqdii")
_ACK_HDR = struct.Struct("<HHq")
_LEN = struct.Struct("<I")
_EPOCH = struct.Struct("<q")
_CMT_HDR = struct.Struct("<HHHq")   # group_len, topic_len, partition, offset
_TRIM_HDR = struct.Struct("<Hd")    # topic_len, cutoff_ts
_PART_HDR = struct.Struct("<HHq")   # topic_len, partition, lease_epoch (Q/N)

_POLL_S = 0.002          # follower ack / leader tail idle poll
_RECONNECT_S = 0.5       # leader reconnect backoff
_BATCH = 256             # records per fetch

# Fencing epochs live in the segment log itself so they survive restarts
# and replicate to followers like any record. One partition, effectively
# no retention (an epoch record is ~80 bytes; losing history would let a
# restarted deposed leader forget it was deposed).
HA_EPOCH_TOPIC = "__swarmdb_ha"
_EPOCH_RETENTION_MS = 10 * 365 * 24 * 3600 * 1000


def _heartbeat_s() -> float:
    try:
        return float(os.environ.get("SWARMDB_HA_HEARTBEAT_S", "0.5"))
    except ValueError:
        return 0.5


def read_log_epoch(broker: Broker) -> int:
    """Highest fencing epoch persisted in this broker's segment log
    (0 when the node has never been part of an epoch'd cluster)."""
    try:
        if HA_EPOCH_TOPIC not in broker.list_topics():
            return 0
        end = broker.end_offset(HA_EPOCH_TOPIC, 0)
        if end <= 0:
            return 0
        recs = broker.fetch(HA_EPOCH_TOPIC, 0, end - 1, 1)
        if not recs:
            return 0  # trimmed/wiped — treat as unknown
        return int(json.loads(recs[-1].value.decode("utf-8"))["epoch"])
    except (BrokerError, ValueError, KeyError):
        return 0


def persist_epoch(broker: Broker, epoch: int, node_id: str) -> int:
    """Append an epoch record to the segment log and force durability.

    The fsync matters: a promotion that is not on disk before the new
    leader takes writes could be forgotten by a crash-restart, and the
    resurrected node would come back believing its pre-promotion epoch.
    """
    broker.create_topic(HA_EPOCH_TOPIC, 1, retention_ms=_EPOCH_RETENTION_MS)
    payload = json.dumps(
        {"epoch": int(epoch), "node": node_id, "ts": time.time()}
    ).encode("utf-8")
    off = broker.append(HA_EPOCH_TOPIC, 0, payload)
    broker.flush()
    return off


class _FencedByFollower(Exception):
    """Internal: a follower refused our epoch (carries its higher one)."""

    def __init__(self, epoch: int) -> None:
        super().__init__(f"fenced by follower at epoch {epoch}")
        self.epoch = epoch


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("replication peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _send_record(sock: socket.socket, rec: Record) -> None:
    topic = rec.topic.encode()
    key = rec.key if rec.key is not None else b""
    klen = -1 if rec.key is None else len(rec.key)
    sock.sendall(
        b"R"
        + _REC_HDR.pack(len(topic), rec.partition, rec.offset,
                        rec.timestamp, klen, len(rec.value))
        + topic + key + rec.value
    )


def _send_commit(sock: socket.socket, group: str, topic: str,
                 part: int, offset: int) -> None:
    g, t = group.encode(), topic.encode()
    sock.sendall(b"C" + _CMT_HDR.pack(len(g), len(t), part, offset) + g + t)


def _send_trim(sock: socket.socket, topic: str, cutoff_ts: float) -> None:
    t = topic.encode()
    sock.sendall(b"X" + _TRIM_HDR.pack(len(t), cutoff_ts) + t)


def _send_trace(sock: socket.socket, tc: Dict) -> None:
    payload = json.dumps(tc).encode()
    sock.sendall(b"G" + _LEN.pack(len(payload)) + payload)


def _send_partition_frame(sock: socket.socket, ftype: bytes, topic: str,
                          part: int, epoch: int) -> None:
    """Q (lease announce, leader->follower) and N (partition fence,
    follower->leader) share one layout."""
    t = topic.encode()
    sock.sendall(ftype + _PART_HDR.pack(len(t), part, epoch) + t)


class ReplicaServer:
    """Follower side: mirror a leader's log into a local broker.

    Accepts any number of sequential leader connections (reconnects after
    a leader restart reuse the same listener). ``broker`` is typically a
    :class:`~swarmdb_tpu_torch.broker.native.NativeBroker` on the follower's
    own disk; anything implementing the Broker ABC works (tests use it
    with LocalBroker too — acks then track its watermark semantics).
    """

    def __init__(self, broker: Broker, host: str = "127.0.0.1",
                 port: int = 0, *,
                 on_activity: Optional[Callable[[], None]] = None,
                 on_peer_activity: Optional[Callable[[str], None]] = None,
                 partition_mode: bool = False,
                 gate: Optional[Callable[[], bool]] = None) -> None:
        self.broker = broker
        # HA hooks: ``on_activity`` fires on every frame from the active
        # leader (feeds the failure detector's beat); ``gate`` returning
        # False refuses/drops connections (chaos partition injection).
        # ``partition_mode`` admits many concurrent leader
        # streams and fences per (topic, partition) via Q/N frames;
        # ``on_peer_activity(node_id)`` then feeds the per-peer detector
        # for whichever peer identified itself (I frame) on the stream.
        self.on_activity = on_activity
        self.on_peer_activity = on_peer_activity
        self.partition_mode = partition_mode
        self.gate = gate
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # a restarted follower re-binds its fixed port while the previous
        # instance's sockets drain TIME_WAIT — retry briefly instead of
        # failing the node
        for attempt in range(40):
            try:
                self._listener.bind((host, port))
                break
            except OSError:
                if attempt == 39:
                    raise
                time.sleep(0.25)
        self._listener.listen(4)
        self.host, self.port = self._listener.getsockname()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        # single-active-leader, epoch-aware:
        # the one connection allowed to mirror records. A second accept is
        # split-brain, a leader restart racing its old socket, or a NEW
        # leader after a failover — HIGHEST EPOCH WINS: a connection whose
        # announced epoch is >= the active stream's supersedes it (the
        # stale stream is closed before the new hello snapshots local
        # ends, so two leaders can never interleave appends into the
        # mirror); a connection with a LOWER epoch than the highest ever
        # seen is refused outright with an F frame (fencing).
        self._conn_lock = make_lock("broker.replica.ReplicaServer._conn_lock")
        # swarmlint: guarded-by[self._conn_lock]: _active_conn, _conn_epochs, _highest_epoch, _tp_epochs, _tp_owner
        self._active_conn: Optional[socket.socket] = None
        self._conn_epochs: Dict[int, int] = {}  # id(conn) -> epoch
        self._highest_epoch: int = read_log_epoch(broker)
        # partition mode: per-(topic, partition) lease fencing floors and
        # the connection currently owning each partition's mirror
        self._tp_epochs: Dict[Tuple[str, int], int] = {}
        self._tp_owner: Dict[Tuple[str, int], int] = {}  # tp -> id(conn)

    def start(self) -> "ReplicaServer":
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="swarmdb-replica-accept")
        t.start()
        self._threads.append(t)
        return self

    @property
    def highest_epoch(self) -> int:
        with self._conn_lock:
            return self._highest_epoch

    def note_epoch(self, epoch: int) -> None:
        """Raise the fencing floor (a promoted node fences every leader
        below its new epoch, including the one it just replaced)."""
        with self._conn_lock:
            if epoch > self._highest_epoch:
                self._highest_epoch = epoch

    def note_partition_epoch(self, topic: str, part: int,
                             epoch: int) -> None:
        """Raise one partition's lease-fencing floor (the HA watch loop
        pushes the cluster map's assignment epochs here, so a deposed
        lease is fenced even before the new leader's first Q frame)."""
        with self._conn_lock:
            if epoch > self._tp_epochs.get((topic, part), 0):
                self._tp_epochs[(topic, part)] = epoch

    def drop_connections(self) -> None:
        """Hard-close every leader stream (chaos partition / promotion)."""
        with self._conn_lock:
            conns = list(self._conns)
            self._active_conn = None
            self._tp_owner.clear()
        for sock in conns:
            for op in (lambda s=sock: s.shutdown(socket.SHUT_RDWR),
                       sock.close):
                try:
                    op()
                except OSError:
                    pass

    def stop(self) -> None:
        self._stop.set()
        # snapshot under the lock (swarmlint SWL303): a connection
        # registering concurrently must either be in the snapshot (and
        # get shut down here) or observe _stop and exit on its own
        with self._conn_lock:
            conns = list(self._conns)
        # shutdown() BEFORE close(): a thread parked in accept()/recv()
        # holds the open file description, so close() alone leaves the
        # socket alive (and the port LISTENING) until that syscall
        # returns — shutdown wakes it
        for sock in [self._listener] + conns:
            for op in (lambda s=sock: s.shutdown(socket.SHUT_RDWR),
                       sock.close):
                try:
                    op()
                except OSError:
                    pass
        # join before returning: callers do stop() then broker.close(),
        # and a still-running ack/serve thread would hand the closed
        # (NULL) native handle to the C library mid-call
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=3.0)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._listener.accept()
            except OSError:
                return  # listener closed
            # REUSEADDR on the accepted socket too: its eventual TIME_WAIT
            # must not block a restarted server's bind on this port
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if self.gate is not None and not self.gate():
                # chaos partition: drop on the floor (no RST semantics
                # needed — the leader sees EOF and reconnect-backs-off)
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            with self._conn_lock:
                self._conns.append(conn)
            # supersede/refuse happens in _serve AFTER the epoch announce
            # arrives: a stale-epoch connection must be fenced WITHOUT
            # disturbing the active stream (last-writer-wins would let a
            # flapping deposed leader repeatedly kill the live mirror)
            logger.info("replica: leader connected from %s", addr)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True, name="swarmdb-replica-conn")
            t.start()
            self._threads.append(t)

    def _note_activity(self, peer: Optional[str] = None) -> None:
        """Feed the failure detector (every frame from the active leader
        is a liveness proof; in partition mode, from whichever peer the
        stream's I frame identified). Never lets a callback error kill
        the mirror stream."""
        if self.on_activity is not None:
            try:
                self.on_activity()
            except Exception:
                logger.exception("replica on_activity hook failed")
        if peer is not None and self.on_peer_activity is not None:
            try:
                self.on_peer_activity(peer)
            except Exception:
                logger.exception("replica on_peer_activity hook failed")

    def _local_ends(self) -> Dict[str, Dict[str, int]]:
        ends: Dict[str, Dict[str, int]] = {}
        for name, meta in self.broker.list_topics().items():
            ends[name] = {
                str(p): self.broker.end_offset(name, p)
                for p in range(meta.num_partitions)
            }
        return ends

    def _serve(self, conn: socket.socket) -> None:
        # tp -> mirrored end; shared with ack_loop (its own thread)
        # swarmlint: guarded-by[lock]: appended
        appended: Dict[Tuple[str, int], int] = {}
        acked: Dict[Tuple[str, int], int] = {}
        lock = make_lock("broker.replica.ReplicaServer._serve.lock")
        done = threading.Event()
        # the follower->leader channel is written by TWO threads in
        # partition mode (ack_loop's A frames, this thread's N fences):
        # serialize sends so frames never interleave mid-payload
        send_lock = make_lock("broker.replica.ReplicaServer._serve.send_lock")
        peer_id: List[Optional[str]] = [None]  # from the I frame
        refused_tps: set = set()  # tps already N-fenced on this conn

        def ack_loop() -> None:
            # acks carry the follower's fsync watermark, advanced by its
            # broker's group-commit flusher — poll it and push updates.
            # EVERY local partition is acked, not just ones that received
            # records on THIS connection (review r5 #2): after a leader
            # restart the new Replicator starts from acked=0, and idle
            # fully-mirrored partitions would otherwise freeze the
            # leader's watermark at 0 until fresh traffic arrived.
            idle_wait = _POLL_S
            while not done.is_set() and not self._stop.is_set():
                with lock:
                    ends = dict(appended)
                try:
                    for name, meta in self.broker.list_topics().items():
                        for p in range(meta.num_partitions):
                            ends.setdefault(
                                (name, p), self.broker.end_offset(name, p))
                except BrokerError:
                    pass
                advanced = False
                for (topic, part), end in ends.items():
                    try:
                        durable = min(self.broker.durable_offset(topic, part),
                                      end)
                        if durable < end:
                            # nudge the durability point: snapshot-mode
                            # brokers group-commit inside wait_durable
                            # (rate-limited there), and acks must track
                            # records that arrived over THIS stream, not
                            # only local-writer traffic. Zero timeout:
                            # never parks the ack loop.
                            self.broker.wait_durable(topic, part,
                                                     durable, 0.0)
                            durable = min(
                                self.broker.durable_offset(topic, part),
                                end)
                    except BrokerError:
                        continue
                    if durable > acked.get((topic, part), -1):
                        advanced = True
                        acked[(topic, part)] = durable
                        t = topic.encode()
                        try:
                            with send_lock:
                                conn.sendall(b"A" + _ACK_HDR.pack(
                                    len(t), part, durable) + t)
                        except OSError:
                            return
                # idle backoff (review r5 #4): a quiet deployment must not
                # poll the broker locks 500x/sec forever
                idle_wait = _POLL_S if advanced else min(idle_wait * 2, 0.05)
                done.wait(idle_wait)

        acker = None
        try:
            # -- fencing handshake ------------------------------
            # The leader's FIRST frame is its epoch announce; a silent or
            # wedged peer must not hang this thread (timeout lifted once
            # streaming starts).
            conn.settimeout(30)
            if _recv_exact(conn, 1) != b"E":
                raise BrokerError("expected leader epoch announce")
            (leader_epoch,) = _EPOCH.unpack(_recv_exact(conn, _EPOCH.size))
            stale = None
            refused: Optional[int] = None
            with self._conn_lock:
                if self.partition_mode:
                    # many concurrent leader streams are the point:
                    # fencing is per-partition (Q/N), never per-connection
                    self._conn_epochs[id(conn)] = leader_epoch
                    self._highest_epoch = max(self._highest_epoch,
                                              leader_epoch)
                    active = None
                    active_epoch = -1
                else:
                    active = self._active_conn
                    active_epoch = (self._conn_epochs.get(id(active), -1)
                                    if active is not None else -1)
                    if (leader_epoch < self._highest_epoch
                            or leader_epoch < active_epoch):
                        refused = max(self._highest_epoch, active_epoch)
                    else:
                        self._highest_epoch = max(self._highest_epoch,
                                                  leader_epoch)
                        self._conn_epochs[id(conn)] = leader_epoch
                        self._active_conn = conn
                        stale = active
            if refused is not None:
                logger.warning(
                    "replica: fencing leader at stale epoch %d (highest "
                    "seen %d)", leader_epoch, refused)
                conn.sendall(b"F" + _EPOCH.pack(refused))
                return
            if stale is not None:
                # highest-epoch-wins supersede, BEFORE the hello below
                # snapshots local ends: the stale _serve's next recv
                # fails, so its append stream is dead by the time the new
                # leader's cursor is anchored on the follower's offsets
                logger.warning(
                    "replica: leader connection at epoch %d supersedes the "
                    "active stream (epoch %d) — closing the stale one "
                    "(single-active-leader)", leader_epoch, active_epoch)
                for op in (lambda: stale.shutdown(socket.SHUT_RDWR),
                           stale.close):
                    try:
                        op()
                    except OSError:
                        pass
            self._note_activity()
            hello = json.dumps({"ends": self._local_ends(),
                                "epoch": self.highest_epoch}).encode()
            conn.sendall(b"H" + _LEN.pack(len(hello)) + hello)
            conn.settimeout(None)
            acker = threading.Thread(target=ack_loop, daemon=True,
                                     name="swarmdb-replica-ack")
            acker.start()
            while not self._stop.is_set():
                ftype = _recv_exact(conn, 1)
                # a superseded stream needs no is-active re-check here: the
                # supersede path closes this socket, so the next recv fails
                self._note_activity(peer_id[0])
                if ftype == b"P":
                    # heartbeat: liveness only, the activity note above is
                    # the whole point
                    _EPOCH.unpack(_recv_exact(conn, _EPOCH.size))
                elif ftype == b"I":
                    # peer identity (partition mode): subsequent frames on
                    # this stream beat THAT peer's failure detector
                    (jlen,) = _LEN.unpack(_recv_exact(conn, _LEN.size))
                    ident = json.loads(_recv_exact(conn, jlen))
                    peer_id[0] = ident.get("node")
                    self._note_activity(peer_id[0])
                elif ftype == b"Q":
                    # partition lease announce: highest epoch wins the
                    # partition's mirror; an equal epoch is the SAME
                    # leader reconnecting (the map CAS seats exactly one
                    # winner per partition-epoch), so it re-takes
                    # ownership rather than being refused
                    (tlen, part, lease_epoch) = _PART_HDR.unpack(
                        _recv_exact(conn, _PART_HDR.size))
                    topic = _recv_exact(conn, tlen).decode()
                    tp = (topic, part)
                    with self._conn_lock:
                        cur = self._tp_epochs.get(tp, 0)
                        if lease_epoch >= cur:
                            self._tp_epochs[tp] = lease_epoch
                            self._tp_owner[tp] = id(conn)
                            refused_tps.discard(tp)
                            accepted = True
                        else:
                            accepted = False
                    if not accepted:
                        logger.warning(
                            "replica: fencing partition lease %s[%d] at "
                            "stale epoch %d (highest seen %d)",
                            topic, part, lease_epoch, cur)
                        with send_lock:
                            _send_partition_frame(conn, b"N", topic, part,
                                                  cur)
                elif ftype == b"C":
                    (glen, tlen, part, offset) = _CMT_HDR.unpack(
                        _recv_exact(conn, _CMT_HDR.size))
                    group = _recv_exact(conn, glen).decode()
                    topic = _recv_exact(conn, tlen).decode()
                    try:
                        self.broker.commit_offset(group, topic, part, offset)
                    except BrokerError:
                        # commit for a topic not yet mirrored here — the
                        # reconnect snapshot will re-send it
                        pass
                elif ftype == b"X":
                    (tlen, cutoff) = _TRIM_HDR.unpack(
                        _recv_exact(conn, _TRIM_HDR.size))
                    topic = _recv_exact(conn, tlen).decode()
                    try:
                        self.broker.trim_older_than(topic, cutoff)
                    except BrokerError:
                        pass
                elif ftype == b"G":
                    # trace-context announce: the follower's
                    # replication hop joins the propagated trace
                    (jlen,) = _LEN.unpack(_recv_exact(conn, _LEN.size))
                    ctx = propagate.extract(
                        json.loads(_recv_exact(conn, jlen)))
                    if ctx is not None:
                        TRACER.instant(
                            "replica.apply", cat="replica",
                            rid=ctx.trace_id,
                            args={"origin": ctx.origin,
                                  "node": propagate.node_id()})
                elif ftype == b"T":
                    (jlen,) = _LEN.unpack(_recv_exact(conn, _LEN.size))
                    spec = json.loads(_recv_exact(conn, jlen))
                    self.broker.create_topic(
                        spec["name"], spec["parts"],
                        retention_ms=spec.get(
                            "retention_ms", 7 * 24 * 3600 * 1000))
                    meta = self.broker.list_topics()[spec["name"]]
                    if meta.num_partitions < spec["parts"]:
                        self.broker.create_partitions(spec["name"],
                                                      spec["parts"])
                elif ftype == b"R":
                    (tlen, part, offset, ts, klen,
                     vlen) = _REC_HDR.unpack(_recv_exact(conn, _REC_HDR.size))
                    topic = _recv_exact(conn, tlen).decode()
                    key = _recv_exact(conn, klen) if klen > 0 else (
                        b"" if klen == 0 else None)
                    value = _recv_exact(conn, vlen)
                    if self.partition_mode:
                        # only the connection owning this partition's
                        # lease may mirror into it: a record from anyone
                        # else (a stale leader racing its fence, or a
                        # peer that never announced) is dropped, and the
                        # sender is told ONCE per partition why
                        tp = (topic, part)
                        with self._conn_lock:
                            owner_ok = self._tp_owner.get(tp) == id(conn)
                            cur = self._tp_epochs.get(tp, 0)
                        if not owner_ok:
                            if tp not in refused_tps:
                                refused_tps.add(tp)
                                with send_lock:
                                    _send_partition_frame(
                                        conn, b"N", topic, part, cur)
                            continue
                    # mirror-position check from the tracked map; ONE
                    # locked end_offset query per partition per
                    # connection, not per record (review r5 #4: the
                    # per-record query serialized catch-up against the
                    # follower's own group-commit flusher)
                    with lock:
                        end = appended.get((topic, part))
                    if end is None:
                        end = self.broker.end_offset(topic, part)
                    if offset < end:
                        # duplicate after reconnect — already have it.
                        # Seed the tracked map FIRST: a
                        # duplicate BURST otherwise re-queries end_offset
                        # under the broker lock once per record, exactly
                        # the serialization the map exists to avoid.
                        with lock:
                            appended[(topic, part)] = end
                        continue
                    if offset > end:
                        # contiguity broken (leader bug or operator error:
                        # follower dir not seeded from this leader) — stop
                        # mirroring rather than mis-number the log
                        raise BrokerError(
                            f"replication gap on {topic}[{part}]: leader "
                            f"sent {offset}, local end {end}")
                    got = self.broker.append(topic, part, value, key=key,
                                             timestamp=ts)
                    if got != offset:
                        # a real error, not an assert (compiled out under
                        # -O): a concurrent local writer on the follower's
                        # broker mis-numbered the mirror — acking it would
                        # hand failover a log that differs from the
                        # leader's (review r5 #3)
                        raise BrokerError(
                            f"mirror divergence on {topic}[{part}]: "
                            f"leader offset {offset}, local append {got}")
                    with lock:
                        appended[(topic, part)] = offset + 1
                else:
                    raise BrokerError(f"bad frame type {ftype!r}")
        except (ConnectionError, OSError):
            logger.info("replica: leader disconnected")
        except Exception:
            logger.exception("replica: connection failed")
        finally:
            done.set()
            if acker is not None:
                # the ack loop touches the broker handle; it must be dead
                # before stop()'s join (and the caller's broker.close())
                # returns — _serve threads are joined there, so joining
                # the acker here makes that transitive
                acker.join(timeout=3.0)
            try:
                conn.close()
            except OSError:
                pass
            # prune this connection's bookkeeping: a flapping leader
            # reconnects every _RECONNECT_S, and append-only lists would
            # accrete dead sockets/threads without bound
            with self._conn_lock:
                if self._active_conn is conn:
                    self._active_conn = None
                self._conn_epochs.pop(id(conn), None)
                for tp in [tp for tp, owner in self._tp_owner.items()
                           if owner == id(conn)]:
                    del self._tp_owner[tp]  # epoch floor stays sticky
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass
            cur = threading.current_thread()
            self._threads = [t for t in self._threads
                             if t.is_alive() and t is not cur]


class Replicator:
    """Leader side: one streaming connection to one follower."""

    def __init__(self, broker: Broker, target: str, *,
                 get_epoch: Optional[Callable[[], int]] = None,
                 ctrl_snapshot: Optional[Callable[[], Tuple[Dict, Dict]]] = None,
                 gate: Optional[Callable[[], bool]] = None,
                 heartbeat_s: Optional[float] = None,
                 on_fenced: Optional[Callable[[int], None]] = None,
                 lease_fn: Optional[
                     Callable[[str, int], Optional[int]]] = None,
                 node_id: Optional[str] = None,
                 on_partition_fenced: Optional[
                     Callable[[str, int, int], None]] = None) -> None:
        self.broker = broker
        host, _, port = target.rpartition(":")
        self.addr = (host or "127.0.0.1", int(port))
        # HA hooks (all optional; plain replication uses epoch 0):
        # get_epoch — this leader's fencing epoch, announced on connect;
        # ctrl_snapshot — full (commits, trims) maps re-sent on every
        # (re)connect so control metadata lost to a disconnect converges;
        # gate — False = chaos partition (refuse to connect / cut stream);
        # on_fenced — fired once when a follower refuses our epoch.
        # Partition mode: lease_fn(topic, part) returns the
        # lease epoch when THIS node currently leads that partition (only
        # those stream; the epoch rides a Q frame), node_id identifies us
        # to the follower's per-peer detector (I frame), and
        # on_partition_fenced fires when the follower N-fences one lease.
        self._get_epoch = get_epoch or (lambda: 0)
        self._ctrl_snapshot = ctrl_snapshot
        self.gate = gate
        self.heartbeat_s = (heartbeat_s if heartbeat_s is not None
                            else _heartbeat_s())
        self._on_fenced = on_fenced
        self._lease_fn = lease_fn
        self._node_id = node_id
        self._on_partition_fenced = on_partition_fenced
        # tp -> fencing epoch from an N frame; written by the ack thread,
        # read by the stream loop — benign GIL-atomic dict ops (a stale
        # read costs one extra refused batch, never a mis-apply)
        self._tp_refused: Dict[Tuple[str, int], int] = {}
        # a follower reporting a higher epoch means THIS leader is deposed:
        # stop reconnecting (the stream would be refused forever) and let
        # ReplicatedBroker surface FencedError on writes
        self.fenced = threading.Event()
        self.fenced_epoch: Optional[int] = None
        # control frames queued while streaming; bounded because the
        # reconnect snapshot supersedes anything dropped here
        # swarmlint: guarded-by[self._ctrl_lock]: _ctrl, _last_trace
        self._ctrl_lock = make_lock("broker.replica.Replicator._ctrl_lock")
        self._ctrl: collections.deque = collections.deque(maxlen=4096)
        self._last_trace: Optional[Dict] = None  # G-frame dedup
        # tp -> follower durable end, written by recv_acks / clamped at
        # reconnect under the condition below
        # swarmlint: guarded-by[self._cv]: acked, _ack_advanced_at
        self.acked: Dict[Tuple[str, int], int] = {}
        # tp -> wall time the follower's watermark last ADVANCED — the
        # age half of the lag gauge (/metrics): a lagging partition whose
        # watermark is also old means the follower is stalled, not just
        # busy catching up
        self._ack_advanced_at: Dict[Tuple[str, int], float] = {}
        self._started_at = time.time()
        self.gapped: set = set()
        self.connected = threading.Event()
        self._cv = make_condition("broker.replica.Replicator._cv")
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"swarmdb-replicator-{self.addr[1]}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        # join before the caller closes the underlying broker: a fetch
        # racing the close surfaces as a spurious UnknownTopicError +
        # reconnect-backoff log line at every shutdown
        self._thread.join(timeout=2.0)

    def post_commit(self, group: str, topic: str, part: int,
                    offset: int) -> None:
        """Queue a consumer-group commit for the follower (best-effort;
        the reconnect snapshot is the backstop)."""
        if self.fenced.is_set():
            return
        with self._ctrl_lock:
            self._ctrl.append(("C", group, topic, part, offset))

    def post_trim(self, topic: str, cutoff_ts: float) -> None:
        """Queue a retention trim for the follower (idempotent)."""
        if self.fenced.is_set():
            return
        with self._ctrl_lock:
            self._ctrl.append(("X", topic, cutoff_ts))

    def post_trace(self, tc: Dict) -> None:
        """Queue a trace-context announce (best-effort —
        tracing must never back-pressure replication). Consecutive
        duplicates are elided so a burst of appends under one trace
        costs one G frame."""
        if self.fenced.is_set():
            return
        with self._ctrl_lock:
            if tc == self._last_trace:
                return
            self._last_trace = tc
            self._ctrl.append(("G", tc))

    def _drain_ctrl(self, sock: socket.socket) -> int:
        with self._ctrl_lock:
            pending, self._ctrl = list(self._ctrl), collections.deque(
                maxlen=self._ctrl.maxlen)
        for frame in pending:
            if frame[0] == "C":
                _send_commit(sock, *frame[1:])
            elif frame[0] == "G":
                _send_trace(sock, frame[1])
            else:
                _send_trim(sock, *frame[1:])
        return len(pending)

    def acked_offset(self, topic: str, part: int) -> int:
        if (topic, part) in self.gapped:
            return 0
        # benign racy read of a watermark — a stale value only delays a
        # swarmlint: disable=SWL301 -- delivery report by one poll tick
        return self.acked.get((topic, part), 0)

    def lag_stats(self, ends: Dict[Tuple[str, int], int]) -> Dict:
        """Fsync-watermark lag vs the leader's end offsets: total lagging
        RECORDS across partitions, and the age in SECONDS of the stalest
        lagging watermark (0.0 when fully caught up). Gapped partitions
        count their full backlog — they are out of the watermark until
        the operator re-seeds (see module docstring)."""
        with self._cv:
            acked = dict(self.acked)
            advanced = dict(self._ack_advanced_at)
        now = time.time()
        records = 0
        stalest = 0.0
        for tp, end in ends.items():
            behind = max(0, end - (0 if tp in self.gapped
                                   else acked.get(tp, 0)))
            if behind <= 0:
                continue
            records += behind
            stalest = max(stalest,
                          now - advanced.get(tp, self._started_at))
        return {
            "target": f"{self.addr[0]}:{self.addr[1]}",
            "lag_records": records,
            "lag_seconds": round(stalest, 3),
            "connected": self.connected.is_set(),
            "gapped": len(self.gapped),
            "fenced": self.fenced.is_set(),
        }

    def wait_acked(self, topic: str, part: int, offset: int,
                   timeout_s: float) -> bool:
        """True once the follower's fsync watermark passes ``offset``."""
        deadline = time.time() + timeout_s
        with self._cv:
            while self.acked_offset(topic, part) <= offset:
                left = deadline - time.time()
                if (left <= 0 or self._stop.is_set()
                        or self.fenced.is_set()):
                    return False
                self._cv.wait(min(left, 0.05))
        return True

    def _run(self) -> None:
        while not self._stop.is_set() and not self.fenced.is_set():
            try:
                self._stream_once()
            except _FencedByFollower as exc:
                # deposed: reconnecting would be refused forever. Park the
                # thread and surface the epoch through fenced_epoch /
                # ReplicatedBroker.FencedError.
                self.fenced_epoch = exc.epoch
                self.fenced.set()
                with self._cv:
                    self._cv.notify_all()  # release wait_acked parkers
                logger.error(
                    "replicator %s: FENCED — follower is at epoch %d, our "
                    "epoch %d is stale (leader deposed; rejoin as follower)",
                    self.addr, exc.epoch, self._get_epoch())
                if self._on_fenced is not None:
                    try:
                        self._on_fenced(exc.epoch)
                    except Exception:
                        logger.exception("on_fenced hook failed")
            except (ConnectionError, OSError) as exc:
                logger.info("replicator %s: %s; reconnecting", self.addr, exc)
            except Exception:
                logger.exception("replicator %s failed; reconnecting",
                                 self.addr)
            self.connected.clear()
            self._stop.wait(_RECONNECT_S)

    def _stream_once(self) -> None:
        if self.gate is not None and not self.gate():
            raise ConnectionError("partitioned (chaos gate)")
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        # REUSEADDR on the CLIENT socket: a closed self-connect (below)
        # parks in TIME_WAIT bound to the follower's port, and without
        # the flag that corpse blocks the follower's restart bind for 60 s
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.settimeout(10)
        try:
            sock.connect(self.addr)
        except OSError:
            sock.close()
            raise
        if sock.getsockname() == sock.getpeername():
            # loopback self-connect: retrying an ephemeral-range port with
            # no listener can TCP-simultaneous-connect to ITSELF — the
            # socket then squats on the follower's port (blocking its
            # restart) while this thread waits forever for a hello
            sock.close()
            raise ConnectionError("self-connect (no follower listening)")
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # the hello must arrive promptly; a silent/wedged peer must not
        # hang the replicator (timeout lifted once streaming starts)
        sock.settimeout(30)
        try:
            # fencing handshake: announce our epoch FIRST; the follower
            # answers with its hello (accepted) or an F frame (we are
            # deposed — a newer leader has a higher epoch)
            epoch = self._get_epoch()
            sock.sendall(b"E" + _EPOCH.pack(epoch))
            ftype = _recv_exact(sock, 1)
            if ftype == b"F":
                (fence_epoch,) = _EPOCH.unpack(
                    _recv_exact(sock, _EPOCH.size))
                raise _FencedByFollower(fence_epoch)
            if ftype != b"H":
                raise BrokerError("expected follower hello")
            (jlen,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
            hello = json.loads(_recv_exact(sock, jlen))
            follower_ends = hello["ends"]
            # clamp stale watermarks to what the follower ACTUALLY holds
            # (review r5 #3): a follower re-seeded or wiped between
            # connections reports lower end offsets, and keeping the old
            # acked values would fire delivery reports for records that
            # no longer exist on the replica
            with self._cv:
                for (topic, part) in list(self.acked):
                    held = int(follower_ends.get(topic, {}).get(
                        str(part), 0))
                    if self.acked[(topic, part)] > held:
                        self.acked[(topic, part)] = held
            # re-evaluate gapped partitions against the NEW hello: the
            # documented recovery (operator re-seeds the follower from a
            # copy of the leader's log dir) arrives as a reconnect with
            # healthy end offsets, and a sticky gapped set would pin the
            # partition out of the stream (and its watermark to 0) until
            # the leader process restarted (review r5 #2)
            self.gapped.clear()
            sock.settimeout(None)  # streaming: blocking sends/acks resume
            self.connected.set()

            dead = threading.Event()

            def recv_acks() -> None:
                try:
                    while not self._stop.is_set():
                        ftype = _recv_exact(sock, 1)
                        if ftype == b"N":
                            # partition fence: the follower saw a higher
                            # lease epoch for ONE partition — revoke that
                            # lease only; the stream (and our other
                            # partitions) keep going
                            tlen, part, fence_epoch = _PART_HDR.unpack(
                                _recv_exact(sock, _PART_HDR.size))
                            topic = _recv_exact(sock, tlen).decode()
                            self._tp_refused[(topic, part)] = fence_epoch
                            logger.warning(
                                "replicator %s: partition lease %s[%d] "
                                "FENCED at epoch %d", self.addr, topic,
                                part, fence_epoch)
                            if self._on_partition_fenced is not None:
                                try:
                                    self._on_partition_fenced(
                                        topic, part, fence_epoch)
                                except Exception:
                                    logger.exception(
                                        "on_partition_fenced hook failed")
                            continue
                        if ftype != b"A":
                            raise BrokerError("bad ack frame")
                        tlen, part, end = _ACK_HDR.unpack(
                            _recv_exact(sock, _ACK_HDR.size))
                        topic = _recv_exact(sock, tlen).decode()
                        with self._cv:
                            if end > self.acked.get((topic, part), -1):
                                self._ack_advanced_at[(topic, part)] = \
                                    time.time()
                            self.acked[(topic, part)] = end
                            self._cv.notify_all()
                except (ConnectionError, OSError, BrokerError):
                    pass
                finally:
                    # EOF here is how an IDLE leader learns the follower
                    # went away (nothing to send -> no failing sendall):
                    # abort the stream so the outer loop reconnects and
                    # resyncs instead of serving stale acks forever
                    dead.set()
                    try:
                        sock.close()
                    except OSError:
                        pass

            acker = threading.Thread(target=recv_acks, daemon=True,
                                     name="swarmdb-replicator-ack")
            acker.start()

            if self._node_id is not None and self._lease_fn is not None:
                # identify ourselves so the follower's per-peer failure
                # detector credits this stream's frames to US
                ident = json.dumps({"node": self._node_id}).encode()
                sock.sendall(b"I" + _LEN.pack(len(ident)) + ident)

            # reconnect snapshot: control metadata (consumer-group commits,
            # retention trims) queued while disconnected was dropped — the
            # full latest-wins maps converge the follower in one burst
            if self._ctrl_snapshot is not None:
                commits, trims = self._ctrl_snapshot()
                for (group, topic, part), offset in commits.items():
                    _send_commit(sock, group, topic, part, offset)
                for topic, cutoff in trims.items():
                    _send_trim(sock, topic, cutoff)

            known: Dict[str, TopicMeta] = {}
            cursors: Dict[Tuple[str, int], int] = {}
            # tp -> lease epoch last Q-announced on THIS connection
            announced: Dict[Tuple[str, int], int] = {}
            idle_wait = _POLL_S
            last_tx = time.monotonic()
            while not self._stop.is_set():
                if dead.is_set():
                    raise ConnectionError("follower connection lost")
                if self.gate is not None and not self.gate():
                    raise ConnectionError("partitioned (chaos gate)")
                shipped = self._drain_ctrl(sock)
                for name, meta in self.broker.list_topics().items():
                    prev = known.get(name)
                    if prev is None or prev.num_partitions < meta.num_partitions:
                        spec = json.dumps({
                            "name": name, "parts": meta.num_partitions,
                            "retention_ms": meta.retention_ms}).encode()
                        sock.sendall(b"T" + _LEN.pack(len(spec)) + spec)
                        known[name] = meta
                    for part in range(meta.num_partitions):
                        tp = (name, part)
                        if self._lease_fn is not None:
                            # partition mode: stream ONLY the partitions
                            # we currently lease; announce the lease
                            # epoch (Q) before its first record and on
                            # every epoch change
                            lease = self._lease_fn(name, part)
                            if lease is None:
                                announced.pop(tp, None)
                                continue
                            fenced_at = self._tp_refused.get(tp)
                            if fenced_at is not None and fenced_at >= lease:
                                continue  # deposed until a fresh lease
                            if announced.get(tp) != lease:
                                _send_partition_frame(sock, b"Q", name,
                                                      part, lease)
                                announced[tp] = lease
                                self._tp_refused.pop(tp, None)
                                shipped += 1
                        if tp in self.gapped:
                            continue
                        if tp not in cursors:
                            start = int(
                                follower_ends.get(name, {}).get(str(part), 0))
                            begin = self.broker.begin_offset(name, part)
                            if begin > start:
                                # leader trimmed past the follower's end:
                                # cannot mirror contiguously — keep it out
                                # of the watermark, operator re-seeds
                                logger.error(
                                    "replication gap %s[%d]: leader begin "
                                    "%d > follower end %d; partition needs "
                                    "re-seeding", name, part, begin, start)
                                self.gapped.add(tp)
                                continue
                            if start > self.broker.end_offset(name, part):
                                # follower AHEAD of us: a deposed leader's
                                # un-acked divergent tail (its local
                                # appends after it lost the cluster).
                                # Streaming would silently fork the log —
                                # mark gapped, operator re-seeds.
                                logger.error(
                                    "replication divergence %s[%d]: "
                                    "follower end %d ahead of leader end; "
                                    "partition needs re-seeding",
                                    name, part, start)
                                self.gapped.add(tp)
                                continue
                            cursors[tp] = start
                        recs = self.broker.fetch(name, part, cursors[tp],
                                                 _BATCH)
                        for rec in recs:
                            _send_record(sock, rec)
                        if recs:
                            cursors[tp] = recs[-1].offset + 1
                            shipped += len(recs)
                if not shipped:
                    # idle: backoff sleep instead of wait_for_data (which
                    # is single-partition; this loop multiplexes all of
                    # them). 2 ms doubling to 50 ms keeps catch-up latency
                    # tight under traffic without burning a quiet
                    # deployment's CPU on list_topics+fetch 500x/sec
                    # (review r5 #4)
                    now = time.monotonic()
                    if now - last_tx >= self.heartbeat_s:
                        # heartbeat: an idle stream must still prove the
                        # leader alive, or every quiet period reads as a
                        # leader death to the follower's failure detector
                        sock.sendall(b"P" + _EPOCH.pack(epoch))
                        last_tx = now
                    self._stop.wait(idle_wait)
                    idle_wait = min(idle_wait * 2, 0.05)
                else:
                    idle_wait = _POLL_S
                    last_tx = time.monotonic()
        finally:
            try:
                sock.close()
            except OSError:
                pass


class ReplicatedBroker(Broker):
    """Leader-side wrapper: same log, replication-gated durability.

    Every data/admin call delegates to the wrapped broker; only the
    durability watermark changes — ``durable_offset`` is the minimum of
    the local fsync watermark and every follower's acked (fsynced)
    watermark, so the Producer's acks=all delivery reports fire only for
    records that survive the loss of any single node."""

    def __init__(self, broker: Broker, targets: List[str], *,
                 epoch: int = 0, allow_no_targets: bool = False,
                 gate: Optional[Callable[[], bool]] = None,
                 heartbeat_s: Optional[float] = None) -> None:
        if not targets and not allow_no_targets:
            # a degraded HA leader (last node standing) may run with zero
            # followers — but only when the caller says so explicitly;
            # plain replication_factor>1 config without followers stays a
            # loud error (runtime.py refuses it earlier too)
            raise ValueError("ReplicatedBroker needs at least one target")
        self.inner = broker
        self.epoch = epoch
        self._gate = gate
        self._heartbeat_s = heartbeat_s
        # leader-side control metadata mirrors (latest-wins), re-sent in
        # full on every follower (re)connect — the Broker ABC has no
        # enumeration API, so the leader is the source of truth here
        # swarmlint: guarded-by[self._ctrl_state_lock]: _commits, _trims
        self._ctrl_state_lock = make_lock("broker.replica.ReplicatedBroker._ctrl_state_lock")
        self._commits: Dict[Tuple[str, str, int], int] = {}
        self._trims: Dict[str, float] = {}
        # explicit deposal (the HA watch loop saw a higher epoch in the
        # cluster map before any follower had the chance to send F)
        self._fenced_override: Optional[int] = None
        self.replicators = [self._make_replicator(t) for t in targets]

    def _make_replicator(self, target: str) -> Replicator:
        return Replicator(
            self.inner, target,
            get_epoch=lambda: self.epoch,
            ctrl_snapshot=self._ctrl_snapshot,
            gate=self._gate,
            heartbeat_s=self._heartbeat_s,
        )

    def _ctrl_snapshot(self) -> Tuple[Dict, Dict]:
        with self._ctrl_state_lock:
            return dict(self._commits), dict(self._trims)

    def add_target(self, target: str) -> bool:
        """Attach a follower discovered after construction (HA: a node
        joining the cluster map). False if already replicating to it."""
        for r in self.replicators:
            if f"{r.addr[0]}:{r.addr[1]}" == target:
                return False
        self.replicators.append(self._make_replicator(target))
        return True

    @property
    def fenced_by(self) -> Optional[int]:
        """Highest epoch that fenced us, or None while leading."""
        epochs = [r.fenced_epoch for r in self.replicators
                  if r.fenced.is_set() and r.fenced_epoch is not None]
        if self._fenced_override is not None:
            epochs.append(self._fenced_override)
        return max(epochs) if epochs else None

    def set_fenced(self, epoch: int) -> None:
        """Depose this leader explicitly (cluster map moved past us)."""
        self._fenced_override = max(epoch, self._fenced_override or 0)

    def _check_fenced(self) -> None:
        fenced = self.fenced_by
        if fenced is not None:
            raise FencedError(
                f"leader deposed: our epoch {self.epoch} is fenced by a "
                f"follower at epoch {fenced} — appends refused (rejoin as "
                "a follower; see the HA runbook)")

    def stop_replication(self) -> None:
        """Stop the replicator threads WITHOUT closing the wrapped broker
        (a deposed leader keeps its log readable for re-seeding)."""
        for r in self.replicators:
            r.stop()

    # -- replication-gated durability ---------------------------------------

    def durable_offset(self, topic: str, partition: int) -> int:
        local = self.inner.durable_offset(topic, partition)
        return min([local] + [r.acked_offset(topic, partition)
                              for r in self.replicators])

    def wait_durable(self, topic: str, partition: int, offset: int,
                     timeout_s: float) -> bool:
        t0 = time.monotonic()
        deadline = time.time() + timeout_s
        if not self.inner.wait_durable(topic, partition, offset, timeout_s):
            return False
        for r in self.replicators:
            if not r.wait_acked(topic, partition, offset,
                                max(0.0, deadline - time.time())):
                return False
        # replication lag as writers experience it: append -> acks=all
        # watermark passed it (histogram at /metrics); the
        # waiting message's trace context tags the bucket exemplar
        tc = propagate.current()
        HIST_REPLICATION_COMMIT.observe(
            time.monotonic() - t0,
            tc.trace_id if tc is not None else None)
        return True

    def replication_stats(self) -> List[Dict]:
        """Per-follower fsync-watermark lag vs this leader's log (the
        /metrics replica gauges: without them the acks=all
        back-pressure path shows only as stalled DELIVERED reports). One end-offset sweep shared by every
        follower's :meth:`Replicator.lag_stats`."""
        ends: Dict[Tuple[str, int], int] = {}
        for name, meta in self.inner.list_topics().items():
            for p in range(meta.num_partitions):
                try:
                    ends[(name, p)] = self.inner.end_offset(name, p)
                except BrokerError:
                    continue
        return [r.lag_stats(ends) for r in self.replicators]

    def close(self) -> None:
        for r in self.replicators:
            r.stop()
        self.inner.close()

    # -- pure delegation ----------------------------------------------------

    def create_topic(self, name, num_partitions,
                     retention_ms=7 * 24 * 3600 * 1000):
        return self.inner.create_topic(name, num_partitions,
                                       retention_ms=retention_ms)

    def list_topics(self):
        return self.inner.list_topics()

    def create_partitions(self, name, new_total):
        return self.inner.create_partitions(name, new_total)

    # swarmlint: ha
    def append(self, topic, partition, value, key=None, timestamp=None):
        # the fencing check makes a deposed leader's writes fail FAST and
        # LOUD (with the epoch in the error) instead of appending to a log
        # no follower will ever ack — the local-only fork is what manual
        # failover could never rule out (SWL603 polices the ordering)
        self._check_fenced()
        off = self.inner.append(topic, partition, value, key=key,
                                timestamp=timestamp)
        tc = propagate.inject()
        if tc is not None:
            # announce the active trace to every follower stream so the
            # replication hop lands in the cluster-merged trace (G
            # frames dedup consecutive repeats; see post_trace)
            for r in self.replicators:
                r.post_trace(tc)
        return off

    def fetch(self, topic, partition, offset, max_records=256):
        return self.inner.fetch(topic, partition, offset, max_records)

    def end_offset(self, topic, partition):
        return self.inner.end_offset(topic, partition)

    def begin_offset(self, topic, partition):
        return self.inner.begin_offset(topic, partition)

    def wait_for_data(self, topic, partition, offset, timeout_s):
        return self.inner.wait_for_data(topic, partition, offset, timeout_s)

    def commit_offset(self, group, topic, partition, offset):
        # consumer-group offsets cross the stream:
        # a promoted follower serves every group from its replicated
        # committed offset, not the log beginning
        self.inner.commit_offset(group, topic, partition, offset)
        with self._ctrl_state_lock:
            self._commits[(group, topic, partition)] = offset
        for r in self.replicators:
            r.post_commit(group, topic, partition, offset)

    def committed_offset(self, group, topic, partition):
        return self.inner.committed_offset(group, topic, partition)

    def trim_older_than(self, topic, cutoff_ts):
        n = self.inner.trim_older_than(topic, cutoff_ts)
        with self._ctrl_state_lock:
            self._trims[topic] = max(cutoff_ts,
                                     self._trims.get(topic, cutoff_ts))
        for r in self.replicators:
            r.post_trim(topic, cutoff_ts)
        return n

    def flush(self) -> None:
        self.inner.flush()


def main(argv: Optional[List[str]] = None) -> None:
    """Run a follower node: ``python -m swarmdb_tpu_torch.broker.replica
    --log-dir /data/replica --listen 0.0.0.0:9444``"""
    import argparse

    ap = argparse.ArgumentParser(description="swarmdb follower replica node")
    ap.add_argument("--log-dir", required=True)
    ap.add_argument("--listen", default="127.0.0.1:9444")
    ap.add_argument("--sync-interval-ms", type=int, default=5)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from .native import NativeBroker

    host, _, port = args.listen.rpartition(":")
    broker = NativeBroker(log_dir=args.log_dir,
                          sync_interval_ms=args.sync_interval_ms)
    server = ReplicaServer(broker, host or "127.0.0.1", int(port)).start()
    print(f"REPLICA_READY {server.host}:{server.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
        broker.close()


if __name__ == "__main__":
    main()
