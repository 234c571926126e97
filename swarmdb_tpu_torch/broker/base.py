"""Broker transport interface (the L1 layer).

This is the contract the reference consumes from confluent_kafka/librdkafka
(produce/poll/flush at ` main.py:476-484,1386`; subscribe/poll/close at
`:344,557,367`; list_topics/create_topics/create_partitions at
`:241,277,1349`) re-expressed as an in-tree interface with the JAX
package's two implementations:

- ``broker.local.LocalBroker`` — pure-Python, thread-safe, in-memory with
  optional JSON durability; used for tests and single-process serving.
- ``broker.native.NativeBroker`` — the C++ engine (append-only segment
  log, per-partition rings) loaded via ctypes, built at first use from the
  port's own ``broker/cpp/broker.cpp``.

``broker.replica`` replicates either across hosts and ``ha/`` supervises
the replicas. A copy of ``swarmdb_tpu/broker/base.py``: the port imports
nothing of the JAX package.

Key semantic choices (deliberate departures from the reference):

- Partition affinity is REAL: consumers subscribe to specific partitions and
  unicast messages are produced to the receiver's partition, so receive is
  O(own messages). The reference's consumers re-read the whole topic and
  filter client-side (defect D8, ` main.py:334-345,579-585`).
- Broadcast is a fan-out WRITE (one record per partition) instead of a
  fan-out READ, preserving single-partition consumption.
- The partitioner is stable FNV-1a (fixes defect D6).
"""

from __future__ import annotations

import abc
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils.sync import make_lock

logger = logging.getLogger("swarmdb_tpu_torch.broker")


@dataclass(frozen=True)
class Record:
    """One entry in a partition log (librdkafka ``Message`` equivalent)."""

    topic: str
    partition: int
    offset: int
    key: Optional[bytes]
    value: bytes
    timestamp: float


@dataclass
class TopicMeta:
    name: str
    num_partitions: int
    retention_ms: int


DeliveryCallback = Callable[[Optional[str], Record], None]
# signature mirrors rdkafka's (err, msg) delivery report (` main.py:374-391`):
# err is None on success, else a human-readable error string.


class BrokerError(Exception):
    #: True when retrying the same operation (possibly against a newly
    #: resolved leader) is safe and likely to succeed. Callers that queue
    #: work (the runtime's send path) use this to distinguish "try again"
    #: from "give up".
    retryable = False


class UnknownTopicError(BrokerError):
    pass


class FencedError(BrokerError):
    """A deposed leader tried to write with a stale fencing epoch.

    Raised by :class:`~swarmdb_tpu_torch.broker.replica.ReplicatedBroker` once a
    follower (or the cluster map) reports a higher epoch than this
    leader's: its appends and mirror connections are refused so a
    partitioned old leader coming back can never fork the replicated log.
    NOT retryable — the process must rejoin as a follower (see the HA
    runbook in the README).

    Partition-scoped: under partition-level leadership a
    node is fenced per ``(topic, partition)`` lease, not per process —
    ``topic``/``partition``/``epoch`` carry which lease was lost and at
    what fencing epoch, while the node's OTHER leaderships keep writing.
    Node-level fencing leaves them ``None``."""

    retryable = False

    def __init__(self, *args, topic: "Optional[str]" = None,
                 partition: "Optional[int]" = None,
                 epoch: "Optional[int]" = None) -> None:
        super().__init__(*args)
        self.topic = topic
        self.partition = partition
        self.epoch = epoch


class LeaderChangedError(BrokerError):
    """The cluster leader moved (failover in progress or completed).

    Raised by :class:`~swarmdb_tpu_torch.ha.client.ClusterBroker` when the node
    it was bound to died or was deposed. Retryable: the next attempt
    re-resolves the leader from the cluster map."""

    retryable = True


class Broker(abc.ABC):
    """Storage + admin plane. One per process (or one native engine)."""

    # -- admin (AdminClient equivalent: ` main.py:241,277,1349`) -------------

    @abc.abstractmethod
    def create_topic(
        self, name: str, num_partitions: int, retention_ms: int = 7 * 24 * 3600 * 1000
    ) -> bool:
        """Create a topic; returns False if it already existed."""

    @abc.abstractmethod
    def list_topics(self) -> Dict[str, TopicMeta]: ...

    @abc.abstractmethod
    def create_partitions(self, name: str, new_total: int) -> None:
        """Grow (never shrink) a topic's partition count
        (reference `auto_scale_partitions`, ` main.py:1327-1365`)."""

    # -- data plane ----------------------------------------------------------

    @abc.abstractmethod
    def append(
        self,
        topic: str,
        partition: int,
        value: bytes,
        key: Optional[bytes] = None,
        timestamp: Optional[float] = None,
    ) -> int:
        """Append one record; returns its offset."""

    @abc.abstractmethod
    def fetch(
        self, topic: str, partition: int, offset: int, max_records: int = 256
    ) -> List[Record]:
        """Read records at >= offset. Non-blocking; empty list if none."""

    @abc.abstractmethod
    def end_offset(self, topic: str, partition: int) -> int:
        """Offset one past the last record (== next offset to be assigned)."""

    @abc.abstractmethod
    def begin_offset(self, topic: str, partition: int) -> int:
        """Earliest retained offset (>0 after retention trims)."""

    @abc.abstractmethod
    def wait_for_data(
        self, topic: str, partition: int, offset: int, timeout_s: float
    ) -> bool:
        """Block until a record at >= offset exists or timeout. True if data."""

    # -- consumer-group offsets ---------------------------------------------

    @abc.abstractmethod
    def commit_offset(self, group: str, topic: str, partition: int, offset: int) -> None: ...

    @abc.abstractmethod
    def committed_offset(self, group: str, topic: str, partition: int) -> Optional[int]: ...

    # -- retention / durability ---------------------------------------------

    @abc.abstractmethod
    def trim_older_than(self, topic: str, cutoff_ts: float) -> int:
        """Drop records older than cutoff; returns number dropped."""

    def durable_offset(self, topic: str, partition: int) -> int:
        """Offsets below this are crash-durable. The default (== end_offset)
        is correct for brokers whose append IS the durability point (the
        in-memory LocalBroker); the native broker reports its group-commit
        fsync watermark instead."""
        return self.end_offset(topic, partition)

    def wait_durable(self, topic: str, partition: int, offset: int,
                     timeout_s: float) -> bool:
        """Block until the record at ``offset`` is durable (or timeout)."""
        return self.durable_offset(topic, partition) > offset

    def flush(self) -> None:
        """Force durability (fsync segment logs). No-op for in-memory."""

    def close(self) -> None:
        pass

    # -- health --------------------------------------------------------------

    def healthy(self) -> bool:
        """Liveness probe used by GET /health (reference `api.py:794-800`)."""
        try:
            self.list_topics()
            return True
        except Exception:
            return False


class Producer:
    """Client-side producer with acks=all delivery reports.

    Mirrors the confluent Producer surface the reference uses
    (` main.py:476-484`): ``produce(topic, value, key, partition,
    on_delivery)`` + ``poll`` + ``flush``. Callbacks are queued at produce
    time and fired from ``poll``/``flush`` — but ONLY once the record's
    offset clears the broker's durability watermark
    (``Broker.durable_offset``), matching the reference's ``acks=all``
    contract (` main.py:196-197`): a delivery report implies the record
    survives a broker crash. For the in-memory LocalBroker the watermark is
    the end offset, so callbacks fire on the next poll; for the native
    broker they fire after its group-commit fsync (~sync_interval_ms).
    """

    def __init__(self, broker: Broker) -> None:
        self._broker = broker
        self._pending: List[Tuple[DeliveryCallback, Optional[str], Record]] = []
        # swarmlint: guarded-by[self._pending_lock]: _pending
        self._pending_lock = make_lock("broker.base.Producer._pending_lock")
        # serializes whole poll() invocations: two concurrent pollers (the
        # runtime's delivery-poll thread + send_message's inline poll) could
        # otherwise swap out separate batches and fire per-partition
        # callbacks out of order
        self._poll_lock = make_lock("broker.base.Producer._poll_lock")

    def produce(
        self,
        topic: str,
        value: bytes,
        key: Optional[bytes] = None,
        partition: Optional[int] = None,
        on_delivery: Optional[DeliveryCallback] = None,
    ) -> Record:
        if partition is None:
            from ..utils.hashing import stable_partition

            meta = self._broker.list_topics().get(topic)
            if meta is None:
                raise UnknownTopicError(topic)
            partition = stable_partition(
                (key or value).decode("utf-8", "replace"), meta.num_partitions
            )
        # Local errors raise synchronously (rdkafka contract); the delivery
        # callback reports the committed (topic, partition, offset).
        ts = time.time()
        offset = self._broker.append(topic, partition, value, key=key, timestamp=ts)
        record = Record(topic, partition, offset, key, value, ts)
        if on_delivery is not None:
            with self._pending_lock:
                self._pending.append((on_delivery, None, record))
        return record

    def poll(self, timeout: float = 0.0) -> int:
        """Fire delivery callbacks for durably-committed records.

        Returns how many fired. Records not yet past the durability
        watermark stay queued for a later poll (or ``flush``). A positive
        ``timeout`` blocks up to that long for the oldest pending record to
        become durable.
        """
        if timeout > 0:
            # blocking wait happens OUTSIDE _poll_lock: the background
            # delivery poller parks here for its whole timeout, and holding
            # the lock through it would stall every send_message's inline
            # poll(0) behind the wait
            with self._pending_lock:
                oldest = self._pending[0][2] if self._pending else None
            if oldest is not None:
                self._broker.wait_durable(
                    oldest.topic, oldest.partition, oldest.offset, timeout
                )
        with self._poll_lock:
            with self._pending_lock:
                batch, self._pending = self._pending, []
            if not batch:
                return 0
            fired = 0
            requeue: List[Tuple[DeliveryCallback, Optional[str], Record]] = []
            watermarks: Dict[Tuple[str, int], int] = {}
            part_errors: Dict[Tuple[str, int], str] = {}
            for cb, err, rec in batch:
                tp = (rec.topic, rec.partition)
                if tp not in watermarks and tp not in part_errors:
                    try:
                        watermarks[tp] = self._broker.durable_offset(*tp)
                    except BrokerError as exc:
                        # topic gone or partition poisoned (failed fsync):
                        # durability can never be confirmed — report the
                        # ERROR, never a false DELIVERED
                        part_errors[tp] = str(exc)
                if tp in part_errors and err is None:
                    err = part_errors[tp]
                if err is not None or rec.offset < watermarks[tp]:
                    cb(err, rec)
                    fired += 1
                else:
                    requeue.append((cb, err, rec))
            if requeue:
                with self._pending_lock:
                    # prepend to preserve per-partition callback order
                    self._pending = requeue + self._pending
            return fired

    def flush(self, timeout: float = -1.0) -> int:
        """Force durability, then fire every pending callback."""
        self._broker.flush()
        self.poll(0)
        with self._pending_lock:
            remaining = len(self._pending)
        return remaining

    @property
    def pending_count(self) -> int:
        """Delivery callbacks queued but not yet past the durability gate."""
        with self._pending_lock:
            return len(self._pending)


@dataclass
class _PartitionCursor:
    topic: str
    partition: int
    next_offset: int
    buffer: "deque" = field(default_factory=lambda: deque())


class Consumer:
    """Partition-affine consumer with committed offsets.

    Unlike the reference's consumers (whole-topic subscribe + client-side
    filter, defect D8), a Consumer subscribes to explicit ``(topic,
    partition)`` pairs — normally exactly the one partition its agent hashes
    to — and round-robins across them.
    """

    # prefetch granularity and auto-commit cadence (rdkafka-style periodic
    # commits: at-least-once, bounded redelivery window after a crash)
    FETCH_BATCH = 64
    COMMIT_EVERY_RECORDS = 64
    COMMIT_EVERY_S = 1.0

    def __init__(
        self,
        broker: Broker,
        group_id: str,
        auto_offset_reset: str = "earliest",
        auto_commit: bool = True,
    ) -> None:
        self._broker = broker
        self.group_id = group_id
        self._auto_offset_reset = auto_offset_reset
        self._auto_commit = auto_commit
        self._cursors: List[_PartitionCursor] = []
        self._rr = 0  # round-robin index
        self._closed = False
        self._uncommitted = 0
        self._last_commit = time.time()

    def assign(self, assignments: Sequence[Tuple[str, int]]) -> None:
        """Subscribe to explicit (topic, partition) pairs."""
        self._cursors = []
        for topic, part in assignments:
            committed = self._broker.committed_offset(self.group_id, topic, part)
            if committed is not None:
                start = committed
            elif self._auto_offset_reset == "latest":
                start = self._broker.end_offset(topic, part)
            else:  # earliest
                start = self._broker.begin_offset(topic, part)
            self._cursors.append(_PartitionCursor(topic, part, start))

    def add_assignment(
        self, topic: str, partition: int, start_offset: Optional[int] = None
    ) -> bool:
        """Incrementally add one partition, KEEPING existing assignments.

        Used on partition-count growth (`SwarmDB.auto_scale_partitions`): the
        old partition stays assigned so its undelivered backlog drains, and
        the newly-mapped partition starts at committed-offset-if-any, else
        ``start_offset`` (the caller's pre-growth end snapshot), else its
        CURRENT END — never earliest — so historical records there (e.g.
        broadcast fan-out copies this group already consumed via its old
        partition) are not replayed. Returns False if already assigned.
        """
        for cur in self._cursors:
            if (cur.topic, cur.partition) == (topic, partition):
                return False
        committed = self._broker.committed_offset(self.group_id, topic, partition)
        if committed is not None:
            start = committed
        elif start_offset is not None:
            start = start_offset
        else:
            start = self._broker.end_offset(topic, partition)
        self._cursors.append(_PartitionCursor(topic, partition, start))
        return True

    def subscribe_topic(self, topic: str) -> None:
        """Whole-topic subscription (all partitions) — reference-compatible
        mode used by admin/replay tooling, not the per-agent hot path."""
        meta = self._broker.list_topics().get(topic)
        if meta is None:
            raise UnknownTopicError(topic)
        self.assign([(topic, p) for p in range(meta.num_partitions)])

    def _take(self, cur: _PartitionCursor) -> Record:
        rec = cur.buffer.popleft()
        cur.next_offset = rec.offset + 1
        if self._auto_commit:
            # periodic commit, not per record: a commit is a durable-log
            # append broker-side, so per-record committing puts one file
            # write on every consumed message
            self._uncommitted += 1
            now = time.time()
            if (self._uncommitted >= self.COMMIT_EVERY_RECORDS
                    or now - self._last_commit >= self.COMMIT_EVERY_S):
                self.commit()
        return rec

    def poll(self, timeout: float = 0.0) -> Optional[Record]:
        """Next record from any assigned partition, or None on timeout.

        Records are prefetched in batches of ``FETCH_BATCH`` per broker
        call; offsets auto-commit periodically (see _take).
        """
        if self._closed or not self._cursors:
            return None
        deadline = time.time() + max(0.0, timeout)
        while True:
            for _ in range(len(self._cursors)):
                cur = self._cursors[self._rr % len(self._cursors)]
                self._rr += 1
                if cur.buffer:
                    return self._take(cur)
                # Retention may have trimmed past our cursor — skip forward.
                begin = self._broker.begin_offset(cur.topic, cur.partition)
                if cur.next_offset < begin:
                    cur.next_offset = begin
                recs = self._broker.fetch(
                    cur.topic, cur.partition, cur.next_offset, self.FETCH_BATCH
                )
                if recs:
                    cur.buffer.extend(recs)
                    return self._take(cur)
                # A failover may seat a copy of the log shorter than the
                # offset this cursor reached: the records past its end are
                # gone, and new ones land at those offsets. Re-read from
                # the new end (the JAX package rewinds only past a trim,
                # and its cursor waits past the end forever).
                end = self._broker.end_offset(cur.topic, cur.partition)
                if cur.next_offset > end:
                    logger.warning(
                        "%s[%d]: cursor %d past the log's end %d (a "
                        "failover seated a shorter copy); re-reading from "
                        "the end", cur.topic, cur.partition,
                        cur.next_offset, end)
                    cur.next_offset = end
            remaining = deadline - time.time()
            if remaining <= 0:
                return None
            # Block on the first cursor's partition for the remainder; any
            # new data there wakes us, otherwise we re-scan on timeout.
            cur = self._cursors[self._rr % len(self._cursors)]
            self._broker.wait_for_data(
                cur.topic, cur.partition, cur.next_offset, min(remaining, 0.05)
            )

    def commit(self) -> None:
        for cur in self._cursors:
            self._broker.commit_offset(
                self.group_id, cur.topic, cur.partition, cur.next_offset
            )
        self._uncommitted = 0
        self._last_commit = time.time()

    def close(self) -> None:
        if not self._closed:
            if self._auto_commit:
                self.commit()
            self._closed = True

    @property
    def assignments(self) -> List[Tuple[str, int]]:
        return [(c.topic, c.partition) for c in self._cursors]
