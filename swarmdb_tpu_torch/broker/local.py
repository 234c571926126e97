"""Pure-Python in-process broker.

Thread-safe partitioned log with blocking reads, consumer-group offsets,
retention trimming, and optional JSON snapshot durability. Implements the
full :class:`~swarmdb_tpu_torch.broker.base.Broker` contract so everything above
the transport (core runtime, serving backend) runs with no external
cluster — the role Kafka+Zookeeper containers play for the reference
(`dockerfile-compose.yaml:5-48`).

Concurrency model: one ``threading.Condition`` per partition guards a plain
list of records. Appends are O(1); fetches are O(result) via offset
arithmetic (offset - base index). This is the semantics twin of the C++
engine in ``broker/cpp/``; tests run against both through the same suite.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from .base import Broker, BrokerError, Record, TopicMeta, UnknownTopicError
from ..utils.sync import make_condition, make_lock


class _Partition:
    __slots__ = ("cond", "records", "base_offset")

    def __init__(self) -> None:
        self.cond = make_condition("broker.local._Partition.cond")
        self.records: List[Record] = []
        self.base_offset = 0  # offset of records[0]; grows as retention trims

    def end_offset(self) -> int:
        return self.base_offset + len(self.records)


class LocalBroker(Broker):
    # floor between durability-driven snapshots (wait_durable): one snapshot
    # covers every record pending at that moment (group commit), so this
    # bounds snapshot I/O at ~5/s regardless of message rate instead of
    # letting the 5ms delivery poller rewrite full state per cycle.
    SNAPSHOT_MIN_INTERVAL_S = 0.2

    def __init__(self, snapshot_path: Optional[str] = None) -> None:
        self._topics: Dict[str, TopicMeta] = {}
        self._parts: Dict[Tuple[str, int], _Partition] = {}
        self._offsets: Dict[Tuple[str, str, int], int] = {}  # (group, topic, part)
        self._meta_lock = make_lock("broker.local.LocalBroker._meta_lock")
        self._snapshot_path = snapshot_path
        # durability watermark per (topic, partition): end offsets captured by
        # the last snapshot. Only meaningful in snapshot mode — pure in-memory
        # operation has no crash durability, so append IS its durability point
        # and durable_offset == end_offset (see Broker.durable_offset).
        self._snap_ends: Dict[Tuple[str, int], int] = {}
        self._last_snapshot = 0.0
        # serializes snapshot writes: concurrent flush() callers (delivery
        # poller + explicit flush) share one fixed tmp path
        self._snap_lock = make_lock("broker.local.LocalBroker._snap_lock")
        if snapshot_path and os.path.exists(snapshot_path):
            self._restore(snapshot_path)

    # -- admin ---------------------------------------------------------------

    def create_topic(
        self, name: str, num_partitions: int, retention_ms: int = 7 * 24 * 3600 * 1000
    ) -> bool:
        with self._meta_lock:
            if name in self._topics:
                return False
            self._topics[name] = TopicMeta(name, num_partitions, retention_ms)
            for p in range(num_partitions):
                self._parts[(name, p)] = _Partition()
            return True

    def list_topics(self) -> Dict[str, TopicMeta]:
        with self._meta_lock:
            return dict(self._topics)

    def create_partitions(self, name: str, new_total: int) -> None:
        with self._meta_lock:
            meta = self._topics.get(name)
            if meta is None:
                raise UnknownTopicError(name)
            if new_total <= meta.num_partitions:
                return  # grow-only, like Kafka create_partitions
            for p in range(meta.num_partitions, new_total):
                self._parts[(name, p)] = _Partition()
            meta.num_partitions = new_total

    # -- data plane ----------------------------------------------------------

    def _part(self, topic: str, partition: int) -> _Partition:
        # under _meta_lock: an unguarded lookup racing
        # create_topic could observe the topic registered but its
        # partitions not yet built and mis-report "partition out of
        # range" for a topic that is coming up fine
        with self._meta_lock:
            part = self._parts.get((topic, partition))
            in_topics = topic in self._topics
        if part is None:
            if not in_topics:
                raise UnknownTopicError(topic)
            raise BrokerError(f"partition {partition} out of range for topic {topic!r}")
        return part

    def append(
        self,
        topic: str,
        partition: int,
        value: bytes,
        key: Optional[bytes] = None,
        timestamp: Optional[float] = None,
    ) -> int:
        part = self._part(topic, partition)
        ts = timestamp if timestamp is not None else time.time()
        with part.cond:
            offset = part.end_offset()
            part.records.append(Record(topic, partition, offset, key, value, ts))
            part.cond.notify_all()
            return offset

    def fetch(
        self, topic: str, partition: int, offset: int, max_records: int = 256
    ) -> List[Record]:
        part = self._part(topic, partition)
        with part.cond:
            start = max(offset, part.base_offset) - part.base_offset
            if start >= len(part.records):
                return []
            return list(part.records[start : start + max_records])

    def end_offset(self, topic: str, partition: int) -> int:
        part = self._part(topic, partition)
        with part.cond:
            return part.end_offset()

    def begin_offset(self, topic: str, partition: int) -> int:
        part = self._part(topic, partition)
        with part.cond:
            return part.base_offset

    def wait_for_data(
        self, topic: str, partition: int, offset: int, timeout_s: float
    ) -> bool:
        part = self._part(topic, partition)
        deadline = time.time() + timeout_s
        with part.cond:
            # predicate re-checked in a while loop:
            # the single-wait shape returned early on any spurious
            # wakeup or a notify for an already-consumed append,
            # degrading the long-poll into a busy poll
            while part.end_offset() <= offset:
                left = deadline - time.time()
                if left <= 0:
                    return False
                part.cond.wait(left)
            return True

    # -- consumer-group offsets ---------------------------------------------

    def commit_offset(self, group: str, topic: str, partition: int, offset: int) -> None:
        with self._meta_lock:
            self._offsets[(group, topic, partition)] = offset

    def committed_offset(self, group: str, topic: str, partition: int) -> Optional[int]:
        with self._meta_lock:
            return self._offsets.get((group, topic, partition))

    # -- retention -----------------------------------------------------------

    def trim_older_than(self, topic: str, cutoff_ts: float) -> int:
        meta = self.list_topics().get(topic)
        if meta is None:
            raise UnknownTopicError(topic)
        dropped = 0
        for p in range(meta.num_partitions):
            part = self._part(topic, p)
            with part.cond:
                i = 0
                while i < len(part.records) and part.records[i].timestamp < cutoff_ts:
                    i += 1
                if i:
                    part.records = part.records[i:]
                    part.base_offset += i
                    dropped += i
        return dropped

    def enforce_retention(self) -> int:
        """Trim every topic per its retention_ms (broker-side GC sweep)."""
        now = time.time()
        total = 0
        for meta in self.list_topics().values():
            total += self.trim_older_than(meta.name, now - meta.retention_ms / 1000.0)
        return total

    # -- durability ----------------------------------------------------------

    def flush(self) -> None:
        if self._snapshot_path:
            self.save_snapshot(self._snapshot_path)

    def durable_offset(self, topic: str, partition: int) -> int:
        """In snapshot mode the durability point is the last snapshot, not
        append — delivery reports (acks=all) must not outrun it."""
        if not self._snapshot_path:
            return self.end_offset(topic, partition)
        self._part(topic, partition)  # raises on unknown topic/partition
        with self._meta_lock:
            return self._snap_ends.get((topic, partition), 0)

    def wait_durable(self, topic: str, partition: int, offset: int,
                     timeout_s: float) -> bool:
        if not self._snapshot_path:
            return self.end_offset(topic, partition) > offset
        if self.durable_offset(topic, partition) > offset:
            return True
        # group commit, degenerate form: snapshot now (covers every pending
        # record at once) — rate-limited so a tight delivery-poll loop can't
        # turn the send path into O(full state) disk writes per cycle; an
        # explicit Producer.flush() -> Broker.flush() still snapshots
        # unconditionally. Honor timeout_s: wait out the rate-limit window
        # (or as much of it as the timeout allows) instead of returning
        # immediately and inviting a caller busy-spin.
        hold = self.SNAPSHOT_MIN_INTERVAL_S - (time.time() - self._last_snapshot)
        if hold > 0:
            time.sleep(min(hold, timeout_s))
        if time.time() - self._last_snapshot >= self.SNAPSHOT_MIN_INTERVAL_S:
            self.flush()
        return self.durable_offset(topic, partition) > offset

    def save_snapshot(self, path: str) -> None:
        """Full-state JSON snapshot (reference persistence shape analog,
        ` main.py:852-892`, applied at the broker layer)."""
        with self._snap_lock:
            self._save_snapshot_locked(path)

    def _save_snapshot_locked(self, path: str) -> None:
        with self._meta_lock:
            topics = {
                n: {"num_partitions": m.num_partitions, "retention_ms": m.retention_ms}
                for n, m in self._topics.items()
            }
            # JSON-array keys: group/topic names may contain any separator
            # character, so positional encoding is the only safe flattening.
            offsets = [[g, t, p, v] for (g, t, p), v in self._offsets.items()]
            parts = dict(self._parts)
        state = {
            "topics": topics,
            "partitions": [],
            "offsets": offsets,
            "timestamp": time.time(),
        }
        ends: Dict[Tuple[str, int], int] = {}
        for (topic, p), part in parts.items():
            with part.cond:
                ends[(topic, p)] = part.end_offset()
                state["partitions"].append({
                    "topic": topic,
                    "partition": p,
                    "base_offset": part.base_offset,
                    # base64: record keys/values are arbitrary bytes; a utf-8
                    # round-trip would corrupt binary payloads.
                    "records": [
                        {
                            "offset": r.offset,
                            "key": base64.b64encode(r.key).decode() if r.key else None,
                            "value": base64.b64encode(r.value).decode(),
                            "timestamp": r.timestamp,
                        }
                        for r in part.records
                    ],
                })
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, path)
        with self._meta_lock:
            self._snap_ends.update(ends)
            self._last_snapshot = time.time()

    def _restore(self, path: str) -> None:
        with open(path) as f:
            state = json.load(f)
        for name, m in state.get("topics", {}).items():
            self.create_topic(name, m["num_partitions"], m["retention_ms"])
        for pdata in state.get("partitions", []):
            topic, pnum = pdata["topic"], pdata["partition"]
            part = self._part(topic, pnum)
            part.base_offset = pdata["base_offset"]
            part.records = [
                Record(
                    topic,
                    pnum,
                    r["offset"],
                    base64.b64decode(r["key"]) if r["key"] else None,
                    base64.b64decode(r["value"]),
                    r["timestamp"],
                )
                for r in pdata["records"]
            ]
        with self._meta_lock:
            for group, topic, pnum, off in state.get("offsets", []):
                self._offsets[(group, topic, pnum)] = off
            for (topic, p), part in self._parts.items():
                self._snap_ends[(topic, p)] = part.end_offset()
