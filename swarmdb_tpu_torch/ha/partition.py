"""Partition-level leadership: leases, quorum acks, spread policy.

Partition leadership generalizes the HA machinery from "one leader node" to "one
leader PER (topic, partition)" — the granularity Kafka scales writes at
and the one DeServe-style serving assumes for fine-grained reassignment.
This module owns the node-side pieces:

- :class:`PartitionLeases` — the set of partitions THIS node currently
  leads, each at its assignment's fencing epoch. The write path consults
  it lock-cheap on every append; the HA watch loop reconciles it against
  the cluster map's ``assignments`` table.
- :class:`PartitionReplicatedBroker` — the node's broker facade in
  partition mode. Appends are fence-checked per partition (a lost lease
  raises a partition-scoped :class:`FencedError` carrying the fencing
  epoch, while the node's other leaderships keep writing), leased
  partitions replicate to every peer through partition-filtered
  :class:`~swarmdb_tpu_torch.broker.replica.Replicator` streams (Q-frame lease
  announces, N-frame fences), and durability is **quorum-gated**:
  ``durable_offset`` is the offset a majority of replicas (local fsync
  included) have fsynced. Majority — not all — is what bounds the blast
  radius of a node death to the partitions it LED: every other
  partition's leader keeps acking through the surviving majority while
  the dead node's partitions fail over. Zero acked loss still holds:
  followers mirror the leader's log contiguously (prefix property), so
  the most-caught-up live replica per partition — which failover seats —
  contains every majority-acked record.
- spread policy helpers — deterministic per-``(partition, node)`` scores
  so every coordinator ranks candidates identically (ties on catch-up
  spread leaderships instead of piling onto the lexically-first node),
  plus the env knobs: ``SWARMDB_HA_PARTITION_LEADERSHIP`` (default off —
  partition mode is for ClusterBroker-fronted deployments; an embedded
  single-node runtime writes through its own facade and cannot route to
  peer leaders) and ``SWARMDB_HA_SPREAD`` (max leaderships a node sheds
  per anti-entropy pass when a healed peer rejoins under-loaded).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..broker.base import Broker, BrokerError, FencedError
from ..broker.replica import Replicator
from ..obs import propagate
from ..utils.sync import make_lock

__all__ = ["PartitionLeases", "PartitionReplicatedBroker",
           "partition_leadership_default", "spread_moves_default",
           "spread_score", "is_internal_topic"]

#: topics the HA layer itself owns (fencing epochs): never leased, never
#: partition-replicated — each node persists its own copies locally
INTERNAL_PREFIX = "__"


def is_internal_topic(name: str) -> bool:
    return name.startswith(INTERNAL_PREFIX)


def partition_leadership_default(cluster_mode: bool = False) -> bool:
    """Partition mode's default: ON for cluster-mode nodes —
    the deployment entry points (``python -m swarmdb_tpu_torch.ha.node``,
    ``api/server.py`` with SWARMDB_HA_NODE_ID) pass ``cluster_mode=True``
    now that the embedded runtime routes produces through partition
    leaders (``HANode.client_broker``). Explicitly setting
    ``SWARMDB_HA_PARTITION_LEADERSHIP`` wins either way; in-process
    harnesses that pass nothing keep the node-level default (off), so
    embedded single-node behavior stays bit-identical."""
    raw = os.environ.get("SWARMDB_HA_PARTITION_LEADERSHIP")
    if raw is None or not raw.strip():
        return bool(cluster_mode)
    return raw.strip() not in ("0", "false", "no")


def spread_moves_default() -> int:
    try:
        return max(1, int(os.environ.get("SWARMDB_HA_SPREAD", "1")))
    except ValueError:
        return 1


def spread_score(topic: str, partition: int, node_id: str) -> int:
    """Deterministic pseudo-random tie-breaker for candidate ranking:
    every coordinator computes the same score for the same
    ``(partition, node)`` pair, so equally-caught-up candidates are
    SPREAD across the cluster instead of all failing over onto the
    lexically-greatest node id."""
    raw = f"{topic}:{partition}:{node_id}".encode("utf-8")
    return int.from_bytes(hashlib.sha1(raw).digest()[:8], "big")


class PartitionLeases:
    """The partitions this node currently leads, each at its lease
    (assignment) epoch. Thread-safe; the append-path read is one dict
    lookup under a plain lock."""

    def __init__(self) -> None:
        # swarmlint: guarded-by[self._lock]: _leases, _fenced
        self._lock = make_lock("ha.partition.PartitionLeases._lock")
        self._leases: Dict[Tuple[str, int], int] = {}
        # tp -> highest epoch that fenced us (error messages carry it)
        self._fenced: Dict[Tuple[str, int], int] = {}

    def epoch_of(self, topic: str, partition: int) -> Optional[int]:
        with self._lock:
            return self._leases.get((topic, partition))

    def grant(self, topic: str, partition: int, epoch: int) -> bool:
        """Take (or refresh) a lease; never moves an epoch backwards."""
        tp = (topic, partition)
        with self._lock:
            if epoch < self._leases.get(tp, 0):
                return False
            if epoch <= self._fenced.get(tp, -1):
                return False  # already fenced at/above this epoch
            self._leases[tp] = int(epoch)
            return True

    def revoke(self, topic: str, partition: int,
               fenced_epoch: Optional[int] = None) -> Optional[int]:
        """Drop a lease (deposed, or handing over); returns the epoch the
        lease was held at, or None when it was not held."""
        tp = (topic, partition)
        with self._lock:
            held = self._leases.pop(tp, None)
            if fenced_epoch is not None:
                self._fenced[tp] = max(fenced_epoch,
                                       self._fenced.get(tp, 0))
            return held

    def fenced_epoch(self, topic: str, partition: int) -> Optional[int]:
        with self._lock:
            return self._fenced.get((topic, partition))

    def snapshot(self) -> Dict[Tuple[str, int], int]:
        with self._lock:
            return dict(self._leases)

    def count(self) -> int:
        with self._lock:
            return len(self._leases)


class PartitionReplicatedBroker(Broker):
    """Leader-side facade for partition mode: per-partition fencing on
    the write path, partition-filtered replication to every peer, and
    quorum-gated durability (see module docstring).

    ``on_lease_fenced(topic, partition, epoch)`` fires when a follower
    N-fences one of our leases (a newer leader announced a higher epoch)
    — the HA node records the event and re-reads the map."""

    _POLL_S = 0.002

    def __init__(self, broker: Broker, node_id: str, *,
                 gate: Optional[Callable[[], bool]] = None,
                 heartbeat_s: Optional[float] = None,
                 on_lease_fenced: Optional[
                     Callable[[str, int, int], None]] = None,
                 on_topic_created: Optional[
                     Callable[[str, int], None]] = None) -> None:
        self.inner = broker
        self.node_id = node_id
        self.leases = PartitionLeases()
        self._gate = gate
        self._heartbeat_s = heartbeat_s
        self._on_lease_fenced = on_lease_fenced
        # fired after create_topic/create_partitions lands locally: the
        # controller assigns the new partitions across live nodes HERE,
        # so producers can route them one map-refresh later
        self._on_topic_created = on_topic_created
        # swarmlint: guarded-by[self._repl_lock]: _repls, _cluster_size
        self._repl_lock = make_lock("ha.partition.PartitionReplicatedBroker._repl_lock")
        self._repls: Dict[str, Replicator] = {}  # replica_addr -> stream
        # registered replica-set size (self included): the quorum floor.
        # A node whose peers all vanished must NOT fall back to acking
        # alone — durability stays pinned to a majority of the cluster
        # the map last said this partition replicates across.
        self._cluster_size = 1
        # leader-side control metadata (latest-wins), re-sent in full on
        # every follower (re)connect — same contract as ReplicatedBroker
        # swarmlint: guarded-by[self._ctrl_state_lock]: _commits, _trims
        self._ctrl_state_lock = make_lock("ha.partition.PartitionReplicatedBroker._ctrl_state_lock")
        self._commits: Dict[Tuple[str, str, int], int] = {}
        self._trims: Dict[str, float] = {}

    # ------------------------------------------------------------- topology

    def _lease_fn(self, topic: str, part: int) -> Optional[int]:
        if is_internal_topic(topic):
            return None
        return self.leases.epoch_of(topic, part)

    def _ctrl_snapshot(self) -> Tuple[Dict, Dict]:
        with self._ctrl_state_lock:
            return dict(self._commits), dict(self._trims)

    def _fenced_by_follower(self, topic: str, part: int,
                            epoch: int) -> None:
        self.leases.revoke(topic, part, fenced_epoch=epoch)
        if self._on_lease_fenced is not None:
            try:
                self._on_lease_fenced(topic, part, epoch)
            except Exception:
                pass

    def sync_targets(self, addrs: Iterable[str]) -> None:
        """Reconcile replication streams with the cluster map's current
        peer set: new peers get a stream, deregistered (dead) peers are
        stopped AND leave the ack quorum — pruning a corpse is what lets
        the surviving majority keep acking."""
        want = {a for a in addrs if a}
        with self._repl_lock:
            self._cluster_size = len(want) + 1
            stale = [a for a in self._repls if a not in want]
            stopped = [self._repls.pop(a) for a in stale]
            for addr in want:
                if addr not in self._repls:
                    self._repls[addr] = Replicator(
                        self.inner, addr,
                        ctrl_snapshot=self._ctrl_snapshot,
                        gate=self._gate, heartbeat_s=self._heartbeat_s,
                        lease_fn=self._lease_fn, node_id=self.node_id,
                        on_partition_fenced=self._fenced_by_follower)
        for r in stopped:
            r.stop()

    def _replicas(self) -> List[Replicator]:
        with self._repl_lock:
            return list(self._repls.values())

    def targets(self) -> List[str]:
        with self._repl_lock:
            return sorted(self._repls)

    def stop_replication(self) -> None:
        with self._repl_lock:
            repls, self._repls = list(self._repls.values()), {}
        for r in repls:
            r.stop()

    # ----------------------------------------------------------- write path

    def _check_partition_fence(self, topic: str, partition: int) -> None:
        """Every partition-log write passes here first (swarmlint SWL603
        polices the ordering): no live lease -> partition-scoped
        FencedError carrying the fencing epoch, so a deposed partition
        leader fails LOUD on exactly that partition while its other
        leaderships keep writing."""
        if is_internal_topic(topic):
            return  # HA bookkeeping topics are node-local, never leased
        if self.leases.epoch_of(topic, partition) is not None:
            return
        fenced = self.leases.fenced_epoch(topic, partition)
        raise FencedError(
            f"not the leader of {topic}[{partition}]"
            + (f" (lease fenced at epoch {fenced})" if fenced is not None
               else " (no lease)") +
            " — appends refused; the cluster map names the current "
            "partition leader",
            topic=topic, partition=partition, epoch=fenced)

    # swarmlint: ha
    def append(self, topic, partition, value, key=None, timestamp=None):
        self._check_partition_fence(topic, partition)
        off = self.inner.append(topic, partition, value, key=key,
                                timestamp=timestamp)
        tc = propagate.inject()
        if tc is not None:
            for r in self._replicas():
                r.post_trace(tc)
        return off

    # swarmlint: ha
    def commit_offset(self, group, topic, partition, offset):
        # consumer-group commits replicate per-partition (C frames go to
        # every peer), so ANY future leader of this partition serves the
        # group from its committed offset, not the log start
        self._check_partition_fence(topic, partition)
        self.inner.commit_offset(group, topic, partition, offset)
        with self._ctrl_state_lock:
            self._commits[(group, topic, partition)] = offset
        for r in self._replicas():
            r.post_commit(group, topic, partition, offset)

    def trim_older_than(self, topic, cutoff_ts):
        # topic-wide retention: routed to the controller by ClusterBroker
        # (there is no single partition to fence on); X frames replicate
        # the trim to every peer like the node-level path does
        n = self.inner.trim_older_than(topic, cutoff_ts)
        with self._ctrl_state_lock:
            self._trims[topic] = max(cutoff_ts,
                                     self._trims.get(topic, cutoff_ts))
        for r in self._replicas():
            r.post_trim(topic, cutoff_ts)
        return n

    # ----------------------------------------------------- quorum durability

    def _quorum(self) -> int:
        """Majority of the REGISTERED replica set (local copy included)
        — not of whatever streams happen to be up right now: a node
        stripped of its peers (killed mid-teardown, isolated) must stall
        acks, never quietly degrade to single-copy durability."""
        with self._repl_lock:
            total = max(self._cluster_size, 1 + len(self._repls))
        return total // 2 + 1

    def durable_offset(self, topic: str, partition: int) -> int:
        local = self.inner.durable_offset(topic, partition)
        if (is_internal_topic(topic)
                or self.leases.epoch_of(topic, partition) is None):
            # not ours to gate: report the local fsync watermark (the
            # partition's leader is the ack authority; ClusterBroker
            # routes durability waits there)
            return local
        marks = sorted(
            [local] + [r.acked_offset(topic, partition)
                       for r in self._replicas()],
            reverse=True)
        quorum = self._quorum()
        if len(marks) < quorum:
            return 0  # not enough replicas to form a majority: no acks
        return marks[quorum - 1]

    def wait_durable(self, topic: str, partition: int, offset: int,
                     timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        if (is_internal_topic(topic)
                or self.leases.epoch_of(topic, partition) is None):
            return self.inner.wait_durable(topic, partition, offset,
                                           timeout_s)
        # drive the LOCAL durability point first: snapshot-mode brokers
        # advance their watermark inside wait_durable (group commit),
        # not in the background — polling durable_offset alone would
        # park forever on them
        if not self.inner.wait_durable(topic, partition, offset,
                                       timeout_s):
            return False
        while True:
            try:
                if self.durable_offset(topic, partition) > offset:
                    return True
            except BrokerError:
                return False
            if self.leases.epoch_of(topic, partition) is None:
                return False  # lease lost mid-wait: caller re-resolves
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            time.sleep(min(self._POLL_S, left))

    # ------------------------------------------------------------------ obs

    def replication_stats(self) -> List[Dict]:
        ends: Dict[Tuple[str, int], int] = {}
        for name, meta in self.inner.list_topics().items():
            for p in range(meta.num_partitions):
                try:
                    ends[(name, p)] = self.inner.end_offset(name, p)
                except BrokerError:
                    continue
        return [r.lag_stats(ends) for r in self._replicas()]

    def partition_lag(self) -> Dict[str, Dict[str, int]]:
        """Per-LED-partition replica lag: local end vs the slowest
        quorum member's acked watermark (the /admin/ha table column)."""
        out: Dict[str, Dict[str, int]] = {}
        repls = self._replicas()
        for (topic, part), epoch in sorted(self.leases.snapshot().items()):
            try:
                end = self.inner.end_offset(topic, part)
            except BrokerError:
                continue
            marks = sorted([r.acked_offset(topic, part) for r in repls],
                           reverse=True)
            need = max(0, self._quorum() - 1)  # followers in the quorum
            quorum_mark = (marks[need - 1] if need and len(marks) >= need
                           else end)
            out[f"{topic}:{part}"] = {
                "epoch": epoch, "end": end,
                "replica_lag": max(0, end - quorum_mark),
            }
        return out

    # -------------------------------------------------------- pure delegation

    def create_topic(self, name, num_partitions,
                     retention_ms=7 * 24 * 3600 * 1000):
        created = self.inner.create_topic(name, num_partitions,
                                          retention_ms=retention_ms)
        if self._on_topic_created is not None and not is_internal_topic(name):
            try:
                self._on_topic_created(name, num_partitions)
            except Exception:
                pass  # the anti-entropy pass is the assignment backstop
        return created

    def list_topics(self):
        return self.inner.list_topics()

    def create_partitions(self, name, new_total):
        out = self.inner.create_partitions(name, new_total)
        if self._on_topic_created is not None and not is_internal_topic(name):
            try:
                self._on_topic_created(name, new_total)
            except Exception:
                pass
        return out

    def fetch(self, topic, partition, offset, max_records=256):
        return self.inner.fetch(topic, partition, offset, max_records)

    def end_offset(self, topic, partition):
        return self.inner.end_offset(topic, partition)

    def begin_offset(self, topic, partition):
        return self.inner.begin_offset(topic, partition)

    def wait_for_data(self, topic, partition, offset, timeout_s):
        return self.inner.wait_for_data(topic, partition, offset, timeout_s)

    def committed_offset(self, group, topic, partition):
        return self.inner.committed_offset(group, topic, partition)

    def flush(self) -> None:
        self.inner.flush()

    def close(self) -> None:
        self.stop_replication()
        self.inner.close()

    def healthy(self) -> bool:
        try:
            return self.inner.healthy()
        except Exception:
            return False
