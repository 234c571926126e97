"""ClusterBroker: client-side zero-loss failover.

A :class:`~swarmdb_tpu_torch.broker.base.Broker` facade that binds to whichever
node the cluster map says is leader, and re-points when leadership moves.
The contract for an in-flight ``send_message``:

- it **lands acked-durable** — the append reached the leader and the
  acks=all watermark passed it (so it is fsynced on every follower and
  therefore on any promotable candidate), or
- it **raises retryably** — :class:`LeaderChangedError`
  (``retryable=True``): the caller re-sends and the new attempt resolves
  the new leader. Nothing is ever silently dropped: an append the old
  leader took but never acked simply never fires its delivery report, so
  the runtime marks it FAILED (resend path), never DELIVERED.

Reads (fetch / offsets / waits) are side-effect-free, so a read that
fails on a dead leader is retried ONCE internally after re-resolving —
consumers ride through a failover without surfacing an error. Writes are
never auto-retried (a blind append retry could duplicate a record the
dying leader actually took); the retryable error is the caller's signal.

``open_broker(node_id, info)`` turns a cluster-map entry into a live
Broker. Two stock openers:

- in-process clusters (tests, the chip check): a dict lookup of
  ``HANode.broker_facade``;
- cross-process deployments: :func:`data_plane_opener` dials the
  leader's :class:`~swarmdb_tpu_torch.ha.dataplane.DataPlaneServer`, so every
  client op executes inside the node process against the same acks=all +
  fencing facade the embedded runtime uses. (Opening a second broker
  engine over the leader's log dir does NOT work: engine handles
  snapshot at open, and such writes would bypass replication — exactly
  the loss the HA layer exists to prevent.)

Partition-level routing: when the cluster map carries an
``assignments`` table, every partition-scoped operation (append, fetch,
offsets, waits, consumer-group commits) routes to THAT partition's
leader — one open broker handle per node, cached — while admin ops
(topic create/list, partition scaling, retention trims) keep going to
the node-level leader (the controller). A partition whose assignment
points at a deregistered node is LEADERLESS mid-failover: writes to it
raise the same retryable :class:`LeaderChangedError` (the orphan sweep
re-seats it within the detector budget), while every other partition's
writes keep flowing to their own leaders — that is the bounded blast
radius, client-side.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..broker.base import (Broker, BrokerError, FencedError,
                           LeaderChangedError, Record, TopicMeta,
                           UnknownTopicError)
from ..obs import TRACER, propagate
from .cluster import ClusterMap
from ..utils.sync import make_rlock

logger = logging.getLogger("swarmdb_tpu_torch.ha")

__all__ = ["ClusterBroker", "data_plane_opener"]

#: exceptions that mean "this leader handle is stale", not "bad request"
_TRANSIENT = (FencedError, ConnectionError, OSError)


def data_plane_opener(timeout_s: float = 5.0
                      ) -> Callable[[str, Dict[str, Any]], Broker]:
    """Opener for cross-process clusters: a RemoteBroker dialing the
    leader's registered data-plane address."""
    def _open(node_id: str, info: Dict[str, Any]) -> Broker:
        data_addr = info.get("data_addr")
        if not data_addr:
            raise LeaderChangedError(
                f"leader {node_id} registered no data_addr to re-point to "
                "(is its node running with the data plane disabled?)")
        from .dataplane import RemoteBroker

        return RemoteBroker(data_addr, timeout_s=timeout_s)

    return _open


class ClusterBroker(Broker):
    def __init__(self, cluster: ClusterMap,
                 open_broker: Callable[[str, Dict[str, Any]], Broker], *,
                 refresh_s: float = 0.25, owns_inner: bool = True) -> None:
        self.cluster = cluster
        self._open = open_broker
        self.refresh_s = refresh_s
        # owns_inner=False for in-process clusters where the inner broker
        # belongs to an HANode (closing it would kill the node)
        self._owns_inner = owns_inner
        self._lock = make_rlock("ha.client.ClusterBroker._lock")
        # swarmlint: guarded-by[self._lock]: _inner, _leader_id, _leader_epoch, _next_check, _assignments, _nodes, _opened
        self._inner: Optional[Broker] = None
        self._leader_id: Optional[str] = None
        self._leader_epoch = -1
        self._next_check = 0.0
        # partition-level routing state (refreshed with the map snapshot)
        self._assignments: Dict[str, Dict[str, Any]] = {}
        self._nodes: Dict[str, Dict[str, Any]] = {}
        # node_id -> (info-fingerprint, open broker); re-opened when a
        # node re-registers with fresh addresses
        self._opened: Dict[str, Tuple[str, Broker]] = {}

    # ------------------------------------------------------------ resolution

    def leader(self) -> Optional[Tuple[str, int]]:
        """(node_id, epoch) currently bound, or None."""
        with self._lock:
            if self._leader_id is None:
                return None
            return self._leader_id, self._leader_epoch

    def _invalidate(self) -> None:
        with self._lock:
            self._next_check = 0.0

    def _current(self) -> Broker:
        with self._lock:
            now = time.monotonic()
            if self._inner is not None and now < self._next_check:
                return self._inner
            self._next_check = now + self.refresh_s
            state = self.cluster.read()
            # partition-routing view rides the same snapshot cadence
            self._assignments = state.get("assignments", {}) or {}
            self._nodes = state.get("nodes", {}) or {}
            leader = state.get("leader")
            epoch = state.get("epoch", 0)
            if leader is None:
                if self._inner is not None:
                    return self._inner  # pre-HA map: keep what we have
                raise LeaderChangedError("cluster map has no leader yet")
            if (leader == self._leader_id and epoch == self._leader_epoch
                    and self._inner is not None):
                return self._inner
            info = state.get("nodes", {}).get(leader)
            if info is None:
                raise LeaderChangedError(
                    f"leader {leader} is not registered in the cluster map")
            old = self._inner
            self._inner = self._open(leader, info)
            prev_leader = self._leader_id
            self._leader_id, self._leader_epoch = leader, epoch
            logger.info("cluster broker: re-pointed to leader %s "
                        "(epoch %d)", leader, epoch)
            # the re-point is a trace event: carried under the active
            # trace context (if a send is in flight) so a failover shows
            # up INSIDE the affected request's merged timeline
            ctx = propagate.current()
            TRACER.instant(
                "cluster.repoint", cat="ha",
                rid=ctx.trace_id if ctx else None,
                args={"leader": leader, "epoch": epoch,
                      "previous": prev_leader})
            if old is not None and self._owns_inner:
                try:
                    old.close()
                except Exception:
                    pass
            return self._inner

    # ------------------------------------------------- partition resolution

    def _for_partition(self, topic: str, partition: int) -> Broker:
        """The broker to run a partition-scoped op against: the
        partition's assigned leader when the map has one, else the
        node-level leader (controller) — which is exactly the node-level
        behavior for maps without assignments."""
        with self._lock:
            controller = self._current()  # refreshes the snapshot too
            a = self._assignments.get(f"{topic}:{int(partition)}")
            if a is None:
                return controller
            nid = a.get("leader")
            if nid == self._leader_id:
                return controller
            info = self._nodes.get(nid)
            if info is None:
                raise LeaderChangedError(
                    f"partition {topic}[{partition}] is leaderless "
                    f"(assigned to deregistered node {nid}); failover in "
                    "progress — retry resolves the new leader")
            fp = json.dumps(info, sort_keys=True)
            cached = self._opened.get(nid)
            if cached is not None and cached[0] == fp:
                return cached[1]
            if cached is not None and self._owns_inner:
                try:
                    cached[1].close()
                except Exception:
                    pass
            broker = self._open(nid, info)
            self._opened[nid] = (fp, broker)
            return broker

    def _drop_partition_handle(self, topic: str, partition: int) -> None:
        """A partition op failed transiently: forget the (possibly dead)
        node handle so the next attempt re-opens, and force a snapshot
        refresh."""
        with self._lock:
            a = self._assignments.get(f"{topic}:{int(partition)}")
            nid = a.get("leader") if a else None
            cached = self._opened.pop(nid, None) if nid else None
            self._next_check = 0.0
        if cached is not None and self._owns_inner:
            try:
                cached[1].close()
            except Exception:
                pass

    def _read_tp(self, topic: str, partition: int,
                 op: Callable[[Broker], Any]) -> Any:
        """Partition-scoped side-effect-free op: one transparent retry
        after re-resolving, like :meth:`_read`."""
        try:
            return op(self._for_partition(topic, partition))
        except UnknownTopicError:
            raise
        except LeaderChangedError:
            self._drop_partition_handle(topic, partition)
        except (_TRANSIENT + (BrokerError,)):
            self._drop_partition_handle(topic, partition)
        try:
            return op(self._for_partition(topic, partition))
        except UnknownTopicError:
            raise
        except (_TRANSIENT + (BrokerError,)) as exc:
            raise LeaderChangedError(
                f"read on {topic}[{partition}] failed across a leader "
                f"re-resolve ({exc}); failover may still be in progress"
            ) from exc

    def _write_tp(self, topic: str, partition: int,
                  op: Callable[[Broker], Any], what: str) -> Any:
        """Partition-scoped mutating op: NEVER auto-retried — a stale-
        leader failure becomes the retryable error, scoped to THIS
        partition (every other partition keeps writing through its own
        leader: the client half of the bounded blast radius)."""
        try:
            return op(self._for_partition(topic, partition))
        except UnknownTopicError:
            raise
        except (_TRANSIENT + (BrokerError,)) as exc:
            self._drop_partition_handle(topic, partition)
            ctx = propagate.current()
            TRACER.instant(
                "cluster.failover", cat="ha",
                rid=ctx.trace_id if ctx else None,
                args={"op": what, "partition": f"{topic}:{partition}",
                      "error": type(exc).__name__})
            raise LeaderChangedError(
                f"{what} failed: partition leader unreachable or deposed "
                f"({exc}); retry resolves the new leader") from exc

    # ------------------------------------------------------------ delegation

    def _read(self, op: Callable[[Broker], Any]) -> Any:
        """Side-effect-free op: one transparent retry after re-resolving
        (consumers ride through a failover without an error surfacing)."""
        try:
            return op(self._current())
        except UnknownTopicError:
            raise
        except (_TRANSIENT + (BrokerError,)):
            self._invalidate()
        try:
            return op(self._current())
        except UnknownTopicError:
            raise
        except (_TRANSIENT + (BrokerError,)) as exc:
            raise LeaderChangedError(
                f"read failed across a leader re-resolve ({exc}); "
                "failover may still be in progress") from exc

    def _write(self, op: Callable[[Broker], Any], what: str) -> Any:
        """Mutating op: NEVER auto-retried — convert a stale-leader
        failure into the retryable error the caller acts on."""
        try:
            return op(self._current())
        except UnknownTopicError:
            raise
        except (_TRANSIENT + (BrokerError,)) as exc:
            bound = self.leader()
            self._invalidate()
            ctx = propagate.current()
            TRACER.instant(
                "cluster.failover", cat="ha",
                rid=ctx.trace_id if ctx else None,
                args={"op": what,
                      "leader": bound[0] if bound else None,
                      "error": type(exc).__name__})
            raise LeaderChangedError(
                f"{what} failed: leader "
                f"{bound[0] if bound else '?'} unreachable or deposed "
                f"({exc}); retry resolves the new leader") from exc

    # -- admin ----------------------------------------------------------------

    def create_topic(self, name: str, num_partitions: int,
                     retention_ms: int = 7 * 24 * 3600 * 1000) -> bool:
        return self._write(
            lambda b: b.create_topic(name, num_partitions,
                                     retention_ms=retention_ms),
            f"create_topic({name})")

    def list_topics(self) -> Dict[str, TopicMeta]:
        return self._read(lambda b: b.list_topics())

    def create_partitions(self, name: str, new_total: int) -> None:
        return self._write(
            lambda b: b.create_partitions(name, new_total),
            f"create_partitions({name})")

    # -- data plane -----------------------------------------------------------

    def append(self, topic: str, partition: int, value: bytes,
               key: Optional[bytes] = None,
               timestamp: Optional[float] = None) -> int:
        return self._write_tp(
            topic, partition,
            lambda b: b.append(topic, partition, value, key=key,
                               timestamp=timestamp),
            f"append({topic}[{partition}])")

    def fetch(self, topic: str, partition: int, offset: int,
              max_records: int = 256) -> List[Record]:
        return self._read_tp(
            topic, partition,
            lambda b: b.fetch(topic, partition, offset, max_records))

    def end_offset(self, topic: str, partition: int) -> int:
        return self._read_tp(topic, partition,
                             lambda b: b.end_offset(topic, partition))

    def begin_offset(self, topic: str, partition: int) -> int:
        return self._read_tp(topic, partition,
                             lambda b: b.begin_offset(topic, partition))

    def wait_for_data(self, topic: str, partition: int, offset: int,
                      timeout_s: float) -> bool:
        try:
            return self._read_tp(
                topic, partition,
                lambda b: b.wait_for_data(topic, partition, offset,
                                          timeout_s))
        except LeaderChangedError:
            return False  # poll loops treat timeout and failover alike

    # -- consumer-group offsets ----------------------------------------------

    def commit_offset(self, group: str, topic: str, partition: int,
                      offset: int) -> None:
        return self._write_tp(
            topic, partition,
            lambda b: b.commit_offset(group, topic, partition, offset),
            f"commit_offset({group})")

    def committed_offset(self, group: str, topic: str,
                         partition: int) -> Optional[int]:
        return self._read_tp(
            topic, partition,
            lambda b: b.committed_offset(group, topic, partition))

    # -- retention / durability ----------------------------------------------

    def trim_older_than(self, topic: str, cutoff_ts: float) -> int:
        # topic-wide: the controller applies it and X-frames every peer
        return self._write(
            lambda b: b.trim_older_than(topic, cutoff_ts),
            f"trim_older_than({topic})")

    def durable_offset(self, topic: str, partition: int) -> int:
        return self._read_tp(topic, partition,
                             lambda b: b.durable_offset(topic, partition))

    def wait_durable(self, topic: str, partition: int, offset: int,
                     timeout_s: float) -> bool:
        try:
            return self._read_tp(
                topic, partition,
                lambda b: b.wait_durable(topic, partition, offset,
                                         timeout_s))
        except LeaderChangedError:
            return False

    def flush(self) -> None:
        try:
            self._read(lambda b: b.flush())
        except LeaderChangedError:
            pass  # a failover mid-flush: the new leader is durable already

    def close(self) -> None:
        with self._lock:
            inner, self._inner = self._inner, None
            opened, self._opened = list(self._opened.values()), {}
        if self._owns_inner:
            for handle in ([inner] if inner is not None else []) + [
                    b for _, b in opened]:
                try:
                    handle.close()
                except Exception:
                    pass

    def healthy(self) -> bool:
        try:
            return self._read(lambda b: b.healthy())
        except Exception:
            return False
