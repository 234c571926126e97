"""Conversation locality: pin serving to partition leadership.

Without it, a conversation's turns go to one admission lane by a bare
stable hash of the agent pair — good for prefix reuse, blind to WHO owns
the conversation's log, while partition leadership gives every
``(topic, partition)`` its own leader. This module makes the two coincide, the convergence "Software-
Defined Agentic Serving" argues for: the node that leads a
conversation's log partition also serves its compute — reads, writes,
prefill, and decode land together, and a node death scopes the serving
blast radius to the conversations that node OWNED.

:class:`ConversationLocality` derives a :class:`~swarmdb_tpu_torch.backend
.engine.GenRequest` ``shard_hint`` from the conversation's partition
leadership instead of the bare pair hash:

- the conversation's log partition is the served agent's partition
  (``stable_partition(receiver_id, num_partitions)`` — the partition the
  runtime produces its messages to and its consumer drains);
- the partition's CURRENT leader comes from a leadership lookup (the
  HA node's incrementally-synced index, or a bench-side
  :class:`~swarmdb_tpu_torch.ha.lindex.LeadershipIndex`);
- the lane pin hashes ``(partition, leader)`` — stable while leadership
  is stable, and DETERMINISTICALLY re-pinned the moment leadership moves
  (drain handover, failover promotion): every observer computes the same
  new lane, so a conversation's turns keep landing together and its
  anchor-head/prefix pages re-register on the new lane at the next turn.

Leadership moves arrive through :meth:`on_rebalance` (subscribe it via
``HANode.add_rebalance_listener``); each affected conversation's re-pin
emits an ``ha.repin`` flight instant + tracer event so the analyzer can
attribute a TTFT spike to leadership churn, and the local/remote split
feeds the ``swarmdb_conversation_locality`` gauges.

Deployments without partition leadership never construct this class —
the serving layer keeps the pair-hash hint, bit-identical.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Set, Tuple

from ..obs import TRACER
from ..utils.hashing import stable_partition
from ..utils.sync import make_lock

logger = logging.getLogger("swarmdb_tpu_torch.serving")

__all__ = ["ConversationPin", "ConversationLocality"]


@dataclass
class ConversationPin:
    """Where one conversation lives right now."""

    partition: int            # its log partition (receiver hash)
    leader: Optional[str]     # that partition's current leader (None =
                              # leaderless mid-failover / no assignment)
    epoch: int                # the assignment's fencing epoch
    lane: int                 # derived admission-lane pin (shard_hint)
    local: Optional[bool]     # leader == this node (None when unknown)


class ConversationLocality:
    """Tracks conversation -> (partition, leader, lane) pins.

    ``leadership(key)`` maps an assignment key (``"topic:part"``) to
    ``{"leader", "epoch"}`` or None — O(1) against an incrementally-
    synced index. ``num_partitions`` is a callable so partition growth
    (auto-scale) is picked up without re-wiring.
    """

    def __init__(self, *, topic: str, n_lanes: int,
                 leadership: Callable[[str], Optional[Dict[str, Any]]],
                 num_partitions: Callable[[], int],
                 local_node: Optional[str] = None,
                 metrics: Any = None, flight: Any = None,
                 cap: int = 8192) -> None:
        self.topic = topic
        self.n_lanes = max(1, int(n_lanes))
        self._leadership = leadership
        self._num_partitions = num_partitions
        self.local_node = local_node
        self.metrics = metrics
        self.flight = flight
        self._cap = max(16, int(cap))
        self._lock = make_lock(
            "backend.locality.ConversationLocality._lock")
        # swarmlint: guarded-by[self._lock]: _pins, _by_partition, _repins
        # insertion order = LRU order for the size cap (anchor-dict idiom)
        self._pins: Dict[Tuple[str, str], ConversationPin] = {}
        self._by_partition: Dict[int, Set[Tuple[str, str]]] = {}
        self._repins = 0

    # -------------------------------------------------------------- pinning

    @staticmethod
    def _pair(a: str, b: str) -> Tuple[str, str]:
        return (a, b) if a <= b else (b, a)

    def _lane_for(self, partition: int, leader: Optional[str]) -> int:
        """Deterministic lane derivation: stable while leadership is
        stable, re-pinned (same answer on every observer) when the
        leader changes. Leaderless partitions keep a partition-stable
        lane so a mid-failover turn still lands with its siblings."""
        if leader is None:
            return stable_partition(f"p{partition}", self.n_lanes)
        return stable_partition(f"{partition}@{leader}", self.n_lanes)

    def _compute(self, partition: int) -> ConversationPin:
        entry = None
        try:
            entry = self._leadership(f"{self.topic}:{partition}")
        except Exception:
            logger.exception("leadership lookup failed for %s:%d",
                             self.topic, partition)
        leader = entry.get("leader") if entry else None
        epoch = int(entry.get("epoch", 0)) if entry else 0
        return ConversationPin(
            partition=partition, leader=leader, epoch=epoch,
            lane=self._lane_for(partition, leader),
            local=(leader == self.local_node
                   if leader is not None and self.local_node is not None
                   else None))

    def pin(self, sender_id: str, receiver_id: str) -> ConversationPin:
        """Current pin for one conversation (registered for re-pin
        tracking). The partition is the RECEIVER's — the served agent's
        log partition, where the runtime produces this conversation's
        messages and its consumer drains them."""
        try:
            nparts = max(1, int(self._num_partitions()))
        except Exception:
            nparts = 1
        part = stable_partition(receiver_id, nparts)
        pin = self._compute(part)
        key = self._pair(sender_id, receiver_id)
        with self._lock:
            old = self._pins.pop(key, None)
            if old is not None and old.partition != part:
                self._by_partition.get(old.partition, set()).discard(key)
            while len(self._pins) >= self._cap:
                # size-capped dict, insertion order = LRU order (the
                # anchor-dict idiom); the pop above is the LRU touch
                oldest = next(iter(self._pins))
                epin = self._pins.pop(oldest)
                self._by_partition.get(epin.partition, set()).discard(
                    oldest)
            self._pins[key] = pin
            self._by_partition.setdefault(part, set()).add(key)
        return pin

    def forget(self, sender_id: str, receiver_id: str) -> None:
        key = self._pair(sender_id, receiver_id)
        with self._lock:
            pin = self._pins.pop(key, None)
            if pin is not None:
                self._by_partition.get(pin.partition, set()).discard(key)

    # --------------------------------------------------------- rebalancing

    def on_rebalance(self, key: str,
                     entry: Optional[Dict[str, Any]]) -> None:
        """Leadership-move subscriber (``HANode.add_rebalance_listener``
        / bench harness): deterministically re-pin every registered
        conversation on the moved partition. Idempotent — duplicate
        observations of the same move are no-ops."""
        topic, _, part_s = key.rpartition(":")
        if topic != self.topic:
            return
        try:
            partition = int(part_s)
        except ValueError:
            return
        leader = entry.get("leader") if entry else None
        epoch = int(entry.get("epoch", 0)) if entry else 0
        new_lane = self._lane_for(partition, leader)
        moved = []
        with self._lock:
            for pair in list(self._by_partition.get(partition, ())):
                old = self._pins.get(pair)
                if old is None or (old.leader == leader
                                   and old.epoch == epoch):
                    continue
                pin = ConversationPin(
                    partition=partition, leader=leader, epoch=epoch,
                    lane=new_lane,
                    local=(leader == self.local_node
                           if leader is not None
                           and self.local_node is not None else None))
                self._pins[pair] = pin
                moved.append((pair, old))
            self._repins += len(moved)
        if not moved:
            return
        if self.metrics is not None:
            self.metrics.counters["conversation_repins"].inc(len(moved))
        for pair, old in moved:
            # the re-pin instant is what lets the analyzer attribute a
            # TTFT spike to leadership churn: it names the conversation,
            # the partition, both leaders, and both lanes
            args = {"partition": f"{self.topic}:{partition}",
                    "conversation": "|".join(pair),
                    "from_leader": old.leader, "to_leader": leader,
                    "from_lane": old.lane, "to_lane": new_lane,
                    "epoch": epoch}
            TRACER.instant("ha.repin", cat="ha", args=args)
            if self.flight is not None:
                try:
                    self.flight.record_event(
                        {"t": time.time(), "kind": "ha.repin", **args})
                except Exception:
                    pass
        logger.info("locality: re-pinned %d conversation(s) on %s:%d -> "
                    "leader %s lane %d", len(moved), self.topic,
                    partition, leader, new_lane)

    # --------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        """The /admin/ha ``partition_serving`` block + the
        ``swarmdb_conversation_locality`` gauge inputs."""
        with self._lock:
            pins = list(self._pins.values())
            repins = self._repins
        by_leader: Dict[str, int] = {}
        local = remote = leaderless = 0
        for p in pins:
            if p.leader is None:
                leaderless += 1
            else:
                by_leader[p.leader] = by_leader.get(p.leader, 0) + 1
                if p.local is True:
                    local += 1
                elif p.local is False:
                    remote += 1
        return {
            "conversations": len(pins),
            "by_leader": dict(sorted(by_leader.items())),
            "leaderless": leaderless,
            "local": local,
            "remote": remote,
            "repins": repins,
            "n_lanes": self.n_lanes,
            "local_node": self.local_node,
        }
