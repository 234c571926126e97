"""LeadershipIndex: incrementally-maintained leadership views.

Without it, the spread/shed/orphan-sweep policies each re-derive their working
sets — leaderships per node, orphaned partitions, a node's own
assignments — by scanning the cluster map's FULL assignment table on
every decision. At 6 partitions that was free; at the hundreds of
partitions the scaled drills run (and with a watch tick every
``suspect_s/2`` on every node of a 5-9 node cluster), the O(partitions)
scans per tick per node dominate the control plane's CPU and stretch
rebalance convergence.

This module keeps those views INCREMENTAL. The index consumes
:meth:`~swarmdb_tpu_torch.ha.cluster.ClusterMap.read_changes` deltas (O(1)
when nothing moved, O(changed) otherwise; full resync only at start or
after a journal overflow) and maintains:

- ``entries``    — key -> {"leader", "epoch"} (the assignment table);
- ``by_node``    — node -> set of keys it is assigned (dead or alive);
- ``orphans``    — keys whose assigned leader is not registered (the
  orphan sweep's whole worklist, updated in O(victim's partitions) when
  a node deregisters instead of rescanned per pass);
- leadership counts, the node table, and the node-level leader/epoch.

Listeners registered with :meth:`add_listener` receive every applied
assignment change ``(key, entry_or_None)`` exactly once, regardless of
which thread's sync applied it — the HA node uses this for per-key
lease/fencing reconciliation, and the serving tier's conversation
locality re-pins off the same stream (``ha.repin``).

``work_units`` counts assignment entries VISITED by apply/decision
helpers; the regression test pins a single leadership move to O(moved)
work on a hundreds-of-partitions index.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..utils.sync import make_lock

logger = logging.getLogger("swarmdb_tpu_torch.ha")

__all__ = ["LeadershipIndex", "IndexSync"]


class IndexSync:
    """What one :meth:`LeadershipIndex.sync` observed."""

    __slots__ = ("changed", "full", "version")

    def __init__(self, changed: bool, full: bool, version: int) -> None:
        self.changed = changed  # anything applied by THIS call
        self.full = full        # this call applied a full resync
        self.version = version


class LeadershipIndex:
    """Thread-safe; one instance per observer (node, bench harness).

    Queries return copies of small views (nodes, counts, one node's key
    set, the orphan list) — never the whole assignment table.
    """

    def __init__(self) -> None:
        self._lock = make_lock("ha.lindex.LeadershipIndex._lock")
        # swarmlint: guarded-by[self._lock]: _entries, _by_node, _orphans, _nodes, _leader, _epoch, version, work_units
        self.version = -1
        self._entries: Dict[str, Dict[str, Any]] = {}
        self._by_node: Dict[str, Set[str]] = {}
        self._orphans: Set[str] = set()
        self._nodes: Dict[str, Dict[str, Any]] = {}
        self._leader: Optional[str] = None
        self._epoch = 0
        #: assignment entries visited by apply/decision work (test hook)
        self.work_units = 0
        self._listeners: List[Callable[[str, Optional[Dict[str, Any]]],
                                       None]] = []

    # -------------------------------------------------------------- sync

    def add_listener(self, cb: Callable[[str, Optional[Dict[str, Any]]],
                                        None]) -> None:
        """``cb(key, entry_or_None)`` fires (outside the index lock) for
        every applied assignment change; on a full resync it fires for
        every key, so a listener's derived state is rebuilt too."""
        self._listeners.append(cb)

    def sync(self, cluster: Any) -> IndexSync:
        """Pull and apply whatever moved since our version. Exceptions
        from the map propagate (callers already treat map reads as
        fallible). Listener callbacks run after the lock is released, on
        the syncing thread."""
        notify: List[Tuple[str, Optional[Dict[str, Any]]]] = []
        with self._lock:
            reader = getattr(cluster, "read_changes", None)
            if reader is None:
                # maps without a journal: every sync is a full resync
                delta = {"version": self.version + 1, "changed": True,
                         "full": True, "state": cluster.read()}
            else:
                delta = reader(self.version)
            if not delta.get("changed"):
                self.version = int(delta.get("version", self.version))
                return IndexSync(False, False, self.version)
            if delta.get("full"):
                notify = self._apply_full(delta["state"])
            else:
                notify = self._apply_delta(delta)
            self.version = ver = int(delta.get("version", self.version))
            full = bool(delta.get("full"))
        for key, entry in notify:
            for cb in self._listeners:
                try:
                    cb(key, entry)
                except Exception:
                    logger.exception("leadership-index listener failed "
                                     "for %s", key)
        return IndexSync(True, full, ver)

    # swarmlint: holds[self._lock]
    def _apply_full(self, state: Dict[str, Any]
                    ) -> List[Tuple[str, Optional[Dict[str, Any]]]]:
        old_keys = set(self._entries)
        self._entries = {}
        self._by_node = {}
        self._orphans = set()
        self._nodes = dict(state.get("nodes", {}))
        self._leader = state.get("leader")
        self._epoch = int(state.get("epoch", 0))
        notify: List[Tuple[str, Optional[Dict[str, Any]]]] = []
        for key, a in state.get("assignments", {}).items():
            self._apply_entry(key, a)
            notify.append((key, dict(a)))
        for key in old_keys - set(self._entries):
            notify.append((key, None))
        return notify

    # swarmlint: holds[self._lock]
    def _apply_delta(self, delta: Dict[str, Any]
                     ) -> List[Tuple[str, Optional[Dict[str, Any]]]]:
        self._leader = delta.get("leader")
        self._epoch = int(delta.get("epoch", 0))
        new_nodes = dict(delta.get("nodes", {}))
        # node-set churn: orphan bookkeeping in O(changed nodes' keys)
        for nid in set(self._nodes) - set(new_nodes):
            self._orphans |= self._by_node.get(nid, set())
        for nid in set(new_nodes) - set(self._nodes):
            self._orphans -= self._by_node.get(nid, set())
        self._nodes = new_nodes
        notify: List[Tuple[str, Optional[Dict[str, Any]]]] = []
        for key, a in delta.get("assignments", {}).items():
            self._apply_entry(key, a)
            notify.append((key, dict(a)))
        for key in delta.get("removed", ()):
            old = self._entries.pop(key, None)
            if old is not None:
                self.work_units += 1
                self._by_node.get(old.get("leader"), set()).discard(key)
                self._orphans.discard(key)
                notify.append((key, None))
        return notify

    # swarmlint: holds[self._lock]
    def _apply_entry(self, key: str, a: Dict[str, Any]) -> None:
        self.work_units += 1
        old = self._entries.get(key)
        if old is not None and old.get("leader") != a.get("leader"):
            self._by_node.get(old["leader"], set()).discard(key)
        self._entries[key] = {"leader": a.get("leader"),
                              "epoch": int(a.get("epoch", 0))}
        leader = a.get("leader")
        self._by_node.setdefault(leader, set()).add(key)
        if leader in self._nodes:
            self._orphans.discard(key)
        else:
            self._orphans.add(key)

    # ----------------------------------------------------------- queries

    def entry(self, key: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            a = self._entries.get(key)
            return dict(a) if a is not None else None

    def leader_of(self, key: str) -> Optional[str]:
        with self._lock:
            a = self._entries.get(key)
            return a.get("leader") if a is not None else None

    def keys_led_by(self, node_id: str) -> Set[str]:
        with self._lock:
            return set(self._by_node.get(node_id, ()))

    def leadership_counts(self) -> Dict[str, int]:
        """Leaderships per REGISTERED node (the spread/shed view):
        O(cluster size), never O(partitions)."""
        with self._lock:
            return {nid: len(self._by_node.get(nid, ()))
                    for nid in self._nodes}

    def orphans(self) -> List[Tuple[str, Dict[str, Any]]]:
        with self._lock:
            return [(k, dict(self._entries[k]))
                    for k in sorted(self._orphans) if k in self._entries]

    def orphan_count(self) -> int:
        with self._lock:
            return len(self._orphans)

    def assignment_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def nodes(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {nid: dict(info or {})
                    for nid, info in self._nodes.items()}

    def node_info(self, node_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            info = self._nodes.get(node_id)
            return dict(info) if info is not None else None

    def has_node(self, node_id: str) -> bool:
        with self._lock:
            return node_id in self._nodes

    def leader(self) -> Optional[str]:
        with self._lock:
            return self._leader

    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def reset_work_counter(self) -> int:
        """Return-and-zero the work counter (test hook)."""
        with self._lock:
            n, self.work_units = self.work_units, 0
            return n
