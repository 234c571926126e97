"""Cluster map: the HA control plane's tiny source of truth.

One record answers "who is the leader, at what fencing epoch, and where
does everyone live". Promotion is a compare-and-swap on the epoch —
``try_promote(node, new_epoch)`` succeeds for exactly one caller per
epoch, which is what makes a partition flap produce ONE new leader
instead of a dueling pair. Two implementations:

- :class:`InMemoryClusterMap` — single-process clusters (tests, the
  chip check, embedded deployments).
- :class:`FileClusterMap` — a JSON file on shared storage (the compose
  stack's shared volume), CAS'd under an ``fcntl`` lock. This plays the
  role etcd/ZooKeeper would in a multi-rack deployment; the interface is
  deliberately small enough to re-implement over either.

A node that cannot reach the cluster map cannot promote itself — that is
the quorum-ish guard: an isolated follower believing everyone else dead
still has no way to win an epoch.

Fencing epochs are ALSO persisted in each broker's own segment log
(:func:`~swarmdb_tpu_torch.broker.replica.persist_epoch`), so a restarted node
remembers its last epoch even if the map is lost.

Partition-level leadership: alongside the node-level leader
(which remains the CONTROLLER — admin ops, assignment authority), the
map carries an epoch-versioned ``assignments`` table mapping
``"topic:partition" -> {"leader": node_id, "epoch": int}``. Each
partition's fencing epoch is an INDEPENDENT CAS space:
:meth:`ClusterMap.try_promote_partition` checks only THAT assignment's
epoch, so two coordinators promoting different partitions never
serialize on (or clobber) each other's epoch bumps — the
:class:`FileClusterMap` implementation does the whole read-modify-write
of the shared JSON under one ``fcntl`` lock precisely so a concurrent
CAS on partition A can never store a state that has forgotten partition
B's fresh bump (the stale-read window a load-outside-the-lock
implementation would have).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Optional

from ..broker.replica import read_log_epoch, persist_epoch  # noqa: F401  (re-export)
from ..utils.sync import make_lock

__all__ = ["NodeInfo", "ClusterMap", "InMemoryClusterMap", "FileClusterMap",
           "read_log_epoch", "persist_epoch", "tp_key", "parse_tp_key"]


def tp_key(topic: str, partition: int) -> str:
    """Assignment-table key for one partition; the partition is always
    the LAST ``:``-segment, so :func:`parse_tp_key` round-trips even for
    topic names that themselves contain ``:``."""
    return f"{topic}:{int(partition)}"


def parse_tp_key(key: str) -> "tuple[str, int]":
    topic, _, part = key.rpartition(":")
    return topic, int(part)


@dataclass
class NodeInfo:
    """One node's addresses as the rest of the cluster should dial them."""

    node_id: str
    replica_addr: str = ""    # host:port of the mirror listener (follower)
    liveness_addr: str = ""   # host:port of the out-of-band liveness probe
    data_addr: str = ""       # host:port of the client data plane
    log_dir: str = ""         # segment-log dir (re-seed source)
    meta: Dict[str, Any] = field(default_factory=dict)


#: retained mutation-journal entries (see ``read_changes``). Sized to
#: cover an entire assignment wave of a few-hundred-partition topic plus
#: failover churn; an observer further behind than this resyncs in full.
CHANGELOG_CAP = 2048


def _empty_state() -> Dict[str, Any]:
    return {"epoch": 0, "leader": None, "nodes": {}, "assignments": {},
            "version": 0, "changes": []}


def _bump(state: Dict[str, Any], kind: str, key: str) -> None:
    """Journal one mutation: monotonically bump ``version`` and append
    ``[version, kind, key]`` (kind: "a"=assignment, "n"=node,
    "l"=leader/epoch). Every mutation journals exactly one entry, so the
    retained tail is always a CONSECUTIVE version range — which is what
    lets ``read_changes`` decide coverage with one comparison."""
    state["version"] = int(state.get("version", 0)) + 1
    changes = state.setdefault("changes", [])
    changes.append([state["version"], kind, key])
    if len(changes) > CHANGELOG_CAP:
        del changes[: len(changes) - CHANGELOG_CAP]


def _delta_since(state: Dict[str, Any], since_version: int) -> Dict[str, Any]:
    """Shared ``read_changes`` arithmetic over a state dict the caller
    holds exclusively. Three shapes:

    - ``{"version": v, "changed": False}`` — nothing moved (the common
      watch tick; O(1) for the caller).
    - ``{"version", "changed": True, "full": False, "leader", "epoch",
      "nodes", "assignments": {key: entry}, "removed": [key, ...]}`` —
      the journal covers the gap: only assignments whose keys appear in
      it are shipped (nodes/leader are O(cluster) and always included).
    - ``{"version", "changed": True, "full": True, "state": <snapshot>}``
      — the observer is too far behind (journal trimmed past it, or a
      pre-journal legacy state): full resync.
    """
    v = int(state.get("version", 0))
    if since_version >= v:
        return {"version": v, "changed": False}
    changes = state.get("changes") or []
    # consecutive-version property: covered iff the oldest retained entry
    # is no newer than the first mutation the observer missed
    covered = bool(changes) and changes[0][0] <= since_version + 1
    if since_version < 0 or not covered:
        snap = {k: val for k, val in state.items() if k != "changes"}
        return {"version": v, "changed": True, "full": True, "state": snap}
    changed_keys = {key for ver, kind, key in changes
                    if ver > since_version and kind == "a"}
    assigns = state.get("assignments", {})
    return {
        "version": v, "changed": True, "full": False,
        "leader": state.get("leader"),
        "epoch": int(state.get("epoch", 0)),
        "nodes": state.get("nodes", {}),
        "assignments": {k: assigns[k] for k in changed_keys if k in assigns},
        "removed": sorted(k for k in changed_keys if k not in assigns),
    }


def _promote_partition(state: Dict[str, Any], topic: str, partition: int,
                       node_id: str, new_epoch: int,
                       expect_epoch: Optional[int]) -> bool:
    """Shared per-partition CAS arithmetic, applied to a state dict the
    caller holds exclusively (both map impls run it inside their lock).
    The epoch space is the ASSIGNMENT's, not the node-level one: a CAS
    on partition A neither reads nor writes partition B's epoch."""
    key = tp_key(topic, partition)
    a = state["assignments"].get(key, {"leader": None, "epoch": 0})
    cur = int(a.get("epoch", 0))
    if new_epoch <= cur:
        return False
    if expect_epoch is not None and cur != expect_epoch:
        return False
    state["assignments"][key] = {"leader": node_id, "epoch": int(new_epoch)}
    return True


class ClusterMap:
    """Interface; see module docstring. All methods are thread-safe."""

    def read(self) -> Dict[str, Any]:
        """Snapshot: ``{"epoch": int, "leader": node_id|None,
        "nodes": {node_id: NodeInfo-dict},
        "assignments": {"topic:part": {"leader": node_id, "epoch": int}}}``."""
        raise NotImplementedError

    def register(self, info: NodeInfo) -> None:
        """Upsert a node's addresses (does not change leadership)."""
        raise NotImplementedError

    def deregister(self, node_id: str) -> None:
        raise NotImplementedError

    def try_promote(self, node_id: str, new_epoch: int,
                    expect_epoch: Optional[int] = None) -> bool:
        """CAS: become leader at ``new_epoch`` iff it exceeds the current
        epoch. Exactly one caller per epoch can win. ``expect_epoch``
        tightens it to a true compare-and-swap: the promotion also fails
        if the map's epoch is no longer the one the candidate ranked its
        peers at — a coordinator whose probe round straddled someone
        else's win must lose, not seat a second leader over the fresh
        one (its own ``current_epoch()`` may have already absorbed the
        winner's epoch, so "higher wins" alone is not enough)."""
        raise NotImplementedError

    def try_promote_partition(self, topic: str, partition: int,
                              node_id: str, new_epoch: int,
                              expect_epoch: Optional[int] = None) -> bool:
        """Per-partition CAS: seat ``node_id`` as the leader
        of ``(topic, partition)`` at ``new_epoch`` iff it exceeds that
        ASSIGNMENT's current epoch (and, when given, ``expect_epoch``
        still matches it). Exactly one caller per partition-epoch wins;
        promotions of different partitions are independent CAS spaces
        and never fail (or clobber) each other."""
        raise NotImplementedError

    def assignments(self) -> Dict[str, Dict[str, Any]]:
        """Convenience: the current assignment table snapshot."""
        return self.read().get("assignments", {})

    def read_changes(self, since_version: int) -> Dict[str, Any]:
        """Incremental snapshot: what moved since
        ``since_version``. Every mutation bumps a monotone ``version``
        and journals ``[version, kind, key]`` into a bounded changelog,
        so an observer that polls every tick pays O(1) when nothing
        changed and O(changed assignments + cluster size) when
        something did — never O(all partitions) per tick. An observer
        behind the retained journal gets a full-resync payload. See
        :func:`_delta_since` for the three result shapes. This is what
        keeps :class:`~swarmdb_tpu_torch.ha.lindex.LeadershipIndex` (and
        through it the spread/shed/orphan policies) at O(moved) per
        decision on hundreds-of-partitions clusters."""
        raise NotImplementedError


class InMemoryClusterMap(ClusterMap):
    def __init__(self) -> None:
        # swarmlint: guarded-by[self._lock]: _state
        self._lock = make_lock("ha.cluster.InMemoryClusterMap._lock")
        self._state = _empty_state()

    def read(self) -> Dict[str, Any]:
        with self._lock:
            # deep copy, journal excluded (read() callers want the map,
            # not the mutation history — read_changes serves that)
            snap = {k: v for k, v in self._state.items() if k != "changes"}
            return json.loads(json.dumps(snap))

    def register(self, info: NodeInfo) -> None:
        with self._lock:
            self._state["nodes"][info.node_id] = asdict(info)
            _bump(self._state, "n", info.node_id)

    def deregister(self, node_id: str) -> None:
        with self._lock:
            self._state["nodes"].pop(node_id, None)
            _bump(self._state, "n", node_id)

    def try_promote(self, node_id: str, new_epoch: int,
                    expect_epoch: Optional[int] = None) -> bool:
        with self._lock:
            if new_epoch <= self._state["epoch"]:
                return False
            if (expect_epoch is not None
                    and self._state["epoch"] != expect_epoch):
                return False
            self._state["epoch"] = int(new_epoch)
            self._state["leader"] = node_id
            _bump(self._state, "l", "")
            return True

    def try_promote_partition(self, topic: str, partition: int,
                              node_id: str, new_epoch: int,
                              expect_epoch: Optional[int] = None) -> bool:
        with self._lock:
            if not _promote_partition(self._state, topic, partition,
                                      node_id, new_epoch, expect_epoch):
                return False
            _bump(self._state, "a", tp_key(topic, partition))
            return True

    def read_changes(self, since_version: int) -> Dict[str, Any]:
        with self._lock:
            out = _delta_since(self._state, since_version)
            return json.loads(json.dumps(out))  # deep copy


class FileClusterMap(ClusterMap):
    """JSON file + ``fcntl.flock`` sidecar lock on shared storage.

    Every mutation (and the CAS) runs read-modify-write under the lock;
    the write itself is tmp+rename so readers never see a torn file.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock_path = path + ".lock"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def _load(self) -> Dict[str, Any]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                state = json.load(f)
        except (OSError, ValueError):
            return _empty_state()
        for key, default in _empty_state().items():
            state.setdefault(key, default)
        return state

    def _store(self, state: Dict[str, Any]) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, self.path)

    def _locked(self):
        import fcntl

        class _Lock:
            def __init__(self, path: str) -> None:
                self._path = path
                self._fd: Optional[int] = None

            def __enter__(self) -> "_Lock":
                self._fd = os.open(self._path, os.O_CREAT | os.O_RDWR, 0o644)
                fcntl.flock(self._fd, fcntl.LOCK_EX)
                return self

            def __exit__(self, *exc: Any) -> None:
                if self._fd is not None:
                    fcntl.flock(self._fd, fcntl.LOCK_UN)
                    os.close(self._fd)

        return _Lock(self._lock_path)

    def read(self) -> Dict[str, Any]:
        with self._locked():
            state = self._load()
        state.pop("changes", None)
        return state

    def register(self, info: NodeInfo) -> None:
        with self._locked():
            state = self._load()
            state["nodes"][info.node_id] = asdict(info)
            _bump(state, "n", info.node_id)
            self._store(state)

    def deregister(self, node_id: str) -> None:
        with self._locked():
            state = self._load()
            state["nodes"].pop(node_id, None)
            _bump(state, "n", node_id)
            self._store(state)

    def try_promote(self, node_id: str, new_epoch: int,
                    expect_epoch: Optional[int] = None) -> bool:
        with self._locked():
            state = self._load()
            if new_epoch <= state["epoch"]:
                return False
            if expect_epoch is not None and state["epoch"] != expect_epoch:
                return False
            state["epoch"] = int(new_epoch)
            state["leader"] = node_id
            _bump(state, "l", "")
            self._store(state)
            return True

    def try_promote_partition(self, topic: str, partition: int,
                              node_id: str, new_epoch: int,
                              expect_epoch: Optional[int] = None) -> bool:
        # the WHOLE read-modify-write sits inside the flock: a state
        # loaded before the lock would be a stale-read window in which a
        # concurrent CAS on a DIFFERENT partition lands, and storing the
        # stale snapshot would silently erase its epoch bump (the
        # lost-update bug tests/test_partition_leadership.py drives)
        with self._locked():
            state = self._load()
            if not _promote_partition(state, topic, partition, node_id,
                                      new_epoch, expect_epoch):
                return False
            _bump(state, "a", tp_key(topic, partition))
            self._store(state)
            return True

    def read_changes(self, since_version: int) -> Dict[str, Any]:
        # the file IO is O(state) regardless (it is a file); the win is
        # for the CALLER, whose index applies O(changed) work per tick
        with self._locked():
            state = self._load()
        return _delta_since(state, since_version)
