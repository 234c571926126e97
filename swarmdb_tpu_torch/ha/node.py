"""HANode: one broker process under the HA control plane.

A node wraps a :class:`~swarmdb_tpu_torch.broker.base.Broker` and runs, per
role:

- **follower** — a :class:`~swarmdb_tpu_torch.broker.replica.ReplicaServer`
  mirroring the leader's log, a :class:`~swarmdb_tpu_torch.ha.detector
  .FailureDetector` watching the leader (fed by replication-frame beats
  + the out-of-band liveness probe), and a promotion coordinator that
  fires on confirmed leader death.
- **leader** — a :class:`~swarmdb_tpu_torch.broker.replica.ReplicatedBroker`
  over every registered follower, exposed as :attr:`broker_facade` (the
  acks=all write surface), plus a reconcile loop that picks up newly
  registered followers and steps down if the cluster map moves past us.

Every node runs a :class:`~swarmdb_tpu_torch.ha.detector.LivenessServer` — the
out-of-band probe endpoint, which also reports the node's fencing epoch
and catch-up total (sum of end offsets) for candidate ranking.

Promotion ("highest epoch wins", single winner):

1. detector says DEAD (beats AND probes gone past ``dead_s``);
2. the coordinator probes every other registered node and ranks live
   candidates by ``(catch-up, node_id)`` — most-caught-up wins, id
   breaks ties deterministically;
3. the winner CASes the cluster map to ``epoch+1``
   (:meth:`ClusterMap.try_promote` — exactly one caller can win an
   epoch, so a partition flap can never seat two leaders);
4. it persists the epoch into its own segment log
   (:func:`~swarmdb_tpu_torch.broker.replica.persist_epoch`) BEFORE taking
   writes, then starts replicating to the surviving followers. The dead
   leader is deregistered from the map; when it comes back it is fenced
   (``F`` frames / :class:`~swarmdb_tpu_torch.broker.base.FencedError`) until
   re-seeded and restarted as a follower (see the README runbook).

Partition-level leadership (``partition_leadership=True``;
the DEFAULT for cluster-mode entry points — this CLI and
``api/server.py`` — with ``SWARMDB_HA_PARTITION_LEADERSHIP`` overriding
either way) layers a second, finer role machine on top: the node-level
leader stays on as the CONTROLLER (admin ops, assignment of new
topics), while every ``(topic, partition)`` gets its own leader from
the cluster map's epoch-versioned ``assignments`` table. The node's
policy loops (assignment spread, anti-entropy shed, orphan sweep) run
off an incrementally-maintained :class:`~swarmdb_tpu_torch.ha.lindex
.LeadershipIndex` — O(moved partitions) per decision, which is what
lets the drills scale to 5-9 nodes and hundreds of partitions — and an
embedded runtime writes through :meth:`HANode.client_broker`, which
routes each produce to that partition's leader. Each node then runs:

- a :class:`~swarmdb_tpu_torch.ha.partition.PartitionReplicatedBroker` facade
  — per-partition fencing on appends, partition-filtered replication to
  every peer, majority-quorum durability;
- one failure detector PER PEER (fed by that peer's replication-stream
  frames via I-frame identity + the liveness probe). A confirmed-dead
  peer is deregistered and its partitions become ORPHANS;
- an orphan sweep that re-seats each orphaned partition on the
  most-caught-up live replica (per-partition ends from the ``#``
  liveness probe, deterministic spread-score tie-breaks, per-assignment
  epoch CAS pinned with ``expect_epoch`` — exactly one winner per
  partition-epoch), so a node kill degrades only the partitions it led;
- an anti-entropy shed pass: an over-loaded node hands leaderships to a
  healed, under-loaded peer through a drain handover (stop appends,
  wait until the target's mirror acked our end, THEN CAS) — leadership
  moves never race the log.

Deterministic fault injection for all of the above lives in
``ha/chaos.py``; the node exposes the hooks it needs
(:meth:`set_isolated`, :meth:`set_delay`, :meth:`kill`).

Run standalone (the compose follower service)::

    python -m swarmdb_tpu_torch.ha.node --node-id follower-1 \
        --log-dir /data/replica --cluster /data/ha/cluster.json \
        --listen 0.0.0.0:9444 --liveness 0.0.0.0:9445

Healthcheck probe (exit 0 iff the liveness endpoint answers)::

    python -m swarmdb_tpu_torch.ha.node --probe localhost:9445
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..broker.base import Broker
from ..broker.replica import (ReplicaServer, ReplicatedBroker,
                              persist_epoch, read_log_epoch)
from ..obs import TRACER
from ..obs.flight import FlightRecorder
from .cluster import ClusterMap, NodeInfo, parse_tp_key, tp_key
from .detector import (DetectorState, FailureDetector, LivenessServer,
                       dead_s_default, probe_ends, probe_liveness,
                       suspect_s_default)
from ..utils.sync import make_lock, make_rlock
from .lindex import LeadershipIndex
from .partition import (PartitionReplicatedBroker, is_internal_topic,
                        partition_leadership_default, spread_moves_default,
                        spread_score)

logger = logging.getLogger("swarmdb_tpu_torch.ha")

__all__ = ["HANode", "NodeBroker", "ClusterUnreachableError", "main"]


class ClusterUnreachableError(RuntimeError):
    """The control-plane store cannot be reached (partition): promotion
    and reconciliation must stall, never guess."""


def _promotion_policy() -> str:
    return os.environ.get("SWARMDB_HA_PROMOTION", "auto").strip() or "auto"


class HANode:
    def __init__(self, node_id: str, broker: Broker, cluster: ClusterMap, *,
                 listen_host: str = "127.0.0.1", replica_port: int = 0,
                 liveness_port: int = 0, data_port: Optional[int] = 0,
                 advertise_host: Optional[str] = None,
                 heartbeat_s: Optional[float] = None,
                 suspect_s: Optional[float] = None,
                 dead_s: Optional[float] = None,
                 promotion: Optional[str] = None,
                 partition_leadership: Optional[bool] = None,
                 cluster_mode: bool = False,
                 flight: Optional[FlightRecorder] = None,
                 log_dir: str = "") -> None:
        self.node_id = node_id
        self.broker = broker
        self.cluster = cluster
        # cluster_mode: set by the deployment entry points (the node CLI
        # and api/server.py) — partition leadership defaults ON there;
        # in-process harnesses keep the node-level default
        self.partition_leadership = (
            partition_leadership if partition_leadership is not None
            else partition_leadership_default(cluster_mode))
        self._listen_host = listen_host
        self._replica_port = replica_port
        self._liveness_port = liveness_port
        self._data_port = data_port  # None = no client data plane
        self._advertise_host = advertise_host or listen_host
        self.heartbeat_s = heartbeat_s
        self.suspect_s = (suspect_s if suspect_s is not None
                          else suspect_s_default())
        self.dead_s = (dead_s if dead_s is not None
                       else dead_s_default(self.suspect_s))
        self.promotion = promotion or _promotion_policy()
        self.flight = flight or FlightRecorder()
        # dump-file identity (obs/flight dump_to): first owner wins on a
        # shared harness recorder — per-node recorders get their own id
        self.flight.meta.setdefault("node_id", node_id)
        self.log_dir = log_dir

        self._lock = make_rlock("ha.node.HANode._lock")
        # swarmlint: guarded-by[self._lock]: _role, _epoch, _leader_broker, _orphan_since, _orphan_peak
        self._role = "follower"
        self._epoch = read_log_epoch(broker)
        self._leader_broker: Optional[ReplicatedBroker] = None

        # chaos hooks: benign racy flags (GIL-atomic bool/float stores)
        self._isolated = False
        self._delay = 0.0

        self._stop = threading.Event()
        self._promoting = threading.Event()  # one promotion attempt at a time
        self._last_leader_seen: Optional[str] = None
        self._threads: List[threading.Thread] = []

        self._replica_server: Optional[ReplicaServer] = None
        self._liveness: Optional[LivenessServer] = None
        self._data_plane = None  # DataPlaneServer when data_port is set
        self._detector: Optional[FailureDetector] = None

        # partition-level leadership
        self._pbroker: Optional[PartitionReplicatedBroker] = None
        # swarmlint: guarded-by[self._peers_lock]: _peer_detectors
        self._peers_lock = make_lock("ha.node.HANode._peers_lock")
        self._peer_detectors: Dict[str, FailureDetector] = {}
        self._sweeping = threading.Event()  # one orphan sweep at a time
        self._shed_tick = 0
        self.spread_moves = spread_moves_default()

        # incrementally-maintained leadership views: the
        # spread/shed/orphan policies decide off this index instead of
        # re-scanning the full assignment table; per-assignment
        # reconciliation (leases, fencing floors, rebalance fan-out)
        # rides its change listener, so a tick with nothing moved is
        # O(cluster size + own leaderships)
        self._index = LeadershipIndex()
        self._index.add_listener(self._on_assignment_change)
        # controller worklist: never-assigned partitions, fed by
        # _on_topic_created + a low-frequency topic-listing backstop
        # swarmlint: guarded-by[self._unassigned_lock]: _unassigned
        self._unassigned_lock = make_lock("ha.node.HANode._unassigned_lock")
        self._unassigned: set = set()
        self._assign_tick = 0
        # serving-tier locality subscribers (backend/locality.py)
        self._rebalance_listeners: List[Any] = []
        # rebalance-convergence episode tracking (first orphan observed
        # -> orphan set empty), the bench/metrics first-class number
        self._orphan_since: Optional[float] = None
        self._orphan_peak = 0
        self.last_convergence_s: Optional[float] = None

    # ------------------------------------------------------------ chaos hooks

    def _gate(self) -> bool:
        """Connection-admission gate consulted by every server/stream this
        node owns. False = chaos partition; a configured delay injects
        latency before the verdict."""
        if self._delay > 0:
            time.sleep(min(self._delay, 0.5))
        return not self._isolated

    def set_isolated(self, isolated: bool) -> None:
        self._isolated = bool(isolated)
        if isolated and self._replica_server is not None:
            # cut existing streams too, not just new ones
            self._replica_server.drop_connections()
        if isolated and self._data_plane is not None:
            self._data_plane.drop_connections()
        self._record("partition" if isolated else "heal", {})

    def set_delay(self, seconds: float) -> None:
        self._delay = max(0.0, float(seconds))
        self._record("delay", {"seconds": self._delay})

    def kill(self) -> None:
        """Abrupt death (chaos): no graceful handover, broker closed."""
        self._record("kill", {})
        with self._lock:
            # dead BEFORE teardown: from this instant every broker_facade
            # access refuses, exactly like the sockets of a dead process
            self._role = "dead"
        self.stop()
        try:
            self.broker.close()
        except Exception:
            pass

    # -------------------------------------------------------------- lifecycle

    def start(self, role: str = "follower") -> "HANode":
        if self.partition_leadership:
            self._pbroker = PartitionReplicatedBroker(
                self.broker, self.node_id, gate=self._gate,
                heartbeat_s=self.heartbeat_s,
                on_lease_fenced=self._on_lease_fenced,
                on_topic_created=self._on_topic_created)
        self._liveness = LivenessServer(
            self.current_epoch, self._catchup_total,
            self._listen_host, self._liveness_port,
            get_ends=self._local_partition_ends,
            gate=self._gate).start()
        self._replica_server = ReplicaServer(
            self.broker, self._listen_host, self._replica_port,
            on_activity=self._on_replica_activity,
            on_peer_activity=self._on_peer_activity,
            partition_mode=self.partition_leadership,
            gate=self._gate).start()
        data_addr = ""
        if self._data_port is not None:
            from .dataplane import DataPlaneServer

            # per-request facade lookup: clients ride role transitions
            # (and get FencedError from a deposed leader) with no rebind
            self._data_plane = DataPlaneServer(
                lambda: self.broker_facade, self._listen_host,
                self._data_port, gate=self._gate,
                node_id=self.node_id).start()
            data_addr = f"{self._advertise_host}:{self._data_plane.port}"
        self.cluster.register(NodeInfo(
            node_id=self.node_id,
            replica_addr=f"{self._advertise_host}:{self._replica_server.port}",
            liveness_addr=f"{self._advertise_host}:{self._liveness.port}",
            data_addr=data_addr,
            log_dir=self.log_dir,
        ))
        self._detector = FailureDetector(
            self._leader_liveness_addr,
            suspect_s=self.suspect_s, dead_s=self.dead_s,
            on_state=self._on_detector_state,
            name=self.node_id,
        ).start()
        if role == "leader":
            state = self._read_map()
            new_epoch = max(state["epoch"], self.current_epoch()) + 1
            if not self.cluster.try_promote(self.node_id, new_epoch,
                                            expect_epoch=state["epoch"]):
                raise RuntimeError(
                    f"bootstrap promotion lost: cluster already at epoch "
                    f">= {new_epoch} (is another leader running?)")
            self._become_leader(new_epoch, self._read_map(),
                                deposed=None)
        if self.partition_leadership:
            # seed replication targets / quorum size / peer detectors
            # from the map NOW — the first appends must not race the
            # first watch tick into single-copy quorums. The initial
            # index sync is a full resync: the change listener replays
            # every assignment (leases + fencing floors seeded).
            try:
                self._sync_index()
                self._reconcile_partitions()
            except Exception:
                logger.exception("initial partition reconcile failed")
        t = threading.Thread(target=self._watch_loop, daemon=True,
                             name=f"swarmdb-ha-watch-{self.node_id}")
        t.start()
        self._threads.append(t)
        self._record("start", {"role": self.role})
        return self

    def stop(self) -> None:
        """Graceful stop: servers and threads down, broker left open
        (the caller owns it)."""
        self._stop.set()
        if self._detector is not None:
            self._detector.stop()
        with self._peers_lock:
            peer_dets = list(self._peer_detectors.values())
            self._peer_detectors.clear()
        for det in peer_dets:
            det.stop()
        if self._pbroker is not None:
            self._pbroker.stop_replication()
        with self._lock:
            lb = self._leader_broker
            self._leader_broker = None
        if lb is not None:
            lb.stop_replication()
        if self._replica_server is not None:
            self._replica_server.stop()
        if self._data_plane is not None:
            self._data_plane.stop()
        if self._liveness is not None:
            self._liveness.stop()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=2.0)

    # ------------------------------------------------------------------ state

    @property
    def role(self) -> str:
        with self._lock:
            return self._role

    def current_epoch(self) -> int:
        """Highest epoch this node has seen: its own persisted/announced
        epoch or any it learned from a connecting leader."""
        with self._lock:
            epoch = self._epoch
        if self._replica_server is not None:
            epoch = max(epoch, self._replica_server.highest_epoch)
        return epoch

    @property
    def broker_facade(self) -> Broker:
        """What clients write through: the replicated (acks=all) wrapper
        while leading, the plain local broker otherwise (reads only —
        ClusterBroker routes writes to the map leader). In partition
        mode it is ALWAYS the partition-replicated facade: appends are
        fence-checked per lease, so the same handle is correct whether
        this node leads zero or all partitions. A killed node raises —
        its real-deployment counterpart is a dead process whose sockets
        refuse, and an in-process chaos kill must look the same to a
        ClusterBroker (transient error -> re-resolve the leader)."""
        with self._lock:
            if self._role == "dead":
                raise ConnectionError(f"node {self.node_id} is dead")
            if self._pbroker is not None:
                return self._pbroker
            return self._leader_broker or self.broker

    def client_broker(self) -> Broker:
        """What an EMBEDDED runtime should write through.

        Node-level mode: the per-call role-facade proxy (NodeBroker) —
        the node-level write path. Partition mode: a
        per-partition-routing :class:`~swarmdb_tpu_torch.ha.client
        .ClusterBroker` whose opener short-circuits THIS node to its own
        facade (local writes for partitions we lead cost one dict
        lookup) and dials peers' data planes for the rest. This is the
        wiring that lets partition leadership default ON for cluster
        nodes: every produce reaches the partition's owning leader
        instead of fencing on the local facade, and a mid-failover write
        surfaces as the retryable ``LeaderChangedError`` the runtime's
        resend path already understands."""
        if not self.partition_leadership:
            return NodeBroker(self)
        from .client import ClusterBroker, data_plane_opener

        remote = data_plane_opener()

        def _open(node_id: str, info: Dict[str, Any]) -> Broker:
            if node_id == self.node_id:
                return NodeBroker(self)
            return remote(node_id, info)

        return ClusterBroker(self.cluster, _open, owns_inner=True)

    # ---------------------------------------------- leadership index views

    def assignment_of(self, key: str) -> Optional[Dict[str, Any]]:
        """Current assignment entry ``{"leader", "epoch"}`` for a
        ``"topic:partition"`` key, from the incrementally-synced index
        (O(1)); None while unassigned/unknown. The serving tier's
        conversation locality derives lane pins from this."""
        return self._index.entry(key)

    def add_rebalance_listener(self, cb) -> None:
        """``cb(key, entry_or_None)`` fires on every assignment change
        this node OBSERVES (assign/failover/shed/deposal — regardless of
        which node acted): the serving tier re-pins conversation
        locality off this stream. Listeners must be fast and must not
        raise (exceptions are swallowed and logged)."""
        self._rebalance_listeners.append(cb)

    def _notify_rebalance(self, key: str,
                          entry: Optional[Dict[str, Any]]) -> None:
        for cb in self._rebalance_listeners:
            try:
                cb(key, entry)
            except Exception:
                logger.exception("rebalance listener failed for %s", key)

    def _sync_index(self):
        """Pull map changes into the leadership index (isolation-gated
        like every other map access) and track orphan-episode
        convergence. Assignment-change side effects (lease grants/
        revocations, fencing floors, rebalance fan-out) fire from the
        index listener on this thread."""
        if self._isolated:
            raise ClusterUnreachableError(self.node_id)
        res = self._index.sync(self.cluster)
        self._track_convergence()
        return res

    def _track_convergence(self) -> None:
        """Rebalance convergence as a first-class number: an
        episode opens when this node first observes orphaned partitions
        and closes when the orphan set drains — the elapsed time is what
        the scaled drills bound and /metrics exports."""
        n = self._index.orphan_count()
        with self._lock:
            if n:
                if self._orphan_since is None:
                    self._orphan_since = time.monotonic()
                    self._orphan_peak = n
                else:
                    self._orphan_peak = max(self._orphan_peak, n)
                return
            if self._orphan_since is None:
                return
            elapsed = time.monotonic() - self._orphan_since
            peak = self._orphan_peak
            self._orphan_since = None
            self.last_convergence_s = round(elapsed, 4)
        self._record("rebalance_converged", {
            "elapsed_s": round(elapsed, 4), "orphans_peak": peak})
        TRACER.instant("ha.rebalance", cat="ha", args={
            "action": "converged", "node": self.node_id,
            "elapsed_s": round(elapsed, 4), "orphans_peak": peak})

    def status(self) -> Dict[str, Any]:
        """Control-plane status (the /admin/ha + /metrics surface)."""
        with self._lock:
            role, epoch, lb = self._role, self._epoch, self._leader_broker
        out: Dict[str, Any] = {
            "node_id": self.node_id,
            "role": role,
            "epoch": epoch,
            "promotion": self.promotion,
            "isolated": self._isolated,
        }
        try:
            state = self._read_map()
            out["leader"] = state.get("leader")
            out["cluster_epoch"] = state.get("epoch")
            out["nodes"] = sorted(state.get("nodes", {}))
        except ClusterUnreachableError:
            out["leader"] = None
            out["cluster_unreachable"] = True
        if self._detector is not None and role == "follower":
            out["detector"] = self._detector.status()
        if lb is not None:
            out["replication"] = lb.replication_stats()
            out["fenced_by"] = lb.fenced_by
        pb = self._pbroker
        if pb is not None:
            try:
                out["partition_leadership"] = self._partition_status(pb)
            except Exception:
                logger.exception("partition status failed")
        return out

    def _partition_status(self, pb: PartitionReplicatedBroker
                          ) -> Dict[str, Any]:
        """The /admin/ha partition table + /metrics gauge inputs:
        per-partition (leader, epoch, replica lag for partitions WE
        lead), leaderships per node, and the leaderless count."""
        try:
            state = self._read_map()
        except ClusterUnreachableError:
            state = {"nodes": {}, "assignments": {}}
        nodes = state.get("nodes", {})
        lag = pb.partition_lag()
        leaderships: Dict[str, int] = {nid: 0 for nid in nodes}
        leaderless = 0
        partitions: Dict[str, Any] = {}
        for key, a in sorted(state.get("assignments", {}).items()):
            nid = a.get("leader")
            row = {"leader": nid, "epoch": int(a.get("epoch", 0))}
            if nid in leaderships:
                leaderships[nid] += 1
            else:
                leaderless += 1
                row["leaderless"] = True
            if key in lag:
                row["replica_lag"] = lag[key]["replica_lag"]
                row["end"] = lag[key]["end"]
            partitions[key] = row
        with self._lock:
            converging = self._orphan_since is not None
            convergence = self.last_convergence_s
        return {
            "enabled": True,
            "leases": pb.leases.count(),
            "leaderships": leaderships,
            "leaderless": leaderless,
            "partitions": partitions,
            "replication": pb.replication_stats(),
            # rebalance-convergence episode view: the gauge
            # /metrics exports and the scaled drills bound
            "rebalancing": converging,
            "rebalance_convergence_s": convergence,
            "orphans": self._index.orphan_count(),
        }

    def _catchup_total(self) -> int:
        total = 0
        try:
            for name, meta in self.broker.list_topics().items():
                for p in range(meta.num_partitions):
                    total += self.broker.end_offset(name, p)
        except Exception:
            pass
        return total

    def _local_partition_ends(self) -> Dict[str, Dict[str, int]]:
        """Per-partition end offsets for the liveness ``#`` probe — the
        per-partition catch-up view orphan sweeps rank candidates by."""
        ends: Dict[str, Dict[str, int]] = {}
        try:
            for name, meta in self.broker.list_topics().items():
                if is_internal_topic(name):
                    continue
                ends[name] = {
                    str(p): self.broker.end_offset(name, p)
                    for p in range(meta.num_partitions)
                }
        except Exception:
            pass
        return ends

    # ----------------------------------------------- partition leadership

    def _on_peer_activity(self, peer: str) -> None:
        """A replication frame arrived from ``peer`` (I-frame-identified
        stream): beat that peer's failure detector."""
        with self._peers_lock:
            det = self._peer_detectors.get(peer)
        if det is not None:
            det.beat()
        if peer == self._last_leader_seen and self._detector is not None:
            self._detector.beat()

    def _on_lease_fenced(self, topic: str, part: int, epoch: int) -> None:
        """A follower N-fenced one of our partition leases: a newer
        leader exists. The lease is already revoked (pbroker did it);
        record why and let the watch loop re-read the map."""
        self._record("partition_deposed", {
            "topic": topic, "partition": part, "fenced_epoch": epoch})
        TRACER.instant("ha.rebalance", cat="ha", args={
            "action": "deposed", "node": self.node_id,
            "partition": tp_key(topic, part), "epoch": epoch})

    def _on_topic_created(self, name: str, parts: int) -> None:
        """Controller hook: assign a freshly created topic's partitions
        across live nodes right away (the low-frequency topic-listing
        backstop in :meth:`_assign_unassigned` covers topics created
        elsewhere)."""
        if not self.partition_leadership or self.role != "leader":
            return
        try:
            self._sync_index()
        except ClusterUnreachableError:
            return
        adds = [tp_key(name, p) for p in range(parts)
                if self._index.entry(tp_key(name, p)) is None]
        with self._unassigned_lock:
            self._unassigned.update(adds)
        self._assign_unassigned()

    def _refresh_unassigned(self) -> None:
        """Authoritative recompute of the controller's never-assigned
        worklist from the local topic table — the backstop for topics
        whose creation replicated in via T frames (no _on_topic_created
        fires here). Amortized: called every ~16 controller ticks, not
        per decision."""
        try:
            topics = self.broker.list_topics()
        except Exception:
            return
        fresh = set()
        for name, meta in topics.items():
            if is_internal_topic(name):
                continue
            for p in range(meta.num_partitions):
                key = tp_key(name, p)
                if self._index.entry(key) is None:
                    fresh.add(key)
        with self._unassigned_lock:
            self._unassigned = fresh

    def _assign_unassigned(self) -> None:
        """Controller: give every never-assigned partition a leader,
        least-loaded live node first with deterministic spread
        tie-breaks. The worklist is the incrementally-fed
        ``_unassigned`` set and the load view is the index's
        leadership counts — O(unassigned + cluster size) per pass, not
        a full assignment-table scan. Orphans (epoch > 0,
        leader gone) are NOT handled here — they need catch-up ranking,
        the orphan sweep's job."""
        self._assign_tick += 1
        if self._assign_tick % 16 == 1:
            self._refresh_unassigned()
        with self._unassigned_lock:
            todo = sorted(self._unassigned)
        if not todo:
            return
        counts = self._index.leadership_counts()
        nodes = sorted(counts)
        if not nodes:
            return
        for key in todo:
            if self._index.entry(key) is not None:
                with self._unassigned_lock:
                    self._unassigned.discard(key)
                continue
            name, p = parse_tp_key(key)
            target = min(nodes, key=lambda n: (
                counts[n], -spread_score(name, p, n)))
            won = False
            try:
                won = self.cluster.try_promote_partition(
                    name, p, target, 1, expect_epoch=0)
            except Exception:
                logger.exception("assignment CAS failed for %s", key)
            if won:
                counts[target] += 1
                with self._unassigned_lock:
                    self._unassigned.discard(key)
                if target == self.node_id and self._pbroker is not None:
                    self._pbroker.leases.grant(name, p, 1)
                self._record("rebalance", {
                    "action": "assign", "partition": key,
                    "leader": target, "epoch": 1})
                TRACER.instant("ha.rebalance", cat="ha", args={
                    "action": "assign", "partition": key,
                    "leader": target, "epoch": 1})

    def _on_peer_dead(self, peer: str) -> None:
        """A peer's detector confirmed DEAD (beats and probes both
        gone): deregister the corpse — its partitions become orphans the
        sweep re-seats, and pruning it from every quorum lets surviving
        majorities keep acking — then sweep."""
        if self._isolated:
            # a partitioned node sees EVERY peer as dead — it must not
            # act on that: no deregistering healthy nodes, no claiming
            # (the same no-dueling guard _read_map enforces for CASes)
            return
        self._record("peer_dead", {"peer": peer})
        try:
            self.cluster.deregister(peer)
        except Exception:
            logger.exception("deregistering dead peer %s failed", peer)
        self._start_orphan_sweep()

    def _start_orphan_sweep(self) -> None:
        if self._sweeping.is_set() or self._stop.is_set():
            return
        self._sweeping.set()
        t = threading.Thread(target=self._orphan_sweep_loop, daemon=True,
                             name=f"swarmdb-ha-sweep-{self.node_id}")
        t.start()
        self._threads.append(t)

    def _orphan_sweep_loop(self) -> None:
        """Failure-scoped rebalance: re-seat ONLY orphaned partitions
        (assignment leader no longer registered). Every survivor runs
        the same deterministic ranking — most-caught-up live replica
        first (per-partition ends from the ``#`` probe), spread-score
        tie-break — and CASes only the partitions it wins, with
        ``expect_epoch`` pinned to the ranked-at assignment so exactly
        one winner per partition-epoch can seat. Loops (bounded) so a
        designated winner that died mid-claim is swept up by the next
        pass's re-ranking."""
        t0 = time.monotonic()
        try:
            for _ in range(200):  # bounded: ~100x any sane convergence
                if self._stop.is_set():
                    return
                try:
                    self._sync_index()
                except ClusterUnreachableError:
                    self._stop.wait(self.suspect_s)
                    continue
                # the index maintains the orphan set incrementally
                # (O(victim's partitions) when a node deregisters) —
                # the sweep's worklist is a copy of it, not a scan
                nodes = self._index.nodes()
                orphans = self._index.orphans()
                if not orphans:
                    return
                # candidate views: per-partition ends of every LIVE node
                views: Dict[str, Dict[str, Dict[str, int]]] = {
                    self.node_id: self._local_partition_ends()}
                missing = []
                for nid, info in nodes.items():
                    if nid == self.node_id:
                        continue
                    addr = (info or {}).get("liveness_addr")
                    if not addr:
                        continue
                    view = probe_ends(addr, max(0.05, self.suspect_s / 2))
                    if view is not None:
                        views[nid] = view.get("ends", {})
                    else:
                        missing.append(nid)
                if (missing and time.monotonic() - t0
                        < self.dead_s + self.suspect_s):
                    # a registered peer whose probe did not answer (a slow
                    # one, under load) may hold the longest copy: ranking
                    # without it can seat a shorter one, whose readers sit
                    # past its end. A dead peer is deregistered within
                    # dead_s; until then, or until it answers, probe again
                    # (the JAX package ranks whoever answered)
                    self._stop.wait(max(0.05, self.suspect_s / 2))
                    continue
                claimed = 0
                for key, a in orphans:
                    topic, part = parse_tp_key(key)

                    def _end(nid: str) -> int:
                        return int(views[nid].get(topic, {})
                                   .get(str(part), 0))

                    winner = max(views, key=lambda n: (
                        _end(n), spread_score(topic, part, n), n))
                    if winner != self.node_id:
                        continue
                    new_epoch = int(a.get("epoch", 0)) + 1
                    won = False
                    try:
                        won = self.cluster.try_promote_partition(
                            topic, part, self.node_id, new_epoch,
                            expect_epoch=int(a.get("epoch", 0)))
                    except Exception:
                        logger.exception("partition CAS failed; retrying")
                    if not won:
                        continue
                    claimed += 1
                    self._ensure_local_partition(topic, part)
                    if self._pbroker is not None:
                        self._pbroker.leases.grant(topic, part, new_epoch)
                    elapsed = round(time.monotonic() - t0, 4)
                    logger.warning(
                        "ha: %s promoted to PARTITION leader of %s at "
                        "epoch %d (%.3fs into sweep)", self.node_id, key,
                        new_epoch, elapsed)
                    self._record("partition_promoted", {
                        "partition": key, "epoch": new_epoch,
                        "deposed": a.get("leader"), "elapsed_s": elapsed})
                    TRACER.instant("ha.rebalance", cat="ha", args={
                        "action": "failover", "partition": key,
                        "leader": self.node_id, "epoch": new_epoch,
                        "deposed": a.get("leader")})
                if claimed:
                    self.flight.auto_dump("ha_partition_promotion")
                # give the other survivors a beat to claim their wins,
                # then re-scan for leftovers (their deaths included)
                self._stop.wait(max(0.05, self.suspect_s / 2))
        finally:
            self._sweeping.clear()

    def _on_assignment_change(self, key: str,
                              entry: Optional[Dict[str, Any]]) -> None:
        """Index change listener: fires exactly once per applied
        assignment change (and for every key on a full resync), on
        whichever thread synced — this is where per-assignment
        reconciliation lives now, so a watch tick with nothing moved
        does ZERO per-partition work."""
        with self._unassigned_lock:
            self._unassigned.discard(key)
        if self.partition_leadership:
            try:
                self._reconcile_assignment(key, entry)
            except Exception:
                logger.exception("assignment reconcile failed for %s", key)
        self._notify_rebalance(key, entry)

    def _reconcile_assignment(self, key: str,
                              entry: Optional[Dict[str, Any]]) -> None:
        """Converge local lease + fencing-floor state onto ONE
        assignment entry (None = dropped from the table)."""
        pb = self._pbroker
        if pb is None:
            return
        topic, part = parse_tp_key(key)
        if entry is None:
            # leased but no longer in the table at all (topic dropped)
            pb.leases.revoke(topic, part)
            return
        epoch = int(entry.get("epoch", 0))
        if self._replica_server is not None:
            self._replica_server.note_partition_epoch(topic, part, epoch)
        held = pb.leases.epoch_of(topic, part)
        if entry.get("leader") == self.node_id:
            if held != epoch:
                # the lease implies the topic: a T frame may not have
                # arrived yet (assignment raced replication), and a
                # leader without the topic would refuse its appends
                self._ensure_local_partition(topic, part)
                pb.leases.grant(topic, part, epoch)
        elif held is not None:
            # deposed (failover or a rebalance move): fence ONLY this
            # lease; our other partitions keep writing
            pb.leases.revoke(topic, part, fenced_epoch=epoch)
            self._record("partition_deposed", {
                "topic": topic, "partition": part,
                "new_leader": entry.get("leader"), "epoch": epoch})
            TRACER.instant("ha.rebalance", cat="ha", args={
                "action": "deposed", "node": self.node_id,
                "partition": key, "new_leader": entry.get("leader"),
                "epoch": epoch})

    def _reconcile_partitions(self) -> None:
        """Watch-loop duty in partition mode, index-driven:
        replication targets, per-peer detectors, self-heal registration,
        and the own-lease backstop — O(cluster size + own leaderships)
        per tick. Per-assignment lease/floor reconciliation happens in
        :meth:`_on_assignment_change` for exactly the CHANGED entries."""
        pb = self._pbroker
        if pb is None:
            return
        nodes = self._index.nodes()
        # replication streams + ack quorum follow the registered peers
        pb.sync_targets(
            info.get("replica_addr") for nid, info in nodes.items()
            if nid != self.node_id and info.get("replica_addr"))
        # one failure detector per peer (probe + I-frame beats)
        with self._peers_lock:
            for nid in [n for n in self._peer_detectors if n not in nodes]:
                self._peer_detectors.pop(nid).stop()
            for nid in nodes:
                if nid == self.node_id or nid in self._peer_detectors:
                    continue
                self._peer_detectors[nid] = FailureDetector(
                    self._peer_liveness_fn(nid),
                    suspect_s=self.suspect_s, dead_s=self.dead_s,
                    on_state=self._peer_state_fn(nid),
                    name=f"{self.node_id}->{nid}",
                ).start()
        # self-heal: a deregistered (deposed/healed) node re-registers —
        # safe under quorum acks, where a divergent replica gaps itself
        # out of the quorum instead of freezing it
        if self.node_id not in nodes:
            self.cluster.register(self._my_info())
        # own-lease backstop, O(own): an aborted drain handover re-grant
        # or a lease dropped out-of-band has no map change to ride the
        # listener, so our holdings are reconciled against the index
        # every tick
        led = self._index.keys_led_by(self.node_id)
        for (topic, part), held in pb.leases.snapshot().items():
            key = tp_key(topic, part)
            if key not in led:
                self._reconcile_assignment(key, self._index.entry(key))
        for key in led:
            topic, part = parse_tp_key(key)
            a = self._index.entry(key)
            if a is not None and pb.leases.epoch_of(topic, part) != a["epoch"]:
                self._ensure_local_partition(topic, part)
                pb.leases.grant(topic, part, a["epoch"])
        # orphan backstop: a sweep can be lost to a crash — any node
        # noticing orphans restarts one
        if self._index.orphan_count():
            self._start_orphan_sweep()

    def _ensure_local_partition(self, topic: str, part: int) -> None:
        try:
            meta = self.broker.list_topics().get(topic)
            if meta is None:
                self.broker.create_topic(topic, part + 1)
            elif meta.num_partitions <= part:
                self.broker.create_partitions(topic, part + 1)
        except Exception:
            logger.exception("ensuring local %s[%d] failed", topic, part)

    def _peer_liveness_fn(self, nid: str):
        def _resolve() -> Optional[str]:
            try:
                info = self._read_map().get("nodes", {}).get(nid)
            except ClusterUnreachableError:
                return None
            return info.get("liveness_addr") if info else None
        return _resolve

    def _peer_state_fn(self, nid: str):
        def _on_state(old: DetectorState, new: DetectorState) -> None:
            self._record("peer_detector", {
                "peer": nid, "from": old.name.lower(),
                "to": new.name.lower()})
            if new is DetectorState.DEAD and not self._stop.is_set():
                t = threading.Thread(target=self._on_peer_dead,
                                     args=(nid,), daemon=True,
                                     name=f"swarmdb-ha-peerdead-{nid}")
                t.start()
                self._threads.append(t)
        return _on_state

    def _my_info(self) -> NodeInfo:
        return NodeInfo(
            node_id=self.node_id,
            replica_addr=(f"{self._advertise_host}:"
                          f"{self._replica_server.port}"
                          if self._replica_server is not None else ""),
            liveness_addr=(f"{self._advertise_host}:{self._liveness.port}"
                           if self._liveness is not None else ""),
            data_addr=(f"{self._advertise_host}:{self._data_plane.port}"
                       if self._data_plane is not None else ""),
            log_dir=self.log_dir,
        )

    def _shed_pass(self) -> None:
        """Anti-entropy: when a healed node re-joins under-loaded, an
        over-loaded node hands it leaderships — bounded to
        ``spread_moves`` per pass (the SWARMDB_HA_SPREAD knob), each via
        the drain handover so the move never races the log. Index-driven:
        load comes from the leadership counts (O(cluster
        size)) and candidates from our OWN lease snapshot (O(own)) — no
        assignment-table scan."""
        pb = self._pbroker
        if pb is None:
            return
        counts = self._index.leadership_counts()
        nodes = sorted(counts)
        if len(nodes) < 2 or self.node_id not in counts:
            return
        for _ in range(self.spread_moves):
            under = min(nodes, key=lambda n: (counts[n], n))
            if under == self.node_id:
                return
            if counts[self.node_id] - counts[under] < 2:
                return  # within one leadership of balanced: done
            info = self._index.node_info(under) or {}
            if probe_liveness(info.get("liveness_addr", ""),
                              max(0.05, self.suspect_s / 2)) is None:
                return  # never shed onto a corpse
            moved = False
            for (topic, part), epoch in sorted(pb.leases.snapshot().items()):
                a = self._index.entry(tp_key(topic, part))
                if a is None or a.get("leader") != self.node_id:
                    continue
                if self._handover(topic, part, epoch, under,
                                  info.get("replica_addr", "")):
                    counts[self.node_id] -= 1
                    counts[under] += 1
                    moved = True
                    break
            if not moved:
                return  # nothing currently hand-over-able (lagging peer)

    def _handover(self, topic: str, part: int, epoch: int,
                  to_nid: str, to_addr: str) -> bool:
        """Drain handover of one leadership: stop taking appends, wait
        (bounded) until the target's mirror has acked everything we
        hold, then CAS the assignment to the target. On any failure the
        lease is simply not CASed away — the next watch tick re-grants
        it from the unchanged map."""
        pb = self._pbroker
        if pb is None or not to_addr:
            return False
        with pb._repl_lock:
            repl = pb._repls.get(to_addr)
        if repl is None:
            return False
        if pb.leases.revoke(topic, part) is None:
            return False  # lost it concurrently
        try:
            end = self.broker.end_offset(topic, part)
        except Exception:
            end = None
        if end is not None and repl.wait_acked(
                topic, part, end - 1, max(0.5, 4 * self.suspect_s)):
            try:
                if self.cluster.try_promote_partition(
                        topic, part, to_nid, epoch + 1,
                        expect_epoch=epoch):
                    key = tp_key(topic, part)
                    self._record("rebalance", {
                        "action": "shed", "partition": key,
                        "leader": to_nid, "epoch": epoch + 1})
                    TRACER.instant("ha.rebalance", cat="ha", args={
                        "action": "shed", "partition": key,
                        "leader": to_nid, "epoch": epoch + 1,
                        "from": self.node_id})
                    return True
            except Exception:
                logger.exception("handover CAS failed")
        # abort: map unchanged, the next reconcile tick re-grants us
        pb.leases.grant(topic, part, epoch)
        return False

    # ------------------------------------------------------------ map access

    def _read_map(self) -> Dict[str, Any]:
        if self._isolated:
            # a partitioned node cannot see the control store — and
            # therefore can never win an epoch (the no-dueling guard)
            raise ClusterUnreachableError(self.node_id)
        return self.cluster.read()

    def _leader_liveness_addr(self) -> Optional[str]:
        try:
            state = self._read_map()
        except ClusterUnreachableError:
            return None
        leader = state.get("leader")
        if leader is None or leader == self.node_id:
            return None
        info = state.get("nodes", {}).get(leader)
        return info.get("liveness_addr") if info else None

    # ------------------------------------------------------------- callbacks

    def _on_replica_activity(self) -> None:
        # under partition leadership every peer streams into this node,
        # so a frame proves nothing about the controller: its detector
        # beats from the controller's own stream (_on_peer_activity) and
        # its probes. The JAX package beats it from any stream, and a
        # dead controller of a cluster of three or more is never
        # replaced (ROADMAP.md queue 3)
        if self._detector is not None and not self.partition_leadership:
            self._detector.beat()

    def _on_detector_state(self, old: DetectorState,
                           new: DetectorState) -> None:
        self._record("detector", {"from": old.name.lower(),
                                  "to": new.name.lower()})
        TRACER.instant("ha.detector", cat="ha",
                       args={"node": self.node_id, "state": new.name.lower()})
        if new is DetectorState.DEAD and self.promotion == "auto":
            if self.role == "follower" and not self._promoting.is_set():
                self._promoting.set()
                t = threading.Thread(target=self._promotion_loop, daemon=True,
                                     name=f"swarmdb-ha-promote-{self.node_id}")
                t.start()
                self._threads.append(t)

    # -------------------------------------------------------------- promotion

    def _promotion_loop(self) -> None:
        """Runs until the cluster has a live leader again (us or a better
        candidate) or the leader turns out to be alive after all.

        The leader failed over from is the one the detector was judging:
        the last leader the watch loop gave a grace period to
        (``_last_leader_seen``). A DEAD verdict that lands after another
        node already won, but before the watch loop noticed and reset
        the detector, must not fail over from the fresh winner: the JAX
        package's loop took the map's leader at its first read as the
        dead one and deposed it (ROADMAP.md queue 3)."""
        dead_leader: Optional[str] = self._last_leader_seen
        try:
            while not self._stop.is_set():
                if (self._detector is None
                        or self._detector.state is not DetectorState.DEAD
                        or self.role != "follower"):
                    return
                try:
                    state = self._read_map()
                except ClusterUnreachableError:
                    self._stop.wait(self.suspect_s)
                    continue
                if dead_leader is None:
                    dead_leader = state.get("leader")
                if dead_leader is None:
                    return  # nothing to fail over from
                if state.get("leader") != dead_leader:
                    # someone else already won this failover: the leader
                    # we judged dead is not the map's leader any more. Our
                    # detector's DEAD verdict is about the OLD leader —
                    # promoting on it now would depose the fresh winner
                    # (the dueling-promotion bug). Give the new leader a
                    # fresh grace period and stand down.
                    if self._detector is not None:
                        self._detector.reset()
                    return
                # rank live candidates by (catch-up, node_id); probes run
                # on this thread — promotion is allowed to block
                my_key = (self._catchup_total(), self.node_id)
                best_key = my_key
                peer_epoch_max = 0
                for nid, info in state.get("nodes", {}).items():
                    if nid in (dead_leader, self.node_id):
                        continue
                    addr = info.get("liveness_addr")
                    if not addr:
                        continue
                    res = probe_liveness(addr, max(0.05, self.suspect_s / 2))
                    if res is None:
                        continue  # dead or partitioned: not a candidate
                    epoch, catchup = res
                    peer_epoch_max = max(peer_epoch_max, epoch)
                    if (catchup, nid) > best_key:
                        best_key = (catchup, nid)
                if best_key == my_key:
                    new_epoch = max(state["epoch"], self.current_epoch(),
                                    peer_epoch_max) + 1
                    try:
                        # expect_epoch pins the CAS to the map we ranked
                        # against: if anyone won while our probes ran,
                        # we lose here and stand down on the next pass —
                        # never promote over a freshly seated leader
                        won = self.cluster.try_promote(
                            self.node_id, new_epoch,
                            expect_epoch=state["epoch"])
                    except Exception:
                        logger.exception("try_promote failed; retrying")
                        won = False
                    if won:
                        self._become_leader(new_epoch, self._read_map(),
                                            deposed=dead_leader)
                        return
                # not best, or lost the CAS: give the winner a beat, then
                # re-read — a new leader resets our detector via the watch
                # loop and this loop exits on its next pass
                self._stop.wait(max(0.05, self.suspect_s / 2))
        finally:
            self._promoting.clear()

    def _become_leader(self, new_epoch: int, map_state: Dict[str, Any],
                       deposed: Optional[str]) -> None:
        t0 = time.time()
        # epoch on disk BEFORE the first write: a crash-restart between
        # promotion and the first append must come back knowing it led
        persist_epoch(self.broker, new_epoch, self.node_id)
        targets = [
            info.get("replica_addr")
            for nid, info in map_state.get("nodes", {}).items()
            if nid not in (self.node_id, deposed) and info.get("replica_addr")
        ]
        with self._lock:
            self._role = "leader"
            self._epoch = new_epoch
            if not self.partition_leadership:
                self._leader_broker = ReplicatedBroker(
                    self.broker, targets, epoch=new_epoch,
                    allow_no_targets=True, gate=self._gate,
                    heartbeat_s=self.heartbeat_s)
            # partition mode: the node-level leader is the CONTROLLER
            # only — data-plane replication stays per-partition through
            # the existing PartitionReplicatedBroker; the dead node's
            # partitions fail over via the orphan sweep, not here
        if self._replica_server is not None:
            # the mirror listener stays up purely as a fencing endpoint:
            # raising its floor turns any stale leader's connect into an
            # F frame carrying our epoch
            self._replica_server.note_epoch(new_epoch)
            if not self.partition_leadership:
                # (partition mode keeps peer streams up: many concurrent
                # leaders mirroring here is the normal state)
                self._replica_server.drop_connections()
        if deposed is not None:
            # the dead leader leaves the map: it must re-register (after
            # re-seeding) to rejoin, and until then the reconcile loop
            # won't gate the acks=all watermark on a corpse
            try:
                self.cluster.deregister(deposed)
            except Exception:
                logger.exception("deregistering deposed leader failed")
        logger.warning(
            "ha: %s PROMOTED to leader at epoch %d (deposed=%s, "
            "followers=%s)", self.node_id, new_epoch, deposed, targets)
        TRACER.instant("ha.promoted", cat="ha",
                       args={"node": self.node_id, "epoch": new_epoch,
                             "deposed": deposed, "followers": len(targets)})
        self._record("promoted", {"epoch": new_epoch, "deposed": deposed,
                                  "followers": targets,
                                  "elapsed_s": round(time.time() - t0, 4)})
        self.flight.auto_dump("ha_promotion")

    def _step_down(self, cluster_epoch: int,
                   new_leader: Optional[str]) -> None:
        with self._lock:
            if self._role != "leader":
                return
            # partition mode: losing the CONTROLLER role is routine (an
            # isolated-then-healed controller rejoins as a follower);
            # data-plane writes stay governed by per-partition leases,
            # which the map reconcile fences individually
            self._role = ("follower" if self.partition_leadership
                          else "deposed")
            # the fenced ReplicatedBroker STAYS the facade: reads keep
            # working (re-seeding needs the log) but every write raises
            # FencedError with the epoch — a deposed leader must fail
            # loud, not quietly fork a local-only log
            lb = self._leader_broker
        if lb is not None:
            lb.set_fenced(cluster_epoch)
            lb.stop_replication()
        logger.error(
            "ha: %s DEPOSED (cluster moved to epoch %d, leader %s) — "
            "writes refused; re-seed and restart as follower",
            self.node_id, cluster_epoch, new_leader)
        TRACER.instant("ha.deposed", cat="ha",
                       args={"node": self.node_id, "epoch": cluster_epoch,
                             "new_leader": new_leader})
        self._record("deposed", {"cluster_epoch": cluster_epoch,
                                 "new_leader": new_leader})
        self.flight.auto_dump("ha_deposed")

    # -------------------------------------------------------------- reconcile

    def _watch_loop(self) -> None:
        poll = max(0.05, self.suspect_s / 2)
        while not self._stop.is_set():
            self._stop.wait(poll)
            if self._stop.is_set():
                return
            try:
                # one incremental pull per tick: O(1) when the map did
                # not move; assignment side effects fire from the index
                # listener for exactly the changed entries
                self._sync_index()
            except ClusterUnreachableError:
                continue
            except Exception:
                logger.exception("cluster map read failed")
                continue
            leader = self._index.leader()
            cluster_epoch = self._index.epoch()
            with self._lock:
                role, epoch, lb = self._role, self._epoch, self._leader_broker
            if self.partition_leadership and role != "dead":
                try:
                    self._reconcile_partitions()
                    if role == "leader":
                        # controller duties: new topics get leaders
                        self._assign_unassigned()
                    self._shed_tick += 1
                    if self._shed_tick % 4 == 0:
                        # anti-entropy: re-spread onto healed peers (every
                        # few ticks — a shed is a drain handover and may
                        # block this loop for up to ~4x suspect_s)
                        self._shed_pass()
                except Exception:
                    logger.exception("partition reconcile failed")
            if role == "leader":
                if (cluster_epoch > epoch
                        or (leader is not None and leader != self.node_id)):
                    self._step_down(cluster_epoch, leader)
                    continue
                if lb is not None:
                    if lb.fenced_by is not None:
                        self._step_down(lb.fenced_by, leader)
                        continue
                    # adopt newly registered followers
                    for nid, info in self._index.nodes().items():
                        if nid == self.node_id or not info.get("replica_addr"):
                            continue
                        lb.add_target(info["replica_addr"])
            elif role == "follower":
                if leader != self._last_leader_seen:
                    # failover completed (or first leader appeared): judge
                    # the NEW leader with a fresh grace period
                    self._last_leader_seen = leader
                    if self._detector is not None:
                        self._detector.reset()
                if self._replica_server is not None:
                    # learn the cluster epoch as a fencing floor even
                    # before the new leader's first mirror connect
                    self._replica_server.note_epoch(cluster_epoch)

    # ------------------------------------------------------------------- obs

    def _record(self, kind: str, detail: Dict[str, Any]) -> None:
        try:
            self.flight.record_event({
                "t": time.time(), "node": self.node_id,
                "kind": f"ha.{kind}", **detail,
            })
        except Exception:
            pass


class NodeBroker(Broker):
    """Stable Broker handle over a node's CURRENT role facade.

    A runtime embedding an HA node (``server.py`` with
    ``SWARMDB_HA_NODE_ID`` set) holds one broker reference for its whole
    life, but the node's write surface changes at every role transition:
    plain local broker as follower, :class:`ReplicatedBroker` (acks=all +
    fencing) as leader. This proxy re-reads :attr:`HANode.broker_facade`
    per call, so a promotion/deposal takes effect on the very next
    operation — including :class:`~swarmdb_tpu_torch.broker.base.FencedError`
    on a deposed leader's appends."""

    def __init__(self, node: "HANode") -> None:
        self.node = node

    def _b(self) -> Broker:
        return self.node.broker_facade

    def create_topic(self, name, num_partitions,
                     retention_ms=7 * 24 * 3600 * 1000):
        return self._b().create_topic(name, num_partitions,
                                      retention_ms=retention_ms)

    def list_topics(self):
        return self._b().list_topics()

    def create_partitions(self, name, new_total):
        return self._b().create_partitions(name, new_total)

    def append(self, topic, partition, value, key=None, timestamp=None):
        return self._b().append(topic, partition, value, key=key,
                                timestamp=timestamp)

    def fetch(self, topic, partition, offset, max_records=256):
        return self._b().fetch(topic, partition, offset, max_records)

    def end_offset(self, topic, partition):
        return self._b().end_offset(topic, partition)

    def begin_offset(self, topic, partition):
        return self._b().begin_offset(topic, partition)

    def wait_for_data(self, topic, partition, offset, timeout_s):
        return self._b().wait_for_data(topic, partition, offset, timeout_s)

    def commit_offset(self, group, topic, partition, offset):
        return self._b().commit_offset(group, topic, partition, offset)

    def committed_offset(self, group, topic, partition):
        return self._b().committed_offset(group, topic, partition)

    def trim_older_than(self, topic, cutoff_ts):
        return self._b().trim_older_than(topic, cutoff_ts)

    def durable_offset(self, topic, partition):
        return self._b().durable_offset(topic, partition)

    def wait_durable(self, topic, partition, offset, timeout_s):
        return self._b().wait_durable(topic, partition, offset, timeout_s)

    def flush(self):
        return self._b().flush()

    def close(self):
        # the node owns its broker's lifecycle (stop() leaves it open for
        # the caller; kill() closes it) — closing through the proxy would
        # tear the log out from under an active role machine
        pass

    def healthy(self):
        try:
            return self._b().healthy()
        except Exception:
            return False


def main(argv: Optional[List[str]] = None) -> int:
    """Standalone HA node (the compose follower service) / probe CLI."""
    import argparse

    ap = argparse.ArgumentParser(description="swarmdb HA node")
    ap.add_argument("--node-id", default=None)
    ap.add_argument("--role", choices=("follower", "leader"),
                    default="follower")
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--cluster", default=None,
                    help="path to the shared cluster-map JSON file")
    ap.add_argument("--listen", default="0.0.0.0:9444",
                    help="host:port for the replica mirror listener")
    ap.add_argument("--liveness", default="0.0.0.0:9445",
                    help="host:port for the liveness probe endpoint")
    ap.add_argument("--data", default="0.0.0.0:9446",
                    help="host:port for the client data plane "
                         "(port 'off' disables it)")
    ap.add_argument("--advertise-host", default=None,
                    help="hostname peers should dial (default: $HOSTNAME)")
    ap.add_argument("--broker", choices=("native", "local"), default="native")
    ap.add_argument("--sync-interval-ms", type=int, default=5)
    ap.add_argument("--probe", default=None, metavar="HOST:PORT",
                    help="healthcheck mode: probe a liveness endpoint and "
                         "exit 0 iff it answers")
    args = ap.parse_args(argv)

    if args.probe:
        res = probe_liveness(args.probe, timeout_s=2.0)
        if res is None:
            print(json.dumps({"ok": False, "target": args.probe}))
            return 1
        print(json.dumps({"ok": True, "target": args.probe,
                          "epoch": res[0], "catchup": res[1]}))
        return 0

    if not (args.node_id and args.log_dir and args.cluster):
        ap.error("--node-id, --log-dir and --cluster are required "
                 "(unless --probe)")
    logging.basicConfig(level=logging.INFO)
    # this process IS the node: trace exports, flight-dump filenames and
    # propagated trace contexts all carry its id (obs/propagate.node_id)
    os.environ.setdefault("SWARMDB_NODE_ID", args.node_id)

    from .cluster import FileClusterMap

    if args.broker == "native":
        from ..broker.native import NativeBroker

        broker: Broker = NativeBroker(log_dir=args.log_dir,
                                      sync_interval_ms=args.sync_interval_ms)
    else:
        from ..broker.local import LocalBroker

        broker = LocalBroker(
            snapshot_path=os.path.join(args.log_dir, "snapshot.json"))

    host, _, port = args.listen.rpartition(":")
    lhost, _, lport = args.liveness.rpartition(":")
    _, _, dport = args.data.rpartition(":")
    data_port = None if dport == "off" else int(dport)
    advertise = (args.advertise_host
                 or os.environ.get("SWARMDB_HA_ADVERTISE_HOST")
                 or (host if host not in ("", "0.0.0.0") else
                     __import__("socket").gethostname()))
    node = HANode(
        args.node_id, broker, FileClusterMap(args.cluster),
        listen_host=host or "0.0.0.0", replica_port=int(port),
        liveness_port=int(lport), data_port=data_port,
        advertise_host=advertise, log_dir=args.log_dir,
        # deployment entry point = cluster mode: partition leadership
        # defaults ON here (SWARMDB_HA_PARTITION_LEADERSHIP overrides)
        cluster_mode=True,
    ).start(role=args.role)
    data = (f"{node._data_plane.host}:{node._data_plane.port}"
            if node._data_plane is not None else "off")
    print(f"HA_NODE_READY {args.node_id} "
          f"replica={node._replica_server.host}:{node._replica_server.port} "
          f"liveness={node._liveness.host}:{node._liveness.port} "
          f"data={data}",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        node.stop()
        broker.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
