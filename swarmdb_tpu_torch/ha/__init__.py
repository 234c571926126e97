"""HA control plane: failure detection, fenced promotion, client failover.

A copy of ``swarmdb_tpu/ha/`` for the port: the same classes, wire frames
and cluster-map format, so a port node and a JAX-package node read each
other's maps and replication streams.

Turns the leader/follower replication of ``broker/replica.py`` into an
automatically recovering cluster. Pieces:

- ``cluster``  — the cluster map (leader, fencing epoch, node registry)
  with CAS promotion; in-memory and shared-file implementations.
- ``detector`` — heartbeat + out-of-band-probe failure detector with a
  lock-free, I/O-free evaluation path (swarmlint SWL601/SWL602).
- ``node``     — HANode: the per-process role machine (follower ⇄
  leader), promotion coordinator, and standalone CLI.
- ``client``   — ClusterBroker: clients re-point to the new leader via
  the cluster map; writes fail retryably mid-failover, reads ride
  through.
- ``dataplane`` — the Broker surface served over TCP, so cross-process
  clients write through the leader node's acks=all + fencing facade
  (never a second engine handle over its log dir).
- ``chaos``    — deterministic fault injection (kill / partition /
  delay on a scripted schedule, plus dueling-promotion injection) for
  the tests and ``chip_smoke.py``'s ``ha`` phase.
- ``partition`` — partition-level leadership: leases,
  partition-scoped fencing + replication, quorum durability, spread
  policy. Enabled per node via ``partition_leadership=True``; the
  DEFAULT for cluster-mode entry points (node CLI,
  api/server.py), with ``SWARMDB_HA_PARTITION_LEADERSHIP`` overriding.
- ``lindex``   — LeadershipIndex: incrementally-maintained
  leadership/orphan views off the cluster map's mutation journal, so
  the spread/shed/orphan policies and the serving tier's conversation
  locality pay O(moved partitions) per decision, not O(all).
"""

from .chaos import ChaosHarness, build_local_cluster, wait_until
from .client import ClusterBroker, data_plane_opener
from .cluster import (ClusterMap, FileClusterMap, InMemoryClusterMap,
                      NodeInfo, parse_tp_key, persist_epoch,
                      read_log_epoch, tp_key)
from .dataplane import DataPlaneServer, RemoteBroker
from .detector import (DetectorState, FailureDetector, LivenessServer,
                       probe_ends, probe_liveness)
from .lindex import LeadershipIndex
from .node import ClusterUnreachableError, HANode, NodeBroker
from .partition import (PartitionLeases, PartitionReplicatedBroker,
                        spread_score)

__all__ = [
    "ChaosHarness", "build_local_cluster", "wait_until",
    "ClusterBroker", "data_plane_opener",
    "DataPlaneServer", "RemoteBroker",
    "ClusterMap", "FileClusterMap", "InMemoryClusterMap", "NodeInfo",
    "persist_epoch", "read_log_epoch", "tp_key", "parse_tp_key",
    "DetectorState", "FailureDetector", "LivenessServer", "probe_liveness",
    "probe_ends",
    "ClusterUnreachableError", "HANode", "NodeBroker",
    "LeadershipIndex",
    "PartitionLeases", "PartitionReplicatedBroker", "spread_score",
]
