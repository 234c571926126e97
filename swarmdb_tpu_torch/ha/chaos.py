"""Deterministic fault injection for the HA control plane.

The tests and the chip check drive failures through ONE harness so a
scenario is a readable script, every injected fault lands in an event
log (with monotonic stamps, dumpable through the flight recorder), and
"wait for the cluster to converge" is a bounded poll, not a sleep:

    chaos = ChaosHarness()
    chaos.add_node("n0", leader_node)
    ...
    chaos.kill("n0")                       # crash: sockets + broker gone
    chaos.isolate("n1")                    # full partition (both ways,
                                           # control store included)
    chaos.heal("n1")
    chaos.delay("n2", 0.2)                 # inject per-connection latency
    chaos.run_script([(0.5, "kill", "n0")])  # scripted schedule

Faults map onto :class:`~swarmdb_tpu_torch.ha.node.HANode` hooks:

- ``kill`` — abrupt death: servers torn down, broker closed, no
  handover (the crash the failure detector exists for).
- ``isolate``/``heal`` — the node's admission gate flips: incoming
  replica/liveness connections are dropped, existing streams cut,
  outgoing replicator connects refused, and the node loses sight of the
  cluster map (so a partitioned minority can never win an epoch).
- ``delay`` — latency injected at the node's admission gate.

``wait_until`` polls a predicate on a short interval against a hard
deadline — the only real sleeping a chaos test does is bounded by the
detector thresholds under test.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..broker.base import Broker
from ..obs.flight import FlightRecorder
from .client import ClusterBroker
from .cluster import InMemoryClusterMap
from .node import HANode
from ..utils.sync import make_lock

__all__ = ["ChaosHarness", "build_local_cluster", "wait_until"]


def wait_until(predicate: Callable[[], bool], timeout_s: float,
               poll_s: float = 0.01, what: str = "condition") -> None:
    """Bounded convergence wait; raises AssertionError on deadline."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(poll_s)
    raise AssertionError(f"timed out after {timeout_s:.1f}s waiting for "
                         f"{what}")


def build_local_cluster(node_ids: Sequence[str], *,
                        broker_factory: Optional[
                            Callable[[str], Broker]] = None,
                        suspect_s: float = 0.3,
                        dead_s: float = 0.6,
                        heartbeat_s: float = 0.05,
                        refresh_s: float = 0.05,
                        partition_leadership: Optional[bool] = None,
                        flight: Optional[FlightRecorder] = None):
    """One-call in-process cluster for tests and the chip check.

    Builds an :class:`InMemoryClusterMap`, one :class:`HANode` per id
    (first id bootstraps as leader, the rest follow), and a
    :class:`ClusterBroker` whose opener resolves a node id straight to
    that node's live ``broker_facade`` (``owns_inner=False`` — the nodes
    own their brokers). Returns ``(harness, cluster, client)``; callers
    tear everything down with ``harness.stop()`` + ``client.close()``
    and close the per-node brokers they asked ``broker_factory`` to
    make.

    Detector thresholds default tight (suspect 0.3 s / dead 0.6 s,
    heartbeat 0.05 s) so a scripted leader-kill converges in well under a
    second of real time — the only sleeping a chaos scenario does.
    """
    if broker_factory is None:
        from ..broker.local import LocalBroker

        broker_factory = lambda node_id: LocalBroker()  # noqa: E731
    harness = ChaosHarness(flight=flight)
    cluster = InMemoryClusterMap()
    for i, node_id in enumerate(node_ids):
        node = HANode(
            node_id, broker_factory(node_id), cluster,
            suspect_s=suspect_s, dead_s=dead_s, heartbeat_s=heartbeat_s,
            partition_leadership=partition_leadership,
            flight=harness.flight,
        )
        harness.add_node(node_id, node)
        node.start(role="leader" if i == 0 else "follower")
    from .node import NodeBroker

    # NodeBroker (per-call facade re-read), NOT the facade object itself:
    # a chaos-killed node must surface as ConnectionError on the very
    # next op — a cached facade object would keep taking writes into a
    # dead node's log (exactly what a dead process's sockets cannot do)
    client = ClusterBroker(
        cluster,
        lambda node_id, info: NodeBroker(harness.nodes[node_id]),
        refresh_s=refresh_s, owns_inner=False)
    return harness, cluster, client


class ChaosHarness:
    def __init__(self, flight: Optional[FlightRecorder] = None) -> None:
        self.nodes: Dict[str, HANode] = {}
        self.flight = flight or FlightRecorder()
        self.events: List[Dict[str, Any]] = []
        self._events_lock = make_lock("ha.chaos.ChaosHarness._events_lock")
        self._timers: List[threading.Timer] = []
        self._t0 = time.monotonic()

    # ------------------------------------------------------------- topology

    def add_node(self, node_id: str, node: HANode) -> HANode:
        self.nodes[node_id] = node
        return node

    def _log(self, action: str, target: str, **detail: Any) -> None:
        ev = {"t_mono": round(time.monotonic() - self._t0, 4),
              "action": action, "target": target, **detail}
        with self._events_lock:
            self.events.append(ev)
        self.flight.record_event({"kind": f"chaos.{action}",
                                  "node": target, **detail})

    # --------------------------------------------------------------- faults

    def kill(self, node_id: str) -> None:
        self._log("kill", node_id)
        self.nodes[node_id].kill()

    def isolate(self, node_id: str) -> None:
        self._log("isolate", node_id)
        self.nodes[node_id].set_isolated(True)

    def heal(self, node_id: str) -> None:
        self._log("heal", node_id)
        self.nodes[node_id].set_isolated(False)

    def delay(self, node_id: str, seconds: float) -> None:
        self._log("delay", node_id, seconds=seconds)
        self.nodes[node_id].set_delay(seconds)

    def duel_promotion(self, topic: str, partition: int) -> Dict[str, Any]:
        """Dueling-promotion injection: every LIVE node races
        a per-partition CAS for the same partition at the same ranked-at
        epoch, all released simultaneously — the per-assignment
        ``expect_epoch`` CAS must seat exactly ONE winner per
        partition-epoch. Returns ``{"winners": [...], "epoch": int}``."""
        live = [(nid, n) for nid, n in self.nodes.items()
                if n.role != "dead"]
        if not live:
            return {"winners": [], "epoch": None}
        cluster = live[0][1].cluster
        from .cluster import tp_key

        a = cluster.read().get("assignments", {}).get(
            tp_key(topic, partition), {"epoch": 0})
        ranked_at = int(a.get("epoch", 0))
        start = threading.Barrier(len(live))
        winners: List[str] = []
        winners_lock = make_lock("ha.chaos.ChaosHarness.duel_promotion.winners_lock")

        def race(nid: str) -> None:
            start.wait()
            if cluster.try_promote_partition(
                    topic, partition, nid, ranked_at + 1,
                    expect_epoch=ranked_at):
                with winners_lock:
                    winners.append(nid)

        threads = [threading.Thread(target=race, args=(nid,),
                                    daemon=True) for nid, _ in live]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=5.0)
        self._log("duel", f"{topic}:{partition}", winners=list(winners),
                  epoch=ranked_at + 1)
        return {"winners": winners, "epoch": ranked_at + 1}

    # ------------------------------------------------------------ scheduling

    def schedule(self, at_s: float, action: str, node_id: str,
                 *args: Any) -> threading.Timer:
        """Fire ``action`` (kill/isolate/heal/delay) ``at_s`` seconds from
        now. Timers are plain wall scheduling — the DETERMINISM is in the
        single-threaded application of each fault plus the event log, not
        in pretending the OS scheduler away."""
        fn = getattr(self, action)
        t = threading.Timer(at_s, fn, args=(node_id, *args))
        t.daemon = True
        t.start()
        self._timers.append(t)
        return t

    def run_script(self,
                   script: Sequence[Tuple[float, str, str]]) -> None:
        """Schedule a whole scenario: [(at_s, action, node_id), ...]."""
        for at_s, action, node_id in script:
            self.schedule(at_s, action, node_id)

    # -------------------------------------------------------------- teardown

    def stop(self) -> None:
        for t in self._timers:
            t.cancel()
        for node in self.nodes.values():
            try:
                node.stop()
            except Exception:
                pass

    def dump(self) -> Dict[str, Any]:
        with self._events_lock:
            events = list(self.events)
        return {"chaos_events": events, "flight": self.flight.dump("chaos")}
