"""LeadershipIndex + cluster-map mutation journal, the port's copy
(``swarmdb_tpu_torch/ha/lindex.py``, ``ha/cluster.py``): the cases of
``tests/test_lindex.py``, plus the detector's verdicts and the liveness
probes between the packages.

The scaled drills (5-9 nodes, hundreds of partitions) require the
spread/shed/orphan-sweep policies to stop scanning the full assignment
table per decision. Contracts pinned here:

- ``ClusterMap.read_changes``: O(1) no-change ticks, per-key deltas
  covered by the bounded journal, full resync beyond it — for both map
  implementations;
- ``LeadershipIndex``: leadership counts / own-key sets / orphan set
  maintained incrementally, with the change-listener stream firing
  exactly once per applied change;
- the headline regression: after seeding a 512-partition index, ONE
  leadership move costs O(moved) work units — not O(partitions) — and a
  node death costs O(victim's partitions).
"""

import pytest

from swarmdb_tpu_torch.ha import (FileClusterMap, InMemoryClusterMap,
                            LeadershipIndex, NodeInfo, tp_key)

PARTS = 512
NODES = ["n0", "n1", "n2"]


def _seed(cmap, parts=PARTS, nodes=NODES):
    for i, nid in enumerate(nodes):
        cmap.register(NodeInfo(node_id=nid, replica_addr=f"h:{9000 + i}",
                               liveness_addr=f"h:{9100 + i}"))
    for p in range(parts):
        assert cmap.try_promote_partition(
            "t", p, nodes[p % len(nodes)], 1, expect_epoch=0)


@pytest.fixture(params=["memory", "file"])
def cmap(request, tmp_path):
    if request.param == "memory":
        return InMemoryClusterMap()
    return FileClusterMap(str(tmp_path / "cluster.json"))


def test_read_changes_contract(cmap):
    # first observation: full resync
    _seed(cmap, parts=8)
    d = cmap.read_changes(-1)
    assert d["changed"] and d["full"]
    assert len(d["state"]["assignments"]) == 8
    v = d["version"]
    # nothing moved: O(1) no-change shape
    d = cmap.read_changes(v)
    assert d == {"version": v, "changed": False}
    # one move: the delta carries exactly that key
    assert cmap.try_promote_partition("t", 3, "n1", 2, expect_epoch=1)
    d = cmap.read_changes(v)
    assert d["changed"] and not d["full"]
    assert set(d["assignments"]) == {tp_key("t", 3)}
    assert d["assignments"][tp_key("t", 3)] == {"leader": "n1",
                                                "epoch": 2}
    assert d["removed"] == []
    # a node change bumps the version but ships no assignment entries
    cmap.deregister("n2")
    d2 = cmap.read_changes(d["version"])
    assert d2["changed"] and not d2["full"]
    assert d2["assignments"] == {} and "n2" not in d2["nodes"]


def test_read_changes_overflow_resyncs(cmap):
    from swarmdb_tpu_torch.ha import cluster as cluster_mod

    _seed(cmap, parts=4)
    v = cmap.read_changes(-1)["version"]
    # push the journal past its cap: the old observer must get a FULL
    # resync, never a silently-truncated delta
    n = cluster_mod.CHANGELOG_CAP + 8
    epoch = 1
    for _ in range(n):
        epoch += 1
        assert cmap.try_promote_partition("t", 0, "n0", epoch,
                                          expect_epoch=epoch - 1)
    d = cmap.read_changes(v)
    assert d["changed"] and d["full"]
    assert d["state"]["assignments"][tp_key("t", 0)]["epoch"] == epoch


def test_index_incremental_views_and_orphans():
    cmap = InMemoryClusterMap()
    _seed(cmap, parts=12, nodes=NODES)
    idx = LeadershipIndex()
    seen = []
    idx.add_listener(lambda key, entry: seen.append((key, entry)))
    res = idx.sync(cmap)
    assert res.changed and res.full
    assert len(seen) == 12  # full resync replays every key
    counts = idx.leadership_counts()
    assert sum(counts.values()) == 12 and set(counts) == set(NODES)
    assert idx.orphan_count() == 0
    assert idx.keys_led_by("n1") == {
        tp_key("t", p) for p in range(12) if p % 3 == 1}

    # a move fires the listener exactly once, for exactly that key
    seen.clear()
    a = idx.entry(tp_key("t", 4))
    assert cmap.try_promote_partition("t", 4, "n2", a["epoch"] + 1,
                                      expect_epoch=a["epoch"])
    assert idx.sync(cmap).changed
    assert seen == [(tp_key("t", 4), {"leader": "n2",
                                      "epoch": a["epoch"] + 1})]
    assert tp_key("t", 4) in idx.keys_led_by("n2")
    assert tp_key("t", 4) not in idx.keys_led_by("n1")

    # node death: its keys become orphans, O(victim's partitions)
    cmap.deregister("n2")
    idx.sync(cmap)
    assert idx.orphan_count() == len(idx.keys_led_by("n2"))
    assert {k for k, _ in idx.orphans()} == idx.keys_led_by("n2")
    # re-registration heals the orphan set
    cmap.register(NodeInfo(node_id="n2"))
    idx.sync(cmap)
    assert idx.orphan_count() == 0
    # no-change tick is a no-op
    assert not idx.sync(cmap).changed


def test_one_move_costs_o_moved_not_o_partitions():
    """The headline: per-decision work is pinned
    to O(moved partitions) on a hundreds-of-partitions index."""
    cmap = InMemoryClusterMap()
    _seed(cmap)  # 512 partitions
    idx = LeadershipIndex()
    idx.sync(cmap)
    seeded = idx.reset_work_counter()
    assert seeded >= PARTS  # the one-time full resync IS O(partitions)

    # one leadership move: apply + queries must not rescan the table
    a = idx.entry(tp_key("t", 100))
    assert cmap.try_promote_partition("t", 100, "n1", a["epoch"] + 1,
                                      expect_epoch=a["epoch"])
    idx.sync(cmap)
    idx.leadership_counts()
    idx.orphans()
    idx.keys_led_by("n1")
    assert idx.reset_work_counter() <= 4, (
        "a single move must cost O(moved) index work, not O(partitions)")

    # ten no-change ticks: zero assignment entries visited
    for _ in range(10):
        idx.sync(cmap)
        idx.leadership_counts()
    assert idx.reset_work_counter() == 0

    # a node death costs O(victim's partitions)
    victim_keys = len(idx.keys_led_by("n2"))
    cmap.deregister("n2")
    idx.sync(cmap)
    idx.orphans()
    assert idx.reset_work_counter() <= victim_keys + 4


def test_index_without_journal_falls_back_to_full():
    class BareMap:
        """A ClusterMap-shaped object with no read_changes."""

        def __init__(self):
            self.state = {"epoch": 1, "leader": "n0",
                          "nodes": {"n0": {}},
                          "assignments": {tp_key("t", 0):
                                          {"leader": "n0", "epoch": 1}}}

        def read(self):
            import json

            return json.loads(json.dumps(self.state))

    idx = LeadershipIndex()
    res = idx.sync(BareMap())
    assert res.changed and res.full
    assert idx.leader_of(tp_key("t", 0)) == "n0"


# ------------------------------------------------ the failure detector


def test_detector_verdicts_follow_signal_age():
    """The verdict path is arithmetic over the freshest signal's age:
    ALIVE under suspect_s, SUSPECT under dead_s, DEAD beyond; a beat or a
    reset restores ALIVE. The same stamps give the JAX detector's
    verdicts."""
    from swarmdb_tpu.ha.detector import FailureDetector as JaxDetector
    from swarmdb_tpu_torch.ha import DetectorState, FailureDetector

    port = FailureDetector(lambda: None, suspect_s=1.0, dead_s=2.0)
    jax = JaxDetector(lambda: None, suspect_s=1.0, dead_s=2.0)
    base = port._last_beat
    for det in (port, jax):
        det._last_beat = det._last_probe_ok = base
    for age, want in ((0.0, "ALIVE"), (0.99, "ALIVE"), (1.0, "SUSPECT"),
                      (1.99, "SUSPECT"), (2.0, "DEAD"), (60.0, "DEAD")):
        assert port._evaluate(base + age) is DetectorState[want]
        assert jax._evaluate(base + age).name == want
    # a fresh probe answer counts as much as a beat
    port._last_probe_ok = base + 50.0
    assert port._evaluate(base + 50.5) is DetectorState.ALIVE
    port.reset()
    assert port.signal_age_s() < 1.0
    assert set(port.status()) == {"state", "state_code", "signal_age_s",
                                  "suspect_s", "dead_s"}


def test_detector_threads_go_dead_on_silence_and_recover():
    """Started, with a target that never answers, the detector walks
    ALIVE -> SUSPECT -> DEAD through its hook; a beat brings it back."""
    import threading
    import time

    from swarmdb_tpu_torch.ha import DetectorState, FailureDetector
    from swarmdb_tpu_torch.ha.chaos import wait_until

    seen = []
    lock = threading.Lock()

    def hook(old, new):
        with lock:
            seen.append(new)

    det = FailureDetector(lambda: "127.0.0.1:1", suspect_s=0.4, dead_s=0.8,
                          on_state=hook).start()
    try:
        wait_until(lambda: det.state is DetectorState.DEAD, 30.0,
                   what="dead verdict")
        with lock:
            assert seen[:2] == [DetectorState.SUSPECT, DetectorState.DEAD]

        def beating():
            det.beat()
            return det.state is DetectorState.ALIVE

        wait_until(beating, 30.0, what="recovery on beats")
        time.sleep(0.01)
    finally:
        det.stop()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_liveness_probes_cross_packages(server_pkg):
    """``?`` and ``#`` probes of either package read the other's
    liveness endpoint; a refused gate reads as dead."""
    from swarmdb_tpu.ha import detector as jax_det
    from swarmdb_tpu_torch.ha import detector as port_det

    server_mod, client_mod = ((port_det, jax_det) if server_pkg == "port"
                              else (jax_det, port_det))
    open_gate = [True]
    srv = server_mod.LivenessServer(
        lambda: 4, lambda: 17, get_ends=lambda: {"t": {"0": 17}},
        gate=lambda: open_gate[0]).start()
    try:
        assert client_mod.probe_liveness(srv.addr, 5.0) == (4, 17)
        assert client_mod.probe_ends(srv.addr, 5.0) == {
            "epoch": 4, "catchup": 17, "ends": {"t": {"0": 17}}}
        open_gate[0] = False
        assert client_mod.probe_liveness(srv.addr, 5.0) is None
        assert client_mod.probe_ends(srv.addr, 5.0) is None
    finally:
        srv.stop()
    assert client_mod.probe_liveness(srv.addr, 1.0) is None
