"""The port's runtime lock sanitizer against the JAX package's.

Every case of tests/test_lockcheck.py runs through both packages'
factories (``utils/sync.py``) and sanitizers (``obs/lockcheck.py``): the
same interleavings give the same cycles, sites and report keys. Each
fixture resets both registries before and after, so no deliberately
provoked cycle outlives its test.
"""

import json
import threading
import time

import pytest

from swarmdb_tpu.obs import lockcheck as jax_lockcheck
from swarmdb_tpu.utils import sync as jax_sync
from swarmdb_tpu_torch.obs import lockcheck as torch_lockcheck
from swarmdb_tpu_torch.utils import sync as torch_sync

PKGS = {"jax": (jax_sync, jax_lockcheck), "torch": (torch_sync,
                                                    torch_lockcheck)}


@pytest.fixture()
def lockcheck_on(monkeypatch, tmp_path):
    monkeypatch.setenv("SWARMDB_LOCKCHECK", "1")
    monkeypatch.setenv("SWARMDB_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("SWARMDB_NODE_ID", "testnode")
    for _, lc in PKGS.values():
        lc.registry().reset()
    yield PKGS
    for _, lc in PKGS.values():
        lc.registry().reset()


def _run_threads(*fns, names=None):
    for i, fn in enumerate(fns):
        t = threading.Thread(target=fn,
                             name=(names[i] if names else None))
        t.start()
        t.join(10.0)
        assert not t.is_alive()


def _ab_ba(sync, site_a, site_b, names=None):
    a = sync.make_lock(site_a)
    b = sync.make_lock(site_b)

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    _run_threads(forward, backward, names=names)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_factory_returns_plain_threading_types_when_off(pkg, monkeypatch):
    sync, _ = PKGS[pkg]
    monkeypatch.delenv("SWARMDB_LOCKCHECK", raising=False)
    assert type(sync.make_lock("x")) is type(threading.Lock())
    assert type(sync.make_rlock("x")) is type(threading.RLock())
    assert type(sync.make_condition("x")) is threading.Condition


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_factory_returns_checked_types_when_on(pkg, lockcheck_on):
    sync, lc = PKGS[pkg]
    assert isinstance(sync.make_lock("x"), lc.CheckedLock)
    assert isinstance(sync.make_rlock("x"), lc.CheckedRLock)
    assert isinstance(sync.make_condition("x"), lc.CheckedCondition)


def test_ab_ba_reports_the_same_cycle_in_both(lockcheck_on, tmp_path):
    """A real AB-BA on two threads: both packages report one cycle naming
    both sites and both threads, with per-edge stacks, the same report
    keys, and a dump on disk."""
    reports = {}
    for pkg, (sync, lc) in PKGS.items():
        _ab_ba(sync, "backend.engine.Engine._cv",
               "broker.local.LocalBroker._meta_lock", names=["fwd", "bwd"])
        cycles = lc.registry().cycles()
        assert len(cycles) == 1, pkg
        assert set(cycles[0]["sites"]) == {
            "backend.engine.Engine._cv",
            "broker.local.LocalBroker._meta_lock"}
        assert {e["thread"] for e in cycles[0]["edges"]} == {"fwd", "bwd"}
        assert all(e["stack"] for e in cycles[0]["edges"])
        reports[pkg] = lc.registry().report()
        dump = json.loads((tmp_path / "lockcheck_testnode.json").read_text())
        assert len(dump["cycles"]) == 1
        (tmp_path / "lockcheck_testnode.json").unlink()
    assert set(reports["jax"]) == set(reports["torch"])
    assert set(reports["jax"]["cycles"][0]) == set(
        reports["torch"]["cycles"][0])
    assert set(reports["jax"]["edges"][0]) == set(
        reports["torch"]["edges"][0])
    assert sorted(reports["jax"]["cycles"][0]["sites"]) == sorted(
        reports["torch"]["cycles"][0]["sites"])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_same_order_twice_is_not_a_cycle(pkg, lockcheck_on):
    sync, lc = PKGS[pkg]
    a = sync.make_lock("s.A.a")
    b = sync.make_lock("s.A.b")
    for _ in range(3):
        with a:
            with b:
                pass
    rep = lc.registry().report()
    assert rep["cycles"] == []
    assert len(rep["edges"]) == 1
    assert rep["edges"][0]["count"] == 3


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_rlock_reentrancy_records_no_self_edge(pkg, lockcheck_on):
    sync, lc = PKGS[pkg]
    r = sync.make_rlock("core.runtime.SwarmDB._lock")
    with r:
        with r:
            pass
    rep = lc.registry().report()
    assert rep["edges"] == [] and rep["cycles"] == []
    assert rep["sites"]["core.runtime.SwarmDB._lock"]["acquires"] == 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_condition_wait_releases_and_reacquires_in_held_model(
        pkg, lockcheck_on):
    sync, lc = PKGS[pkg]
    cv = sync.make_condition("backend.engine.Engine._cv")
    woke = threading.Event()

    def waiter():
        with cv:
            cv.wait(timeout=5.0)
            woke.set()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    with cv:
        cv.notify_all()
    t.join(5.0)
    assert woke.is_set() and not t.is_alive()
    rep = lc.registry().report()
    assert rep["cycles"] == []
    assert rep["sites"]["backend.engine.Engine._cv"]["acquires"] >= 3


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_notifier_during_wait_leaves_no_stale_held_entry(pkg, lockcheck_on):
    sync, lc = PKGS[pkg]
    cv = sync.make_condition("backend.engine.Engine._cv")
    other = sync.make_lock("broker.base.Producer._pending_lock")
    parked = threading.Event()

    def waiter():
        with cv:
            parked.set()
            cv.wait(timeout=5.0)

    t = threading.Thread(target=waiter)
    t.start()
    parked.wait(5.0)
    time.sleep(0.05)
    with cv:
        cv.notify_all()
    t.join(5.0)
    assert not t.is_alive()
    reg = lc.registry()
    assert not reg.holds(getattr(cv, "_lock", cv))
    with other:
        pass
    edges = reg.report()["edges"]
    assert [e for e in edges
            if e["to_site"] == "broker.base.Producer._pending_lock"] == []
    assert reg.cycles() == []


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_contention_and_hold_stats_on_metrics_lines(pkg, lockcheck_on):
    sync, lc = PKGS[pkg]
    lock = sync.make_lock("obs.metrics.HistogramRegistry._lock")
    entered = threading.Event()
    release = threading.Event()

    def holder():
        with lock:
            entered.set()
            release.wait(5.0)

    t = threading.Thread(target=holder)
    t.start()
    entered.wait(5.0)
    blocked = threading.Thread(target=lambda: lock.acquire() or
                               lock.release())
    blocked.start()
    time.sleep(0.05)
    release.set()
    t.join(5.0)
    blocked.join(5.0)
    assert not t.is_alive() and not blocked.is_alive()
    stats = lc.registry().report()["sites"][
        "obs.metrics.HistogramRegistry._lock"]
    assert stats["contended"] >= 1
    assert stats["hold_s"] > 0.0
    text = "\n".join(lc.registry().prometheus_lines())
    assert ('swarmdb_lock_contended_acquires_total'
            '{site="obs.metrics.HistogramRegistry._lock"}') in text
    assert "swarmdb_lock_hold_seconds" in text
    assert "swarmdb_lock_inversion_cycles 0" in text


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_inversion_lands_in_attached_flight_recorder(pkg, lockcheck_on):
    """Each package's flight recorder attaches itself under the flag; the
    inversion lands there as a ``lockcheck.inversion`` instant."""
    if pkg == "jax":
        from swarmdb_tpu.obs.flight import FlightRecorder
    else:
        from swarmdb_tpu_torch.obs.flight import FlightRecorder
    sync, _ = PKGS[pkg]
    flight = FlightRecorder(n_events=16)
    _ab_ba(sync, "p.Q.a", "p.Q.b")
    events = [e for e in flight.events()
              if e.get("kind") == "lockcheck.inversion"]
    assert len(events) == 1
    assert set(events[0]["sites"]) == {"p.Q.a", "p.Q.b"}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_cycle_dedup_by_site_pair(pkg, lockcheck_on):
    sync, lc = PKGS[pkg]
    for _ in range(2):
        _ab_ba(sync, "lanes.L.a", "lanes.L.b")
    assert len(lc.registry().cycles()) == 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_analyzer_lists_lockcheck_dumps_next_to_flight_dumps(
        pkg, lockcheck_on, tmp_path):
    """Each package's analyzer lists a lockcheck dump beside the analyzed
    trace with its cycle count, node and sites."""
    if pkg == "jax":
        from swarmdb_tpu.obs.analyze import _synthetic_trace, analyze_files
    else:
        from swarmdb_tpu_torch.obs.analyze import (_synthetic_trace,
                                                   analyze_files)
    sync, _ = PKGS[pkg]
    _ab_ba(sync, "x.Y.a", "x.Y.b")
    assert (tmp_path / "lockcheck_testnode.json").exists()
    trace_path = tmp_path / "trace.json"
    trace_path.write_text(json.dumps(
        {"traceEvents": _synthetic_trace(5.0, 10.0, 20.0)}))
    dumps = analyze_files([str(trace_path)]).get("lockcheck_dumps")
    assert dumps and dumps[0]["cycles"] == 1
    assert dumps[0]["node"] == "testnode"
    assert sorted(dumps[0]["cycle_sites"][0]) == ["x.Y.a", "x.Y.b"]


def test_port_locks_are_labelled(lockcheck_on):
    """The port's own locks go through the factory with stable sites:
    the device capture lock, taken on a CUDA device object (no card is
    needed to build the lock), is one checked lock per device."""
    import torch

    from swarmdb_tpu_torch.backend import decode_graphs

    dev = torch.device("cuda", 7)
    decode_graphs._DEVICE_LOCKS.pop(7, None)
    try:
        lock = decode_graphs.device_lock(dev)
        assert isinstance(lock, torch_lockcheck.CheckedLock)
        assert lock.site == "backend.decode_graphs.device_lock"
        assert decode_graphs.device_lock(dev) is lock
    finally:
        decode_graphs._DEVICE_LOCKS.pop(7, None)


def test_dropped_locks_leave_no_false_cycle(lockcheck_on):
    """Locks built and dropped by the hundred (a process that builds and
    stops services): fresh instances of two sites, each pair taken in one
    order and the next pair in the other, form no instance-level cycle.
    The graph's nodes are serial numbers, never the reused id() of a
    collected lock."""
    for i in range(200):
        a = torch_sync.make_lock("drop.S.a")
        b = torch_sync.make_lock("drop.S.b")
        first, second = (a, b) if i % 2 else (b, a)
        with first:
            with second:
                pass
        del a, b, first, second     # freed at once: their ids recycle
    assert torch_lockcheck.registry().cycles() == []
    nodes = {e for pair in torch_lockcheck.registry()._edges for e in pair}
    assert len(nodes) == 400
