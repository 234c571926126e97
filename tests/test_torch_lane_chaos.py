"""Supervision and chaos over lane groups, against the JAX reference: the
lane cases of ``tests/test_serving_chaos.py``, each run through both
packages on a supervised 2-lane group (tiny-debug, float32 weights and
pools; the JAX group on the conftest's virtual CPU devices).

- idle lanes beat and read alive, with per-lane gauges;
- a lane killed mid-stream is quarantined and its request migrates to
  the sibling: the stream ends "length" with the undisturbed run's greedy
  tokens (exactly), nothing lost or repeated, and the lane is restarted,
  probed and re-admitted; killed at every chunk boundary, the port's
  replay equals the JAX package's;
- a wedged lane is quarantined with its thread alive, its hinted traffic
  remapped, and re-admitted after heal; a restart mid-stream is retried;
  a deadline ends a request no lane can serve;
- a retry storm leaves one "retry.storm" flight event; the migration
  budget and the storm threshold come from the environment;
- a scenario scheduled by ``run_script`` (slow, heal, kill) gives the
  same chaos events in both packages;
- the group's stats and the supervisor's status have the JAX package's
  per-lane shape.
"""

import threading
import time

import pytest
import torch

# an injected LaneKilled is an unhandled thread exception: the failure
# under test, not noise
pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")

from swarmdb_tpu.backend.chaos import ServingChaos as JChaos
from swarmdb_tpu.backend.supervisor import LaneSupervisor as JSup
from swarmdb_tpu_torch.backend.chaos import ServingChaos as TChaos
from swarmdb_tpu_torch.backend.chaos import wait_until
from swarmdb_tpu_torch.backend.supervisor import LaneSupervisor as TSup
from tests.test_torch_lanes import build_pair, gen

SUP = dict(suspect_s=0.25, quarantine_s=0.5, poll_s=0.05, probe_clean_n=2,
           probe_timeout_s=60.0, deadline_s=120.0, retries=2)
PKGS = ("jax", "torch")


@pytest.fixture(scope="module")
def stack():
    """{pkg: (group, supervisor, chaos)}; every test leaves both lanes of
    both groups healthy."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    jg, tg = build_pair(mp)
    out = {}
    for pkg, g, chaos_cls in (("jax", jg, JChaos), ("torch", tg, TChaos)):
        g.start()
        out[pkg] = (g, g.attach_supervisor(**SUP), chaos_cls(g))
    yield out
    for pkg in ("torch", "jax"):
        g, sup, chaos = out[pkg]
        chaos.stop()
        sup.stop()
        g.stop()
    mp.undo()
    torch.set_num_threads(threads)


def _healthy(sup) -> bool:
    return all(lane["state"] == "alive" for lane in sup.status()["lanes"])


def _all_healthy(stack, what="lanes healthy", timeout=60.0):
    for pkg in PKGS:
        sup = stack[pkg][1]
        wait_until(lambda: _healthy(sup), timeout, what=f"{pkg} {what}")


def test_idle_lanes_beat_and_read_alive(stack):
    _all_healthy(stack, timeout=10.0)
    for pkg in PKGS:
        _, sup, _ = stack[pkg]
        st = sup.status()
        assert [lane["state_code"] for lane in st["lanes"]] == [0, 0]
        assert all(lane["beat_age_s"] < 1.0 for lane in st["lanes"])
        lines = sup.prometheus_lines()
        assert 'swarmdb_lane_state{lane="0"} 0' in lines
        assert 'swarmdb_lane_state{lane="1"} 0' in lines
        assert sum(ln.startswith("swarmdb_lane_beat_age_seconds{")
                   for ln in lines) == 2


def test_kill_mid_stream_migrates_with_zero_loss(stack):
    prompt = [1, 5, 9, 13]
    _all_healthy(stack)
    refs = {pkg: gen(pkg, stack[pkg][0], prompt, 24, hint=0)[0]
            for pkg in PKGS}
    assert refs["torch"] == refs["jax"] and len(refs["jax"]) == 24
    for pkg in PKGS:
        g, sup, chaos = stack[pkg]
        migrated = g.metrics.counters["requests_migrated"].value
        killed = []

        def kill_at_8(rid, tok, streamed, _killed=killed, _chaos=chaos):
            if len(streamed) == 8 and not _killed:
                _killed.append(True)
                _chaos.kill_lane(0)  # lands at the next chunk boundary

        toks, reason, streamed = gen(pkg, g, prompt, 24, hint=0,
                                     on_token=kill_at_8)
        assert killed, f"{pkg}: stream finished before the kill armed"
        assert reason == "length" and streamed == toks
        assert toks == refs[pkg], f"{pkg}: migrated stream diverged"
        assert g.metrics.counters["requests_migrated"].value > migrated
        events = g.flight.events()
        assert {"chaos.kill_fired", "lane.quarantined",
                "request.migrated"} <= {e.get("kind") for e in events}
        moved = [e for e in events if e.get("kind") == "request.migrated"]
        assert (moved[-1]["from_lane"], moved[-1]["to_lane"]) == (0, 1)
        wait_until(lambda: _healthy(sup), 60.0,
                   what=f"{pkg} lane 0 re-admitted")
        st = sup.status()
        assert st["lane_quarantines"] >= 1 and st["lane_readmissions"] >= 1
        assert st["lanes"][0]["restarts"] >= 1
        assert "lane.readmitted" in {e.get("kind") for e in g.flight.events()}
        again, _, _ = gen(pkg, g, prompt, 24, hint=0)
        assert again == refs[pkg]


def test_replay_equal_at_every_chunk_boundary(stack):
    """Killed at every chunk boundary k (a kill armed at token k lands at
    k's boundary; decode_chunk 4), the request migrates to the sibling
    lane, which re-prefills prompt + the k emitted tokens: the port's
    stream equals the JAX package's for every k, with no token repeated
    or lost. (On this degenerate prompt both packages' replays may part
    from the undisturbed run at a near tie, identically: ROADMAP.md
    queue 3.)"""
    prompt = [2, 4, 6, 8, 10]
    n_tokens = 16
    _all_healthy(stack)
    out = {pkg: {} for pkg in PKGS}
    for k in (4, 8, 12):
        for pkg in PKGS:
            g, sup, chaos = stack[pkg]
            wait_until(lambda: _healthy(sup), 60.0,
                       what=f"{pkg} recovery before boundary {k}")
            killed = []

            def kill_at_k(rid, tok, streamed, _k=k, _killed=killed,
                          _chaos=chaos):
                if len(streamed) == _k and not _killed:
                    _killed.append(True)
                    _chaos.kill_lane(1)

            toks, reason, streamed = gen(pkg, g, prompt, n_tokens, hint=1,
                                         on_token=kill_at_k)
            assert killed, f"{pkg} boundary {k}: finished before the kill"
            assert reason == "length" and streamed == toks
            out[pkg][k] = toks
    assert out["torch"] == out["jax"]
    _all_healthy(stack, what="final recovery")


def test_wedge_quarantines_migrates_and_heals(stack):
    _all_healthy(stack)
    for pkg in PKGS:
        g, sup, chaos = stack[pkg]
        q_before = sup.status()["lane_quarantines"]
        chaos.wedge(0)
        try:
            wait_until(lambda: sup.status()["lanes"][0]["state"]
                       == "quarantined", 10.0,
                       what=f"{pkg} wedged lane quarantined")
            assert sup.status()["lanes"][0]["thread_alive"]
            # a request hinted to the wedged lane is remapped to its
            # sibling and served
            toks, reason, _ = gen(pkg, g, [3, 7, 11], 8, hint=0)
            assert reason == "length" and len(toks) == 8
        finally:
            chaos.heal(0)
        wait_until(lambda: _healthy(sup), 60.0,
                   what=f"{pkg} wedged lane re-admitted")
        assert sup.status()["lane_quarantines"] == q_before + 1


def test_supervisor_retries_a_lane_restart(stack):
    """A lane restarted under a request (not a quarantine): the request
    ends "engine_restart", retryable, and the retry serves it whole."""
    _all_healthy(stack)
    for pkg in PKGS:
        g, sup, _ = stack[pkg]
        retried = g.metrics.counters["requests_retried"].value
        restarter = threading.Thread(target=g.lanes[1].restart, daemon=True)
        started = []

        def restart_at_4(rid, tok, streamed):
            if len(streamed) == 4 and not started:
                started.append(True)
                restarter.start()

        toks, reason, streamed = gen(pkg, g, [1, 9, 17], 16, hint=1,
                                     on_token=restart_at_4)
        restarter.join(60)
        assert reason == "length" and len(toks) == 16 and streamed == toks
        assert g.metrics.counters["requests_retried"].value > retried
        wait_until(lambda: _healthy(sup), 60.0,
                   what=f"{pkg} post-restart recovery")


def test_deadline_expires_instead_of_hanging(stack):
    _all_healthy(stack)
    for pkg in PKGS:
        g, sup, chaos = stack[pkg]
        chaos.wedge(0)
        chaos.wedge(1)
        try:
            toks, reason, _ = gen(pkg, g, [5, 6, 7], 8,
                                  deadline=time.time() + 1.0, timeout=30.0)
            assert (toks, reason) == ([], "deadline"), pkg
            assert (g.metrics.counters["requests_deadline_expired"].value
                    >= 1)
        finally:
            chaos.heal(0)
            chaos.heal(1)
        wait_until(lambda: _healthy(sup), 60.0,
                   what=f"{pkg} post-wedge recovery")


def test_retry_storm_leaves_one_flight_event(stack, monkeypatch):
    monkeypatch.setenv("SWARMDB_RETRY_STORM_N", "5")
    monkeypatch.setenv("SWARMDB_REQ_MIGRATIONS", "1")
    for pkg, sup_cls in (("jax", JSup), ("torch", TSup)):
        g, sup, _ = stack[pkg]
        fresh = sup_cls(g)   # not started: reads the environment only
        assert (fresh.storm_n, fresh.migrations) == (5, 1)
        c = g.metrics.counters["requests_retried"]
        storms = sum(e.get("kind") == "retry.storm"
                     for e in g.flight.events())
        fresh._prev_retried, fresh._storming = c.value, False
        c.inc(5)
        fresh._detect_retry_storm()
        fresh._detect_retry_storm()   # a quiet poll ends the storm
        assert not fresh._storming
        ev = [e for e in g.flight.events() if e.get("kind") == "retry.storm"]
        assert len(ev) == storms + 1
        assert ev[-1]["retries_in_window"] == 5


#: a scripted scenario: slow lane 1, heal it, kill lane 0
SCRIPT = [(0.0, "slow", (1, 0.02)), (0.15, "heal", (1,)),
          (0.3, "kill_lane", (0,))]


@pytest.mark.parametrize("pkg", PKGS)
def test_run_script_gives_the_same_chaos_events(stack, pkg):
    """``run_script`` schedules a whole scenario in one call: the chaos
    events (action and lane; timestamps aside) are the same in both
    packages, the kill fires, and the lane is re-admitted."""
    g, sup, chaos = stack[pkg]
    wait_until(lambda: _healthy(sup), 60.0, what=f"{pkg} lanes healthy")
    n0 = len(chaos.dump()["chaos_events"])
    chaos.run_script(SCRIPT)

    def seen():
        return [(e["action"], e["lane"])
                for e in chaos.dump()["chaos_events"][n0:]]

    wait_until(lambda: ("kill_fired", 0) in seen(), 30.0,
               what=f"{pkg} scripted kill fired")
    assert seen() == [("slow", 1), ("heal", 1), ("kill_lane", 0),
                      ("kill_fired", 0)]
    wait_until(lambda: _healthy(sup), 60.0,
               what=f"{pkg} killed lane re-admitted")
    assert seen()[-1] == ("kill_fired", 0)


def test_group_stats_and_admin_surface(stack):
    _all_healthy(stack)
    shapes = {}
    for pkg in PKGS:
        g, sup, _ = stack[pkg]
        assert g.stats()["lane_states"] == ["alive", "alive"]
        st = sup.status()
        assert [lane["lane"] for lane in st["lanes"]] == [0, 1]
        assert st["config"]["retries"] == 2
        assert st["lane_quarantines"] >= 1  # earlier tests killed lanes
        shapes[pkg] = (sorted(st["lanes"][0]),
                       sorted(k for k in st if k != "config"),
                       sorted(k for k in g.stats() if k != "latencies"))
    assert shapes["torch"] == shapes["jax"]
