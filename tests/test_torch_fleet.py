"""The fleet against the JAX reference: ``SWARMDB_FLEET=prefill:N,decode:M``
splits a lane group into prefill and decode pools, and a staged request
prefills on a prefill lane, travels through the transit host store and
decodes on a decode lane.

The cases of ``tests/test_fleet.py``, each run through both packages, one
test case per package, so that a stall on one side cannot hide the
other's result (a 2-lane fleet, prefill:1,decode:1, supervised;
tiny-debug, float32 weights and pools; the JAX group on the conftest's
virtual CPU devices):

- the spec parsers give the JAX package's pool maps and weights,
  refusals included;
- pools and roles are wired; a staged handoff's greedy tokens equal the
  colocated group's and the JAX fleet's, exactly, with the stream equal
  to the reply; admission-only work stays on the prefill pool; priority
  >= 3 pins to the fastest tier; a quarantined pool degrades to
  colocated serving;
- custody balances after handoffs, by accounting (every page free, in a
  slot, or in a prefix cache; the transit store empty; the page
  sanitizer's view of a fleet is tests/test_torch_sanitize.py's);
- a prefill lane killed mid-wave loses nothing (last in file order: it
  kills a lane and waits for its re-admission).
"""

import threading

import numpy as np
import pytest
import torch

import jax

# an injected LaneKilled is an unhandled thread exception: the failure
# under test, not noise
pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")

from swarmdb_tpu.backend.chaos import ServingChaos as JChaos
from swarmdb_tpu.parallel import fleet as jfleet
from swarmdb_tpu_torch.backend.chaos import ServingChaos as TChaos
from swarmdb_tpu_torch.backend.chaos import wait_until
from swarmdb_tpu_torch.parallel import fleet as tfleet
from swarmdb_tpu_torch.parallel.serving import build_serving_engine as tbuild
from swarmdb_tpu_torch.utils.convert import params_from_numpy
from tests.test_torch_lanes import (CHUNK, PKG, PS, SEQ, build_pair,
                                    f32_params, gen, gen_many)

FLEET_ENV = {"SWARMDB_FLEET": "prefill:1,decode:1",
             "SWARMDB_FLEET_TRANSIT_MB": "16"}
SUP = dict(suspect_s=0.25, quarantine_s=0.5, poll_s=0.05, probe_clean_n=2,
           probe_timeout_s=60.0, deadline_s=120.0, retries=2)
PKGS = ("jax", "torch")


# ------------------------------------------------------------ spec parsers


@pytest.mark.parametrize("n,spec", [
    (4, "prefill:2,decode:2"), (4, "prefill:1,decode:3"),
    (3, "decode:2,prefill:1"), (4, ""), (4, "   "),
    (4, "prefill:1,decode:1"), (4, "prefill:3,decode:3"),
    (4, "prefill:0,decode:4"), (4, "prefill:4,decode:0"),
    (4, "prefill:two,decode:2"), (4, "fast:2,slow:2"),
    (4, "prefill=2,decode=2")])
def test_parse_fleet_spec_equals_jax(n, spec):
    got = tfleet.parse_fleet_spec(n, spec)
    assert got == jfleet.parse_fleet_spec(n, spec)
    if spec == "prefill:1,decode:3":
        assert got == {"prefill": [0], "decode": [1, 2, 3]}


@pytest.mark.parametrize("spec", ["1,1,0.5,2", "", "1,1,1", "1,1,0,1",
                                  "1,1,-2,1", "a,b,c,d"])
def test_parse_tier_weights_equals_jax(spec):
    assert (tfleet.parse_tier_weights(4, spec)
            == jfleet.parse_tier_weights(4, spec))


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def fleet():
    """{pkg: (group, supervisor, chaos)} for a supervised 2-lane fleet of
    each package, and the port's colocated 2-lane group on the same
    weights (``"colo"``); every test leaves the lanes healthy."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    params = f32_params()
    jg, tg = build_pair(mp, env=FLEET_ENV, params=params)
    mp.setenv("SWARMDB_FLEET", "")
    colo, _ = tbuild("tiny-debug", ["cpu"] * 2, max_batch=4, max_seq=SEQ,
                     paged=True, page_size=PS, decode_chunk=CHUNK,
                     params=params_from_numpy(jax.tree.map(np.asarray,
                                                           params),
                                              device="cpu"))
    assert jg.fleet is not None and tg.fleet is not None
    assert colo.fleet is None
    out = {"colo": colo}
    for pkg, g, chaos_cls in (("jax", jg, JChaos), ("torch", tg, TChaos)):
        g.start()
        out[pkg] = (g, g.attach_supervisor(**SUP), chaos_cls(g))
    colo.start()
    yield out
    colo.stop()
    for pkg in ("torch", "jax"):
        g, sup, chaos = out[pkg]
        chaos.stop()
        sup.stop()
        g.stop()
    mp.undo()
    torch.set_num_threads(threads)


def _healthy(sup) -> bool:
    return all(lane["state"] == "alive" for lane in sup.status()["lanes"])


def _custody(lane) -> int:
    """Pages of an idle paged lane not free, in no slot and in no prefix
    cache entry: 0 when custody balances."""
    alloc = lane.paged.allocator
    held = sum(len(alloc.pages_for(s)) for s in range(lane.max_batch))
    cached = lane._prefix.stats()["cached_pages"]
    return lane.paged.num_pages - 1 - alloc.free_count() - held - cached


# ------------------------------------------------------------ pool wiring


@pytest.mark.parametrize("pkg", PKGS)
def test_fleet_pools_wired(fleet, pkg):
    g, sup, _ = fleet[pkg]
    wait_until(lambda: _healthy(sup), 30.0, what=f"{pkg} lanes alive")
    assert g.fleet.pools == {"prefill": [0], "decode": [1]}
    assert [e._role for e in g.lanes] == ["prefill", "decode"]
    assert [g.fleet.lane_role(j) for j in (0, 1)] == ["prefill", "decode"]
    st = g.stats()["fleet"]
    assert st["pool_sizes"] == {"prefill": 1, "decode": 1}
    assert st["weights"] is None
    assert st["transit_store"]["capacity_bytes"] == 16 << 20
    if pkg == "torch":
        slab = g.fleet.stats()["transit_slab"]
        assert slab["bytes"] == 16 << 20 and slab["pinned"] is False


# --------------------------------------------------- handoff equality


@pytest.mark.parametrize("pkg", PKGS)
def test_handoff_tokens_equal_colocated_and_jax(fleet, pkg):
    """Each package's staged handoffs give the port's colocated group's
    greedy tokens (so the two fleets' tokens are equal)."""
    prompts = [[1, 5, 9, 13], [2, 4, 6, 8, 10, 12, 14],
               list(range(3, 40)),           # pages of prefill
               [7, 7, 7]]
    ref = [gen("torch", fleet["colo"], p, 16)[0] for p in prompts]
    g, sup, _ = fleet[pkg]
    c = g.metrics.counters
    ho0 = c["fleet_handoffs"].value
    fb0 = c["fleet_handoff_fallbacks"].value
    for p, r in zip(prompts, ref):
        toks, reason, streamed = gen(pkg, g, p, 16)
        assert reason == "length" and toks == r, (pkg, p, toks, r)
        assert streamed == toks
    st = g.fleet.stats()
    # which handoff was missed, and where the request went instead (a
    # colocated route, a fallback) with the lanes' states
    why = (pkg, {k: v for k, v in st.items()
                 if not k.startswith("transit")},
           {"handoffs_before": ho0, "fallbacks_before": fb0},
           [lane["state"] for lane in sup.status()["lanes"]])
    assert st["handoffs"] - ho0 == len(prompts), why
    assert c["fleet_handoff_fallbacks"].value == fb0, why
    assert st["transit_store"]["entries"] == 0
    assert st["transit_store"]["bytes"] == 0
    assert st["handoff_ms_p95"] >= st["handoff_ms_p50"] > 0
    if pkg == "torch":
        assert st["gather_ms_per_page"] > 0


@pytest.mark.parametrize("pkg", PKGS)
def test_admission_only_work_stays_on_prefill_pool(fleet, pkg):
    prompt = [3, 1, 4, 1, 5]
    ref = gen("torch", fleet["colo"], prompt, 1)[0]
    g, _, _ = fleet[pkg]
    c = g.metrics.counters
    direct0, ho0 = (c["fleet_direct_prefill"].value,
                    c["fleet_handoffs"].value)
    chunks0 = g.lanes[0].metrics.counters["engine_decode_chunks"].value
    toks, reason, _ = gen(pkg, g, prompt, 1)
    assert reason == "length" and toks == ref and len(toks) == 1
    assert c["fleet_direct_prefill"].value == direct0 + 1
    assert c["fleet_handoffs"].value == ho0
    if pkg == "torch":
        # retired off the prefill sample: the prefill lane decoded
        # nothing (metrics are shared, so read the lane's own counts)
        assert g.lanes[0]._runner.chunks == 0
        assert (g.lanes[0].metrics.counters["engine_decode_chunks"]
                .value == chunks0)


# ----------------------------------------------------------------- routing


@pytest.fixture(scope="module")
def routes():
    """{pkg: (sequence of routes, lane weights)} of a 4-lane fleet
    (prefill:2,decode:2) with tier weights 1,1,1,2, not started."""
    mp = pytest.MonkeyPatch()
    try:
        jg, tg = build_pair(mp, n=4, max_batch=8, env={
            "SWARMDB_FLEET": "prefill:2,decode:2",
            "SWARMDB_FLEET_TIERS": "1,1,1,2"})
    finally:
        mp.undo()
    out = {}
    for pkg, g in (("jax", jg), ("torch", tg)):
        Req, SP = PKG[pkg]

        def req(priority):
            return Req(prompt=[1, 2, 3], priority=priority,
                       sampling=SP(max_new_tokens=4))

        dec, pre = g.fleet.pools["decode"], g.fleet.pools["prefill"]
        seq = [g._route(req(3), within=dec)[0] for _ in range(6)]
        seq += [g._route(req(1), within=dec)[0] for _ in range(12)]
        seq += [g._route(req(3), within=pre)[0] for _ in range(12)]
        seq += [g._route(req(1), within=[j])[0] for j in range(4)]
        out[pkg] = (seq, g.stats()["lane_weights"])
    return out


@pytest.mark.parametrize("pkg", PKGS)
def test_routing_critical_pins_to_fast_tier(routes, pkg):
    """Priority 3 on the weight-2 lane, batch traffic over the whole
    pool; the port's sequence of routes is the JAX package's."""
    seq, weights = routes[pkg]
    assert weights == [1.0, 1.0, 1.0, 2.0]
    if pkg == "torch":
        assert seq == routes["jax"][0]
    assert seq[:6] == [3] * 6
    assert set(seq[6:18]) == {2, 3} and set(seq[18:30]) == {0, 1}
    assert seq[30:] == [0, 1, 2, 3]


@pytest.mark.parametrize("pkg", PKGS)
def test_quarantined_pool_degrades_to_colocated(fleet, monkeypatch, pkg):
    prompt = [9, 8, 7, 6]
    g, sup, _ = fleet[pkg]
    wait_until(lambda: _healthy(sup), 30.0, what=f"{pkg} lanes alive")
    c = g.metrics.counters
    orig = sup.lane_admissible
    # the prefill pool reads quarantined: the decode pool serves whole
    # requests, no handoff
    monkeypatch.setattr(sup, "lane_admissible",
                        lambda j: j >= 1 and orig(j))
    fb0, ho0 = (c["fleet_colocated_fallback"].value,
                c["fleet_handoffs"].value)
    toks, reason, streamed = gen(pkg, g, prompt, 8)
    assert reason == "length" and len(toks) == 8 and streamed == toks
    assert c["fleet_colocated_fallback"].value == fb0 + 1
    assert c["fleet_handoffs"].value == ho0
    # both pools quarantined: the fleet steps aside and the group's route
    # (all lanes) serves
    monkeypatch.setattr(sup, "lane_admissible", lambda j: False)
    toks2, reason, _ = gen(pkg, g, prompt, 8)
    assert reason == "length" and toks2 == toks
    monkeypatch.setattr(sup, "lane_admissible", orig)


# ------------------------------------------------------------- custody


@pytest.mark.parametrize("pkg", PKGS)
def test_handoff_custody_balances(fleet, pkg):
    g, sup, _ = fleet[pkg]
    res, _ = gen_many(pkg, g, [([1 + i, 5, 9, 13, 17, 21, 25, 29, 33],
                                12, {}) for i in range(3)])
    assert all(r == "length" and len(t) == 12 for t, r in res)
    wait_until(lambda: all(not any(s.active for s in e.slots)
                           for e in g.lanes), 30.0, what="idle lanes")
    assert [_custody(e) for e in g.lanes] == [0, 0], pkg
    st = g.fleet.stats()
    assert st["transit_store"]["entries"] == 0 and st["in_flight"] == 0
    if pkg == "torch":
        assert st["transit_slab"]["in_use"] == 0


# ------------------------------------------------- chaos: prefill-lane kill
#
# Last in file order: kills a lane and waits for its re-admission.


@pytest.mark.parametrize("pkg", PKGS)
def test_prefill_lane_killed_mid_wave(fleet, pkg):
    """The prefill lane dies while part of a wave is staged on it: the
    supervisor quarantines it and replays its staged requests (the
    surviving decode pool serves them whole); every stream finishes with
    the colocated greedy tokens, nothing lost or repeated, and the lane is
    restarted, probed and re-admitted."""
    prompt = list(range(2, 30))
    ref = gen("torch", fleet["colo"], prompt, 20)[0]
    n = 4
    g, sup, chaos = fleet[pkg]
    wait_until(lambda: _healthy(sup), 30.0, what=f"{pkg} lanes alive")
    Req, SP = PKG[pkg]
    events = [threading.Event() for _ in range(n)]
    outs = [{} for _ in range(n)]
    streams = [[] for _ in range(n)]
    killed = []
    lock = threading.Lock()

    def mk(i):
        def _tok(rid, tok):
            streams[i].append(tok)
            with lock:
                if not killed:
                    killed.append(True)
                    chaos.kill_lane(0)

        def _done(rid, toks, reason):
            outs[i].update(toks=toks, reason=reason)
            events[i].set()

        return _tok, _done

    for i in range(n):
        tok, done = mk(i)
        g.submit(Req(prompt=list(prompt), on_token=tok, on_done=done,
                     sampling=SP(max_new_tokens=20)))
    for i, ev in enumerate(events):
        assert ev.wait(120.0), f"{pkg}: request {i} never completed"
    assert killed
    for i in range(n):
        assert outs[i]["reason"] == "length", (pkg, i, outs[i])
        assert outs[i]["toks"] == ref, (pkg, i)
        assert streams[i] == ref, (pkg, i)
    wait_until(lambda: _healthy(sup), 90.0,
               what=f"{pkg} killed lane re-admitted")
    assert sup.status()["lane_readmissions"] >= 1
