"""The three-tier conversation state (device pool -> host memory -> log
replay) on the port, against the JAX package (``tests/test_tiering.py``'s
cases, each run through both packages where both can run it):

- ``select_victims``: the policy cases and seeded random candidates give
  the JAX package's victims;
- the backpressure gate's demote band: the engine's own gate signals the
  tier manager with the JAX package's hysteresis, and
  ``SWARMDB_TIER_DEMOTE`` is parsed and clamped alike;
- demote -> promote over f32, bf16 and int8 pools: the promoted pages are
  bit-identical (``torch.equal``) to the demoted ones, the pools keep
  their storage (``data_ptr``), and the conversation's greedy replies
  equal the never-demoted ones (and, on f32, the JAX package's);
- a demotion larger than the warm store goes cold, and the cold resume's
  replies equal the JAX package's (a re-prefill from the broker log);
- a warm entry evicted by a newer demotion goes cold (counters equal the
  JAX package's) and its conversation is still served;
- ``status()`` has the JAX package's keys, ``health()["tier"]`` carries
  it, and ``SWARMDB_TIER=0`` attaches no tier manager.

Tolerances: none (tokens, bytes and counters are compared exactly).
"""

import numpy as np
import pytest
import torch

from swarmdb_tpu.backend import tiering as jtier
from swarmdb_tpu_torch.backend import tiering as ttier
from tests.test_torch_rolling import (_one_torch_thread, chat, counters,
                                      serve, service_pair)

assert _one_torch_thread  # the autouse fixture, imported to apply here


# ----------------------------------------------------------- victim policy

NOW = 1000.0
POLICY_CASES = [
    ([("a", 2, 990.0, 5), ("b", 2, 900.0, 5), ("c", 2, 950.0, 5)], 2, 1.0,
     ["b"]),
    ([("a", 2, 990.0, 5), ("b", 2, 900.0, 5), ("c", 2, 950.0, 5)], 4, 1.0,
     ["b", "c"]),
    ([("hotter", 1, 900.0, 50), ("colder", 1, 900.0, 2)], 1, 1.0,
     ["colder"]),
    ([("fresh", 4, NOW - 0.1, 0), ("idle", 1, NOW - 10.0, 0)], 4, 1.0,
     ["idle"]),
    ([("a", 3, 900.0, 0), ("b", 3, 901.0, 0), ("c", 3, 902.0, 0)], 4, 0.0,
     ["a", "b"]),
    ([("a", 1, 900.0, 0), ("b", 1, 901.0, 0)], 100, 0.0, ["a", "b"]),
    ([], 5, 0.0, []),
]


@pytest.mark.parametrize("cands,need,min_idle,want", POLICY_CASES,
                         ids=["oldest", "two_oldest", "touch_tiebreak",
                              "min_idle", "need_covered", "shortfall",
                              "empty"])
def test_select_victims_policy(cands, need, min_idle, want):
    got = ttier.select_victims(cands, need, NOW, min_idle)
    assert got == jtier.select_victims(cands, need, NOW, min_idle) == want


def test_select_victims_seeded_candidates():
    rng = np.random.default_rng(0)
    for trial in range(50):
        n = int(rng.integers(0, 30))
        cands = [(f"c{i}", int(rng.integers(1, 9)),
                  float(NOW - rng.integers(0, 20)),
                  int(rng.integers(0, 4))) for i in range(n)]
        need = int(rng.integers(0, 60))
        idle = float(rng.choice([0.0, 0.5, 5.0]))
        assert (ttier.select_victims(cands, need, NOW, idle)
                == jtier.select_victims(cands, need, NOW, idle)), trial


# ----------------------------------------------------- gate demote band


def _port_engine(monkeypatch, **env):
    from swarmdb_tpu_torch.backend.service import build_backend_engine

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    eng, _ = build_backend_engine("tiny-debug", max_batch=2, max_seq=64,
                                  paged=True, page_size=8, device="cpu")
    return eng


def _jax_engine(monkeypatch, **env):
    from swarmdb_tpu.backend.service import build_backend_engine
    from swarmdb_tpu.models.configs import get_config

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    eng, _ = build_backend_engine(get_config("tiny-debug"), max_batch=2,
                                  max_seq=64, paged=True, page_size=8)
    return eng


def test_demote_gate_hysteresis_no_thrash(monkeypatch):
    """The engine's gate with utilisation forced: under the demote mark
    nothing is signalled; once tripped the signal stays on until the low
    watermark, as the JAX package's probe of its gate shows."""
    monkeypatch.setenv("SWARMDB_POOL_LOW", "0.60")
    monkeypatch.setenv("SWARMDB_TIER_DEMOTE", "0.85")
    monkeypatch.setenv("SWARMDB_POOL_HIGH", "0.92")
    eng = _port_engine(monkeypatch)
    signals = []
    eng.on_tier_pressure = lambda need: signals.append(util[0])
    util = [0.0]
    monkeypatch.setattr(eng, "_pool_headroom", lambda: 1.0 - util[0])
    trace = []
    for u in (0.70, 0.84, 0.80, 0.84, 0.86, 0.70, 0.61, 0.59, 0.84):
        util[0] = u
        eng._backpressure_gate()
        trace.append(list(signals))
    assert signals == [0.86, 0.70, 0.61]
    assert trace[3] == [] and trace[-1] == [0.86, 0.70, 0.61]


@pytest.mark.parametrize("value", ["1.0", "0.05", "0.99", "0.87", "junk"])
def test_demote_watermark_env_parsing(monkeypatch, value):
    """``SWARMDB_TIER_DEMOTE`` >= 1 turns the band off, anything else is
    clamped into [low, high]: the port's engine reads what the JAX
    package's reads."""
    monkeypatch.setenv("SWARMDB_TIER_DEMOTE", value)
    assert (_port_engine(monkeypatch)._bp_demote
            == _jax_engine(monkeypatch)._bp_demote)


# ------------------------------------------------- service-level tier cycles


def tier_pair(monkeypatch, tmp_path, kv="f32", users=("u",), **env):
    """(JAX service, port service) with rolling KV and the tier manager
    on a paged engine at max_seq 256, every parked conversation eligible
    for demotion."""
    monkeypatch.setenv("SWARMDB_TIER", "1")
    pair = service_pair(monkeypatch, tmp_path, True, seq=256, users=users,
                        kv=kv, **env)
    for svc in pair:
        assert svc._tier is not None, "the tier manager must attach"
        svc._tier.min_idle_s = 0.0
    return pair


def turns(svc, user, n, on_turn=None, max_new=4):
    out = []
    for t in range(n):
        if on_turn is not None:
            on_turn(t)
        out.append(chat(svc, user, f"turn {t} from {user}", max_new=max_new))
    return out


def wait_parked(svc, key, timeout=60.0):
    import time

    deadline = time.time() + timeout
    while time.time() < deadline:
        with svc._rolling_lock:
            st = svc._rolling.get(key)
            if st is not None and st.get("pages") and not st["in_flight"]:
                return st
        time.sleep(0.05)
    raise AssertionError(f"{key} never parked device pages")


def demote_all(svc):
    """Demote every idle device-resident conversation (the pressure
    hook's call), once the engine loop has been out of a step with no
    active slot for three reads in a row: the JAX engine's steps donate
    the pool the demotion reads."""
    import time

    eng = svc.engine
    quiet, deadline = 0, time.time() + 30
    while quiet < 3 and time.time() < deadline:
        quiet = 0 if eng._in_step or eng._any_active() else quiet + 1
        time.sleep(0.02)
    with svc._rolling_lock:
        return svc._tier.demote_now(10 ** 6)


def _pages(pool, ids):
    from swarmdb_tpu_torch.ops.paged_kv import QuantPool

    idx = torch.tensor(ids)
    if isinstance(pool, QuantPool):
        return (pool.data[:, idx].clone(), pool.scale[:, idx].clone())
    return (pool[:, idx].clone(),)


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_demote_promote_bit_identical(monkeypatch, tmp_path, kv):
    """Four turns with every idle conversation demoted between them: each
    promotion copies back exactly the bytes that were demoted (checked
    right after the insert, before the resume prefill writes), the
    payloads lie in the warm store's slab and give its bytes back once
    promoted, the pools
    keep their storage, every resumed turn is a warm hit, and the replies
    equal a never-demoted serve's (and the JAX package's on f32)."""
    js, ts = tier_pair(monkeypatch, tmp_path / "tier", kv=kv)
    key = ("u", "bot")
    eng = ts.engine
    ptrs = [eng.cache[n].data_ptr() if kv != "int8"
            else eng.cache[n].data.data_ptr() for n in ("k", "v")]
    demoted, promoted = [], []

    def demote_between(t):
        if t == 0:
            return
        st = wait_parked(ts, key)
        demoted.append([_pages(eng.cache[n], st["pages"])
                        for n in ("k", "v")])
        assert demote_all(ts) > 0
        with ts._rolling_lock:
            st = ts._rolling[key]
            assert st.get("host") and st.get("pages") is None
        assert ts._tier.store.has(key)
        # the payload lies in the store's slab, and is all it holds
        slab = ts._tier.store.slab_stats()
        assert slab["in_use"] >= ts._tier.store.stats()["bytes"] > 0
        base = ts._tier.store._slab.buf.data_ptr()
        entry = ts._tier.store._entries[key]
        for side in (entry.k, entry.v):
            for t in side if isinstance(side, tuple) else (side,):
                assert base <= t.data_ptr() < base + slab["bytes"]

    insert = eng._promote_insert

    def watched(req):
        insert(req)
        promoted.append([_pages(eng.cache[n], req.resume_pages)
                         for n in ("k", "v")])

    eng._promote_insert = watched
    got = serve(ts, lambda s: (turns(s, "u", 4, on_turn=demote_between),
                               counters(s), dict(s._tier.status()["counters"])))
    replies, c, tc = got
    assert len(promoted) == len(demoted) == 3
    # promoted payloads gave their bytes back to the slab
    assert ts._tier.store.slab_stats()["in_use"] == 0
    for before, after in zip(demoted, promoted):
        for pb, pa in zip(before, after):
            assert all(torch.equal(x, y) for x, y in zip(pb, pa))
    assert [eng.cache[n].data_ptr() if kv != "int8"
            else eng.cache[n].data.data_ptr() for n in ("k", "v")] == ptrs
    assert tc["promotions"] >= 3 and tc["demotions"] >= 3
    assert tc["cold_resumes"] == 0 and c["rolling_resumes"] >= 3
    # the same turns, never demoted
    _, hot = tier_pair(monkeypatch, tmp_path / "hot", kv=kv)
    want = serve(hot, lambda s: turns(s, "u", 4))
    assert replies == want
    if kv == "f32":
        js.db.close()
        jhot, _ = tier_pair(monkeypatch, tmp_path / "jhot", kv=kv)
        assert serve(jhot, lambda s: turns(s, "u", 4)) == replies


def test_demote_cold_resume_equals_jax(monkeypatch, tmp_path):
    """A demotion larger than the whole warm store falls through to cold:
    the registry entry goes, the cold ledger keeps the footprint, the next
    turn is a cold resume (a fresh prefill of the window from the broker
    log) and observes ``tier_ttft_cold_s``. Both packages run the same
    cycle; the replies and tier counters are equal."""
    pair = tier_pair(monkeypatch, tmp_path)
    key = ("u", "bot")

    def drive(svc):
        def cold_between(t):
            if t == 0:
                return
            wait_parked(svc, key)
            svc._tier.store.capacity_bytes = 1
            demote_all(svc)
            with svc._rolling_lock:
                assert key not in svc._rolling
            assert not svc._tier.store.has(key)

        replies = turns(svc, "u", 3, on_turn=cold_between)
        hist = svc.db.metrics.latencies.get("tier_ttft_cold_s")
        return (replies, dict(svc._tier.status()["counters"]),
                hist is not None and hist.count() >= 2)

    jout, tout = (serve(s, drive) for s in pair)
    assert tout == jout
    assert tout[1]["cold_resumes"] >= 2 and tout[1]["promotions"] == 0
    assert tout[2]


def test_warm_store_eviction_goes_cold(monkeypatch, tmp_path):
    """A store sized to one conversation: demoting a second evicts the
    first (warm -> cold: registry entry dropped, counted), whose next turn
    is a cold resume that is still served, in both packages alike."""
    from swarmdb_tpu_torch.ops.paged_kv import pool_page_bytes

    pair = tier_pair(monkeypatch, tmp_path, users=("u", "u2"))

    def drive(svc):
        turns(svc, "u", 1)
        st = wait_parked(svc, ("u", "bot"))
        cache = svc.engine.cache
        if hasattr(cache["k"], "element_size"):
            page_bytes = (pool_page_bytes(cache["k"])
                          + pool_page_bytes(cache["v"]))
        else:
            from swarmdb_tpu.ops.paged_kv import pool_page_bytes as jpb

            page_bytes = jpb(cache["k"]) + jpb(cache["v"])
        svc._tier.store.capacity_bytes = len(st["pages"]) * page_bytes
        assert demote_all(svc) > 0
        assert svc._tier.store.has(("u", "bot"))
        turns(svc, "u2", 1)
        wait_parked(svc, ("u2", "bot"))
        demote_all(svc)
        out = [not svc._tier.store.has(("u", "bot"))]
        with svc._rolling_lock:
            out.append(("u", "bot") not in svc._rolling)
        out.append(turns(svc, "u", 1))
        out.append(dict(svc._tier.status()["counters"]))
        return out

    jout, tout = (serve(s, drive) for s in pair)
    assert tout == jout
    assert tout[0] and tout[1]
    assert tout[3]["warm_evictions"] >= 1 and tout[3]["cold_resumes"] >= 1


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_tier_status_keys_and_health(monkeypatch, tmp_path):
    """After two turns and a demotion, ``status()`` has the JAX package's
    keys (nested), warm pages, a demotion counted in the db metrics too,
    and ``health()["tier"]`` carries it."""
    pair = tier_pair(monkeypatch, tmp_path)

    def drive(svc):
        turns(svc, "u", 2)
        wait_parked(svc, ("u", "bot"))
        demote_all(svc)
        s = svc._tier.status()
        assert s["enabled"] is True and s["pages"]["warm"] > 0
        assert s["counters"]["demotions"] >= 1
        assert 0.0 <= s["warm_hit_rate"] <= 1.0
        assert s["config"]["warm_capacity_bytes"] > 0
        assert (svc.db.metrics.counters["tier_demotions"].value
                == s["counters"]["demotions"])
        assert svc.health()["tier"]["enabled"] is True
        return _keys(s), s["pages"], s["counters"]

    jout, tout = (serve(s, drive) for s in pair)
    assert tout == jout


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_tier_disabled_by_env_or_engine(monkeypatch, tmp_path, paged):
    """``SWARMDB_TIER=0`` leaves rolling KV on and attaches no tier
    manager; a dense engine never gets one (the JAX package attaches tiers
    to paged engines only)."""
    monkeypatch.setenv("SWARMDB_TIER", "0" if paged else "1")
    pair = service_pair(monkeypatch, tmp_path, paged)
    for svc in pair:
        try:
            assert svc._rolling is not None and svc._tier is None
            assert svc.health()["tier"] == {"enabled": False}
        finally:
            svc.db.close()
