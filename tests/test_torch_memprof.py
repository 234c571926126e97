"""PyTorch port vs JAX reference: the memory accountant.

Every case of ``tests/test_memprof.py`` against the port (the sampled
miss-ratio curve against brute-force LRU, the conversation temperature
ledger and its survival across a lane kill, flag-off type identity, the
report / compact block / Prometheus / window surfaces, the dump ->
analyzer pipeline), plus parity with the JAX package:

- the same request sequence through both paged engines leaves the same
  ``occupancy()`` (residency ages aside: they are clock readings) and
  ``prefix_totals()``;
- ``ReuseSampler`` / ``simulate_lru`` give the same curve on one seeded
  chain trace, exactly, and the same ``tier_validation`` against one
  tier status;
- ``_mem_window`` folds the same snapshots into the same window fields,
  and ``prefix_hit_drop_x`` / ``mem_headroom_min`` fire on the same
  synthetic sequence;
- each package's ``analyze.py --memory`` reads the other's dump to the
  same report;
- each service holds a conversation ledger of its own
  (``memprof().conv_ledger()`` hands out one per call), which the
  registry's report reads together.

Each package's process-global accountant is swapped for a fresh one per
fixture (xdist-safe). ``SWARMDB_MEM_H2D_GBPS`` is set equal in both
packages wherever their warm-tier prices meet.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend import service as jsvc
from swarmdb_tpu.backend.sampling import SamplingParams as JSP
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu.obs import analyze as janalyze
from swarmdb_tpu.obs import sentinel as jsentinel
from swarmdb_tpu_torch.backend import service as tsvc
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.obs import analyze as tanalyze
from swarmdb_tpu_torch.obs import sentinel as tsentinel
from swarmdb_tpu_torch.obs.memprof import (MEM_CURVE_POINTS, NULL_CONV,
                                           NULL_POOL, NULL_PROBE, ConvLedger,
                                           MemProfiler, NullConvLedger,
                                           NullPool, NullProbe, ReuseSampler,
                                           memprof, memprof_enabled,
                                           simulate_lru)
from swarmdb_tpu_torch.utils.convert import params_from_numpy

# the modules (each package's obs/__init__ exports a same-named function)
jmemprof = importlib.import_module("swarmdb_tpu.obs.memprof")
tmemprof = importlib.import_module("swarmdb_tpu_torch.obs.memprof")

CFG = get_config("tiny-debug")
MAX_BATCH, SEQ, PS = 4, 96, 16

#: 37 tokens -> two full 16-token pages -> two prefix chains per lookup
PROMPTS = [[1, 5, 9, 2, 7] * 3, [4] * 37, [7]]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh_registries(mp, sample_inv=None):
    """Both packages' process-global accountants replaced (optionally
    with a rate-1/``sample_inv`` sampler)."""
    mp.delenv("SWARMDB_MEMPROF", raising=False)
    mp.setenv("SWARMDB_MEM_H2D_GBPS", "42.5")
    regs = []
    for mod in (jmemprof, tmemprof):
        reg = mod.MemProfiler()
        if sample_inv is not None:
            reg.sampler = mod.ReuseSampler(sample_inv, 65536)
        mp.setattr(mod, "_MEMPROF", reg)
        regs.append(reg)
    return regs


def _pair(mp):
    """JAX and port paged engines on one set of float32 weights."""
    mp.setenv("SWARMDB_KV_DTYPE", "f32")
    for k in ("SWARMDB_PAGED", "SWARMDB_CHUNKED", "SWARMDB_EMIT_RING",
              "SWARMDB_FLEET", "SWARMDB_ROLLING_KV"):
        mp.delenv(k, raising=False)
    je, _ = jsvc.build_backend_engine(CFG, max_batch=MAX_BATCH, max_seq=SEQ,
                                      paged=True, page_size=PS)
    je.params = jax.tree.map(lambda a: a.astype(jnp.float32), je.params)
    te, _ = tsvc.build_backend_engine(
        "tiny-debug", max_batch=MAX_BATCH, max_seq=SEQ, paged=True,
        page_size=PS, device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, je.params),
                                 device="cpu"))
    return je, te


def _serve(eng, prompts, sp, n=8):
    eng.start()
    try:
        for p in prompts:
            toks, reason = eng.generate_sync(p, sp(max_new_tokens=n))
            assert reason in ("length", "eos")
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The shared accounted run: fresh registries with a rate-1 sampler
    -> both packages' paged engines -> serve PROMPTS twice (the second
    pass hits the prefix cache) -> seed the port's conversation ledger
    the way the service layer would."""
    mp = pytest.MonkeyPatch()
    jreg, treg = _fresh_registries(mp, sample_inv=1)
    je, te = _pair(mp)
    te.paged.allocator.mem.set_label("mem-test-lane")
    te.warmup()
    _serve(te, PROMPTS + PROMPTS, TSP)
    _serve(je, PROMPTS + PROMPTS, JSP)
    conv = treg.conv_ledger()
    conv.touch(("membot", "user1"), 37)
    conv.resident(("membot", "user1"), 3)
    conv.anchor(("membot", "user1"), 16)
    conv.touch(("membot", "user2"), 15)
    tmp = tmp_path_factory.mktemp("memdump")
    yield {"prof": treg, "jprof": jreg, "eng": te, "jeng": je,
           "conv": conv, "tmp": tmp}
    mp.undo()


# ------------------------------------------------ ghost-cache accuracy


def _zipf_trace(n_keys, n_accesses, seed, shift=30):
    """Shifted-Zipf rank trace (p ~ 1/(rank+shift)), as the reference
    test draws it."""
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    p = 1.0 / (ranks + shift)
    p /= p.sum()
    idx = np.random.default_rng(seed).choice(n_keys, size=n_accesses, p=p)
    return [int(i).to_bytes(16, "little") for i in idx]


def test_sampled_curve_within_2pct_of_brute_force_lru():
    trace = _zipf_trace(5000, 150_000, seed=42)
    s = ReuseSampler(4, 65536)
    for key in trace:
        s.access(key)
    st = s.stats()
    assert st["accesses"] == len(trace)
    assert 0.15 < st["sampled"] / st["accesses"] < 0.35
    assert st["stack_overflowed"] == 0
    for cap in (32, 128, 512, 2048):
        exact = simulate_lru(trace, cap)
        est = s.hit_rate_at(cap)
        assert abs(est - exact) < 0.02, (
            f"capacity {cap}: sampled {est:.4f} vs exact {exact:.4f}")


def test_sample_rate_one_is_exact_lru():
    trace = _zipf_trace(2000, 20_000, seed=7)
    s = ReuseSampler(1, 65536)
    for key in trace:
        s.access(key)
    assert s.stats()["sampled"] == len(trace)
    for cap in (16, 64, 256):
        assert s.hit_rate_at(cap) == pytest.approx(
            simulate_lru(trace, cap), abs=1e-12)


def test_curve_is_monotone_and_follows_capacity_points():
    trace = _zipf_trace(1000, 30_000, seed=3)
    s = ReuseSampler(2, 65536)
    for key in trace:
        s.access(key)
    curve = s.curve(device_capacity=100)
    assert [r["capacity_x"] for r in curve] == list(MEM_CURVE_POINTS)
    assert [r["capacity_pages"] for r in curve] == [25, 50, 100, 200, 400]
    rates = [r["hit_rate"] for r in curve]
    assert rates == sorted(rates), "hit rate must not shrink with capacity"
    assert rates[-1] > 0


@pytest.mark.parametrize("sample_inv", [1, 4])
def test_reuse_curve_and_lru_equal_jax(sample_inv):
    """One seeded chain trace through both samplers: the same stats,
    the same curve and the same exact LRU hit rates, to the bit."""
    trace = _zipf_trace(3000, 40_000, seed=11)
    out = {}
    for name, mod in (("jax", jmemprof), ("torch", tmemprof)):
        s = mod.ReuseSampler(sample_inv, 65536)
        for key in trace:
            s.access(key)
        out[name] = (s.stats(), s.curve(device_capacity=300),
                     [s.hit_rate_at(c) for c in (10, 100, 1000)],
                     [mod.simulate_lru(trace, c) for c in (10, 100, 1000)])
    assert out["torch"] == out["jax"]


def test_tier_validation_and_models_equal_jax(monkeypatch):
    """The same sampled trace, page price and bound tier status give the
    same warm-tier model, verdict and tier_validation in both
    packages."""
    monkeypatch.setenv("SWARMDB_MEM_H2D_GBPS", "42.5")
    monkeypatch.setenv("SWARMDB_MEM_CAPACITY", "200")
    monkeypatch.setenv("SWARMDB_MEM_TIER_MIN_RESUMES", "5")
    trace = _zipf_trace(1500, 20_000, seed=5)
    status = {"pages": {"warm": 150, "hot": 10},
              "counters": {"promotions": 12, "cold_resumes": 8},
              "warm_store": {"compress_ratio": None}}
    out = {}
    for name, mod in (("jax", jmemprof), ("torch", tmemprof)):
        reg = mod.MemProfiler(enabled=True)
        reg.sampler = mod.ReuseSampler(2, 65536)
        for key in trace:
            reg.sampler.access(key)
        reg.set_page_bytes(2 * 1024 * 1024)
        reg.bind_tier(lambda: status)
        out[name] = (reg.warm_tier_model(), reg.verdict(),
                     reg.tier_validation())
    assert out["torch"] == out["jax"]
    tv = out["torch"][2]
    assert tv["measured_warm_share"] == 0.6
    assert tv["predicted_warm_share"] is not None and tv["drift"] is not None


# ------------------------------------------------- temperature ledger


def test_temperature_classification_by_threshold_args():
    led = ConvLedger(cap=100)
    led.touch(("a", "b"), 40)
    led.resident(("a", "b"), 5)
    led.anchor(("a", "b"), 16)
    led.touch("solo", 9)
    hot = led.report(hot_s=60.0, warm_s=600.0)
    assert hot["tracked"] == 2 and hot["touches_total"] == 2
    assert hot["by_state"] == {"hot": 2, "warm": 0, "cold": 0}
    assert hot["resident_pages_by_state"]["hot"] == 5
    top = hot["top_resident"][0]
    assert top["conversation"] == "a→b"
    assert top["resident_pages"] == 5 and top["anchor_tokens"] == 16
    assert top["prompt_tokens"] == 40
    warm = led.report(hot_s=-1.0, warm_s=600.0)
    assert warm["by_state"] == {"hot": 0, "warm": 2, "cold": 0}
    cold = led.report(hot_s=-2.0, warm_s=-1.0)
    assert cold["by_state"] == {"hot": 0, "warm": 0, "cold": 2}
    assert cold["resident_pages_by_state"]["cold"] == 5


def test_ledger_drop_cap_and_lru_eviction():
    led = ConvLedger(cap=3)
    for i in range(3):
        led.touch(f"c{i}", 10)
        led.resident(f"c{i}", 2)
    led.drop("c1")
    rep = led.report(60.0, 600.0)
    assert rep["resident_pages_by_state"]["hot"] == 4
    led.touch("c0", 10)
    led.touch("c3", 10)
    keys = {k for k, *_ in led.snapshot()}
    assert keys == {"c0", "c2", "c3"}
    assert led.report(60.0, 600.0)["tracked"] == 3


def test_one_conversation_ledger_per_service(monkeypatch):
    """Each service's ledger is its own (two services sharing a
    conversation key keep their touches apart, which the tier manager's
    victim order reads); the registry's report reads them together and
    lets a dropped service's ledger go."""
    _, reg = _fresh_registries(monkeypatch)
    a, b = reg.conv_ledger(), reg.conv_ledger()
    assert type(a) is ConvLedger and a is not b
    a.touch(("u", "bot"), 10)
    a.touch(("u", "bot"), 12)
    b.touch(("u", "bot"), 7)
    assert [r[2] for r in a.snapshot()] == [2]
    assert [r[2] for r in b.snapshot()] == [1]
    rep = reg.conversations.report(60.0, 600.0)
    assert rep["tracked"] == 2 and rep["touches_total"] == 3
    del b
    import gc
    gc.collect()
    assert reg.conversations.report(60.0, 600.0)["tracked"] == 1


# ------------------------------------------------- flag-off identity


def test_memprof_flag_off_type_identity(monkeypatch):
    monkeypatch.setenv("SWARMDB_MEMPROF", "0")
    assert memprof_enabled() is False
    reg = MemProfiler()
    assert reg.enabled is False
    pool = reg.pool(lambda: {"num_pages": 8, "free_pages": 7})
    probe = reg.prefix_probe()
    conv = reg.conv_ledger()
    assert type(pool) is NullPool and pool is NULL_POOL
    assert type(probe) is NullProbe and probe is NULL_PROBE
    assert type(conv) is NullConvLedger and conv is NULL_CONV
    assert pool.enabled is probe.enabled is conv.enabled is False
    pool.page_alloc([1, 2])
    pool.page_free([1])
    pool.pool_reset()
    probe.access(b"\x00" * 16)
    conv.touch("k", 4)
    conv.resident("k", 2)
    conv.anchor("k", 1)
    conv.drop("k")
    occ = reg.occupancy()
    assert occ["total_pages"] == 0 and occ["pools"] == []
    assert reg.report()["enabled"] is False
    from swarmdb_tpu_torch.ops.paged_kv import PageAllocator
    from swarmdb_tpu_torch.ops.prefix_cache import PrefixLRU

    alloc = PageAllocator(8, 16, 64, 2)
    assert alloc.mem is NULL_POOL
    assert alloc.allocate(0, 2) is not None
    lru = PrefixLRU(8, 16)
    assert lru.mem is NULL_PROBE


def test_memprof_flag_on_real_handles(run):
    from swarmdb_tpu_torch.obs.memprof import MemPool, PrefixProbe

    eng = run["eng"]
    assert type(eng.paged.allocator.mem) is MemPool
    assert type(eng._prefix.mem) is PrefixProbe
    assert type(run["prof"].conv_ledger()) is ConvLedger


# ------------------------------------------------- accounted-run surfaces


def test_occupancy_decomposition_consistency(run):
    occ = run["prof"].occupancy()
    assert occ["total_pages"] > 0
    for k in ("free", "active", "cached_evictable", "pinned"):
        assert occ[k] >= 0, occ
    assert occ["free"] + occ["active"] <= occ["total_pages"]
    assert occ["headroom_pages"] == occ["free"] + occ["cached_evictable"]
    rows = {r["pool"]: r for r in occ["pools"]}
    lane = rows["mem-test-lane"]
    assert lane["num_pages"] - 1 <= occ["total_pages"]
    assert lane["pages_allocated_total"] > 0
    assert lane["pages_freed_total"] > 0
    assert lane["residency"]["pages"] >= 0


def test_occupancy_and_prefix_totals_equal_jax(run):
    """The same requests through both paged engines: the same pool
    decomposition and prefix totals (residency ages are clock readings,
    and the port's pool carries this test's label)."""
    def occ(reg):
        o = reg.occupancy()
        rows = [{k: v for k, v in r.items() if k not in ("residency",
                                                          "pool")}
                for r in o["pools"]]
        return dict(o, pools=rows)

    assert occ(run["prof"]) == occ(run["jprof"])
    assert run["prof"].prefix_totals() == run["jprof"].prefix_totals()
    assert run["prof"].prefix_totals()["hit_tokens"] > 0


def test_prefix_accounting_and_report_contract(run):
    prof = run["prof"]
    pt = prof.prefix_totals()
    assert pt["lookups"] > 0
    assert pt["hit_tokens"] > 0
    rep = prof.report()
    assert rep["kind"] == "swarmdb.mem" and rep["version"] == 1
    assert rep["enabled"] is True
    assert rep["page_bytes"] > 0, "engine never priced the page"
    assert 0 < rep["prefix"]["hit_rate"] <= 1
    assert rep["conversations"]["tracked"] >= 2
    assert rep["reuse"]["sampled"] > 0
    assert rep["reuse"]["device_capacity_pages"] == \
        prof.device_capacity()
    assert len(rep["reuse"]["curve"]) == len(MEM_CURVE_POINTS)
    assert isinstance(rep["verdict"], str)
    # the JAX report's keys, field for field
    assert set(rep) == set(run["jprof"].report())
    assert rep["page_bytes"] == run["jprof"].report()["page_bytes"]


def test_warm_tier_model_and_verdict(run):
    prof = run["prof"]
    tiers = prof.warm_tier_model()
    assert [t["warm_x"] for t in tiers] == [0.5, 1.0, 2.0, 4.0]
    rates = [t["hit_rate"] for t in tiers]
    assert rates == sorted(rates), "more warm pages cannot hit less"
    assert all(t["extra_hit_rate"] >= 0 for t in tiers)
    assert all(t["readmit_ms_per_page"] > 0 for t in tiers)
    verdict = prof.verdict()
    assert isinstance(verdict, str)
    assert "warm tier" in verdict or "device pool" in verdict


def test_h2d_default_is_the_cards(monkeypatch):
    """Unset, the warm tier's re-admission is priced at the port's
    measured default (not the JAX package's 10 GB/s)."""
    monkeypatch.delenv("SWARMDB_MEM_H2D_GBPS", raising=False)
    reg = MemProfiler(enabled=True)
    reg.set_page_bytes(2 * 1024 * 1024)
    row = reg.warm_tier_model()[0]
    assert tmemprof.H2D_GBPS_DEFAULT != 10.0
    assert row["readmit_ms_per_page"] == round(
        2 * 1024 * 1024 / (tmemprof.H2D_GBPS_DEFAULT * 1e9) * 1e3, 4)


def test_mem_profile_bench_block(run):
    block = run["prof"].mem_profile()
    assert set(block["occupancy"]) == {
        "total_pages", "free", "active", "cached_evictable", "pinned",
        "headroom_pages"}
    assert block["lookups"] > 0
    assert 0 < block["prefix_hit_rate"] <= 1
    assert set(block["curve"]) == {str(x) for x in MEM_CURVE_POINTS}
    assert block["sampled_accesses"] > 0
    assert set(block["conversations"]) == {"hot", "warm", "cold"}
    assert isinstance(block["verdict"], str)


def test_prometheus_lines(run):
    body = "\n".join(run["prof"].prometheus_lines())
    for state in ("free", "active", "cached_evictable", "pinned"):
        assert f'swarmdb_mem_pool_pages{{state="{state}"}}' in body
    assert "swarmdb_mem_headroom_pages " in body
    for state in ("hot", "warm", "cold"):
        assert (f'swarmdb_conversation_temperature{{state="{state}"}}'
                in body)
    assert "swarmdb_mem_sampled_accesses_total " in body
    assert 'swarmdb_mem_curve_hit_rate{capacity="1.0x"}' in body


def test_counters_snapshot_window_shape(run):
    snap = run["prof"].counters_snapshot()
    assert set(snap) == {"hit_tokens", "miss_tokens", "lookups",
                         "full_misses", "pool_total_pages",
                         "pool_headroom_pages", "conv_touches",
                         "mono_ns"}
    assert snap["lookups"] > 0 and snap["mono_ns"] > 0
    assert set(snap) == set(run["jprof"].counters_snapshot())


# -------------------------------------------------- dump -> analyzer


def test_dump_analyzer_listing_and_memory_report(run):
    prof, tmp = run["prof"], run["tmp"]
    path = prof.dump_to(str(tmp), "test")
    kind, dump = tanalyze.load_file(path)
    assert kind == "mem"
    assert dump["node"] and dump["reason"] == "test"
    rep = tanalyze.memory_report([path])
    assert rep["kind"] == "swarmdb.obs.memory"
    d = rep["dumps"][0]
    assert d["path"] == path and d["enabled"] is True
    assert d["occupancy"]["total_pages"] > 0
    assert d["temperature"]["by_state"]["hot"] >= 2
    assert d["temperature"]["top_resident"]
    assert len(d["miss_ratio_curve"]) == len(MEM_CURVE_POINTS)
    assert d["sampling"]["sampled"] > 0
    assert isinstance(d["verdict"], str)
    tracef = tmp / "t_trace.json"
    tracef.write_text(json.dumps({"traceEvents": [
        {"name": "engine.decode_chunk", "ph": "X", "ts": 0.0,
         "dur": 1000.0, "args": {"rid": "r1"}}]}))
    listing = tanalyze.analyze_files([str(tracef)])
    listed = listing.get("mem_dumps")
    assert listed and listed[0]["path"] == path
    assert listed[0]["total_pages"] > 0
    before = set(tmp.glob("mem_*.json"))
    run["eng"].flight.auto_dump("test_reason", str(tmp))
    fresh = set(tmp.glob("mem_*.json")) - before
    assert fresh, "flight auto-dump did not ship a mem dump"


def test_memory_report_rejects_non_mem_dump(run):
    other = run["tmp"] / "x_trace.json"
    other.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(ValueError, match="swarmdb.mem"):
        tanalyze.memory_report([str(other)])


def test_each_analyzer_reads_the_others_mem_dump(run, tmp_path):
    tpath = run["prof"].dump_to(str(tmp_path / "t"), "cross")
    jpath = run["jprof"].dump_to(str(tmp_path / "j"), "cross")
    for path in (tpath, jpath):
        assert janalyze.load_file(path)[0] == "mem"
        assert tanalyze.load_file(path)[0] == "mem"
        assert (tanalyze.memory_report([path])
                == janalyze.memory_report([path]))


# ------------------------------------------------------------ sentinel SLOs


def test_mem_window_equal_jax_from_same_snapshots(monkeypatch):
    snaps = [
        {"hit_tokens": 100, "miss_tokens": 100, "lookups": 10,
         "full_misses": 2, "pool_total_pages": 200,
         "pool_headroom_pages": 50, "conv_touches": 4, "mono_ns": 1},
        {"hit_tokens": 190, "miss_tokens": 130, "lookups": 20,
         "full_misses": 3, "pool_total_pages": 200,
         "pool_headroom_pages": 8, "conv_touches": 9, "mono_ns": 2},
    ]
    out = {}
    _fresh_registries(monkeypatch)
    for name, mod, smod in (("jax", jmemprof, jsentinel),
                            ("torch", tmemprof, tsentinel)):
        feed = iter(snaps)
        monkeypatch.setattr(mod.memprof(), "counters_snapshot",
                            lambda: next(feed))
        s = smod.SLOSentinel(metrics=None,
                             config=smod.SLOConfig(enabled=True))
        windows = []
        for _ in snaps:
            w: dict = {}
            s._mem_window(w)
            windows.append(w)
        out[name] = windows
    assert out["torch"] == out["jax"]
    assert out["torch"] == [{"mem_headroom_frac": 0.25},
                            {"mem_headroom_frac": 0.04,
                             "prefix_hit_rate": 0.75}]


def _window(hit=None, headroom=None):
    w = {"completed": 20, "admission_waves": 4,
         "per_completion_ms": {"queue_wait": 5.0, "prefill": 10.0,
                               "decode": 20.0, "host_sync": 1.0},
         "p95_ttft_s": 0.5, "p95_queue_wait_s": 0.2}
    if hit is not None:
        w["prefix_hit_rate"] = hit
    if headroom is not None:
        w["mem_headroom_frac"] = headroom
    return w


def test_prefix_hit_and_headroom_slos_fire_as_in_jax():
    seq = [(0.8, 0.5), (0.8, 0.5), (0.7, 0.4), (0.3, 0.5), (0.8, 0.02)]
    out = {}
    for name, pkg in (("jax", jsentinel), ("torch", tsentinel)):
        cfg = pkg.SLOConfig(enabled=True, warmup_windows=2,
                            min_completions=8, ttft_p95_s=100.0,
                            queue_p95_s=100.0, cost_growth_x=100.0,
                            retry_rate=100.0, prefix_hit_drop_x=2.0,
                            mem_headroom_min=0.05)
        s = pkg.SLOSentinel(metrics=None, config=cfg)
        seen = []
        for hit, room in seq:
            alert = s.ingest(_window(hit, room))
            seen.append(None if alert is None else sorted(
                b["slo"] for b in alert["breaches"]))
        out[name] = seen
    assert out["torch"] == out["jax"]
    assert out["torch"] == [None, None, None, ["prefix_hit_drop_x"],
                            ["mem_headroom_min"]]


# ------------------------------------------- chaos: ledger survives kill


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_temperature_ledger_survives_lane_kill_and_replay(monkeypatch):
    """A mid-stream lane kill restarts the lane and resets its pool, but
    the service-side conversation ledger survives untouched, the
    migrated replay stays equal to the reference, and the occupancy
    decomposition stays consistent across the restart."""
    import threading

    from swarmdb_tpu_torch.backend.chaos import ServingChaos, wait_until
    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.parallel.lanes import ShardLaneGroup
    from swarmdb_tpu_torch.parallel.serving import build_serving_engine

    for k in ("SWARMDB_FLEET", "SWARMDB_KV_DTYPE"):
        monkeypatch.delenv(k, raising=False)
    _, prof = _fresh_registries(monkeypatch)
    conv = prof.conv_ledger()
    g, info = build_serving_engine(
        "tiny-debug", ["cpu", "cpu"], max_batch=4, max_seq=128, paged=True,
        page_size=8, decode_chunk=4)
    assert isinstance(g, ShardLaneGroup)
    g.start()
    sup = g.attach_supervisor(
        suspect_s=0.25, quarantine_s=0.5, poll_s=0.05,
        probe_clean_n=2, probe_timeout_s=60.0, deadline_s=120.0,
        retries=2)
    chaos = ServingChaos(g)

    def _healthy():
        return all(l["state"] == "alive" for l in sup.status()["lanes"])

    def _gen(prompt, max_new, on_token=None):
        done = threading.Event()
        out = {}
        streamed = []

        def _tok(rid, tok):
            streamed.append(tok)
            if on_token is not None:
                on_token(rid, tok, streamed)

        def _done(rid, toks, reason):
            out["toks"], out["reason"] = toks, reason
            done.set()

        g.submit(GenRequest(prompt=list(prompt),
                            sampling=TSP(max_new_tokens=max_new),
                            priority=1, shard_hint=0,
                            on_token=_tok, on_done=_done))
        assert done.wait(120.0), "request never completed"
        return out["toks"], out["reason"], streamed

    try:
        wait_until(lambda: _healthy(), 30.0, what="lanes healthy")
        pool0 = g.lanes[0].paged.allocator.mem
        assert pool0.label == "lane0"
        key = ("mem-chaos", "client")
        conv.touch(key, 4)
        conv.resident(key, 2)
        prompt = [1, 5, 9, 13]
        ref, reason, _ = _gen(prompt, 24)
        assert reason == "length" and len(ref) == 24
        allocs_before_kill = pool0.alloc_events
        assert allocs_before_kill > 0

        killed = []

        def kill_at_8(rid, tok, streamed):
            if len(streamed) == 8 and not killed:
                killed.append(True)
                chaos.kill_lane(0)

        conv.touch(key, 4)
        toks, reason, streamed = _gen(prompt, 24, on_token=kill_at_8)
        assert killed, "stream finished before the kill armed"
        assert reason == "length" and streamed == toks
        assert toks == ref, "migrated stream diverged from reference"
        wait_until(lambda: _healthy(), 60.0, what="lane 0 readmission")
        rows = {k: (touches, res)
                for k, _, touches, res, _, _ in conv.snapshot()}
        assert rows[key] == (2, 2), rows
        rep = conv.report(hot_s=120.0, warm_s=600.0)
        assert rep["by_state"]["hot"] >= 1
        assert any(r["conversation"] == "mem-chaos→client"
                   for r in rep["top_resident"])
        assert g.lanes[0].paged.allocator.mem is pool0
        assert pool0.label == "lane0"
        again, _, _ = _gen(prompt, 24)
        assert again == ref
        assert pool0.alloc_events > allocs_before_kill
        occ = prof.occupancy()
        labels = {r["pool"] for r in occ["pools"]}
        assert {"lane0", "lane1"} <= labels
        assert occ["free"] + occ["active"] <= occ["total_pages"]
        assert occ["headroom_pages"] == \
            occ["free"] + occ["cached_evictable"]
    finally:
        chaos.stop()
        sup.stop()
        g.stop()
        conv.drop(("mem-chaos", "client"))
