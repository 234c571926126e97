"""PyTorch port vs JAX reference: the device-time profiler.

Every case of ``tests/test_profiler.py`` against the port (the harvest at
warmup and none after, per-variant device time, lane duty cycles, the
dispatch-shape profile and its tiny flush waves, flag-off type identity,
the report / Prometheus / trace / dump surfaces, the peak table and the
sentinel's MFU / duty objectives), plus parity with the JAX package on
the same config, weights and prompts:

- the harvested variant keys equal the JAX engine's (paged and dense);
- the dispatch-shape profile (kind, width, waves, packed, padding) and
  ``tiny_flush_waves`` are equal, with ``SWARMDB_RAGGED_MIN_WIDTH=1`` in
  both packages as in the reference test;
- the port's GEMM FLOPs per variant equal ``FlopCounterMode``'s count of
  the plain CPU forward at the variant's shape (attention left out), and
  its FLOPs stand within a measured ratio of XLA's ``cost_analysis`` for
  the same variant (XLA also counts elementwise work);
- ``_profile_window`` folds the same snapshots into the same window
  fields, and ``mfu_drop_x`` / ``duty_drop_x`` fire on the same synthetic
  sequence in both packages;
- each package's ``analyze.py --roofline`` reads the other's dump to the
  same report, on-chip memory column included (only a card dump's
  top-level budget differs: the port reads the card's opt-in shared
  memory per block where the JAX package reads its default VMEM).

Each package's process-global profiler is swapped for a fresh one per
fixture (xdist-safe: no case reads another file's traffic).
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
from swarmdb_tpu_torch.obs import cost as tcost
from swarmdb_tpu_torch.obs import sentinel as tsentinel
from swarmdb_tpu_torch.obs.profiler import (NULL_LANE, KernelProfiler,
                                            LaneProfile, NullLane,
                                            platform_peaks, profiler)
from swarmdb_tpu_torch.utils.convert import params_from_numpy

# the modules (each package's obs/__init__ exports a same-named function)
jprofiler = importlib.import_module("swarmdb_tpu.obs.profiler")
tprofiler = importlib.import_module("swarmdb_tpu_torch.obs.profiler")

CFG = get_config("tiny-debug")
MAX_BATCH, SEQ, PS = 4, 96, 16

#: 15 tokens -> largest-fit ragged waves w8 + w4 + w2 + w1 (tiny flush)
PROMPTS = [[1, 5, 9, 2, 7] * 3, [4] * 37, [7]]

#: port FLOPs / XLA cost_analysis FLOPs per harvested variant, as
#: measured on tiny-debug and tiny-moe (XLA also prices elementwise work
#: and its reference attention at full shapes; the port prices GEMMs and
#: the attention at the variant's static context): prefill waves 0.45 -
#: 1.78. XLA prices a decode chunk's scanned loop body once, so a decode
#: chunk's ratio over its K steps is held instead: 0.67 - 1.70
FLOP_RATIO_BOUND = {"prefill": (0.4, 2.0), "decode": (0.6, 1.8)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh_registries(mp):
    """Both packages' process-global profilers replaced for a fixture."""
    mp.setattr(jprofiler, "_PROFILER", jprofiler.KernelProfiler())
    mp.setattr(tprofiler, "_PROFILER", tprofiler.KernelProfiler())


def _pair(paged, mp, cfg=CFG):
    """JAX and port engines on one set of float32 weights."""
    mp.setenv("SWARMDB_KV_DTYPE", "f32")
    for k in ("SWARMDB_PAGED", "SWARMDB_CHUNKED", "SWARMDB_EMIT_RING",
              "SWARMDB_FLEET", "SWARMDB_ROLLING_KV", "SWARMDB_PROFILE"):
        mp.delenv(k, raising=False)
    je, _ = jsvc.build_backend_engine(cfg, max_batch=MAX_BATCH, max_seq=SEQ,
                                      paged=paged, page_size=PS)
    je.params = jax.tree.map(lambda a: a.astype(jnp.float32), je.params)
    te, _ = tsvc.build_backend_engine(
        cfg.name, max_batch=MAX_BATCH, max_seq=SEQ, paged=paged,
        page_size=PS, device="cpu",
        kv_dtype=None if paged else torch.float32,
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
    """The shared profiled run: fresh registries -> both packages' paged
    engines -> the port's warmup (harvest) and the JAX engine's harvest
    -> serve PROMPTS in both -> capture every surface."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SWARMDB_RAGGED_MIN_WIDTH", "1")
    _fresh_registries(mp)
    je, te = _pair(True, mp)
    te._prof.set_label("prof-test-loaded")
    prof = profiler()
    te.warmup()
    harvest_at_warmup = prof.harvest_calls
    device_s_after_warmup = sum(
        v["device_s"] for v in prof.variants_report())
    je.profile_harvest()
    _serve(te, PROMPTS, TSP)
    _serve(je, PROMPTS, JSP)
    yield {
        "prof": prof,
        "jprof": jprofiler.profiler(),
        "eng": te,
        "jeng": je,
        "harvest_at_warmup": harvest_at_warmup,
        "device_s_after_warmup": device_s_after_warmup,
        "tmp": tmp_path_factory.mktemp("profdump"),
    }
    mp.undo()


# ------------------------------------------------------- harvest discipline


def test_cost_harvest_at_warmup_zero_after(run):
    prof = run["prof"]
    assert run["harvest_at_warmup"] > 0, "warmup harvested nothing"
    assert run["device_s_after_warmup"] == 0.0, \
        "warmup was billed as device time"
    assert prof.harvest_calls == run["harvest_at_warmup"], \
        "harvest leaked past warmup"
    rep = prof.report()
    assert rep["enabled"] is True
    ran = [v for v in rep["variants"] if v["invocations"] > 0]
    assert ran, "no runtime attribution recorded"
    assert all(v["device_s"] > 0 for v in ran)
    full = [v for v in ran if v.get("mfu") is not None]
    assert full, f"no harvested variant executed: {rep['variants']}"
    assert full[0]["roofline"] in ("compute-bound", "memory-bound")
    assert full[0]["arithmetic_intensity"] > 0
    assert full[0]["achieved_flops_per_s"] > 0
    assert rep["mfu"] is not None and 0 < rep["mfu"] <= 1


def test_harvest_covers_ragged_variants_with_kernel_meta(run):
    ragged = [v for v in run["prof"].variants_report()
              if v["variant"].startswith("prefill.ragged[")]
    assert ragged, "ragged variants not harvested"
    assert all(v["flops_per_call"] for v in ragged)
    # which CUDA kernel these seconds measure on the card
    assert ragged[0]["meta"]["kernel"] in ("ragged_prefill",
                                           "ragged_prefill_quant")
    decode = [v for v in run["prof"].variants_report()
              if v["variant"].startswith(("decode.", "resident."))]
    assert decode and all(v["meta"]["kernel"] == run["eng"]._decode_kernel
                          for v in decode)


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_harvested_keys_equal_jax(kind, monkeypatch):
    """The port's harvest names exactly the JAX engine's variants: the
    same families over the same shapes (``prof_key``)."""
    monkeypatch.setenv("SWARMDB_RAGGED_MIN_WIDTH", "1")
    _fresh_registries(monkeypatch)
    je, te = _pair(True if kind == "paged" else None, monkeypatch)
    assert je.profile_harvest() > 0
    te.warmup()
    jkeys = {v["variant"] for v in jprofiler.profiler().variants_report()}
    tkeys = {v["variant"] for v in profiler().variants_report()}
    assert tkeys == jkeys
    assert profiler().harvest_calls == len(tkeys)


# ------------------------------------------------------------- duty cycles


def test_duty_cycle_loaded_vs_idle_lane(run):
    idle, _ = tsvc.build_backend_engine(
        "tiny-debug", max_batch=MAX_BATCH, max_seq=SEQ, paged=True,
        page_size=PS, device="cpu")
    idle._prof.set_label("prof-test-idle")
    lanes = {r["lane"]: r for r in run["prof"].lanes_report()
             if r["lane"].startswith("prof-test-")}
    assert set(lanes) == {"prof-test-loaded", "prof-test-idle"}
    for r in lanes.values():
        assert 0.0 <= r["duty_cycle"] <= 1.0
        assert r["elapsed_s"] >= 0
    assert (lanes["prof-test-loaded"]["duty_cycle"]
            > lanes["prof-test-idle"]["duty_cycle"])
    assert lanes["prof-test-idle"]["busy_s"] == 0.0


# ----------------------------------------------------- dispatch-shape profile


def test_dispatch_profile_and_tiny_flush_detection(run):
    prof = run["prof"]
    rows = {(r["kind"], r["width"]): r for r in prof.dispatch_profile()}
    assert ("ragged", 1) in rows, rows.keys()
    tiny = rows[("ragged", 1)]
    assert tiny["tiny_flush"] is True
    assert tiny["waves"] >= 1 and tiny["packed_tokens"] >= 1
    assert prof.tiny_flush_waves() >= 1
    ragged = [r for (k, _w), r in rows.items() if k == "ragged"]
    assert sum(r["padding_tokens"] for r in ragged) == 0
    assert (sum(r["packed_tokens"] for r in ragged)
            == sum(len(p) for p in PROMPTS))
    assert tiny["variants"] == ["prefill.ragged[w1]"]
    assert tiny["variant_invocations"] >= tiny["waves"]
    assert tiny["variant_device_s"] > 0


def test_wave_table_and_tiny_flush_equal_jax(run):
    """The same prompts through both engines give the same (kind, width)
    rows, waves, packed and padding tokens, and tiny flush waves."""
    def table(prof):
        return [(r["kind"], r["width"], r["waves"], r["packed_tokens"],
                 r["padding_tokens"], r.get("tiny_flush", False),
                 r.get("variants")) for r in prof.dispatch_profile()]

    assert table(run["prof"]) == table(run["jprof"])
    assert run["prof"].tiny_flush_waves() == run["jprof"].tiny_flush_waves()


# ------------------------------------------------------- flag-off identity


def test_profile_flag_off_type_identity(monkeypatch):
    monkeypatch.setenv("SWARMDB_PROFILE", "0")
    _fresh_registries(monkeypatch)
    reg = KernelProfiler()
    lane = reg.lane()
    assert type(lane) is NullLane
    assert lane is NULL_LANE is reg.lane(), \
        "disabled lanes must be THE shared NullLane singleton"
    assert lane.enabled is False
    eng, _ = tsvc.build_backend_engine("tiny-debug", max_batch=2,
                                       max_seq=64, device="cpu")
    assert eng._prof is NULL_LANE
    before = profiler().harvest_calls
    eng.warmup()
    _serve(eng, [[1, 7, 3]], TSP, n=4)
    assert profiler().harvest_calls == before
    lane.dispatch("decode.full", 0, 10)
    lane.wave("ragged", 1, 1, 0)
    assert reg.variants_report() == []
    assert reg.dispatch_profile() == []
    assert profiler().variants_report() == []


def test_profile_flag_on_is_lane_profile(run):
    assert type(run["eng"]._prof) is LaneProfile


# -------------------------------------------------------- derived surfaces


def test_prometheus_and_report_contract(run):
    prof = run["prof"]
    body = "\n".join(prof.prometheus_lines())
    assert "swarmdb_mfu " in body
    assert 'swarmdb_lane_duty_cycle{lane="prof-test-loaded"}' in body
    assert 'swarmdb_kernel_device_seconds_total{variant="' in body
    assert 'swarmdb_kernel_invocations_total{variant="' in body
    rep = prof.report()
    assert rep["kind"] == "swarmdb.profile" and rep["version"] == 1
    assert rep["platform"] == "cpu"
    assert rep["peaks"]["peak_flops"] > 0
    assert rep["harvest_calls"] > 0
    # the JAX report's keys, field for field
    assert set(rep) == set(run["jprof"].report())


def test_chrome_trace_device_tracks(run):
    from swarmdb_tpu_torch.obs import TRACER

    trace = TRACER.to_chrome_trace()
    trace = run["prof"].merge_chrome_trace(trace)
    assert trace["metadata"]["device_tracks"] >= 1
    dev = [e for e in trace["traceEvents"] if e.get("cat") == "device"]
    assert dev, "no device events merged"
    names = {e["args"]["name"] for e in trace["traceEvents"]
             if e.get("name") == "thread_name" and e["tid"] >= 900000}
    assert any(n.startswith("device:") for n in names)


def test_dump_analyzer_listing_and_roofline(run):
    prof, tmp = run["prof"], run["tmp"]
    path = prof.dump_to(str(tmp), "test")
    kind, dump = tanalyze.load_file(path)
    assert kind == "profile"
    report = tanalyze.roofline_report([path], top_n=3)
    top = report["dumps"][0]["top_variants"]
    assert len(top) == 3
    assert top == sorted(top, key=lambda v: -v["device_s"])
    assert all(v["invocations"] > 0 and v["device_s"] > 0 for v in top)
    assert report["dumps"][0]["peaks"]["peak_flops"] > 0
    tracef = tmp / "t_trace.json"
    tracef.write_text(json.dumps({"traceEvents": [
        {"name": "engine.decode_chunk", "ph": "X", "ts": 0.0,
         "dur": 1000.0, "args": {"rid": "r1"}}]}))
    rep = tanalyze.analyze_files([str(tracef)])
    listed = rep.get("profile_dumps")
    assert listed and listed[0]["path"] == path
    assert listed[0]["top_variant"]
    before = set(tmp.glob("profile_*.json"))
    run["eng"].flight.auto_dump("test_reason", str(tmp))
    fresh = set(tmp.glob("profile_*.json")) - before
    assert fresh, "flight auto-dump did not ship a profile dump"


def _no_vmem(report):
    """The report without what differs by nature: a card dump's top-level
    budget (the port's ``smem_budget`` knows the card's opt-in limit, the
    JAX package's ``vmem_budget`` reads an unknown kind as 16 MiB). Each
    variant row's budget comes from the dump itself in both."""
    for d in report["dumps"]:
        if "nvidia" in str(d.get("device_kind") or "").lower():
            d.pop("vmem_budget_bytes")
        d.pop("path")
    return report


def test_each_analyzer_reads_the_others_profile_dump(run, tmp_path):
    """Both schemas are one: either package's --roofline gives the same
    report of either package's dump, the on-chip memory column
    included."""
    tpath = run["prof"].dump_to(str(tmp_path / "t"), "cross")
    jpath = run["jprof"].dump_to(str(tmp_path / "j"), "cross")
    for path in (tpath, jpath):
        assert janalyze.load_file(path)[0] == "profile"
        assert tanalyze.load_file(path)[0] == "profile"
        assert (_no_vmem(tanalyze.roofline_report([path]))
                == _no_vmem(janalyze.roofline_report([path])))


def test_platform_peaks_table_and_overrides(monkeypatch):
    monkeypatch.delenv("SWARMDB_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("SWARMDB_PEAK_BW", raising=False)
    h100 = platform_peaks("gpu", "NVIDIA H100 80GB HBM3")
    assert h100["peak_flops"] == 989e12
    assert h100["peak_bytes_per_s"] == 3.35e12
    assert h100["ridge_flops_per_byte"] > 1
    cpu = platform_peaks("cpu")
    assert cpu["peak_flops"] < h100["peak_flops"]
    # no TPU row: the port never runs on one
    assert platform_peaks("tpu", "TPU v5e")["peak_flops"] == cpu[
        "peak_flops"]
    monkeypatch.setenv("SWARMDB_PEAK_FLOPS", "1e15")
    assert platform_peaks("gpu", "weird-card")["peak_flops"] == 1e15


# ------------------------------------------------------------ GEMM FLOPs


def _attention_out(q, *args, **kwargs):
    """Attention left out of the count: an output of the right shape."""
    return torch.zeros_like(q)


def _count(fn, monkeypatch):
    from torch.utils.flop_counter import FlopCounterMode

    from swarmdb_tpu_torch.models import llama as tl

    for name in ("ragged_prefill_dispatch", "gqa_attention",
                 "gqa_attention_prefix", "gqa_attention_chunked",
                 "paged_attention_dispatch_chunked",
                 "paged_attention_dispatch"):
        if hasattr(tl, name):
            monkeypatch.setattr(tl, name, _attention_out)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("model", ["tiny-debug", "tiny-moe"])
@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_gemm_flops_equal_flop_counter(model, kind, monkeypatch, capsys):
    """Each harvested family's GEMM FLOPs equal FlopCounterMode's count
    of the plain CPU forward at the variant's shape; beside them, the
    variant's total against XLA's cost_analysis for the same key."""
    cfg = get_config(model)
    monkeypatch.setenv("SWARMDB_RAGGED_MIN_WIDTH", "1")
    _fresh_registries(monkeypatch)
    if cfg.is_moe:
        from swarmdb_tpu.models import mixtral as jmx
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              jmx.init_params(cfg, jax.random.PRNGKey(0)))
        monkeypatch.setattr(jmx, "init_params", lambda c, k: params)
    je, te = _pair(True if kind == "paged" else None, monkeypatch, cfg)
    je.profile_harvest()
    te.warmup()
    p, B, K = te.params, te.max_batch, te.decode_chunk
    dev = te.device
    rng = np.random.default_rng(0)
    tokens = lambda *shape: torch.from_numpy(
        rng.integers(3, cfg.vocab_size, shape).astype(np.int64)).to(dev)
    checked = {}

    def check(key, rows, tokens_per_row, head_rows, fn):
        want = tcost.gemm_flops(cfg, rows * tokens_per_row, head_rows)
        got = _count(fn, monkeypatch)
        assert got == want, (key, got, want)
        checked[key] = got

    bucket = te.prefill_buckets[0]
    if kind == "dense":
        Bp = te.prefill_batch
        check(f"prefill.dense[r{Bp}xb{bucket}]", Bp, bucket, Bp,
              lambda: te._forward_fn(
                  p, tokens(Bp, bucket),
                  torch.arange(bucket).expand(Bp, bucket),
                  te._init_cache_fn(Bp, bucket),
                  logits_at=torch.full((Bp,), bucket - 1)))
        ppb = te._prefix_pp_buckets[0]
        lane_pages = min(ppb + -(-bucket // PS), SEQ // PS)
        check(f"prefill.dense_prefix[r{Bp}xb{bucket}xp{ppb}]", Bp, bucket,
              Bp, lambda: te._prefix_lane_fwd(
                  p, tokens(Bp, bucket),
                  torch.ones((Bp, ppb), dtype=torch.int32),
                  torch.full((Bp,), ppb * PS, dtype=torch.int32),
                  *te._prefix_pool, lane_pages,
                  logits_at=torch.full((Bp,), bucket - 1)))
    elif te._ragged:
        wd = te._ragged_widths[2]
        R, maxp = B, te.paged.allocator.maxp
        z = lambda n: torch.zeros(n, dtype=torch.int32)
        check(f"prefill.ragged[w{wd}]", 1, wd, R,
              lambda: te.paged.prefill_ragged(
                  p, tokens(wd), z(wd), torch.arange(wd, dtype=torch.int32),
                  torch.zeros((R, maxp), dtype=torch.int32), z(R),
                  torch.tensor([wd] + [0] * (R - 1), dtype=torch.int32),
                  z(R), te.cache["k"], te.cache["v"]))
    else:
        rb = te._row_buckets[-1]
        check(f"prefill.paged[r{rb}xb{bucket}]", rb, bucket, rb,
              lambda: te._forward_fn(
                  p, tokens(rb, bucket),
                  torch.arange(bucket).expand(rb, bucket),
                  te._init_cache_fn(rb, bucket),
                  logits_at=torch.full((rb,), bucket - 1)))
        ppb = te._prefix_pp_buckets[0]
        check(f"prefill.paged_prefix[r{rb}xb{bucket}xp{ppb}]", rb, bucket,
              rb, lambda: te._prefix_pages_fwd(
                  p, tokens(rb, bucket),
                  torch.ones((rb, ppb), dtype=torch.int32),
                  torch.full((rb,), ppb * PS, dtype=torch.int32),
                  te.cache["k"], te.cache["v"],
                  logits_at=torch.full((rb,), bucket - 1)))
    # a decode chunk: K steps over every row, the head at every row
    want = K * tcost.gemm_flops(cfg, B, B)
    got = _count(lambda: te._chunk_body(2), monkeypatch)
    assert got == want, ("decode", got, want)
    checked["decode.greedy"] = got
    # beside XLA's cost model for the same keys
    jrows = {v["variant"]: v for v in jprofiler.profiler().variants_report()}
    trows = {v["variant"]: v for v in profiler().variants_report()}
    with capsys.disabled():
        for key in checked:
            jf = jrows[key]["flops_per_call"]
            tf = trows[key]["flops_per_call"]
            ratio = tf / jf
            family = "prefill"
            if key.startswith("decode."):
                family, ratio = "decode", ratio / K
            print(f"\n{model} {key}: port {tf:.4g} (GEMM {checked[key]:.4g})"
                  f" XLA {jf:.4g} ratio {tf / jf:.3f} ({family} bound "
                  f"{FLOP_RATIO_BOUND[family]} on {ratio:.3f})")
            lo, hi = FLOP_RATIO_BOUND[family]
            assert lo <= ratio <= hi, (key, tf, jf)


# ------------------------------------------------------------ sentinel SLOs


def _window(completed=20, mfu=None, duty=None):
    w = {
        "completed": completed, "admission_waves": 4,
        "per_completion_ms": {"queue_wait": 5.0, "prefill": 10.0,
                              "decode": 20.0, "host_sync": 1.0},
        "p95_ttft_s": 0.5, "p95_queue_wait_s": 0.2,
    }
    if mfu is not None:
        w["mfu"] = mfu
    if duty is not None:
        w["min_lane_duty"] = duty
    return w


SEQUENCE = [(0.02, 0.6), (0.02, 0.6), (0.018, 0.55), (0.005, 0.6),
            (0.02, 0.1)]


@pytest.mark.parametrize("pkg", [jsentinel, tsentinel],
                         ids=["jax", "torch"])
def test_sentinel_mfu_and_duty_slos(pkg):
    cfg = pkg.SLOConfig(enabled=True, warmup_windows=2, min_completions=8,
                        ttft_p95_s=100.0, queue_p95_s=100.0,
                        cost_growth_x=100.0, retry_rate=100.0,
                        mfu_drop_x=2.0, duty_drop_x=2.0)
    s = pkg.SLOSentinel(metrics=None, config=cfg)
    for _ in range(2):
        assert s.ingest(_window(mfu=0.02, duty=0.6)) is None
    assert s.baseline["mfu"] == pytest.approx(0.02)
    assert s.baseline["min_lane_duty"] == pytest.approx(0.6)
    assert s.ingest(_window(mfu=0.018, duty=0.55)) is None
    alert = s.ingest(_window(mfu=0.005, duty=0.6))
    assert alert is not None
    assert any(b["slo"] == "mfu_drop_x" for b in alert["breaches"])
    alert2 = s.ingest(_window(mfu=0.02, duty=0.1))
    assert any(b["slo"] == "duty_drop_x" for b in alert2["breaches"])
    lines = "\n".join(s.prometheus_lines())
    assert "swarmdb_slo_window_mfu" in lines
    assert "swarmdb_slo_min_lane_duty" in lines


def test_sentinel_alerts_equal_jax_on_one_sequence():
    """The same synthetic window sequence raises the same breaches in
    both packages."""
    out = {}
    for name, pkg in (("jax", jsentinel), ("torch", tsentinel)):
        cfg = pkg.SLOConfig(enabled=True, warmup_windows=2,
                            min_completions=8, ttft_p95_s=100.0,
                            queue_p95_s=100.0, cost_growth_x=100.0,
                            retry_rate=100.0, mfu_drop_x=2.0,
                            duty_drop_x=2.0)
        s = pkg.SLOSentinel(metrics=None, config=cfg)
        seen = []
        for mfu, duty in SEQUENCE:
            alert = s.ingest(_window(mfu=mfu, duty=duty))
            seen.append(None if alert is None else sorted(
                (b["slo"], b.get("limit")) for b in alert["breaches"]))
        out[name] = (seen, s.baseline)
    assert out["torch"] == out["jax"]
    assert [x is not None for x in out["torch"][0]] == [
        False, False, False, True, True]


def test_sentinel_profile_window_fold(monkeypatch):
    _fresh_registries(monkeypatch)
    prof = profiler()
    s = tsentinel.SLOSentinel(metrics=None,
                              config=tsentinel.SLOConfig(enabled=True))
    prof.set_platform("cpu", "")
    prof.record_variant("fold.test.variant", 1e6, 2e6)
    lane = prof.lane("fold-test")
    w1: dict = {}
    s._profile_window(w1)
    assert "mfu" not in w1
    lane.dispatch("fold.test.variant", 0, 5_000_000)
    w2: dict = {}
    s._profile_window(w2)
    assert w2["mfu"] > 0
    assert 0.0 <= w2["min_lane_duty"] <= 1.0


def test_profile_window_equal_jax_from_same_snapshots(monkeypatch):
    """Fed the same cumulative snapshots, both packages' folds write the
    same window fields."""
    _fresh_registries(monkeypatch)
    snaps = [
        {"flops_total": 1e9, "device_s_total": 0.1,
         "lane_busy_ns": {"lane0": 1_000_000, "lane1": 0},
         "mono_ns": 1_000_000_000},
        {"flops_total": 9e9, "device_s_total": 0.5,
         "lane_busy_ns": {"lane0": 401_000_000, "lane1": 100_000_000},
         "mono_ns": 2_000_000_000},
    ]
    out = {}
    for name, pmod, smod in (("jax", jprofiler, jsentinel),
                             ("torch", tprofiler, tsentinel)):
        reg = pmod.profiler()
        reg.set_platform("cpu", "")
        feed = iter(snaps)
        monkeypatch.setattr(reg, "counters_snapshot", lambda: next(feed))
        s = smod.SLOSentinel(metrics=None,
                             config=smod.SLOConfig(enabled=True))
        windows = []
        for _ in snaps:
            w: dict = {}
            s._profile_window(w)
            windows.append(w)
        out[name] = windows
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == {"mfu": round(8e9 / 1.0 / 5e10, 6),
                               "min_lane_duty": 0.1}
