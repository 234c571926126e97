"""The port's kernel sanitizer on the CPU.

The CUDA kernels' bounds-checked build runs only on the card
(``chip_smoke.py``'s ``sanitize`` phase); here the host half is held
against the JAX package's: the wave-descriptor audit on the same inputs,
the ragged write replay, the differential soups (the port's plain ragged
and decode versions against the JAX package's shadow interpreter over the
real Pallas kernels), seeded short-write / oob-block / write-race /
wrong-output defects through stand-in launch callables, the capture-time
skip, the device record's reading, and the report / dump / flight
contract. Each fixture resets both registries.
"""

import json
import os

import numpy as np
import pytest
import torch

from swarmdb_tpu.obs import kerncheck as jax_kerncheck
from swarmdb_tpu_torch.obs import kerncheck as torch_kerncheck
from swarmdb_tpu_torch.ops import attention_cuda, build, layers, paged_kv


@pytest.fixture()
def kerncheck_on(monkeypatch, tmp_path):
    monkeypatch.setenv("SWARMDB_KERNCHECK", "1")
    monkeypatch.setenv("SWARMDB_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("SWARMDB_NODE_ID", "testnode")
    for kc in (jax_kerncheck, torch_kerncheck):
        kc.registry().reset()
    yield torch_kerncheck
    for kc in (jax_kerncheck, torch_kerncheck):
        kc.registry().reset()


def _kinds(kc):
    return [v["kind"] for v in kc.registry().violations()]


def _ragged(seed):
    c = torch_kerncheck.random_ragged_case(np.random.default_rng(seed))
    return c, {k: torch.as_tensor(v) for k, v in c.items()}


# ------------------------------------------------------ descriptor audit

WAVES = {
    "clean": (np.array([0, 1, 2, 3], np.int32),
              np.array([0, 5, 7, 8], np.int32), None),
    "oob": (np.array([1], np.int32), np.array([4], np.int32), (1, 1, 11)),
    "trash": (np.array([0], np.int32), np.array([1], np.int32), "zero"),
    "dup": (np.array([0, 0], np.int32), np.array([1, 1], np.int32), None),
}


@pytest.mark.parametrize("case", sorted(WAVES))
def test_wave_descriptors_match_jax(case, kerncheck_on):
    """check_wave_descriptors on the same inputs in both packages: the
    same count, kinds and ``where``."""
    R, maxp, ps, P = 3, 2, 4, 8
    tables = np.array([[3, 4], [5, 6], [7, 2]], np.int32)
    tok_row, tok_pos, edit = WAVES[case]
    if edit == "zero":
        tables = np.zeros_like(tables)
    elif edit is not None:
        tables = tables.copy()
        tables[edit[0], edit[1]] = edit[2]
    out = {}
    for name, kc in (("jax", jax_kerncheck), ("torch", torch_kerncheck)):
        n = kc.check_wave_descriptors(tok_row, tok_pos, tables, P, ps)
        out[name] = (n, [(v["kind"], v["rule"], v["where"])
                         for v in kc.registry().violations()])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == (0 if case == "clean" else 1)


# ------------------------------------------------------- write replay

@pytest.mark.parametrize("quant", [False, True])
def test_checked_write_replay_clean(quant, kerncheck_on):
    """checked_paged_write_ragged on the real in-place write: the audit
    and the replay of the touched pages agree, zero violations."""
    rng = np.random.default_rng(1)
    L, P, ps, Hkv, D = 2, 10, 4, 2, 8
    kp = torch.as_tensor(rng.standard_normal((L, P, ps, Hkv, D)),
                         dtype=torch.float32)
    vp = torch.as_tensor(rng.standard_normal((L, P, ps, Hkv, D)),
                         dtype=torch.float32)
    if quant:
        kp = paged_kv.QuantPool(*paged_kv._quantize_pages(kp))
        vp = paged_kv.QuantPool(*paged_kv._quantize_pages(vp))
    sk = torch.as_tensor(rng.standard_normal((L, 8, Hkv, D)),
                         dtype=torch.float32)
    sv = torch.as_tensor(rng.standard_normal((L, 8, Hkv, D)),
                         dtype=torch.float32)
    tables = torch.as_tensor(
        np.array([[3, 4, 0], [5, 0, 0], [6, 7, 0]], np.int32))
    tok_row = torch.as_tensor(np.array([0, 0, 1, 1, 1, 2, 5, 5], np.int32))
    tok_pos = torch.as_tensor(np.array([3, 4, 0, 1, 2, 7, 0, 0], np.int32))
    f = kerncheck_on.checked_paged_write_ragged(paged_kv.paged_write_ragged)
    assert f is not paged_kv.paged_write_ragged
    f(kp, vp, sk, sv, tok_row, tok_pos, tables)
    assert kerncheck_on.registry().violations() == []
    assert kerncheck_on.registry().report()["checks"][
        "shadow.paged-write-ragged"] == 1


def test_checked_write_replay_catches_a_misplaced_token(kerncheck_on):
    """A write that lands a token one slot off is a parity violation."""
    rng = np.random.default_rng(2)
    kp = torch.zeros((1, 6, 4, 1, 8))
    vp = torch.zeros_like(kp)
    sk = torch.as_tensor(rng.standard_normal((1, 4, 1, 8)),
                         dtype=torch.float32)
    tables = torch.as_tensor(np.array([[2, 3]], np.int32))
    tok_row = torch.zeros(4, dtype=torch.int32)
    tok_pos = torch.arange(4, dtype=torch.int32)

    def off_by_one(k, v, s_k, s_v, trow, tpos, tab):
        return paged_kv.paged_write_ragged(k, v, s_k, s_v, trow, tpos + 1,
                                           tab)

    kerncheck_on.checked_paged_write_ragged(off_by_one)(
        kp, vp, sk, sk, tok_row, tok_pos, tables)
    assert _kinds(kerncheck_on) == ["parity"]


# ---------------------------------------------------- differential soups

@pytest.mark.parametrize("seed", [0, 1])
def test_plain_ragged_matches_jax_interpreter(seed, kerncheck_on):
    """The port's plain ragged prefill against the JAX package's shadow
    interpreter over the real Pallas kernel, on the differential soup,
    in f32 within 1e-4 on live tokens; neither records a violation."""
    c, t = _ragged(seed)
    want = jax_kerncheck.shadow_ragged_prefill(
        c["q"], c["sfx_k"], c["sfx_v"], c["k_pages"], c["v_pages"],
        c["tables"], c["starts"], c["lens"], c["plens"])
    got = attention_cuda.ragged_prefill_plain(
        t["q"], t["sfx_k"], t["sfx_v"], t["k_pages"], t["v_pages"],
        t["tables"], t["starts"], t["lens"], t["plens"]).numpy()
    live = c["tok_row"] < c["tables"].shape[0]
    assert float(np.abs(got[live] - want[live]).max()) < 1e-4
    assert jax_kerncheck.registry().violations() == []
    assert kerncheck_on.differential_ragged_prefill(
        seed, rounds=2, device="cpu") == 0


def test_plain_ragged_int8_matches_jax_interpreter(kerncheck_on):
    """int8 pages: the port's plain version over the QuantPool against
    the JAX interpreter over the same pages dequantized, within 6e-2."""
    c, t = _ragged(3)
    kq, ks = paged_kv._quantize_pages(t["k_pages"])
    vq, vs = paged_kv._quantize_pages(t["v_pages"])
    deq_k = paged_kv._dequantize_pages(kq, ks).numpy()
    deq_v = paged_kv._dequantize_pages(vq, vs).numpy()
    want = jax_kerncheck.shadow_ragged_prefill(
        c["q"], c["sfx_k"], c["sfx_v"], deq_k, deq_v, c["tables"],
        c["starts"], c["lens"], c["plens"])
    got = attention_cuda.ragged_prefill_quant_plain(
        t["q"], t["sfx_k"], t["sfx_v"], kq, ks, vq, vs, t["tables"],
        t["starts"], t["lens"], t["plens"]).numpy()
    live = c["tok_row"] < c["tables"].shape[0]
    assert float(np.abs(got[live] - want[live]).max()) < 6e-2
    assert kerncheck_on.differential_ragged_prefill(
        3, rounds=1, quantized=True, tol=6e-2, device="cpu") == 0


@pytest.mark.parametrize("quant", [False, True])
def test_plain_decode_matches_jax_interpreter(quant, kerncheck_on):
    """The port's plain paged decode against the JAX interpreter over the
    Pallas paged-decode kernel on the decode soup (empty slots included):
    f32 within 1e-4, int8 within 6e-2; the port's soup over all its
    decode entry points stays clean."""
    rng = np.random.default_rng(5)
    for _ in range(3):
        c = torch_kerncheck.random_decode_case(rng)
        t = {k: torch.as_tensor(v) for k, v in c.items()}
        kp, vp = t["k_pages"], t["v_pages"]
        jk, jv = c["k_pages"], c["v_pages"]
        if quant:
            kq, ks = paged_kv._quantize_pages(kp)
            vq, vs = paged_kv._quantize_pages(vp)
            kp, vp = paged_kv.QuantPool(kq, ks), paged_kv.QuantPool(vq, vs)
            jk = paged_kv._dequantize_pages(kq, ks).numpy()
            jv = paged_kv._dequantize_pages(vq, vs).numpy()
        want = jax_kerncheck.shadow_paged_decode(
            c["q"], jk, jv, c["table"], c["lengths"])
        got = attention_cuda.paged_decode_plain(
            t["q"], kp, vp, t["table"], t["lengths"]).numpy()
        live = c["lengths"] > 0
        if live.any():
            err = float(np.abs(got[live] - want[live]).max())
            assert err < (6e-2 if quant else 1e-4)
    assert jax_kerncheck.registry().violations() == []
    tol = 6e-2 if quant else 2e-2
    assert kerncheck_on.differential_paged_decode(
        0, rounds=3, quantized=quant, tol=tol, device="cpu") == 0
    key = "differential.paged-decode" + (".int8" if quant else "")
    assert kerncheck_on.registry().report()["checks"][key] == 3


# ------------------------------------------------------ seeded defects

def _call_ragged(f, t, **kw):
    return f(t["q"], t["sfx_k"], t["sfx_v"], t["k_pages"], t["v_pages"],
             t["tables"], t["starts"], t["lens"], t["plens"], **kw)


def test_checked_ragged_clean_on_the_real_dispatch(kerncheck_on):
    c, t = _ragged(7)
    f = kerncheck_on.checked_ragged_prefill_dispatch(
        layers.ragged_prefill_dispatch)
    out = _call_ragged(f, t)
    assert kerncheck_on.registry().violations() == []
    want = attention_cuda.ragged_prefill_plain(
        t["q"], t["sfx_k"], t["sfx_v"], t["k_pages"], t["v_pages"],
        t["tables"], t["starts"], t["lens"], t["plens"])
    assert torch.equal(out, want)     # positions no row owns stay zero
    assert kerncheck_on.registry().report()["checks"][
        "shadow.ragged-prefill"] == 1


def test_seeded_short_write(kerncheck_on, tmp_path):
    """A launch that skips one live row's stores leaves the canary there:
    a short-write naming the row, dumped the moment it is recorded."""
    c, t = _ragged(3)
    live_r = int(np.nonzero(c["lens"] > 0)[0][0])
    s0, n0 = int(c["starts"][live_r]), int(c["lens"][live_r])

    def skips_a_row(q, *args, window=None, out=None):
        keep = out[s0:s0 + n0].clone()
        layers.ragged_prefill_dispatch(q, *args, window=window, out=out)
        out[s0:s0 + n0] = keep
        return out

    _call_ragged(kerncheck_on.checked_ragged_prefill_dispatch(skips_a_row),
                 t)
    vs = kerncheck_on.registry().violations()
    assert {v["kind"] for v in vs} == {"short-write", "parity"}
    sw = next(v for v in vs if v["kind"] == "short-write")
    assert f"row {live_r}" in sw["message"] and sw["rule"] == "SWL905"
    dump = json.loads((tmp_path / "kerncheck_testnode.json").read_text())
    assert dump["violations"]


def test_seeded_oob_page_id(kerncheck_on):
    """A table holding page id P + 5: the host audit names the row, the
    column and the id before the launch (the card's checked build names
    the block too; chip_smoke.py's sanitize phase)."""
    c, t = _ragged(4)
    P = c["k_pages"].shape[0]
    r = int(np.nonzero((c["lens"] > 0) & (c["plens"] > 0))[0][0])
    t["tables"] = t["tables"].clone()
    t["tables"][r, 0] = P + 5
    seen = []

    def stand_in(q, *args, window=None, out=None):
        seen.append(out)
        return torch.zeros_like(q)

    _call_ragged(kerncheck_on.checked_ragged_prefill_dispatch(stand_in), t)
    vs = kerncheck_on.registry().violations()
    assert [v["kind"] for v in vs] == ["oob-block"]
    assert vs[0]["where"] == {"row": r, "column": 0, "page": P + 5}
    assert vs[0]["rule"] == "SWL901"
    assert seen, "the launch still runs (the kernel clamps)"


def test_seeded_write_race(kerncheck_on):
    """Two ragged rows overlapping in the stream: a write-race naming both
    rows, from the host audit before the launch."""
    c, t = _ragged(6)
    live = np.nonzero(c["lens"] > 0)[0]
    a, b = int(live[0]), int(live[1])
    t["starts"] = t["starts"].clone()
    t["starts"][b] = t["starts"][a]
    _call_ragged(kerncheck_on.checked_ragged_prefill_dispatch(
        lambda q, *args, window=None, out=None: torch.zeros_like(q)), t)
    vs = kerncheck_on.registry().violations()
    assert [v["kind"] for v in vs] == ["write-race"]
    assert sorted(vs[0]["where"]["rows"]) == sorted([a, b])


def test_seeded_wrong_output(kerncheck_on):
    """A dispatch that returns garbage is a parity violation (the JAX
    package's rogue-dispatch case), for the ragged prefill and for the
    single-step paged decode."""
    c, t = _ragged(2)
    _call_ragged(kerncheck_on.checked_ragged_prefill_dispatch(
        lambda q, *args, window=None, out=None: torch.zeros_like(q) + 42.0),
        t)
    d = torch_kerncheck.random_decode_case(np.random.default_rng(9))
    d["lengths"][0] = 5
    q = torch.as_tensor(d["q"])[:, None]
    pos = torch.as_tensor(d["lengths"] - 1)[:, None]
    kerncheck_on.checked_paged_attention_dispatch(
        lambda q, *args, window=None, out=None: torch.zeros_like(q) + 42.0)(
        q, torch.as_tensor(d["k_pages"]), torch.as_tensor(d["v_pages"]),
        torch.as_tensor(d["table"]), pos)
    vs = kerncheck_on.registry().violations()
    assert {(v["kind"], v["kernel"]) for v in vs} == {
        ("parity", "ragged_paged_prefill_attention"),
        ("parity", "paged_decode_gqa_attention")}


def test_checked_decode_audit_and_clean_dispatch(kerncheck_on):
    """The single-step decode wrapper: clean on the real dispatch (canary
    overwritten on every live slot); a length past the table's coverage
    is an oob-block before the launch."""
    d = torch_kerncheck.random_decode_case(np.random.default_rng(4))
    args = [torch.as_tensor(d[k]) for k in ("k_pages", "v_pages", "table")]
    q = torch.as_tensor(d["q"])[:, None]
    f = kerncheck_on.checked_paged_attention_dispatch(
        layers.paged_attention_dispatch)
    out = f(q, *args, torch.as_tensor(np.maximum(d["lengths"] - 1, 0))[:,
                                                                      None])
    assert out.shape == q.shape
    assert kerncheck_on.registry().violations() == []
    cov = d["table"].shape[1] * d["k_pages"].shape[1]
    pos = torch.zeros((q.shape[0], 1), dtype=torch.int32)
    pos[2, 0] = cov + 3
    f(q, *args, pos)
    vs = kerncheck_on.registry().violations()
    assert [v["kind"] for v in vs] == ["oob-block"]
    assert vs[0]["where"] == {"slot": 2, "length": cov + 4}


def test_capture_time_calls_are_skipped(kerncheck_on, monkeypatch):
    """A call made while a CUDA graph is captured (the counterpart of the
    JAX package's tracer skip) goes straight to the dispatch: no audit,
    no canary, no tally."""
    monkeypatch.setattr(torch_kerncheck, "_capturing", lambda: True)
    c, t = _ragged(1)
    calls = []

    def stand_in(q, *args, window=None, out=None):
        calls.append(out)
        return torch.zeros_like(q) + 42.0

    _call_ragged(kerncheck_on.checked_ragged_prefill_dispatch(stand_in), t)
    assert calls == [None]
    assert kerncheck_on.registry().report()["checks"] == {}
    assert kerncheck_on.registry().violations() == []


def test_wide_calls_are_skipped(kerncheck_on, monkeypatch):
    monkeypatch.setenv("SWARMDB_KERNCHECK_MAX_W", "4")
    c, t = _ragged(1)
    _call_ragged(kerncheck_on.checked_ragged_prefill_dispatch(
        layers.ragged_prefill_dispatch), t)
    assert kerncheck_on.registry().report()["checks"] == {}


# ------------------------------------------------- the device record

def test_device_record_read_into_the_registry(kerncheck_on, monkeypatch):
    """kerncheck_poll reads a device's record mirror (no sync: it is host
    memory) and files an oob-block naming the entry point, the block,
    its cluster rank, the id and its bound, and a write-race naming both
    blocks; then clears the record."""
    words = {f: 0 for f in attention_cuda.KC_FIELDS}
    oob = dict(words, hits=3, taken=1,
               entry=build.KERNELS.index("ragged_prefill"), site=1, bx=4,
               by=2, bz=0, rank=-1, raw=1029, bound=1024, other=-1)
    race = dict(words, hits=1, taken=1,
                entry=build.KERNELS.index("paged_decode"), site=5, bx=3,
                by=1, bz=2, rank=3, raw=17, bound=5, other=8, ox=0, oy=1,
                oz=0)
    host = torch.tensor([oob[f] for f in attention_cuda.KC_FIELDS]
                        + [race[f] for f in attention_cuda.KC_FIELDS],
                        dtype=torch.int32)
    dev_rec = host.clone()
    monkeypatch.setitem(attention_cuda._KC_RECORDS, 5, (dev_rec, host))
    hits = attention_cuda.kerncheck_poll(torch.device("cuda", 5))
    assert [h["kind"] for h in hits] == ["oob-block", "write-race"]
    vs = kerncheck_on.registry().violations()
    assert [(v["kind"], v["kernel"]) for v in vs] == [
        ("oob-block", "ragged_prefill"), ("write-race", "paged_decode")]
    assert vs[0]["where"] == {"block": [4, 2, 0], "rank": -1,
                              "site": "page id", "index": 1029,
                              "bound": 1024}
    assert vs[1]["where"]["blocks"] == [[0, 1, 0], [3, 1, 2]]
    assert "cluster rank 3" in vs[1]["message"]
    assert int(host.abs().sum()) == 0 and int(dev_rec.abs().sum()) == 0
    assert attention_cuda.kerncheck_poll(torch.device("cuda", 5)) == []


def test_checked_build_is_a_second_library(monkeypatch):
    """The checked variant of every kernel is its own library (-kc- in
    the name, the flag in its hash) and is the one launched under the
    flag, or where use_checked_build says so."""
    for name in build.KERNELS:
        plain, kc = build.library_path(name), build.library_path(name, True)
        assert plain != kc and "-kc-" in kc.name
        assert "-kc-" not in plain.name
    monkeypatch.delenv("SWARMDB_KERNCHECK", raising=False)
    assert attention_cuda.kerncheck_launches() is False
    with attention_cuda.use_checked_build(True):
        assert attention_cuda.kerncheck_launches() is True
    monkeypatch.setenv("SWARMDB_KERNCHECK", "1")
    assert attention_cuda.kerncheck_launches() is True
    with attention_cuda.use_checked_build(False):
        assert attention_cuda.kerncheck_launches() is False


def test_dispatchers_picked_at_engine_build(kerncheck_on):
    ragged, decode = layers.attention_dispatchers()
    assert ragged.__wrapped__ is layers.ragged_prefill_dispatch
    assert decode.__wrapped__ is layers.paged_attention_dispatch


# ------------------------------------------- report / dump / flight

def test_report_prometheus_and_dump_contract(kerncheck_on, tmp_path):
    reg = kerncheck_on.registry()
    reg.note_check("shadow.ragged-prefill")
    text = "\n".join(reg.prometheus_lines())
    assert "swarmdb_kernel_violations_total 0" in text
    assert ('swarmdb_kernel_checks_total{check="shadow.ragged-prefill"}'
            ' 1') in text
    reg.record("oob-block", "k", "seeded", {"grid": [1, 2]})
    assert "swarmdb_kernel_violations_total 1" in "\n".join(
        reg.prometheus_lines())
    dump = json.loads((tmp_path / "kerncheck_testnode.json").read_text())
    assert dump["violations"][0]["kind"] == "oob-block"
    assert dump["violations"][0]["rule"] == "SWL901"
    rep = reg.report()
    assert rep["enabled"] is True and rep["node"] == "testnode"
    assert set(rep) == set(jax_kerncheck.registry().report())
    reg.record("oob-block", "k", "seeded", {"grid": [1, 2]})
    assert len(reg.violations()) == 1


def test_violation_emits_flight_instant(kerncheck_on):
    from swarmdb_tpu_torch.obs.flight import FlightRecorder

    fl = FlightRecorder(n_events=16)
    reg = kerncheck_on.registry()
    reg.attach_flight(fl)
    reg.record("short-write", "kern", "seeded short write", {"row": 1})
    ev = [e for e in fl.events() if e.get("kind") == "kerncheck.violation"]
    assert ev and ev[0]["violation_kind"] == "short-write"
    assert ev[0]["rule"] == "SWL905"


def test_analyzer_lists_kerncheck_dumps(kerncheck_on, tmp_path):
    kerncheck_on.registry().record(
        "write-race", "paged_write_ragged", "seeded", {"cells": [5]})
    from swarmdb_tpu_torch.obs.analyze import _synthetic_trace, analyze_files

    trace_path = tmp_path / "trace.json"
    trace_path.write_text(json.dumps(
        {"traceEvents": _synthetic_trace(5.0, 10.0, 20.0)}))
    dumps = analyze_files([str(trace_path)]).get("kerncheck_dumps")
    assert dumps and dumps[0]["violations"] == 1
    assert dumps[0]["node"] == "testnode"
    assert dumps[0]["violation_kinds"] == ["write-race"]
    assert dumps[0]["kernels"] == ["paged_write_ragged"]


@pytest.mark.cuda
def test_checked_build_catches_on_the_card():
    """On the card: the bounds-checked build names the block of a clamped
    page id and both blocks of an overlapping row (chip_smoke.py's
    sanitize phase runs the same at Llama-3-8B's widths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the checked build is CUDA C++")
    torch_kerncheck.registry().reset()
    c, t = _ragged(4)
    t = {k: v.cuda() for k, v in t.items()}
    P = c["k_pages"].shape[0]
    r = int(np.nonzero((c["lens"] > 0) & (c["plens"] > 0))[0][0])
    t["tables"][r, 0] = P + 5
    with attention_cuda.use_checked_build(True):
        _call_ragged(layers.ragged_prefill_dispatch, t)
        torch.cuda.synchronize()
    hits = attention_cuda.kerncheck_poll(torch.device("cuda", 0))
    assert [h["kind"] for h in hits] == ["oob-block"]
    assert hits[0]["raw"] == P + 5 and hits[0]["bound"] == P
    assert os.environ.get("SWARMDB_KERNCHECK", "0") in ("", "0")
