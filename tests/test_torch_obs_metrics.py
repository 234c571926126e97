"""The port's latency histograms and trace propagation against the JAX
package's (``obs/metrics.py``, ``obs/propagate.py``).

The same observation sequences (drawn from a numpy seed, with values on
bucket bounds and past the top) and request ids, with ``time.time``
fixed, must render the same Prometheus lines, snapshots and exemplars in
both packages, over both ladders, with histograms on and off
(``SWARMDB_HISTOGRAMS=0``) and with exemplars off. Propagation's wire
form round-trips, and the trace merge gives the same document on the
inputs of the JAX package's own merge test.
"""

import time

import numpy as np
import pytest

from swarmdb_tpu.obs import metrics as jm
from swarmdb_tpu.obs import propagate as jp
from swarmdb_tpu_torch.obs import metrics as tm
from swarmdb_tpu_torch.obs import propagate as tp

LADDERS = {"fast": jm.LADDER_FAST, "wide": jm.LADDER_WIDE}


def _observations(ladder, seed):
    """(seconds, rid or None) pairs: log-uniform values across the
    ladder and past it, every bound itself, and a zero."""
    rng = np.random.default_rng(seed)
    lo, hi = np.log10(ladder[0]) - 1, np.log10(ladder[-1]) + 1
    vals = list(10.0 ** rng.uniform(lo, hi, 200)) + list(ladder) + [0.0]
    rng.shuffle(vals)
    return [(float(v), None if i % 7 == 3 else f"rid-{i}")
            for i, v in enumerate(vals)]


def test_ladders_and_registrations_match_jax():
    assert tm.LADDER_FAST == jm.LADDER_FAST
    assert tm.LADDER_WIDE == jm.LADDER_WIDE
    jreg = sorted((h.name, h.boundaries, h.help) for h in jm.HISTOGRAMS.all())
    treg = sorted((h.name, h.boundaries, h.help) for h in tm.HISTOGRAMS.all())
    assert treg == jreg and len(treg) == 6
    for name in ("HIST_TTFT", "HIST_QUEUE_WAIT", "HIST_DECODE_CHUNK",
                 "HIST_DATAPLANE_RTT", "HIST_REPLICATION_COMMIT",
                 "HIST_PUBLISH"):
        assert getattr(tm, name).name == getattr(jm, name).name
        assert tm.HISTOGRAMS.get(getattr(tm, name).name) is getattr(tm, name)


@pytest.mark.parametrize("ladder", sorted(LADDERS))
@pytest.mark.parametrize("switch", ["on", "histograms_off", "exemplars_off"])
def test_histograms_render_as_jax(ladder, switch, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.delenv("SWARMDB_HISTOGRAMS", raising=False)
    monkeypatch.delenv("SWARMDB_EXEMPLARS", raising=False)
    if switch == "histograms_off":
        monkeypatch.setenv("SWARMDB_HISTOGRAMS", "0")
    if switch == "exemplars_off":
        monkeypatch.setenv("SWARMDB_EXEMPLARS", "0")
    regs = {"jax": jm.HistogramRegistry(), "torch": tm.HistogramRegistry()}
    obs = _observations(LADDERS[ladder], seed=len(ladder))
    out = {}
    for pkg, reg in regs.items():
        a = reg.register("a_seconds", LADDERS[ladder], "first")
        b = reg.register("b_seconds", LADDERS[ladder], "second")
        assert reg.register("a_seconds", (1.0,)) is a   # registered once
        for i, (v, rid) in enumerate(obs):
            (a if i % 3 else b).observe(v, rid)
        out[pkg] = (reg.render_prometheus(exemplars=True),
                    reg.render_prometheus(prefix="x_"),
                    a.snapshot(), b.snapshot(), reg.exemplars(),
                    a.exemplars(), a.total, a.sum_s)
    assert out["torch"] == out["jax"]
    lines, _, snap_a, _, ex, _, total, _ = out["torch"]
    if switch == "histograms_off":
        assert total == 0 and ex == {}
    else:
        assert snap_a["count"] == total > 0
        assert any("_bucket{" in ln for ln in lines)
        assert bool(ex) == (switch == "on")
        if switch == "on":
            assert any('# {trace_id="rid-' in ln for ln in lines)


def test_toggles_and_reset_match_jax():
    out = {}
    for pkg, mod in (("jax", jm), ("torch", tm)):
        reg = mod.HistogramRegistry(enabled=True)
        h = reg.register("t_seconds", mod.LADDER_FAST)
        h.observe(0.003, "r1")
        reg.set_enabled(False)
        h.observe(0.004, "r2")
        reg.set_enabled(True)
        reg.set_exemplars_enabled(False)
        h.observe(0.005, "r3")
        snap = h.snapshot()
        rids = [e["trace_id"] for e in h.exemplars()]
        reg.reset()
        out[pkg] = (snap, rids, h.snapshot(), h.exemplars())
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["count"] == 2 and out["torch"][1] == ["r1"]
    with pytest.raises(ValueError, match="strictly increasing"):
        tm.Histogram("bad", (1.0, 0.5))


def test_trace_context_round_trips_as_jax():
    for mod in (jp, tp):
        assert mod.current() is None
    ctx = tp.TraceContext("trace-1", origin="node-a")
    wire = tp.inject(ctx)
    assert wire == {"t": "trace-1", "s": ctx.span_id, "o": "node-a"}
    # the wire form crosses packages both ways
    back = jp.extract(wire)
    assert (back.trace_id, back.span_id, back.origin) == (
        "trace-1", ctx.span_id, "node-a")
    again = tp.extract(jp.inject(back))
    assert (again.trace_id, again.span_id, again.origin) == (
        "trace-1", ctx.span_id, "node-a")
    for bad in (None, {"t": 7}, "nope", {"t": ""}, {}):
        assert tp.extract(bad) is None and jp.extract(bad) is None
    partial = tp.extract({"t": "x", "s": 5, "o": None})
    assert partial.trace_id == "x" and partial.origin == tp.node_id()
    with tp.use(ctx):
        assert tp.current() is ctx and tp.inject() == wire
        with tp.use(None):
            assert tp.current() is ctx
        child = ctx.child()
        assert child.trace_id == "trace-1" and child.span_id != ctx.span_id
    assert tp.current() is None and tp.inject() is None


def _trace(anchor, pid, name, ts):
    return {
        "traceEvents": [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": "swarmdb_tpu"}},
            {"name": name, "cat": "x", "ph": "X", "pid": pid,
             "tid": 1, "ts": ts, "dur": 5.0},
        ],
        "metadata": {"anchor_epoch_s": anchor},
    }


@pytest.mark.parametrize("sources", [
    # the JAX package's merge test: node b 1 s later, a duplicate of a
    [("a", _trace(1000.0, 1, "ev-a", 100.0)),
     ("b", _trace(1001.0, 2, "ev-b", 100.0)),
     ("a-dup", _trace(1000.0, 1, "ev-a", 100.0))],
    # no anchors at all, and one source alone
    [("x", {"traceEvents": [{"name": "e", "ph": "X", "ts": 3.0,
                             "dur": 1.0}]})],
    [],
], ids=["three-nodes", "no-anchor", "empty"])
def test_merge_chrome_traces_equals_jax(sources):
    merged = tp.merge_chrome_traces(sources)
    assert merged == jp.merge_chrome_traces(sources)
    if len(sources) == 3:
        evs = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
        assert [(e["name"], e["ts"]) for e in evs] == [
            ("ev-a", 100.0), ("ev-b", 100.0 + 1e6)]
