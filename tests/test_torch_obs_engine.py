"""The port's engine feeds against the JAX engine's: spans, flight steps,
request records, histograms and phase counters.

Both packages' paged and dense tiny-debug engines (float32, one set of
weights) serve the same prompts, drawn from a numpy seed. Compared:

- the span names of each request (``engine.admit``, ``engine.prefill``,
  ``engine.decode_chunk``), and ``engine.host_sync`` spans in the trace;
- the flight step keys, but for the documented difference: the port
  stamps ``decode_kernel`` (the CUDA kernel's name) on the dense engine's
  steps too, where the JAX engine stamps it on paged steps only;
- the request-record keys;
- the histogram counts: TTFT = requests served, queue wait = requests
  admitted, decode chunk = chunks processed; and one decode-chunk span per
  snapshot slot of every processed chunk.

Host syncs per request differ by design: the port waits on every chunk
(its record reads the request's chunks + 1), the JAX resident session
once per session (at most 3); each package is held to its own rule.
A two-lane group stamps its steps with ``shard`` in both packages, and a
sentinel set on the group reaches every lane.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend import service as jsvc
from swarmdb_tpu.backend.engine import GenRequest as JReq
from swarmdb_tpu.backend.sampling import SamplingParams as JSP
from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu.obs import TRACER as JTRACER
from swarmdb_tpu.obs import metrics as jm
from swarmdb_tpu_torch.backend import service as tsvc
from swarmdb_tpu_torch.backend.engine import GenRequest as TReq
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.obs import TRACER as TTRACER
from swarmdb_tpu_torch.obs import metrics as tm
from swarmdb_tpu_torch.utils.convert import params_from_numpy

CFG = get_config("tiny-debug")
MAX_BATCH, SEQ, PS, CHUNK, NEW = 4, 128, 8, 4, 10
PKG = {"jax": (JReq, JSP, JTRACER, jm), "torch": (TReq, TSP, TTRACER, tm)}
ENGINE_SPANS = {"engine.admit", "engine.prefill", "engine.decode_chunk"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32_params():
    return jax.tree.map(lambda a: a.astype(jnp.float32),
                        jl.init_params(CFG, jax.random.PRNGKey(0)))


def _engines(kind, monkeypatch):
    monkeypatch.setenv("SWARMDB_KV_DTYPE", "f32")
    for k in ("SWARMDB_PAGED", "SWARMDB_CHUNKED", "SWARMDB_EMIT_RING",
              "SWARMDB_FLEET"):
        monkeypatch.delenv(k, raising=False)
    paged = True if kind == "paged" else None
    je, _ = jsvc.build_backend_engine(CFG, max_batch=MAX_BATCH, max_seq=SEQ,
                                      paged=paged, page_size=PS,
                                      decode_chunk=CHUNK)
    je.params = jax.tree.map(lambda a: a.astype(jnp.float32), je.params)
    te, _ = tsvc.build_backend_engine(
        "tiny-debug", max_batch=MAX_BATCH, max_seq=SEQ, paged=paged,
        page_size=PS, decode_chunk=CHUNK, device="cpu",
        kv_dtype=None if paged else torch.float32,
        params=params_from_numpy(jax.tree.map(np.asarray, je.params),
                                 device="cpu"))
    return {"jax": je, "torch": te}


def _serve(pkg, eng, prompts):
    """Every prompt at once; waits until all finished and the loop is
    idle. Returns the request ids."""
    Req, SP, _, _ = PKG[pkg]
    events, rids = [], []
    for i, p in enumerate(prompts):
        ev = threading.Event()
        req = Req(prompt=list(p), sampling=SP(max_new_tokens=NEW),
                  on_done=lambda *a, _e=ev: _e.set())
        req.metadata["message_id"] = f"m{i}"
        rids.append(req.request_id)
        events.append(ev)
        eng.submit(req)
    for ev in events:
        assert ev.wait(120), f"{pkg}: a request never finished"
    deadline = time.time() + 10
    while eng._any_active() and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.3)    # the loop's trailing flight step
    return rids


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_engine_feeds_match_jax(kind, monkeypatch):
    engines = _engines(kind, monkeypatch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, 259, n).tolist() for n in (15, 37, 9, 22, 30)]
    got = {}
    for pkg, eng in engines.items():
        _, _, tracer, hm = PKG[pkg]
        tracer.reset()
        hm.HISTOGRAMS.reset()
        eng.start()
        try:
            rids = _serve(pkg, eng, prompts)
        finally:
            eng.stop()
        c = eng.metrics.counters
        trace = tracer.to_chrome_trace()
        spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
        got[pkg] = dict(
            rids=rids, spans=spans, counters=c,
            names={rid: {e["name"] for e in tracer.events_for(rid)}
                   for rid in rids},
            steps=eng.flight.steps(), reqs=eng.flight.requests(),
            hist={h: getattr(hm, h).total for h in
                  ("HIST_TTFT", "HIST_QUEUE_WAIT", "HIST_DECODE_CHUNK")})
    j, t = got["jax"], got["torch"]
    n = len(prompts)
    for side in (j, t):
        for rid in side["rids"]:
            assert ENGINE_SPANS <= side["names"][rid], side["names"][rid]
        names = [e["name"] for e in side["spans"]]
        assert names.count("engine.host_sync") >= 1
        assert names.count("engine.admit") == names.count(
            "engine.prefill") == n
        assert side["hist"]["HIST_TTFT"] == n
        assert side["hist"]["HIST_QUEUE_WAIT"] == \
            side["counters"]["engine_admitted"].value == n
        assert len(side["reqs"]) == n
        assert side["counters"]["phase_us_host_sync"].value > 0
        assert "phase_us_queue_wait" in side["counters"]
    # the set of span names per request, request by request
    assert [t["names"][r] for r in t["rids"]] == \
        [j["names"][r] for r in j["rids"]]
    # the engine's spans carry the JAX engine's args
    prefill = [e for e in t["spans"] if e["name"] == "engine.prefill"]
    assert {e["args"]["mid"] for e in prefill} == {f"m{i}" for i in range(n)}
    assert all(0 <= e["args"]["slot"] < MAX_BATCH for e in prefill)
    # chunks processed: the port counts them at dispatch, the JAX package
    # in resident sessions (paged) or one host sync per chunk (dense)
    chunks = t["counters"]["engine_decode_chunks"].value
    assert t["hist"]["HIST_DECODE_CHUNK"] == chunks > 0
    jchunks = (j["counters"]["engine_resident_chunks"].value
               if kind == "paged"
               else j["counters"]["engine_host_syncs"].value)
    assert j["hist"]["HIST_DECODE_CHUNK"] == jchunks > 0
    # one decode-chunk span per snapshot slot of each processed chunk:
    # at least one per chunk, and per request as many as its chunks
    per_rid = {}
    for e in t["spans"]:
        if e["name"] == "engine.decode_chunk":
            rid = e["args"]["rid"]
            per_rid[rid] = per_rid.get(rid, 0) + 1
    assert chunks <= sum(per_rid.values()) <= chunks * MAX_BATCH
    # flight steps: the same keys but for the documented difference
    jkeys = set().union(*(s.keys() for s in j["steps"]))
    tkeys = set().union(*(s.keys() for s in t["steps"]))
    extra = {"decode_kernel"} if kind == "dense" else set()
    assert tkeys == jkeys | extra, (tkeys ^ jkeys)
    assert {s["decode_kernel"] for s in t["steps"]} == {
        "paged_decode_chunked" if kind == "paged" else
        "dense_decode_chunked"}
    assert t["steps"][-1]["compiled_variants"] == 0   # no graph on a CPU
    # the ring's last step holds the settled counters
    last, c = t["steps"][-1], t["counters"]
    for key, counter in (("tokens_generated", "tokens_generated"),
                         ("prompt_tokens", "prompt_tokens"),
                         ("host_syncs", "engine_host_syncs"),
                         ("prefill_packed_tokens", "prefill_packed_tokens"),
                         ("restarts", "engine_restarts")):
        assert last[key] == c[counter].value, key
    assert last["active"] == last["queued"] == 0
    # request records: the same keys; host syncs each package's own rule
    assert set(t["reqs"][0]) == set(j["reqs"][0])
    for rec in t["reqs"]:
        assert rec["generated"] == NEW and rec["reason"] == "length"
        assert rec["submitted_at"] <= rec["admitted_at"] <= \
            rec["first_token_at"] <= rec["retired_at"]
        assert 2 <= rec["host_syncs"] <= chunks + 1
        assert per_rid[rec["rid"]] >= rec["host_syncs"] - 1
    if kind == "paged":
        assert all(r["host_syncs"] <= 3 for r in j["reqs"])


def test_lane_steps_carry_shard_and_the_sentinel_reaches_every_lane(
        monkeypatch, tmp_path):
    from swarmdb_tpu.parallel.mesh import make_mesh
    from swarmdb_tpu.parallel.serving import build_serving_engine as jbuild
    from swarmdb_tpu_torch.backend.service import ServingService
    from swarmdb_tpu_torch.backend.tokenizer import default_tokenizer
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.obs.sentinel import SLOSentinel
    from swarmdb_tpu_torch.parallel.serving import build_serving_engine

    monkeypatch.setenv("SWARMDB_KV_DTYPE", "f32")
    for k in ("SWARMDB_FLEET", "SWARMDB_PAGED", "SWARMDB_EMIT_RING"):
        monkeypatch.delenv(k, raising=False)
    params = _f32_params()
    with monkeypatch.context() as m:
        m.setattr(jl, "init_params", lambda cfg, key: jax.device_put(
            params, jax.config.jax_default_device))
        jg, _ = jbuild(CFG, make_mesh(2, data=2, model=1, expert=1),
                       max_batch=MAX_BATCH, max_seq=SEQ, paged=True,
                       page_size=PS, decode_chunk=CHUNK)
    tg, _ = build_serving_engine(
        "tiny-debug", ["cpu", "cpu"], max_batch=MAX_BATCH, max_seq=SEQ,
        paged=True, page_size=PS, decode_chunk=CHUNK,
        params=params_from_numpy(jax.tree.map(np.asarray, params),
                                 device="cpu"))
    shards = {}
    for pkg, g in (("jax", jg), ("torch", tg)):
        Req, SP, _, _ = PKG[pkg]
        g.start()
        try:
            events = []
            for i in range(4):
                ev = threading.Event()
                events.append(ev)
                g.submit(Req(prompt=[3 + i, 4, 5, 6], shard_hint=i % 2,
                             sampling=SP(max_new_tokens=6),
                             on_done=lambda *a, _e=ev: _e.set()))
            assert all(ev.wait(120) for ev in events)
        finally:
            g.stop()
        shards[pkg] = {s.get("shard") for s in g.flight.steps()}
    assert shards["torch"] == shards["jax"] == {0, 1}
    # the setter passes a sentinel to every lane, as the JAX group's does
    sent = SLOSentinel()
    tg.sentinel = sent
    assert tg.sentinel is sent
    assert all(e.sentinel is sent for e in tg.lanes)
    db = SwarmDB(broker=LocalBroker(), save_dir=str(tmp_path))
    try:
        svc = ServingService(db, tg, default_tokenizer(CFG.vocab_size))
        assert tg.sentinel is db.sentinel
        assert all(e.sentinel is db.sentinel for e in tg.lanes)
        assert db.sentinel.flight is tg.flight
        assert db.sentinel.tracer is TTRACER
        if svc.supervisor is not None:
            svc.supervisor.stop()
    finally:
        db.close()
