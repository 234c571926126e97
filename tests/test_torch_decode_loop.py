"""The port's default decode loops against the JAX package's.

The paged engine decodes in device-resident sessions
(``SWARMDB_EMIT_RING``, default "1"), the dense one (and the paged one
under ``SWARMDB_EMIT_RING=0``) with ``SWARMDB_PIPELINE`` chunks in flight
(default 2), both packages alike. On the CPU the port runs each chunk
eagerly (``backend/decode_graphs.decode_chunk``); on the card as a CUDA
graph.

- The repaired fault (``binding_case``, run by
  ``tests/test_torch_decode_loop_dense.py`` and ``..._paged.py``):
  tiny-moe with 8 experts (C = N / 2) in float32, where idle and retired
  rows take capacity, gives the JAX package's greedy tokens at both
  packages' defaults and at the per-chunk settings
  (``SWARMDB_EMIT_RING=0 SWARMDB_PIPELINE=1``).
- Pipeline semantics: a slot that retires with a chunk in flight and is
  re-admitted never emits the old occupant's tokens; ``stop()`` with a
  chunk in flight completes its request.
- Resident-session semantics, held against the JAX engine (tiny-debug,
  float32): one session for requests submitted before start; queued work
  meeting a freed slot ends the session and admission follows; a cancel
  mid-session ends the request "cancelled"; a chaos kill lands at the
  loop-top seam and the supervisor replays the request to the JAX
  package's tokens.
- The environment is read where the JAX package reads it, with its
  defaults; ``SWARMDB_PREWARM=1`` makes ``ServingService.start`` warm up.
- On the card (``cuda`` marker; skips here): a captured chunk replays to
  the eager chunk's tokens, and ``LAUNCHES`` advances per replay by what
  the capture recorded.

JAX is imported inside the helpers, so the card test runs where JAX is
not installed (``python -m pytest --noconftest -m cuda``).
"""

import threading
import time

import numpy as np
import pytest
import torch

from swarmdb_tpu_torch.backend.engine import GenRequest
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.backend.service import build_backend_engine

#: tiny-debug engines of the semantics tests (the JAX side from
#: tests/test_torch_supervisor.py, same constants)
MAX_BATCH, SEQ, PS, CHUNK = 4, 128, 8, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _collect(done, streams=None):
    """(on_token, on_done) recording into ``streams[rid]`` / ``done``."""
    def on_token(rid, tok):
        if streams is not None:
            streams.setdefault(rid, []).append(tok)

    def on_done(rid, toks, why):
        done[rid] = (toks, why)

    return on_token, on_done


def _wait(done, n, timeout=120.0):
    deadline = time.time() + timeout
    while len(done) < n and time.time() < deadline:
        time.sleep(0.01)
    assert len(done) >= n, f"{len(done)} of {n} requests completed"


# ------------------------------------------------------- the repaired fault


def binding_case(monkeypatch, paged, chunked, seed):
    """tiny-moe with 8 experts, float32, max_batch 4, max_seq 96, page
    16, weights from seed 1; three requests (prompt seed ``seed``, 21,
    40 and 33 tokens, 6, 20 and 13 new) submitted before start, through
    the JAX engine and the port's, at both packages' defaults and at the
    per-chunk settings. Asserts the tokens equal both ways, that the
    port ran the intended loop, and that the MoE capacity dropped tokens
    in decode steps."""
    from swarmdb_tpu.backend.engine import GenRequest as JReq
    from swarmdb_tpu.backend.sampling import SamplingParams as JSP
    from swarmdb_tpu_torch.models import mixtral as tm
    from tests.test_torch_mixtral import (JMOE8, TMOE8, _drops, _engines,
                                          _prompts, _run_together)

    drops = []
    block = tm.moe_block

    def counting(x, router, *a, **kw):
        if x.shape[1] == 1:
            drops.append(_drops(x, router, 2, 2.0))
        return block(x, router, *a, **kw)

    monkeypatch.setattr(tm, "moe_block", counting)
    prompts = _prompts(seed, lengths=(21, 40, 33))[:3]
    news = (6, 20, 13)

    def req(cls, sp):
        return lambda p, n, done: cls(
            prompt=p, sampling=sp(max_new_tokens=n),
            on_done=lambda rid, toks, why: done.__setitem__(rid, (toks,
                                                                  why)))

    for var in ("SWARMDB_EMIT_RING", "SWARMDB_PIPELINE"):
        monkeypatch.delenv(var, raising=False)
    for per_chunk in (False, True):   # the defaults first: _engines sets
        je, te = _engines(monkeypatch, (JMOE8, TMOE8), paged, chunked,
                          seed=1, per_chunk=per_chunk)
        loop = te.stats()["decode_loop"]
        if per_chunk:
            assert loop == "pipeline 1"
        else:
            assert loop == ("resident" if paged else "pipeline 2")
        jout = _run_together(je, req(JReq, JSP), prompts, news)
        tout = _run_together(te, req(GenRequest, TSP), prompts, news)
        assert None not in tout
        assert tout == jout, ("per-chunk" if per_chunk else "defaults",
                              tout, jout)
    assert any(drops), "no decode step dropped a token"


# -------------------------------------------------------- tiny-debug pairs


def _pair(monkeypatch, kind, **env):
    """(JAX engine, port engine) of ``kind`` ("dense" / "paged") on the
    same float32 tiny-debug weights, built with ``env`` set."""
    import jax
    import jax.numpy as jnp

    from swarmdb_tpu.models import llama as jl
    from swarmdb_tpu.models.configs import get_config
    from swarmdb_tpu_torch.utils.convert import params_from_numpy
    from tests.test_torch_supervisor import _jax_engine

    monkeypatch.setenv("SWARMDB_KV_DTYPE", "f32")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jpar = jax.tree.map(lambda a: a.astype(jnp.float32),
                        jl.init_params(get_config("tiny-debug"),
                                       jax.random.PRNGKey(0)))
    je = _jax_engine(kind, jpar)
    if "SWARMDB_PIPELINE" in env:
        je.pipeline_depth = int(env["SWARMDB_PIPELINE"])
    te, _ = build_backend_engine(
        "tiny-debug", max_batch=MAX_BATCH, max_seq=SEQ, page_size=PS,
        decode_chunk=CHUNK, paged=kind == "paged", device="cpu",
        kv_dtype=torch.float32,
        params=params_from_numpy(jax.tree.map(np.asarray, jpar),
                                 device="cpu"))
    return je, te


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 259, int(k)).tolist()
            for k in rng.integers(5, 40, n)]


def _jax_generate(je, prompt, n):
    """The JAX engine's greedy (tokens, reason) for one request alone."""
    from swarmdb_tpu.backend.sampling import SamplingParams as JSP

    je.start()
    try:
        return je.generate_sync(prompt, JSP(max_new_tokens=n), timeout=120)
    finally:
        je.stop()


def _both(je, te, prompts, news):
    """Submit every request to each engine before its loop starts, run
    both to completion: (JAX results, port results, port streams)."""
    from swarmdb_tpu.backend.engine import GenRequest as JReq
    from swarmdb_tpu.backend.sampling import SamplingParams as JSP

    out = []
    streams = {}
    for eng, req, sp in ((je, JReq, JSP), (te, GenRequest, TSP)):
        done = {}
        tok, fin = _collect(done, streams if eng is te else None)
        ids = [eng.submit(req(prompt=p, sampling=sp(max_new_tokens=n),
                              on_token=tok, on_done=fin))
               for p, n in zip(prompts, news)]
        eng.start()
        try:
            _wait(done, len(ids))
        finally:
            eng.stop()
        out.append([done[i] for i in ids])
        if eng is te:
            out.append([streams.get(i, []) for i in ids])
    return out


# ------------------------------------------------------------ the pipeline


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_pipeline_discards_a_readmitted_slots_stale_lane(monkeypatch, kind):
    """Two chunks in flight (the paged engine under SWARMDB_EMIT_RING=0):
    the first request retires while its slot's next chunk is in flight,
    the queued fifth takes the slot, and the stale lane is discarded: no
    request streams a token that is not its own, and every request's
    tokens equal the JAX engine's."""
    je, te = _pair(monkeypatch, kind, SWARMDB_EMIT_RING="0")
    assert te.pipeline_depth == 2 and not te._resident
    stale = []
    host_block = te._process_host_block

    def spying(block, lps, snapshot, t_dispatch_ns):
        stale.extend(i for i, req, _ in snapshot
                     if te.slots[i].active and te.slots[i].request is not req)
        return host_block(block, lps, snapshot, t_dispatch_ns)

    te._process_host_block = spying
    prompts = _prompts(5, seed=1)
    news = (3, 30, 30, 30, 20)
    jout, tout, streams = _both(je, te, prompts, news)
    assert stale, "no chunk was in flight over a re-admitted slot"
    assert tout == jout
    for (toks, why), streamed in zip(tout, streams):
        assert why == "length" and streamed == toks


def test_stop_completes_a_request_with_a_chunk_in_flight(monkeypatch):
    """A stop raised while the first chunk is processed (the second is in
    flight) drains the second: its request completes with the JAX
    engine's tokens. With one chunk in flight it would be left active."""
    je, te = _pair(monkeypatch, "dense")
    prompt, n = _prompts(1, seed=2)[0], 2 * CHUNK + 1
    ref = _jax_generate(je, prompt, n)
    done, seen = {}, []

    def on_token(rid, tok):
        seen.append(tok)
        if len(seen) == CHUNK + 1:   # the first chunk's last token
            with te._cv:
                te._stop = True
                te._cv.notify_all()

    te.submit(GenRequest(prompt=prompt, sampling=TSP(max_new_tokens=n),
                         on_token=on_token,
                         on_done=lambda rid, toks, why: done.update(
                             out=(toks, why))))
    te.start()
    te._thread.join(timeout=60)
    assert not te._thread.is_alive()
    te.stop()
    assert done.get("out") == ref
    assert te.metrics.counters["engine_decode_chunks"].value == 2


# ---------------------------------------------------- the resident session


def _counts(eng):
    c = eng.metrics.counters
    return (c["engine_resident_sessions"].value,
            c["engine_resident_chunks"].value)


def test_resident_one_session_for_requests_submitted_before_start(
        monkeypatch):
    je, te = _pair(monkeypatch, "paged")
    assert te._resident
    jout, tout, _ = _both(je, te, _prompts(3, seed=3), (10, 20, 15))
    assert tout == jout
    assert _counts(te) == _counts(je)
    assert _counts(te)[0] == 1


def test_resident_queued_work_at_a_free_slot_ends_the_session(monkeypatch):
    """Five requests, four slots: when the short one retires the queued
    one meets its slot, the vote ends the session, admission follows and
    a second session runs; sessions, chunks and tokens as in JAX."""
    je, te = _pair(monkeypatch, "paged")
    jout, tout, _ = _both(je, te, _prompts(5, seed=4), (3, 24, 24, 24, 12))
    assert tout == jout
    assert _counts(te) == _counts(je)
    assert _counts(te)[0] == 2


def test_resident_cancel_mid_session(monkeypatch):
    """A cancel from the token stream retires the request "cancelled" at
    the next processed chunk, with the tokens of the chunk it came in,
    and the session ends with it; as in JAX."""
    je, te = _pair(monkeypatch, "paged")
    from swarmdb_tpu.backend.engine import GenRequest as JReq
    from swarmdb_tpu.backend.sampling import SamplingParams as JSP

    prompt = _prompts(1, seed=5)[0]
    out = []
    for eng, req, sp in ((je, JReq, JSP), (te, GenRequest, TSP)):
        done = {}
        seen = []

        def on_token(rid, tok, eng=eng, seen=seen):
            seen.append(tok)
            if len(seen) == 5:
                eng.cancel(rid)

        eng.submit(req(prompt=prompt, sampling=sp(max_new_tokens=40),
                       on_token=on_token,
                       on_done=lambda rid, toks, why, done=done:
                           done.update(out=(toks, why))))
        eng.start()
        try:
            _wait(done, 1)
        finally:
            eng.stop()
        out.append(done["out"])
    assert out[1] == out[0]
    assert out[1][1] == "cancelled" and 5 <= len(out[1][0]) < 40
    assert _counts(te) == _counts(je)


# the injected LaneKilled is an unhandled thread exception: the fault
# under test
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_resident_chaos_kill_lands_at_the_seam_and_replays(monkeypatch):
    """A kill armed mid-session ends the session through the vote, lands
    at the loop-top seam (the thread dies), and the supervisor's replay
    finishes the request with the JAX engine's tokens."""
    from swarmdb_tpu_torch.backend.chaos import ServingChaos
    from swarmdb_tpu_torch.backend.supervisor import LaneSupervisor

    je, te = _pair(monkeypatch, "paged")
    prompt, n = _prompts(1, seed=6)[0], 24
    ref = _jax_generate(je, prompt, n)
    te.start()
    sup = LaneSupervisor(te, suspect_s=0.25, quarantine_s=1.0, poll_s=0.05,
                         probe_clean_n=2, probe_timeout_s=60.0,
                         deadline_s=120.0, retries=2).start()
    chaos = ServingChaos(te)
    done, streamed, killed = threading.Event(), [], []
    out = {}

    def on_token(rid, tok):
        streamed.append(tok)
        if len(streamed) == 6 and not killed:
            killed.append(_counts(te))
            chaos.kill_lane(0)

    def on_done(rid, toks, why):
        out.update(toks=toks, why=why)
        done.set()

    try:
        sup.submit(GenRequest(prompt=prompt, sampling=TSP(max_new_tokens=n),
                              on_token=on_token, on_done=on_done))
        assert done.wait(120), "the replayed request never completed"
    finally:
        chaos.stop()
        sup.stop()
        te.stop()
    assert killed
    assert (out["toks"], out["why"]) == ref
    assert streamed == out["toks"]
    kinds = [e.get("kind") for e in te.flight.events()]
    assert "chaos.kill_fired" in kinds and "engine.restart" in kinds
    # the kill's session ended early; the replay ran in another
    assert _counts(te)[0] >= 2
    assert te.metrics.counters["requests_retried"].value >= 1


# ------------------------------------------------------------- environment


def test_loop_settings_are_read_at_build(monkeypatch):
    """``build_backend_engine`` reads SWARMDB_PIPELINE (default 2) for
    both engines and the engine SWARMDB_EMIT_RING (default on, paged
    only), as the JAX package does."""
    for var in ("SWARMDB_PIPELINE", "SWARMDB_EMIT_RING"):
        monkeypatch.delenv(var, raising=False)

    def loop(paged):
        eng, _ = build_backend_engine("tiny-debug", max_batch=2, max_seq=64,
                                      paged=paged, device="cpu")
        return eng.stats()["decode_loop"]

    assert (loop(False), loop(True)) == ("pipeline 2", "resident")
    monkeypatch.setenv("SWARMDB_PIPELINE", "3")
    monkeypatch.setenv("SWARMDB_EMIT_RING", "0")
    assert (loop(False), loop(True)) == ("pipeline 3", "pipeline 3")


@pytest.mark.parametrize("prewarm", ["1", "0", None])
def test_prewarm_env_warms_the_engine_before_start(monkeypatch, tmp_path,
                                                   prewarm):
    """``ServingService.start(warmup=None)`` warms the engine up when
    SWARMDB_PREWARM is "1" (default "0"), before its loop starts; warmup
    refuses an engine already started."""
    from swarmdb_tpu_torch.backend.service import ServingService
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    if prewarm is None:
        monkeypatch.delenv("SWARMDB_PREWARM", raising=False)
    else:
        monkeypatch.setenv("SWARMDB_PREWARM", prewarm)
    monkeypatch.setenv("SWARMDB_SUPERVISE", "0")
    db = SwarmDB(broker=LocalBroker(), save_dir=str(tmp_path))
    svc = ServingService.from_model_name(db, "tiny-debug", max_batch=2,
                                         max_seq=64, device="cpu")
    calls = []
    warm = svc.engine.warmup
    svc.engine.warmup = lambda: calls.append(svc.engine._thread) or warm()
    try:
        svc.start()
        assert calls == ([None] if prewarm == "1" else [])
        with pytest.raises(RuntimeError):
            warm()
    finally:
        svc.stop()
        db.close()


# ---------------------------------------------------------------- the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("paged,chunked", [(True, True), (None, True),
                                           (True, False)])
def test_graph_replay_equals_eager_chunk(monkeypatch, cuda_device, paged,
                                         chunked):
    """tiny-debug in float32 on the card: one greedy chunk replayed as a
    graph and the same chunk run eagerly from the same saved state give
    equal tokens and logprobs within 1e-5 (float32, the same kernels);
    each replay adds the launches the capture recorded and the capture
    itself adds none."""
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    monkeypatch.setenv("SWARMDB_CHUNKED", "1" if chunked else "0")
    eng, _ = build_backend_engine("tiny-debug", max_batch=4, max_seq=256,
                                  paged=paged, device=cuda_device,
                                  kv_dtype=torch.float32)
    with torch.no_grad():
        for p in _prompts(3, seed=7):
            eng.submit(GenRequest(prompt=p, sampling=TSP(max_new_tokens=32)))
        eng._admit()
        positions = np.array([s.dispatched_position if s.active else 0
                              for s in eng.slots], np.int32)
        inputs = eng._chunk_inputs(positions)
        state = [eng._last_tokens, eng._last_lps, eng._io.positions]
        state += list(eng.cache.values() if paged else eng.cache)
        saved = [t.clone() for t in state]
        ac.reset_launches()
        eng._runner.capture(2)
        assert not any(ac.LAUNCHES.values())
        per_replay = eng._runner.graph_launches[2]
        assert per_replay and all(n > 0 for n in per_replay.values())
        g_tok, g_lp = eng._runner.launch(2, inputs).host()
        assert {k: n for k, n in ac.LAUNCHES.items() if n} == per_replay
        for t, v in zip(state, saved):
            t.copy_(v)
        for buf, a in zip(eng._io.inputs(), inputs):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        eng._chunk_body(2)
        torch.cuda.synchronize()
    live = [i for i, s in enumerate(eng.slots) if s.active]
    assert np.array_equal(g_tok[:, live], eng._io.block.cpu().numpy()[:,
                                                                       live])
    np.testing.assert_allclose(g_lp[:, live],
                               eng._io.block_lps.cpu().numpy()[:, live],
                               atol=1e-5, rtol=0)
