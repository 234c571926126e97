"""Request supervision and serving chaos on one engine, against the JAX
reference: the cases of ``tests/test_serving_chaos.py`` that apply to a
single engine, supervised as a group of one lane, on the CPU (lane
groups: ``tests/test_torch_lane_chaos.py``).

- an idle engine beats and reads alive; the retryable-reason contract
  is the JAX package's;
- a request cut off by ``kill_lane`` at any chunk boundary is replayed
  (prompt + the tokens already emitted) and its greedy float32 tokens
  equal an undisturbed run's and the JAX package's (exactly), with no
  token repeated or lost in the stream;
- a wedged loop is quarantined with its thread alive and re-admitted
  after heal; a restart mid-stream is retried; a deadline ends a request
  that cannot be served ("deadline", never a hang), queued or wedged;
- pool pressure pauses admission with hysteresis and sheds only the
  lowest priority, and the supervisor's retries serve a shed request
  once the pool heals;
- through ``ServingService``: supervised by default, a killed decode
  still ends "length"; with ``SWARMDB_SUPERVISE=0`` the retryable
  finish reaches the caller, as in the JAX package;
- a cancel reaches a request parked on a retry timer.

Both engines (dense and paged) hold the same float32 weights as the JAX
ones (``params_from_numpy``) and a float32 cache.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend import engine as jeng
from swarmdb_tpu.backend import service as jsvc
from swarmdb_tpu.backend.sampling import SamplingParams as JSP
from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu_torch.backend import engine as teng
from swarmdb_tpu_torch.backend import service as tsvc
from swarmdb_tpu_torch.backend.chaos import ServingChaos, wait_until
from swarmdb_tpu_torch.backend.engine import GenRequest
from swarmdb_tpu_torch.backend.sampling import SamplingParams
from swarmdb_tpu_torch.backend.supervisor import LaneSupervisor
from swarmdb_tpu_torch.broker.local import LocalBroker
from swarmdb_tpu_torch.core.messages import Message
from swarmdb_tpu_torch.core.runtime import SwarmDB
from swarmdb_tpu_torch.utils.convert import params_from_numpy

# an injected LaneKilled is an unhandled thread exception: the failure
# under test, not noise
pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")

CFG = get_config("tiny-debug")
MAX_BATCH, SEQ, PS, CHUNK = 4, 128, 8, 4


def _jax_engine(kind, params):
    """The JAX package's engine of ``kind`` over a float32 cache."""
    if kind == "paged":
        je, _ = jsvc.build_backend_engine(CFG, max_batch=MAX_BATCH,
                                          max_seq=SEQ, paged=True,
                                          page_size=PS, decode_chunk=CHUNK)
        je.params = params
        return je
    from swarmdb_tpu.backend.tokenizer import default_tokenizer

    tok = default_tokenizer(CFG.vocab_size)
    return jeng.Engine(
        lambda p, t, pos, c: jl.forward(p, CFG, t, pos, c),
        lambda b, s: jl.init_kv_cache(CFG, b, s, jnp.float32),
        params, max_batch=MAX_BATCH, max_seq=SEQ, eos_id=tok.eos_id,
        pad_id=tok.pad_id, seed=0, decode_chunk=CHUNK,
        chunked_fns=(
            lambda p, t, pos, c, hkv, s: jl.forward_chunked(p, CFG, t, pos,
                                                            c, hkv, s),
            lambda b, k: jl.init_chunk_kv(CFG, b, k), jl.merge_chunk),
        prefix_fns=(
            lambda p, t, tab, pl, pk, pv, lp, logits_at=None:
                jl.forward_prefix_lane(p, CFG, t, tab, pl, pk, pv, lp,
                                       logits_at=logits_at),
            lambda n, ps: jl.init_prefix_pool(CFG, n, ps, jnp.float32)),
        prefix_pages=1 + -(-(MAX_BATCH * SEQ // 2) // PS),
        prefix_page_size=PS,
        forward_last_fn=lambda p, t, pos, c, at: jl.forward(
            p, CFG, t, pos, c, logits_at=at))


@pytest.fixture(scope="module", params=["dense", "paged"])
def stack(request):
    """(port engine, its supervisor, chaos, JAX reference generate), the
    engine shared by the module's tests; every test leaves it alive."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setenv("SWARMDB_KV_DTYPE", "f32")
    jpar = jax.tree.map(lambda a: a.astype(jnp.float32),
                        jl.init_params(CFG, jax.random.PRNGKey(0)))
    je = _jax_engine(request.param, jpar)
    eng, _ = tsvc.build_backend_engine(
        "tiny-debug", max_batch=MAX_BATCH, max_seq=SEQ, page_size=PS,
        decode_chunk=CHUNK, paged=request.param == "paged", device="cpu",
        kv_dtype=torch.float32,
        params=params_from_numpy(jax.tree.map(np.asarray, jpar),
                                 device="cpu"))
    eng.start()
    je.start()
    sup = LaneSupervisor(eng, suspect_s=0.25, quarantine_s=1.0, poll_s=0.05,
                         probe_clean_n=2, probe_timeout_s=60.0,
                         deadline_s=120.0, retries=2).start()
    chaos = ServingChaos(eng)

    def jax_ref(prompt, n):
        toks, reason = je.generate_sync(list(prompt),
                                        JSP(max_new_tokens=n), timeout=120)
        return toks, reason

    yield eng, sup, chaos, jax_ref
    chaos.stop()
    sup.stop()
    eng.stop()
    je.stop()
    mp.undo()
    torch.set_num_threads(threads)


def _lane0(sup) -> dict:
    """The one engine's entry of the status's per-lane list."""
    lanes = sup.status()["lanes"]
    assert len(lanes) == 1
    return lanes[0]


def _alive(sup) -> bool:
    return _lane0(sup)["state"] == "alive"


def _gen(sup, prompt, max_new, on_token=None, deadline=None, priority=1,
         timeout=120.0):
    """Submit through the supervisor and wait: (tokens, reason,
    streamed)."""
    done = threading.Event()
    out = {}
    streamed = []

    def _tok(rid, tok):
        streamed.append(tok)
        if on_token is not None:
            on_token(rid, tok, streamed)

    def _done(rid, toks, reason):
        out.update(toks=toks, reason=reason)
        done.set()

    sup.submit(GenRequest(prompt=list(prompt), priority=priority,
                          sampling=SamplingParams(max_new_tokens=max_new),
                          on_token=_tok, on_done=_done, deadline=deadline))
    assert done.wait(timeout), "request never completed"
    return out["toks"], out["reason"], streamed


def test_idle_engine_beats_and_reads_alive(stack):
    eng, sup, _, _ = stack
    wait_until(lambda: _alive(sup), 10.0, what="engine alive")
    st = _lane0(sup)
    assert st["state_code"] == 0
    assert st["beat_age_s"] < 1.0
    lines = sup.prometheus_lines()
    assert 'swarmdb_lane_state{lane="0"} 0' in lines
    assert any(l.startswith('swarmdb_lane_beat_age_seconds{lane="0"} ')
               for l in lines)


def test_retryable_reason_contract():
    assert teng.RETRYABLE_REASONS == jeng.RETRYABLE_REASONS
    for r in ("engine_error", "engine_restart", "lane_quarantined", "shed",
              "stale_resume"):
        assert teng.is_retryable_reason(r), r
    for r in ("eos", "length", "cancelled", "deadline", "max_seq"):
        assert not teng.is_retryable_reason(r), r


def test_kill_mid_stream_replays_with_zero_loss(stack):
    eng, sup, chaos, jax_ref = stack
    wait_until(lambda: _alive(sup), 30.0, what="engine alive")
    prompt = [1, 5, 9, 13]
    ref, reason, _ = _gen(sup, prompt, 24)
    assert reason == "length" and len(ref) == 24
    assert (ref, reason) == jax_ref(prompt, 24)
    c = eng.metrics.counters
    migrated, retried = (c["requests_migrated"].value,
                         c["requests_retried"].value)
    killed = []

    def kill_at_8(rid, tok, streamed):
        if len(streamed) == 8 and not killed:
            killed.append(True)
            chaos.kill_lane(0)  # lands at the next chunk boundary

    toks, reason, streamed = _gen(sup, prompt, 24, on_token=kill_at_8)
    assert killed, "stream finished before the kill armed"
    assert reason == "length"
    assert streamed == toks and toks == ref
    # one engine: the replay queues behind the restart, which fails it
    # with the retryable "engine_restart" -> the retry serves it
    assert c["requests_migrated"].value > migrated
    assert c["requests_retried"].value > retried
    kinds = {e.get("kind") for e in eng.flight.events()}
    assert {"chaos.kill_fired", "lane.quarantined", "request.migrated",
            "engine.restart", "request.retried"} <= kinds
    wait_until(lambda: _alive(sup), 60.0, what="readmission")
    st = sup.status()
    assert st["lane_quarantines"] >= 1 and st["lane_readmissions"] >= 1
    assert st["lanes"][0]["restarts"] >= 1
    again, _, _ = _gen(sup, prompt, 24)
    assert again == ref


@pytest.mark.parametrize("prompt", [[1, 5, 9, 13], [2, 4, 6, 8, 10]])
def test_replay_equal_at_every_chunk_boundary(stack, prompt):
    """Kill at every chunk boundary k (a kill armed at token k lands at
    k's boundary). The replay is the undisturbed run's first k tokens and
    then the continuation of prompt + those k tokens: it equals the JAX
    package's continuation exactly, with no token repeated or lost. It
    equals the undisturbed run exactly where the JAX package's replay
    does too: on [2, 4, 6, 8, 10] both packages' prefills of the replayed
    prompt part from their own decode at k = 4 and 8 (a near tie under
    the rounding of prefill against decode, ROADMAP.md queue 3)."""
    eng, sup, chaos, jax_ref = stack
    n_tokens = 16  # decode_chunk 4 -> boundaries at 4, 8, 12
    wait_until(lambda: _alive(sup), 60.0, what="engine alive")
    ref, _, _ = _gen(sup, prompt, n_tokens)
    assert len(ref) == n_tokens
    assert jax_ref(prompt, n_tokens) == (ref, "length")
    for k in (4, 8, 12):
        wait_until(lambda: _alive(sup), 60.0,
                   what=f"recovery before boundary {k}")
        killed = []

        def kill_at_k(rid, tok, streamed, _k=k, _killed=killed):
            if len(streamed) == _k and not _killed:
                _killed.append(True)
                chaos.kill_lane(0)

        toks, reason, streamed = _gen(sup, prompt, n_tokens,
                                      on_token=kill_at_k)
        assert killed, f"boundary {k}: stream finished before the kill"
        assert reason == "length"
        assert streamed == toks, f"boundary {k}: stream != final tokens"
        cont, _ = jax_ref(prompt + ref[:k], n_tokens - k)
        assert toks == ref[:k] + cont, f"boundary {k}: replay != JAX's"
        assert (toks == ref) == (cont == ref[k:]), (
            f"boundary {k}: the replay agrees with the undisturbed run "
            "where the JAX package's does not, or the other way round")
    wait_until(lambda: _alive(sup), 60.0, what="final recovery")
    if prompt == [1, 5, 9, 13]:
        assert all(jax_ref(prompt + ref[:k], n_tokens - k)[0] == ref[k:]
                   for k in (4, 8, 12))


def test_wedge_quarantines_and_heals(stack):
    eng, sup, chaos, _ = stack
    wait_until(lambda: _alive(sup), 60.0, what="engine alive")
    q_before = sup.status()["lane_quarantines"]
    chaos.wedge(0)
    try:
        wait_until(lambda: _lane0(sup)["state"]
                   == "quarantined", 10.0, what="wedged engine quarantined")
        assert _lane0(sup)["thread_alive"]
        out = {}
        done = threading.Event()
        sup.submit(GenRequest(prompt=[3, 7, 11],
                              sampling=SamplingParams(max_new_tokens=8),
                              on_done=lambda r, t, why: (
                                  out.update(t=t, why=why), done.set())))
        assert not done.wait(0.5), "a wedged engine served a request"
    finally:
        chaos.heal(0)
    assert done.wait(60), "the request never finished after heal"
    assert out["why"] == "length" and len(out["t"]) == 8
    wait_until(lambda: _alive(sup), 60.0, what="wedged engine readmitted")
    assert sup.status()["lane_quarantines"] == q_before + 1


def test_supervisor_retries_engine_restart(stack):
    eng, sup, _, _ = stack
    wait_until(lambda: _alive(sup), 60.0, what="engine alive")
    retried = eng.metrics.counters["requests_retried"].value
    restarted = []

    restarter = threading.Thread(target=eng.restart, daemon=True)

    def restart_at_4(rid, tok, streamed):
        if len(streamed) == 4 and not restarted:
            restarted.append(True)
            restarter.start()

    toks, reason, streamed = _gen(sup, [1, 9, 17], 16, on_token=restart_at_4)
    restarter.join(60)
    assert reason == "length" and len(toks) == 16
    assert streamed == toks
    assert eng.metrics.counters["requests_retried"].value > retried
    wait_until(lambda: _alive(sup), 60.0, what="post-restart recovery")


def test_deadline_expires_instead_of_hanging(stack):
    eng, sup, chaos, _ = stack
    wait_until(lambda: _alive(sup), 60.0, what="engine alive")
    chaos.wedge(0)
    try:
        toks, reason, _ = _gen(sup, [5, 6, 7], 8,
                               deadline=time.time() + 1.0, timeout=30.0)
        assert reason == "deadline" and toks == []
        assert eng.metrics.counters["requests_deadline_expired"].value >= 1
    finally:
        chaos.heal(0)
    wait_until(lambda: _alive(sup), 60.0, what="post-wedge recovery")


def test_engine_fails_a_queued_request_past_its_deadline(stack):
    """The engine's own check, without the supervisor: a queued request
    whose deadline has passed fails "deadline" at admission."""
    eng, sup, _, _ = stack
    wait_until(lambda: _alive(sup), 60.0, what="engine alive")
    got = []
    done = threading.Event()
    eng.submit(GenRequest(prompt=[4, 4, 4],
                          sampling=SamplingParams(max_new_tokens=4),
                          deadline=time.time() - 1.0,
                          on_done=lambda r, t, why: (got.append((t, why)),
                                                     done.set())))
    assert done.wait(30) and got == [([], "deadline")]


def test_cancel_reaches_a_request_parked_on_a_retry_timer(stack):
    eng, sup, _, _ = stack
    wait_until(lambda: _alive(sup), 60.0, what="engine alive")
    slow = LaneSupervisor(eng, backoff_s=30.0, retries=2)  # not started
    got = []
    done = threading.Event()

    restarter = threading.Thread(target=eng.restart, daemon=True)

    def restart_once(rid, tok):
        if not got:
            got.append("token")
            restarter.start()

    rid = slow.submit(GenRequest(
        prompt=[8, 8, 8], sampling=SamplingParams(max_new_tokens=64),
        on_token=restart_once,
        on_done=lambda r, t, why: (got.append(why), done.set())))
    wait_until(lambda: slow._tracked[rid].retry_timer is not None, 60.0,
               what="the request parked on its retry timer")
    assert not done.is_set()
    assert slow.cancel(rid)
    assert done.wait(5) and got[-1] == "cancelled"
    assert rid not in slow._tracked
    restarter.join(60)
    wait_until(lambda: _alive(sup), 60.0, what="post-restart recovery")


# ------------------------------------------------- pool pressure (paged)


def _paged(monkeypatch, high, low, shed):
    monkeypatch.setenv("SWARMDB_POOL_HIGH", str(high))
    monkeypatch.setenv("SWARMDB_POOL_LOW", str(low))
    monkeypatch.setenv("SWARMDB_POOL_SHED", str(shed))
    eng, _ = tsvc.build_backend_engine("tiny-debug", max_batch=2,
                                       max_seq=64, paged=True, page_size=8,
                                       decode_chunk=4, device="cpu")
    return eng


def test_backpressure_pause_resume_hysteresis(monkeypatch):
    eng = _paged(monkeypatch, high=0.5, low=0.2, shed=0.9)
    eng.start()
    chaos = ServingChaos(eng)
    try:
        chaos.squeeze_pool(0.95)
        done = threading.Event()
        out = {}
        eng.submit(GenRequest(
            prompt=[1, 2, 3], sampling=SamplingParams(max_new_tokens=4),
            on_done=lambda rid, t, r: (out.update(reason=r, toks=t),
                                       done.set())))
        wait_until(lambda: eng.metrics.counters[
            "engine_admission_paused"].value >= 1, 10.0,
            what="admission pause")
        assert not done.is_set(), "paused engine admitted anyway"
        assert eng.stats()["admission_paused"] is True
        chaos.heal_pool()
        assert done.wait(60), "admission never resumed after heal"
        assert out["reason"] == "length"
        assert eng.metrics.counters["engine_admission_resumed"].value >= 1
        kinds = {e.get("kind") for e in eng.flight.events()}
        assert {"pool.backpressure_paused",
                "pool.backpressure_resumed"} <= kinds
    finally:
        chaos.stop()
        eng.stop()


def test_squeeze_sheds_lowest_priority_and_retries_serve_it(monkeypatch):
    """Past the shed watermark the low-priority request is shed (retryable)
    and the high one waits; a supervisor whose retry budget and backoff
    cover the squeeze serves the shed request after heal_pool."""
    eng = _paged(monkeypatch, high=0.5, low=0.2, shed=0.6)
    eng.start()
    sup = LaneSupervisor(eng, retries=8, backoff_s=0.2, deadline_s=60.0,
                         poll_s=0.05).start()
    chaos = ServingChaos(eng)
    results = {}
    events = {p: threading.Event() for p in ("low", "high")}

    def mk(name):
        def _done(rid, toks, reason):
            results[name] = (reason, toks)
            events[name].set()
        return _done

    try:
        chaos.squeeze_pool(0.95)
        sup.submit(GenRequest(prompt=[1, 2, 3], priority=0,
                              sampling=SamplingParams(max_new_tokens=4),
                              on_done=mk("low")))
        sup.submit(GenRequest(prompt=[4, 5, 6], priority=3,
                              sampling=SamplingParams(max_new_tokens=4),
                              on_done=mk("high")))
        wait_until(lambda: eng.metrics.counters["requests_shed"].value >= 1,
                   20.0, what="a shed request")
        assert not events["low"].is_set(), "the shed reached the caller"
        assert not events["high"].is_set(), "shed the wrong priority"
        assert sup.status()["requests_retried"] >= 1
        kinds = {e.get("kind") for e in eng.flight.events()}
        assert "pool.request_shed" in kinds
        chaos.heal_pool()
        for k in ("low", "high"):
            assert events[k].wait(60), f"{k}-priority request never served"
            assert results[k][0] == "length" and len(results[k][1]) == 4
    finally:
        chaos.stop()
        sup.stop()
        eng.stop()


# ------------------------------------------------- through the service


@pytest.mark.parametrize("supervise", ["1", "0"])
def test_service_kill_with_and_without_supervision(supervise, monkeypatch,
                                                   tmp_path):
    """Supervised (the default) a killed decode still finishes "length";
    with ``SWARMDB_SUPERVISE=0`` the consumer's watchdog restarts the loop
    and the retryable "engine_restart" reaches the caller and the reply,
    as in the JAX package."""
    monkeypatch.setenv("SWARMDB_SUPERVISE", supervise)
    monkeypatch.delenv("SWARMDB_PAGED", raising=False)
    db = SwarmDB(broker=LocalBroker(), save_dir=str(tmp_path))
    svc = tsvc.ServingService.from_model_name(db, "tiny-debug",
                                              backend_id="b0", max_batch=2,
                                              max_seq=128, decode_chunk=4,
                                              device="cpu")
    chaos = ServingChaos(svc.engine)
    try:
        assert (svc.supervisor is None) == (supervise == "0")
        if svc.supervisor is not None:
            svc.supervisor.poll_s = 0.05  # sees the dead loop sooner
        svc.start()
        killed, streamed = [], []
        done = threading.Event()
        got = {}

        def on_token(rid, tok):
            streamed.append(tok)
            if len(streamed) == 4 and not killed:
                killed.append(True)
                chaos.kill_lane(0)

        def on_done(rid, toks, reason):
            got.update(toks=toks, reason=reason)
            done.set()

        msg = Message(sender_id="user", receiver_id="bot",
                      content="keep talking",
                      metadata={"generation": {"max_new_tokens": 24}})
        db.register_agent("bot")
        svc.serve_message(msg, on_token=on_token, on_done=on_done)
        assert done.wait(60), "no completion"
        reply = db.get_message(msg.metadata["reply_id"])
        assert killed
        if supervise == "1":
            assert got["reason"] == "length" and len(got["toks"]) == 24
            assert streamed == got["toks"]
            assert svc.supervisor.status()["requests_retried"] >= 1
        else:
            assert got["reason"] == "engine_restart"
            assert 4 <= len(got["toks"]) < 24
            wait_until(svc.engine.alive, 30.0, what="watchdog restart")
        assert reply.metadata["finish_reason"] == got["reason"]
        assert svc.health()["supervisor"].get("enabled", True) == (
            supervise == "1")
    finally:
        chaos.stop()
        svc.stop()
        db.close()
