"""Rolling KV on the port against the JAX package: a conversation keeps
its K/V pages between turns and each turn prefills only its delta on top
(``GenRequest.keep_pages`` / ``resume_pages``, the service's rolling
registry under ``SWARMDB_ROLLING_KV=1``). The cases of the JAX package's
``tests/test_rolling.py`` and ``tests/test_rolling_drift.py``, each run
through both packages on the same float32 weights (tiny-debug, tiny-moe):

- engine level, paged and dense: three turns (keep, resume, resume) give
  the JAX package's tokens and its ``on_pages`` arguments (pages, written
  extent, tail) exactly, at both packages' default decode loops and at
  the per-chunk settings (``SWARMDB_EMIT_RING=0 SWARMDB_PIPELINE=1``);
  each resumed turn also equals a fresh prefill of the whole history;
- bad requests are refused at submit; a stale epoch is refused at
  submit and failed "stale_resume" at admission; the pools keep their
  storage (``data_ptr``) across resume writes and the dense lane
  extraction, which the captured decode graphs read;
- a dense resume frees its superseded side-pool pages;
- service level: chat and tool-call conversations give the JAX
  package's replies and rolling counters, a concurrent turn is "plain",
  page custody balances after a soak, and pool pressure evicts idle
  conversations (paged and dense);
- the drift table (rolling against a re-prefill serve, per turn) equals
  the JAX package's;
- tiny-moe with 8 experts, where the resume wave's padding rows take
  MoE capacity, gives the JAX package's tokens;
- a resumed turn whose engine is killed mid-decode under the supervisor
  ends "lane_quarantined" in both packages, its streamed tokens a prefix
  of the undisturbed turn's.

Tolerances: none. Every comparison is of greedy tokens, page ids,
lengths or counters, exactly.
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
from swarmdb_tpu.models import mixtral as jm
from swarmdb_tpu.models.configs import get_config as jget
from swarmdb_tpu_torch.backend import service as tsvc
from swarmdb_tpu_torch.backend.engine import GenRequest
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.utils.convert import params_from_numpy

CFG = jget("tiny-debug")
PS, SEQ, BATCH, CHUNK = 8, 96, 2, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32_params(cfg=CFG, seed=9):
    return jax.tree.map(lambda a: a.astype(jnp.float32),
                        jl.init_params(cfg, jax.random.PRNGKey(seed)))


def engine_pair(monkeypatch, paged, params, per_chunk=False, cfg=CFG,
                model="tiny-debug", prefix_tokens=None, max_batch=BATCH,
                seq=SEQ, ps=PS, kv_pool_tokens=None, kv="f32"):
    """(JAX engine, port engine) over float32 caches and the same
    weights, built by both packages' ``build_backend_engine`` (the JAX
    dense one with a float32 cache). ``per_chunk``: both without the
    resident loop and pipelining."""
    monkeypatch.setenv("SWARMDB_KV_DTYPE", kv)
    for var in ("SWARMDB_EMIT_RING", "SWARMDB_PIPELINE"):
        monkeypatch.delenv(var, raising=False)
    if per_chunk:
        monkeypatch.setenv("SWARMDB_EMIT_RING", "0")
        monkeypatch.setenv("SWARMDB_PIPELINE", "1")
    if prefix_tokens is not None:
        monkeypatch.setenv("SWARMDB_PREFIX_TOKENS", str(prefix_tokens))
    if paged:
        je, _ = jsvc.build_backend_engine(cfg, max_batch=max_batch,
                                          max_seq=seq, paged=True,
                                          page_size=ps, decode_chunk=CHUNK,
                                          kv_pool_tokens=kv_pool_tokens)
        je.params = params
        mod = jm if cfg.is_moe else jl
        if kv == "f32":
            je._prefill_cache_fn = (
                lambda b, s: mod.init_kv_cache(cfg, b, s, jnp.float32))
    else:
        je = jax_dense_engine(cfg, params, per_chunk, max_batch=max_batch,
                              seq=seq, ps=ps, prefix_tokens=prefix_tokens)
    te, _ = tsvc.build_backend_engine(
        model if cfg is CFG else _port_cfg(cfg), max_batch=max_batch,
        max_seq=seq, page_size=ps, decode_chunk=CHUNK, paged=paged,
        kv_pool_tokens=kv_pool_tokens,
        device="cpu", kv_dtype=None if paged else torch.float32,
        params=params_from_numpy(jax.tree.map(np.asarray, params),
                                 device="cpu"))
    assert je.supports_rolling() and te.supports_rolling()
    return je, te


def _port_cfg(jcfg):
    from swarmdb_tpu_torch.models.configs import get_config as tget

    return tget(jcfg.name, n_experts=jcfg.n_experts) if jcfg.is_moe \
        else tget(jcfg.name)


def jax_dense_engine(cfg, params, per_chunk, max_batch=BATCH, seq=SEQ,
                     ps=PS, prefix_tokens=None):
    """The JAX package's dense engine with its prefix side pool, over a
    float32 cache, as its ``build_backend_engine`` wires it."""
    from swarmdb_tpu.backend.tokenizer import default_tokenizer

    mod = jm if cfg.is_moe else jl
    tok = default_tokenizer(cfg.vocab_size)
    pt = (int(prefix_tokens) if prefix_tokens is not None
          else max_batch * seq // 2)
    return jeng.Engine(
        lambda p, t, pos, c: mod.forward(p, cfg, t, pos, c),
        lambda b, s: mod.init_kv_cache(cfg, b, s, jnp.float32),
        params, max_batch=max_batch, max_seq=seq, eos_id=tok.eos_id,
        pad_id=tok.pad_id, seed=0, decode_chunk=CHUNK,
        chunked_fns=(
            lambda p, t, pos, c, hkv, s: mod.forward_chunked(
                p, cfg, t, pos, c, hkv, s),
            lambda b, k: mod.init_chunk_kv(cfg, b, k), mod.merge_chunk),
        prefix_fns=(
            lambda p, t, tab, pl, pk, pv, lp, logits_at=None:
                mod.forward_prefix_lane(p, cfg, t, tab, pl, pk, pv, lp,
                                        logits_at=logits_at),
            lambda n, ps_: jl.init_prefix_pool(cfg, n, ps_, jnp.float32)),
        prefix_pages=1 + -(-pt // ps), prefix_page_size=ps,
        pipeline_depth=1 if per_chunk else 2,
        forward_last_fn=lambda p, t, pos, c, at: mod.forward(
            p, cfg, t, pos, c, logits_at=at))


def gen_keep(eng, req_cls, sp_cls, prompt, max_new, resume=None,
             timeout=120.0):
    """One keep_pages generation on a started engine: (tokens, reason,
    pages, written, tail)."""
    done = threading.Event()
    out = {}

    def on_done(rid, toks, reason):
        out.update(toks=list(toks), reason=reason)
        done.set()

    def on_pages(rid, pages, written, tail):
        out.update(pages=list(pages), written=written, tail=list(tail))

    req = req_cls(prompt=list(prompt),
                  sampling=sp_cls(max_new_tokens=max_new, temperature=0.0),
                  on_done=on_done, on_pages=on_pages, keep_pages=True)
    if resume is not None:
        req.resume_pages = list(resume[0])
        req.resume_len = resume[1]
    eng.submit(req)
    assert done.wait(timeout), "generation timed out"
    return (out["toks"], out["reason"], out.get("pages"),
            out.get("written"), out.get("tail"))


def three_turns(eng, req_cls, sp_cls, p1, new2, new3, news=(7, 6, 5)):
    """keep -> resume -> resume on a started engine; returns the three
    gen_keep results."""
    t1 = gen_keep(eng, req_cls, sp_cls, p1, news[0])
    t2 = gen_keep(eng, req_cls, sp_cls, t1[4] + new2, news[1],
                  resume=(t1[2], t1[3]))
    t3 = gen_keep(eng, req_cls, sp_cls, t2[4] + new3, news[2],
                  resume=(t2[2], t2[3]))
    return [t1, t2, t3]


def prompts(seed, vocab=CFG.vocab_size):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, n).tolist() for n in (21, 9, 5)]


def run(eng, fn):
    eng._stop = False   # the JAX engine's start() keeps a stop() flag
    eng.start()
    try:
        return fn()
    finally:
        eng.stop()


# ------------------------------------------------------------- engine level


@pytest.mark.parametrize("per_chunk", [False, True],
                         ids=["defaults", "per_chunk"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_resume_equals_jax_and_a_fresh_prefill(monkeypatch, paged,
                                               per_chunk):
    """Three turns (keep, resume, resume) through both packages: equal
    tokens and equal on_pages (pages, written, tail) at every turn; the
    written extent plus the tail is the whole turn; each resumed turn
    equals a fresh engine's prefill of the whole history."""
    params = f32_params()
    je, te = engine_pair(monkeypatch, paged, params, per_chunk)
    p1, new2, new3 = prompts(3)
    jout = run(je, lambda: three_turns(je, jeng.GenRequest, JSP, p1, new2,
                                       new3))
    tout = run(te, lambda: three_turns(te, GenRequest, TSP, p1, new2, new3))
    assert tout == jout
    (g1, _, pages, written, tail), (g2, *_), (g3, *_) = tout
    assert written + len(tail) == len(p1) + len(g1)
    assert len(pages) == -(-written // PS)
    assert all(r[1] in ("length", "eos") for r in tout)
    loop = te.stats()["decode_loop"]
    assert loop == ("pipeline 1" if per_chunk
                    else "resident" if paged else "pipeline 2")
    # a fresh prefill of the whole history gives the resumed tokens
    _, ref = engine_pair(monkeypatch, paged, params, per_chunk)
    r2 = run(ref, lambda: gen_keep(ref, GenRequest, TSP, p1 + g1 + new2,
                                   6)[0])
    assert r2 == g2
    _, ref = engine_pair(monkeypatch, paged, params, per_chunk)
    r3 = run(ref, lambda: gen_keep(ref, GenRequest, TSP,
                                   p1 + g1 + new2 + g2 + new3, 5)[0])
    assert r3 == g3


def test_resume_rejects_bad_requests(monkeypatch):
    """Refused at submit in both packages: pages that do not cover
    resume_len, no pages, a resumed total past max_seq, a stale epoch."""
    je, te = engine_pair(monkeypatch, True, f32_params())
    for eng, cls in ((je, jeng.GenRequest), (te, GenRequest)):
        for kw in (dict(prompt=[1, 2], resume_pages=[1], resume_len=17),
                   dict(prompt=[1, 2], resume_pages=[], resume_len=8),
                   dict(prompt=list(range(3, 50)),
                        resume_pages=list(range(1, 8)), resume_len=50),
                   dict(prompt=[5, 6, 7], resume_pages=[1, 2],
                        resume_len=12, resume_epoch=-1)):
            with pytest.raises(ValueError) as err:
                eng.submit(cls(**kw))
            if kw.get("resume_epoch") == -1:
                assert "stale resume epoch" in str(err.value)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_stale_resume_epoch_failed_at_admission(monkeypatch, paged):
    """A pool reset while the resume sat queued: both packages fail it
    "stale_resume" at admission and count it."""
    je, te = engine_pair(monkeypatch, paged, f32_params())
    for eng, cls, sp in ((je, jeng.GenRequest, JSP),
                         (te, GenRequest, TSP)):
        done = threading.Event()
        out = {}

        def on_done(rid, toks, reason, out=out, done=done):
            out["reason"] = reason
            done.set()

        eng.submit(cls(prompt=[5, 6, 7], sampling=sp(max_new_tokens=2),
                       on_done=on_done, keep_pages=True,
                       resume_pages=[1, 2], resume_len=12,
                       resume_epoch=eng.pool_epoch()))
        if paged:
            eng.paged.allocator.reset()
        else:
            eng._prefix.reset()
        eng.start()
        try:
            assert done.wait(60)
        finally:
            eng.stop()
        assert out["reason"] == "stale_resume"
        assert eng.metrics.counters["engine_stale_resumes"].value == 1


def test_pools_keep_their_storage(monkeypatch):
    """Resume writes, the dense lane extraction and a promotion insert
    write in place: the tensors a captured decode graph reads keep their
    ``data_ptr`` across them."""
    from swarmdb_tpu_torch.ops.paged_kv import (pool_gather_pages,
                                                pool_insert_raw)

    params = f32_params()
    p1, new2, _ = prompts(5)
    for paged in (True, False):
        _, te = engine_pair(monkeypatch, paged, params)
        tensors = ([te.cache["k"], te.cache["v"], te.cache["page_table"]]
                   if paged else list(te.cache) + list(te._prefix_pool))
        ptrs = [t.data_ptr() for t in tensors]

        def turns():
            t1 = gen_keep(te, GenRequest, TSP, p1, 7)
            if paged:
                ids = torch.tensor(t1[2])
                pay = [pool_gather_pages(te.cache[n], t1[2])
                       for n in ("k", "v")]
                for n, p in zip(("k", "v"), pay):
                    pool_insert_raw(te.cache[n], ids, p)
            gen_keep(te, GenRequest, TSP, t1[4] + new2, 6,
                     resume=(t1[2], t1[3]))

        run(te, turns)
        assert [t.data_ptr() for t in tensors] == ptrs


def test_dense_resume_frees_superseded_pages(monkeypatch):
    """A dense retirement extracts a fresh page set and releases the
    resumed turn's source pages: the side pool's free count moves alike
    in both packages."""
    p1 = prompts(11)[0][:17]
    je, te = engine_pair(monkeypatch, False, f32_params())
    got = []
    for eng, cls, sp in ((je, jeng.GenRequest, JSP),
                         (te, GenRequest, TSP)):
        def body(eng=eng, cls=cls, sp=sp):
            free0 = eng._prefix.free_count()
            g1, _, pages, written, tail = gen_keep(eng, cls, sp, p1, 5)
            cached1 = eng._prefix.stats()["cached_pages"]
            assert eng._prefix.free_count() == free0 - len(pages) - cached1
            _, _, pages2, _, _ = gen_keep(eng, cls, sp, tail + [9, 9, 9], 5,
                                          resume=(pages, written))
            cached2 = eng._prefix.stats()["cached_pages"]
            assert eng._prefix.free_count() == free0 - len(pages2) - cached2
            eng.rolling_free(pages2)
            assert eng._prefix.free_count() == free0 - cached2
            return pages, pages2

        got.append(run(eng, body))
    assert got[0] == got[1]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_moe_binding_capacity_resume_equals_jax(monkeypatch, paged):
    """tiny-moe with 8 experts (C = N / 2): the resume wave is padded to
    prefill_batch rows of the suffix bucket, and its padding rows take
    capacity, so tokens depend on the JAX package's grouping; two
    conversations resumed in one round, a short and a long delta in two
    buckets. Equal tokens and on_pages, and the MoE dropped tokens."""
    from swarmdb_tpu_torch.models import mixtral as tm
    from tests.test_torch_mixtral import _drops

    drops = []
    block = tm.moe_block

    def counting(x, router, *a, **kw):
        drops.append(_drops(x, router, 2, 2.0))
        return block(x, router, *a, **kw)

    monkeypatch.setattr(tm, "moe_block", counting)
    jcfg = jget("tiny-moe", n_experts=8)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init_params(jcfg, jax.random.PRNGKey(1)))
    je, te = engine_pair(monkeypatch, paged, params, cfg=jcfg,
                         model="tiny-moe", max_batch=4)
    rng = np.random.default_rng(2)
    p = [rng.integers(3, 259, n).tolist() for n in (21, 30)]
    deltas = [rng.integers(3, 259, n).tolist() for n in (5, 20)]

    def body(eng, cls, sp):
        firsts = run(eng, lambda: [gen_keep(eng, cls, sp, q, 6) for q in p])
        # both resumes queued before the loop starts: one admission round
        done, kept, order = {}, {}, []
        for (_, _, pages, written, tail), d in zip(firsts, deltas):
            order.append(eng.submit(cls(
                prompt=tail + d, sampling=sp(max_new_tokens=8),
                keep_pages=True, resume_pages=pages, resume_len=written,
                on_pages=lambda r, pg, w, t: kept.__setitem__(r, (pg, w, t)),
                on_done=lambda r, t, why: done.__setitem__(r, (list(t),
                                                               why)))))

        def wait():
            deadline = time.time() + 120
            while len(done) < len(order) and time.time() < deadline:
                time.sleep(0.02)

        run(eng, wait)
        return ([f[:2] for f in firsts],
                [done[r] + kept[r] for r in order])

    jout = body(je, jeng.GenRequest, JSP)
    tout = body(te, GenRequest, TSP)
    assert tout == jout
    assert any(drops), "the MoE block never dropped a token"


# ------------------------------------------------------------ service level


def service_pair(monkeypatch, tmp_path, paged, rolling=True, max_batch=BATCH,
                 seq=128, ps=PS, params=None, users=("u",),
                 kv_pool_tokens=None, kv="f32", **env):
    """(JAX service, port service) on one set of float32 weights, each
    over its own SwarmDB with ``users`` and an LLM-backed "bot"; rolling
    KV as asked. Not started."""
    from swarmdb_tpu.backend.tokenizer import default_tokenizer
    from swarmdb_tpu.broker.local import LocalBroker as JBroker
    from swarmdb_tpu.core.runtime import SwarmDB as JDB
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    monkeypatch.setenv("SWARMDB_ROLLING_KV", "1" if rolling else "0")
    monkeypatch.delenv("SWARMDB_PAGED", raising=False)
    monkeypatch.delenv("SWARMDB_SUPERVISE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    je, te = engine_pair(monkeypatch, paged, params or f32_params(),
                         max_batch=max_batch, seq=seq, ps=ps,
                         prefix_tokens=env.get("SWARMDB_PREFIX_TOKENS"),
                         kv_pool_tokens=kv_pool_tokens, kv=kv)
    out = []
    for name, svc_mod, db_cls, broker, eng in (
            ("jax", jsvc, JDB, JBroker, je), ("port", tsvc, SwarmDB,
                                              LocalBroker, te)):
        db = db_cls(broker=broker(), save_dir=str(tmp_path / name))
        for a in tuple(users) + ("bot",):
            db.register_agent(a)
        db.assign_llm_backend("bot", "b0")
        out.append(svc_mod.ServingService(
            db, eng, default_tokenizer(CFG.vocab_size), backend_id="b0"))
    return out


def chat(svc, user, content, max_new=4, mtype=None, timeout=90.0):
    """Send one greedy message to "bot" and wait for its reply: (content,
    finish_reason)."""
    kw = {} if mtype is None else {"message_type": mtype}
    mid = svc.db.send_message(user, "bot", content, metadata={
        "generation": {"max_new_tokens": max_new, "temperature": 0.0}}, **kw)
    deadline = time.time() + timeout
    while time.time() < deadline:
        for m in svc.db.receive_messages(user, timeout=0.2):
            if m.metadata.get("reply_to") == mid:
                return m.content, m.metadata["finish_reason"]
    raise AssertionError(f"no reply to {content!r}")


def serve(svc, fn):
    svc.start(warmup=False)
    try:
        return fn(svc)
    finally:
        svc.stop()
        svc.db.close()


ROLLING_COUNTERS = ("rolling_resumes", "rolling_restarts",
                    "rolling_evictions")


def counters(svc, names=ROLLING_COUNTERS):
    return {n: svc.db.metrics.counters[n].value for n in names}


def registry(svc):
    """The rolling registry's page-free view: per conversation (len,
    tail, pages, in_flight)."""
    with svc._rolling_lock:
        return {k: (st["len"], list(st["tail"]), st["pages"],
                    st["in_flight"]) for k, st in svc._rolling.items()}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_service_rolling_conversation_equals_jax(monkeypatch, tmp_path,
                                                 paged):
    """Ten growing chat turns at max_seq 128: both packages give the same
    replies, resume and restart alike (the window overflows at least
    once) and end with the same registry state."""
    pair = service_pair(monkeypatch, tmp_path, paged)

    def drive(svc):
        replies = [chat(svc, "u", f"turn {t} hello") for t in range(10)]
        return replies, counters(svc), registry(svc)

    jout, tout = (serve(s, drive) for s in pair)
    assert tout == jout
    replies, c, reg = tout
    assert c["rolling_resumes"] >= 4 and c["rolling_restarts"] >= 1, c
    (length, _tail, pages, in_flight), = reg.values()
    assert pages and not in_flight


def test_service_tool_call_turns_equal_jax(monkeypatch, tmp_path):
    """Tool-call turns roll too (their [tool-call] / [tool-result] lines
    enter the K/V through the shared line renderer); both packages give
    the same function_result / chat replies and counters, and record the
    reply ids that later deltas skip."""
    from swarmdb_tpu.core.messages import MessageType as JType
    from swarmdb_tpu_torch.core.messages import MessageType as TType

    pair = service_pair(monkeypatch, tmp_path, True, seq=256)

    def drive(svc, types):
        out = []
        for turn in range(5):
            if turn % 2:
                out.append(chat(svc, "u", {"tool": "t", "args": {"i": turn}},
                                max_new=3, mtype=types.FUNCTION_CALL))
            else:
                out.append(chat(svc, "u", f"chat {turn}", max_new=3))
        with svc._rolling_lock:
            st = next(iter(svc._rolling.values()))
            n_ids = len(st["reply_ids"])
        return out, counters(svc), n_ids

    jout = serve(pair[0], lambda s: drive(s, JType))
    tout = serve(pair[1], lambda s: drive(s, TType))
    assert tout == jout
    assert tout[1]["rolling_resumes"] >= 3 and tout[2] > 0


def test_rolling_plan_concurrent_turn_is_plain(monkeypatch, tmp_path):
    """A turn arriving while the conversation's claim is in flight is
    served plain; after the first turn stores and finalizes, the next
    resumes with the stored pages, the plan's epoch and a delta. The same
    plans in both packages."""
    pair = service_pair(monkeypatch, tmp_path, True, seq=64)

    def steps(svc, sp_cls):
        db = svc.db
        key = ("u", "bot")
        sp = sp_cls(max_new_tokens=4)
        msg = db.get_message(db.send_message("u", "bot", "first"))
        out = [svc._rolling_plan(key, msg, sp)[:2]]
        msg2 = db.get_message(db.send_message("u", "bot", "second"))
        out.append(svc._rolling_plan(key, msg2, sp)[:2])
        svc._rolling_store(key, [1, 2], 12, [])
        msg.metadata["reply_id"] = "r1"
        svc._rolling_finalize(key, msg, "length")
        with svc._rolling_lock:
            st = svc._rolling[key]
            out.append((st["in_flight"], st["reply_ids"]))
        msg3 = db.get_message(db.send_message("u", "bot", "third"))
        mode, res, toks = svc._rolling_plan(key, msg3, sp)
        out.append((mode, res[:2], res[2] == svc._rolling_epoch(), toks))
        db.close()
        return out

    jout = steps(pair[0], JSP)
    tout = steps(pair[1], TSP)
    assert tout == jout
    assert tout[0] == ("keep", None) and tout[1] == ("plain", None)
    assert tout[3][:3] == ("resume", ([1, 2], 12), True) and tout[3][3]


def test_rolling_soak_page_custody_balances(monkeypatch, tmp_path):
    """Six conversations sending bursts (concurrent turns go plain) and
    overflowing the window: once idle, free pages + registry pages +
    hash-cache pages are the whole pool, in both packages."""
    users = [f"u{i}" for i in range(6)]
    pair = service_pair(monkeypatch, tmp_path, True, max_batch=4,
                        users=users)

    def drive(svc):
        db = svc.db
        for r in range(6):
            for u in users:
                db.send_message(u, "bot", f"r{r} from {u}", metadata={
                    "generation": {"max_new_tokens": 3,
                                   "temperature": 0.0}})
        completed = db.metrics.counters["completed_messages"]
        deadline = time.time() + 180
        while completed.value < 6 * len(users) and time.time() < deadline:
            time.sleep(0.1)
        assert completed.value >= 6 * len(users)
        deadline = time.time() + 30
        busy = True
        while time.time() < deadline:
            with svc._rolling_lock:
                busy = any(st.get("in_flight")
                           for st in svc._rolling.values())
            if not busy and not svc.engine._any_active():
                break
            time.sleep(0.1)
        assert not busy and not svc.engine._any_active()
        svc.stop()   # the loop is idle: flush its retired slots here
        alloc = svc.engine.paged.allocator
        pending = alloc.take_pending_frees()
        alloc.release_taken(pending)
        with svc._rolling_lock:
            held = sum(len(st["pages"]) for st in svc._rolling.values()
                       if st.get("pages"))
        hashed = svc.engine._prefix.stats()["cached_pages"]
        return alloc.free_count() + held + hashed, alloc.num_pages - 1

    for svc in pair:
        total, pool = serve(svc, drive)
        assert total == pool


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_pool_pressure_evicts_idle_rolling(monkeypatch, tmp_path, paged):
    """A pool too small for a second conversation while the first's idle
    pages are parked: the pressure hook evicts the idle state (paged:
    at admission; dense: at the retirement extraction) and the second
    conversation is served, in both packages alike."""
    env = ({} if paged else {"SWARMDB_PREFIX_TOKENS": "64"})
    # paged: 8 usable pages + trash
    pair = service_pair(monkeypatch, tmp_path, paged, max_batch=1, seq=64,
                        users=("u1", "u2"),
                        kv_pool_tokens=64 if paged else None, **env)

    def drive(svc):
        first = chat(svc, "u1", "hello " * 12)
        second = chat(svc, "u2", "world " * (12 if paged else 14),
                      max_new=16)
        deadline = time.time() + 30
        while time.time() < deadline:
            with svc._rolling_lock:
                st = svc._rolling.get(("u2", "bot"))
                if st is not None and st.get("pages") and not st["in_flight"]:
                    break
            time.sleep(0.05)
        with svc._rolling_lock:
            gone = ("u1", "bot") not in svc._rolling
        return first, second, counters(svc), gone

    jout, tout = (serve(s, drive) for s in pair)
    assert tout == jout
    assert tout[2]["rolling_evictions"] >= 1 and tout[3]


def test_drift_table_equals_jax(monkeypatch, tmp_path):
    """The JAX package's drift table: one scripted 12-turn conversation
    served with rolling KV and without (a re-prefill every turn) at
    max_seq 96, per-turn reply similarity. Rolling drifts by design (its
    K/V holds the replies' raw tokens where a re-prefill renders "bot:"
    lines, and restarts re-anchor the window); the port's table equals
    the JAX package's turn for turn, turn 0 is identical, and the
    conversation restarts and resumes."""
    from difflib import SequenceMatcher

    N = 12
    params = f32_params()

    def conversation(rolling, tag):
        pair = service_pair(monkeypatch, tmp_path / tag, True,
                            rolling=rolling, seq=96, params=params)

        def drive(svc):
            replies = [svc.tokenizer.encode(
                chat(svc, "u", f"turn {t} the quick brown fox",
                     max_new=6)[0], add_bos=False) for t in range(N)]
            return replies, counters(svc)

        return [serve(s, drive) for s in pair]

    base = conversation(False, "base")
    roll = conversation(True, "roll")
    tables = []
    for (b, _), (r, c) in zip(base, roll):
        sims = [round(SequenceMatcher(None, x, y).ratio(), 6)
                for x, y in zip(b, r)]
        tables.append((sims, c))
        assert b[0] == r[0]
    print("\nrolling drift over %d turns (port = JAX): %s" % (N, tables[1]))
    assert tables[1] == tables[0]
    c = tables[1][1]
    assert c["rolling_restarts"] >= 1 and c["rolling_resumes"] >= 2, c


# the injected LaneKilled is an unhandled thread exception: the fault
# under test
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_killed_resume_decode_ends_lane_quarantined_as_in_jax(monkeypatch,
                                                              tmp_path):
    """Supervised, a resumed turn whose engine is killed mid-decode is
    not replayed: a replay would prompt with the turn's delta alone. Both
    packages end it "lane_quarantined" at the quarantine, with the
    tokens streamed so far (a prefix of the undisturbed resumed turn),
    store the reply with that finish reason, and hold no state of the
    conversation in the readmitted engine's pool; its next turn is
    served."""
    from swarmdb_tpu.backend.chaos import ServingChaos as JChaos
    from swarmdb_tpu_torch.backend.chaos import ServingChaos as TChaos

    N = 24
    js, ts = service_pair(monkeypatch, tmp_path / "calm", True, seq=128)
    jtokens = []
    jsubmit = js.engine.submit

    def jrecording(req):
        user_done = req.on_done

        def on_done(rid, toks, reason):
            jtokens.append(list(toks))
            user_done(rid, toks, reason)

        req.on_done = on_done
        return jsubmit(req)

    js.engine.submit = jrecording
    serve(js, lambda s: [chat(s, "u", "hello there", max_new=N),
                         chat(s, "u", "and again", max_new=N)])
    ts.db.close()
    undisturbed = jtokens[1]
    assert len(undisturbed) == N

    def killed(svc, chaos_cls):
        """Serve two turns; kill the engine once the second (resumed)
        turn has streamed 4 tokens. Returns the first reply, the resumed
        request's outcome as the supervisor hands it to the service, the
        stored reply's finish reason, the supervisor's status, the
        registry and every request the engine was given."""
        chaos = chaos_cls(svc.engine)
        submitted, got, fired = [], {}, []
        submit = svc.engine.submit

        def recording(req):
            submitted.append(req)
            if req.resume_pages is not None:
                on_token = req.on_token

                def counting(rid, tok):
                    on_token(rid, tok)
                    got["streamed"] = got.get("streamed", 0) + 1
                    if got["streamed"] == 4 and not fired:
                        fired.append(True)
                        chaos.kill_lane(0)

                req.on_token = counting
            return submit(req)

        sup_submit = svc.supervisor.submit

        def adopting(req):
            if req.resume_pages is not None:
                on_done = req.on_done

                def outcome(rid, toks, reason):
                    got.update(toks=list(toks), reason=reason)
                    on_done(rid, toks, reason)

                req.on_done = outcome
            return sup_submit(req)

        svc.engine.submit = recording
        svc.supervisor.submit = adopting

        def drive(svc):
            svc.supervisor.poll_s = 0.05
            first = chat(svc, "u", "hello there", max_new=N)
            _, finish = chat(svc, "u", "and again", max_new=N)
            # the restart retires the dead loop's slots (re-storing the
            # killed turn's pages under the old epoch); once the engine is
            # readmitted, no state of the current pool is left
            deadline = time.time() + 60
            while (svc.supervisor.status()["lane_readmissions"] < 1
                   and time.time() < deadline):
                time.sleep(0.05)
            status = svc.supervisor.status()
            with svc._rolling_lock:
                live = {k: st["pages"] for k, st in svc._rolling.items()
                        if st["epoch"] == svc._rolling_epoch()}
            third = chat(svc, "u", "one more", max_new=N)
            return first, dict(got), finish, status, live, third

        try:
            out = serve(svc, drive)
        finally:
            chaos.stop()
        assert fired
        return out, submitted

    jpair = service_pair(monkeypatch, tmp_path / "jax", True, seq=128)
    jpair[1].db.close()
    tpair = service_pair(monkeypatch, tmp_path / "port", True, seq=128)
    tpair[0].db.close()
    results = [killed(jpair[0], JChaos), killed(tpair[1], TChaos)]
    for (first, got, finish, status, live, third), submitted in results:
        assert got["reason"] == finish == "lane_quarantined"
        assert 4 <= len(got["toks"]) <= got["streamed"] < N
        assert got["toks"] == undisturbed[:len(got["toks"])]
        assert status["lane_quarantines"] >= 1
        assert status["requests_retried"] == 0
        assert status["requests_migrated"] == 0
        assert status["lane_readmissions"] >= 1 and live == {}
        # the conversation starts again on the readmitted engine
        assert third[1] == "length"
        resumed = [r for r in submitted if r.resume_pages is not None]
        again = [r for r in submitted if r.metadata.get("message_id")
                 == resumed[0].metadata["message_id"]]
        # the resumed request was submitted once and never replayed
        assert len(resumed) == 1 and len(again) == 1
    assert results[0][0][0] == results[1][0][0]
