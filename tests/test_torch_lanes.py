"""Lane groups against the JAX reference: ``build_serving_engine`` over
several devices gives one paged engine per device behind one facade.

The cases of ``tests/test_admit_overlap.py`` that apply to lanes (its
GSPMD and leadership re-pin cases belong to ROADMAP.md queue 1 items 11
and 12), each run through both packages: the JAX group on the conftest's
virtual CPU devices, the port's on ``["cpu"] * 2``, tiny-debug with the
same float32 weights (``params_from_numpy``) and float32 pools.

- the group's shape and facade; lanes on one device share one weights
  dict; one device gives the single engine;
- greedy tokens equal across lanes and equal to the JAX package's
  (exactly: float32 on both sides); sampled tokens per lane equal to the
  JAX package's, from the per-lane slot keys;
- hint routing; waves admitted while a sibling lane decodes counted;
  admission by priority within a lane; a restart revives dead lanes
  only;
- host waits per streamed request: one per decode chunk in the port (its
  resident session waits on each chunk's block, ROADMAP.md queue 1 item
  2), where the JAX package's resident loop waits once per session.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend.engine import GenRequest as JReq
from swarmdb_tpu.backend.sampling import SamplingParams as JSP
from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu.parallel.mesh import make_mesh
from swarmdb_tpu.parallel.serving import build_serving_engine as jbuild
from swarmdb_tpu_torch.backend.engine import Engine
from swarmdb_tpu_torch.backend.engine import GenRequest as TReq
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.parallel.lanes import ShardLaneGroup
from swarmdb_tpu_torch.parallel.serving import build_serving_engine as tbuild
from swarmdb_tpu_torch.utils.convert import params_from_numpy

CFG = get_config("tiny-debug")
MAX_BATCH, SEQ, PS, CHUNK = 4, 128, 8, 4
PKG = {"jax": (JReq, JSP), "torch": (TReq, TSP)}


def f32_params(seed=0):
    return jax.tree.map(lambda a: a.astype(jnp.float32),
                        jl.init_params(CFG, jax.random.PRNGKey(seed)))


def build_pair(mp, n=2, max_batch=MAX_BATCH, env=None, params=None):
    """(JAX group, port group) of ``n`` lanes on one set of float32
    weights over float32 pools. ``mp`` (a MonkeyPatch the caller undoes
    after stopping the groups) holds ``SWARMDB_KV_DTYPE`` and ``env``,
    which a restarted lane reads again."""
    mp.setenv("SWARMDB_KV_DTYPE", "f32")
    for k in ("SWARMDB_FLEET", "SWARMDB_FLEET_TIERS", "SWARMDB_PAGED",
              "SWARMDB_EMIT_RING", "SWARMDB_CHUNKED"):
        mp.delenv(k, raising=False)
    for k, v in (env or {}).items():
        mp.setenv(k, v)
    params = f32_params() if params is None else params

    def placed(cfg, key):
        # each JAX lane's weights: ``params`` on the lane's device (the
        # JAX build inits under ``jax.default_device``), with no random
        # init to compile per device
        return jax.device_put(params, jax.config.jax_default_device)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jl, "init_params", placed)
        jg, jinfo = jbuild(CFG, make_mesh(n, data=n, model=1, expert=1),
                           max_batch=max_batch, max_seq=SEQ, paged=True,
                           page_size=PS, decode_chunk=CHUNK)
    for e in jg.lanes:
        assert e.params["embed"].devices() == {e._home_device}
    tg, tinfo = tbuild("tiny-debug", ["cpu"] * n, max_batch=max_batch,
                       max_seq=SEQ, paged=True, page_size=PS,
                       decode_chunk=CHUNK, params=params_from_numpy(
                           jax.tree.map(np.asarray, params), device="cpu"))
    assert jinfo.data_size == tinfo.data_size == n
    return jg, tg


def gen(pkg, group, prompt, max_new, hint=None, priority=1, on_token=None,
        deadline=None, timeout=120.0, **sampling):
    """One request through ``group`` of package ``pkg``, waited for:
    (tokens, reason, streamed)."""
    Req, SP = PKG[pkg]
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

    group.submit(Req(prompt=list(prompt), priority=priority,
                     sampling=SP(max_new_tokens=max_new, **sampling),
                     on_token=_tok, on_done=_done, shard_hint=hint,
                     deadline=deadline))
    assert done.wait(timeout), f"{pkg}: request never completed"
    return out["toks"], out["reason"], streamed


def gen_many(pkg, group, specs, timeout=180.0):
    """Submit every (prompt, max_new, kwargs) of ``specs`` at once, then
    wait: [(tokens, reason)] in order, and the ids in completion order."""
    Req, SP = PKG[pkg]
    events = [threading.Event() for _ in specs]
    outs = [None] * len(specs)
    order = []
    lock = threading.Lock()

    def mk(i):
        def _done(rid, toks, reason):
            with lock:
                outs[i] = (toks, reason)
                order.append(i)
            events[i].set()
        return _done

    for i, (prompt, max_new, kw) in enumerate(specs):
        kw = dict(kw)
        hint, prio = kw.pop("hint", None), kw.pop("priority", 1)
        group.submit(Req(prompt=list(prompt), priority=prio,
                         sampling=SP(max_new_tokens=max_new, **kw),
                         on_done=mk(i), shard_hint=hint))
    for i, ev in enumerate(events):
        assert ev.wait(timeout), f"{pkg}: request {i} never completed"
    return outs, order


@pytest.fixture(scope="module")
def pair():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    jg, tg = build_pair(mp)
    jg.start()
    tg.start()
    yield {"jax": jg, "torch": tg}
    tg.stop()
    jg.stop()
    mp.undo()
    torch.set_num_threads(threads)


def test_group_shape_and_facade(pair):
    jg, tg = pair["jax"], pair["torch"]
    assert isinstance(tg, ShardLaneGroup)
    assert len(tg.lanes) == len(jg.lanes) == 2
    assert tg.max_batch == jg.max_batch == MAX_BATCH
    assert tg.paged.allocator.n_shards == jg.paged.allocator.n_shards == 2
    # the pools are sized by the JAX package's rule: slot windows plus a
    # window per slot of prefix budget, per lane
    assert ([e.paged.num_pages for e in tg.lanes]
            == [e.paged.num_pages for e in jg.lanes])
    assert (tg.paged.allocator.stats()["num_pages"]
            == jg.paged.allocator.stats()["num_pages"])
    # lanes on one device share one weights dict (JAX replicates per
    # device); every lane is its own paged engine on that device
    assert tg.lanes[0].params is tg.lanes[1].params
    assert all(e.device.type == "cpu" and e.paged is not None
               and e._resident and e.stream is None for e in tg.lanes)
    assert tg.supports_rolling() is jg.supports_rolling() is False
    assert tg.fleet is None and jg.fleet is None
    assert [e.flight_shard for e in tg.lanes] == [0, 1]
    assert all(e.flight is tg.flight for e in tg.lanes)


def test_one_device_gives_the_single_engine():
    eng, info = tbuild("tiny-debug", ["cpu"], max_seq=64, paged=True)
    assert isinstance(eng, Engine) and info.data_size == 1
    assert eng.max_batch == 8 and eng.paged is not None


def test_lanes_generate_equal_greedy_tokens_equal_to_jax(pair):
    prompt = [1, 5, 9, 13]
    outs = {}
    for pkg, g in pair.items():
        res, _ = gen_many(pkg, g, [(prompt, 6, {"hint": h})
                                   for h in (0, 1)])
        outs[pkg] = res
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == outs["torch"][1]
    assert outs["torch"][0][1] == "length"


def test_sampled_tokens_per_lane_equal_jax(pair):
    """Each lane samples with its own slot keys (seed + 7919 (d + 1)):
    the same key words as the JAX lane's, and its tokens."""
    for tl, jl_ in zip(pair["torch"].lanes, pair["jax"].lanes):
        np.testing.assert_array_equal(tl._default_keys_np,
                                      np.asarray(jl_._default_keys_np))
    prompt = [3, 8, 2, 7, 11]
    outs = {}
    for pkg, g in pair.items():
        outs[pkg], _ = gen_many(pkg, g, [
            (prompt, 8, {"hint": h, "temperature": 0.8}) for h in (0, 1)])
    assert outs["torch"] == outs["jax"]


@pytest.mark.parametrize("hint", [1, 4])
def test_shard_hint_routes_to_lane(pair, hint):
    for pkg, g in pair.items():
        before = [e.total_requests for e in g.lanes]
        gen(pkg, g, [2, 4], 2, hint=hint)
        after = [e.total_requests for e in g.lanes]
        lane = hint % 2
        assert after[lane] == before[lane] + 1, (pkg, before, after)
        assert sum(after) == sum(before) + 1


def test_admission_overlaps_sibling_decode(pair):
    """Waves admitted while the sibling lane is inside a decode session:
    both packages count some under the same load."""
    specs = [([1, 3 + i % 40, 5], 8 + 4 * (i % 3), {"hint": i})
             for i in range(12)]
    for pkg, g in pair.items():
        c = g.metrics.counters["engine_admission_overlap_steps"]
        before = c.value
        res, _ = gen_many(pkg, g, specs)
        assert all(r == "length" for _, r in res)
        assert c.value > before, f"{pkg}: no wave overlapped a sibling"


def test_admission_by_priority_within_a_lane(pair):
    """Both of lane 0's slots decode long requests while four low- and
    four high-priority requests queue behind them: the four high ones
    are admitted first (their first tokens come first), in both packages
    (per-lane strict priority with the default aging, SWARMDB_AGING_S =
    5 s, which does not reach them). Order, not wall-clock latency."""
    for pkg, g in pair.items():
        Req, SP = PKG[pkg]
        started = threading.Semaphore(0)
        blockers = []
        for i in range(2):
            ev = threading.Event()
            seen = []

            def tok(rid, t, _seen=seen):
                if not _seen:
                    _seen.append(t)
                    started.release()

            g.submit(Req(prompt=[9, 9, i + 1], shard_hint=0,
                         sampling=SP(max_new_tokens=24), on_token=tok,
                         on_done=lambda *a, _ev=ev: _ev.set()))
            blockers.append(ev)
        for _ in range(2):
            assert started.acquire(timeout=60), f"{pkg}: blocker idle"
        first = []   # request index, in the order of first tokens
        lock = threading.Lock()
        done = [threading.Event() for _ in range(8)]
        for i in range(8):
            def tok(rid, t, _i=i):
                with lock:
                    if _i not in first:
                        first.append(_i)

            g.submit(Req(prompt=[4 + i // 4, 4, i], shard_hint=0,
                         priority=0 if i < 4 else 3,
                         sampling=SP(max_new_tokens=4), on_token=tok,
                         on_done=lambda *a, _d=done[i]: _d.set()))
        for ev in done + blockers:
            assert ev.wait(60), f"{pkg}: a request never finished"
        assert sorted(first) == list(range(8))
        assert set(first[:4]) == {4, 5, 6, 7}, (pkg, first)


def test_host_waits_per_streamed_request(pair):
    """The port's resident session waits once per decode chunk (its vote
    after a chunk reads that chunk's block), so a request streamed alone
    through an idle lane costs as many host syncs as chunks; the JAX
    package's costs at most 3 (admit, session, final) per request."""
    tg = pair["torch"]
    c = tg.metrics.counters
    before = (c["engine_host_syncs"].value, c["engine_decode_chunks"].value)
    toks, reason, streamed = gen("torch", tg, [1, 2, 3], 32, hint=1)
    syncs = c["engine_host_syncs"].value - before[0]
    chunks = c["engine_decode_chunks"].value - before[1]
    assert reason == "length" and streamed == toks and len(toks) == 32
    assert syncs == chunks and 32 // CHUNK <= chunks <= 32 // CHUNK + 1
    jg = pair["jax"]
    jtoks, _, _ = gen("jax", jg, [1, 2, 3], 32, hint=1)
    rec = next(r for r in reversed(jg.flight.requests())
               if r["generated"] == 32)
    assert rec["host_syncs"] <= 3 and jtoks == toks


def test_group_restart_revives_only_dead_lanes(pair):
    for pkg, g in pair.items():
        lane = g.lanes[1]
        lane.stop()
        assert not g.alive()
        threads = [e._thread for e in g.lanes]
        g.restart()
        assert g.alive()
        assert g.lanes[0]._thread is threads[0]
        assert g.lanes[1]._thread is not None
        toks, reason, _ = gen(pkg, g, [5, 6], 2, hint=1)
        assert reason == "length" and len(toks) == 2
