"""PyTorch port vs JAX reference: the engine keywords and knobs.

- ``Engine(aging_s=)``: the JAX engine's aging case
  (``tests/test_engine.py::test_age_queue_promotes_starved_low_priority``)
  on both engines with the same requests, and ``SWARMDB_AGING_S`` read as
  the JAX engine reads it ("2.5", "0", "x" and unset).
- ``build_serving_engine``'s ``eos_id``, ``pad_id``, ``pipeline_depth``
  and ``aging_s``: on one CPU device the engine holds the JAX call's four
  values, and greedy tokens stop at a custom EOS where the JAX engine's
  do (float32 weights, bf16 slot cache in both, as the JAX call builds
  it); a one-process program over two CPU devices carries the four to
  its worker, and again after ``restart()``.
- ``SWARMDB_PREFILL_ROWS``: tiny-moe (8 experts, so that capacity
  binds) paged at ``prefill_batch`` 2 and 8, unset, "0", "1" and "": the
  row buckets and the greedy tokens of one admission round equal the JAX
  engine's, exactly, at float32. A MoE block's capacity counts the
  padding rows, so the buckets decide the tokens: "0" and "1" give
  different ones.

``ServingChaos.run_script`` is held against the JAX package in
``tests/test_torch_lane_chaos.py``.
"""

import functools
import re
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import swarmdb_tpu.parallel.serving as jserving
from swarmdb_tpu.backend.engine import Engine as JaxEngine
from swarmdb_tpu.backend.engine import GenRequest as JReq
from swarmdb_tpu.backend.sampling import SamplingParams as JSP
from swarmdb_tpu.backend.service import build_backend_engine as jax_build
from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models import mixtral as jm
from swarmdb_tpu.models.configs import get_config as jcfg
from swarmdb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from swarmdb_tpu_torch.backend.engine import GenRequest as TReq
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.backend.service import build_backend_engine
from swarmdb_tpu_torch.backend.tokenizer import default_tokenizer
from swarmdb_tpu_torch.models.configs import get_config as tcfg
from swarmdb_tpu_torch.parallel.serving import build_serving_engine
from swarmdb_tpu_torch.utils.convert import params_from_numpy

TINY = jcfg("tiny-debug")
#: the four engine keywords, none of them a default
KNOBS = dict(pad_id=3, pipeline_depth=1, aging_s=2.5)
WAIT_S = 120


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the other test workers' timing checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


# ------------------------------------------------------------------ aging


def _jax_engine(**kw):
    params = jl.init_params(TINY, jax.random.PRNGKey(0))
    return JaxEngine(
        lambda p, t, pos, c: jl.forward(p, TINY, t, pos, c),
        lambda b, s: jl.init_kv_cache(TINY, b, s),
        params, max_batch=2, max_seq=64, seed=0, prefill_buckets=[16],
        **kw)


def _port_engine(**kw):
    return build_backend_engine("tiny-debug", max_batch=2, max_seq=64,
                                device="cpu", **kw)[0]


ENGINES = {"jax": (_jax_engine, JReq), "torch": (_port_engine, TReq)}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_age_queue_promotes_starved_low_priority(pkg):
    """A LOW request that has waited two aging periods outranks a younger
    NORMAL one, its own priority untouched, once; ``aging_s=0`` keeps
    strict priority. The same requests give the same heap order in both
    packages (the JAX case, run on each engine)."""
    make, Req = ENGINES[pkg]
    eng = make(aging_s=5.0)
    assert eng._aging_s == 5.0
    old_low = Req(prompt=[1, 2], priority=0)
    old_low.submitted_at = time.time() - 11.0  # two class bumps earned
    fresh_normal = Req(prompt=[1, 3], priority=1)
    eng.submit(old_low)
    eng.submit(fresh_normal)
    with eng._cv:
        assert eng._queue[0][3] is fresh_normal  # strict priority order
    eng._age_queue()
    with eng._cv:
        assert eng._queue[0][3] is old_low  # aged to class 2 > NORMAL
    assert old_low.priority == 0  # original priority untouched
    assert eng.metrics.counters["engine_priority_aged"].value == 1
    # idempotent: a second pass with no further wait changes nothing
    eng._age_queue()
    with eng._cv:
        assert eng._queue[0][3] is old_low
    assert eng.metrics.counters["engine_priority_aged"].value == 1
    eng2 = make(aging_s=0)
    old2 = Req(prompt=[1, 2], priority=0)
    old2.submitted_at = time.time() - 100.0
    new2 = Req(prompt=[1, 3], priority=1)
    eng2.submit(old2)
    eng2.submit(new2)
    eng2._age_queue()
    with eng2._cv:
        assert eng2._queue[0][3] is new2


@pytest.mark.parametrize("env", ["2.5", "0", "x", None],
                         ids=["2.5", "0", "not_a_float", "unset"])
def test_aging_s_reads_the_environment_as_jax(monkeypatch, env):
    """``aging_s=None`` reads ``SWARMDB_AGING_S`` (default 5.0; a value
    that is not a float gives 5.0); a given value wins over it."""
    if env is None:
        monkeypatch.delenv("SWARMDB_AGING_S", raising=False)
    else:
        monkeypatch.setenv("SWARMDB_AGING_S", env)
    want = _jax_engine()._aging_s
    assert _port_engine()._aging_s == want
    assert want == {"2.5": 2.5, "0": 0.0}.get(env, 5.0)
    assert _port_engine(aging_s=1.5)._aging_s == _jax_engine(
        aging_s=1.5)._aging_s == 1.5


# ------------------------------------------------ build_serving_engine


PROMPTS = [[1, 5, 9, 13, 2], list(range(3, 40)), [7, 7, 7]]


def _greedy(eng, n=12):
    """[(tokens, reason)] of ``PROMPTS``, one after another."""
    SP = JSP if isinstance(eng, JaxEngine) else TSP
    eng.start()
    try:
        out = []
        for p in PROMPTS:
            toks, why = eng.generate_sync(p, SP(max_new_tokens=n),
                                          timeout=WAIT_S)
            out.append((list(toks), why))
        return out
    finally:
        eng.stop()


def test_build_serving_engine_keywords_equal_the_jax_call(monkeypatch):
    """One CPU device: the engine holds the JAX call's ``eos_id``,
    ``pad_id``, ``pipeline_depth`` and ``aging_s``, and with an EOS that
    the first prompt's greedy run emits, both stop there with the same
    tokens."""
    for k in ("SWARMDB_PAGED", "SWARMDB_CHUNKED", "SWARMDB_AGING_S",
              "SWARMDB_PIPELINE"):
        monkeypatch.delenv(k, raising=False)
    # the JAX call's program has no prefix cache
    monkeypatch.setenv("SWARMDB_PREFIX", "0")
    monkeypatch.setattr(jserving, "build_sharded_model", functools.partial(
        jserving.build_sharded_model, dtype=jnp.float32))
    mesh = jax_make_mesh(devices=jax.devices()[:1], data=1, model=1,
                         expert=1)
    shape = dict(max_batch=4, max_seq=64, seed=0)
    params = params_from_numpy(_np(jserving.build_sharded_model(
        TINY, mesh, seed=0).params), device="cpu")

    def port(**kw):
        eng, _ = build_serving_engine("tiny-debug", ["cpu"], params=params,
                                      **shape, **kw)
        return eng

    # the EOS: a token the first prompt's greedy run emits, first at i
    probe = _greedy(port())[0][0]
    i = next(i for i in range(2, len(probe)) if probe[i] not in probe[:i])
    eos = probe[i]
    je, _ = jserving.build_serving_engine(TINY, mesh, eos_id=eos, **shape,
                                          **KNOBS)
    te = port(eos_id=eos, **KNOBS)
    assert (te.eos_id, te.pad_id, te.pipeline_depth, te._aging_s) == (
        je.eos_id, je.pad_id, je.pipeline_depth, je._aging_s) == (
        eos, 3, 1, 2.5)
    got, want = _greedy(te), _greedy(je)
    assert got == want
    assert got[0][1] == "eos" and len(got[0][0]) <= i + 1


def test_build_serving_engine_defaults(monkeypatch):
    """Unset, the four are the tokenizer's ids, ``SWARMDB_PIPELINE`` and
    ``SWARMDB_AGING_S`` (read by the engine)."""
    monkeypatch.setenv("SWARMDB_PIPELINE", "3")
    monkeypatch.setenv("SWARMDB_AGING_S", "7")
    monkeypatch.delenv("SWARMDB_PAGED", raising=False)
    eng, _ = build_serving_engine("tiny-debug", ["cpu"], max_batch=2,
                                  max_seq=64)
    tok = default_tokenizer(tcfg("tiny-debug").vocab_size)
    assert (eng.eos_id, eng.pad_id, eng.pipeline_depth, eng._aging_s) == (
        tok.eos_id, tok.pad_id, 3, 7.0)
    monkeypatch.delenv("SWARMDB_PIPELINE")
    eng, _ = build_serving_engine("tiny-debug", ["cpu"], max_batch=2,
                                  max_seq=64)
    assert eng.pipeline_depth == 2


def _worker_knobs(eng):
    """The worker's (eos_id, pad_id, pipeline_depth, aging_s), from the
    line its engine logs once built."""
    m = re.search(r"rank 1 engine: eos_id (\d+) pad_id (\d+) "
                  r"pipeline_depth (\d+) aging_s (\S+)", eng._owner._tail(1))
    assert m, eng._owner._tail(1)
    return (int(m[1]), int(m[2]), int(m[3]), float(m[4]))


def test_local_program_carries_the_keywords_through_restart(monkeypatch):
    """Over two CPU devices (the dense program on the model axis), the
    coordinator's engine and its worker's hold the four, and a restarted
    program's new worker holds them too and serves the same tokens."""
    monkeypatch.setenv("SWARMDB_KV_DTYPE", "f32")
    knobs = dict(eos_id=4, **KNOBS)
    want = (4, 3, 1, 2.5)
    eng, _ = build_serving_engine("tiny-debug", ["cpu", "cpu"], max_batch=4,
                                  max_seq=64, decode_chunk=4, **knobs)
    try:
        assert (eng.eos_id, eng.pad_id, eng.pipeline_depth,
                eng._aging_s) == want
        assert _worker_knobs(eng) == want
        eng.start()
        first = eng.generate_sync(PROMPTS[1], TSP(max_new_tokens=6),
                                  timeout=WAIT_S)
        old = eng._owner.pids()
        eng.restart()
        assert eng._owner.pids() != old
        assert _worker_knobs(eng) == want
        assert eng.generate_sync(PROMPTS[1], TSP(max_new_tokens=6),
                                 timeout=WAIT_S) == first
    finally:
        eng.stop()


# ------------------------------------------------------ SWARMDB_PREFILL_ROWS


MOE_J = jcfg("tiny-moe", n_experts=8)
MOE_T = tcfg("tiny-moe", n_experts=8)
ROWS_BATCH, SEQ, PS = 8, 96, 16


def _rows_engines(monkeypatch, prefill_batch):
    """The JAX package's paged tiny-moe engine and the port's on the same
    float32 weights over float32 pools (the JAX temp prefill cache in
    float32 too)."""
    monkeypatch.setenv("SWARMDB_KV_DTYPE", "f32")
    for k in ("SWARMDB_CHUNKED", "SWARMDB_EMIT_RING", "SWARMDB_PIPELINE"):
        monkeypatch.delenv(k, raising=False)
    je, _ = jax_build(MOE_J, max_batch=ROWS_BATCH, max_seq=SEQ, paged=True,
                      page_size=PS, seed=0, prefill_batch=prefill_batch)
    je.params = jax.tree.map(lambda a: a.astype(jnp.float32), je.params)
    je._prefill_cache_fn = (
        lambda b, s: jm.init_kv_cache(MOE_J, b, s, jnp.float32))
    te, _ = build_backend_engine(
        MOE_T, max_batch=ROWS_BATCH, max_seq=SEQ, paged=True, page_size=PS,
        device="cpu", prefill_batch=prefill_batch,
        params=params_from_numpy(_np(je.params), device="cpu"))
    return je, te


def _one_round(engine, Req, SP, prompts, n=8):
    """Greedy tokens of ``prompts`` submitted before the loop starts: one
    admission round."""
    done = {}
    ids = [engine.submit(Req(
        prompt=p, sampling=SP(max_new_tokens=n),
        on_done=lambda rid, toks, why: done.__setitem__(rid, (list(toks),
                                                              why))))
        for p in prompts]
    engine.start()
    try:
        deadline = time.time() + WAIT_S
        while len(done) < len(ids) and time.time() < deadline:
            time.sleep(0.02)
    finally:
        engine.stop()
    return [done.get(i) for i in ids]


@pytest.mark.parametrize("env", [None, "0", "1", ""],
                         ids=["unset", "0", "1", "empty"])
@pytest.mark.parametrize("prefill_batch", [2, 8])
def test_prefill_rows_knob_equals_jax(monkeypatch, prefill_batch, env):
    """Unset ("auto"): the power-of-two ladder when ``prefill_batch <=
    4``; "0": ``[prefill_batch]``; any other value, "" included: the
    ladder. Three prompts in one round pad to the bucket's rows; the
    tokens equal the JAX engine's."""
    if env is None:
        monkeypatch.delenv("SWARMDB_PREFILL_ROWS", raising=False)
    else:
        monkeypatch.setenv("SWARMDB_PREFILL_ROWS", env)
    je, te = _rows_engines(monkeypatch, prefill_batch)
    ladder = [1, 2] if prefill_batch == 2 else [1, 2, 4, 8]
    on = env not in (None, "0") or (env is None and prefill_batch <= 4)
    assert te._row_buckets == je._row_buckets == (
        ladder if on else [prefill_batch])
    assert not te._ragged
    rng = np.random.default_rng(prefill_batch)
    prompts = [rng.integers(3, 259, n).tolist() for n in (15, 37, 21)]
    want = _one_round(je, JReq, JSP, prompts)
    got = _one_round(te, TReq, TSP, prompts)
    assert all(g is not None for g in got)
    assert got == want
    assert te.metrics.counters["prefill_waves"].value > 0


def test_prefill_rows_knob_changes_moe_tokens(monkeypatch):
    """At ``prefill_batch`` 8 the round's three rows pad to 8 under "0"
    and to 4 under "1": the padding takes capacity, so the tokens part."""
    outs = {}
    for env in ("0", "1"):
        monkeypatch.setenv("SWARMDB_PREFILL_ROWS", env)
        _, te = _rows_engines(monkeypatch, 8)
        rng = np.random.default_rng(8)
        prompts = [rng.integers(3, 259, n).tolist() for n in (15, 37, 21)]
        outs[env] = _one_round(te, TReq, TSP, prompts)
    assert outs["0"] != outs["1"]
