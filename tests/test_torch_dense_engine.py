"""PyTorch port vs JAX reference: the dense slot-cache engine end to end,
one chat message through it, and the ``SWARMDB_PAGED`` default.

The JAX side is ``swarmdb_tpu.backend.engine.Engine`` built here with the
dense wiring of its ``build_backend_engine`` (bucketed prefill, the prefix
lane over a side pool, chunked or single-step decode) but a float32 slot
cache and side pool, so that both engines hold the same float32 weights
(``params_from_numpy``) and float32 KV: the same requests must give the
same tokens, greedy and seeded. Prompts come from a seed; one extends an
earlier one, so its pages come back from the side pool
(``prefix_reused_tokens > 0``), and one is shorter than a page (the plain
bucketed wave).
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend import service as jsvc
from swarmdb_tpu.backend.engine import Engine as JaxEngine
from swarmdb_tpu.backend.sampling import SamplingParams as JSP
from swarmdb_tpu.backend.tokenizer import default_tokenizer
from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu_torch.backend import service as tsvc
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.broker.local import LocalBroker
from swarmdb_tpu_torch.core.runtime import SwarmDB
from swarmdb_tpu_torch.utils.convert import params_from_numpy

CFG = get_config("tiny-debug")
MAX_BATCH, SEQ, PS = 4, 96, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the other test workers' timing checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_dense_engine(params, chunked: bool) -> JaxEngine:
    """The JAX package's dense engine as its ``build_backend_engine``
    wires it, with a float32 slot cache and side pool."""
    tok = default_tokenizer(CFG.vocab_size)
    chunked_fns = None
    if chunked:
        chunked_fns = (
            lambda p, t, pos, c, hkv, s: jl.forward_chunked(p, CFG, t, pos,
                                                            c, hkv, s),
            lambda b, k: jl.init_chunk_kv(CFG, b, k),
            jl.merge_chunk)
    prefix_pages = 1 + -(-(MAX_BATCH * SEQ // 2) // PS)
    return JaxEngine(
        lambda p, t, pos, c: jl.forward(p, CFG, t, pos, c),
        lambda b, s: jl.init_kv_cache(CFG, b, s, jnp.float32),
        params, max_batch=MAX_BATCH, max_seq=SEQ, eos_id=tok.eos_id,
        pad_id=tok.pad_id, seed=0, decode_chunk=8,
        chunked_fns=chunked_fns,
        prefix_fns=(
            lambda p, t, tab, pl, pk, pv, lp, logits_at=None:
                jl.forward_prefix_lane(p, CFG, t, tab, pl, pk, pv, lp,
                                       logits_at=logits_at),
            lambda n, ps: jl.init_prefix_pool(CFG, n, ps, jnp.float32)),
        prefix_pages=prefix_pages, prefix_page_size=PS,
        forward_last_fn=lambda p, t, pos, c, at: jl.forward(
            p, CFG, t, pos, c, logits_at=at))


@pytest.mark.parametrize("chunked", ["1", "0"])
def test_dense_engine_tokens_equal_jax_engine(monkeypatch, chunked):
    """Chunked (``SWARMDB_CHUNKED=1``) and single-step (``=0``) dense
    engines, greedy and seeded, with a prefix-lane hit."""
    monkeypatch.delenv("SWARMDB_PAGED", raising=False)
    monkeypatch.setenv("SWARMDB_CHUNKED", chunked)
    jpar = jax.tree.map(lambda a: a.astype(jnp.float32),
                        jl.init_params(CFG, jax.random.PRNGKey(0)))
    je = _jax_dense_engine(jpar, chunked == "1")
    te, _ = tsvc.build_backend_engine(
        "tiny-debug", max_batch=MAX_BATCH, max_seq=SEQ, page_size=PS,
        device="cpu", kv_dtype=torch.float32,
        params=params_from_numpy(jax.tree.map(np.asarray, jpar),
                                 device="cpu"))
    assert te.paged is None and je.paged is None
    assert te.cache[0].dtype == torch.float32
    assert (te._chunked_fns is None) == (chunked == "0")
    assert te.prefill_buckets == je.prefill_buckets
    assert te._prefix_pp_buckets == je._prefix_pp_buckets
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 259, n).tolist() for n in (15, 37, 9, 61)]
    prompts.append(prompts[1] + rng.integers(3, 259, 10).tolist())
    je.start()
    te.start()
    try:
        for p in prompts:
            for sp in (dict(max_new_tokens=12),
                       dict(max_new_tokens=12, temperature=0.9, top_p=0.9,
                            seed=7)):
                assert je.generate_sync(p, JSP(**sp)) == \
                    te.generate_sync(p, TSP(**sp)), (len(p), sp)
    finally:
        je.stop()
        te.stop()
    c = te.metrics.counters
    assert c["prefix_reused_tokens"].value > 0
    assert c["engine_decode_chunks"].value > 0
    assert te._prefix.stats()["cached_pages"] > 0


def test_dense_engine_serves_a_batch_with_long_and_short_prompts(
        monkeypatch):
    """Several requests in flight at once: prompts shorter than a page
    (bucketed waves) and longer ones (the prefix path) admitted together,
    each slot's lane rewritten by its next occupant. Every request ends
    with length/eos and the side pool's pages stay within its size."""
    monkeypatch.delenv("SWARMDB_PAGED", raising=False)
    eng, _ = tsvc.build_backend_engine("tiny-debug", max_batch=3,
                                       max_seq=64, device="cpu")
    assert eng.paged is None and eng.cache[0].dtype == torch.bfloat16
    rng = np.random.default_rng(1)
    done = {}
    eng.start()
    try:
        from swarmdb_tpu_torch.backend.engine import GenRequest

        ids = []
        for i, n in enumerate((5, 40, 12, 33, 2, 50, 17)):
            ids.append(eng.submit(GenRequest(
                prompt=rng.integers(3, 259, n).tolist(),
                sampling=TSP(max_new_tokens=6 + i),
                on_done=lambda r, t, why: done.__setitem__(r, (t, why)))))
        deadline = time.time() + 60
        while len(done) < len(ids) and time.time() < deadline:
            time.sleep(0.05)
    finally:
        eng.stop()
    assert set(done) == set(ids)
    assert all(why in ("length", "eos") for _, why in done.values())
    st = eng._prefix.stats()
    assert st["cached_pages"] + st["free_pages"] <= st["num_pages"] - 1
    assert eng.stats()["cache"] == "dense"


def test_message_round_trip_through_dense_service(monkeypatch):
    """One chat message through the port's SwarmDB + ServingService with
    ``SWARMDB_PAGED`` unset: the dense engine."""
    monkeypatch.delenv("SWARMDB_PAGED", raising=False)
    db = SwarmDB(broker=LocalBroker())
    svc = tsvc.ServingService.from_model_name(db, "tiny-debug",
                                              backend_id="b0", max_batch=2,
                                              max_seq=128, device="cpu")
    try:
        assert svc.engine.paged is None
        db.register_agent("user")
        db.register_agent("bot")
        db.assign_llm_backend("bot", "b0")
        svc.start()
        mid = db.send_message("user", "bot", "hello dense bot",
                              metadata={"generation": {"max_new_tokens": 6}})
        deadline = time.time() + 60
        replies = []
        while not replies and time.time() < deadline:
            replies = db.receive_messages("user", timeout=0.2)
        assert replies, "no reply arrived"
        assert replies[0].metadata["reply_to"] == mid
        assert replies[0].metadata["finish_reason"] in ("length", "eos")
        assert svc.engine.cache[0].device.type == "cpu"
        assert svc.health()["engine"]["cache"] == "dense"
    finally:
        svc.stop()
        db.close()


@pytest.mark.parametrize("env", [None, "0", "1"])
def test_swarmdb_paged_default_agrees_with_jax(monkeypatch, env):
    """The same ``SWARMDB_PAGED`` builds the same kind of engine in both
    packages: "1" paged, anything else (unset included) dense."""
    if env is None:
        monkeypatch.delenv("SWARMDB_PAGED", raising=False)
    else:
        monkeypatch.setenv("SWARMDB_PAGED", env)
    je, _ = jsvc.build_backend_engine("tiny-debug", max_batch=2, max_seq=64)
    te, _ = tsvc.build_backend_engine("tiny-debug", max_batch=2, max_seq=64,
                                      device="cpu")
    assert (te.paged is None) == (je.paged is None) == (env != "1")
