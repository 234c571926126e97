"""PyTorch port vs JAX reference: the paged engine end to end, and one chat
message through the port's SwarmDB + ServingService with the paged engine,
on the CPU (the dense engine: tests/test_torch_dense_engine.py).

Both engines run tiny-debug with the same float32 weights (carried over by
``params_from_numpy``) and float32 pools (``SWARMDB_KV_DTYPE=f32``): the
same requests must give the same tokens, greedy and seeded. Prompts are
drawn from a seed; one is long enough to split across ragged waves, and
repeats hit the prefix cache.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend.sampling import SamplingParams as JSP
from swarmdb_tpu.backend.service import build_backend_engine as jax_build
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu_torch.backend.engine import GenRequest
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.backend.service import (ServingService,
                                               build_backend_engine)
from swarmdb_tpu_torch.broker.local import LocalBroker
from swarmdb_tpu_torch.core.runtime import SwarmDB
from swarmdb_tpu_torch.utils.convert import params_from_numpy

CFG = get_config("tiny-debug")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the other test workers' timing checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def engines(monkeypatch):
    monkeypatch.setenv("SWARMDB_KV_DTYPE", "f32")
    je, _ = jax_build(CFG, max_batch=4, max_seq=96, paged=True, page_size=16)
    je.params = jax.tree.map(lambda a: a.astype(jnp.float32), je.params)
    te, _ = build_backend_engine(
        "tiny-debug", max_batch=4, max_seq=96, paged=True, page_size=16,
        device="cpu", params=params_from_numpy(jax.tree.map(np.asarray, je.params),
                                 device="cpu"))
    je.start()
    te.start()
    yield je, te
    je.stop()
    te.stop()


def test_engine_tokens_equal_jax_engine(engines):
    je, te = engines
    assert te.cache["k"].dtype == torch.float32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 259, n).tolist() for n in (15, 37, 1, 22, 61)]
    prompts.append(prompts[1] + rng.integers(3, 259, 10).tolist())
    for p in prompts:
        for sp in (dict(max_new_tokens=12),
                   dict(max_new_tokens=12, temperature=0.9, top_p=0.9,
                        seed=7)):
            assert je.generate_sync(p, JSP(**sp)) == \
                te.generate_sync(p, TSP(**sp)), (len(p), sp)
    c = te.metrics.counters
    assert c["prefix_reused_tokens"].value > 0   # repeats hit the cache
    assert c["prefill_packed_tokens"].value > 0


def test_message_round_trip_through_serving_service(tmp_path):
    db = SwarmDB(broker=LocalBroker(), save_dir=str(tmp_path))
    svc = ServingService.from_model_name(db, "tiny-debug", backend_id="b0",
                                         max_batch=2, max_seq=128,
                                         paged=True, device="cpu")
    try:
        db.register_agent("user")
        db.register_agent("bot")
        db.assign_llm_backend("bot", "b0")
        svc.start()
        mid = db.send_message("user", "bot", "hello bot",
                              metadata={"generation": {"max_new_tokens": 6}})
        deadline = time.time() + 60
        replies = []
        while not replies and time.time() < deadline:
            replies = db.receive_messages("user", timeout=0.2)
        assert replies, "no reply arrived"
        meta = replies[0].metadata
        assert meta["reply_to"] == mid
        assert meta["finish_reason"] in ("length", "eos")
        assert meta["backend_id"] == "b0"
        assert svc.engine.cache["k"].device.type == "cpu"
        assert svc.health()["status"] == "healthy"
    finally:
        svc.stop()
        db.close()


def test_a_failed_submit_finishes_callers_that_attached(tmp_path):
    """A second ``serve_message`` of one message attaches to the first's
    generation while it is being submitted. If that submit raises, the
    first caller gets the error and every attached caller its ``on_done``
    with "engine_error", under the request id it was given."""
    db = SwarmDB(broker=LocalBroker(), save_dir=str(tmp_path))
    svc = ServingService.from_model_name(db, "tiny-debug", backend_id="b0",
                                         max_batch=2, max_seq=128,
                                         device="cpu")
    entered, release = threading.Event(), threading.Event()

    def failing_submit(req):
        entered.set()
        release.wait(10)
        raise RuntimeError("submit failed")

    svc._submit = failing_submit
    try:
        db.register_agent("user")
        db.register_agent("bot")
        msg = db.get_message(db.send_message("user", "bot", "hello bot"))
        first = []

        def serve_first():
            try:
                svc.serve_message(msg)
            except RuntimeError as exc:
                first.append(str(exc))

        t = threading.Thread(target=serve_first)
        t.start()
        assert entered.wait(10)
        done = []
        rid = svc.serve_message(
            msg, on_done=lambda r, toks, why: done.append((r, toks, why)))
        assert isinstance(rid, str) and done == []
        release.set()
        t.join(10)
        assert first == ["submit failed"]
        assert done == [(rid, [], "engine_error")]
        # the failed claim is gone: the next caller starts anew
        entered.clear()
        with pytest.raises(RuntimeError):
            svc.serve_message(msg)
    finally:
        release.set()
        svc.stop()
        db.close()


def test_cancel_queued_and_unknown_requests():
    eng, _ = build_backend_engine("tiny-debug", max_batch=2, max_seq=64,
                                  paged=True, device="cpu")
    done = []
    rid = eng.submit(GenRequest(prompt=[1, 5, 9], sampling=TSP(),
                                on_done=lambda r, t, why: done.append(why)))
    assert eng.cancel(rid)            # still queued: the engine never ran
    assert done == ["cancelled"]
    assert not eng.cancel(rid)        # gone now
    assert eng.metrics.counters["engine_cancelled"].value == 1
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(GenRequest(prompt=[1] * 64))
