"""PyTorch port vs JAX reference: ``n > 1`` fan-out through SwarmDB +
ServingService.

A message whose ``metadata["generation"]["n"]`` asks for n completions
gets one reply: its body is completion 0, and ``metadata["alternatives"]``
holds completions 1..n-1, each sampled with seed ``seed + i`` and each
stopped by its own stop-sequence watch; a cancel of completion 0's
request reaches every member. Both packages' services run tiny-debug on
the same float32 weights (``params_from_numpy``) over a float32 cache:
the dense engine (float32 slot cache and side pool) and the paged one
(``SWARMDB_KV_DTYPE=f32``). The same seeded message must give the same
body and alternatives -- texts, finish reasons and token counts --
exactly (the tokens are equal, greedy and seeded).
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend import service as jsvc
from swarmdb_tpu.backend.engine import Engine as JaxEngine
from swarmdb_tpu.backend.tokenizer import default_tokenizer
from swarmdb_tpu.broker.local import LocalBroker as JaxBroker
from swarmdb_tpu.core.messages import Message as JaxMessage
from swarmdb_tpu.core.runtime import SwarmDB as JaxDB
from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu_torch.backend import service as tsvc
from swarmdb_tpu_torch.broker.local import LocalBroker
from swarmdb_tpu_torch.core.messages import Message
from swarmdb_tpu_torch.core.runtime import SwarmDB
from swarmdb_tpu_torch.utils.convert import params_from_numpy

CFG = get_config("tiny-debug")
MAX_BATCH, SEQ, PS = 4, 128, 16


def _jax_dense_engine(params) -> JaxEngine:
    """The JAX package's dense engine as its ``build_backend_engine``
    wires it (chunked decode, the prefix lane over a side pool), with a
    float32 slot cache and side pool."""
    tok = default_tokenizer(CFG.vocab_size)
    return JaxEngine(
        lambda p, t, pos, c: jl.forward(p, CFG, t, pos, c),
        lambda b, s: jl.init_kv_cache(CFG, b, s, jnp.float32),
        params, max_batch=MAX_BATCH, max_seq=SEQ, eos_id=tok.eos_id,
        pad_id=tok.pad_id, seed=0, decode_chunk=8,
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
def services(request, tmp_path_factory):
    """(JAX service, port service), both started, on the same weights."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setenv("SWARMDB_KV_DTYPE", "f32")
    mp.delenv("SWARMDB_PAGED", raising=False)
    mp.delenv("SWARMDB_SUPERVISE", raising=False)
    tmp = tmp_path_factory.mktemp(request.param)
    jtok = default_tokenizer(CFG.vocab_size)
    if request.param == "paged":
        je, jtok = jsvc.build_backend_engine(CFG, max_batch=MAX_BATCH,
                                             max_seq=SEQ, paged=True,
                                             page_size=PS)
        je.params = jax.tree.map(lambda a: a.astype(jnp.float32), je.params)
        jpar = je.params
    else:
        jpar = jax.tree.map(lambda a: a.astype(jnp.float32),
                            jl.init_params(CFG, jax.random.PRNGKey(0)))
        je = _jax_dense_engine(jpar)
    te, ttok = tsvc.build_backend_engine(
        "tiny-debug", max_batch=MAX_BATCH, max_seq=SEQ, page_size=PS,
        paged=request.param == "paged", device="cpu",
        kv_dtype=torch.float32,
        params=params_from_numpy(jax.tree.map(np.asarray, jpar),
                                 device="cpu"))
    jdb = JaxDB(broker=JaxBroker(), save_dir=str(tmp / "jax"))
    tdb = SwarmDB(broker=LocalBroker(), save_dir=str(tmp / "torch"))
    js = jsvc.ServingService(jdb, je, jtok, backend_id="b0")
    ts = tsvc.ServingService(tdb, te, ttok, backend_id="b0")
    for db in (jdb, tdb):
        db.register_agent("user")
        db.register_agent("bot")
        db.assign_llm_backend("bot", "b0")
    js.start()
    ts.start()
    yield js, ts
    for svc, db in ((js, jdb), (ts, tdb)):
        svc.stop()
        db.close()
    mp.undo()
    torch.set_num_threads(torch_threads)


def _reply(svc, content, generation, timeout=120.0):
    """Send one message to the backend's agent and return its reply's
    (body, metadata)."""
    db = svc.db
    mid = db.send_message("user", "bot", content,
                          metadata={"generation": generation})
    deadline = time.time() + timeout
    while time.time() < deadline:
        for m in db.receive_messages("user", timeout=0.2):
            if m.metadata.get("reply_to") == mid:
                return m.content, m.metadata
    raise AssertionError(f"no reply to {content!r}")


def _summary(body, meta):
    return (body, meta["finish_reason"], meta["completion_tokens"],
            [(a["text"], a["finish_reason"], a["completion_tokens"])
             for a in meta.get("alternatives", [])])


def test_n2_seeded_alternatives_equal_jax(services):
    js, ts = services
    gen = {"n": 2, "max_new_tokens": 10, "temperature": 0.9, "seed": 3}
    want = _summary(*_reply(js, "tell me one thing", gen))
    got = _summary(*_reply(ts, "tell me one thing", gen))
    assert got == want
    assert len(got[3]) == 1          # n = 2: one alternative
    assert got[3][0][0] != got[0]    # seeds 3 and 4 part ways


def test_n3_greedy_alternatives_equal_jax(services):
    """Greedy completions are copies of each other by definition."""
    js, ts = services
    gen = {"n": 3, "max_new_tokens": 8}
    want = _summary(*_reply(js, "and greedily now", gen))
    got = _summary(*_reply(ts, "and greedily now", gen))
    assert got == want
    assert [a[0] for a in got[3]] == [got[0], got[0]]


def test_stop_sequence_per_completion_equals_jax(services):
    """Each completion stops at its own first match: the stop string is
    taken from alternative 1's unstopped text, so that completion stops
    while the body runs on (or stops elsewhere)."""
    js, ts = services
    for seed in range(5, 40):
        # the first seed whose alternative shows enough text (tiny-debug
        # ids past the byte range decode to nothing); every message goes
        # to both services, so their conversations stay the same
        gen = {"n": 2, "max_new_tokens": 12, "temperature": 0.9,
               "seed": seed}
        want = _summary(*_reply(js, "stop somewhere", gen))
        assert _summary(*_reply(ts, "stop somewhere", gen)) == want
        alt = want[3][0][0]
        if len(alt) >= 5 and alt[3:5] not in alt[:4]:
            break
    stop = alt[3:5]
    gen = dict(gen, stop=[stop])
    want = _summary(*_reply(js, "stop somewhere", gen))
    got = _summary(*_reply(ts, "stop somewhere", gen))
    assert got == want
    assert got[3][0][1] == "stop" and stop not in got[3][0][0]


def _cancel_fanout(svc, msg_cls):
    """Serve an n = 3 message directly and cancel it at its first token:
    returns (reason, alternatives' reasons) of the emitted reply."""
    done = threading.Event()
    rid = {}
    fired = []

    def on_token(r, t):
        if not fired:
            fired.append(True)
            svc.cancel_request(rid["rid"])

    msg = msg_cls(sender_id="user", receiver_id="bot",
                  content="a long answer please",
                  metadata={"generation": {"n": 3, "max_new_tokens": 100}})
    got = {}

    def on_done(r, toks, reason):
        got["reason"] = reason
        done.set()

    rid["rid"] = svc.serve_message(msg, on_token=on_token, on_done=on_done)
    assert done.wait(120), "the fan-out never finished"
    reply = svc.db.get_message(msg.metadata["reply_id"])
    return (got["reason"], reply.metadata["finish_reason"],
            [a["finish_reason"] for a in reply.metadata["alternatives"]])


def test_cancel_reaches_every_member(services):
    js, ts = services
    want = _cancel_fanout(js, JaxMessage)
    got = _cancel_fanout(ts, Message)
    assert got == want == ("cancelled", "cancelled",
                           ["cancelled", "cancelled"])
    assert not ts._fanout    # the group is forgotten once emitted
