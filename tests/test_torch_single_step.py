"""PyTorch port vs JAX reference: the single-step paged decode
(``SWARMDB_CHUNKED=0``): kernel 3's plain version, the decode write, the
``forward_paged`` forward and the engine that decodes one step at a time.

Tolerances: the plain version vs the Pallas kernel (interpret mode) and
the dense reference 1e-5 absolute and relative in float32 (the online
softmax sums tile by tile); ``forward_paged`` logits 1e-4 over several
chained steps on a float32 pool (two layers of float32 matmuls summed in
another order; measured 3e-6) and 1e-3 on an int8 pool carried over from
the JAX package (measured 3e-6; each step requantizes its token's page,
and a ~1e-7 difference in a K/V value can flip one code of it). Engines:
greedy and seeded tokens equal on seeded prompts (ROADMAP.md queue 3 on
near ties).

``test_single_step_kernel_matches_plain_on_card`` needs the CUDA card: it
is marked ``cuda`` and skips elsewhere.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend.sampling import SamplingParams as JSP
from swarmdb_tpu.backend.service import build_backend_engine as jax_build
from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu.ops import layers as jly
from swarmdb_tpu.ops import paged_kv as jp
from swarmdb_tpu.ops.attention_pallas import (
    paged_decode_gqa_attention as pallas_decode)
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.backend.service import (ServingService,
                                               build_backend_engine)
from swarmdb_tpu_torch.broker.local import LocalBroker
from swarmdb_tpu_torch.core.runtime import SwarmDB
from swarmdb_tpu_torch.models import llama as tl
from swarmdb_tpu_torch.ops import attention_cuda as ac
from swarmdb_tpu_torch.ops import layers as tly
from swarmdb_tpu_torch.ops import paged_kv as tp
from swarmdb_tpu_torch.utils.convert import (params_from_numpy,
                                             pool_from_numpy)

CFG = get_config("tiny-debug")
TOL = dict(rtol=1e-5, atol=1e-5)
HKV, D, PS = 2, 16, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the other test workers' timing checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decode_case(seed, G):
    """Four slots over a 14-page pool: page-crossing lengths, a slot past
    half its table, and a slot of length 0."""
    rng = np.random.default_rng(seed)
    B, P = 4, 14
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q = f(B, HKV * G, D)
    kp, vp = f(P, PS, HKV, D), f(P, PS, HKV, D)
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 10],
                      [11, 0, 0, 0]], np.int32)
    lengths = np.array([18, 9, 31, 0], np.int32)
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("window", [None, 6])
def test_decode_plain_matches_pallas_and_reference(G, window):
    q, kp, vp, table, lengths = _decode_case(1, G)
    t = ac.paged_decode_plain(*map(torch.from_numpy, (q, kp, vp, table,
                                                      lengths)),
                              window=window).numpy()
    k = np.asarray(pallas_decode(*map(jnp.asarray, (q, kp, vp, table,
                                                    lengths)),
                                 window=window, interpret=True))
    kg, vg = jp.paged_gather_kv(jnp.asarray(kp), jnp.asarray(vp),
                                jnp.asarray(table))
    ref = np.asarray(jly.gqa_attention(
        jnp.asarray(q)[:, None], kg, vg,
        jnp.asarray(lengths - 1)[:, None], window=window))[:, 0]
    np.testing.assert_allclose(t, k, **TOL)
    live = lengths > 0
    np.testing.assert_allclose(t[live], ref[live], **TOL)
    assert not t[~live].any() and not k[~live].any()   # length 0: zeros


def test_dense_gqa_attention_matches_jax():
    """The plain core of kernels 3 and 6, with T > 1 queries."""
    rng = np.random.default_rng(2)
    B, T, S = 2, 3, 12
    q = rng.standard_normal((B, T, 4, D)).astype(np.float32)
    ck = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    cv = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    pos = np.array([[3, 4, 5], [9, 10, 11]], np.int32)
    for window in (None, 4):
        j = jly.gqa_attention(*map(jnp.asarray, (q, ck, cv, pos)),
                              window=window)
        t = tly.gqa_attention(*map(torch.from_numpy, (q, ck, cv, pos)),
                              window=window)
        np.testing.assert_allclose(np.asarray(j), t.numpy(), **TOL)


def test_paged_write_decode_plain_pool():
    """Plain pools take the token verbatim: live cells bit-identical."""
    rng = np.random.default_rng(3)
    k = rng.standard_normal((7, 4, HKV, D)).astype(np.float32)
    v = rng.standard_normal((7, 4, HKV, D)).astype(np.float32)
    tk = rng.standard_normal((3, 1, HKV, D)).astype(np.float32)
    tv = rng.standard_normal((3, 1, HKV, D)).astype(np.float32)
    pos = np.array([[5], [2], [12]], np.int32)       # slot 2 past coverage
    table = np.array([[1, 2, 0], [3, 4, 0], [5, 6, 0]], np.int32)
    jk, jv = jp.paged_write_decode(*map(jnp.asarray, (k, v, tk, tv, pos,
                                                      table)))
    ok, ov = tp.paged_write_decode(*map(torch.from_numpy,
                                        (k.copy(), v.copy(), tk, tv, pos,
                                         table)))
    np.testing.assert_array_equal(np.asarray(jk)[1:], ok.numpy()[1:])
    np.testing.assert_array_equal(np.asarray(jv)[1:], ov.numpy()[1:])


@pytest.fixture(scope="module")
def params():
    jpar = jax.tree.map(lambda a: a.astype(jnp.float32),
                        jl.init_params(CFG, jax.random.PRNGKey(3)))
    return jpar, params_from_numpy(jax.tree.map(np.asarray, jpar),
                                   device="cpu")


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_forward_paged_matches_jax(params, kind):
    """Three chained single steps over the same pool in both packages:
    each step writes its token's K/V into its page, then attends (a slot
    starting mid-page, one on a page boundary, one whose steps cross a
    page). The pools are compared after the last step."""
    jpar, tpar = params
    rng = np.random.default_rng(4)
    B, P, ps = 3, 13, 16
    shape = (CFG.n_layers, P, ps, CFG.n_kv_heads, CFG.head_dim)
    pools = [rng.standard_normal(shape).astype(np.float32) for _ in "kv"]
    if kind == "int8":
        jpools = [jp.QuantPool(*jp._quantize_pages(jnp.asarray(a)))
                  for a in pools]
        tpools = [pool_from_numpy(jax.tree.map(np.asarray, a),
                                  device="cpu") for a in jpools]
        tol = dict(atol=1e-3, rtol=1e-3)
    else:
        jpools = [jnp.asarray(a) for a in pools]
        tpools = [torch.from_numpy(a.copy()) for a in pools]
        tol = dict(atol=1e-4, rtol=1e-4)
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 10]], np.int32)
    jcache = {"k": jpools[0], "v": jpools[1],
              "page_table": jnp.asarray(table)}
    tcache = {"k": tpools[0], "v": tpools[1],
              "page_table": torch.from_numpy(table)}
    pos = np.array([[21], [16], [46]], np.int32)
    for step in range(3):
        tokens = rng.integers(3, CFG.vocab_size, (B, 1)).astype(np.int32)
        jlog, jcache = jl.forward_paged(jpar, CFG, jnp.asarray(tokens),
                                        jnp.asarray(pos + step), jcache)
        tlog, tcache = tl.forward_paged(tpar, CFG, torch.from_numpy(tokens),
                                        torch.from_numpy(pos + step),
                                        tcache)
        np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **tol)
    for key in ("k", "v"):
        if kind == "int8":
            jd = np.asarray(jcache[key].data)[:, 1:].astype(int)
            td = tcache[key].data.numpy()[:, 1:].astype(int)
            assert np.abs(jd - td).max() <= 1 and (jd != td).mean() < 1e-3
            np.testing.assert_allclose(np.asarray(jcache[key].scale)[:, 1:],
                                       tcache[key].scale.numpy()[:, 1:],
                                       rtol=1e-5)
        else:
            np.testing.assert_allclose(np.asarray(jcache[key])[:, 1:],
                                       tcache[key].numpy()[:, 1:], **tol)


def test_single_step_engine_tokens_equal_jax_engine(monkeypatch):
    """SWARMDB_CHUNKED=0 on an f32 pool: both engines admit through ragged
    prefill and decode one step at a time; greedy and seeded tokens
    equal."""
    monkeypatch.setenv("SWARMDB_KV_DTYPE", "f32")
    monkeypatch.setenv("SWARMDB_CHUNKED", "0")
    je, _ = jax_build(CFG, max_batch=4, max_seq=96, paged=True, page_size=16)
    je.params = jax.tree.map(lambda a: a.astype(jnp.float32), je.params)
    te, _ = build_backend_engine(
        "tiny-debug", max_batch=4, max_seq=96, paged=True, page_size=16,
        device="cpu", params=params_from_numpy(jax.tree.map(np.asarray, je.params),
                                 device="cpu"))
    assert te._chunked_fns is None and te.cache["k"].dtype == torch.float32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 259, n).tolist() for n in (15, 37, 1, 61)]
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


def test_message_round_trip_int8_single_step(monkeypatch, tmp_path):
    """One chat message through the port's SwarmDB + ServingService with
    both switches set (int8 pool, single-step decode)."""
    monkeypatch.setenv("SWARMDB_KV_DTYPE", "int8")
    monkeypatch.setenv("SWARMDB_CHUNKED", "0")
    db = SwarmDB(broker=LocalBroker(), save_dir=str(tmp_path))
    svc = ServingService.from_model_name(db, "tiny-debug", backend_id="b0",
                                         max_batch=2, max_seq=128,
                                         paged=True, device="cpu")
    try:
        assert tp.is_quantized(svc.engine.cache["k"])
        assert svc.engine._chunked_fns is None
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
        assert replies[0].metadata["reply_to"] == mid
        assert replies[0].metadata["finish_reason"] in ("length", "eos")
    finally:
        svc.stop()
        db.close()


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,pdt,tol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.float32, torch.bfloat16, 2e-2)])
def test_single_step_kernel_matches_plain_on_card(cuda_device, qdt, pdt,
                                                  tol):
    """Kernel 3 against its plain version on the same card tensors, the
    query and the pages each in their own dtype. With bf16 pages the plain
    version rounds the softmax weights to bf16 before the value product
    and the kernel keeps them in fp32: 2e-2 there, 1e-4 in f32."""
    for G in (1, 2):
        q, kp, vp, table, lengths = [torch.from_numpy(a).to(cuda_device)
                                     for a in _decode_case(5, G)]
        q, kp, vp = q.to(qdt), kp.to(pdt), vp.to(pdt)
        for window in (None, 6):
            got = ac.paged_decode_gqa_attention(q, kp, vp, table, lengths,
                                                window=window)
            want = ac.paged_decode_plain(q, kp, vp, table, lengths,
                                         window=window)
            torch.cuda.synchronize()
            assert got.dtype == qdt
            assert (got.float() - want.float()).abs().max().item() <= tol
