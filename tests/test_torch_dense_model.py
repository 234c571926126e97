"""PyTorch port vs JAX reference: the dense slot cache's building blocks
(``write_kv_cache``, the chunk merge, ``compose_prefix_lane``,
``gqa_attention_prefix``) and the dense engine's Llama forwards
(``forward``, ``forward_chunked`` + ``merge_chunk``,
``forward_prefix_pages``, ``forward_prefix_lane``), on the same weights
(``params_from_numpy``) and the same caches (``kv_cache_from_numpy``).

tiny-debug in float32 on the CPU (the port's decode attentions run their
plain versions there, the JAX package its einsum forms). Tolerances: the
writes, merges and lane compositions move values, so they are exact;
attention 1e-5 (one softmax each, summed in another order); logits and
K/V 1e-4 absolute and relative (two layers of float32 matmuls summed in
another order). An int8 pool read by ``forward_prefix_pages`` dequantizes
the same codes on both sides: 1e-4 too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu.ops import layers as jly
from swarmdb_tpu.ops import paged_kv as jp
from swarmdb_tpu_torch.models import llama as tl
from swarmdb_tpu_torch.ops import layers as tly
from swarmdb_tpu_torch.utils.convert import (kv_cache_from_numpy,
                                             params_from_numpy,
                                             pool_from_numpy)

CFG = get_config("tiny-debug")
TOL = dict(rtol=1e-4, atol=1e-4)
HKV, D = 2, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the other test workers' timing checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jpar = jax.tree.map(lambda a: a.astype(jnp.float32),
                        jl.init_params(CFG, jax.random.PRNGKey(3)))
    return jpar, params_from_numpy(jax.tree.map(np.asarray, jpar),
                                   device="cpu")


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------ the blocks


@pytest.mark.parametrize("T", [1, 3, 12])
def test_write_kv_cache_matches_jax(T):
    """T == 1 (a row past the lane writes nothing), a general T, and T ==
    S (the fresh K/V come back; the caches are not touched)."""
    rng = np.random.default_rng(1)
    B, S = 3, 12
    ck, cv = _f32(rng, B, S, HKV, D), _f32(rng, B, S, HKV, D)
    k, v = _f32(rng, B, T, HKV, D), _f32(rng, B, T, HKV, D)
    if T == 1:
        pos = np.array([[4], [0], [S + 2]], np.int32)
    else:
        pos = np.stack([np.arange(T) + o for o in (0, 2, S - T)]).astype(
            np.int32)
    jk, jv = jly.write_kv_cache(*map(jnp.asarray, (ck, cv, k, v, pos)))
    tck, tcv = _t(ck), _t(cv)
    tk, tv = tly.write_kv_cache(tck, tcv, _t(k), _t(v), _t(pos))
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    if T == S:
        np.testing.assert_array_equal(tck.numpy(), ck)   # untouched
    else:
        assert tk is tck and tv is tcv                   # written in place


@pytest.mark.parametrize("merge", ["merge_chunk_kv", "merge_chunk_kv_scatter"])
def test_merge_chunk_matches_both_jax_forms(merge):
    """Starts inside the lane, at 0, and one whose chunk overshoots S (its
    columns past the lane dropped); the port's merge against the JAX
    package's einsum and scatter forms."""
    rng = np.random.default_rng(2)
    L, B, S, Kc = 2, 4, 20, 6
    ck, cv = _f32(rng, L, B, S, HKV, D), _f32(rng, L, B, S, HKV, D)
    hk, hv = _f32(rng, L, B, Kc, HKV, D), _f32(rng, L, B, Kc, HKV, D)
    starts = np.array([5, 0, S - 2, S - Kc], np.int32)
    args = tuple(map(jnp.asarray, (ck, cv, hk, hv, starts)))
    tk, tv = getattr(tly, merge)(_t(ck), _t(cv), _t(hk), _t(hv),
                                 _t(starts))
    for form in (jly.merge_chunk_kv, jly.merge_chunk_kv_scatter):
        jk, jv = form(*args)
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("lane_pages", [3, 6])
def test_compose_prefix_lane_matches_jax(lane_pages):
    """Rows with 0, a page-aligned and a mid-page prefix; the lane shorter
    and longer than the gathered prefix."""
    rng = np.random.default_rng(3)
    L, P, ps, Bp, PP, T = 2, 9, 4, 3, 3, 7
    pk, pv = _f32(rng, L, P, ps, HKV, D), _f32(rng, L, P, ps, HKV, D)
    sk, sv = _f32(rng, L, Bp, T, HKV, D), _f32(rng, L, Bp, T, HKV, D)
    table = np.array([[0, 0, 0], [3, 5, 0], [7, 1, 2]], np.int32)
    plens = np.array([0, 8, 10], np.int32)
    jk, jv = jly.compose_prefix_lane(
        *map(jnp.asarray, (pk, pv, table, plens, sk, sv)), lane_pages)
    tk, tv = tly.compose_prefix_lane(
        *map(_t, (pk, pv, table, plens, sk, sv)), lane_pages)
    assert tk.shape == (L, Bp, lane_pages * ps, HKV, D)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("window", [None, 6])
def test_gqa_attention_prefix_matches_jax(window):
    rng = np.random.default_rng(4)
    B, T, Pt, Hq = 3, 5, 12, 4
    q = _f32(rng, B, T, Hq, D)
    pk, pv = _f32(rng, B, Pt, HKV, D), _f32(rng, B, Pt, HKV, D)
    sk, sv = _f32(rng, B, T, HKV, D), _f32(rng, B, T, HKV, D)
    plens = np.array([0, 7, 12], np.int32)
    args = (q, pk, pv, sk, sv, plens)
    j = jly.gqa_attention_prefix(*map(jnp.asarray, args), window=window)
    t = tly.gqa_attention_prefix(*map(_t, args), window=window)
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_kv_cache_from_numpy_keeps_a_pair():
    """A dense (k, v) cache crosses over as two tensors of its own dtype
    (``pool_from_numpy`` would read the pair as int8 data + scales)."""
    rng = np.random.default_rng(5)
    k, v = _f32(rng, 2, 3, 4, HKV, D), _f32(rng, 2, 3, 4, HKV, D)
    tk, tv = kv_cache_from_numpy(jax.tree.map(np.asarray, (k, v)),
                                 device="cpu")
    assert tk.dtype == tv.dtype == torch.float32
    np.testing.assert_array_equal(tk.numpy(), k)
    np.testing.assert_array_equal(tv.numpy(), v)
    bf = kv_cache_from_numpy((jnp.asarray(k, jnp.bfloat16),
                              jnp.asarray(v, jnp.bfloat16)), device="cpu")
    assert bf[0].dtype == torch.bfloat16


# --------------------------------------------------------- the forwards


def test_forward_prefill_then_decode_steps(params):
    """A [B, T] prefill with ``logits_at`` into a temp cache, its insert
    into the slot cache, then three T == 1 steps that write the cache
    before attending: logits within 1e-4, caches compared."""
    jpar, tpar = params
    rng = np.random.default_rng(6)
    B, T, S = 3, 16, 48
    tokens = rng.integers(3, CFG.vocab_size, (B, T)).astype(np.int32)
    lengths = np.array([16, 9, 4], np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jtmp = jl.init_kv_cache(CFG, B, T, jnp.float32)
    ttmp = tl.init_kv_cache(CFG, B, T, torch.float32, device="cpu")
    assert ttmp[0].shape == jtmp[0].shape
    jlog, jtmp = jl.forward(jpar, CFG, jnp.asarray(tokens), jnp.asarray(pos),
                            jtmp, logits_at=jnp.asarray(lengths - 1))
    tlog, ttmp = tl.forward(tpar, CFG, _t(tokens), _t(pos), ttmp,
                            logits_at=_t(lengths - 1))
    assert tlog.shape == (B, CFG.vocab_size)
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
    for a, b in zip(jtmp, ttmp):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)
    # the slot cache holds garbage past each prompt, never read
    garbage = [_f32(rng, CFG.n_layers, B, S, CFG.n_kv_heads, CFG.head_dim)
               for _ in "kv"]
    jcache = tuple(jnp.asarray(g).at[:, :, :T].set(c)
                   for g, c in zip(garbage, jtmp))
    tcache = kv_cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                 device="cpu")
    cur = lengths.copy()
    for step in range(3):
        tok = rng.integers(3, CFG.vocab_size, (B, 1)).astype(np.int32)
        p = cur[:, None].astype(np.int32)
        jlog, jcache = jl.forward(jpar, CFG, jnp.asarray(tok),
                                  jnp.asarray(p), jcache)
        tlog, tcache = tl.forward(tpar, CFG, _t(tok), _t(p), tcache)
        assert tlog.shape == (B, 1, CFG.vocab_size)
        np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
        cur += 1
    for a, b in zip(jcache, tcache):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)


@pytest.mark.parametrize("merge", ["merge_chunk", "merge_chunk_scatter"])
def test_forward_chunked_steps_and_merge(params, merge):
    """K chunked steps over a frozen slot cache (garbage past each slot's
    start, one chunk overshooting the lane), then the merge."""
    jpar, tpar = params
    rng = np.random.default_rng(7)
    B, S, Kc = 3, 40, 4
    shape = (CFG.n_layers, B, S, CFG.n_kv_heads, CFG.head_dim)
    cache = (_f32(rng, *shape), _f32(rng, *shape))
    jcache = tuple(map(jnp.asarray, cache))
    tcache = kv_cache_from_numpy(cache, device="cpu")
    starts = np.array([9, 0, S - 2], np.int32)
    jchunk = jl.init_chunk_kv(CFG, B, Kc, jnp.float32)
    tchunk = tl.init_chunk_kv(CFG, B, Kc, torch.float32, device="cpu")
    for step in range(Kc):
        tok = rng.integers(3, CFG.vocab_size, (B, 1)).astype(np.int32)
        p = (starts + step)[:, None].astype(np.int32)
        jlog, jchunk = jl.forward_chunked(jpar, CFG, jnp.asarray(tok),
                                          jnp.asarray(p), jcache, jchunk,
                                          jnp.int32(step))
        tlog, tchunk = tl.forward_chunked(tpar, CFG, _t(tok), _t(p), tcache,
                                          tchunk, step)
        np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
    for a, b in zip(jchunk, tchunk):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)
    jm = getattr(jl, merge)(jcache, jchunk, jnp.asarray(starts))
    tm = getattr(tl, merge)(tcache, tchunk, _t(starts))
    assert tm is tcache                                   # in place
    for a, b in zip(jm, tm):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)


def _prefix_case(rng, T=12):
    Bp, P, ps = 3, 11, 16
    tokens = rng.integers(3, CFG.vocab_size, (Bp, T)).astype(np.int32)
    table = np.array([[0, 0], [4, 0], [7, 2]], np.int32)
    plens = np.array([0, 16, 27], np.int32)
    lengths = np.array([12, 5, 9], np.int32)
    shape = (CFG.n_layers, P, ps, CFG.n_kv_heads, CFG.head_dim)
    return tokens, table, plens, lengths, [_f32(rng, *shape) for _ in "kv"]


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_forward_prefix_pages_matches_jax(params, kind):
    """The suffix-only prefill over reused prefix pages (no prefix, a
    whole page, a mid-page prefix), over an f32 pool and an int8 one."""
    jpar, tpar = params
    tokens, table, plens, lengths, pools = _prefix_case(
        np.random.default_rng(8))
    if kind == "int8":
        jpools = [jp.QuantPool(*jp._quantize_pages(jnp.asarray(a)))
                  for a in pools]
        tpools = [pool_from_numpy(jax.tree.map(np.asarray, a), device="cpu")
                  for a in jpools]
    else:
        jpools = [jnp.asarray(a) for a in pools]
        tpools = [_t(a) for a in pools]
    jlog, jk, jv = jl.forward_prefix_pages(
        jpar, CFG, jnp.asarray(tokens), jnp.asarray(table),
        jnp.asarray(plens), *jpools, logits_at=jnp.asarray(lengths - 1))
    tlog, tk, tv = tl.forward_prefix_pages(
        tpar, CFG, _t(tokens), _t(table), _t(plens), *tpools,
        logits_at=_t(lengths - 1))
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jk), tk.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), **TOL)


def test_forward_prefix_lane_matches_jax(params):
    """The dense prefix prefill: logits at each row's last token and the
    composed lanes (prefix pages, then the suffix at its positions)."""
    jpar, tpar = params
    tokens, table, plens, lengths, pools = _prefix_case(
        np.random.default_rng(9))
    lane_pages = 3
    jlog, jk, jv = jl.forward_prefix_lane(
        jpar, CFG, jnp.asarray(tokens), jnp.asarray(table),
        jnp.asarray(plens), *map(jnp.asarray, pools), lane_pages,
        logits_at=jnp.asarray(lengths - 1))
    tlog, tk, tv = tl.forward_prefix_lane(
        tpar, CFG, _t(tokens), _t(table), _t(plens), *map(_t, pools),
        lane_pages, logits_at=_t(lengths - 1))
    assert tlog.shape == (3, CFG.vocab_size)
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jk), tk.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), **TOL)
