"""PyTorch port vs JAX reference: the Mixtral family (top-k routed MoE).

The same numpy-seeded inputs and the JAX package's weights (carried over
by ``params_from_numpy``) go through ``swarmdb_tpu.models.mixtral`` and
``swarmdb_tpu_torch.models.mixtral`` on the CPU, in float32 (the JAX
package runs its dense attention references there; the port its plain
versions). Tolerances: the MoE block 1e-5 (output and expert load); the
forwards 1e-4 on logits and K/V (two layers of float32 matmuls summed in
another order); int8 pages within the bounds of tests/test_torch_kv_quant.py
(codes +-1 on a rounding tie, scales rtol 1e-6); the engines' greedy
tokens equal.

Routing must match exactly: a different token dropped gives a different
reply. ``MOE8`` (tiny-moe with 8 experts, as Mixtral-8x7B has) makes the
capacity bind at the default factor (C = N / 2 with top-2 of 8), where
tiny-moe's 4 experts never drop a token (C = N); the forwards and the
"binding" engine cases run it. There the idle decode slots' garbage rows
compete for capacity, so the loop decides the tokens: the binding case
here holds both packages at the per-chunk path without pipelining
(``SWARMDB_EMIT_RING=0``, ``SWARMDB_PIPELINE=1``), and
``tests/test_torch_decode_loop_{dense,paged}.py`` hold them at both
packages' defaults too (the resident sessions and two chunks in flight,
which decode idle and retired rows at other positions).
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend.engine import Engine as JaxEngine
from swarmdb_tpu.backend.sampling import SamplingParams as JSP
from swarmdb_tpu.backend.service import build_backend_engine as jax_build
from swarmdb_tpu.backend.tokenizer import default_tokenizer
from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models import mixtral as jm
from swarmdb_tpu.models.configs import get_config as jcfg
from swarmdb_tpu.ops import paged_kv as jp
from swarmdb_tpu_torch.backend.engine import GenRequest
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.backend.service import (ServingService,
                                               build_backend_engine)
from swarmdb_tpu_torch.broker.local import LocalBroker
from swarmdb_tpu_torch.core.messages import MessageType
from swarmdb_tpu_torch.core.runtime import SwarmDB
from swarmdb_tpu_torch.models import mixtral as tm
from swarmdb_tpu_torch.models.configs import get_config as tcfg
from swarmdb_tpu_torch.ops import paged_kv as tp
from swarmdb_tpu_torch.utils.convert import params_from_numpy, pool_from_numpy

JCFG, TCFG = jcfg("tiny-moe"), tcfg("tiny-moe")
JMOE8, TMOE8 = jcfg("tiny-moe", n_experts=8), tcfg("tiny-moe", n_experts=8)
TOL = dict(rtol=1e-4, atol=1e-4)
SEQ, PS = 96, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the other test workers' timing checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _weights(cfg, seed):
    jpar = jax.tree.map(lambda a: a.astype(jnp.float32),
                        jm.init_params(cfg, jax.random.PRNGKey(seed)))
    return jpar, params_from_numpy(jax.tree.map(np.asarray, jpar),
                                   device="cpu")


@pytest.fixture(scope="module")
def moe8():
    return _weights(JMOE8, 3)


# ---------------------------------------------------------------- the block


def _block_inputs(seed, B=3, T=20, D=16, E=8, F=24):
    rng = np.random.default_rng(seed)
    return (_f32(rng, B, T, D), _f32(rng, D, E), _f32(rng, E, D, F, scale=.2),
            _f32(rng, E, D, F, scale=.2), _f32(rng, E, F, D, scale=.2))


def _drops(x, router, top_k, cf):
    """Choices over capacity in one block call (counted from the router)."""
    xf = x.reshape(-1, x.shape[-1]).float()
    E = router.shape[-1]
    C = max(1, int(xf.shape[0] * top_k * cf / E))
    idx = torch.topk(xf @ router.float(), top_k, dim=-1).indices
    counts = torch.bincount(idx.reshape(-1), minlength=E)
    return int(torch.clamp(counts - C, min=0).sum())


@pytest.mark.parametrize("cf", [0.5, 2.0])
@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_moe_block_matches_jax(dispatch, cf):
    """Both dispatch forms, with tokens dropped (cf 0.5) and at the
    default factor: output and expert load within 1e-5."""
    args = _block_inputs(1)
    jy, jload = jm.moe_block(*map(jnp.asarray, args), top_k=2,
                             capacity_factor=cf, dispatch=dispatch)
    ty, tload = tm.moe_block(*map(_t, args), top_k=2, capacity_factor=cf,
                             dispatch=dispatch)
    assert ty.shape == args[0].shape and ty.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(jload), tload.numpy(), rtol=1e-5,
                               atol=1e-5)
    if cf < 1:
        assert _drops(_t(args[0]), _t(args[1]), 2, cf) > 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_moe_block_forms_agree(monkeypatch, dtype, tol):
    """Scatter and einsum make the same routing decisions and give the
    same values (bf16: the einsum form sums its one-hot products in
    another order); ``SWARMDB_MOE_DISPATCH`` picks the form when the
    caller names none, scatter by default."""
    args = [a.to(dtype) for a in map(_t, _block_inputs(2))]
    ys, ls = tm.moe_block(*args, top_k=2, capacity_factor=0.75,
                          dispatch="scatter")
    ye, le = tm.moe_block(*args, top_k=2, capacity_factor=0.75,
                          dispatch="einsum")
    assert _drops(args[0], args[1], 2, 0.75) > 0
    torch.testing.assert_close(ys.float(), ye.float(), rtol=tol, atol=tol)
    assert torch.equal(ls, le)
    monkeypatch.delenv("SWARMDB_MOE_DISPATCH", raising=False)
    assert tm._default_dispatch() == "scatter"
    monkeypatch.setenv("SWARMDB_MOE_DISPATCH", "einsum")
    y_env, _ = tm.moe_block(*args, top_k=2, capacity_factor=0.75)
    assert torch.equal(y_env, ye)
    with pytest.raises(ValueError, match="dispatch"):
        tm.moe_block(*args, top_k=2, dispatch="dense")


# ------------------------------------------------------------ params & init


def test_init_params_layout_matches_jax():
    jpar = jm.init_params(JCFG, jax.random.PRNGKey(0))
    tpar = tm.init_params(TCFG, seed=0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jpar)[0]
    flat_t = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(tpar)[0]}
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        t = flat_t[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16
    again = tm.init_params(TCFG, seed=0, device="cpu")
    assert torch.equal(tpar["layers"]["w_down"], again["layers"]["w_down"])
    with pytest.raises(ValueError, match="dense"):
        tm.init_params(tcfg("tiny-debug"), device="cpu")


def test_params_from_numpy_carries_the_moe_keys():
    """The router and the [L, E, ...] expert stacks cross over with their
    shapes, dtypes (bf16 stays bf16) and values."""
    jpar = jm.init_params(JCFG, jax.random.PRNGKey(1))
    tpar = params_from_numpy(jax.tree.map(np.asarray, jpar), device="cpu")
    L, E = JCFG.n_layers, JCFG.n_experts
    for key, shape in (("router", (L, JCFG.dim, E)),
                       ("w_gate", (L, E, JCFG.dim, JCFG.ffn_dim)),
                       ("w_up", (L, E, JCFG.dim, JCFG.ffn_dim)),
                       ("w_down", (L, E, JCFG.ffn_dim, JCFG.dim))):
        t = tpar["layers"][key]
        assert tuple(t.shape) == shape and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            np.asarray(jpar["layers"][key]).astype(np.float32),
            t.float().numpy())


# ------------------------------------------------------------- the forwards


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_forward_prefill_then_decode_steps(moe8, dispatch):
    """A [B, T] prefill with ``logits_at`` into a temp cache (its padding
    rows take capacity), then three T == 1 steps over a slot cache."""
    jpar, tpar = moe8
    rng = np.random.default_rng(6)
    B, T, S = 3, 16, 48
    tokens = rng.integers(3, JMOE8.vocab_size, (B, T)).astype(np.int32)
    tokens[2, 4:] = 0                                     # a padded row
    lengths = np.array([16, 9, 4], np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jlog, jtmp = jm.forward(
        jpar, JMOE8, jnp.asarray(tokens), jnp.asarray(pos),
        jm.init_kv_cache(JMOE8, B, T, jnp.float32),
        logits_at=jnp.asarray(lengths - 1), moe_dispatch=dispatch)
    tlog, ttmp = tm.forward(
        tpar, TMOE8, _t(tokens), _t(pos),
        tm.init_kv_cache(TMOE8, B, T, torch.float32, device="cpu"),
        logits_at=_t(lengths - 1), moe_dispatch=dispatch)
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
    for a, b in zip(jtmp, ttmp):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)
    shape = (JMOE8.n_layers, B, S, JMOE8.n_kv_heads, JMOE8.head_dim)
    cache = (_f32(rng, *shape), _f32(rng, *shape))
    jcache = tuple(map(jnp.asarray, cache))
    tcache = tuple(_t(c.copy()) for c in cache)
    cur = lengths.copy()
    for _ in range(3):
        tok = rng.integers(3, JMOE8.vocab_size, (B, 1)).astype(np.int32)
        p = cur[:, None].astype(np.int32)
        jlog, jcache = jm.forward(jpar, JMOE8, jnp.asarray(tok),
                                  jnp.asarray(p), jcache,
                                  moe_dispatch=dispatch)
        tlog, tcache = tm.forward(tpar, TMOE8, _t(tok), _t(p), tcache,
                                  moe_dispatch=dispatch)
        np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
        cur += 1
    for a, b in zip(jcache, tcache):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)


def test_forward_chunked_steps_and_merge(moe8):
    jpar, tpar = moe8
    rng = np.random.default_rng(7)
    B, S, Kc = 4, 40, 4
    shape = (JMOE8.n_layers, B, S, JMOE8.n_kv_heads, JMOE8.head_dim)
    cache = (_f32(rng, *shape), _f32(rng, *shape))
    jcache = tuple(map(jnp.asarray, cache))
    tcache = tuple(_t(c.copy()) for c in cache)
    starts = np.array([9, 0, S - 2, 0], np.int32)
    jchunk = jm.init_chunk_kv(JMOE8, B, Kc, jnp.float32)
    tchunk = tm.init_chunk_kv(TMOE8, B, Kc, torch.float32, device="cpu")
    for step in range(Kc):
        tok = rng.integers(3, JMOE8.vocab_size, (B, 1)).astype(np.int32)
        p = (starts + step)[:, None].astype(np.int32)
        jlog, jchunk = jm.forward_chunked(jpar, JMOE8, jnp.asarray(tok),
                                          jnp.asarray(p), jcache, jchunk,
                                          jnp.int32(step))
        tlog, tchunk = tm.forward_chunked(tpar, TMOE8, _t(tok), _t(p),
                                          tcache, tchunk, step)
        np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
    jmerged = jm.merge_chunk(jcache, jchunk, jnp.asarray(starts))
    tmerged = tm.merge_chunk(tcache, tchunk, _t(starts))
    for a, b in zip(jmerged, tmerged):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)


def _pools(kind, seed, P=13):
    """One seeded (k, v) page pool pair in both packages: f32, or int8
    (the JAX package's quantizer, carried over)."""
    rng = np.random.default_rng(seed)
    shape = (JMOE8.n_layers, P, PS, JMOE8.n_kv_heads, JMOE8.head_dim)
    vals = [_f32(rng, *shape) for _ in "kv"]
    if kind == "int8":
        jpools = [jp.QuantPool(*jp._quantize_pages(jnp.asarray(a)))
                  for a in vals]
        return jpools, [pool_from_numpy(jax.tree.map(np.asarray, a),
                                        device="cpu") for a in jpools]
    return [jnp.asarray(a) for a in vals], [_t(a.copy()) for a in vals]


def _prefix_case(rng, T=12):
    tokens = rng.integers(3, JMOE8.vocab_size, (3, T)).astype(np.int32)
    table = np.array([[0, 0], [4, 0], [7, 2]], np.int32)
    plens = np.array([0, 16, 27], np.int32)
    lengths = np.array([12, 5, 9], np.int32)
    return tokens, table, plens, lengths


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_forward_prefix_pages_matches_jax(moe8, kind):
    """The suffix-only prefill over reused pages (no prefix, a whole page,
    a mid-page prefix), over an f32 pool and an int8 one."""
    jpar, tpar = moe8
    tokens, table, plens, lengths = _prefix_case(np.random.default_rng(8))
    jpools, tpools = _pools(kind, 9)
    jlog, jk, jv = jm.forward_prefix_pages(
        jpar, JMOE8, jnp.asarray(tokens), jnp.asarray(table),
        jnp.asarray(plens), *jpools, logits_at=jnp.asarray(lengths - 1))
    tlog, tk, tv = tm.forward_prefix_pages(
        tpar, TMOE8, _t(tokens), _t(table), _t(plens), *tpools,
        logits_at=_t(lengths - 1))
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jk), tk.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), **TOL)


def test_forward_prefix_lane_matches_jax(moe8):
    jpar, tpar = moe8
    tokens, table, plens, lengths = _prefix_case(np.random.default_rng(10))
    jpools, tpools = _pools("f32", 11)
    jlog, jk, jv = jm.forward_prefix_lane(
        jpar, JMOE8, jnp.asarray(tokens), jnp.asarray(table),
        jnp.asarray(plens), *jpools, 3, logits_at=jnp.asarray(lengths - 1))
    tlog, tk, tv = tm.forward_prefix_lane(
        tpar, TMOE8, _t(tokens), _t(table), _t(plens), *tpools, 3,
        logits_at=_t(lengths - 1))
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jk), tk.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), **TOL)


def _paged_case(rng, idle_pos=0):
    """Three live slots and an idle one (its table row zeroed, its
    position counting up from 0 within the chunk, as the engine's)."""
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 10],
                      [0, 0, 0, 0]], np.int32)
    positions = np.array([[21], [9], [40], [idle_pos]], np.int32)
    tokens = rng.integers(3, JMOE8.vocab_size, (4, 1)).astype(np.int32)
    return table, positions, tokens


def _assert_pools(jpool, tpool):
    """Pools equal past trash page 0 (which takes duplicate writes in
    either order): f32 within 1e-4; int8 codes within one (on a rounding
    tie) in under 0.1% of the cells, scales rtol 1e-5."""
    if isinstance(jpool, jp.QuantPool):
        jd, td = np.asarray(jpool.data)[:, 1:], tpool.data.numpy()[:, 1:]
        assert np.abs(jd.astype(int) - td.astype(int)).max() <= 1
        assert (jd != td).mean() < 1e-3
        np.testing.assert_allclose(np.asarray(jpool.scale)[:, 1:],
                                   tpool.scale.numpy()[:, 1:], rtol=1e-5)
    else:
        np.testing.assert_allclose(np.asarray(jpool)[:, 1:],
                                   tpool.numpy()[:, 1:], **TOL)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_forward_paged_chunked_and_merge(moe8, kind):
    """Chunked decode steps over a frozen pool (kernel 2 / 5 on the card)
    with an idle slot whose row takes capacity, then the merge."""
    jpar, tpar = moe8
    rng = np.random.default_rng(12)
    Kc, step = 4, 2
    table, positions, tokens = _paged_case(rng, idle_pos=step)
    (jk, jv), (tk, tv) = _pools(kind, 13)
    shape = (JMOE8.n_layers, 4, Kc, JMOE8.n_kv_heads, JMOE8.head_dim)
    hk, hv = _f32(rng, *shape), _f32(rng, *shape)
    jcache = {"k": jk, "v": jv, "page_table": jnp.asarray(table)}
    tcache = {"k": tk, "v": tv, "page_table": _t(table)}
    jlog, jchunk = jm.forward_paged_chunked(
        jpar, JMOE8, jnp.asarray(tokens), jnp.asarray(positions), jcache,
        (jnp.asarray(hk), jnp.asarray(hv)), jnp.int32(step))
    tlog, tchunk = tm.forward_paged_chunked(
        tpar, TMOE8, _t(tokens), _t(positions), tcache,
        (_t(hk.copy()), _t(hv.copy())), step)
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
    starts = positions[:, 0] - step
    jmerged = jm.merge_paged_chunk(jcache, jchunk, jnp.asarray(starts))
    tmerged = tm.merge_paged_chunk(tcache, tchunk, _t(starts))
    for key in ("k", "v"):
        _assert_pools(jmerged[key], tmerged[key])


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_forward_paged_single_steps(moe8, kind):
    """Three single decode steps that write the pool before attending
    (kernel 3 / 6 on the card); the idle slot writes trash page 0."""
    jpar, tpar = moe8
    rng = np.random.default_rng(14)
    table, positions, _ = _paged_case(rng)
    (jk, jv), (tk, tv) = _pools(kind, 15)
    jcache = {"k": jk, "v": jv, "page_table": jnp.asarray(table)}
    tcache = {"k": tk, "v": tv, "page_table": _t(table)}
    for s in range(3):
        tok = rng.integers(3, JMOE8.vocab_size, (4, 1)).astype(np.int32)
        p = positions + s
        jlog, jcache = jm.forward_paged(jpar, JMOE8, jnp.asarray(tok),
                                        jnp.asarray(p), jcache)
        tlog, tcache = tm.forward_paged(tpar, TMOE8, _t(tok), _t(p), tcache)
        live = slice(0, 3)   # the idle row reads trash page 0
        np.testing.assert_allclose(np.asarray(jlog)[live],
                                   tlog.numpy()[live], **TOL)
    for key in ("k", "v"):
        _assert_pools(jcache[key], tcache[key])


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_pool_insert_pages_matches_jax(kind):
    """The bucketed prefills' whole-page insert: plain pools take the
    values; int8 pools the exact quantization of the fresh pages (no
    survivor requant), trash page 0 repeated."""
    rng = np.random.default_rng(16)
    (jk, _), (tk, _) = _pools(kind, 17)
    pages = _f32(rng, JMOE8.n_layers, 5, PS, JMOE8.n_kv_heads,
                 JMOE8.head_dim, scale=3.0)
    ids = np.array([4, 0, 9, 2, 0], np.int32)
    jout = jp.pool_insert_pages(jk, jnp.asarray(ids), jnp.asarray(pages))
    tout = tp.pool_insert_pages(tk, _t(ids), _t(pages))
    assert tout is tk                                     # in place
    _assert_pools(jout, tout)


# ---------------------------------------------------------------- engines


def _jax_dense_engine(cfg, params, chunked, pipeline_depth=2):
    """The JAX package's dense engine as its ``build_backend_engine``
    wires it, with a float32 slot cache and side pool."""
    tok = default_tokenizer(cfg.vocab_size)
    chunked_fns = None
    if chunked:
        chunked_fns = (
            lambda p, t, pos, c, hkv, s: jm.forward_chunked(p, cfg, t, pos,
                                                            c, hkv, s),
            lambda b, k: jm.init_chunk_kv(cfg, b, k),
            jm.merge_chunk)
    return JaxEngine(
        lambda p, t, pos, c: jm.forward(p, cfg, t, pos, c),
        lambda b, s: jm.init_kv_cache(cfg, b, s, jnp.float32),
        params, max_batch=4, max_seq=SEQ, eos_id=tok.eos_id,
        pad_id=tok.pad_id, seed=0, decode_chunk=8, chunked_fns=chunked_fns,
        prefix_fns=(
            lambda p, t, tab, pl, pk, pv, lp, logits_at=None:
                jm.forward_prefix_lane(p, cfg, t, tab, pl, pk, pv, lp,
                                       logits_at=logits_at),
            lambda n, ps: jl.init_prefix_pool(cfg, n, ps, jnp.float32)),
        prefix_pages=1 + -(-(4 * SEQ // 2) // PS), prefix_page_size=PS,
        pipeline_depth=pipeline_depth,
        forward_last_fn=lambda p, t, pos, c, at: jm.forward(
            p, cfg, t, pos, c, logits_at=at))


def _engines(monkeypatch, cfg_pair, paged, chunked, kv="f32", seed=0,
             per_chunk=False):
    """The JAX package's engine and the port's on the same float32
    weights. Paged: ``jax_build`` with a float32 temp prefill cache over
    an f32 pool (the port's temp cache is in the pool's logical dtype; the
    JAX package's always bf16). ``per_chunk``: the JAX engine without its
    resident loop and pipelining."""
    jcfg_, tcfg_ = cfg_pair
    monkeypatch.setenv("SWARMDB_CHUNKED", "1" if chunked else "0")
    monkeypatch.setenv("SWARMDB_KV_DTYPE", kv)
    if per_chunk:
        monkeypatch.setenv("SWARMDB_EMIT_RING", "0")
        monkeypatch.setenv("SWARMDB_PIPELINE", "1")
    if paged:
        je, _ = jax_build(jcfg_, max_batch=4, max_seq=SEQ, paged=True,
                          page_size=PS, seed=seed)
        je.params = jax.tree.map(lambda a: a.astype(jnp.float32), je.params)
        if kv == "f32":
            je._prefill_cache_fn = (
                lambda b, s: jm.init_kv_cache(jcfg_, b, s, jnp.float32))
        jpar = je.params
    else:
        jpar = _weights(jcfg_, seed)[0]
        je = _jax_dense_engine(jcfg_, jpar, chunked,
                               1 if per_chunk else 2)
    te, _ = build_backend_engine(
        tcfg_, max_batch=4, max_seq=SEQ, paged=paged, page_size=PS,
        device="cpu", kv_dtype=None if paged else torch.float32,
        params=params_from_numpy(jax.tree.map(np.asarray, jpar),
                                 device="cpu"))
    assert (te.paged is None) == (not paged)
    assert (te._chunked_fns is None) == (not chunked)
    return je, te


def _prompts(seed, lengths=(15, 37, 61)):
    rng = np.random.default_rng(seed)
    out = [rng.integers(3, 259, n).tolist() for n in lengths]
    out.append(out[1] + rng.integers(3, 259, 10).tolist())  # a prefix hit
    return out


@pytest.mark.parametrize("chunked", [True, False],
                         ids=["chunked", "single_step"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_tokens_equal_jax_engine(monkeypatch, paged, chunked):
    """tiny-moe through both engines, chunked and single-step, over
    float32 caches: greedy and seeded tokens equal the JAX package's. The
    paged engine prefills in row-bucketed and prefix waves (tiny-moe has
    no ragged forward) and a repeat reads its prefix back."""
    je, te = _engines(monkeypatch, (JCFG, TCFG), paged, chunked)
    if paged:
        assert not te._ragged and te._row_buckets == je._row_buckets
    je.start()
    te.start()
    try:
        for p in _prompts(0):
            for sp in (dict(max_new_tokens=10),
                       dict(max_new_tokens=10, temperature=0.9, top_p=0.9,
                            seed=7)):
                assert je.generate_sync(p, JSP(**sp)) == \
                    te.generate_sync(p, TSP(**sp)), (len(p), sp)
    finally:
        je.stop()
        te.stop()
    c = te.metrics.counters
    assert c["prefix_reused_tokens"].value > 0
    assert c["prefill_waves"].value > 0


@pytest.mark.parametrize("chunked", [True, False],
                         ids=["chunked", "single_step"])
def test_int8_engine_tokens_equal_jax_engine(monkeypatch, chunked):
    """tiny-moe over an int8 pool: the row-bucketed and prefix waves
    quantize whole pages exactly (``pool_insert_pages``), decode writes
    requantize; greedy tokens equal the JAX package's."""
    je, te = _engines(monkeypatch, (JCFG, TCFG), True, chunked, kv="int8")
    assert tp.is_quantized(te.cache["k"]) and jp.is_quantized(je.cache["k"])
    je.start()
    te.start()
    try:
        for p in _prompts(1):
            assert je.generate_sync(p, JSP(max_new_tokens=10)) == \
                te.generate_sync(p, TSP(max_new_tokens=10)), len(p)
    finally:
        je.stop()
        te.stop()
    assert te.metrics.counters["prefix_reused_tokens"].value > 0


def _run_together(engine, make_req, prompts, news):
    """Submit every request before the loop starts (one admission round
    in both packages) and wait for all of them."""
    done = {}
    ids = [engine.submit(make_req(p, n, done)) for p, n in zip(prompts, news)]
    engine.start()
    try:
        deadline = time.time() + 120
        while len(done) < len(ids) and time.time() < deadline:
            time.sleep(0.02)
    finally:
        engine.stop()
    return [done.get(i) for i in ids]


@pytest.mark.parametrize("paged,chunked", [(False, True), (False, False),
                                           (True, True)],
                         ids=["dense_chunked", "dense_single_step",
                              "paged_chunked"])
def test_binding_capacity_tokens_equal_jax_engine(monkeypatch, paged,
                                                   chunked):
    """8 experts (C = N / 2): two requests admitted in one round, one
    retiring early, two slots idle throughout. Prefill padding and the
    idle slots' rows take capacity and tokens are dropped, in both
    packages alike: greedy tokens equal. (Paged single-step is left out:
    there two idle rows write trash page 0 at one offset in the same
    step, in either order, and then attend it.)"""
    from swarmdb_tpu.backend.engine import GenRequest as JReq

    calls = []
    block = tm.moe_block

    def counting(x, router, *a, **kw):
        calls.append((x.shape[1], _drops(x, router, 2, 2.0)))
        return block(x, router, *a, **kw)

    monkeypatch.setattr(tm, "moe_block", counting)
    je, te = _engines(monkeypatch, (JMOE8, TMOE8), paged, chunked, seed=1,
                      per_chunk=True)
    prompts = _prompts(2, lengths=(21, 40))[:2]
    news = (6, 20)

    def req(cls, sp):
        return lambda p, n, done: cls(
            prompt=p, sampling=sp(max_new_tokens=n),
            on_done=lambda rid, toks, why: done.__setitem__(rid, (toks, why)))

    jout = _run_together(je, req(JReq, JSP), prompts, news)
    tout = _run_together(te, req(GenRequest, TSP), prompts, news)
    assert all(o is not None for o in tout)
    assert jout == tout
    assert any(drops for T, drops in calls if T == 1), calls
    assert any(drops for T, drops in calls if T > 1), calls


# ---------------------------------------------------------------- serving


def test_function_call_round_trip_through_swarmdb(tmp_path):
    """A ``function_call`` message to a tiny-moe backed agent comes back
    as a ``function_result`` reply, on the paged engine (row-bucketed
    prefill) and on the default dense one."""
    for paged in (True, None):
        db = SwarmDB(broker=LocalBroker(), save_dir=str(tmp_path / str(paged)))
        svc = ServingService.from_model_name(db, "tiny-moe", backend_id="b0",
                                             max_batch=2, max_seq=128,
                                             paged=paged, device="cpu")
        try:
            assert (svc.engine.paged is None) == (paged is None)
            db.register_agent("user")
            db.register_agent("tool")
            db.assign_llm_backend("tool", "b0")
            svc.start()
            mid = db.send_message(
                "user", "tool",
                {"name": "lookup_weather",
                 "arguments": {"city": "city_3", "unit": "C"}},
                message_type=MessageType.FUNCTION_CALL,
                metadata={"generation": {"max_new_tokens": 6}})
            deadline = time.time() + 60
            replies = []
            while not replies and time.time() < deadline:
                replies = db.receive_messages("user", timeout=0.2)
            assert replies, "no reply arrived"
            reply = replies[0]
            assert reply.type == MessageType.FUNCTION_RESULT
            assert reply.metadata["reply_to"] == mid
            assert reply.metadata["finish_reason"] in ("length", "eos")
        finally:
            svc.stop()
            db.close()


def test_tool_call_turns_render_as_in_jax(tmp_path):
    """Both packages render a tool conversation's prompts token for token
    alike, and so share its prefix-cache behaviour: a ``function_call``
    renders as ``user [tool-call]: ...`` in its own prompt and as
    ``user: ...`` in history, so turn 2 shares no full page (16 tokens)
    with turn 1, while turn 3 shares several with turn 2 (ROADMAP.md,
    queue 3)."""
    from swarmdb_tpu.backend.service import build_prompt as jax_prompt
    from swarmdb_tpu.broker.local import LocalBroker as JaxBroker
    from swarmdb_tpu.core.messages import MessageType as JaxType
    from swarmdb_tpu.core.runtime import SwarmDB as JaxDB
    from swarmdb_tpu_torch.backend.service import build_prompt
    from swarmdb_tpu_torch.backend.tokenizer import (
        default_tokenizer as port_tokenizer)

    def drive(db, mtype, render, tok):
        for a in ("user", "tool"):
            db.register_agent(a)
        prompts = []
        for turn in range(3):
            mid = db.send_message(
                "user", "tool", {"name": "lookup_weather",
                                 "arguments": {"city": f"city_{turn}"}},
                message_type=mtype.FUNCTION_CALL)
            prompts.append(render(db, db.get_message(mid), tok,
                                  history_limit=64))
            db.send_message("tool", "user", f"sunny, {20 + turn} C",
                            message_type=mtype.FUNCTION_RESULT)
        db.close()
        return prompts

    jdb = JaxDB(broker=JaxBroker(), save_dir=str(tmp_path / "jax"))
    tdb = SwarmDB(broker=LocalBroker(), save_dir=str(tmp_path / "port"))
    jp_ = drive(jdb, JaxType, jax_prompt,
                default_tokenizer(JCFG.vocab_size))
    tp_ = drive(tdb, MessageType, build_prompt,
                port_tokenizer(TCFG.vocab_size))
    assert jp_ == tp_

    def shared(a, b):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        return n

    assert shared(tp_[0], tp_[1]) < PS
    assert shared(tp_[1], tp_[2]) >= 3 * PS


# ------------------------------------------- Llama without ragged waves


@pytest.mark.parametrize("chunked", [True, False],
                         ids=["chunked", "single_step"])
def test_llama_bucketed_paged_prefill_equals_jax(monkeypatch, chunked):
    """tiny-debug with ``SWARMDB_RAGGED_PREFILL=0``: the Llama paged
    engine admits through the row-bucketed and prefix waves (read at
    build in both packages) and gives the JAX package's tokens."""
    from swarmdb_tpu.models.configs import get_config as jget

    monkeypatch.setenv("SWARMDB_RAGGED_PREFILL", "0")
    monkeypatch.setenv("SWARMDB_CHUNKED", "1" if chunked else "0")
    monkeypatch.setenv("SWARMDB_KV_DTYPE", "f32")
    cfg = jget("tiny-debug")
    je, _ = jax_build(cfg, max_batch=4, max_seq=SEQ, paged=True,
                      page_size=PS)
    je.params = jax.tree.map(lambda a: a.astype(jnp.float32), je.params)
    je._prefill_cache_fn = lambda b, s: jl.init_kv_cache(cfg, b, s,
                                                         jnp.float32)
    te, _ = build_backend_engine(
        "tiny-debug", max_batch=4, max_seq=SEQ, paged=True, page_size=PS,
        device="cpu", params=params_from_numpy(
            jax.tree.map(np.asarray, je.params), device="cpu"))
    assert not te._ragged and not je._ragged_active()
    je.start()
    te.start()
    try:
        for p in _prompts(3):
            assert je.generate_sync(p, JSP(max_new_tokens=10)) == \
                te.generate_sync(p, TSP(max_new_tokens=10)), len(p)
    finally:
        je.stop()
        te.stop()
    c = te.metrics.counters
    assert c["prefix_reused_tokens"].value > 0
    assert c["prefill_padding_tokens"].value > 0   # bucketed, not packed
