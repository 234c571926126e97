"""PyTorch port vs JAX reference: int8 KV pages (``SWARMDB_KV_DTYPE=int8``).

The same numpy inputs go through the JAX package's quantizer, quantized
writes and int8 Pallas kernels (interpret mode, as tests/test_kv_quant.py
runs them) and through the port's counterparts on the CPU.

Tolerances:

- Quantization: int8 codes equal, except a +-1 flip where the scaled value
  sits on a rounding tie (|v / scale| within 1e-4 of k + 0.5); scales
  within rtol 1e-6. Both packages divide in f32 and round half to even.
- Plain versions of the int8 kernels vs the Pallas kernels: 1e-5 absolute
  and relative on the same int8 payload and scales (the dequantized values
  are identical; only the softmax's summation order differs).
- Forwards from one carried-over int8 pool: 1e-3 on the logits (measured
  1.2e-5 for the prefill wave, 3e-6 for the decode step). Float32 sums in
  another order move a K/V value by ~1e-7, which can put it on the other
  side of a rounding tie and flip one int8 code of a page a write
  requantizes (one code is amax / 127 of that page); the bound leaves
  room for such a flip. The written pools: codes within +-1, in under
  0.1% of the cells, scales within rtol 1e-5.
- Engines: greedy tokens equal on seeded prompts (ROADMAP.md queue 3 on
  near ties).

``test_quant_kernels_match_plain_on_card`` needs the CUDA card: it is
marked ``cuda`` and skips elsewhere.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend.sampling import SamplingParams as JSP
from swarmdb_tpu.backend.service import build_backend_engine as jax_build
from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu.ops import paged_kv as jp
from swarmdb_tpu.ops.attention_pallas import (
    paged_decode_gqa_attention_chunked_quant as pallas_chunked_quant,
    paged_decode_gqa_attention_quant as pallas_decode_quant,
    ragged_paged_prefill_attention_quant as pallas_prefill_quant,
)
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.backend.service import build_backend_engine
from swarmdb_tpu_torch.models import llama as tl
from swarmdb_tpu_torch.ops import attention_cuda as ac
from swarmdb_tpu_torch.ops import paged_kv as tp
from swarmdb_tpu_torch.utils.convert import (params_from_numpy,
                                             pool_from_numpy, pool_to_numpy)

CFG = get_config("tiny-debug")
TOL = dict(rtol=1e-5, atol=1e-5)
HKV, D, PS = 2, 16, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the other test workers' timing checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _assert_codes(j, t, vals=None, scale=None):
    """int8 codes equal; a +-1 difference only on a rounding tie."""
    j = np.asarray(j).astype(np.int32)
    t = np.asarray(t).astype(np.int32)
    diff = np.abs(j - t)
    assert diff.max(initial=0) <= 1
    if diff.any():
        assert vals is not None, "codes differ where no tie can be shown"
        x = np.abs(vals / scale[..., None, :, None])
        assert np.all(np.abs(x - np.floor(x) - 0.5)[diff > 0] < 1e-4)


def _assert_pool(jpool, tpool, skip_trash=True):
    """Quantized pools equal: codes (ties allowed) and scales (rtol 1e-6).
    Trash page 0 takes duplicate writes in either order: left out."""
    lo = 1 if skip_trash else 0
    jd, js = np.asarray(jpool.data), np.asarray(jpool.scale)
    td, ts = pool_to_numpy(tpool)
    _assert_codes(jd[..., lo:, :, :, :], td[..., lo:, :, :, :])
    np.testing.assert_allclose(js[..., lo:, :], ts[..., lo:, :], rtol=1e-6)


def _both(rng, shape_lead=(2, 7)):
    """One random quantized pool in both packages ([..., P, PS, HKV, D])."""
    vals = _f32(rng, *shape_lead, PS, HKV, D)
    vals[..., 0, :, :, :] = 0.0                          # one all-zero page
    q, s = jp._quantize_pages(jnp.asarray(vals))
    jpool = jp.QuantPool(q, s)
    return jpool, pool_from_numpy(jax.tree.map(np.asarray, jpool),
                                  device="cpu")


# ------------------------------------------------------- quantization


def test_quantize_and_dequantize_match_jax():
    rng = np.random.default_rng(0)
    vals = _f32(rng, 3, 5, PS, HKV, D)
    vals[0, 1] = 0.0                                     # all-zero page
    vals[1, 2] *= 1e-3                                   # tiny scale
    vals[2, 3, :, 0, 0] = 0.5 * np.abs(vals[2, 3]).max()  # near a tie
    jq, js = jp._quantize_pages(jnp.asarray(vals))
    tq, ts = tp._quantize_pages(torch.from_numpy(vals))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=1e-6)
    _assert_codes(jq, tq.numpy(), vals, np.asarray(js))
    assert tq.abs().max() <= 127                         # -128 stays free
    np.testing.assert_array_equal(
        np.asarray(jp._dequantize_pages(jq, js)),
        tp._dequantize_pages(torch.from_numpy(np.array(jq)),
                             torch.from_numpy(np.array(js))).numpy())
    # bf16 input: both widen exactly, then quantize alike
    jb = jp._quantize_pages(jnp.asarray(vals, jnp.bfloat16))
    tb = tp._quantize_pages(torch.from_numpy(vals).bfloat16())
    _assert_codes(jb[0], tb[0].numpy())
    np.testing.assert_allclose(np.asarray(jb[1]), tb[1].numpy(), rtol=1e-6)


def test_requant_window_matches_jax():
    rng = np.random.default_rng(1)
    jpool, tpool = _both(rng, (6,))
    new = _f32(rng, 6, PS, HKV, D, scale=3.0)            # raises the amax
    is_new = rng.random((6, PS)) < 0.3
    is_keep = ~is_new & (rng.random((6, PS)) < 0.6)
    jq, js = jp._requant_window(jpool.data, jpool.scale, jnp.asarray(new),
                                jnp.asarray(is_new), jnp.asarray(is_keep))
    tq, ts = tp._requant_window(tpool.data, tpool.scale,
                                torch.from_numpy(new),
                                torch.from_numpy(is_new),
                                torch.from_numpy(is_keep))
    _assert_codes(jq, tq.numpy())
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=1e-6)


# ------------------------------------------------------------- writes


def test_int8_paged_write_decode():
    """One token per slot: mid-page (survivors requantized), a page's
    first slot (later slots zeroed), past the coverage (trash), an
    inactive slot (zeroed table row: trash)."""
    rng = np.random.default_rng(2)
    jk, tk = _both(rng, (7,))
    jv, tv = _both(rng, (7,))
    k = _f32(rng, 4, 1, HKV, D, scale=2.0)
    v = _f32(rng, 4, 1, HKV, D)
    pos = np.array([[5], [4], [12], [3]], np.int32)
    table = np.array([[1, 2, 0], [3, 4, 0], [5, 6, 0], [0, 0, 0]], np.int32)
    jo = jp.paged_write_decode(jk, jv, *map(jnp.asarray, (k, v, pos,
                                                          table)))
    to = tp.paged_write_decode(tk, tv, *map(torch.from_numpy, (k, v, pos,
                                                               table)))
    for j, t in zip(jo, to):
        _assert_pool(j, t)


def test_int8_paged_write_chunk():
    """A finished chunk of 5 from mid-page starts (crossing a page), one
    starting on a page boundary, one running past the coverage."""
    rng = np.random.default_rng(3)
    jk, tk = _both(rng)
    jv, tv = _both(rng)
    L, B, Kc = 2, 3, 5
    ck = _f32(rng, L, B, Kc, HKV, D)
    cv = _f32(rng, L, B, Kc, HKV, D, scale=0.5)
    table = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
    table[2] = [0, 0, 0]
    starts = np.array([2, 8, 9], np.int32)               # slot 1 overshoots
    jo = jp.paged_write_chunk(jk, jv, *map(jnp.asarray, (ck, cv, starts,
                                                         table)))
    to = tp.paged_write_chunk(tk, tv, *map(torch.from_numpy, (ck, cv, starts,
                                                              table)))
    for j, t in zip(jo, to):
        _assert_pool(j, t)


def test_int8_paged_write_ragged():
    """A packed wave: a fresh row filling one page and part of the next,
    the tail of a split prompt whose head sits in a partly filled page
    (survivors requantized), a prefix-hit row starting on a page boundary,
    a dead row, and padding."""
    rng = np.random.default_rng(4)
    jk, tk = _both(rng, (2, 13))
    jv, tv = _both(rng, (2, 13))
    W = 16
    sk = _f32(rng, 2, W, HKV, D)
    sv = _f32(rng, 2, W, HKV, D)
    tables = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12]],
                      np.int32)
    tok_row = np.full(W, 4, np.int32)
    tok_pos = np.full(W, 12, np.int32)
    for r, (s, n, p0) in enumerate([(0, 6, 0), (6, 5, 2), (11, 3, 4)]):
        tok_row[s:s + n] = r
        tok_pos[s:s + n] = p0 + np.arange(n)
    args = (sk, sv, tok_row, tok_pos, tables)
    jo = jp.paged_write_ragged(jk, jv, *map(jnp.asarray, args))
    to = tp.paged_write_ragged(tk, tv, *map(torch.from_numpy, args))
    for j, t in zip(jo, to):
        _assert_pool(j, t)


def test_int8_gather_dequantizes_like_jax():
    rng = np.random.default_rng(5)
    jk, tk = _both(rng, (9,))
    jv, tv = _both(rng, (9,))
    table = np.array([[1, 2, 3], [4, 0, 0], [8, 7, 6]], np.int32)
    jg = jp.paged_gather_kv(jk, jv, jnp.asarray(table))
    tg = tp.paged_gather_kv(tk, tv, torch.from_numpy(table))
    for a, b in zip(jg, tg):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ------------------------------------------------ kernels: plain vs Pallas


def _quant_pool(rng, B, maxp, lengths):
    """Slots filled to ``lengths`` tokens over their own pages, quantized
    in the JAX package (page 0 trash). Returns numpy (kq, ks, vq, vs,
    table)."""
    P = 1 + B * maxp
    kp = np.zeros((P, PS, HKV, D), np.float32)
    vp = np.zeros((P, PS, HKV, D), np.float32)
    table = np.zeros((B, maxp), np.int32)
    nxt = 1
    for b in range(B):
        for j in range(-(-int(lengths[b]) // PS)):
            table[b, j] = nxt
            kp[nxt] = _f32(rng, PS, HKV, D)
            vp[nxt] = _f32(rng, PS, HKV, D)
            nxt += 1
    kq, ks = jp._quantize_pages(jnp.asarray(kp))
    vq, vs = jp._quantize_pages(jnp.asarray(vp))
    return tuple(np.array(a) for a in (kq, ks, vq, vs)) + (table,)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("window", [None, 5])
def test_decode_quant_plain_matches_pallas(G, window):
    """Kernel 6: single-step decode over int8 pages, page-crossing
    lengths, and a length-0 slot that must give zeros."""
    rng = np.random.default_rng(10 + G)
    B, maxp = 4, 3
    lengths = np.array([5, PS, 2 * PS + 3, 0], np.int32)
    pool = _quant_pool(rng, B, maxp, lengths)
    q = _f32(rng, B, HKV * G, D)
    args = (q,) + pool + (lengths,)
    t = ac.paged_decode_quant_plain(*map(torch.from_numpy, args),
                                    window=window).numpy()
    k = np.asarray(pallas_decode_quant(*map(jnp.asarray, args),
                                       window=window, interpret=True))
    np.testing.assert_allclose(t, k, **TOL)
    assert not t[3].any() and not k[3].any()


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("step,window", [(0, None), (3, None), (2, 5)])
def test_chunked_decode_quant_plain_matches_pallas(G, step, window):
    """Kernel 5: two-segment decode over int8 pages + a full-precision
    chunk buffer; one slot with an empty prefix."""
    rng = np.random.default_rng(20 + G)
    B, maxp, Kc = 3, 4, 4
    starts = np.array([PS + 2, 2 * PS, 0], np.int32)
    pool = _quant_pool(rng, B, maxp, starts)
    q = _f32(rng, B, HKV * G, D)
    ck, cv = _f32(rng, B, Kc, HKV, D), _f32(rng, B, Kc, HKV, D)
    t = ac.paged_decode_chunked_quant_plain(
        *map(torch.from_numpy, (q,) + pool + (ck, cv, starts)), step,
        window=window).numpy()
    k = np.asarray(pallas_chunked_quant(
        *map(jnp.asarray, (q,) + pool + (ck, cv, starts)), jnp.int32(step),
        window=window, interpret=True))
    np.testing.assert_allclose(t, k, **TOL)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("window", [None, 3])
def test_prefill_quant_plain_matches_pallas(G, window):
    """Kernel 4: int8 prefix pages + full-precision suffix: a fresh row,
    a page-aligned prefix, a mid-page split, a dead row."""
    rng = np.random.default_rng(30 + G)
    R, maxp, W = 4, 4, 16
    plens = np.array([0, PS, PS + 1, 0], np.int32)
    lens = np.array([3, 5, 4, 0], np.int32)
    starts = np.array([0, 3, 8, 12], np.int32)
    kq, ks, vq, vs, tables = _quant_pool(rng, R, maxp, plens + lens)
    q = _f32(rng, W, HKV * G, D)
    sk, sv = _f32(rng, W, HKV, D), _f32(rng, W, HKV, D)
    args = (q, sk, sv, kq, ks, vq, vs, tables, starts, lens, plens)
    t = ac.ragged_prefill_quant_plain(*map(torch.from_numpy, args),
                                      window=window).numpy()
    k = np.asarray(pallas_prefill_quant(*map(jnp.asarray, args),
                                        window=window, interpret=True))
    own = np.zeros(W, bool)
    for s, n in zip(starts, lens):
        own[s:s + n] = True
    np.testing.assert_allclose(t[own], k[own], **TOL)
    assert not t[~own].any()


def test_quant_wrappers_run_plain_on_cpu_and_check_args():
    rng = np.random.default_rng(40)
    lengths = np.array([6, 0], np.int32)
    kq, ks, vq, vs, table = map(torch.from_numpy,
                                _quant_pool(rng, 2, 2, lengths))
    q = torch.from_numpy(_f32(rng, 2, 4, D))
    lens = torch.from_numpy(lengths)
    ac.reset_launches()
    out = ac.paged_decode_gqa_attention_quant(q, kq, ks, vq, vs, table, lens)
    assert torch.equal(out, ac.paged_decode_quant_plain(q, kq, ks, vq, vs,
                                                        table, lens))
    # the query keeps its own dtype: bf16 in, bf16 out
    assert ac.paged_decode_gqa_attention_quant(
        q.bfloat16(), kq, ks, vq, vs, table, lens).dtype == torch.bfloat16
    assert not any(ac.LAUNCHES.values())
    with pytest.raises(ValueError, match="int8"):
        ac.paged_decode_gqa_attention_quant(q, kq.float(), ks, vq.float(),
                                            vs, table, lens)
    with pytest.raises(ValueError, match="float32"):
        ac.paged_decode_gqa_attention_quant(q, kq, ks.double(), vq,
                                            vs.double(), table, lens)
    with pytest.raises(ValueError, match=r"\[P, Hkv\]"):
        ac.paged_decode_gqa_attention_quant(q, kq, ks[:1], vq, vs[:1],
                                            table, lens)
    with pytest.raises(ValueError, match="int8 through the _quant"):
        ac.paged_decode_gqa_attention(q, kq, vq, table, lens)


# ------------------------------------------------------------ forwards


@pytest.fixture(scope="module")
def params():
    jpar = jax.tree.map(lambda a: a.astype(jnp.float32),
                        jl.init_params(CFG, jax.random.PRNGKey(3)))
    return jpar, params_from_numpy(jax.tree.map(np.asarray, jpar),
                                   device="cpu")


def _model_pools(seed, P=13, ps=16):
    rng = np.random.default_rng(seed)
    shape = (CFG.n_layers, P, ps, CFG.n_kv_heads, CFG.head_dim)
    out = []
    for _ in range(2):
        jpool = jp.QuantPool(*jp._quantize_pages(jnp.asarray(
            rng.standard_normal(shape).astype(np.float32))))
        out.append((jpool, pool_from_numpy(jax.tree.map(np.asarray, jpool),
                                           device="cpu")))
    return out


def test_forward_ragged_prefill_int8_pool(params):
    """The wave of tests/test_torch_llama.py over an int8 pool: prefix
    rows read int8 pages, the suffix attends in bf16 (the pool's logical
    dtype); then the wave's quantized write."""
    jpar, tpar = params
    rng = np.random.default_rng(1)
    W, R, MAXP, ps = 48, 4, 4, 16
    (jk, tk), (jv, tv) = _model_pools(2)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12],
                       [0, 0, 0, 0]], np.int32)
    starts = np.array([0, 10, 0, 30], np.int32)
    lens = np.array([10, 20, 0, 13], np.int32)
    plens = np.array([32, 0, 0, 21], np.int32)
    tokens = rng.integers(3, CFG.vocab_size, W).astype(np.int32)
    tok_row = np.full(W, R, np.int32)
    tok_pos = np.full(W, MAXP * ps, np.int32)
    for r in range(R):
        s, n = starts[r], lens[r]
        tok_row[s:s + n] = r
        tok_pos[s:s + n] = plens[r] + np.arange(n)
    args = (tokens, tok_row, tok_pos, tables, starts, lens, plens)
    jlog, jsk, jsv = jl.forward_ragged_prefill(
        jpar, CFG, *map(jnp.asarray, args), jk, jv)
    tlog, tsk, tsv = tl.forward_ragged_prefill(
        tpar, CFG, *map(torch.from_numpy, args), tk, tv)
    assert tsk.dtype == torch.bfloat16
    live = lens > 0
    np.testing.assert_allclose(np.asarray(jlog)[live], tlog.numpy()[live],
                               atol=1e-3, rtol=1e-3)
    jo = jp.paged_write_ragged(jk, jv, jsk, jsv, *map(
        jnp.asarray, (tok_row, tok_pos, tables)))
    to = tp.paged_write_ragged(tk, tv, tsk, tsv, *map(
        torch.from_numpy, (tok_row, tok_pos, tables)))
    for j, t in zip(jo, to):
        jd, td = np.asarray(j.data)[:, 1:], t.data.numpy()[:, 1:]
        assert np.abs(jd.astype(int) - td.astype(int)).max() <= 1
        assert (jd != td).mean() < 1e-3
        np.testing.assert_allclose(np.asarray(j.scale)[:, 1:],
                                   t.scale.numpy()[:, 1:], rtol=1e-5)


def test_forward_paged_chunked_and_merge_int8_pool(params):
    jpar, tpar = params
    rng = np.random.default_rng(4)
    B, Kc, step = 3, 4, 2
    (jk, tk), (jv, tv) = _model_pools(5)
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 10]], np.int32)
    positions = np.array([[21], [9], [40]], np.int32)
    tokens = rng.integers(3, CFG.vocab_size, (B, 1)).astype(np.int32)
    shape = (CFG.n_layers, B, Kc, CFG.n_kv_heads, CFG.head_dim)
    hk = rng.standard_normal(shape).astype(np.float32)
    hv = rng.standard_normal(shape).astype(np.float32)
    jcache = {"k": jk, "v": jv, "page_table": jnp.asarray(table)}
    tcache = {"k": tk, "v": tv, "page_table": torch.from_numpy(table)}
    jlog, jchunk = jl.forward_paged_chunked(
        jpar, CFG, jnp.asarray(tokens), jnp.asarray(positions), jcache,
        (jnp.asarray(hk, jnp.bfloat16), jnp.asarray(hv, jnp.bfloat16)),
        jnp.int32(step))
    tlog, tchunk = tl.forward_paged_chunked(
        tpar, CFG, torch.from_numpy(tokens), torch.from_numpy(positions),
        tcache, (torch.from_numpy(hk).bfloat16(),
                 torch.from_numpy(hv).bfloat16()), step)
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), atol=1e-4,
                               rtol=1e-4)
    starts = positions[:, 0] - step
    jm = jl.merge_paged_chunk(jcache, jchunk, jnp.asarray(starts))
    tm = tl.merge_paged_chunk(tcache, tchunk, torch.from_numpy(starts))
    for key in ("k", "v"):
        j, t = jm[key], tm[key]
        jd, td = np.asarray(j.data)[:, 1:], t.data.numpy()[:, 1:]
        assert np.abs(jd.astype(int) - td.astype(int)).max() <= 1
        assert (jd != td).mean() < 1e-3
        np.testing.assert_allclose(np.asarray(j.scale)[:, 1:],
                                   t.scale.numpy()[:, 1:], rtol=1e-5)


# ------------------------------------------------------------- engines


@pytest.mark.parametrize("chunked", ["1", "0"])
def test_int8_engine_tokens_equal_jax_engine(monkeypatch, chunked):
    """The port's int8 engine (chunked, and single-step) against the JAX
    package's on the same f32 weights: greedy tokens equal on seeded
    prompts, one long enough to split across waves, a repeat that hits
    the prefix cache (its pages read back as int8)."""
    monkeypatch.setenv("SWARMDB_KV_DTYPE", "int8")
    monkeypatch.setenv("SWARMDB_CHUNKED", chunked)
    je, _ = jax_build(CFG, max_batch=4, max_seq=96, paged=True, page_size=16)
    je.params = jax.tree.map(lambda a: a.astype(jnp.float32), je.params)
    te, _ = build_backend_engine(
        "tiny-debug", max_batch=4, max_seq=96, paged=True, page_size=16,
        device="cpu", params=params_from_numpy(jax.tree.map(np.asarray, je.params),
                                 device="cpu"))
    assert tp.is_quantized(te.cache["k"]) and jp.is_quantized(je.cache["k"])
    assert (te._chunked_fns is None) == (chunked == "0")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 259, n).tolist() for n in (15, 37, 61)]
    prompts.append(prompts[1] + rng.integers(3, 259, 10).tolist())
    je.start()
    te.start()
    try:
        for p in prompts:
            assert je.generate_sync(p, JSP(max_new_tokens=10)) == \
                te.generate_sync(p, TSP(max_new_tokens=10)), len(p)
    finally:
        je.stop()
        te.stop()
    assert te.metrics.counters["prefix_reused_tokens"].value > 0


# ------------------------------------------------------------ the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_quant_kernels_match_plain_on_card(cuda_device, dtype, tol):
    """Kernels 4-6 against their plain versions on the same card tensors
    (the same int8 payload and scales on both sides); query, chunk and
    suffix in ``dtype``: f32 within 1e-4, bf16 within 2e-2."""
    rng = np.random.default_rng(50)
    dev = cuda_device
    to = lambda a, cast=False: (torch.from_numpy(a).to(dev).to(dtype) if cast
                                else torch.from_numpy(a).to(dev))
    lengths = np.array([5, PS, 2 * PS + 3, 0], np.int32)
    kq, ks, vq, vs, table = map(to, _quant_pool(rng, 4, 3, lengths))
    q = to(_f32(rng, 4, 2 * HKV, D), True)
    pairs = []
    for window in (None, 5):
        pairs.append((
            ac.paged_decode_gqa_attention_quant(
                q, kq, ks, vq, vs, table, to(lengths), window=window),
            ac.paged_decode_quant_plain(
                q, kq, ks, vq, vs, table, to(lengths), window=window)))
        starts = to(np.array([PS + 2, 2 * PS, 0, 3], np.int32))
        ck = to(_f32(rng, 4, 4, HKV, D), True)
        cv = to(_f32(rng, 4, 4, HKV, D), True)
        pairs.append((
            ac.paged_decode_gqa_attention_chunked_quant(
                q, kq, ks, vq, vs, table, ck, cv, starts, 2, window=window),
            ac.paged_decode_chunked_quant_plain(
                q, kq, ks, vq, vs, table, ck, cv, starts, 2,
                window=window)))
        W = 16
        sq = to(_f32(rng, W, 2 * HKV, D), True)
        sk = to(_f32(rng, W, HKV, D), True)
        sv = to(_f32(rng, W, HKV, D), True)
        desc = [to(np.array(a, np.int32)) for a in
                ([0, 3, 8, 12], [3, 5, 4, 0], [0, PS, PS + 1, 0])]
        pairs.append((
            ac.ragged_paged_prefill_attention_quant(
                sq, sk, sv, kq, ks, vq, vs, table, *desc, window=window),
            ac.ragged_prefill_quant_plain(
                sq, sk, sv, kq, ks, vq, vs, table, *desc, window=window)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.dtype == dtype
        assert (got.float() - want.float()).abs().max().item() <= tol
