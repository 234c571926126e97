"""PyTorch port vs JAX reference: the paged KV pool's writes and the host
page allocator.

The writes are exact copies, so live cells must be bit-identical. Page 0
(the trash page) absorbs padding tokens and out-of-coverage writes in both
packages; duplicate trash writes land in either order, so the trash page is
left out of the comparison.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swarmdb_tpu.ops import paged_kv as jp
from swarmdb_tpu_torch.ops import paged_kv as tp

L, P, PS, HKV, D = 2, 7, 4, 2, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the other test workers' timing checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pools(rng):
    return (rng.standard_normal((L, P, PS, HKV, D)).astype(np.float32),
            rng.standard_normal((L, P, PS, HKV, D)).astype(np.float32))


def _same_live(j, t):
    np.testing.assert_array_equal(np.asarray(j)[:, 1:], t.numpy()[:, 1:])


def test_paged_write_ragged():
    rng = np.random.default_rng(0)
    k, v = _pools(rng)
    W = 10
    sk = rng.standard_normal((L, W, HKV, D)).astype(np.float32)
    sv = rng.standard_normal((L, W, HKV, D)).astype(np.float32)
    tables = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    tok_row = np.array([0, 0, 0, 0, 0, 1, 1, 1, 2, 2], np.int32)  # 2 = pad
    tok_pos = np.array([3, 4, 5, 6, 7, 0, 1, 2, 12, 12], np.int32)
    jk, jv = jp.paged_write_ragged(*map(jnp.asarray, (k, v, sk, sv, tok_row,
                                                      tok_pos, tables)))
    tk, tv = tp.paged_write_ragged(*map(torch.from_numpy,
                                        (k.copy(), v.copy(), sk, sv, tok_row,
                                         tok_pos, tables)))
    _same_live(jk, tk)
    _same_live(jv, tv)


def test_paged_write_chunk_and_gather():
    rng = np.random.default_rng(1)
    k, v = _pools(rng)
    B, Kc = 2, 3
    ck = rng.standard_normal((L, B, Kc, HKV, D)).astype(np.float32)
    cv = rng.standard_normal((L, B, Kc, HKV, D)).astype(np.float32)
    table = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    starts = np.array([3, 10], np.int32)   # slot 1 runs past coverage
    jk, jv = jp.paged_write_chunk(*map(jnp.asarray, (k, v, ck, cv, starts,
                                                     table)))
    tk, tv = tp.paged_write_chunk(*map(torch.from_numpy,
                                       (k.copy(), v.copy(), ck, cv, starts,
                                        table)))
    _same_live(jk, tk)
    _same_live(jv, tv)
    jg = jp.paged_gather_kv(jk[1], jv[1], jnp.asarray(table))
    tg = tp.paged_gather_kv(tk[1], tv[1], torch.from_numpy(table))
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_set_page_table_rows():
    table = np.arange(12, dtype=np.int32).reshape(4, 3)
    rows, vals = [2, 0], np.array([[7, 8, 9], [0, 0, 0]], np.int32)
    j = jp.set_page_table_rows(jnp.asarray(table), rows, vals)
    t = tp.set_page_table_rows(torch.from_numpy(table.copy()), rows, vals)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_allocator_sequence_matches():
    """The same admission / transfer / retirement / reclaim sequence hands
    out the same page ids and reports the same counts."""
    args = (9, 4, 16, 3)
    ja, ta = jp.PageAllocator(*args), tp.PageAllocator(*args)
    assert ja.pages_needed(5, 6, 2) == ta.pages_needed(5, 6, 2)
    for a in (ja, ta):
        assert a.maxp == 4
    ops = [("allocate", 0, 3), ("allocate_with_prefix", 1, [2], 2),
           ("transfer_to_cache", 0, [1]), ("mark_retired", 0),
           ("take_release",), ("add_free", [1]), ("allocate", 2, 4),
           ("allocate", 0, 9)]
    for op in ops:
        outs = []
        for a in (ja, ta):
            if op[0] == "take_release":
                a.release_taken(a.take_pending_frees())
                outs.append(None)
                continue
            r = getattr(a, op[0])(*op[1:])
            outs.append(None if r is None else np.asarray(r).tolist())
        assert outs[0] == outs[1], op
        assert ja.free_count() == ta.free_count()
        for s in range(3):
            assert ja.pages_for(s) == ta.pages_for(s)
    keys = ("num_pages", "free_pages", "live_slots", "pages_allocated_total",
            "pages_freed_total")
    js, ts = ja.stats(), ta.stats()
    assert {k: js[k] for k in keys} == {k: ts[k] for k in keys}


def test_pool_init_and_int8_structure(monkeypatch):
    pool = tp.init_paged_kv_cache(2, 5, 4, 2, 8, batch=3, max_seq=16,
                                  dtype=torch.float32, device="cpu")
    assert pool["k"].shape == (2, 5, 4, 2, 8)
    assert pool["page_table"].shape == (3, 4)
    assert pool["page_table"].dtype == torch.int32
    assert tp.pages_per_slot(17, 4) == jp.pages_per_slot(17, 4) == 5
    # SWARMDB_KV_DTYPE=int8: the JAX package's QuantPool layout, field for
    # field (int8 payload, f32 scales per page and KV head, all zero)
    monkeypatch.setenv("SWARMDB_KV_DTYPE", "int8")
    jpool = jp.init_paged_kv_cache(2, 5, 4, 2, 8, batch=3, max_seq=16)
    qpool = tp.init_paged_kv_cache(2, 5, 4, 2, 8, batch=3, max_seq=16,
                                   device="cpu")
    for key in ("k", "v"):
        assert tp.is_quantized(qpool[key]) and jp.is_quantized(jpool[key])
        for field in ("data", "scale"):
            j, t = getattr(jpool[key], field), getattr(qpool[key], field)
            assert tuple(t.shape) == j.shape
            assert str(t.dtype).split(".")[-1] == str(j.dtype)
            assert not t.any()
    assert tp.pool_dtype(qpool["k"]) == torch.bfloat16
    assert tp.pool_data(qpool["k"]) is qpool["k"].data
    layer = tp.pool_layer(qpool["k"], 1)
    assert layer.data.shape == (5, 4, 2, 8) and layer.scale.shape == (5, 2)
    assert layer.data.data_ptr() == qpool["k"].data[1].data_ptr()  # a view
    assert tp.pool_page_bytes(qpool["k"]) == jp.pool_page_bytes(
        jpool["k"]) == 2 * (4 * 2 * 8 + 2 * 4)
    assert tp.pool_page_bytes(pool["k"]) == 2 * 4 * 2 * 8 * 4
    monkeypatch.setenv("SWARMDB_KV_DTYPE", "fp4")
    with pytest.raises(ValueError, match="SWARMDB_KV_DTYPE"):
        tp.init_paged_kv_cache(2, 5, 4, 2, 8, batch=3, max_seq=16,
                               device="cpu")


@pytest.mark.parametrize("env,name", [(None, None), ("int8", None),
                                      ("f32", None), ("bf16", "int8"),
                                      ("int8", "f32")])
def test_kv_quantized_equals_jax(monkeypatch, env, name):
    if env is None:
        monkeypatch.delenv("SWARMDB_KV_DTYPE", raising=False)
    else:
        monkeypatch.setenv("SWARMDB_KV_DTYPE", env)
    assert tp.kv_quantized(name) == jp.kv_quantized(name)
    assert tp.kv_quantized(name) == ((name or env) == "int8")


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_paged_insert_prefill_matches_jax(kind):
    """The JAX package's case (tests/test_paged_kv.py): two of three rows
    of an 8-token bucket into pages of 4, one chunk to trash page 0; live
    pages equal, payload and scales for an int8 pool."""
    Bp, bucket, npages = 3, 8, 6
    rng = np.random.default_rng(5)
    dk = rng.standard_normal((L, Bp, bucket, HKV, D)).astype(np.float32)
    dv = rng.standard_normal((L, Bp, bucket, HKV, D)).astype(np.float32)
    target = np.array([[1, 2], [3, 0]], np.int32)
    shape = (L, npages, PS, HKV, D)
    if kind == "int8":
        jpools = [jp.QuantPool(jnp.zeros(shape, jnp.int8),
                               jnp.zeros(shape[:2] + (HKV,), jnp.float32))
                  for _ in range(2)]
        tpools = [tp.QuantPool(torch.zeros(shape, dtype=torch.int8),
                               torch.zeros(shape[:2] + (HKV,)))
                  for _ in range(2)]
    else:
        jpools = [jnp.zeros(shape, jnp.float32) for _ in range(2)]
        tpools = [torch.zeros(shape) for _ in range(2)]
    jk, jv = jp.paged_insert_prefill(*jpools, jnp.asarray(dk),
                                     jnp.asarray(dv), jnp.asarray(target))
    tk, tv = tp.paged_insert_prefill(*tpools, torch.from_numpy(dk),
                                     torch.from_numpy(dv),
                                     torch.from_numpy(target))
    for j, t in ((jk, tk), (jv, tv)):
        if kind == "int8":
            for field in ("data", "scale"):
                _same_live(getattr(j, field), getattr(t, field))
        else:
            _same_live(j, t)
    assert tp.pool_data(tk)[:, 1:4].any()   # the live pages were written
    with pytest.raises(ValueError, match="pages of"):
        tp.paged_insert_prefill(*tpools, torch.from_numpy(dk[:, :, :6]),
                                torch.from_numpy(dv[:, :, :6]),
                                torch.from_numpy(target))
