"""The warm tier's host page store and its raw page payloads, against
the JAX package (``tests/test_host_pool_codec.py``'s cases, each run
through both packages' ``HostPageStore`` on the same payloads; the port's
payloads are CPU tensors made from the same numpy arrays):

- the codec is off by default and stored bytes are the raw bytes;
- ``SWARMDB_TIER_ZSTD=1`` round-trips bit-exactly (zlib here, where
  ``zstandard`` is absent) with the same compressed sizes and stats;
- quantized (int8 data, f32 scale) tuples round-trip;
- capacity and eviction count compressed bytes;
- a store that lost its codec still inflates;
- ``pool_gather_pages`` / ``pool_insert_raw`` move the JAX package's exact
  storage-width bytes (f32, bf16 and int8 pools): a gathered payload
  equals the JAX one and reinserting it restores the pool bit for bit.

Tolerances: none (bytes are compared exactly).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swarmdb_tpu.ops import host_pool as jhp
from swarmdb_tpu.ops import paged_kv as jpk
from swarmdb_tpu_torch.ops import host_pool as thp
from swarmdb_tpu_torch.ops import paged_kv as tpk


def _plain_payload(pages=4, fill=3):
    # low-entropy payloads: compressible enough to show a ratio > 1
    k = np.full((pages, 8, 2, 4), fill, dtype=np.float32)
    v = np.full((pages, 8, 2, 4), fill + 1, dtype=np.float32)
    return k, v


def _quantized_payload(pages=4):
    data = np.ones((pages, 8, 2, 4), dtype=np.int8)
    scale = np.full((pages, 8, 2, 1), 0.5, dtype=np.float32)
    return (data, scale), (data * 2, scale * 3)


def _t(payload):
    """The port's payload: the same arrays as CPU tensors."""
    if isinstance(payload, tuple):
        return tuple(torch.from_numpy(p.copy()) for p in payload)
    return torch.from_numpy(payload.copy())


def _stores(capacity=1 << 20):
    return (jhp.HostPageStore(capacity_bytes=capacity, label="t"),
            thp.HostPageStore(capacity_bytes=capacity, label="t"))


def _equal(np_payload, t_payload):
    if isinstance(np_payload, tuple):
        assert isinstance(t_payload, tuple)
        for a, b in zip(np_payload, t_payload):
            _equal(a, b)
        return
    assert str(t_payload.dtype).endswith(str(np_payload.dtype)) or (
        np_payload.dtype == np.int8 and t_payload.dtype == torch.int8)
    np.testing.assert_array_equal(t_payload.numpy(), np_payload)


def test_codec_off_by_default(monkeypatch):
    monkeypatch.delenv("SWARMDB_TIER_ZSTD", raising=False)
    js, ts = _stores()
    k, v = _plain_payload()
    assert js.put("a", k, v, 4, 30) == ts.put("a", _t(k), _t(v), 4, 30) == []
    assert ts.stats() == js.stats()
    st = ts.stats()
    assert st["codec"] is None and "compress_ratio" not in st
    assert st["bytes"] == k.nbytes + v.nbytes
    e = ts.pop("a")
    _equal(k, e.k)
    _equal(v, e.v)


def test_codec_roundtrip_bit_exact(monkeypatch):
    monkeypatch.setenv("SWARMDB_TIER_ZSTD", "1")
    js, ts = _stores()
    k, v = _plain_payload()
    js.put("a", k, v, 4, 30)
    ts.put("a", _t(k), _t(v), 4, 30)
    st = ts.stats()
    assert st == js.stats()
    assert st["codec"] in ("zstd", "zlib")
    assert st["bytes"] < k.nbytes + v.nbytes and st["compress_ratio"] > 1.0
    assert st["raw_bytes_in"] == k.nbytes + v.nbytes
    assert st["compressed_bytes_in"] == st["bytes"]
    e = ts.pop("a")
    je = js.pop("a")
    _equal(k, e.k)
    _equal(v, e.v)
    assert e.k.dtype == torch.float32 and tuple(e.k.shape) == k.shape
    assert (e.nbytes, e.n_pages, e.length) == (je.nbytes, je.n_pages,
                                               je.length)


def test_quantized_tuple_payload_roundtrip(monkeypatch):
    monkeypatch.setenv("SWARMDB_TIER_ZSTD", "1")
    js, ts = _stores()
    (kd, ks), (vd, vs) = _quantized_payload()
    js.put("q", (kd, ks), (vd, vs), 4, 30)
    ts.put("q", _t((kd, ks)), _t((vd, vs)), 4, 30)
    assert ts.stats() == js.stats()
    e = ts.pop("q")
    assert isinstance(e.k, tuple) and isinstance(e.v, tuple)
    _equal((kd, ks), e.k)
    _equal((vd, vs), e.v)
    assert e.k[0].dtype == torch.int8 and e.k[1].dtype == torch.float32


def test_eviction_accounts_compressed_bytes(monkeypatch):
    monkeypatch.setenv("SWARMDB_TIER_ZSTD", "1")
    k, v = _plain_payload()
    probe = thp.HostPageStore(capacity_bytes=1 << 20, label="probe")
    probe.put("x", _t(k), _t(v), 4, 30)
    nbytes = probe.stats()["bytes"]
    # room for exactly two compressed entries: the third put evicts the
    # LRU entry only
    js, ts = _stores(2 * nbytes + 1)
    for store, conv in ((js, lambda a: a), (ts, _t)):
        assert store.put("a", conv(k), conv(v), 4, 30) == []
        assert store.put("b", conv(k), conv(v), 4, 30) == []
        assert store.put("c", conv(k), conv(v), 4, 30) == ["a"]
    assert ts.stats() == js.stats()
    st = ts.stats()
    assert st["entries"] == 2 and st["evictions"] == 1
    assert ts.pop("a") is None
    assert ts.pop("b") is not None and ts.pop("c") is not None
    assert ts.stats()["bytes"] == 0


def test_env_flip_off_midlife_still_inflates(monkeypatch):
    """A store whose codec was on keeps inflating its entries after the
    env var goes off (the zlib fallback seam)."""
    monkeypatch.setenv("SWARMDB_TIER_ZSTD", "1")
    ts = thp.HostPageStore(capacity_bytes=1 << 20, label="t")
    if ts.stats()["codec"] == "zstd":
        pytest.skip("zstd blobs need the zstd codec to inflate; the "
                    "mid-life fallback seam is zlib-specific")
    k, v = _plain_payload()
    ts.put("a", _t(k), _t(v), 4, 30)
    monkeypatch.delenv("SWARMDB_TIER_ZSTD")
    ts._codec = None  # a store that lost its resolution
    e = ts.pop("a")
    _equal(k, e.k)
    _equal(v, e.v)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_raw_payload_equals_jax_and_reinserts_exactly(kind):
    """A seeded pool of each storage kind: ``pool_gather_pages`` of three
    pages equals the JAX package's payload byte for byte, and
    ``pool_insert_raw`` into pages zeroed meanwhile restores the pool
    exactly, in place."""
    rng = np.random.default_rng(0)
    L, P, ps, H, D = 2, 9, 4, 2, 8
    ids = [5, 2, 7]
    vals = rng.standard_normal((L, P, ps, H, D)).astype(np.float32)
    if kind == "int8":
        q = rng.integers(-127, 128, (L, P, ps, H, D)).astype(np.int8)
        s = rng.random((L, P, H)).astype(np.float32)
        jpool = jpk.QuantPool(jnp.asarray(q), jnp.asarray(s))
        tpool = tpk.QuantPool(torch.from_numpy(q.copy()),
                              torch.from_numpy(s.copy()))
    else:
        jdt = jnp.float32 if kind == "f32" else jnp.bfloat16
        jpool = jnp.asarray(vals, jdt)
        tpool = torch.from_numpy(vals.copy()).to(
            torch.float32 if kind == "f32" else torch.bfloat16)
    jpay = jpk.pool_gather_pages(jpool, ids)
    tpay = tpk.pool_gather_pages(tpool, ids)

    def as_bytes(t):
        return t.contiguous().view(torch.uint8).numpy().tobytes()

    if kind == "int8":
        assert [as_bytes(t) for t in tpay] == [np.asarray(a).tobytes()
                                                for a in jpay]
    else:
        assert as_bytes(tpay) == np.asarray(jpay).tobytes()
    before = [t.clone() for t in (tpk.pool_data(tpool),)
              + ((tpool.scale,) if kind == "int8" else ())]
    ptr = tpk.pool_data(tpool).data_ptr()
    idx = torch.tensor(ids)
    tpk.pool_data(tpool)[:, idx] = 0
    tpk.pool_insert_raw(tpool, idx, tpay)
    after = (tpk.pool_data(tpool),) + ((tpool.scale,) if kind == "int8"
                                       else ())
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert tpk.pool_data(tpool).data_ptr() == ptr


def test_slab_bounds_host_memory_and_recycles_bytes():
    """The store's host memory is one slab of its capacity: carved
    tensors come out of it, give their bytes back when garbage, evict
    the least recently used entries while a payload does not fit, and
    get None when the slab cannot hold one even empty."""
    page = (2, 1, 4, 2, 8)             # [L, n, ps, Hkv, D] f32: 512 bytes
    store = thp.HostPageStore(capacity_bytes=6 * 512, label="t")
    assert store.slab_stats() == {"bytes": 3072, "in_use": 0,
                                  "pinned": False}
    base = store._slab.buf.data_ptr()
    for key in "abc":
        k, evicted = store.host_tensor(page, torch.float32, evict=True)
        v, more = store.host_tensor(page, torch.float32, evict=True)
        assert evicted == more == [] and k.shape == v.shape == page
        assert base <= k.data_ptr() < base + 3072
        k.fill_(1.0)
        v.fill_(2.0)
        assert store.put(key, k, v, 1, 4) == []
    del k, v
    # the entries hold the whole slab: room comes from the oldest one
    assert store.slab_stats()["in_use"] == 3072
    two, evicted = store.host_tensor((2, 2, 4, 2, 8), torch.float32,
                                     evict=True)
    assert evicted == ["a"] and len(store) == 2
    assert store.slab_stats()["in_use"] == 3072
    del two
    assert store.slab_stats()["in_use"] == 2048
    e = store.pop("c")
    assert torch.equal(e.v, torch.full(page, 2.0))
    assert store.slab_stats()["in_use"] == 2048   # the popped payload holds
    del e
    assert store.drop("b")
    assert store.slab_stats()["in_use"] == 0
    # freed extents merged back into one: a whole-slab tensor fits
    whole, evicted = store.host_tensor((6 * 128,), torch.float32)
    assert whole is not None and evicted == []
    assert store.host_tensor((1,), torch.int8, evict=True) == (None, [])
    del whole
    assert store.host_tensor((7 * 128,), torch.float32,
                             evict=True) == (None, [])


def test_codec_inflates_into_the_slab(monkeypatch):
    """Under the codec an entry lives compressed outside the slab; a
    payload that came from the slab is inflated back into it."""
    monkeypatch.setenv("SWARMDB_TIER_ZSTD", "1")
    store = thp.HostPageStore(capacity_bytes=1 << 16, label="t")
    k, v = _plain_payload()
    tk, _ = store.host_tensor(k.shape, torch.float32)
    tv, _ = store.host_tensor(v.shape, torch.float32)
    tk.copy_(torch.from_numpy(k))
    tv.copy_(torch.from_numpy(v))
    store._slab.pinned = True    # as a page-locked slab would report
    store.put("a", _pinned(tk), _pinned(tv), 4, 30)
    del tk, tv
    assert store.slab_stats()["in_use"] == 0
    e = store.pop("a")
    _equal(k, e.k)
    _equal(v, e.v)
    base = store._slab.buf.data_ptr()
    assert base <= e.k.data_ptr() < base + (1 << 16)
    assert store.slab_stats()["in_use"] >= k.nbytes + v.nbytes


class _pinned(torch.Tensor):
    """A CPU tensor that reports page-locked memory, as a slab on the
    card's host would (this host has no page-locked allocator)."""

    def __new__(cls, t):
        return t.as_subclass(cls)

    def is_pinned(self, *args, **kwargs):
        return True


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_gather_lands_in_the_host_callable(kind):
    """``pool_gather_pages`` copies into what ``host`` gives (the warm
    store's slab), and answers None when it has no room."""
    rng = np.random.default_rng(1)
    L, P, ps, H, D = 2, 6, 4, 2, 8
    vals = rng.standard_normal((L, P, ps, H, D)).astype(np.float32)
    if kind == "int8":
        pool = tpk.QuantPool(
            torch.from_numpy(rng.integers(-127, 128, vals.shape)
                             .astype(np.int8)),
            torch.from_numpy(rng.random((L, P, H)).astype(np.float32)))
    else:
        pool = torch.from_numpy(vals)
    store = thp.HostPageStore(capacity_bytes=1 << 16, label="t")
    pay = tpk.pool_gather_pages(
        pool, [4, 1], lambda shape, dt: store.host_tensor(shape, dt)[0])
    plain = tpk.pool_gather_pages(pool, [4, 1])
    base = store._slab.buf.data_ptr()
    for got, want in zip(pay if kind == "int8" else (pay,),
                         plain if kind == "int8" else (plain,)):
        assert torch.equal(got, want)
        assert base <= got.data_ptr() < base + (1 << 16)
    assert tpk.pool_gather_pages(pool, [4, 1], lambda s, d: None) is None
