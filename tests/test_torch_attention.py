"""The ragged-prefill and chunked-decode kernels' plain versions vs the
JAX package's Pallas kernels (interpret mode, as
tests/test_pallas_attention.py runs them) and its dense references; the
wrappers' CPU dispatch and argument checks. (The int8 and single-step
kernels: tests/test_torch_kv_quant.py, tests/test_torch_single_step.py.)

float32 throughout; tolerance 1e-5 (absolute and relative): the Pallas
kernels sum an online softmax tile by tile, the plain versions in one
softmax. Only live tokens are compared for the prefill (positions no row
owns are zero by contract and checked separately).

``test_kernels_match_plain_on_card`` needs the CUDA card: it is marked
``cuda`` and skips elsewhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swarmdb_tpu.ops import layers as jl
from swarmdb_tpu.ops.paged_kv import paged_gather_kv
from swarmdb_tpu.ops.attention_pallas import (
    paged_decode_gqa_attention_chunked as pallas_decode,
    ragged_paged_prefill_attention as pallas_prefill,
)
from swarmdb_tpu_torch.ops import attention_cuda as ac

TOL = dict(rtol=1e-5, atol=1e-5)
HQ, HKV, D, PS = 4, 2, 16, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the other test workers' timing checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: Rows per wave of _prefill_case: (starts, lens, prefix_lens, width).
PREFILL_ROWS = {
    # rows with and without prefix pages
    "prefix": ([0, 7, 20, 0], [7, 13, 12, 0], [16, 0, 8, 0], 32),
    # a dead row between live ones
    "dead": ([0, 10, 10, 0], [10, 0, 22, 0], [5, 0, 0, 0], 32),
    # the tail of a prompt whose head an earlier wave wrote: prefix_len not
    # page-aligned, the row runs to the end of the stream
    "split": ([0, 3, 0, 0], [3, 29, 0, 0], [0, 21, 0, 0], 32),
    # single-token rows, with and without prefix, most positions unowned
    "single": ([0, 1, 2, 3], [1, 1, 1, 1], [0, 5, 8, 19], 32),
    # a row one token past a query tile of the tensor-core body (64 // G =
    # 32 tokens at G 2), then a short row; W not a multiple of the tile
    "tile_plus_one": ([0, 33, 0, 0], [33, 6, 0, 0], [12, 0, 0, 0], 40),
    # prefixes ending mid-page (page size 8)
    "mid_page": ([0, 9, 0, 0], [9, 20, 0, 0], [13, 29, 0, 0], 32),
}


def _prefill_case(seed, case):
    """A wave over 4 rows of the pool's 13 pages (``PREFILL_ROWS``)."""
    rng = np.random.default_rng(seed)
    starts, lens, plens, W = PREFILL_ROWS[case]
    P = 13
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, sk, sv = f(W, HQ, D), f(W, HKV, D), f(W, HKV, D)
    kp, vp = f(P, PS, HKV, D), f(P, PS, HKV, D)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12],
                       [0, 0, 0, 0]], np.int32)
    return (q, sk, sv, kp, vp, tables, np.array(starts, np.int32),
            np.array(lens, np.int32), np.array(plens, np.int32))


def _owned(W, starts, lens):
    own = np.zeros(W, bool)
    row = np.full(W, len(starts), np.int32)
    for r, (s, n) in enumerate(zip(starts, lens)):
        own[s:s + n] = True
        row[s:s + n] = r
    return own, row


@pytest.mark.parametrize("case", list(PREFILL_ROWS))
@pytest.mark.parametrize("window", [None, 7, 1])
def test_prefill_plain_matches_pallas_and_reference(case, window):
    args = _prefill_case(0, case)
    q, starts, lens = args[0], args[6], args[7]
    own, tok_row = _owned(q.shape[0], starts, lens)
    t = ac.ragged_prefill_plain(*map(torch.from_numpy, args),
                                window=window).numpy()
    k = np.asarray(pallas_prefill(*map(jnp.asarray, args), window=window,
                                  interpret=True))
    ref = np.asarray(jl.ragged_prefill_attention_reference(
        *map(jnp.asarray, args + (tok_row,)), window=window))
    np.testing.assert_allclose(t[own], k[own], **TOL)
    np.testing.assert_allclose(t[own], ref[own], **TOL)
    assert not t[~own].any()          # unowned positions stay zero
    np.testing.assert_array_equal(k[~own], t[~own])


def _decode_case(seed):
    rng = np.random.default_rng(seed)
    B, P, maxp, Kc = 4, 14, 4, 4
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q = f(B, HQ, D)
    kp, vp = f(P, PS, HKV, D), f(P, PS, HKV, D)
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 10],
                      [11, 0, 0, 0]], np.int32)
    ck, cv = f(B, Kc, HKV, D), f(B, Kc, HKV, D)
    starts = np.array([17, 9, 30, 0], np.int32)   # mixed, one empty prefix
    return q, kp, vp, table, ck, cv, starts


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("window", [None, 6])
def test_decode_plain_matches_pallas_and_reference(step, window):
    q, kp, vp, table, ck, cv, starts = _decode_case(1)
    t = ac.paged_decode_chunked_plain(
        *map(torch.from_numpy, (q, kp, vp, table, ck, cv, starts)), step,
        window=window).numpy()
    k = np.asarray(pallas_decode(*map(jnp.asarray, (q, kp, vp, table, ck, cv,
                                                     starts)),
                                 jnp.int32(step), window=window,
                                 interpret=True))
    kg, vg = paged_gather_kv(jnp.asarray(kp), jnp.asarray(vp),
                             jnp.asarray(table))
    ref = np.asarray(jl.gqa_attention_chunked(
        jnp.asarray(q)[:, None], kg, vg, jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(starts + step)[:, None], jnp.int32(step),
        window=window))[:, 0]
    np.testing.assert_allclose(t, k, **TOL)
    np.testing.assert_allclose(t, ref, **TOL)


def test_wrappers_run_plain_on_cpu_and_count_no_launch():
    ac.reset_launches()
    args = _prefill_case(2, "prefix")
    out = ac.ragged_paged_prefill_attention(*map(torch.from_numpy, args))
    plain = ac.ragged_prefill_plain(*map(torch.from_numpy, args))
    assert torch.equal(out, plain)
    d = _decode_case(3)
    out = ac.paged_decode_gqa_attention_chunked(
        *map(torch.from_numpy, d), 2)
    plain = ac.paged_decode_chunked_plain(*map(torch.from_numpy, d), 2)
    assert torch.equal(out, plain)
    assert set(ac.LAUNCHES) == {
        "ragged_prefill", "paged_decode_chunked", "paged_decode",
        "ragged_prefill_quant", "paged_decode_chunked_quant",
        "paged_decode_quant", "dense_decode_chunked", "dense_decode"}
    assert not any(ac.LAUNCHES.values())


def test_wrappers_check_arguments():
    args = list(map(torch.from_numpy, _prefill_case(4, "prefix")))
    bad_dtype = list(args)
    bad_dtype[1] = bad_dtype[1].double()
    with pytest.raises(ValueError, match="float32 or bfloat16|expected"):
        ac.ragged_paged_prefill_attention(*bad_dtype)
    bad_idx = list(args)
    bad_idx[6] = bad_idx[6].long()
    with pytest.raises(ValueError, match="int32"):
        ac.ragged_paged_prefill_attention(*bad_idx)
    strided = list(args)
    strided[0] = torch.from_numpy(np.asfortranarray(args[0].numpy()))
    with pytest.raises(ValueError, match="contiguous"):
        ac.ragged_paged_prefill_attention(*strided)
    d = list(map(torch.from_numpy, _decode_case(5)))
    with pytest.raises(ValueError, match="step"):
        ac.paged_decode_gqa_attention_chunked(*d, 4)
    short = list(d)
    short[6] = short[6][:2]
    with pytest.raises(ValueError, match="slots"):
        ac.paged_decode_gqa_attention_chunked(*short, 0)


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
def test_kernels_match_plain_on_card(cuda_device, qdt, pdt, tol):
    """Each kernel against its plain version on the same card tensors, the
    query in ``qdt`` and the pages, suffix and chunk buffer in ``pdt``:
    f32 within 1e-4, else 2e-2 (the plain version rounds the softmax
    weights to bf16 before the value product, the kernel keeps them in
    fp32). The output comes back in the query's dtype."""
    for case in ("prefix", "dead", "split"):
        for window in (None, 7):
            args = [torch.from_numpy(a).to(cuda_device)
                    for a in _prefill_case(6, case)]
            args[0] = args[0].to(qdt)
            args[1:5] = [a.to(pdt) for a in args[1:5]]
            got = ac.ragged_paged_prefill_attention(*args, window=window)
            want = ac.ragged_prefill_plain(*args, window=window)
            torch.cuda.synchronize()
            assert got.dtype == qdt
            assert (got.float() - want.float()).abs().max().item() <= tol
    d = [torch.from_numpy(a).to(cuda_device) for a in _decode_case(7)]
    d[0] = d[0].to(qdt)
    for i in (1, 2, 4, 5):
        d[i] = d[i].to(pdt)
    for step in (0, 3):
        for window in (None, 6):
            got = ac.paged_decode_gqa_attention_chunked(*d, step,
                                                        window=window)
            want = ac.paged_decode_chunked_plain(*d, step, window=window)
            torch.cuda.synchronize()
            assert got.dtype == qdt
            assert (got.float() - want.float()).abs().max().item() <= tol
