"""The dense slot cache's decode kernels (Pallas kernels 7 and 8): the
port's plain versions against the JAX package's Pallas kernels in
interpret mode (as tests/test_pallas_attention.py runs them) and against
its einsum forms; the wrappers' CPU dispatch, the dispatch of
``layers.gqa_attention`` / ``gqa_attention_chunked``, and the argument
checks.

float32 throughout; tolerance 1e-5 (absolute and relative): the Pallas
kernels sum an online softmax tile by tile, the plain versions in one
softmax. Lengths are >= 1: with length 0 the Pallas kernel 8 returns the
lane's mean value row and the port's kernel zeros (no caller passes 0).

``test_dense_kernels_match_plain_on_card`` needs the CUDA card: it is
marked ``cuda`` and skips elsewhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swarmdb_tpu.ops import layers as jly
from swarmdb_tpu.ops.attention_pallas import (
    decode_gqa_attention as pallas_decode,
    decode_gqa_attention_chunked as pallas_chunked,
)
from swarmdb_tpu_torch.ops import attention_cuda as ac
from swarmdb_tpu_torch.ops import layers as tly

TOL = dict(rtol=1e-5, atol=1e-5)
HKV, D, S, KC = 2, 16, 32, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the other test workers' timing checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lanes(rng, B, G):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, HKV * G, D), f(B, S, HKV, D), f(B, S, HKV, D)


def _single_case(seed, G):
    """Four slots: length 1, a length crossing a 16-row tile, the whole
    lane, and a mid-lane one."""
    rng = np.random.default_rng(seed)
    q, ck, cv = _lanes(rng, 4, G)
    return q, ck, cv, np.array([1, 17, S, 9], np.int32)


def _chunk_case(seed, G):
    """Starts from 0 to S - Kc; the chunk buffer full of draws (entries
    past ``step`` must not count)."""
    rng = np.random.default_rng(seed)
    q, ck, cv = _lanes(rng, 4, G)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    starts = np.array([0, 13, S - KC, 20], np.int32)
    return q, ck, cv, f(4, KC, HKV, D), f(4, KC, HKV, D), starts


@pytest.mark.parametrize("G", [1, 2])
def test_decode_plain_matches_pallas_and_reference(G):
    q, ck, cv, lengths = _single_case(1, G)
    t = ac.decode_plain(*map(torch.from_numpy, (q, ck, cv, lengths))).numpy()
    k = np.asarray(pallas_decode(*map(jnp.asarray, (q, ck, cv, lengths)),
                                 interpret=True))
    ref = np.asarray(jly.gqa_attention(
        *map(jnp.asarray, (q[:, None], ck, cv, (lengths - 1)[:, None]))))
    np.testing.assert_allclose(t, k, **TOL)
    np.testing.assert_allclose(t, ref[:, 0], **TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_decode_plain_windowed_matches_reference(G):
    """The port's kernel takes a window (the Pallas kernel 8 does not):
    against the JAX package's windowed einsum form."""
    q, ck, cv, lengths = _single_case(2, G)
    t = ac.decode_plain(*map(torch.from_numpy, (q, ck, cv, lengths)),
                        window=6).numpy()
    ref = np.asarray(jly.gqa_attention(
        *map(jnp.asarray, (q[:, None], ck, cv, (lengths - 1)[:, None])),
        window=6))
    np.testing.assert_allclose(t, ref[:, 0], **TOL)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("step", [0, 2, KC - 1])
@pytest.mark.parametrize("window", [None, 6])
def test_decode_chunked_plain_matches_pallas_and_reference(G, step, window):
    """Pallas kernel 7 with a tile of 8 (S % tile == 0): the frozen lane
    below each slot's start plus the chunk entries <= step."""
    q, ck, cv, hk, hv, starts = _chunk_case(3, G)
    t = ac.decode_chunked_plain(
        *map(torch.from_numpy, (q, ck, cv, hk, hv, starts)), step,
        window=window).numpy()
    k = np.asarray(pallas_chunked(
        *map(jnp.asarray, (q, ck, cv, hk, hv, starts)), jnp.int32(step),
        window=window, tile=8, interpret=True))
    ref = np.asarray(jly.gqa_attention_chunked(
        *map(jnp.asarray, (q[:, None], ck, cv, hk, hv,
                           (starts + step)[:, None])),
        jnp.int32(step), window=window))
    np.testing.assert_allclose(t, k, **TOL)
    np.testing.assert_allclose(t, ref[:, 0], **TOL)


def test_plain_versions_never_read_past_the_live_range():
    """Lane entries at or past each slot's start (a bucketed prefill's
    padding garbage) and chunk entries past ``step`` move nothing."""
    q, ck, cv, hk, hv, starts = map(torch.from_numpy, _chunk_case(4, 2))
    out = ac.decode_chunked_plain(q, ck, cv, hk, hv, starts, 1)
    ck2, cv2, hk2, hv2 = ck.clone(), cv.clone(), hk.clone(), hv.clone()
    for b, s in enumerate(starts.tolist()):
        ck2[b, s:], cv2[b, s:] = 1e6, -1e6
    hk2[:, 2:], hv2[:, 2:] = 1e6, -1e6
    again = ac.decode_chunked_plain(q, ck2, cv2, hk2, hv2, starts, 1)
    torch.testing.assert_close(out, again, **TOL)
    q, ck, cv, lengths = map(torch.from_numpy, _single_case(5, 2))
    out = ac.decode_plain(q, ck, cv, lengths)
    for b, n in enumerate(lengths.tolist()):
        ck[b, n:], cv[b, n:] = 1e6, -1e6
    torch.testing.assert_close(out, ac.decode_plain(q, ck, cv, lengths),
                               **TOL)


def test_wrappers_and_dispatch_run_plain_on_cpu():
    """On CPU tensors the wrappers are their plain versions and launch
    nothing; ``layers.gqa_attention`` sends T == 1 to the single-step
    wrapper (T > 1 stays the einsum form) and ``gqa_attention_chunked``
    to the two-segment one."""
    ac.reset_launches()
    q, ck, cv, lengths = map(torch.from_numpy, _single_case(6, 2))
    out = ac.decode_gqa_attention(q, ck, cv, lengths, window=5)
    assert torch.equal(out, ac.decode_plain(q, ck, cv, lengths, window=5))
    via = tly.gqa_attention(q[:, None], ck, cv, (lengths - 1)[:, None],
                            window=5)
    assert torch.equal(via[:, 0], out)
    c = list(map(torch.from_numpy, _chunk_case(7, 2)))
    out = ac.decode_gqa_attention_chunked(*c, 3)
    assert torch.equal(out, ac.decode_chunked_plain(*c, 3))
    via = tly.gqa_attention_chunked(c[0][:, None], *c[1:5],
                                    (c[5] + 3)[:, None], 3)
    assert torch.equal(via[:, 0], out)
    assert not any(ac.LAUNCHES.values())


def test_dense_wrappers_check_arguments():
    q, ck, cv, lengths = map(torch.from_numpy, _single_case(8, 2))
    with pytest.raises(ValueError, match="int32"):
        ac.decode_gqa_attention(q, ck, cv, lengths.long())
    with pytest.raises(ValueError, match="differ in dtype"):
        ac.decode_gqa_attention(q, ck, cv.double(), lengths)
    with pytest.raises(ValueError, match="slots"):
        ac.decode_gqa_attention(q, ck, cv, lengths[:2])
    with pytest.raises(ValueError, match="alike"):
        ac.decode_gqa_attention(q, ck, cv[:, :8].contiguous(), lengths)
    c = list(map(torch.from_numpy, _chunk_case(9, 2)))
    with pytest.raises(ValueError, match="step"):
        ac.decode_gqa_attention_chunked(*c, KC)
    strided = list(c)
    strided[1] = c[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ac.decode_gqa_attention_chunked(*strided, 0)
    with pytest.raises(ValueError, match="chunk buffers"):
        ac.decode_gqa_attention_chunked(*c[:3], c[3][:, :2].contiguous(),
                                        *c[4:], 0)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,cdt,tol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.float32, torch.bfloat16, 2e-2)])
def test_dense_kernels_match_plain_on_card(cuda_device, qdt, cdt, tol):
    """Kernels 7 and 8 against their plain versions on the same card
    tensors, the query in ``qdt`` and the lanes and chunk buffer in
    ``cdt``: f32 within 1e-4, else 2e-2 (the plain version rounds the
    softmax weights to bf16 before the value product, the kernel keeps
    them in fp32). The output comes back in the query's dtype."""
    for G in (1, 2):
        q, ck, cv, lengths = [torch.from_numpy(a).to(cuda_device)
                              for a in _single_case(10, G)]
        q, ck, cv = q.to(qdt), ck.to(cdt), cv.to(cdt)
        for window in (None, 6):
            got = ac.decode_gqa_attention(q, ck, cv, lengths, window=window)
            want = ac.decode_plain(q, ck, cv, lengths, window=window)
            torch.cuda.synchronize()
            assert got.dtype == qdt
            assert (got.float() - want.float()).abs().max().item() <= tol
        c = [torch.from_numpy(a).to(cuda_device) for a in _chunk_case(11, G)]
        c[0] = c[0].to(qdt)
        c[1:5] = [a.to(cdt) for a in c[1:5]]
        for step in (0, KC - 1):
            for window in (None, 6):
                got = ac.decode_gqa_attention_chunked(*c, step,
                                                      window=window)
                want = ac.decode_chunked_plain(*c, step, window=window)
                torch.cuda.synchronize()
                assert got.dtype == qdt
                assert (got.float() - want.float()).abs().max().item() <= tol
