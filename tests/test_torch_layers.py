"""PyTorch port vs JAX reference: the transformer layer functions.

Inputs are numpy arrays from a seed, fed to ``swarmdb_tpu.ops.layers`` and
to ``swarmdb_tpu_torch.ops.layers`` on the CPU in float32. Tolerance: 1e-5
absolute and relative (float32 sums taken in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swarmdb_tpu.ops import layers as jl
from swarmdb_tpu_torch.ops import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the other test workers' timing checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(j, t, **tol):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), **(tol or TOL))


def test_rms_norm():
    rng = _rng(0)
    x, w = _f32(rng, 2, 5, 32), _f32(rng, 32)
    _close(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5),
           tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5))


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope(theta):
    rng = _rng(1)
    pos = rng.integers(0, 900, size=(2, 7)).astype(np.int32)
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), 16, theta)
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), 16, theta)
    _close(jc, tc)
    _close(js, ts)
    x = _f32(rng, 2, 7, 4, 16)
    _close(jl.apply_rope(jnp.asarray(x), jc, js),
           tl.apply_rope(torch.from_numpy(x), tc, ts))


def test_qkv_proj_and_swiglu():
    rng = _rng(2)
    L, dim, Hq, Hkv, D, F = 2, 32, 4, 2, 8, 48
    lp = {"wq": _f32(rng, L, dim, Hq * D), "wk": _f32(rng, L, dim, Hkv * D),
          "wv": _f32(rng, L, dim, Hkv * D)}
    h = _f32(rng, 1, 6, dim)
    pos = np.arange(6, dtype=np.int32)[None]
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), D, 10_000.0)
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), D, 10_000.0)
    t_lp = {k: torch.from_numpy(v) for k, v in lp.items()}
    for l in range(L):
        jq = jl.qkv_proj(jnp.asarray(h), {k: jnp.asarray(v[l])
                                          for k, v in lp.items()},
                         Hq, Hkv, D, jc, js)
        tq = tl.qkv_proj(torch.from_numpy(h), t_lp, l, Hq, Hkv, D, tc, ts)
        for a, b in zip(jq, tq):
            _close(a, b, rtol=1e-4, atol=1e-4)
    wg, wu, wd = _f32(rng, dim, F), _f32(rng, dim, F), _f32(rng, F, dim)
    _close(jl.swiglu(*map(jnp.asarray, (h, wg, wu, wd))),
           tl.swiglu(*map(torch.from_numpy, (h, wg, wu, wd))),
           rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("window", [None, 5])
def test_gqa_attention_chunked(window):
    rng = _rng(3)
    B, S, Kc, Hq, Hkv, D = 3, 24, 4, 4, 2, 16
    q = _f32(rng, B, 1, Hq, D)
    ck, cv = _f32(rng, B, S, Hkv, D), _f32(rng, B, S, Hkv, D)
    hk, hv = _f32(rng, B, Kc, Hkv, D), _f32(rng, B, Kc, Hkv, D)
    step = 2
    qpos = np.array([[5], [step], [20]], np.int32)
    j = jl.gqa_attention_chunked(*map(jnp.asarray, (q, ck, cv, hk, hv, qpos)),
                                 jnp.int32(step), window=window)
    t = tl.gqa_attention_chunked(*map(torch.from_numpy,
                                      (q, ck, cv, hk, hv, qpos)),
                                 step, window=window)
    _close(j, t)


@pytest.mark.parametrize("window", [None, 6])
def test_ragged_prefill_reference(window):
    """Rows: a prefix row, a fresh row, a dead row; padding at the end."""
    rng = _rng(4)
    W, Hq, Hkv, D, P, ps, maxp = 24, 4, 2, 16, 9, 8, 3
    q = _f32(rng, W, Hq, D)
    sk, sv = _f32(rng, W, Hkv, D), _f32(rng, W, Hkv, D)
    kp, vp = _f32(rng, P, ps, Hkv, D), _f32(rng, P, ps, Hkv, D)
    tables = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
    starts = np.array([0, 9, 20], np.int32)
    lens = np.array([9, 11, 0], np.int32)
    plens = np.array([10, 0, 0], np.int32)
    tok_row = np.full(W, 3, np.int32)
    tok_row[0:9], tok_row[9:20] = 0, 1
    args = (q, sk, sv, kp, vp, tables, starts, lens, plens, tok_row)
    j = np.asarray(jl.ragged_prefill_attention_reference(
        *map(jnp.asarray, args), window=window))
    t = tl.ragged_prefill_attention_reference(
        *map(torch.from_numpy, args), window=window).numpy()
    live = tok_row < 3   # padding rows are garbage by contract
    np.testing.assert_allclose(j[live], t[live], **TOL)
