"""PyTorch port vs JAX reference: token sampling.

Greedy rows and the top-k / top-p filters must pick the same tokens, and a
seeded draw must give the SAME tokens as ``jax.random`` (Threefry-2x32,
``fold_in`` and the Gumbel-max of ``jax.random.categorical`` are ported
bit for bit; the Gumbel noise itself agrees within float32 rounding of the
two logs, 1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend import sampling as js
from swarmdb_tpu_torch.backend import sampling as ts

B, V = 8, 320


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the other test workers' timing checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(logits, keys, pos, temp, topk, topp, **kw):
    j = js.sample_tokens(jnp.asarray(logits), jnp.asarray(keys),
                         jnp.asarray(pos), jnp.asarray(temp),
                         jnp.asarray(topk), jnp.asarray(topp), **kw)
    t = ts.sample_tokens(torch.from_numpy(logits),
                         torch.from_numpy(keys.astype(np.int64)),
                         torch.from_numpy(pos), torch.from_numpy(temp),
                         torch.from_numpy(topk), torch.from_numpy(topp), **kw)
    return np.asarray(j), t.numpy()


def _case(seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((B, V))).astype(np.float32)
    pos = rng.integers(0, 4000, B).astype(np.int32)
    return logits, pos


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_slot_keys_and_fold_in_match(seed):
    keys = np.asarray(js.make_slot_keys(seed, B))
    np.testing.assert_array_equal(keys, ts.make_slot_keys(seed, B))
    data = np.array([0, 1, 77, 2**31 + 5], np.int64)
    j = np.stack([np.asarray(jax.random.fold_in(jnp.asarray(keys[0]), d))
                  for d in data])
    t = ts.fold_in(torch.from_numpy(keys[:1].astype(np.int64)).expand(4, 2),
                   torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(j, t)
    g = np.asarray(jax.random.gumbel(jnp.asarray(keys[1]), (V,)))
    gt = ts.gumbel(torch.from_numpy(keys[1:2].astype(np.int64)), V)[0]
    np.testing.assert_allclose(g, gt.numpy(), rtol=1e-6, atol=1e-6)


def test_greedy_and_filters_match():
    logits, pos = _case(1)
    keys = np.asarray(js.make_slot_keys(0, B))
    zeros = np.zeros(B, np.float32)
    j, t = _both(logits, keys, pos, zeros, np.zeros(B, np.int32),
                 np.ones(B, np.float32))
    np.testing.assert_array_equal(j, t)
    np.testing.assert_array_equal(t, logits.argmax(-1))
    j, t = _both(logits, keys, pos, zeros, np.zeros(B, np.int32),
                 np.ones(B, np.float32), assume_greedy=True)
    np.testing.assert_array_equal(j, t)
    # top-k 1 and a tiny nucleus both collapse sampling onto the argmax
    j, t = _both(logits, keys, pos, np.ones(B, np.float32),
                 np.ones(B, np.int32), np.ones(B, np.float32))
    np.testing.assert_array_equal(t, logits.argmax(-1))
    j, t = _both(logits, keys, pos, np.ones(B, np.float32),
                 np.zeros(B, np.int32), np.full(B, 1e-3, np.float32))
    np.testing.assert_array_equal(t, logits.argmax(-1))
    lj = js.token_logprob(jnp.asarray(logits), jnp.asarray(t))
    lt = ts.token_logprob(torch.from_numpy(logits), torch.from_numpy(t))
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [3, 11, 2024])
@pytest.mark.parametrize("use_filters", [True, False])
def test_seeded_tokens_equal_jax_random(seed, use_filters):
    logits, pos = _case(seed)
    keys = np.asarray(js.make_slot_keys(seed, B)).copy()
    keys[2] = ts.key_from_seed(seed * 1000 + 1)   # a per-request seed row
    temp = np.array([0, .8, 1, 1.3, .5, .8, 2, .7], np.float32)
    topk = np.array([0, 0, 5, 0, 20, 0, 3, 0], np.int32)
    topp = np.array([1, .9, 1, .5, 1, .95, 1, .3], np.float32)
    j, t = _both(logits, keys, pos, temp, topk, topp,
                 use_filters=use_filters)
    np.testing.assert_array_equal(j, t)
