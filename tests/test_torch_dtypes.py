"""PyTorch port vs JAX reference: the attention query and the chunk buffer
keep their own dtype when the pool's differs.

tiny-debug with float32 weights over a bf16 pool. The JAX package attends
with the query in the compute dtype (f32) and promotes the bf16 pages and
chunk buffer to it; the port must do the same, not round the query to the
pool's dtype. Same inputs as ``tests/test_torch_llama.py``; tolerance 1e-4
absolute and relative on the logits (float32 sums in another order). Before
the repair the port's logits were ~0.02 off.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu_torch.models import llama as tl
from swarmdb_tpu_torch.utils.convert import params_from_numpy

CFG = get_config("tiny-debug")
TOL = dict(rtol=1e-4, atol=1e-4)
PS, MAXP, P = 16, 4, 13


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
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jl.init_params(CFG, jax.random.PRNGKey(3)))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _bf16_pools(seed):
    """The same bf16 pool in both packages (f32 draws rounded to nearest
    even on both sides)."""
    rng = np.random.default_rng(seed)
    shape = (CFG.n_layers, P, PS, CFG.n_kv_heads, CFG.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return ((jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)),
            (torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()))


def test_ragged_prefill_f32_weights_bf16_pool(params):
    jp, tp = params
    rng = np.random.default_rng(1)
    W, R = 48, 4
    (jk, jv), (tk, tv) = _bf16_pools(2)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12],
                       [0, 0, 0, 0]], np.int32)
    starts = np.array([0, 10, 0, 30], np.int32)
    lens = np.array([10, 20, 0, 13], np.int32)
    plens = np.array([32, 0, 0, 21], np.int32)
    tokens = rng.integers(3, CFG.vocab_size, W).astype(np.int32)
    tok_row = np.full(W, R, np.int32)
    tok_pos = np.full(W, MAXP * PS, np.int32)
    for r in range(R):
        s, n = starts[r], lens[r]
        tok_row[s:s + n] = r
        tok_pos[s:s + n] = plens[r] + np.arange(n)
    args = (tokens, tok_row, tok_pos, tables, starts, lens, plens)
    jlog, jsk, _ = jl.forward_ragged_prefill(
        jp, CFG, *map(jnp.asarray, args), jk, jv)
    tlog, tsk, _ = tl.forward_ragged_prefill(
        tp, CFG, *map(torch.from_numpy, args), tk, tv)
    assert tsk.dtype == torch.bfloat16      # suffix K/V in the pool dtype
    live = lens > 0
    np.testing.assert_allclose(np.asarray(jlog)[live], tlog.numpy()[live],
                               **TOL)


def test_paged_chunked_f32_weights_bf16_pool(params):
    jp, tp = params
    rng = np.random.default_rng(4)
    B, Kc, step = 3, 4, 2
    (jk, jv), (tk, tv) = _bf16_pools(5)
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 10]], np.int32)
    positions = np.array([[21], [9], [40]], np.int32)
    tokens = rng.integers(3, CFG.vocab_size, (B, 1)).astype(np.int32)
    shape = (CFG.n_layers, B, Kc, CFG.n_kv_heads, CFG.head_dim)
    hk = rng.standard_normal(shape).astype(np.float32)
    hv = rng.standard_normal(shape).astype(np.float32)
    jlog, _ = jl.forward_paged_chunked(
        jp, CFG, jnp.asarray(tokens), jnp.asarray(positions),
        {"k": jk, "v": jv, "page_table": jnp.asarray(table)},
        (jnp.asarray(hk, jnp.bfloat16), jnp.asarray(hv, jnp.bfloat16)),
        jnp.int32(step))
    tlog, _ = tl.forward_paged_chunked(
        tp, CFG, torch.from_numpy(tokens), torch.from_numpy(positions),
        {"k": tk, "v": tv, "page_table": torch.from_numpy(table)},
        (torch.from_numpy(hk).bfloat16(), torch.from_numpy(hv).bfloat16()),
        step)
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
