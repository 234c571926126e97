"""PyTorch port vs JAX reference: the Llama forwards of the paged serving
path, with the JAX package's weights carried over by
``swarmdb_tpu_torch.utils.convert.params_from_numpy``.

tiny-debug in float32 with a float32 pool, on the CPU (the port's
attention runs its plain versions there; the JAX package runs its dense
references). Tolerance: 1e-4 absolute and relative on logits and K/V (two
layers of float32 matmuls summed in another order).
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


def _pool(seed):
    rng = np.random.default_rng(seed)
    shape = (CFG.n_layers, P, PS, CFG.n_kv_heads, CFG.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_init_params_layout_matches(params):
    jp, _ = params
    tp = tl.init_params(CFG, seed=0, device="cpu", dtype=torch.float32)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        assert tuple(flat_t[jax.tree_util.keystr(path)].shape) == leaf.shape
    again = tl.init_params(CFG, seed=0, device="cpu", dtype=torch.float32)
    assert torch.equal(tp["layers"]["wq"], again["layers"]["wq"])


def test_forward_ragged_prefill(params):
    """One wave: a row over prefix pages, a fresh row, a split row (its
    head already in its pages), a dead row, and padding at the end."""
    jp, tp = params
    rng = np.random.default_rng(1)
    W, R = 48, 4
    kpool, vpool = _pool(2)
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
    jl_, jk, jv = jl.forward_ragged_prefill(
        jp, CFG, *map(jnp.asarray, args), jnp.asarray(kpool),
        jnp.asarray(vpool))
    tl_, tk, tv = tl.forward_ragged_prefill(
        tp, CFG, *map(torch.from_numpy, args), torch.from_numpy(kpool),
        torch.from_numpy(vpool))
    live = lens > 0
    np.testing.assert_allclose(np.asarray(jl_)[live], tl_.numpy()[live],
                               **TOL)
    own = tok_row < R
    np.testing.assert_allclose(np.asarray(jk)[:, own], tk.numpy()[:, own],
                               **TOL)
    np.testing.assert_allclose(np.asarray(jv)[:, own], tv.numpy()[:, own],
                               **TOL)


def test_forward_paged_chunked_and_merge(params):
    jp, tp = params
    rng = np.random.default_rng(4)
    B, Kc, step = 3, 4, 2
    kpool, vpool = _pool(5)
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 10]], np.int32)
    positions = np.array([[21], [9], [40]], np.int32)
    tokens = rng.integers(3, CFG.vocab_size, (B, 1)).astype(np.int32)
    shape = (CFG.n_layers, B, Kc, CFG.n_kv_heads, CFG.head_dim)
    hk = rng.standard_normal(shape).astype(np.float32)
    hv = rng.standard_normal(shape).astype(np.float32)
    jcache = {"k": jnp.asarray(kpool), "v": jnp.asarray(vpool),
              "page_table": jnp.asarray(table)}
    tcache = {"k": torch.from_numpy(kpool.copy()),
              "v": torch.from_numpy(vpool.copy()),
              "page_table": torch.from_numpy(table)}
    jlog, (jhk, jhv) = jl.forward_paged_chunked(
        jp, CFG, jnp.asarray(tokens), jnp.asarray(positions), jcache,
        (jnp.asarray(hk), jnp.asarray(hv)), jnp.int32(step))
    tlog, (thk, thv) = tl.forward_paged_chunked(
        tp, CFG, torch.from_numpy(tokens), torch.from_numpy(positions),
        tcache, (torch.from_numpy(hk.copy()), torch.from_numpy(hv.copy())),
        step)
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jhk), thk.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jhv), thv.numpy(), **TOL)
    starts = positions[:, 0] - step
    jm = jl.merge_paged_chunk(jcache, (jhk, jhv), jnp.asarray(starts))
    tm = tl.merge_paged_chunk(tcache, (thk, thv), torch.from_numpy(starts))
    # page 0 (trash) absorbs out-of-coverage writes in either order
    np.testing.assert_allclose(np.asarray(jm["k"])[:, 1:],
                               tm["k"].numpy()[:, 1:], **TOL)
    np.testing.assert_allclose(np.asarray(jm["v"])[:, 1:],
                               tm["v"].numpy()[:, 1:], **TOL)
