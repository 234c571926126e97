"""PyTorch port vs JAX reference: the Llama forwards split over a model
axis of two ranks (tensor parallelism), and a sharded checkpoint.

The JAX side is ``swarmdb_tpu.parallel.serving.build_sharded_model`` over
a mesh of two CPU devices (``data=1, model=2``), float32 weights: its
bucketed prefill (``forward`` with the head at each row's last token),
then ``forward_chunked`` for a chunk of steps and ``merge_chunk``, over a
float32 slot cache and chunk buffer. The port's side is two gloo
processes (``tests/torch_pod_child.py``), each holding its share of the
same weights (``params_from_numpy(shardings=)``) and running the port's
own forwards with the collectives of ``parallel/collectives.py``: every
rank's logits within 1e-4 of the JAX mesh's (float32: the row-split sums
change only the order of additions), each rank's slot cache equal to
its KV heads' slice of the JAX cache within the same bound, and each
rank's ``wq`` share [L, D, Hq * hd / 2]. The two processes run once for
the module (``pod`` fixture); each test reads its part.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from swarmdb_tpu.parallel.serving import build_sharded_model
from swarmdb_tpu_torch.utils.checkpoint import save_params
from swarmdb_tpu_torch.utils.convert import params_from_numpy
from torch_pod_child import params_npz, run_pod

CFG = get_config("tiny-debug")
B, T, S, K = 3, 16, 64, 4
TOL = 1e-4


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """The JAX mesh's outputs and the two ranks' on the same inputs."""
    tmp = tmp_path_factory.mktemp("tp")
    mesh = jax_make_mesh(devices=jax.devices()[:2], data=1, model=2,
                         expert=1)
    sm = build_sharded_model(CFG, mesh, seed=0, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, sm.params)
    rng = np.random.default_rng(0)
    lengths = np.asarray([16, 9, 3], np.int32)
    tokens = np.zeros((B, T), np.int32)
    for r, n in enumerate(lengths):
        tokens[r, :n] = rng.integers(3, CFG.vocab_size, n)
    feed = rng.integers(3, CFG.vocab_size, (B, K)).astype(np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))

    # JAX: the prefill over a float32 temp cache, its head at each row's
    # last token; then the slot cache, a chunk of steps, the merge
    temp = jl.init_kv_cache(CFG, B, T, jnp.float32)
    logits, temp = sm.forward_fn(sm.params, jnp.asarray(tokens),
                                 jnp.asarray(positions), temp)
    want = {"prefill_logits": np.asarray(logits)[np.arange(B),
                                                 lengths - 1]}
    cache = jl.init_kv_cache(CFG, B, S, jnp.float32)
    cache = tuple(c.at[:, :, :T].set(t) for c, t in zip(cache, temp))
    chunk_fwd, _init, merge = sm.chunked_fns
    ckv = jl.init_chunk_kv(CFG, B, K, jnp.float32)
    steps = []
    for s in range(K):
        lg, ckv = chunk_fwd(sm.params, jnp.asarray(feed[:, s:s + 1]),
                            jnp.asarray(lengths + s)[:, None], cache, ckv,
                            jnp.int32(s))
        steps.append(np.asarray(lg)[:, 0])
    want["chunk_logits"] = np.stack(steps)
    cache = merge(cache, ckv, jnp.asarray(lengths))
    want["cache_k"], want["cache_v"] = (np.asarray(c) for c in cache)

    ckpt = save_params(params_from_numpy(params, "cpu"),
                       str(tmp / "ckpt.pt"))
    got, codes, logs = run_pod("forward", tmp, dict(
        params_npz(params), tokens=tokens, lengths=lengths, feed=feed,
        max_seq=S, chunk=K, ckpt=ckpt))
    assert codes == [0, 0], logs
    return want, got


def test_each_rank_holds_its_share_of_wq(pod):
    _want, got = pod
    L, D = CFG.n_layers, CFG.dim
    for rank in got:
        assert rank["wq_shape"].tolist() == [
            L, D, CFG.n_heads * CFG.head_dim // 2]


@pytest.mark.parametrize("key", ["prefill_logits", "chunk_logits"])
def test_logits_match_the_jax_mesh(pod, key):
    """Both ranks hold the full logits (the vocab shares gathered), equal
    to each other and within 1e-4 of the JAX mesh's."""
    want, got = pod
    for rank in got:
        assert rank[key].shape == want[key].shape
        np.testing.assert_allclose(rank[key], want[key], atol=TOL, rtol=0)
    np.testing.assert_array_equal(got[0][key], got[1][key])


@pytest.mark.parametrize("key", ["cache_k", "cache_v"])
def test_merged_cache_holds_each_ranks_kv_heads(pod, key):
    """After the prefill and a merged chunk, rank r's slot cache is the
    JAX cache's KV heads [r * Hkv / 2, (r + 1) * Hkv / 2)."""
    want, got = pod
    h = CFG.n_kv_heads // 2
    for r, rank in enumerate(got):
        np.testing.assert_allclose(rank[key],
                                   want[key][:, :, :, r * h:(r + 1) * h],
                                   atol=TOL, rtol=0)


def test_collectives_per_forward(pod):
    """Per forward: the embedding's sum, one sum after wo and one after
    w_down per layer, the logits' gather -- 2L + 2 -- for the prefill and
    each chunk step."""
    _want, got = pod
    per = 2 * CFG.n_layers + 2
    for rank in got:
        assert int(rank["collectives"]) == per * (1 + K)


def test_sharded_checkpoint_restores_bit_equal_slices(pod):
    """``restore_params(shardings=(plan, mesh))`` on each rank equals the
    rank's slices of the whole checkpoint, bit for bit."""
    _want, got = pod
    assert [bool(r["ckpt_equal"]) for r in got] == [True, True]
