"""PyTorch port vs JAX reference: the dense single program over a data
axis, alone (data 2) and with a model axis (data 2 x model 2).

The JAX side is ``swarmdb_tpu.parallel.serving.build_sharded_model`` over
a mesh of CPU devices of the same shape, float32 weights: its bucketed
prefill (``forward`` with the head at each row's last token), then
``forward_chunked`` for a chunk of steps and ``merge_chunk``, over a
float32 slot cache and chunk buffer. The port's side is one gloo process
per rank (``tests/torch_pod_child.py``): each holds its model-axis share
of the same weights and runs the rows of its data shard, so every rank's
logits are its rows of the JAX mesh's, within 1e-4 (float32: the row-split
sums change only the order of additions), and its slot cache is its rows
and KV heads of the JAX cache.

The dense engine over data 2 and over data 2 x model 2: greedy
``generate_sync`` on the pod gives the port's single dense engine's tokens
exactly, each data group holding two of the four slots, and every rank
reads the same gathered token block in every chunk.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from swarmdb_tpu.parallel.serving import build_sharded_model
from swarmdb_tpu_torch.backend import service as tsvc
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.utils.checkpoint import save_params
from swarmdb_tpu_torch.utils.convert import params_from_numpy
from torch_pod_child import params_npz, run_pod

CFG = get_config("tiny-debug")
B, T, S, K = 4, 16, 64, 4
TOL = 1e-4
MESHES = [(2, 1), (2, 2)]


@pytest.fixture(scope="module", params=MESHES,
                ids=[f"data{d}_model{m}" for d, m in MESHES])
def pod(request, tmp_path_factory):
    """The JAX mesh's outputs and every rank's, on the same inputs."""
    data, model = request.param
    tmp = tmp_path_factory.mktemp(f"dp{data}x{model}")
    mesh = jax_make_mesh(devices=jax.devices()[:data * model], data=data,
                         model=model, expert=1)
    sm = build_sharded_model(CFG, mesh, seed=0, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, sm.params)
    rng = np.random.default_rng(1)
    lengths = np.asarray([16, 9, 3, 12], np.int32)
    tokens = np.zeros((B, T), np.int32)
    for r, n in enumerate(lengths):
        tokens[r, :n] = rng.integers(3, CFG.vocab_size, n)
    feed = rng.integers(3, CFG.vocab_size, (B, K)).astype(np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))

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
        max_seq=S, chunk=K, ckpt=ckpt, data=data), world=data * model)
    assert codes == [0] * (data * model), logs
    return data, model, want, got


def _coords(rank: int, model: int):
    """(data index, model index) of a rank: ranks are row-major over
    (data, model), as the JAX package reshapes its device list."""
    return rank // model, rank % model


@pytest.mark.parametrize("key", ["prefill_logits", "chunk_logits"])
def test_each_rank_has_its_rows_of_the_jax_logits(pod, key):
    data, model, want, got = pod
    n = B // data
    for rank, out in enumerate(got):
        d, _m = _coords(rank, model)
        rows = want[key][..., d * n:(d + 1) * n, :]
        assert out[key].shape == rows.shape
        np.testing.assert_allclose(out[key], rows, atol=TOL, rtol=0)


@pytest.mark.parametrize("key", ["cache_k", "cache_v"])
def test_merged_cache_holds_each_ranks_rows_and_heads(pod, key):
    """After the prefill and a merged chunk, rank (d, m)'s slot cache is
    the JAX cache's rows [d * B/dp, (d + 1) * B/dp) and KV heads
    [m * Hkv/mp, (m + 1) * Hkv/mp)."""
    data, model, want, got = pod
    n, h = B // data, CFG.n_kv_heads // model
    for rank, out in enumerate(got):
        d, m = _coords(rank, model)
        np.testing.assert_allclose(
            out[key], want[key][:, d * n:(d + 1) * n, :, m * h:(m + 1) * h],
            atol=TOL, rtol=0)


def test_collectives_stay_inside_the_model_group(pod):
    """A data axis adds no collective to a forward: 2L + 2 per forward on
    a model axis of two, none on a model axis of one."""
    _data, model, _want, got = pod
    per = 2 * CFG.n_layers + 2 if model > 1 else 0
    for out in got:
        assert int(out["collectives"]) == per * (1 + K)


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(3, 259, n).astype(np.int32) for n in (7, 21, 12)]


@pytest.mark.parametrize("data,model", MESHES,
                         ids=[f"data{d}_model{m}" for d, m in MESHES])
def test_dense_pod_over_a_data_axis_equals_the_single_engine(
        tmp_path, monkeypatch, data, model):
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jl.init_params(CFG, jax.random.PRNGKey(0)))
    prompts, new, max_batch = _prompts(), 10, 4
    inputs = dict(params_npz(params), data=data, paged=False,
                  max_batch=max_batch, max_seq=S, chunk=K, page_size=16,
                  new=new, n_prompts=len(prompts), scenario="serial",
                  **{f"prompt{i}": p for i, p in enumerate(prompts)})
    got, codes, logs = run_pod("dp", tmp_path, inputs, world=data * model)
    assert codes == [0] * (data * model), logs
    coord = got[0]
    pod = [coord[f"tokens{i}"].tolist() for i in range(len(prompts))]
    # the port's single dense engine, without its prefix cache (the pod's
    # engine has none, as the JAX package's sharded engine)
    monkeypatch.setenv("SWARMDB_PREFIX", "0")
    eng, _ = tsvc.build_backend_engine(
        "tiny-debug", max_batch=max_batch, max_seq=S, decode_chunk=K,
        device="cpu", paged=False, params=params_from_numpy(params, "cpu"))
    eng.start()
    try:
        single = [eng.generate_sync(p.tolist(), TSP(max_new_tokens=new))[0]
                  for p in prompts]
    finally:
        eng.stop()
    assert pod == single
    assert all(len(t) == new for t in pod)
    assert coord["blocks"].shape[1:] == (K + 1, max_batch)
    for rank in got:
        np.testing.assert_array_equal(coord["blocks"], rank["blocks"])
        assert int(rank["local_rows"]) == max_batch // data
        assert int(rank["paged_shards"]) == 1


def test_cache_plan_splits_slots_over_data_and_heads_over_model():
    """The slot cache's plan names the JAX ``cache_specs``' two sharded
    dims, and rank (d, m) keeps rows d and heads m of a cache under it."""
    import torch

    from swarmdb_tpu_torch.models import llama as tl
    from swarmdb_tpu_torch.parallel.collectives import Axis
    from swarmdb_tpu_torch.parallel.mesh import MESH_AXES, Mesh, shard_leaf

    k_spec, _v = jl.cache_specs("model")
    plan = tl.cache_plan("model", "data")[0]
    assert list(plan) == [(i, ax) for i, ax in enumerate(k_spec) if ax]
    assert tl.cache_plan("model")[0] == (3, "model")
    full = torch.arange(2 * 4 * 3 * 4 * 2).reshape(2, 4, 3, 4, 2)
    shape = {"data": 2, "model": 2, "expert": 1, "pipe": 1}
    for d in range(2):
        for m in range(2):
            coords = {"data": d, "model": m, "expert": 0, "pipe": 0}
            mesh = Mesh(shape, coords, {a: Axis(a, None, shape[a],
                                                coords[a], "cpu")
                                        for a in MESH_AXES}, "cpu")
            got = shard_leaf(full, plan, mesh)
            assert torch.equal(got, full[:, 2 * d:2 * d + 2, :,
                                         2 * m:2 * m + 2])
