"""PyTorch port vs JAX reference: Mixtral (tiny-moe) on the single program
over model, expert and data axes.

The JAX side is ``swarmdb_tpu.parallel.serving.build_sharded_model`` over
a mesh of CPU devices of the same shape, float32 weights: its bucketed
prefill (``forward`` with the head at each row's last token), then
``forward_chunked`` for a chunk of steps and ``merge_chunk``. GSPMD runs
every call as one program over the whole batch, so the MoE block's
capacity and each choice's place in its expert's queue count all of the
call's rows. The port's side is one gloo process per rank
(``tests/torch_pod_child.py``): each holds its share of the same weights
(``mixtral.param_plan``: attention and F over the model axis, E over the
expert axis) and runs its data shard's rows, naming them to the forwards
(``rows``) so that the block counts the whole call; every rank's logits
are its rows of the JAX mesh's within 1e-4, and its merged slot cache is
its rows and KV heads of the JAX cache. A router pushed toward two of
eight experts drops tokens: the port still equals the JAX mesh there,
while counting a rank's own rows only gives other logits.

The engines: the dense pod engine over data 2 and over expert 2 (and an
8-expert model whose capacity drops tokens in the waves' padding rows and
the idle decode slots), and the sharded paged engine over data 2 with a
prefix hit, give the JAX sharded engines' greedy tokens exactly. A server
pod with ``SERVE_MODEL=tiny-moe`` over two processes answers a message.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend.engine import Engine as JaxEngine
from swarmdb_tpu.backend.sampling import SamplingParams as JSP
from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models import mixtral as jm
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from swarmdb_tpu.parallel.serving import build_sharded_model, \
    build_sharded_paged
from swarmdb_tpu_torch.models import mixtral as tm
from swarmdb_tpu_torch.parallel import serving as tserving
from swarmdb_tpu_torch.utils.checkpoint import save_params
from swarmdb_tpu_torch.utils.convert import params_from_numpy
from torch_pod_child import check_server_pod, params_npz, run_pod

B, T, S, K = 4, 16, 64, 4
TOL = 1e-4
#: (id, data, model, expert, n_experts, router pushed toward two experts)
MESHES = [("model2", 1, 2, 1, 4, False), ("expert2", 1, 1, 2, 4, False),
          ("data2", 2, 1, 1, 4, False),
          ("data2_expert2", 2, 1, 2, 4, False),
          ("model2_expert2", 1, 2, 2, 4, False),
          ("data2_overflow", 2, 1, 1, 8, True)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _push_router(params):
    """Every token toward experts 0 and 1 (as ``tests/test_mixtral.py``
    forces one expert): a large constant in every embedding's dim 0, read
    by the router's rows at dim 0 alone, so each expert's queue gets
    every token and capacity (N * 2 * 2 / 8 = N / 2) drops half."""
    params["embed"][:, 0] = 5.0
    router = params["layers"]["router"]
    router[:, 0, :] = 0.0
    router[:, 0, 0], router[:, 0, 1] = 10.0, 8.0
    return params


def _jax_sharded(cfg, data, model, expert, push=False):
    mesh = jax_make_mesh(devices=jax.devices()[:data * model * expert],
                         data=data, model=model, expert=expert)
    sm = build_sharded_model(cfg, mesh, seed=0, dtype=jnp.float32)
    params = jax.tree.map(lambda a: np.array(a, np.float32), sm.params)
    if push:
        params = _push_router(params)
        sm.params = jax.device_put(jax.tree.map(jnp.asarray, params),
                                   sm.param_shardings)
    return sm, params


@pytest.fixture(scope="module", params=MESHES, ids=[m[0] for m in MESHES])
def pod(request, tmp_path_factory):
    """The JAX mesh's outputs and every rank's, on the same inputs."""
    name, data, model, expert, n_exp, push = request.param
    tmp = tmp_path_factory.mktemp(name)
    cfg = get_config("tiny-moe", n_experts=n_exp)
    sm, params = _jax_sharded(cfg, data, model, expert, push)
    rng = np.random.default_rng(1)
    lengths = np.asarray([16, 9, 3, 12], np.int32)
    tokens = np.zeros((B, T), np.int32)
    for r, n in enumerate(lengths):
        tokens[r, :n] = rng.integers(3, cfg.vocab_size, n)
    feed = rng.integers(3, cfg.vocab_size, (B, K)).astype(np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))

    temp = jl.init_kv_cache(cfg, B, T, jnp.float32)
    logits, temp = sm.forward_fn(sm.params, jnp.asarray(tokens),
                                 jnp.asarray(positions), temp)
    want = {"prefill_logits": np.asarray(logits)[np.arange(B),
                                                 lengths - 1]}
    cache = jl.init_kv_cache(cfg, B, S, jnp.float32)
    cache = tuple(c.at[:, :, :T].set(t) for c, t in zip(cache, temp))
    chunk_fwd, _init, merge = sm.chunked_fns
    ckv = jl.init_chunk_kv(cfg, B, K, jnp.float32)
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
    world = data * model * expert
    got, codes, logs = run_pod("forward", tmp, dict(
        params_npz(params), tokens=tokens, lengths=lengths, feed=feed,
        max_seq=S, chunk=K, ckpt=ckpt, data=data, expert=expert,
        model="tiny-moe", n_experts=n_exp), world=world)
    assert codes == [0] * world, logs
    return dict(cfg=cfg, data=data, model=model, expert=expert, push=push,
                want=want, got=got)


def _coords(rank: int, model: int, expert: int):
    """(data, model, expert) index of a rank: row-major over the axes, as
    the JAX package reshapes its device list."""
    return rank // (model * expert), rank // expert % model, rank % expert


@pytest.mark.parametrize("key", ["prefill_logits", "chunk_logits"])
def test_each_rank_has_its_rows_of_the_jax_logits(pod, key):
    n = B // pod["data"]
    for rank, out in enumerate(pod["got"]):
        d, _m, _e = _coords(rank, pod["model"], pod["expert"])
        rows = pod["want"][key][..., d * n:(d + 1) * n, :]
        assert out[key].shape == rows.shape
        np.testing.assert_allclose(out[key], rows, atol=TOL, rtol=0)


@pytest.mark.parametrize("key", ["cache_k", "cache_v"])
def test_merged_cache_holds_each_ranks_rows_and_heads(pod, key):
    n, h = B // pod["data"], pod["cfg"].n_kv_heads // pod["model"]
    for rank, out in enumerate(pod["got"]):
        d, m, _e = _coords(rank, pod["model"], pod["expert"])
        np.testing.assert_allclose(
            out[key], pod["want"][key][:, d * n:(d + 1) * n, :,
                                       m * h:(m + 1) * h],
            atol=TOL, rtol=0)


def test_counting_a_ranks_own_rows_only(pod):
    """The prefill counted over the data shard's own rows: the same
    logits where no expert overflows (4 experts: C = N), other logits
    where the router overflows them (the mistake the port avoids)."""
    n = B // pod["data"]
    for rank, out in enumerate(pod["got"]):
        d = _coords(rank, pod["model"], pod["expert"])[0]
        want = pod["want"]["prefill_logits"][d * n:(d + 1) * n]
        gap = float(np.abs(out["local_logits"] - want).max())
        if pod["push"]:
            assert gap > 100 * TOL, gap
        else:
            assert gap <= TOL, gap


def test_shares_and_checkpoint(pod):
    """Each rank holds E / ep experts of F / mp and its heads' Q columns,
    and a sharded checkpoint restores exactly its slices."""
    cfg = pod["cfg"]
    for out in pod["got"]:
        assert out["w_gate_shape"].tolist() == [
            cfg.n_layers, cfg.n_experts // pod["expert"], cfg.dim,
            cfg.ffn_dim // pod["model"]]
        assert out["wq_shape"].tolist() == [
            cfg.n_layers, cfg.dim, cfg.n_heads * cfg.head_dim // pod["model"]]
        assert bool(out["ckpt_equal"])


def test_collectives_per_axis(pod):
    """Per forward: the model axis's 2L + 2 (as Llama's), one expert
    all-reduce per MoE layer, and on a data axis one exchange of expert
    choices per MoE layer for each call that counts the whole batch (the
    prefill and every chunk step, not the own-rows prefill)."""
    L = pod["cfg"].n_layers
    calls = 1 + K                  # counted calls; +1 own-rows prefill
    want = [L * calls if pod["data"] > 1 else 0,
            (2 * L + 2) * (calls + 1) if pod["model"] > 1 else 0,
            L * (calls + 1) if pod["expert"] > 1 else 0]
    for out in pod["got"]:
        assert out["axis_calls"].tolist() == want


def test_param_plan_is_the_jax_param_specs():
    """Every leaf splits the dims the JAX ``param_specs`` shard, over the
    same axes."""
    cfg = get_config("tiny-moe")
    specs, plan = jm.param_specs(cfg), tm.param_plan(cfg)

    def split(spec):
        return [(i, ax) for i, ax in enumerate(spec) if ax]

    def leaves(leaf):
        if leaf is None:
            return []
        return list(leaf) if isinstance(leaf[0], tuple) else [leaf]

    for key in ("embed", "final_norm", "lm_head"):
        assert split(specs[key]) == leaves(plan[key]), key
    for key, spec in specs["layers"].items():
        assert split(spec) == leaves(plan["layers"][key]), key


def test_expert_split_block_sums_to_the_whole_block():
    """``moe_block`` on each expert rank's experts (an axis whose sum is
    taken here) adds up to the block over all experts, in both dispatch
    forms, where capacity drops tokens."""
    rng = np.random.default_rng(0)
    D, F, E, N = 8, 16, 4, 24
    x = torch.from_numpy(rng.normal(size=(1, N, D)).astype(np.float32))
    router = torch.from_numpy(rng.normal(size=(D, E)).astype(np.float32))
    router[:, 0] += 3.0 * x[0].mean(0)        # skew toward expert 0
    w = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for s in ((E, D, F), (E, D, F), (E, F, D))]

    class Half:
        size = 2

        def __init__(self, index):
            self.index = index

        def all_reduce(self, y):
            return y

    for dispatch in ("scatter", "einsum"):
        whole, _ = tm.moe_block(x, router, *w, top_k=2,
                                capacity_factor=0.75, dispatch=dispatch)
        parts = [tm.moe_block(x, router, *(t[e * 2:(e + 1) * 2] for t in w),
                              top_k=2, capacity_factor=0.75,
                              dispatch=dispatch, expert=Half(e))[0]
                 for e in range(2)]
        torch.testing.assert_close(parts[0] + parts[1], whole, atol=1e-5,
                                   rtol=0)
    with pytest.raises(ValueError, match="expert axis"):
        tm.moe_block(x, router, *(t[:2] for t in w), top_k=2)


# ------------------------------------------------------------- engines


PROMPTS = [[1, 5, 9, 13, 2], list(range(3, 40)), [7, 7, 7],
           list(range(3, 35)) + [50, 51, 52]]
MAX_BATCH, CHUNK, NEW, PS = 4, 4, 6, 16
#: (id, data, expert, n_experts, router pushed toward two experts)
ENGINES = [("data2", 2, 1, 4, False), ("expert2", 1, 2, 4, False),
           ("data2_overflow", 2, 1, 8, True)]


def _jax_tokens(sm, paged: bool):
    kw = {"chunked_fns": sm.chunked_fns}
    if paged:
        spec, prefix_fns, paged_chunked = build_sharded_paged(
            sm, max_batch=MAX_BATCH, max_seq=S, page_size=PS)
        kw = {"paged": spec, "prefix_fns": prefix_fns,
              "chunked_fns": paged_chunked}
    eng = JaxEngine(sm.forward_fn, sm.init_cache_fn, sm.params,
                    max_batch=MAX_BATCH, max_seq=S, seed=0,
                    decode_chunk=CHUNK, **kw)
    eng.place_state(sm.mesh)
    eng.start()
    try:
        return [list(eng.generate_sync(p, JSP(max_new_tokens=NEW),
                                       timeout=120)[0]) for p in PROMPTS]
    finally:
        eng.stop()


def _pod_tokens(params, tmp_path, data, expert, n_exp, paged):
    inputs = dict(params_npz(params), data=data, expert=expert,
                  model="tiny-moe", n_experts=n_exp, paged=paged,
                  max_batch=MAX_BATCH, max_seq=S, chunk=CHUNK, page_size=PS,
                  new=NEW, n_prompts=len(PROMPTS), scenario="serial",
                  **{f"prompt{i}": np.asarray(p, np.int32)
                     for i, p in enumerate(PROMPTS)})
    world = data * expert
    got, codes, logs = run_pod("dp", tmp_path, inputs, world=world,
                               env={"SWARMDB_KV_DTYPE": "f32"})
    assert codes == [0] * world, logs
    for rank in got:
        np.testing.assert_array_equal(got[0]["blocks"], rank["blocks"])
        assert str(rank["moe_dispatch"]) == "scatter"
        assert not bool(rank["graphs_meta"])      # the CPU: eager chunks
    return got[0], [got[0][f"tokens{i}"].tolist()
                    for i in range(len(PROMPTS))]


@pytest.mark.parametrize("name,data,expert,n_exp,push", ENGINES,
                         ids=[e[0] for e in ENGINES])
def test_dense_pod_tokens_equal_the_jax_sharded_engine(
        tmp_path, name, data, expert, n_exp, push):
    """Greedy tokens of requests one after another: with the pushed
    router, capacity drops tokens in every wave (whose padding rows take
    queue places) and every decode step (whose idle slots do)."""
    cfg = get_config("tiny-moe", n_experts=n_exp)
    sm, params = _jax_sharded(cfg, data, 1, expert, push)
    want = _jax_tokens(sm, paged=False)
    coord, got = _pod_tokens(params, tmp_path, data, expert, n_exp, False)
    assert got == want
    assert all(str(coord[f"reason{i}"]) == "length"
               for i in range(len(PROMPTS)))
    assert int(coord["local_rows"]) == MAX_BATCH // data


@pytest.mark.parametrize("n_exp,push", [(4, False), (8, True)],
                         ids=["4experts", "overflow"])
def test_sharded_paged_pod_tokens_equal_the_jax_engine(tmp_path,
                                                       monkeypatch, n_exp,
                                                       push):
    """Over data 2: decode and packed waves count each shard's rows, the
    prefix wave (the last prompt reuses two cached pages) all of it; with
    the pushed router, capacity drops tokens in each."""
    monkeypatch.setenv("SWARMDB_KV_DTYPE", "f32")
    cfg = get_config("tiny-moe", n_experts=n_exp)
    sm, params = _jax_sharded(cfg, 2, 1, 1, push)
    want = _jax_tokens(sm, paged=True)
    coord, got = _pod_tokens(params, tmp_path, 2, 1, n_exp, True)
    assert got == want
    assert int(coord["paged_shards"]) == 2
    assert int(coord["reused"]) == 2 * PS
    pool = json.loads(str(coord["pool"]))
    assert pool is not None


def test_server_pod_serves_tiny_moe(tmp_path):
    """``SERVE_MODEL=tiny-moe`` over two server processes: the default
    mesh (both ranks on the model axis, as the JAX server's) serves."""
    check_server_pod(tmp_path, "tiny-moe")


def test_sharded_model_builds_mixtral_over_each_axis():
    """One process's view of each mesh: the shares' shapes follow the
    plan, and an expert count that does not split is refused."""
    from swarmdb_tpu_torch.models.configs import get_config as port_config
    from swarmdb_tpu_torch.parallel.mesh import make_mesh

    cfg = port_config("tiny-moe")
    mesh = make_mesh(device="cpu")
    for shape in ({"expert": 2}, {"model": 2}, {"data": 2}):
        mesh.shape = {**mesh.shape, "data": 1, "model": 1, "expert": 1,
                      **shape}
        sm = tserving.build_sharded_model(cfg, mesh, dtype=torch.float32)
        assert sm.params["layers"]["w_gate"].shape == (
            cfg.n_layers, cfg.n_experts // mesh.shape["expert"], cfg.dim,
            cfg.ffn_dim // mesh.shape["model"])
    mesh.shape = dict(mesh.shape, data=1, model=1, expert=3)
    with pytest.raises(ValueError, match="experts 4 do not split"):
        tserving.build_sharded_model(cfg, mesh)
