"""PyTorch port vs JAX reference: the dense single program's prefix lane
(the JAX engine's mirrored call 4) over model, data and expert axes.

The JAX package's ``build_serving_engine(cfg, mesh, prefix_fns=...,
prefix_page_size=..., prefix_pages=...)`` serves the dense sharded engine
with a prefix cache over a side pool replicated on the mesh. The port's
``build_serving_engine(cfg, devices, prefix_pages=..., ...)`` builds the
same program, each rank holding its KV heads of every pool page; a prefix
wave is published as call 4 and runs whole on every data rank, so every
rank's pool holds every registered page.

- ``forward_prefix_lane`` over two gloo ranks (``model`` 2) against the
  JAX function on a two-device mesh: logits and each rank's KV-head share
  of the lanes within 1e-4.
- The one-process program (``parallel/local.py``) with ``prefix_pages``:
  tiny-debug over ``model`` 2, ``data`` 2 and ``data`` 2 x ``model`` 2,
  tiny-moe over ``expert`` 2 and ``data`` 2. Turn 1 queues four prompts
  together (the long one on slot 2: data rank 1 on a data axis); turn 2
  is a prompt whose four leading pages the long one registered, alone on
  slot 0 (data rank 0 reads pages a row of rank 1 wrote); turn 3 is the
  long prompt's second turn (prompt + reply). Greedy tokens equal the
  JAX program's exactly, and so does ``prefix_reused_tokens`` (above 0).
- The same scenario on a two-rank pod over ``model`` 2
  (``tests/torch_pod_child.py``, its worker replaying call 4).
- After ``restart()`` the program serves the long prompt's two turns
  with the same tokens, the second hitting again.
- ``Engine(prefill_buckets=)`` gives the JAX engine's bucket list, and a
  worker still refuses ids 2 and 6 with their reasons.

Weights are float32 on both sides (the JAX call's ``build_sharded_model``
asked for float32, the port given the same values); slot cache, chunk
buffer and side pool are bf16 on both, the two packages' default.
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend.engine import Engine as JaxEngine
from swarmdb_tpu.backend.engine import GenRequest as JReq
from swarmdb_tpu.backend.sampling import SamplingParams as JSP
from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models import mixtral as jm
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu.parallel import serving as jserving
from swarmdb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from swarmdb_tpu_torch.backend.engine import Engine
from swarmdb_tpu_torch.backend.engine import GenRequest as TReq
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.models import llama as tl
from swarmdb_tpu_torch.parallel.serving import build_serving_engine
from swarmdb_tpu_torch.utils.convert import params_from_numpy
from torch_pod_child import params_npz, prefix_turns, run_pod

MAX_BATCH, SEQ, CHUNK, NEW, PS, POOL = 4, 64, 4, 5, 8, 32
#: the JAX package's dense-prefix pod script's buckets (tests/
#: test_multihost.py): 32, topped by max_seq
BUCKETS = [32]
LONG = list(range(3, 40))                   # four full pages registered
TURN1 = [[1, 5, 9, 13, 2], [7, 7, 7], LONG, [4, 6]]
HIT = list(range(3, 35)) + [50, 51, 52]     # LONG's four pages, then new
#: turn 2: HIT alone; turn 3: LONG's second turn (turn 1 prompt 2 + reply)
LATER = [HIT, 2]
#: reused tokens: HIT's four pages, then LONG's four again
REUSED = 2 * 4 * PS
WAIT_S = 90


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One intra-op thread here and in the workers (they take the
    caller's count); no engine knob left from another test."""
    for k in ("SWARMDB_PAGED", "SWARMDB_CHUNKED", "SWARMDB_PREFIX"):
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_prefix_fns(cfg):
    """The dense prefix pair as the JAX package's serving wires it."""
    fam = jm if cfg.is_moe else jl
    return (lambda p, t, tab, pl, pk, pv, lp, logits_at=None:
            fam.forward_prefix_lane(p, cfg, t, tab, pl, pk, pv, lp,
                                    logits_at=logits_at),
            lambda n, ps: jl.init_prefix_pool(cfg, n, ps))


_JAX_RUNS: dict = {}


def _jax_program(name, data, model, expert):
    """The JAX ``build_serving_engine`` over ``data`` x ``model`` x
    ``expert`` CPU devices with the prefix lane, its weights float32:
    (turns' tokens and reasons, prefix_reused_tokens, the weights as
    numpy). Kept per axes: the pod case reuses the model axis's."""
    key = (name, data, model, expert)
    if key in _JAX_RUNS:
        return _JAX_RUNS[key]
    cfg = get_config(name)
    n = data * model * expert
    mesh = jax_make_mesh(devices=jax.devices()[:n], data=data, model=model,
                         expert=expert)
    mp = pytest.MonkeyPatch()
    mp.setattr(jserving, "build_sharded_model", functools.partial(
        jserving.build_sharded_model, dtype=jnp.float32))
    try:
        eng, sm = jserving.build_serving_engine(
            cfg, mesh, max_batch=MAX_BATCH, max_seq=SEQ, decode_chunk=CHUNK,
            prefill_buckets=BUCKETS, prefix_fns=_jax_prefix_fns(cfg),
            prefix_page_size=PS, prefix_pages=POOL)
    finally:
        mp.undo()
    try:
        turns = prefix_turns(eng, TURN1, LATER, NEW, JReq, JSP,
                             timeout=WAIT_S)
        reused = eng.metrics.counters["prefix_reused_tokens"].value
    finally:
        eng.stop()
    out = (turns, reused, jax.tree.map(lambda a: np.array(a, np.float32),
                                       sm.params))
    _JAX_RUNS[key] = out
    return out


def _port_program(name, params, **axes):
    n = axes.get("data", 1) * (axes.get("model") or 1) * axes.get(
        "expert", 1)
    return build_serving_engine(
        name, ["cpu"] * n, max_batch=MAX_BATCH, max_seq=SEQ,
        decode_chunk=CHUNK, paged=False, prefix_pages=POOL,
        prefix_page_size=PS, prefill_buckets=BUCKETS,
        params=params_from_numpy(params, "cpu"), **axes)


def _serve(eng, later=LATER):
    return prefix_turns(eng, TURN1, later, NEW, TReq, TSP, timeout=WAIT_S)


# ------------------------------------------------------ the lane forward


def test_lane_forward_over_two_ranks_equals_the_jax_mesh(tmp_path):
    """Two rows with hits of 3 and 1 pages and suffixes of 5 and 8
    tokens: each rank's logits (gathered over the vocab) and its KV heads
    of the composed lanes against the JAX function on a 2-device model
    mesh."""
    cfg = get_config("tiny-debug")
    mesh = jax_make_mesh(devices=jax.devices()[:2], data=1, model=2,
                         expert=1)
    sm = jserving.build_sharded_model(cfg, mesh, seed=0, dtype=jnp.float32)
    params = jax.tree.map(lambda a: np.array(a, np.float32), sm.params)
    rng = np.random.default_rng(7)
    L, P, Hkv, D = cfg.n_layers, 12, cfg.n_kv_heads, cfg.head_dim
    pool_k, pool_v = (rng.standard_normal((L, P, PS, Hkv, D))
                      .astype(np.float32) for _ in range(2))
    tokens = rng.integers(3, cfg.vocab_size, (2, 8)).astype(np.int32)
    table = np.asarray([[3, 7, 1, 0], [5, 0, 0, 0]], np.int32)
    plens = np.asarray([3 * PS, PS], np.int32)
    logits_at = np.asarray([4, 7], np.int32)
    lane_pages = 5
    want = jl.forward_prefix_lane(
        sm.params, cfg, jnp.asarray(tokens), jnp.asarray(table),
        jnp.asarray(plens), jnp.asarray(pool_k), jnp.asarray(pool_v),
        lane_pages, logits_at=jnp.asarray(logits_at))
    want = [np.asarray(a, np.float32) for a in want]
    inputs = dict(params_npz(params), tokens=tokens, table=table,
                  plens=plens, pool_k=pool_k, pool_v=pool_v,
                  lane_pages=lane_pages, logits_at=logits_at)
    got, codes, logs = run_pod("lane", tmp_path, inputs)
    assert codes == [0, 0], logs
    h = Hkv // 2
    for r, out in enumerate(got):
        assert tuple(out["pool_shape"]) == (L, 4, 8, h, D)
        np.testing.assert_allclose(out["logits"], want[0], atol=1e-4,
                                   rtol=0)
        for k, name in ((1, "lane_k"), (2, "lane_v")):
            np.testing.assert_allclose(
                out[name], want[k][:, :, :, r * h:(r + 1) * h], atol=1e-4,
                rtol=0)


# ------------------------------------------------- the one-process program


@pytest.mark.parametrize("name,axes", [
    ("tiny-debug", {"data": 1, "model": 2, "expert": 1}),
    ("tiny-debug", {"data": 2, "model": 1, "expert": 1}),
    ("tiny-debug", {"data": 2, "model": 2, "expert": 1}),
    ("tiny-moe", {"data": 1, "model": 1, "expert": 2}),
    ("tiny-moe", {"data": 2, "model": 1, "expert": 1}),
], ids=["debug-model2", "debug-data2", "debug-data2xmodel2",
        "moe-expert2", "moe-data2"])
def test_local_program_prefix_lane_equals_the_jax_mesh(name, axes):
    want, reused, params = _jax_program(name, **axes)
    assert reused == REUSED
    eng, sm = _port_program(name, params, **axes)
    procs = list(eng._owner.procs)
    assert eng._prefix is not None and eng.paged is None
    assert eng.prefill_buckets == [32, SEQ]
    m = axes["model"]
    assert eng._prefix_pool[0].shape[3] == get_config(name).n_kv_heads // m
    try:
        got = _serve(eng)
        hits = eng.metrics.counters["prefix_reused_tokens"].value
    finally:
        eng.stop()
    assert got == want
    assert hits == reused
    assert all(p.poll() == 0 for p in procs)


def test_pod_replays_the_prefix_lane(tmp_path):
    """A 2-rank pod over model 2 (``init_distributed`` in each process):
    rank 1's ``worker_loop`` replays call 4; the one-process program's
    tokens and hits."""
    want, reused, params = _jax_program("tiny-debug", 1, 2, 1)
    inputs = dict(params_npz(params), max_batch=MAX_BATCH, max_seq=SEQ,
                  chunk=CHUNK, new=NEW, page_size=PS, paged=False,
                  prefix_pages=POOL, prefix_page_size=PS,
                  buckets=np.asarray(BUCKETS), scenario="prefix",
                  later=json.dumps(LATER), n_prompts=len(TURN1),
                  **{f"prompt{i}": np.asarray(p, np.int32)
                     for i, p in enumerate(TURN1)})
    got, codes, logs = run_pod("dp", tmp_path, inputs, timeout=180.0)
    assert codes == [0, 0], logs
    coord, worker = got
    turns = [(coord[f"tokens{i}"].tolist(), str(coord[f"reason{i}"]))
             for i in range(len(TURN1) + len(LATER))]
    assert turns == want
    assert int(coord["reused"]) == reused
    np.testing.assert_array_equal(coord["blocks"], worker["blocks"])


def test_restart_serves_the_same_tokens_and_hits_again():
    """The model-2 program serves, restarts (new worker, empty pools on
    both ranks, an empty prefix table), then serves the long prompt's two
    turns: the same tokens as before, the second turn hitting its four
    pages again."""
    want, _reused, params = _jax_program("tiny-debug", 1, 2, 1)
    eng, _sm = _port_program("tiny-debug", params, data=1, model=2)
    try:
        assert _serve(eng) == want
        eng.restart()
        assert eng._prefix.stats()["cached_pages"] == 0
        c = eng.metrics.counters["prefix_reused_tokens"]
        before = c.value
        first = eng.generate_sync(LONG, TSP(max_new_tokens=NEW),
                                  timeout=WAIT_S)
        second = eng.generate_sync(LONG + list(first[0]),
                                   TSP(max_new_tokens=NEW), timeout=WAIT_S)
        assert (list(first[0]), first[1]) == want[2]
        assert (list(second[0]), second[1]) == want[-1]
        assert c.value - before == 4 * PS
    finally:
        eng.stop()


# ----------------------------------------------------- engine arguments


@pytest.mark.parametrize("max_seq,buckets", [
    (64, None), (64, [32]), (1024, [256, 64, 1000]), (64, [16, 63])])
def test_prefill_buckets_equal_the_jax_engine(max_seq, buckets):
    """The JAX ``Engine(prefill_buckets=)`` rule: sorted, topped by
    max_seq unless the largest holds a prompt of max_seq - 1 tokens."""
    cfg = get_config("tiny-debug")
    jparams = jl.init_params(cfg, jax.random.PRNGKey(0))
    jeng = JaxEngine(lambda p, t, pos, c: jl.forward(p, cfg, t, pos, c),
                     lambda b, s: jl.init_kv_cache(cfg, b, s), jparams,
                     max_batch=2, max_seq=max_seq, prefill_buckets=buckets)
    teng = Engine(tl.init_params(cfg, device="cpu"),
                  forward_fn=lambda p, t, pos, c, logits_at=None:
                  tl.forward(p, cfg, t, pos, c, logits_at=logits_at),
                  init_cache_fn=lambda b, s: tl.init_kv_cache(
                      cfg, b, s, device="cpu"),
                  max_batch=2, max_seq=max_seq, device="cpu",
                  prefill_buckets=buckets)
    assert teng.prefill_buckets == jeng.prefill_buckets


@pytest.mark.parametrize("call_id,why", [(2, "rolling"), (6, "ragged")])
def test_worker_refuses_the_unmirrored_calls(call_id, why):
    """Ids 2 and 6 have no handler: no pod engine makes them."""
    cfg = get_config("tiny-debug")
    eng = Engine(tl.init_params(cfg, device="cpu"),
                 forward_fn=lambda p, t, pos, c, logits_at=None:
                 tl.forward(p, cfg, t, pos, c, logits_at=logits_at),
                 init_cache_fn=lambda b, s: tl.init_kv_cache(
                     cfg, b, s, device="cpu"),
                 max_batch=2, max_seq=64, device="cpu")
    assert Engine.CALL_DENSE_PREFIX_PREFILL in Engine._MH_CALLS
    with pytest.raises(ValueError, match=why):
        eng._replay_call(call_id, [])
