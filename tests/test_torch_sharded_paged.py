"""PyTorch port vs JAX reference: the paged engine over a data axis (the
sharded paged engine), its slot-affine page pool and its refusals.

The port's side is two gloo ranks on the CPU (``tests/torch_pod_child.py``
job ``dp``): ``build_serving_engine(data=2, paged=True)`` on each, rank 0
serving through ``enable_multihost`` and rank 1 replaying its calls, each
rank holding its shard of the pool (its sub-pool, its two slots' table
rows) and the JAX package's float32 tiny weights whole. The JAX side is
the JAX package's own sharded paged engine over two CPU devices
(``build_sharded_model(dtype=float32)``, ``build_sharded_paged`` and
``Engine``, as its ``build_serving_engine`` wires them), with the pool in
f32 on both (``SWARMDB_KV_DTYPE=f32``). Greedy tokens, chunked and
single-step, over prompts of which the last reuses a cached prefix, equal
the JAX sharded paged engine's, the port's single paged engine's and the
JAX dense sharded engine's, exactly; both ranks read the same gathered
token block in every chunk. Admission spreads over the shards and a
shard hint keeps a conversation's prefix hits (max_batch 8).
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend.engine import Engine as JaxEngine
from swarmdb_tpu.backend.sampling import SamplingParams as JSP
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu.ops import paged_kv as jpk
from swarmdb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from swarmdb_tpu.parallel.serving import build_serving_engine as \
    jax_build_serving_engine
from swarmdb_tpu.parallel.serving import build_sharded_model, \
    build_sharded_paged
from swarmdb_tpu_torch.backend import service as tsvc
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.ops import paged_kv as tpk
from swarmdb_tpu_torch.parallel import serving as tserving
from swarmdb_tpu_torch.utils.convert import params_from_numpy
from torch_pod_child import params_npz, run_pod

ROOT = Path(__file__).resolve().parent.parent
CFG = get_config("tiny-debug")
MAX_BATCH, SEQ, CHUNK, NEW, PS = 4, 64, 4, 6, 16
# the JAX package's parity prompts (tests/test_parallel.py), then one
# whose first two pages the second prompt registered
PROMPTS = [[1, 5, 9, 13, 2], list(range(3, 40)), [7, 7, 7],
           list(range(3, 35)) + [50, 51, 52]]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX engines' greedy tokens (paged chunked and single-step, and
    the dense sharded engine) and the float32 weights they ran."""
    mesh = jax_make_mesh(devices=jax.devices()[:2], data=2, model=1,
                         expert=1)
    sm = build_sharded_model(CFG, mesh, seed=0, dtype=jnp.float32)
    out = {"params": jax.tree.map(np.asarray, sm.params)}
    with pytest.MonkeyPatch.context() as m:
        m.setenv("SWARMDB_KV_DTYPE", "f32")
        for name, paged, chunked in (("paged_chunked", True, True),
                                     ("paged_single", True, False),
                                     ("dense", False, True)):
            kw = {"chunked_fns": sm.chunked_fns}
            if paged:
                spec, prefix_fns, paged_chunked = build_sharded_paged(
                    sm, max_batch=MAX_BATCH, max_seq=SEQ, page_size=PS)
                assert spec.allocator.n_shards == 2
                kw = {"paged": spec, "prefix_fns": prefix_fns,
                      "chunked_fns": paged_chunked if chunked else None}
            eng = JaxEngine(sm.forward_fn, sm.init_cache_fn, sm.params,
                            max_batch=MAX_BATCH, max_seq=SEQ, seed=0,
                            decode_chunk=CHUNK, **kw)
            eng.place_state(sm.mesh)
            eng.start()
            try:
                out[name] = [
                    list(eng.generate_sync(p, JSP(max_new_tokens=NEW),
                                           timeout=120)[0])
                    for p in PROMPTS]
            finally:
                eng.stop()
    return out


def _pod(params, tmp_path, chunked: bool, scenario="serial",
         prompts=PROMPTS, max_batch=MAX_BATCH, new=NEW, **extra):
    inputs = dict(params_npz(params), data=2, paged=True,
                  max_batch=max_batch, max_seq=SEQ, chunk=CHUNK,
                  page_size=PS, new=new, n_prompts=len(prompts),
                  scenario=scenario, **extra,
                  **{f"prompt{i}": np.asarray(p, np.int32)
                     for i, p in enumerate(prompts)})
    # the prefix budget pinned to its default: the pool sizes checked
    # below assume it, and a test that ran before in this process may
    # have left it set (bench.py's setdefault)
    env = {"SWARMDB_KV_DTYPE": "f32",
           "SWARMDB_CHUNKED": "1" if chunked else "0",
           "SWARMDB_PREFIX_TOKENS": str(max_batch * SEQ // 2)}
    got, codes, logs = run_pod("dp", tmp_path, inputs, env=env)
    assert codes == [0, 0], logs
    return got


def _port_single(params, chunked: bool, monkeypatch):
    """The port's single paged engine on the same weights and shapes."""
    monkeypatch.setenv("SWARMDB_KV_DTYPE", "f32")
    monkeypatch.setenv("SWARMDB_CHUNKED", "1" if chunked else "0")
    eng, _ = tsvc.build_backend_engine(
        "tiny-debug", max_batch=MAX_BATCH, max_seq=SEQ, decode_chunk=CHUNK,
        device="cpu", paged=True, page_size=PS,
        params=params_from_numpy(params, "cpu"))
    eng.start()
    try:
        return [eng.generate_sync(p, TSP(max_new_tokens=NEW))[0]
                for p in PROMPTS]
    finally:
        eng.stop()


@pytest.mark.parametrize("chunked", [True, False],
                         ids=["chunked", "single_step"])
def test_sharded_paged_pod_tokens_equal_jax_and_single_engines(
        jax_side, tmp_path, monkeypatch, chunked):
    coord, worker = _pod(jax_side["params"], tmp_path, chunked)
    pod = [coord[f"tokens{i}"].tolist() for i in range(len(PROMPTS))]
    assert all(str(coord[f"reason{i}"]) == "length"
               for i in range(len(PROMPTS)))
    mode = "paged_chunked" if chunked else "paged_single"
    assert pod == jax_side[mode]
    assert pod == jax_side["dense"]
    assert pod == _port_single(jax_side["params"], chunked, monkeypatch)
    # every chunk: both ranks read the same gathered [K+1, B] block (row
    # 0 their fed tokens), so the pod's fed-token state agrees
    assert coord["blocks"].shape[1:] == (CHUNK + 1, MAX_BATCH)
    np.testing.assert_array_equal(coord["blocks"], worker["blocks"])
    # each rank holds its shard: 2 slots, a sub-pool of 1 + 384 / 32
    # pages, and its chunks run with no collective inside (eager here:
    # the CPU has no graphs)
    per_shard = 1 + (MAX_BATCH * SEQ + MAX_BATCH * SEQ // 2) // (PS * 2)
    for rank in (coord, worker):
        assert int(rank["paged_shards"]) == 2
        assert int(rank["local_rows"]) == MAX_BATCH // 2
        assert int(rank["local_pages"]) == per_shard
        assert not bool(rank["graphs_meta"])
    assert int(coord["shard_steps"]) > 0     # flight steps by shard
    # the last prompt met the second's two cached pages on its shard
    assert int(coord["reused"]) == 2 * PS


def test_admission_spreads_over_the_shards(jax_side, tmp_path):
    """Four requests at once on a max_batch 8 pod land on both shards
    (id-order admission would put them all on shard 0's sub-pool)."""
    prompts = [[1 + i, 2, 3] for i in range(4)]
    coord, _ = _pod(jax_side["params"], tmp_path, True, scenario="spread",
                    prompts=prompts, max_batch=8, new=12)
    assert coord["shards_seen"].tolist() == [0, 1]
    assert sorted(coord["reasons"].tolist()) == ["length"] * 4


def test_shard_hint_keeps_prefix_affinity(jax_side, tmp_path):
    """A conversation's turns carry a shard hint: turns 2 and 3 land on
    turn 1's shard and reuse its two cached pages each."""
    coord, _ = _pod(jax_side["params"], tmp_path, True, scenario="hint",
                    prompts=[list(range(1, 41))], max_batch=8, new=3,
                    hint=1)
    assert int(coord["reused"]) >= 2 * 2 * PS


def test_sharded_allocator_slot_affinity():
    """The JAX package's case (tests/test_parallel.py), same numbers."""
    a = tpk.ShardedPageAllocator(8, 4, 8, 64, 8)  # 8 pages/shard, 4 shards
    # slot 5 -> shard 2 -> ids in [16, 24), never 16 (shard trash)
    row = a.allocate(5, 3)
    assert a.shard_of(5) == 2
    assert all(16 < p < 24 for p in row[:3]), row
    assert a.usable_prefix(5, [17, 18, 19]) == 3
    assert a.usable_prefix(5, [17, 9, 19]) == 1
    assert a.usable_prefix(0, [17, 18]) == 0
    assert a.allocate(4, 4) is not None  # slot 4 also shard 2 -> 0 left
    with pytest.raises(RuntimeError, match="already holds"):
        a.allocate(5, 1)
    assert a.free_count(1) == 7
    assert a.free_count(5) == 0
    a.add_free([23])
    assert a.free_count(5) == 1
    assert a.slot_capacity() == 7
    assert a.stats()["free_by_shard"] == [7, 7, 1, 7]


def test_foreign_page_ids_never_reach_a_rank():
    """A row naming another shard's pages is an engine bug: the allocator
    raises (as the JAX package's ``_check_prefix``) before any table
    holds it, and the two packages agree on every id's localization."""
    t = tpk.ShardedPageAllocator(8, 2, 8, 64, 4)
    j = jpk.ShardedPageAllocator(8, 2, 8, 64, 4)
    for alloc in (t, j):
        with pytest.raises(RuntimeError, match="foreign-shard prefix"):
            alloc.allocate_with_prefix(0, [9, 10], 1)   # slot 0: shard 0
        assert alloc.free_count(0) == 7   # nothing taken
    # a rank's localized view (Engine._localize): own ids to [1, Pl),
    # trash and zeroed entries to its trash page 0
    table = np.asarray([[9, 10, 0], [15, 8, 0]], np.int32)
    assert np.clip(table - 1 * 8, 0, 7).tolist() == [[1, 2, 0], [7, 0, 0]]


def test_pagecheck_factories_for_the_sharded_pool(monkeypatch):
    """The JAX package's factory cases (tests/test_pagecheck.py): plain
    classes with the flag off, checked subclasses with it on."""
    monkeypatch.delenv("SWARMDB_PAGECHECK", raising=False)
    assert type(tpk.make_sharded_page_allocator(8, 2, 4, 16, 4)) \
        is tpk.ShardedPageAllocator
    monkeypatch.setenv("SWARMDB_PAGECHECK", "1")
    from swarmdb_tpu_torch.obs import pagecheck

    try:
        s = tpk.make_sharded_page_allocator(8, 2, 4, 16, 4)
        assert type(s).__name__ == "CheckedShardedPageAllocator"
        assert isinstance(s, tpk.ShardedPageAllocator)
        # both shards' first pages are trash, never allocatable: slot 3
        # (shard 1) draws from [9, 16) only
        row = s.allocate(3, 4)
        assert all(8 < p < 16 for p in row), row
        assert s.allocate(2, 4) is None        # 3 left in shard 1
        assert s.free_count(0) == 7
        assert pagecheck.registry().violations() == []
    finally:
        pagecheck.registry().reset()


def test_int8_on_a_sharded_pool_is_refused_as_in_jax(monkeypatch):
    monkeypatch.setenv("SWARMDB_KV_DTYPE", "int8")
    jmesh = jax_make_mesh(devices=jax.devices()[:2], data=2, model=1,
                          expert=1)
    jsm = build_sharded_model(CFG, jmesh, seed=0, dtype=jnp.float32)
    with pytest.raises(NotImplementedError) as want:
        build_sharded_paged(jsm, max_batch=4, max_seq=64, page_size=16)
    from swarmdb_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    mesh.shape = dict(mesh.shape, data=2)
    sm = tserving.build_sharded_model("tiny-debug", mesh)
    with pytest.raises(NotImplementedError) as got:
        tserving.build_sharded_paged(sm, max_batch=4, max_seq=64)
    assert str(got.value) == str(want.value)
    assert "single-chip only" in str(got.value)


def test_paged_over_a_model_axis_is_refused_as_in_jax():
    with pytest.raises(ValueError) as want:
        jax_build_serving_engine(
            get_config("tiny-debug"), jax_make_mesh(8, data=4, model=2,
                                                    expert=1),
            max_batch=4, max_seq=64, paged=True, page_size=8)
    with pytest.raises(ValueError) as got:
        tserving.build_serving_engine("tiny-debug", ["cpu", "cpu"],
                                      max_batch=4, max_seq=64, paged=True,
                                      page_size=8, model=2)
    assert str(got.value) == str(want.value)
    assert "pure-DP mesh" in str(got.value)


def test_server_paged_pod_raises_pure_dp_on_every_rank(tmp_path):
    """``SWARMDB_PAGED=1`` over two server processes: the default mesh
    puts both ranks on the model axis, so each raises the JAX server's
    pure-DP ``ValueError`` (there is no knob for the mesh)."""
    base = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                SERVE_MODEL="tiny-debug", SERVE_DEVICE="cpu",
                SERVE_MAX_BATCH="2", SERVE_MAX_SEQ="64", SWARMDB_PAGED="1",
                SWARMDB_COORDINATOR=f"file://{tmp_path / 'store'}",
                SWARMDB_NUM_PROCESSES="2", SWARMDB_PG_TIMEOUT_S="30",
                BROKER_IMPL="python", SAVE_DIR=str(tmp_path / "hist"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "swarmdb_tpu_torch.api.server"],
        env=dict(base, SWARMDB_PROCESS_ID=str(r)), cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    deadline = time.monotonic() + 60
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode != 0, log
        assert "ValueError: sharded paged serving requires a pure-DP " \
               "mesh" in log, log[-2000:]
