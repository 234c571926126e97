"""PyTorch port vs JAX reference: the single program over the devices of
one process.

The JAX package serves a mesh of the devices of one process as one GSPMD
program (``build_serving_engine(cfg, mesh)``). The port's
``build_serving_engine(cfg, ["cpu", "cpu"], ...)``, called in a process
that is no rank of a process group, spawns a rank for the second device
(``parallel/local.py``), this process being rank 0, and returns rank 0's
engine. The JAX side is built as ``tests/test_torch_sharded_paged.py``
builds it (``build_sharded_model(dtype=float32)``, ``build_sharded_paged``
and ``Engine`` over two CPU devices); the port gets the same float32
weights whole (``params=``: rank 0 writes them once, the worker reads its
share). Greedy tokens of requests one after another are equal exactly:

- the dense engine over ``model`` 2 (no axis given: every device on the
  model axis, as the JAX package's ``plan_mesh_shape``);
- the sharded paged engine (``admit_overlap=False``) over ``data`` 2, and
  the port's dense program over ``data`` 2 built after it in this process;
- tiny-moe over ``expert`` 2.

Then the lifecycle: ``stop`` (started or not) leaves no worker process
and no process group, and a second program builds and serves in this
process; a killed worker ends its request "engine_error" within the
process group's timeout (``SWARMDB_PG_TIMEOUT_S``, a few seconds here),
``restart`` spawns new workers and serves the same tokens, and the
supervisor's restart revives the program after a second kill.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend.engine import Engine as JaxEngine
from swarmdb_tpu.backend.sampling import SamplingParams as JSP
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from swarmdb_tpu.parallel.serving import build_sharded_model, \
    build_sharded_paged
from swarmdb_tpu_torch.backend.engine import GenRequest
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.backend.supervisor import LaneSupervisor
from swarmdb_tpu_torch.parallel.serving import build_serving_engine
from swarmdb_tpu_torch.utils.convert import params_from_numpy

MAX_BATCH, SEQ, CHUNK, NEW, PS = 4, 64, 4, 6, 16
# the JAX package's parity prompts (tests/test_parallel.py), then one
# whose first two pages the second prompt registered
PROMPTS = [[1, 5, 9, 13, 2], list(range(3, 40)), [7, 7, 7],
           list(range(3, 35)) + [50, 51, 52]]
#: every wait of these tests, in seconds
WAIT_S = 60


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One intra-op thread here and in the workers (they take the
    caller's count), and the pool in f32 on both packages."""
    monkeypatch.setenv("SWARMDB_KV_DTYPE", "f32")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_program(cfg, data, model, expert, paged=False):
    """The JAX package's program over two CPU devices: its greedy tokens
    of ``PROMPTS`` and its float32 weights (numpy)."""
    mesh = jax_make_mesh(devices=jax.devices()[:2], data=data, model=model,
                         expert=expert)
    sm = build_sharded_model(cfg, mesh, seed=0, dtype=jnp.float32)
    kw = {"chunked_fns": sm.chunked_fns}
    if paged:
        spec, prefix_fns, paged_chunked = build_sharded_paged(
            sm, max_batch=MAX_BATCH, max_seq=SEQ, page_size=PS)
        kw = {"paged": spec, "prefix_fns": prefix_fns,
              "chunked_fns": paged_chunked}
    eng = JaxEngine(sm.forward_fn, sm.init_cache_fn, sm.params,
                    max_batch=MAX_BATCH, max_seq=SEQ, seed=0,
                    decode_chunk=CHUNK, **kw)
    eng.place_state(sm.mesh)
    eng.start()
    try:
        tokens = [list(eng.generate_sync(p, JSP(max_new_tokens=NEW),
                                         timeout=WAIT_S)[0])
                  for p in PROMPTS]
    finally:
        eng.stop()
    return tokens, jax.tree.map(lambda a: np.array(a, np.float32),
                                sm.params)


def _build(name, params, **axes):
    return build_serving_engine(
        name, ["cpu", "cpu"], max_batch=MAX_BATCH, max_seq=SEQ,
        decode_chunk=CHUNK, page_size=PS,
        params=None if params is None else params_from_numpy(params, "cpu"),
        **axes)


def _serve(eng, prompts=PROMPTS):
    """Greedy tokens of ``prompts`` one after another on a started
    engine, each reply "length"."""
    out = []
    for p in prompts:
        toks, why = eng.generate_sync(p, TSP(max_new_tokens=NEW),
                                      timeout=WAIT_S)
        assert why == "length", why
        out.append(list(toks))
    return out


def _serve_once(eng):
    eng.start()
    try:
        return _serve(eng)
    finally:
        eng.stop()


def _assert_gone(procs):
    """Every worker exited cleanly (told to stop) and was reaped; this
    process is in no group."""
    assert procs and all(p.poll() == 0 for p in procs), [
        p.poll() for p in procs]
    assert not dist.is_initialized()


def test_dense_program_over_model_equals_the_jax_mesh():
    """No axis given: both devices on the model axis (each rank half the
    heads), gloo on the CPU, eager chunks; tokens equal the JAX mesh's."""
    cfg = get_config("tiny-debug")
    want, params = _jax_program(cfg, 1, 2, 1)
    eng, sm = _build(cfg.name, params, paged=False)
    owner = eng._owner
    procs = list(owner.procs)
    assert sm.mesh.shape == {"data": 1, "model": 2, "expert": 1, "pipe": 1}
    assert owner.backend == "gloo" and len(procs) == 1
    assert eng.flight.meta["graphs"] is False
    assert sm.params["layers"]["wq"].shape[-1] == (
        cfg.n_heads * cfg.head_dim // 2)
    assert _serve_once(eng) == want
    _assert_gone(procs)


def test_sharded_paged_program_equals_jax_and_the_dense_program():
    """``admit_overlap=False``: the sharded paged engine over data 2 (each
    rank its shard of the pool; the last prompt reuses cached pages),
    then the dense program over data 2, one after the other in this
    process: the JAX program's tokens both times."""
    cfg = get_config("tiny-debug")
    want, params = _jax_program(cfg, 2, 1, 1, paged=True)
    eng, sm = _build(cfg.name, params, paged=True, admit_overlap=False)
    assert eng.paged.allocator.n_shards == 2
    assert sm.mesh.shape["data"] == 2 and eng._rows == MAX_BATCH // 2
    procs = list(eng._owner.procs)
    paged = _serve_once(eng)
    assert eng.metrics.counters["prefix_reused_tokens"].value == 2 * PS
    _assert_gone(procs)
    eng, sm = _build(cfg.name, params, paged=False, data=2)
    assert eng.paged is None and sm.mesh.shape["data"] == 2
    dense = _serve_once(eng)
    assert paged == want and dense == want


def test_moe_program_over_expert_equals_the_jax_mesh():
    """tiny-moe over expert 2: each rank holds two of the four experts,
    the MoE block's all-reduce combines them."""
    cfg = get_config("tiny-moe")
    want, params = _jax_program(cfg, 1, 1, 2)
    eng, sm = _build(cfg.name, params, paged=False, expert=2)
    assert sm.mesh.shape == {"data": 1, "model": 1, "expert": 2, "pipe": 1}
    assert sm.params["layers"]["w_gate"].shape[1] == cfg.n_experts // 2
    assert _serve_once(eng) == want


def test_stop_leaves_nothing_and_a_second_program_serves():
    """A program stopped before it started (its worker told through the
    store) and one stopped after serving both leave no worker and no
    process group behind; the next program builds in the same process,
    drawing its weights from the seed on every rank."""
    eng, sm = _build("tiny-debug", None, paged=False)
    procs = list(eng._owner.procs)
    eng.stop()
    _assert_gone(procs)
    assert sm.mesh.axis("model").group is None
    eng, sm = _build("tiny-debug", None, paged=False)
    procs = list(eng._owner.procs)
    assert all(p.poll() is None for p in procs)
    first = _serve_once(eng)
    _assert_gone(procs)
    eng, _sm = _build("tiny-debug", None, paged=False)
    assert _serve_once(eng) == first


def _kill_worker_mid_serve(eng):
    """SIGKILL the worker at the request's first token: how the request
    ended and the seconds from the kill to its end."""
    done, t_kill, out = threading.Event(), [], {}

    def on_token(rid, tok):
        if not t_kill:
            t_kill.append(time.monotonic())
            os.kill(eng._owner.pids()[0], signal.SIGKILL)

    def on_done(rid, toks, why):
        out["why"] = why
        done.set()

    eng.submit(GenRequest(prompt=PROMPTS[0],
                          sampling=TSP(max_new_tokens=SEQ - 8),
                          on_token=on_token, on_done=on_done))
    assert done.wait(WAIT_S), "the request hung after its worker died"
    return out["why"], time.monotonic() - t_kill[0]


def test_killed_worker_fails_loudly_and_restart_serves_again(monkeypatch):
    """A worker killed mid-serve ends the request "engine_error" within
    the group's timeout, and later submits raise; ``restart`` spawns a
    new worker and serves the same tokens. Killed again while idle, the
    coordinator's beat fails, and the supervisor's restart revives it."""
    monkeypatch.setenv("SWARMDB_PG_TIMEOUT_S", "4")
    eng, _sm = _build("tiny-debug", None, paged=False)
    eng.start()
    try:
        want = _serve(eng, PROMPTS[:2])
        old = list(eng._owner.procs)
        why, seconds = _kill_worker_mid_serve(eng)
        assert why == "engine_error" and seconds < 4 + 10, (why, seconds)
        assert eng.stats()["pod"] == "failed"
        with pytest.raises(RuntimeError, match="decode program stopped"):
            eng.submit(GenRequest(prompt=[1, 2], sampling=TSP()))
        eng.restart()
        assert old[0].poll() is not None
        assert eng._owner.pids() != [p.pid for p in old]
        assert eng.stats()["pod"] == "coordinator"
        assert _serve(eng, PROMPTS[:2]) == want
        sup = LaneSupervisor(eng, suspect_s=0.5, quarantine_s=1.0,
                             poll_s=0.05).start()
        try:
            os.kill(eng._owner.pids()[0], signal.SIGKILL)
            deadline = time.monotonic() + WAIT_S
            while (sup.status()["lanes"][0]["restarts"] < 1
                   or not eng.alive()):
                assert time.monotonic() < deadline, sup.status()
                time.sleep(0.05)
            assert _serve(eng, PROMPTS[:2]) == want
        finally:
            sup.stop()
    finally:
        procs = list(eng._owner.procs)
        eng.stop()
    _assert_gone(procs)
