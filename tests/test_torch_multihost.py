"""PyTorch port vs JAX reference: the dense engine as a two-rank pod on
the CPU (tensor parallelism over gloo, the coordinator's control plane,
the server's pod mode).

Rank 0's engine (``enable_multihost``) owns the queue and publishes each
device call; rank 1 replays them (``worker_loop``), each on its share of
the JAX package's float32 tiny weights. Greedy ``generate_sync`` on the
pod gives the same tokens as the port's single-process dense engine and
as the JAX package's single-device dense engine (no prefix cache: the
pod engine is built without one), exactly; both ranks decode the same token block in
every chunk (their fed tokens agree); stop releases the worker; restart,
``keep_pages`` and resume are refused. A worker killed mid-request ends
the coordinator's request with "engine_error" well inside its timeout,
and later submits raise. The server entry point with
``SWARMDB_NUM_PROCESSES=2`` answers a ``POST /messages`` while rank 1
runs ``worker_loop``.

Each test runs its ranks as child processes (``tests/torch_pod_child.py``
or the server module) meeting through a ``file://`` store under
``tmp_path``, each killed at a timeout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.backend.engine import Engine as JaxEngine
from swarmdb_tpu.backend.sampling import SamplingParams as JSP
from swarmdb_tpu.backend.tokenizer import default_tokenizer
from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu_torch.backend import service as tsvc
from swarmdb_tpu_torch.backend.sampling import SamplingParams as TSP
from swarmdb_tpu_torch.parallel.multihost import (MAX_NDIM, OP_BEAT,
                                                  OP_CALL, OP_DECODE,
                                                  OP_PREFILL, OP_STOP,
                                                  ControlPlane)
from swarmdb_tpu_torch.utils.convert import params_from_numpy
from torch_pod_child import check_server_pod, params_npz, run_pod

CFG = get_config("tiny-debug")
MAX_BATCH, SEQ, CHUNK, NEW = 4, 64, 4, 10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights():
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jl.init_params(CFG, jax.random.PRNGKey(0)))


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(3, 259, n).astype(np.int32) for n in (7, 21, 12)]


def _jax_tokens(params, prompts):
    """The JAX package's single-device dense engine, chunked, float32
    slot cache, no prefix cache."""
    tok = default_tokenizer(CFG.vocab_size)
    eng = JaxEngine(
        lambda p, t, pos, c: jl.forward(p, CFG, t, pos, c),
        lambda b, s: jl.init_kv_cache(CFG, b, s, jnp.float32),
        jax.tree.map(jnp.asarray, params), max_batch=MAX_BATCH,
        max_seq=SEQ, eos_id=tok.eos_id, pad_id=tok.pad_id, seed=0,
        decode_chunk=CHUNK,
        chunked_fns=(
            lambda p, t, pos, c, hkv, s: jl.forward_chunked(p, CFG, t, pos,
                                                            c, hkv, s),
            lambda b, k: jl.init_chunk_kv(CFG, b, k),
            jl.merge_chunk),
        forward_last_fn=lambda p, t, pos, c, at: jl.forward(
            p, CFG, t, pos, c, logits_at=at))
    eng.start()
    try:
        return [eng.generate_sync(p.tolist(), JSP(max_new_tokens=NEW))
                for p in prompts]
    finally:
        eng.stop()


def _port_tokens(params, prompts, monkeypatch):
    """The port's single-process dense engine, same shape, no prefix."""
    monkeypatch.setenv("SWARMDB_PREFIX", "0")
    eng, _ = tsvc.build_backend_engine(
        "tiny-debug", max_batch=MAX_BATCH, max_seq=SEQ, decode_chunk=CHUNK,
        device="cpu", kv_dtype=torch.float32, paged=False,
        params=params_from_numpy(params, "cpu"))
    assert eng._prefix is None
    eng.start()
    try:
        return [eng.generate_sync(p.tolist(), TSP(max_new_tokens=NEW))
                for p in prompts]
    finally:
        eng.stop()


def test_pod_greedy_tokens_equal_single_engines(tmp_path, monkeypatch):
    params, prompts = _weights(), _prompts()
    inputs = dict(params_npz(params), max_batch=MAX_BATCH, max_seq=SEQ,
                  chunk=CHUNK, new=NEW, n_prompts=len(prompts),
                  **{f"prompt{i}": p for i, p in enumerate(prompts)})
    got, codes, logs = run_pod("engine", tmp_path, inputs)
    # the worker left its loop at the coordinator's stop, and both exited
    assert codes == [0, 0], logs
    coord, worker = got
    pod = [(coord[f"tokens{i}"].tolist(), str(coord[f"reason{i}"]))
           for i in range(len(prompts))]
    assert all(len(t) == NEW and why == "length" for t, why in pod), pod
    assert pod == _port_tokens(params, prompts, monkeypatch)
    assert pod == [(list(t), why) for t, why in _jax_tokens(params,
                                                             prompts)]
    # every chunk: the same [K+1, B] block on both ranks, row 0 = the fed
    # tokens, the last row = the next fed tokens
    assert coord["blocks"].shape == worker["blocks"].shape
    assert coord["blocks"].shape[1:] == (CHUNK + 1, MAX_BATCH)
    np.testing.assert_array_equal(coord["blocks"], worker["blocks"])
    assert coord["pod_stat"] == "coordinator"
    # the chunks ran eagerly: gloo collectives cannot be captured (and
    # this is the CPU)
    assert not bool(worker["graphs_meta"])


def test_pod_refuses_restart_keep_and_resume(tmp_path):
    params, prompts = _weights(), _prompts()[:1]
    inputs = dict(params_npz(params), max_batch=MAX_BATCH, max_seq=SEQ,
                  chunk=CHUNK, new=2, n_prompts=1, prompt0=prompts[0])
    got, codes, logs = run_pod("engine", tmp_path, inputs)
    assert codes == [0, 0], logs
    refused = got[0]["refused"].tolist()
    assert len(refused) == 3, refused
    assert "keep_pages and resume" in refused[0]
    assert "keep_pages and resume" in refused[1]
    assert "cannot restart in place" in refused[2]


def test_killed_worker_fails_the_request_not_the_wait(tmp_path):
    """SIGKILL on rank 1 after two chunks: the coordinator's next
    collective raises, the request ends "engine_error" within its 20 s
    timeout (not "timeout"), the pod is marked failed and a later submit
    raises at once."""
    params = _weights()
    inputs = dict(params_npz(params), max_batch=MAX_BATCH, max_seq=SEQ,
                  chunk=CHUNK, prompt0=_prompts()[0], timeout=20.0)
    got, codes, logs = run_pod("kill", tmp_path, inputs)
    assert codes[1] == -9, logs
    assert codes[0] == 0, logs
    out = got[0]
    assert str(out["reason"]) == "engine_error", out
    assert float(out["seconds"]) < 20.0
    assert "decode program stopped" in str(out["after"])
    assert str(out["pod_stat"]) == "failed"


def test_control_plane_wire_format():
    """Each record's payload packs and unpacks its arrays exactly, beat
    and stop carry none, and an unknown op raises (one process: a
    loopback of the two broadcasts)."""
    plane = ControlPlane(3, axis=None)
    records = []
    plane._send = lambda arr: records.append(np.array(arr, copy=True))
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 9, 3).astype(np.int32)
    keys = rng.integers(0, 2**32, (3, 2)).astype(np.int64)
    temp = rng.random(3).astype(np.float32)
    topk = np.asarray([0, 5, 1], np.int32)
    topp = rng.random(3).astype(np.float32)
    plane.publish_decode(2, pos, keys, temp, topk, topp)
    toks = rng.integers(0, 500, (2, 16)).astype(np.int32)
    lens = np.asarray([16, 3], np.int32)
    scat = np.asarray([1, 3], np.int64)
    plane.publish_prefill(toks, lens, scat, keys[:2], temp[:2], topk[:2],
                          topp[:2])
    plane.publish_beat()
    plane.publish_stop()
    records += [np.asarray([9, 0, 0, 1], np.int64), np.zeros(1, np.uint8)]
    replay = iter(records)
    plane._recv = lambda shape, dtype: next(replay)
    op, args = plane.receive()
    assert op == OP_DECODE and args[0] == 2
    for want, have in zip((pos, keys, temp, topk, topp), args[1:]):
        np.testing.assert_array_equal(want, have)
    op, args = plane.receive()
    assert op == OP_PREFILL
    for want, have in zip((toks, lens, scat, keys[:2], temp[:2], topk[:2],
                           topp[:2]), args):
        np.testing.assert_array_equal(want, have)
    assert plane.receive() == (OP_BEAT, None)
    assert plane.receive() == (OP_STOP, None)
    with pytest.raises(ValueError, match="unknown control op 9"):
        plane.receive()


def test_mirrored_call_wire_format():
    """OP_CALL: arguments of varying shapes, dtypes and ranks (an empty
    one included) come back exactly from the descriptor matrix and the
    packed payload; a call of no arguments sends no payload; an argument
    the wire cannot carry raises at publish (one process: a loopback)."""
    plane = ControlPlane(3, axis=None)
    records = []
    plane._send = lambda arr: records.append(np.array(arr, copy=True))
    rng = np.random.default_rng(1)
    calls = [
        (3, [np.asarray([0, 2], np.int32),
             rng.integers(0, 99, (2, 5)).astype(np.int32)]),
        (5, [rng.integers(0, 500, (4, 16)).astype(np.int32),
             np.ones(4, np.int32), np.zeros((4, 0), np.int32),
             np.full(4, 3, np.int64),
             rng.integers(0, 2**32, (4, 2)).astype(np.int64),
             rng.random(4).astype(np.float32),
             np.arange(24, dtype=np.uint32).reshape(1, 2, 3, 4)]),
        # the dense prefix lane's wave (call 4): tokens, lengths, prefix
        # lengths, the hit table, the registered pages' rows, lane columns
        # and pool ids (the first wave registers none), the scatter and
        # the rows' sampling
        (4, [rng.integers(0, 500, (4, 32)).astype(np.int32),
             np.asarray([5, 3, 1, 1], np.int32),
             np.asarray([16, 0, 0, 0], np.int32),
             np.asarray([[3, 7], [0, 0], [0, 0], [0, 0]], np.int32),
             np.zeros(0, np.int64), np.zeros(0, np.int64),
             np.zeros(0, np.int64),
             np.asarray([0, 2, 4, 4], np.int64),
             rng.integers(0, 2**32, (4, 2)).astype(np.int64),
             np.zeros(4, np.float32), np.zeros(4, np.int32),
             np.ones(4, np.float32)]),
        (4, [rng.integers(0, 500, (2, 16)).astype(np.int32),
             np.asarray([16, 9], np.int32), np.zeros(2, np.int32),
             np.zeros((2, 1), np.int32),
             np.asarray([0, 0, 1], np.int64), np.asarray([0, 1, 0], np.int64),
             np.asarray([5, 6, 9], np.int64), np.asarray([1, 3], np.int64),
             rng.integers(0, 2**32, (2, 2)).astype(np.int64),
             rng.random(2).astype(np.float32), np.asarray([0, 3], np.int32),
             rng.random(2).astype(np.float32)]),
        (1, []),
    ]
    for call_id, args in calls:
        plane.publish_call(call_id, args)
    # the no-argument call is a header alone
    assert records[-1].tolist() == [OP_CALL, 1, 0, 0]
    for bad in (np.zeros((1,) * (MAX_NDIM + 1), np.int32),
                np.zeros(2, np.float64)):
        with pytest.raises(ValueError):
            plane.publish_call(0, [bad])
    replay = iter(records)
    plane._recv = lambda shape, dtype: next(replay)
    for call_id, args in calls:
        op, got = plane.receive()
        assert op == OP_CALL and got[0] == call_id
        assert len(got) == 1 + len(args)
        for want, have in zip(args, got[1:]):
            assert have.dtype == want.dtype and have.shape == want.shape
            np.testing.assert_array_equal(want, have)


def test_server_pod_mode_answers_a_message(tmp_path):
    """``python -m swarmdb_tpu_torch.api.server`` as two ranks on the CPU
    (``SERVE_DEVICE=cpu``, gloo): rank 1 joins ``worker_loop`` (no HTTP),
    rank 0 serves; one ``POST /messages`` to an LLM-backed agent gets its
    reply, and SIGTERM to rank 0 releases rank 1
    (``torch_pod_child.check_server_pod``)."""
    check_server_pod(tmp_path, "tiny-debug")


def test_exit_hook_ends_the_group_while_a_mesh_holds_it(tmp_path):
    """``init_distributed``'s exit hook ends the process group (its gloo
    worker threads joined) even while a mesh's axes still reference it:
    a worker left alive into interpreter finalization may free a
    collective's tensor then and abort the process after a clean run
    ("terminate called without an active exception"; ~2% of one-rank
    pods exiting 8 at once before the axes let go)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import os, torch\n"
        "from swarmdb_tpu_torch.parallel.distributed import"
        " destroy_distributed, init_distributed\n"
        "from swarmdb_tpu_torch.parallel.mesh import make_mesh\n"
        "n0 = len(os.listdir('/proc/self/task'))\n"
        f"init_distributed('file://{tmp_path / 'store'}', 1, 0,"
        " device='cpu')\n"
        "mesh = make_mesh(device='cpu')\n"
        "mesh.axis('model').all_reduce(torch.ones(8))\n"
        "n1 = len(os.listdir('/proc/self/task'))\n"
        "destroy_distributed()\n"
        "n2 = len(os.listdir('/proc/self/task'))\n"
        "assert n1 > n0 and n2 <= n0, (n0, n1, n2)\n"
        "assert mesh.axis('model').all_reduce(torch.ones(2)).sum() == 2\n"
        "print('ok')\n")
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=str(root),
                         env=dict(os.environ, PYTHONPATH=str(root),
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
