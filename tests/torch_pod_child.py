"""One rank of a two-process gloo pod of the PyTorch port, on the CPU.

Run by ``tests/test_torch_tp.py`` and ``tests/test_torch_multihost.py``
(``run_pod`` there), never collected by pytest itself:

    python tests/torch_pod_child.py JOB RANK WORLD STORE IN OUT

The ranks meet through a ``file://`` store (``STORE``), so no port is
bound. ``IN`` is an ``.npz`` of inputs (the JAX package's float32 tiny
weights, ``w.*`` by dotted key, plus the job's arrays); ``OUT`` receives
this rank's results as ``.npz``. Jobs:

- ``forward``: the tensor-parallel forwards on this rank's share
  (``params_from_numpy(shardings=)``): a bucketed prefill with the head
  at each row's last token, then decode steps through ``forward_chunked``
  and one ``merge_chunk``; plus a sharded ``restore_params``.
- ``engine``: the dense pod engine (``build_serving_engine``): rank 0
  serves greedy ``generate_sync`` requests one after another, checks the
  pod-mode refusals and stops; rank 1 runs ``worker_loop``. Both log every
  chunk's token block.
- ``kill``: as ``engine``, but rank 1 kills itself (SIGKILL) after two
  chunks and rank 0 records how its request ended.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from swarmdb_tpu_torch.models import llama  # noqa: E402
from swarmdb_tpu_torch.models.configs import get_config  # noqa: E402
from swarmdb_tpu_torch.parallel.distributed import (  # noqa: E402
    init_distributed)
from swarmdb_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from swarmdb_tpu_torch.utils.convert import params_from_numpy  # noqa: E402

CFG = get_config("tiny-debug")


def _tree(npz) -> dict:
    tree: dict = {}
    for key in npz.files:
        if not key.startswith("w."):
            continue
        node = tree
        parts = key[2:].split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = npz[key]
    return tree


def _shares(inp, mesh):
    return params_from_numpy(_tree(inp), "cpu",
                             shardings=(llama.param_plan(CFG), mesh))


def job_forward(rank: int, inp, mesh) -> dict:
    from swarmdb_tpu_torch.parallel.mesh import shard_params
    from swarmdb_tpu_torch.parallel.serving import build_sharded_model
    from swarmdb_tpu_torch.utils.checkpoint import restore_params

    sm = build_sharded_model(CFG, mesh, params=_shares(inp, mesh),
                             kv_dtype=torch.float32)
    p, tp = sm.params, sm.model_axis
    out = {"wq_shape": np.asarray(p["layers"]["wq"].shape)}
    tokens = torch.from_numpy(inp["tokens"])
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32).expand(B, T)
    lengths = torch.from_numpy(inp["lengths"])
    with torch.no_grad():
        # the bucketed prefill: the dense engine's temp cache, its head at
        # each row's last token
        temp = sm.init_cache_fn(B, T)
        last, temp = sm.forward_fn(p, tokens, positions, temp,
                                   logits_at=lengths - 1)
        out["prefill_logits"] = last.numpy()
        # the slot cache holds the prefill, then K decode steps go into the
        # chunk buffer, then one merge
        S = int(inp["max_seq"])
        cache = sm.init_cache_fn(B, S)
        for full, fresh in zip(cache, temp):
            full[:, :, :T] = fresh
        chunk_fwd, init_chunk, merge = sm.chunked_fns
        K = int(inp["chunk"])
        ckv = init_chunk(B, K)
        ckv = tuple(t.float() for t in ckv)
        pos = lengths.clone()
        tok = torch.from_numpy(inp["feed"])
        steps = []
        for s in range(K):
            logits, ckv = chunk_fwd(p, tok[:, s:s + 1], (pos + s)[:, None],
                                    cache, ckv, s)
            steps.append(logits[:, 0].numpy())
        out["chunk_logits"] = np.stack(steps)
        merge(cache, ckv, pos)
        out["cache_k"] = cache[0].numpy()
        out["cache_v"] = cache[1].numpy()
    out["collectives"] = np.asarray(tp.calls)
    # a sharded checkpoint: this rank reads only its slices, bit for bit
    whole = restore_params(str(inp["ckpt"]), device="cpu")
    got = restore_params(str(inp["ckpt"]), device="cpu",
                         shardings=(sm.param_shardings, mesh))
    want = shard_params(whole, sm.param_shardings, mesh)
    out["ckpt_equal"] = np.asarray(_bit_equal(got, want))
    return out


def _bit_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bit_equal(a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _engine(inp, mesh):
    from swarmdb_tpu_torch.parallel.serving import build_serving_engine

    eng, _sm = build_serving_engine(
        CFG, ["cpu"], model=mesh.shape["model"], params=_shares(inp, mesh),
        kv_dtype=torch.float32, max_batch=int(inp["max_batch"]),
        max_seq=int(inp["max_seq"]), decode_chunk=int(inp["chunk"]))
    eng.block_log = []
    return eng


def job_engine(rank: int, inp, mesh) -> dict:
    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams

    eng = _engine(inp, mesh)
    out = {"graphs_meta": np.asarray(eng.flight.meta["graphs"])}
    if rank:
        eng.worker_loop()
        out["blocks"] = np.stack(eng.block_log)
        return out
    eng.enable_multihost()
    refused = []
    eng.start()
    try:
        prompts = [inp[f"prompt{i}"].tolist()
                   for i in range(int(inp["n_prompts"]))]
        new = int(inp["new"])
        for i, prompt in enumerate(prompts):
            toks, why = eng.generate_sync(
                prompt, SamplingParams(max_new_tokens=new), timeout=60)
            out[f"tokens{i}"] = np.asarray(toks)
            out[f"reason{i}"] = np.asarray(why)
        for kw in ({"keep_pages": True},
                   {"resume_pages": [1], "resume_len": 4}):
            try:
                eng.submit(GenRequest(prompt=prompts[0],
                                      sampling=SamplingParams(), **kw))
            except ValueError as exc:
                refused.append(str(exc))
        try:
            eng.restart()
        except RuntimeError as exc:
            refused.append(str(exc))
        out["pod_stat"] = np.asarray(eng.stats()["pod"])
    finally:
        eng.stop()
    out["refused"] = np.asarray(refused)
    out["blocks"] = np.stack(eng.block_log)
    return out


def job_kill(rank: int, inp, mesh) -> dict:
    from swarmdb_tpu_torch.backend.sampling import SamplingParams

    eng = _engine(inp, mesh)
    if rank:
        def die():
            while len(eng.block_log) < 2:
                time.sleep(0.005)
            os.kill(os.getpid(), signal.SIGKILL)

        threading.Thread(target=die, daemon=True).start()
        eng.worker_loop()
        return {}
    eng.enable_multihost()
    eng.start()
    t0 = time.monotonic()
    try:
        toks, why = eng.generate_sync(
            inp["prompt0"].tolist(),
            SamplingParams(max_new_tokens=int(inp["max_seq"]) // 2),
            timeout=float(inp["timeout"]))
    except TimeoutError:
        toks, why = [], "timeout"
    out = {"reason": np.asarray(why), "seconds": np.asarray(
        time.monotonic() - t0), "n_tokens": np.asarray(len(toks))}
    try:
        eng.generate_sync([5, 6, 7], SamplingParams(max_new_tokens=2),
                          timeout=5)
        out["after"] = np.asarray("served")
    except RuntimeError as exc:
        out["after"] = np.asarray(str(exc))
    out["pod_stat"] = np.asarray(eng.stats()["pod"])
    eng.stop()
    return out


def run_pod(job: str, tmp_path, inputs: dict, timeout: float = 120.0,
            env=None):
    """Run ``job`` on two ranks (two child processes of this script) and
    return ([rank 0's outputs, rank 1's] as dicts or None, [return codes]).
    Each child is killed at ``timeout``: a deadlock fails the caller's
    test instead of hanging it."""
    import subprocess

    inp = str(tmp_path / f"{job}_in.npz")
    np.savez(inp, **inputs)
    store = str(tmp_path / f"{job}_store")
    outs = [str(tmp_path / f"{job}_out{r}.npz") for r in range(2)]
    full_env = dict(os.environ, OMP_NUM_THREADS="1",
                    SWARMDB_PG_TIMEOUT_S="30", **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), "2",
         store, inp, outs[r]], env=full_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    deadline = time.monotonic() + timeout
    codes, logs = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        codes.append(p.returncode)
        logs.append(out)
    results = []
    for path in outs:
        if os.path.exists(path):
            with np.load(path, allow_pickle=False) as z:
                results.append({k: z[k] for k in z.files})
        else:
            results.append(None)
    return results, codes, logs


def params_npz(params) -> dict:
    """A nested dict of numpy arrays as flat ``w.<dotted key>`` entries."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"w.{prefix}{k}"] = np.asarray(v)

    walk(params, "")
    return flat


def main() -> int:
    job, rank, world, store, inp_path, out_path = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    init_distributed(f"file://{store}", world, rank, device="cpu")
    mesh = make_mesh(data=1, model=world, expert=1, device="cpu")
    inp = np.load(inp_path, allow_pickle=False)
    out = {"forward": job_forward, "engine": job_engine,
           "kill": job_kill}[job](rank, inp, mesh)
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
