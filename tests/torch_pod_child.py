"""One rank of a gloo pod of the PyTorch port, on the CPU.

Run by ``tests/test_torch_tp.py``, ``test_torch_multihost.py``,
``test_torch_dp.py`` and ``test_torch_sharded_paged.py`` (``run_pod``
there), never collected by pytest itself:

    python tests/torch_pod_child.py JOB RANK WORLD STORE IN OUT

The ranks meet through a ``file://`` store (``STORE``), so no port is
bound. ``IN`` is an ``.npz`` of inputs (the JAX package's float32 tiny
weights, ``w.*`` by dotted key, plus the job's arrays; ``data``, when
given, is the mesh's data axis, the rest of the ranks its model axis);
``OUT`` receives this rank's results as ``.npz``. Jobs:

- ``forward``: the forwards on this rank's share
  (``params_from_numpy(shardings=)``) and its data shard's rows of the
  batch: a bucketed prefill with the head at each row's last token, then
  decode steps through ``forward_chunked`` and one ``merge_chunk``; plus
  a sharded ``restore_params``.
- ``engine``: the dense pod engine (``build_serving_engine``): rank 0
  serves greedy ``generate_sync`` requests one after another, checks the
  pod-mode refusals and stops; rank 1 runs ``worker_loop``. Both log every
  chunk's token block.
- ``kill``: as ``engine``, but rank 1 kills itself (SIGKILL) after two
  chunks and rank 0 records how its request ended.
- ``dp``: the single program over the mesh (``build_serving_engine`` with
  ``data``; ``paged`` picks the sharded paged engine): rank 0 runs the
  ``scenario`` -- ``serial`` (greedy requests one after another),
  ``spread`` (requests at once: which shards held them) or ``hint``
  (one prompt's turns with a shard hint: its prefix-cache hits) -- and
  stops; the other ranks run ``worker_loop``. Every rank logs every
  chunk's gathered token block.
"""

from __future__ import annotations

import json
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
    # this data shard's rows of the batch
    n = inp["tokens"].shape[0] // mesh.shape["data"]
    rows = slice(mesh.coords["data"] * n, (mesh.coords["data"] + 1) * n)
    tokens = torch.from_numpy(inp["tokens"][rows])
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32).expand(B, T)
    lengths = torch.from_numpy(inp["lengths"][rows])
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
        tok = torch.from_numpy(inp["feed"][rows])
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


def job_dp(rank: int, inp, mesh) -> dict:
    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams
    from swarmdb_tpu_torch.parallel.serving import build_serving_engine

    eng, _sm = build_serving_engine(
        CFG, ["cpu"], data=mesh.shape["data"], model=mesh.shape["model"],
        paged=bool(inp["paged"]), params=_shares(inp, mesh),
        max_batch=int(inp["max_batch"]), max_seq=int(inp["max_seq"]),
        decode_chunk=int(inp["chunk"]), page_size=int(inp["page_size"]))
    eng.block_log = []
    out = {"graphs_meta": np.asarray(eng.flight.meta["graphs"]),
           "paged_shards": np.asarray(eng.flight.meta["paged_shards"]),
           "local_rows": np.asarray(eng._last_tokens.shape[0] - 1)}
    if eng.paged is not None:
        out["local_pages"] = np.asarray(eng.cache["k"].shape[1])
    if rank:
        eng.worker_loop()
        out["blocks"] = np.stack(eng.block_log)
        return out
    eng.enable_multihost()
    eng.start()
    prompts = [inp[f"prompt{i}"].tolist()
               for i in range(int(inp["n_prompts"]))]
    new = int(inp["new"])
    scenario = str(inp["scenario"])
    try:
        if scenario == "serial":
            for i, prompt in enumerate(prompts):
                toks, why = eng.generate_sync(
                    prompt, SamplingParams(max_new_tokens=new), timeout=60)
                out[f"tokens{i}"] = np.asarray(toks)
                out[f"reason{i}"] = np.asarray(why)
        elif scenario == "spread":
            done = threading.Event()
            reasons = []

            def on_done(rid, toks, why):
                reasons.append(why)
                if len(reasons) == len(prompts):
                    done.set()

            alloc = eng.paged.allocator
            for prompt in prompts:
                eng.submit(GenRequest(
                    prompt=prompt, sampling=SamplingParams(
                        max_new_tokens=new), on_done=on_done))
            seen = set()
            while not done.wait(0.005):
                with alloc._lock:
                    seen |= {alloc.shard_of(s) for s in alloc._by_slot}
            out["shards_seen"] = np.asarray(sorted(seen))
            out["reasons"] = np.asarray(reasons)
        else:   # hint: one prompt's turns, its shard named
            for _turn in range(3):
                ev = threading.Event()
                eng.submit(GenRequest(
                    prompt=prompts[0], sampling=SamplingParams(
                        max_new_tokens=new), shard_hint=int(inp["hint"]),
                    on_done=lambda rid, t, w, ev=ev: ev.set()))
                assert ev.wait(60)
        out["reused"] = np.asarray(eng.metrics.counters[
            "prefix_reused_tokens"].value)
        steps = [r.get("active_by_shard") for r in eng.flight.steps()]
        out["shard_steps"] = np.asarray(sum(1 for b in steps if b))
        out["pool"] = np.asarray(json.dumps(eng.stats().get("pool")))
    finally:
        eng.stop()
    out["blocks"] = np.stack(eng.block_log)
    return out


def run_pod(job: str, tmp_path, inputs: dict, timeout: float = 120.0,
            env=None, world: int = 2):
    """Run ``job`` on ``world`` ranks (child processes of this script)
    and return ([each rank's outputs as a dict, or None], [return codes],
    [logs]). Each child is killed at ``timeout``: a deadlock fails the
    caller's test instead of hanging it."""
    import subprocess

    inp = str(tmp_path / f"{job}_in.npz")
    np.savez(inp, **inputs)
    store = str(tmp_path / f"{job}_store")
    outs = [str(tmp_path / f"{job}_out{r}.npz") for r in range(world)]
    full_env = dict(os.environ, OMP_NUM_THREADS="1",
                    SWARMDB_PG_TIMEOUT_S="30", **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         store, inp, outs[r]], env=full_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
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
    inp = np.load(inp_path, allow_pickle=False)
    data = int(inp["data"]) if "data" in inp.files else 1
    mesh = make_mesh(data=data, model=world // data, expert=1, device="cpu")
    out = {"forward": job_forward, "engine": job_engine,
           "kill": job_kill, "dp": job_dp}[job](rank, inp, mesh)
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
