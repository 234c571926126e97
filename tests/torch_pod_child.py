"""One rank of a gloo pod of the PyTorch port, on the CPU.

Run by ``tests/test_torch_tp.py``, ``test_torch_multihost.py``,
``test_torch_dp.py``, ``test_torch_sharded_paged.py``, ``test_torch_ep.py``,
``test_torch_pipeline.py`` and ``test_torch_ring_attention.py``
(``run_pod`` there), never collected by pytest itself:

    python tests/torch_pod_child.py JOB RANK WORLD STORE IN OUT

The ranks meet through a ``file://`` store (``STORE``), so no port is
bound. ``IN`` is an ``.npz`` of inputs (the JAX package's float32 tiny
weights, ``w.*`` by dotted key, plus the job's arrays; ``data``, when
given, is the mesh's data axis, the rest of the ranks its model axis);
``OUT`` receives this rank's results as ``.npz``. The model is
tiny-debug unless ``model`` names another (``n_experts`` and ``window``
override its experts and sliding window); ``expert`` and ``pipe`` size
those axes of the mesh. Jobs:

- ``forward``: the forwards on this rank's share
  (``params_from_numpy(shardings=)``) and its data shard's rows of the
  batch: a bucketed prefill with the head at each row's last token, then
  decode steps through ``forward_chunked`` and one ``merge_chunk``; plus
  a sharded ``restore_params``. A MoE model's forwards count the whole
  batch (``rows``: this shard's block), and its prefill is run once more
  counting the shard's own rows only (``local_logits``).
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
- ``pipe``: ``llama.forward_pipelined`` on this stage's layers
  (``param_plan_pp``) over the pipe axis.
- ``ring``: ``ops.ring_attention`` on this rank's chunk of ``q``/``k``/
  ``v`` (natural order, then the chunks of ``perm``'s order, then with a
  sliding window), and ``llama.forward_seq_parallel`` on its block of
  ``tokens`` (full causal, then with the config's window ``window``).
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


def _cfg(inp):
    """The job's model config (module docstring)."""
    name = str(inp["model"]) if "model" in inp.files else "tiny-debug"
    over = {k: int(inp[k]) for k in ("n_experts",) if k in inp.files}
    return get_config(name, **over)


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


def _shares(inp, mesh, cfg=CFG):
    from swarmdb_tpu_torch.parallel.serving import param_shardings_for

    return params_from_numpy(_tree(inp), "cpu",
                             shardings=(param_shardings_for(cfg, mesh),
                                        mesh))


def job_forward(rank: int, inp, mesh) -> dict:
    from swarmdb_tpu_torch.parallel.mesh import shard_params
    from swarmdb_tpu_torch.parallel.serving import build_sharded_model
    from swarmdb_tpu_torch.utils.checkpoint import restore_params

    cfg = _cfg(inp)
    sm = build_sharded_model(cfg, mesh, params=_shares(inp, mesh, cfg),
                             kv_dtype=torch.float32)
    p, tp = sm.params, sm.model_axis
    out = {"wq_shape": np.asarray(p["layers"]["wq"].shape)}
    if cfg.is_moe:
        out["w_gate_shape"] = np.asarray(p["layers"]["w_gate"].shape)
    # this data shard's rows of the batch
    n = inp["tokens"].shape[0] // mesh.shape["data"]
    rows = slice(mesh.coords["data"] * n, (mesh.coords["data"] + 1) * n)
    tokens = torch.from_numpy(inp["tokens"][rows])
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32).expand(B, T)
    lengths = torch.from_numpy(inp["lengths"][rows])
    # a MoE forward counts the whole batch: this shard's rows of it
    kw = ({"rows": (torch.arange(rows.start, rows.stop),
                    inp["tokens"].shape[0])} if sm.counts_call else {})
    with torch.no_grad():
        # the bucketed prefill: the dense engine's temp cache, its head at
        # each row's last token
        temp = sm.init_cache_fn(B, T)
        last, temp = sm.forward_fn(p, tokens, positions, temp,
                                   logits_at=lengths - 1, **kw)
        out["prefill_logits"] = last.numpy()
        if cfg.is_moe:
            local, _ = sm.forward_fn(p, tokens, positions,
                                     sm.init_cache_fn(B, T),
                                     logits_at=lengths - 1)
            out["local_logits"] = local.numpy()
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
                                    cache, ckv, s, **kw)
            steps.append(logits[:, 0].numpy())
        out["chunk_logits"] = np.stack(steps)
        merge(cache, ckv, pos)
        out["cache_k"] = cache[0].numpy()
        out["cache_v"] = cache[1].numpy()
    out["collectives"] = np.asarray(tp.calls)
    out["axis_calls"] = np.asarray([mesh.axis(a).calls for a in
                                    ("data", "model", "expert")])
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

    cfg = _cfg(inp)
    eng, _sm = build_serving_engine(
        cfg, ["cpu"], data=mesh.shape["data"], model=mesh.shape["model"],
        expert=mesh.shape["expert"], paged=bool(inp["paged"]),
        params=_shares(inp, mesh, cfg),
        max_batch=int(inp["max_batch"]), max_seq=int(inp["max_seq"]),
        decode_chunk=int(inp["chunk"]), page_size=int(inp["page_size"]))
    eng.block_log = []
    out = {"graphs_meta": np.asarray(eng.flight.meta["graphs"]),
           "moe_dispatch": np.asarray(str(eng.flight.meta["moe_dispatch"])),
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


def job_pipe(rank: int, inp, mesh) -> dict:
    from swarmdb_tpu_torch.models.configs import ModelConfig

    cfg = ModelConfig(**json.loads(str(inp["cfg"])))
    params = params_from_numpy(
        _tree(inp), "cpu", shardings=(llama.param_plan_pp(cfg), mesh))
    tokens = torch.from_numpy(inp["tokens"])
    positions = torch.from_numpy(inp["positions"])
    with torch.no_grad():
        logits, (ks, vs) = llama.forward_pipelined(
            params, cfg, tokens, positions, mesh.axis("pipe"),
            microbatches=int(inp["micro"]))
    return {"logits": logits.numpy(), "ks": ks.numpy(), "vs": vs.numpy(),
            "n_layers": np.asarray(params["layers"]["wq"].shape[0]),
            "collectives": np.asarray(mesh.axis("pipe").calls)}


def job_ring(rank: int, inp, mesh) -> dict:
    from dataclasses import replace

    from swarmdb_tpu_torch.ops.ring_attention import ring_attention

    axis, n = mesh.axis("data"), mesh.shape["data"]

    def mine(a):    # this rank's block of the sequence dim (dim 1)
        c = a.shape[1] // n
        return torch.from_numpy(
            np.ascontiguousarray(a[:, rank * c:(rank + 1) * c]))

    q, k, v, pos = (inp[x] for x in ("q", "k", "v", "pos"))
    perm = inp["perm"]
    out = {}
    with torch.no_grad():
        for name, order, window in (("ring", slice(None), None),
                                    ("shuffled", perm, None),
                                    ("windowed", slice(None),
                                     int(inp["window"]))):
            qq, kk, vv, pp = (mine(a[:, order]) for a in (q, k, v, pos))
            out[name] = ring_attention(qq, kk, vv, pp, pp, axis,
                                       window=window).numpy()
        params = params_from_numpy(_tree(inp), "cpu")
        tok, tpos = mine(inp["tokens"]), mine(inp["tok_pos"])
        for name, cfg in (("sp", CFG),
                          ("sp_window", replace(
                              CFG, sliding_window=int(inp["window"])))):
            logits, (ks, vs) = llama.forward_seq_parallel(
                params, cfg, tok, tpos, axis)
            out[f"{name}_logits"] = logits.numpy()
            out[f"{name}_k"], out[f"{name}_v"] = ks.numpy(), vs.numpy()
    out["shifts"] = np.asarray(axis.calls)
    return out


def check_server_pod(tmp_path, model: str) -> None:
    """``python -m swarmdb_tpu_torch.api.server`` with ``SERVE_MODEL=model``
    as two ranks on the CPU (``SERVE_DEVICE=cpu``, gloo): rank 1 joins
    ``worker_loop`` (no HTTP), rank 0 serves; one ``POST /messages`` to an
    LLM-backed agent gets its reply, and SIGTERM to rank 0 releases rank
    1. Raises AssertionError where the pod falls short."""
    import socket
    import subprocess
    import urllib.request

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1",
                SERVE_MODEL=model, SERVE_DEVICE="cpu",
                SERVE_MAX_BATCH="2", SERVE_MAX_SEQ="128", SERVE_CHUNK="4",
                SWARMDB_COORDINATOR=f"file://{tmp_path / 'store'}",
                SWARMDB_NUM_PROCESSES="2", SWARMDB_PG_TIMEOUT_S="30",
                API_HOST="127.0.0.1", API_PORT=str(port),
                API_MAX_REQUESTS="5", BROKER_IMPL="python",
                SAVE_DIR=str(tmp_path / "hist"), JWT_SECRET_KEY="s")
    procs = []
    for rank in (0, 1):
        with open(tmp_path / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "swarmdb_tpu_torch.api.server"],
                env=dict(base, SWARMDB_PROCESS_ID=str(rank)), cwd=tmp_path,
                stdout=log, stderr=subprocess.STDOUT))
    url = f"http://127.0.0.1:{port}"

    def call(path, body=None, token=None):
        req = urllib.request.Request(
            url + path, data=None if body is None else json.dumps(
                body).encode(), method="GET" if body is None else "POST",
            headers={"Content-Type": "application/json",
                     **({"Authorization": f"Bearer {token}"}
                        if token else {})})
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                health = call("/health")
                break
            except OSError:
                assert all(p.poll() is None for p in procs), (
                    (tmp_path / "rank0.log").read_text()[-3000:],
                    (tmp_path / "rank1.log").read_text()[-3000:])
                assert time.monotonic() < deadline, "server never came up"
                time.sleep(0.3)
        tok = call("/auth/token", {"username": "admin",
                                   "password": "pw"})["access_token"]
        for a in ("user", "assistant"):
            call("/agents/register", {"agent_id": a}, tok)
        backend = health["tpu"]["backend_id"]
        call("/admin/llm_backend", {"agent_id": "assistant",
                                    "backend_id": backend}, tok)
        user_tok = call("/auth/token", {"username": "user",
                                        "password": "pw"})["access_token"]
        call("/messages", {"receiver_id": "assistant",
                           "content": "hello pod",
                           "metadata": {"generation": {
                               "max_new_tokens": 6}}}, user_tok)
        reply = []
        deadline = time.monotonic() + 60
        while not reply and time.monotonic() < deadline:
            reply = call("/agents/receive", {"timeout": 1.0}, user_tok)
        assert reply, (tmp_path / "rank0.log").read_text()[-3000:]
        assert reply[0]["sender_id"] == "assistant"
        assert reply[0]["metadata"]["finish_reason"] in ("length", "eos")
        # rank 1 is still in the pod's decode program (no HTTP of its own)
        assert procs[1].poll() is None
        assert "worker joined" in (tmp_path / "rank1.log").read_text()
        assert "API_MAX_REQUESTS ignored" in (tmp_path /
                                             "rank0.log").read_text()
    finally:
        procs[0].terminate()
        try:
            procs[0].wait(timeout=20)
            procs[1].wait(timeout=20)   # released by the coordinator's stop
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    assert procs[1].returncode == 0, (tmp_path / "rank1.log").read_text()


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
    data, expert, pipe = (int(inp[a]) if a in inp.files else 1
                          for a in ("data", "expert", "pipe"))
    mesh = make_mesh(data=data, model=world // (data * expert * pipe),
                     expert=expert, pipe=pipe, device="cpu")
    out = {"forward": job_forward, "engine": job_engine,
           "kill": job_kill, "dp": job_dp, "pipe": job_pipe,
           "ring": job_ring}[job](rank, inp, mesh)
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
