"""The single program over the devices of one process: the ranks it
spawns, and their entry point.

The counterpart of the JAX package's one-process mesh, where
``build_serving_engine(cfg)`` over every local chip is one GSPMD program
in one process. The port runs the single program as one rank per device
(``distributed.py``), so ``build_serving_engine`` called with several
devices in a process that is no rank of a group makes the ranks itself:
the calling process becomes rank 0, the coordinator, on the first device,
and ``LocalProgram`` spawns rank r on device r as a fresh interpreter
(``python -m swarmdb_tpu_torch.parallel.local``; never ``fork``: the
caller may hold a CUDA context). Every rank builds its engine as a pod
rank does (``serving._single_program``); the workers then run
``Engine.worker_loop`` and the coordinator serves.

- The ranks meet on a ``FileStore`` in a temporary directory the program
  owns, a new one for each set of workers.
- The backend follows the devices, as ``init_distributed``'s does: NCCL
  when every rank has a card of its own, gloo on the CPU or when a card
  repeats (then chunks run eagerly: gloo collectives cannot be captured).
- Weights: drawn from the seed by every rank, each keeping its share
  (``init_params(keep=)``); or, given whole as ``params``, written once by
  the coordinator (``utils.checkpoint.save_params``) and read by each
  worker as its share (``restore_params(shardings=)``).
- The workers get the caller's environment as it was at the call (the
  ``SWARMDB_*`` knobs fix every rank's engine shape, as they must) and its
  intra-op thread count.
- The handshake, on store keys: ``joined/r`` before worker r enters the
  process group, ``ready/r`` once its engine is built (``failed/r`` with
  its traceback if the build raised), then ``cmd``: ``go`` when the
  coordinator's engine starts (the workers enter ``worker_loop``) or
  ``stop``. The coordinator's waits are bounded by ``SWARMDB_PG_TIMEOUT_S``
  and by the workers' processes: a worker that dies or fails makes the
  build raise with the tail of its log. There is no fallback to fewer
  devices.
- Lifecycle (``Engine.start`` / ``stop`` / ``restart`` call ``go``,
  ``close`` and ``respawn``): ``close`` tells the workers to stop, joins
  them within ``JOIN_S``, kills any left, and ends the process group and
  every axis's subgroup, so that the process is no rank of a group after
  and can build another program. ``respawn`` spawns new workers on a new
  store and gives the coordinator's mesh axes the new groups (its
  engine's forwards hold those axes). An exit hook closes a program that
  was never stopped. A pod launched from outside (``init_distributed``
  in each process) has no owner and cannot restart in place.
"""

from __future__ import annotations

import atexit
import logging
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..models.configs import ModelConfig
from ..utils.device import resolve_device
from .distributed import destroy_distributed, init_distributed, pg_timeout_s
from .mesh import MESH_AXES, make_mesh, shard_params

logger = logging.getLogger("swarmdb_tpu_torch.local")

__all__ = ["JOIN_S", "LocalProgram", "backend_for", "build_local_program"]

#: seconds a stopped worker has to exit before it is killed
JOIN_S = 30.0
#: the log tail an error carries
_TAIL = 4000
_POLL_S = 0.02


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a card of its own, else gloo (the CPU, or
    a card that repeats: NCCL refuses two ranks on one device)."""
    cuda = all(d.type == "cuda" for d in devices)
    distinct = len({(d.type, d.index) for d in devices}) == len(devices)
    return "nccl" if cuda and distinct else "gloo"


def _build_rank(spec: Dict[str, Any], rank: int, params: Any = None):
    """Rank ``rank``'s engine of the program ``spec`` (rank 0 with the
    caller's whole ``params``, on its device; a worker reads its share of
    the checkpoint)."""
    from ..utils.checkpoint import restore_params
    from .serving import _single_program

    dev = resolve_device(spec["devices"][rank])
    ckpt = spec["ckpt"]
    load: Optional[Callable] = None
    if params is not None:
        def load(plan, mesh):
            return shard_params(params, plan, mesh)
    elif ckpt is not None:
        def load(plan, mesh):
            return restore_params(ckpt, device=dev, shardings=(plan, mesh))
    return _single_program(spec["cfg"], dev, load=load, **spec["engine"])


class LocalProgram:
    """The workers of one single program and the process group they form
    with this process (rank 0). ``spec`` is what every rank builds:
    ``cfg``, ``devices`` (one per rank, as strings), ``engine``
    (``_single_program``'s keywords) and ``ckpt`` (the whole weights'
    file, or None: every rank draws them from the seed)."""

    def __init__(self, spec: Dict[str, Any], home: str) -> None:
        self.spec = spec
        self.world = len(spec["devices"])
        self.backend = backend_for([resolve_device(d)
                                    for d in spec["devices"]])
        self.home = home
        self.generation = 0
        self.procs: List[subprocess.Popen] = []
        self.store: Optional[dist.Store] = None
        #: the workers were told to serve (``go``)
        self.started = False
        #: seconds of the latest spawn: to the group formed, to every
        #: rank's engine built
        self.timings: Dict[str, float] = {}
        #: rank 0's mesh, whose axes a respawn gives the new groups
        self.mesh = None
        self._engine: Optional[weakref.ref] = None
        self._env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self._env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [self._env.get("PYTHONPATH")] if p])
        self._spec_path = os.path.join(home, "spec.pkl")
        with open(self._spec_path, "wb") as f:
            pickle.dump(dict(spec, threads=torch.get_num_threads()), f)
        weakref.finalize(self, shutil.rmtree, home, True)

    # ------------------------------------------------------------ state

    @property
    def running(self) -> bool:
        """Whether workers and a process group exist (between a spawn
        and ``close``)."""
        return self.store is not None

    def pids(self) -> List[int]:
        """The workers' process ids, rank 1 first."""
        return [p.pid for p in self.procs]

    def _gen_dir(self) -> str:
        return os.path.join(self.home, f"gen{self.generation}")

    def _log(self, rank: int) -> str:
        return os.path.join(self._gen_dir(), f"rank{rank}.log")

    def _tail(self, rank: int) -> str:
        try:
            with open(self._log(rank), encoding="utf-8",
                      errors="replace") as f:
                return f.read()[-_TAIL:]
        except OSError:
            return ""

    # ------------------------------------------------------------ spawn

    def spawn(self, build: Callable[[], Any]) -> Any:
        """Start the workers, form the process group with them, run
        ``build`` (this rank's part of the program) and wait for every
        worker's engine. Returns what ``build`` returned; raises, the
        workers gone, if any rank failed."""
        self.generation += 1
        os.makedirs(self._gen_dir())
        t0 = time.perf_counter()
        self.store = dist.FileStore(os.path.join(self._gen_dir(), "store"),
                                    self.world)
        self.started = False
        for rank in range(1, self.world):
            with open(self._log(rank), "wb") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, self._spec_path,
                     self._gen_dir(), str(rank)],
                    env=self._env, stdout=log, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL))
        try:
            self._await("joined")
            init_distributed(num_processes=self.world, process_id=0,
                             backend=self.backend,
                             device=self.spec["devices"][0],
                             store=self.store)
            if self.generation == 1:
                # after init_distributed's own exit hook, so that this one
                # runs first (last in, first out): it stops the engine
                # while the group is still there to tell the workers
                atexit.register(_close_at_exit, weakref.ref(self))
            self.timings["spawn_s"] = time.perf_counter() - t0
            out = build()
            self._await("ready")
            self.timings["init_s"] = time.perf_counter() - t0
        except BaseException:
            self.close(wait=False)
            raise
        logger.info("single program over %d devices (%s): workers %s, "
                    "built in %.1f s", self.world, self.backend,
                    self.pids(), self.timings["init_s"])
        return out

    def _await(self, key: str) -> None:
        """Wait until every worker set ``key/r``: bounded by the process
        group's timeout, and failing at once on a worker that failed or
        exited."""
        deadline = time.monotonic() + pg_timeout_s()
        pending = set(range(1, self.world))
        while pending:
            for rank in sorted(pending):
                if self.store.check([f"failed/{rank}"]):
                    raise RuntimeError(
                        f"rank {rank} of the single program failed to "
                        f"build:\n{self.store.get(f'failed/{rank}').decode()}"
                        f"\n{self._tail(rank)}")
                if self.store.check([f"{key}/{rank}"]):
                    pending.discard(rank)
                    continue
                code = self.procs[rank - 1].poll()
                if code is not None:
                    raise RuntimeError(
                        f"rank {rank} of the single program exited with "
                        f"{code} before '{key}':\n{self._tail(rank)}")
            if pending and time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks {sorted(pending)} of the single program not "
                    f"'{key}' within {pg_timeout_s():g} s:\n"
                    + "\n".join(self._tail(r) for r in sorted(pending)))
            if pending:
                time.sleep(_POLL_S)

    # -------------------------------------------------------- lifecycle

    def attach(self, engine) -> None:
        """``engine`` (rank 0's) owns this program: its start, stop and
        restart drive the workers; the exit hook stops it."""
        self._engine = weakref.ref(engine)
        engine._owner = self

    def go(self) -> None:
        """The coordinator's engine starts: the workers enter their loop."""
        self.store.set("cmd", "go")
        self.started = True

    def close(self, plane=None, wait: bool = True) -> None:
        """Stop the workers (over the control plane ``plane`` once they
        serve, else through the store), join them within ``JOIN_S``, kill
        any left (at once without ``wait``: a failed build), and end the
        process group."""
        if self.store is None:
            return
        told = wait
        try:
            if not wait:
                pass
            elif not self.started:
                self.store.set("cmd", "stop")
            elif plane is not None:
                plane.publish_stop()
            else:
                told = False
        except Exception:
            # a dead rank fails the broadcast: the others are killed
            logger.exception("single program stop failed")
            told = False
        deadline = time.monotonic() + (JOIN_S if told else 0.0)
        for proc in self.procs:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                logger.error("worker %d did not exit; killing it", proc.pid)
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        self.procs = []
        self.store = None
        self.started = False
        destroy_distributed()
        shutil.rmtree(self._gen_dir(), ignore_errors=True)

    def respawn(self, engine) -> None:
        """New workers for ``engine`` (rank 0's, its state reset), on a new
        store: the coordinator's mesh axes take the new groups, and its
        engine publishes to the new workers."""
        mesh = self.mesh

        def rebind():
            fresh = make_mesh(device=mesh.device, **mesh.shape)
            for name in MESH_AXES:
                old, new = mesh.axis(name), fresh.axis(name)
                old.group, old.backend = new.group, new.backend

        self.spawn(rebind)
        engine.enable_multihost()


def _close_at_exit(ref: "weakref.ref[LocalProgram]") -> None:
    """A program never stopped: its engine's stop ends the workers."""
    program = ref()
    if program is None:
        return
    engine = program._engine() if program._engine is not None else None
    if engine is not None:
        engine.stop()
    program.close()


def build_local_program(cfg: ModelConfig, devices: Sequence[torch.device],
                        engine_kw: Dict[str, Any],
                        params: Optional[Dict[str, Any]] = None):
    """(Engine, ShardedModel) of the single program over ``devices``, one
    rank each, this process rank 0 (module docstring). ``engine_kw`` are
    ``_single_program``'s keywords, every axis resolved; ``params`` the
    whole weights on the first device, or None to draw them from
    ``seed``."""
    home = tempfile.mkdtemp(prefix="swarmdb_local_")
    ckpt = None
    if params is not None:
        from ..utils.checkpoint import save_params

        ckpt = save_params(params, os.path.join(home, "params.pt"))
    spec = {"cfg": cfg, "devices": [str(d) for d in devices],
            "engine": dict(engine_kw, metrics=None, flight_dir=None),
            "ckpt": ckpt}
    program = LocalProgram(spec, home)
    engine, sm = program.spawn(lambda: _build_rank(
        dict(spec, engine=engine_kw), 0, params))
    program.mesh = sm.mesh
    engine.enable_multihost()
    program.attach(engine)
    return engine, sm


# ------------------------------------------------------------- worker


def _wait_cmd(store: dist.Store, parent: int) -> str:
    """The coordinator's ``go`` or ``stop``; ``stop`` too if it died."""
    while not store.check(["cmd"]):
        if os.getppid() != parent:
            return "stop"
        time.sleep(_POLL_S)
    return store.get("cmd").decode()


def main(argv: Optional[Sequence[str]] = None) -> int:
    """A worker: ``python -m swarmdb_tpu_torch.parallel.local SPEC DIR
    RANK`` (the program's spec file, its generation's directory, this
    rank). Joins the group, builds its engine, waits for ``go`` and replays
    the coordinator's calls until it publishes stop."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    spec_path, gen_dir, rank = argv if argv is not None else sys.argv[1:4]
    rank = int(rank)
    parent = os.getppid()
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(spec["threads"])
    world = len(spec["devices"])
    store = dist.FileStore(os.path.join(gen_dir, "store"), world)
    store.set(f"joined/{rank}", "1")
    try:
        init_distributed(num_processes=world, process_id=rank,
                         backend=backend_for([resolve_device(d) for d in
                                              spec["devices"]]),
                         device=spec["devices"][rank], store=store)
        engine, _sm = _build_rank(spec, rank)
    except BaseException:
        store.set(f"failed/{rank}", traceback.format_exc()[-_TAIL:])
        raise
    store.set(f"ready/{rank}", "1")
    if _wait_cmd(store, parent) == "go":
        engine.worker_loop()
    del engine
    destroy_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
