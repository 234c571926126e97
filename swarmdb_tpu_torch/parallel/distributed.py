"""Multi-process initialisation: one ``torch.distributed`` process group
for a pod of serving processes.

The counterpart of ``swarmdb_tpu/parallel/distributed.py``. The JAX
package joins its hosts with ``jax.distributed.initialize``, after which
one mesh spans every host's devices. PyTorch has no global mesh: each
process is one rank of a process group, holds its own device, and the
ranks meet in collectives (``parallel/collectives.py``). Rank 0, the
coordinator, owns the HTTP ingress, the broker and the request queue; the
other ranks replay its device calls (``parallel/multihost.py``,
``Engine.worker_loop``).

Environment, as in the JAX package (all optional on one process):

  SWARMDB_COORDINATOR    host:port of rank 0's rendezvous store (TCP)
  SWARMDB_NUM_PROCESSES  the number of processes
  SWARMDB_PROCESS_ID     this process's rank
  SWARMDB_PG_TIMEOUT_S   how long a collective may wait for a peer before
                         it raises (default 120): a dead rank fails the
                         pod loudly instead of wedging it

The backend follows the device: NCCL on ``cuda`` (one card per rank),
gloo on ``cpu``. ``backend="gloo"`` with a ``cuda`` device is for ranks
that share one card, which NCCL refuses.

A program that spawns its own ranks (``parallel/local.py``) joins its
group through a store it owns (``store=``) and ends it with
``destroy_distributed`` when it stops, so that the process is no rank of
any group after (``dist.is_initialized()`` is what makes
``build_serving_engine`` take a process for a pod rank) and can build
another program.
"""

from __future__ import annotations

import atexit
import datetime
import gc
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device
from .collectives import release_groups

logger = logging.getLogger("swarmdb_tpu_torch.distributed")

__all__ = ["destroy_distributed", "init_distributed", "is_coordinator",
           "pg_timeout_s"]

#: whether the exit hook is registered (once for the process)
_AT_EXIT = False


def pg_timeout_s() -> float:
    """Seconds a collective waits for its peers (``SWARMDB_PG_TIMEOUT_S``)."""
    return float(os.environ.get("SWARMDB_PG_TIMEOUT_S", "120"))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None,
                     device: DeviceLike = None,
                     store: Optional[dist.Store] = None) -> bool:
    """Join the process group when a coordinator is configured (the
    argument or ``SWARMDB_COORDINATOR``) or a ``store`` is given;
    idempotent. Returns True when this process is one rank of a group
    (now or already), False for a single process without one (nothing
    done).

    ``coordinator_address`` is ``host:port`` (a TCP store on rank 0), or a
    full ``tcp://`` / ``file://`` init method; ``store`` is a store the
    caller made (``parallel/local.py``'s). ``device`` (default the
    card) picks NCCL on ``cuda`` and gloo on ``cpu``; ``backend``
    overrides it. On ``cuda`` the rank binds its device and, under NCCL,
    creates its communicator at once (``device_id``), so the first
    collective never runs inside a CUDA graph capture."""
    if dist.is_initialized():
        return True
    coordinator_address = (coordinator_address
                           or os.environ.get("SWARMDB_COORDINATOR"))
    if num_processes is None:
        num_processes = int(os.environ.get("SWARMDB_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("SWARMDB_PROCESS_ID", "0"))
    if coordinator_address is None and store is None:
        return False
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if store is not None:
        kwargs = {"store": store}
    else:
        kwargs = {"init_method": (
            coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(
        backend, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=pg_timeout_s()), **kwargs)
    logger.info("distributed init: rank %d of %d over %s on %s",
                process_id, num_processes, backend, dev)
    # a group still alive when the interpreter finalizes can abort the
    # process after a clean run (``collectives`` module docstring): end
    # it first
    global _AT_EXIT
    if not _AT_EXIT:
        _AT_EXIT = True
        atexit.register(destroy_distributed)
    return True


def destroy_distributed() -> None:
    """Leave the process group, if any: destroy it and every subgroup,
    and let every mesh axis go of its group. Afterwards the axes'
    collectives are the identity and ``dist.is_initialized()`` is False.
    Also the exit hook of ``init_distributed``."""
    if dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception:
            logger.exception("process group teardown failed")
    # the group ends (its worker threads joined) only once nothing holds
    # it: the mesh's axes let go, and a cycle that holds one is collected
    release_groups()
    gc.collect()


def is_coordinator() -> bool:
    """True on rank 0 (or outside a process group): the process that owns
    the HTTP ingress, the broker and the request queue."""
    return not dist.is_initialized() or dist.get_rank() == 0
