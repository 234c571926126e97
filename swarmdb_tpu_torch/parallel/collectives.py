"""The collectives of one mesh axis: the one place that knows a backend's
limits.

The JAX package never writes a collective: GSPMD inserts them from the
sharding annotations. The port's tensor-parallel forwards call these
instead (``models/llama.py``'s ``tp=`` argument), and the control plane
broadcasts through them (``parallel/multihost.py``):

- ``all_reduce``: the sum over the axis, in place (after the row-split
  ``wo`` and ``w_down``);
- ``gather_last``: every rank's tensor concatenated along the last dim, in
  rank order (the vocab-split logits);
- ``embed``: the lookup into a vocab-split table, each rank's rows masked
  to its own ids, then summed (one rank contributes each row, the others
  exact zeros, so the sum is the full table's row bit for bit);
- ``broadcast``: rank 0's tensor to every rank;
- ``shift``: the ring step (``lax.ppermute`` with the perm ``[(i, i + 1
  mod n)]``): each rank's tensor to the next index, the previous index's
  received (ring attention's K/V rotation, the pipeline's stage hand-off).

Backends, as the card's machine has them:

- NCCL (one card per rank): collectives on the card's tensors, and they
  may be captured into a CUDA graph (``capturable``), so the engine
  replays its decode chunks as graphs.
- gloo: collectives on CPU tensors, and, for ranks that share one card
  (NCCL refuses two ranks of one communicator on one device), on CUDA
  tensors, which gloo copies through host memory itself. A gloo
  collective cannot be captured: the engine runs its chunks eagerly. The
  control plane's payload lives on the CPU under gloo (``wire_device``).
  gloo's point-to-point sends take CPU tensors only: ``shift`` stages a
  CUDA tensor through host memory itself there.

At exit (``parallel/distributed.py``), the process group must end
before the interpreter finalizes: a gloo worker thread drops its
references to a collective's tensors just after the collective
completes, and a tensor whose Python object is gone then takes the
interpreter lock to be freed; once the interpreter finalizes, Python ends
that thread inside C++ and the process aborts ("terminate called without
an active exception", about 2% of one-rank pods exiting 8 at once). The
group's destructor joins those threads, and it runs only once nothing
references the group, this module's axes included: ``release_groups``
lets go of theirs.

An axis of one rank inside a process group still issues its collectives
(the identity), so a one-card pod runs the path a pod of many cards runs.
``calls`` counts the collectives issued from Python (a graph capture
issues each once; its replays issue none from Python).
"""

from __future__ import annotations

import weakref
from typing import Any

import torch
import torch.distributed as dist

__all__ = ["Axis", "release_groups"]

#: every axis made, so that exit can release their groups
_AXES: "weakref.WeakSet[Axis]" = weakref.WeakSet()


def release_groups() -> None:
    """Drop every axis's reference to its process group (at exit, after
    ``destroy_process_group``): the group's destructor then joins its
    worker threads. The axes' collectives are the identity after."""
    for axis in list(_AXES):
        axis.group = None


class Axis:
    """One mesh axis of this rank: its process group (None = an axis of
    one rank outside any group, whose collectives are the identity), its
    size, this rank's index along it, and the rank's device."""

    def __init__(self, name: str, group: Any, size: int, index: int,
                 device: torch.device) -> None:
        self.name = name
        self.group = group
        self.size = size
        self.index = index
        self.device = device
        self.backend = (dist.get_backend(group) if group is not None
                        else None)
        self.calls = 0
        _AXES.add(self)

    # ---------------------------------------------------------- properties

    @property
    def capturable(self) -> bool:
        """Whether this axis's collectives may run inside a CUDA graph
        capture: NCCL yes, gloo no; an axis without a group has none."""
        return self.backend in (None, "nccl")

    @property
    def wire_device(self) -> torch.device:
        """Where the control plane's payload lives: the CPU under gloo,
        the rank's device under NCCL."""
        return (self.device if self.backend == "nccl"
                else torch.device("cpu"))

    # --------------------------------------------------------- collectives

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the axis, in place; returns ``x``."""
        if self.group is not None:
            self.calls += 1
            dist.all_reduce(x, group=self.group)
        return x

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` [..., n] as one [..., size * n], rank order."""
        if self.group is None:
            return x
        self.calls += 1
        # ranks stacked on dim 0 (the shape gloo asks for), then moved
        out = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        # all_gather_single is the newer name of all_gather_into_tensor
        gather = getattr(dist, "all_gather_single",
                         dist.all_gather_into_tensor)
        gather(out, x.contiguous(), group=self.group)
        out = out.view((self.size,) + tuple(x.shape))
        return out.movedim(0, -2).reshape(*x.shape[:-1], -1)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """Rows of a table split on its vocab dim over the axis: this
        rank's share ``table`` [V / size, D] holds ids ``index * V / size``
        on. Returns [*tokens.shape, D], equal on every rank."""
        ids = tokens.long()
        if self.group is None:
            return table[ids]
        rows = table.shape[0]
        local = ids - self.index * rows
        mine = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)]
        x = torch.where(mine[..., None], x, torch.zeros_like(x))
        return self.all_reduce(x)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` into every rank's ``x``, in place (``src``
        is the rank's index along the axis)."""
        if self.group is not None:
            self.calls += 1
            dist.broadcast(x, group=self.group, group_src=src)
        return x

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """The ring step: ``x`` to the rank at index + 1 and, from the
        rank at index - 1, its ``x`` returned (a new tensor of ``x``'s
        shape, dtype and device); both as one ``batch_isend_irecv`` so no
        rank waits on a send before its receive. An axis of one rank
        returns ``x`` itself (the ring is the identity)."""
        if self.group is None or self.size == 1:
            return x
        self.calls += 1
        staged = self.backend == "gloo" and x.device.type != "cpu"
        src = (x.cpu() if staged else x).contiguous()
        out = torch.empty_like(src)
        peer = [dist.get_global_rank(self.group, (self.index + d) % self.size)
                for d in (1, -1)]
        ops = [dist.P2POp(dist.isend, src, peer[0], group=self.group),
               dist.P2POp(dist.irecv, out, peer[1], group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out.to(x.device) if staged else out

    def __repr__(self) -> str:
        return (f"Axis({self.name!r}, size={self.size}, index={self.index}, "
                f"backend={self.backend})")

