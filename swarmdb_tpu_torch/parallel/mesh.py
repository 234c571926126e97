"""The ranks as a named 4-axis mesh, and shard plans.

The counterpart of ``swarmdb_tpu/parallel/mesh.py``. The JAX package's
mesh is an array of devices named ``("data", "model", "expert", "pipe")``
and its leaves carry ``PartitionSpec`` shardings that GSPMD honours. In
the port a rank is one process with one device, the mesh names each
rank's coordinates and holds one process group per axis
(``parallel/collectives.Axis``), and a **shard plan** takes the place of
the specs: for each leaf of a parameter tree, the dim it splits on and the
axis it splits over (``None`` = every rank holds it whole; the
counterpart of ``replicated``). ``shard_params`` keeps this rank's slice.

Ranks are laid out row-major over the axes, as the JAX package reshapes
its device list: rank = ((d * model + m) * expert + e) * pipe + p.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device
from .collectives import Axis

MESH_AXES = ("data", "model", "expert", "pipe")

#: One leaf's plan: (dim, axis) it splits on, a tuple of those (one per
#: split dim), or None (held whole).
LeafPlan = Optional[Union[Tuple[int, str], Tuple[Tuple[int, str], ...]]]

__all__ = ["MESH_AXES", "Mesh", "make_mesh", "plan_mesh_shape",
           "shard_leaf", "shard_params"]


def _divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap."""
    best = 1
    for d in range(1, min(n, cap) + 1):
        if n % d == 0:
            best = d
    return best


def plan_mesh_shape(
    n_devices: int,
    *,
    max_model: int = 8,
    max_expert: int = 8,
    want_model: Optional[int] = None,
    want_expert: Optional[int] = None,
    want_pipe: Optional[int] = None,
) -> Dict[str, int]:
    """Factor ``n_devices`` into {data, model, expert, pipe} axis sizes, as
    the JAX package does: pipe defaults to 1 (opt-in), model takes the
    largest divisor up to ``max_model`` (8: every north-star model's KV
    heads), expert the largest of the rest up to ``max_expert``, and data
    what remains."""
    pipe = want_pipe if want_pipe else 1
    if n_devices % pipe:
        raise ValueError(f"pipe axis {pipe} does not divide {n_devices}")
    rest = n_devices // pipe
    model = want_model if want_model else _divisor_leq(rest, max_model)
    if rest % model:
        raise ValueError(f"model axis {model} does not divide {rest}")
    rest //= model
    expert = want_expert if want_expert else _divisor_leq(rest, max_expert)
    if rest % expert:
        raise ValueError(f"expert axis {expert} does not divide {rest}")
    return {"data": rest // expert, "model": model, "expert": expert,
            "pipe": pipe}


class Mesh:
    """This rank's view of the mesh: ``shape`` (axis -> size), ``coords``
    (axis -> this rank's index), ``device`` and one ``Axis`` per name
    (``axis(name)``) whose group joins the ranks that differ only there."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int],
                 axes: Dict[str, Axis], device: torch.device) -> None:
        self.shape = shape
        self.coords = coords
        self._axes = axes
        self.device = device

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords}, {self.device})"


def make_mesh(*, data: Optional[int] = None, model: Optional[int] = None,
              expert: Optional[int] = None, pipe: Optional[int] = None,
              device: DeviceLike = None) -> Mesh:
    """The mesh over the process group's ranks (``init_distributed``
    first), or over this one process when there is no group. With
    ``data``, ``model`` and ``expert`` all given they are used as they
    are (their product with ``pipe`` must be the rank count); otherwise
    ``plan_mesh_shape`` factors the count. ``device`` is this rank's
    device (default the card).

    Every rank must call it with the same arguments: an axis that is
    neither the whole group nor one rank gets a subgroup per slice, and
    every rank takes part in creating every subgroup."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data and model and expert:
        shape = {"data": data, "model": model, "expert": expert,
                 "pipe": pipe or 1}
    else:
        shape = plan_mesh_shape(world, want_model=model, want_expert=expert,
                                want_pipe=pipe)
        if data is not None and shape["data"] != data:
            raise ValueError(f"requested data={data}, planned {shape}")
    sizes = [shape[a] for a in MESH_AXES]
    total = 1
    for s in sizes:
        total *= s
    if total != world:
        raise ValueError(f"mesh shape {shape} does not cover {world} ranks")
    coords, rest = {}, rank
    for a, s in reversed(list(zip(MESH_AXES, sizes))):
        coords[a] = rest % s
        rest //= s
    coords = {a: coords[a] for a in MESH_AXES}
    axes = {}
    for i, a in enumerate(MESH_AXES):
        size = sizes[i]
        if not dist.is_initialized() or size == 1 and world > 1:
            axes[a] = Axis(a, None, size, coords[a], dev)
            continue
        if size == world:
            axes[a] = Axis(a, dist.group.WORLD, size, coords[a], dev)
            continue
        mine = None
        for ranks in _slices(sizes, i):
            group = dist.new_group(ranks)
            if rank in ranks:
                mine = group
        axes[a] = Axis(a, mine, size, coords[a], dev)
    return Mesh(shape, coords, axes, dev)


def _slices(sizes: Sequence[int], i: int):
    """The rank lists that vary only along axis ``i``, in a fixed order."""
    stride = 1
    for s in sizes[i + 1:]:
        stride *= s
    total = 1
    for s in sizes:
        total *= s
    seen = set()
    for r in range(total):
        base = r - ((r // stride) % sizes[i]) * stride
        if base in seen:
            continue
        seen.add(base)
        yield [base + k * stride for k in range(sizes[i])]


# ------------------------------------------------------------ shard plans


def shard_leaf(t: torch.Tensor, plan: LeafPlan, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``t`` under ``plan`` (a contiguous copy; ``t``
    itself when the leaf is held whole or its axis has one rank)."""
    if plan is None:
        return t
    if isinstance(plan[0], tuple):
        for one in plan:
            t = shard_leaf(t, one, mesh)
        return t
    dim, axis = plan
    n = mesh.shape[axis]
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over the {axis} axis of {n}")
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.coords[axis] * size, size).contiguous()


def shard_params(params: Any, plan: Any, mesh: Mesh) -> Any:
    """Keep this rank's slice of every leaf of ``params`` (a nested dict
    of tensors) under ``plan`` (the same nesting, ``LeafPlan`` leaves)."""
    if isinstance(params, dict):
        return {k: shard_params(v, plan[k], mesh) for k, v in params.items()}
    return shard_leaf(params, plan, mesh)


def plan_leaf(plan: Any, key: str) -> LeafPlan:
    """The leaf plan at a dotted ``key`` (``"layers.wq"``)."""
    node = plan
    for part in key.split("."):
        node = node[part]
    return node
