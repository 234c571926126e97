"""PyTorch port vs JAX reference: the mesh planner and the shard plans.

``plan_mesh_shape`` is the JAX package's arithmetic, copied: it must
factor every device count the same way for every wanted axis. The shard
plans replace ``PartitionSpec``: the Llama plan must split the same
leaves on the same dims as the JAX package's ``param_specs`` (and the
cache plan its ``cache_specs``' model axis), and ``shard_params`` must
give each rank the block that the JAX mesh places on its device.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding

from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from swarmdb_tpu.parallel.mesh import plan_mesh_shape as jax_plan
from swarmdb_tpu_torch.models import llama as tl
from swarmdb_tpu_torch.parallel.collectives import Axis
from swarmdb_tpu_torch.parallel.mesh import (MESH_AXES, Mesh, make_mesh,
                                             plan_mesh_shape, shard_params)
from swarmdb_tpu_torch.parallel.mesh import _slices

GRID = [(n, m, e, p)
        for n in (1, 2, 3, 4, 6, 8, 12, 16, 32, 64)
        for m, e, p in itertools.product((None, 1, 2, 4), (None, 1, 2),
                                         (None, 1, 2))]


def _outcome(fn, n, m, e, p):
    try:
        return fn(n, want_model=m, want_expert=e, want_pipe=p)
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("n,m,e,p", GRID)
def test_plan_mesh_shape_equals_jax(n, m, e, p):
    assert _outcome(plan_mesh_shape, n, m, e, p) == \
        _outcome(jax_plan, n, m, e, p)


def test_param_plan_splits_what_param_specs_shard():
    """Every leaf of the Llama plan names the dim the JAX spec shards on
    the model axis (None where the spec shards nothing), for both head
    layouts (tied and untied embeddings)."""
    for cfg in (get_config("tiny-debug"),
                get_config("tiny-debug", tie_embeddings=True)):
        specs = jl.param_specs(cfg, model_axis="model")
        plan = tl.param_plan(cfg, model_axis="model")
        flat_specs = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        seen = 0
        for path, spec in flat_specs[0]:
            node = plan
            for k in path:
                node = node[k.key]
            dims = [i for i, ax in enumerate(spec) if ax == "model"]
            assert node == ((dims[0], "model") if dims else None), path
            seen += 1
        assert seen == sum(1 for _ in _leaves(plan))
    k_spec, _v = jl.cache_specs("model")
    assert tl.cache_plan("model")[0] == (list(k_spec).index("model"),
                                         "model")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _rank_mesh(rank: int, model: int) -> Mesh:
    coords = {"data": 0, "model": rank, "expert": 0, "pipe": 0}
    shape = {"data": 1, "model": model, "expert": 1, "pipe": 1}
    dev = torch.device("cpu")
    axes = {a: Axis(a, None, shape[a], coords[a], dev) for a in MESH_AXES}
    return Mesh(shape, coords, axes, dev)


@pytest.mark.parametrize("model", [2, 4])
def test_shard_params_gives_each_rank_its_devices_block(model):
    """Rank r's shares equal the block the JAX mesh (data=1, model=m)
    places on its r-th device, leaf for leaf."""
    cfg = get_config("tiny-debug", n_heads=4, n_kv_heads=4)
    mesh = jax_make_mesh(devices=jax.devices()[:model], data=1, model=model,
                         expert=1)
    params = jax.tree.map(lambda a: a.astype(np.float32),
                          jl.init_params(cfg, jax.random.PRNGKey(1)))
    specs = jl.param_specs(cfg, model_axis="model")
    placed = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params,
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    whole = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    devs = list(mesh.devices.reshape(-1))
    for rank in range(model):
        got = shard_params(whole, tl.param_plan(cfg), _rank_mesh(rank,
                                                                 model))
        flat_got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
        flat_want = [
            np.asarray(next(s.data for s in a.addressable_shards
                            if s.device == devs[rank]))
            for a in jax.tree.leaves(placed)]
        assert len(flat_got) == len(flat_want)
        for g, w in zip(flat_got, flat_want):
            np.testing.assert_array_equal(g, w)


def test_make_mesh_without_a_process_group():
    """One process: every axis has one rank and no group; its collectives
    are the identity."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1, "expert": 1, "pipe": 1}
    tp = mesh.axis("model")
    x = torch.arange(6.0).reshape(2, 3)
    assert tp.group is None and tp.capturable
    assert tp.all_reduce(x) is x and tp.gather_last(x) is x
    assert torch.equal(tp.embed(x, torch.tensor([1, 0])), x[[1, 0]])
    assert tp.calls == 0
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(data=1, model=2, expert=1, device="cpu")


@pytest.mark.parametrize("sizes", [(2, 3, 1, 2), (1, 4, 2, 1), (3, 1, 1, 1)])
def test_axis_groups_partition_the_ranks(sizes):
    """For each axis, its rank lists partition the ranks, each list runs
    along that axis only (row-major layout), and every rank finds itself
    in exactly one."""
    total = int(np.prod(sizes))
    grid = np.arange(total).reshape(sizes)
    for i, size in enumerate(sizes):
        groups = list(_slices(sizes, i))
        assert sorted(r for g in groups for r in g) == list(range(total))
        want = sorted(tuple(np.moveaxis(grid, i, -1).reshape(-1, size)[j])
                      for j in range(total // size))
        assert sorted(tuple(g) for g in groups) == want
