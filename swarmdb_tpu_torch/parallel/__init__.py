"""Multi-device serving: lane groups and the fleet (data parallelism in
one process), and the single program over ``torch.distributed`` ranks
(``distributed.py``, ``mesh.py``, ``collectives.py``, ``multihost.py``
and ``serving.py``): the dense engine over data, model, expert and pipe
axes (Llama and Mixtral), the sharded paged engine over a data axis.
Its ranks are processes the caller launched (``init_distributed``), or,
over several devices of one process, workers ``build_serving_engine``
spawns itself (``local.py``; not imported here, since it is also the
workers' ``python -m`` entry point).

The counterpart of ``swarmdb_tpu/parallel``. Pipeline and sequence
parallelism are library entry points, as in the JAX package:
``models.llama.forward_pipelined`` / ``forward_seq_parallel`` and
``ops.ring_attention`` over an ``Axis``.
"""

from .distributed import destroy_distributed, init_distributed, \
    is_coordinator
from .fleet import FleetManager, build_fleet, parse_fleet_spec, \
    parse_tier_weights
from .lanes import LaneGroupInfo, ShardLaneGroup, build_lane_group
from .mesh import Mesh, make_mesh, plan_mesh_shape, shard_params
from .serving import (ShardedModel, build_serving_engine,
                      build_sharded_model, build_sharded_paged)

__all__ = ["FleetManager", "LaneGroupInfo", "Mesh", "ShardLaneGroup",
           "ShardedModel", "build_fleet", "build_lane_group",
           "build_serving_engine", "build_sharded_model",
           "build_sharded_paged", "destroy_distributed", "init_distributed",
           "is_coordinator", "make_mesh", "parse_fleet_spec",
           "parse_tier_weights", "plan_mesh_shape", "shard_params"]
