"""Data-parallel serving: lane groups and the fleet.

The counterpart of the lane and fleet parts of ``swarmdb_tpu/parallel``
(``lanes.py``, ``fleet.py`` and the lane branch of ``serving.py``). The
mesh, the sharded (GSPMD) engine and multi-host serving are ROADMAP.md
queue 1 item 11.
"""

from .fleet import FleetManager, build_fleet, parse_fleet_spec, \
    parse_tier_weights
from .lanes import LaneGroupInfo, ShardLaneGroup, build_lane_group
from .serving import build_serving_engine

__all__ = ["FleetManager", "LaneGroupInfo", "ShardLaneGroup",
           "build_fleet", "build_lane_group", "build_serving_engine",
           "parse_fleet_spec", "parse_tier_weights"]
