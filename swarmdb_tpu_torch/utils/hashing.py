"""Stable hashing for partition routing.

The reference partitions with Python's builtin ``hash(agent_id)``
(` main.py:309-312`), which is salted per process (defect D6) — the same
agent lands on different partitions in different workers. We use FNV-1a
64-bit, which is deterministic across processes, hosts, and Python versions,
and matches the partitioner implemented in the C++ broker
(``broker/cpp/broker.cc``) so Python and native paths agree.
"""

from __future__ import annotations

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


def stable_partition(key: str, num_partitions: int) -> int:
    """Deterministic key → partition mapping (replaces ` main.py:309-312`)."""
    if num_partitions <= 0:
        raise ValueError(f"num_partitions must be positive, got {num_partitions}")
    return fnv1a64(key.encode("utf-8")) % num_partitions
