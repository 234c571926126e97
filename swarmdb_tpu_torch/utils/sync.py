"""One lock factory for the whole package.

Every module allocates its locks through here with a stable site label
(``"backend.engine.Engine._cv"``), as the JAX package does
(``swarmdb_tpu/utils/sync.py``). Two behaviours:

- default (``SWARMDB_LOCKCHECK`` unset or 0): the plain ``threading``
  objects, exactly (type identity pinned by
  tests/test_torch_lockcheck.py);
- ``SWARMDB_LOCKCHECK=1``: the instrumented wrappers of
  :mod:`swarmdb_tpu_torch.obs.lockcheck` -- per-thread held sets, the
  acquisition-order graph with inversion-cycle detection, per-site hold
  and contention stats.

The flag is read per *allocation*: flipping it mid-process affects locks
created afterwards. Module-level locks take it at import. The lockcheck
import stays lazy, so the off path never pays for it.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional

__all__ = ["make_lock", "make_rlock", "make_condition",
           "lockcheck_enabled"]


def lockcheck_enabled() -> bool:
    return os.environ.get("SWARMDB_LOCKCHECK", "0") not in ("", "0")


def make_lock(site: str) -> Any:
    """A mutex for ``site`` (plain ``threading.Lock`` unless the
    sanitizer is on)."""
    if lockcheck_enabled():
        from ..obs import lockcheck

        return lockcheck.checked("lock", site)
    return threading.Lock()


def make_rlock(site: str) -> Any:
    if lockcheck_enabled():
        from ..obs import lockcheck

        return lockcheck.checked("rlock", site)
    return threading.RLock()


def make_condition(site: str, lock: Optional[Any] = None) -> Any:
    if lockcheck_enabled():
        from ..obs import lockcheck

        return lockcheck.CheckedCondition(site, lock=lock)
    return threading.Condition(lock)
