"""One lock factory for the whole package.

Every module allocates its locks through here with a stable site label
(``"backend.engine.Engine._cv"``), as the JAX package does
(``swarmdb_tpu/utils/sync.py``). In this port the factory returns the plain
``threading`` objects; the runtime lock sanitizer that the label feeds in
the JAX package is not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import threading
from typing import Any, Optional

__all__ = ["make_lock", "make_rlock", "make_condition"]


def make_lock(site: str) -> Any:
    """A mutex for ``site``."""
    return threading.Lock()


def make_rlock(site: str) -> Any:
    return threading.RLock()


def make_condition(site: str, lock: Optional[Any] = None) -> Any:
    return threading.Condition(lock)
