"""The conversation-temperature ledger that tiering reads.

A part of ``swarmdb_tpu/obs/memprof.py``: its ``NullConvLedger`` and
``ConvLedger``, which ``backend/tiering.py`` reads (touch counts break
ties between demotion victims of equal idle age) and
``backend/service.py`` feeds (one touch per served message, the resident
page count at every change of a conversation's kept state). The rest of
the memory accountant (pool residency, reuse sampling, the what-if models,
the ledger's hot / warm / cold ``report`` and ``/admin/mem``, which reads
it) is not ported yet (ROADMAP.md, queue 1 item 10b).

``SWARMDB_MEMPROF=0`` hands the service the shared null ledger, as in the
JAX package.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Any, List, Tuple

from ..utils.sync import make_lock


def memprof_enabled() -> bool:
    """``SWARMDB_MEMPROF``, default on."""
    return os.environ.get("SWARMDB_MEMPROF", "1") != "0"


class NullConvLedger:
    """Flag-off conversation ledger (shared singleton)."""

    __slots__ = ()
    enabled = False

    def touch(self, key, tokens: int) -> None:
        pass

    def resident(self, key, pages: int) -> None:
        pass

    def anchor(self, key, tokens: int) -> None:
        pass

    def drop(self, key) -> None:
        pass

    def snapshot(self) -> List[Tuple[Any, int, int, int, int, int]]:
        return []


NULL_CONV = NullConvLedger()


class ConvLedger:
    """Per-conversation temperature ledger: touched once per served
    message (service thread) and once per change of kept state (engine
    thread), under a small lock."""

    __slots__ = ("enabled", "_lock", "_convs", "_cap", "touches_total")

    def __init__(self, cap: int) -> None:
        self.enabled = True
        self._lock = make_lock("obs.memprof.ConvLedger._lock")
        # key -> [last_touch_ns, touches, resident_pages, anchor_tokens,
        #         prompt_tokens]; insertion order is LRU (size-capped)
        self._convs: "OrderedDict[Any, List[Any]]" = OrderedDict()
        self._cap = cap
        self.touches_total = 0

    def touch(self, key, tokens: int) -> None:
        """One served message for ``key`` (prompt length ``tokens``)."""
        with self._lock:
            st = self._convs.get(key)
            if st is None:
                st = [0, 0, 0, 0, 0]
                while len(self._convs) >= self._cap:
                    self._convs.popitem(last=False)
                self._convs[key] = st
            else:
                self._convs.move_to_end(key)
            st[0] = time.monotonic_ns()
            st[1] += 1
            st[4] = tokens
            self.touches_total += 1

    def resident(self, key, pages: int) -> None:
        """The conversation's kept device pages (0 = none)."""
        with self._lock:
            st = self._convs.get(key)
            if st is not None:
                st[2] = pages

    def anchor(self, key, tokens: int) -> None:
        """Anchor-head capture: ``tokens`` of immutable window head."""
        with self._lock:
            st = self._convs.get(key)
            if st is not None:
                st[3] = tokens

    def drop(self, key) -> None:
        """The conversation's kept state went back to the pool."""
        with self._lock:
            st = self._convs.get(key)
            if st is not None:
                st[2] = 0

    def snapshot(self) -> List[Tuple[Any, int, int, int, int, int]]:
        """(key, last_touch_ns, touches, resident_pages, anchor_tokens,
        prompt_tokens) per conversation, oldest touch first."""
        with self._lock:
            return [(k, st[0], st[1], st[2], st[3], st[4])
                    for k, st in self._convs.items()]

    def reset(self) -> None:
        with self._lock:
            self._convs.clear()
            self.touches_total = 0


def conv_ledger():
    """A new conversation ledger for one serving service, or the shared
    null ledger under ``SWARMDB_MEMPROF=0``. Its size cap is
    ``SWARMDB_MEM_CONV_CAP`` (default 100000). The JAX package keeps one
    per process (``memprof().conv_ledger()``); one per service keeps the
    touches of services that share conversation keys apart."""
    if not memprof_enabled():
        return NULL_CONV
    try:
        cap = int(os.environ.get("SWARMDB_MEM_CONV_CAP", "100000"))
    except ValueError:
        cap = 100000
    return ConvLedger(max(1, cap))
