"""Deterministic fault injection for the serving path.

The counterpart of ``swarmdb_tpu/backend/chaos.py`` on one engine (lane
groups are ROADMAP.md queue 1 item 9; the methods keep the JAX package's
lane argument, and the one engine is lane 0). Faults land at two seams the engine owns, and each
injection lands in the engine's flight recorder as an event:

    chaos = ServingChaos(engine)
    chaos.kill_lane(0)          # the loop thread dies at its next
                                # iteration (LaneKilled escapes its
                                # recovery handler)
    chaos.wedge(0)              # the loop blocks at the seam: beats
                                # starve, the thread stays alive
    chaos.slow(0, 0.05)         # per-step latency
    chaos.squeeze_pool(0.9)     # withdraw 90% of the free pages
    chaos.heal(0)               # clear wedge / slow
    chaos.heal_pool()           # return the squeezed pages

- ``Engine.chaos_step``: called once per loop iteration on the engine
  thread, before admission, so a kill or a wedge lands at a chunk
  boundary.
- ``PageAllocator.reserve``: a squeeze withdraws free pages, like a
  burst of long-lived occupants.

``wait_until`` is a copy of ``swarmdb_tpu/ha/chaos.py``'s: a chaos
test's only sleeping is a bounded wait for the condition under test.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs.flight import FlightRecorder
from ..utils.sync import make_lock
from .engine import Engine

__all__ = ["LaneKilled", "ServingChaos", "wait_until"]


def wait_until(predicate: Callable[[], bool], timeout_s: float,
               poll_s: float = 0.01, what: str = "condition") -> None:
    """Bounded convergence wait; raises AssertionError on deadline."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(poll_s)
    raise AssertionError(f"timed out after {timeout_s:.1f}s waiting for "
                         f"{what}")


class LaneKilled(BaseException):
    """Injected loop death. A BaseException on purpose: the engine loop's
    recovery catches ``Exception``, and a kill must leave a dead thread
    (what the supervisor exists to detect), not a self-healed one."""


class _LaneFault:
    """Per-engine fault state, installed as ``Engine.chaos_step``."""

    def __init__(self, on_fire) -> None:
        self._on_fire = on_fire
        self._kill = threading.Event()
        self._wedge = threading.Event()
        self._delay = 0.0

    def pending(self) -> bool:
        """True while a fault is armed that must land at the seam (the
        idle wait polls it)."""
        return self._kill.is_set() or self._wedge.is_set()

    def __call__(self, eng: Engine) -> None:
        if self._kill.is_set():
            self._kill.clear()  # one-shot: the restarted loop runs clean
            self._on_fire("kill_fired")
            raise LaneKilled("chaos: lane killed")
        if self._wedge.is_set():
            self._on_fire("wedge_holding")
            while self._wedge.is_set():
                # pinned here: beats starve while the thread stays alive
                time.sleep(0.01)
        if self._delay > 0:
            time.sleep(self._delay)


class ServingChaos:
    """Scripted fault injection over one engine."""

    def __init__(self, engine: Engine,
                 flight: Optional[FlightRecorder] = None) -> None:
        if hasattr(engine, "lanes"):
            raise NotImplementedError(
                "lane groups are not ported yet (ROADMAP.md, queue 1 item "
                "9); ServingChaos takes one engine")
        self.engine = engine
        self.flight = flight if flight is not None else engine.flight
        self.events: List[Dict[str, Any]] = []
        self._events_lock = make_lock(
            "backend.chaos.ServingChaos._events_lock")
        self._timers: List[threading.Timer] = []
        self._t0 = time.monotonic()
        # (allocator generation, withdrawn pages): a reset in between
        # reclaimed them already, so heal must not free them twice
        self._reserved: Optional[Tuple[int, List[int]]] = None
        self.fault = _LaneFault(lambda what: self._log(what, fired=True))
        engine.chaos_step = self.fault

    @staticmethod
    def _one(lane: Optional[int]) -> None:
        if lane not in (None, 0):
            raise ValueError(f"lane {lane}: ServingChaos drives one engine, "
                             "lane 0 (lane groups: ROADMAP.md, queue 1 "
                             "item 9)")

    def _log(self, action: str, **detail: Any) -> None:
        if detail.get("fired") and action == "wedge_holding":
            return
        ev = {"t_mono": round(time.monotonic() - self._t0, 4),
              "action": action, "lane": 0, **detail}
        with self._events_lock:
            self.events.append(ev)
        self.flight.record_event(
            {"kind": f"chaos.{action}",
             **{k: v for k, v in detail.items() if k != "fired"}})

    # --------------------------------------------------------------- faults

    def kill_lane(self, lane: int = 0) -> None:
        """Arm a one-shot loop death at the engine's next iteration."""
        self._one(lane)
        self._log("kill_lane")
        self.fault._kill.set()

    def wedge(self, lane: int = 0) -> None:
        """Pin the engine thread at the seam until heal()."""
        self._one(lane)
        self._log("wedge")
        self.fault._wedge.set()

    def slow(self, lane: int, seconds: float) -> None:
        """Per-step latency (a degraded, not dead, engine)."""
        self._one(lane)
        self._log("slow", seconds=seconds)
        self.fault._delay = float(seconds)

    def heal(self, lane: int = 0) -> None:
        """Clear wedge / slow (a kill is one-shot; the supervisor owns the
        restart)."""
        self._one(lane)
        self._log("heal")
        self.fault._wedge.clear()
        self.fault._delay = 0.0

    def squeeze_pool(self, fraction: float = 1.0,
                     lane: Optional[int] = None,
                     drain_cache: bool = True) -> int:
        """Withdraw ``fraction`` of a paged engine's free pages.
        ``drain_cache`` first evicts the unpinned prefix-cache pages into
        the free list (a warm cache is headroom admission would evict on
        demand). Returns the pages withdrawn (0 on a dense engine)."""
        self._one(lane)
        eng = self.engine
        if eng.paged is None:
            return 0
        alloc = eng.paged.allocator
        if drain_cache and eng._prefix is not None:
            evicted = eng._prefix.evict_lru(eng.paged.num_pages)
            if evicted:
                alloc.add_free(evicted)
        pages = alloc.reserve(max(0, int(fraction * alloc.free_count())))
        gen, held = self._reserved or (alloc.generation, [])
        if gen != alloc.generation:
            held = []
        self._reserved = (alloc.generation, held + pages)
        self._log("squeeze_pool", pages=len(pages), fraction=fraction)
        return len(pages)

    def heal_pool(self, lane: Optional[int] = None) -> None:
        """Return every squeezed page to the engine's free list."""
        self._one(lane)
        if self._reserved is None:
            return
        (gen, pages), self._reserved = self._reserved, None
        alloc = self.engine.paged.allocator
        if pages and gen == alloc.generation:
            alloc.add_free(pages)
            self._log("heal_pool", pages=len(pages))

    # ------------------------------------------------------------ scheduling

    def schedule(self, at_s: float, action: str, *args: Any
                 ) -> threading.Timer:
        """Fire ``action`` (kill_lane / wedge / slow / heal / squeeze_pool
        / heal_pool) ``at_s`` seconds from now."""
        t = threading.Timer(at_s, getattr(self, action), args=args)
        t.daemon = True
        t.start()
        self._timers.append(t)
        return t

    # -------------------------------------------------------------- teardown

    def stop(self) -> None:
        """Cancel pending faults, heal everything, uninstall the seam."""
        for t in self._timers:
            t.cancel()
        self.heal_pool()
        self.fault._kill.clear()
        self.fault._wedge.clear()
        self.fault._delay = 0.0
        self.engine.chaos_step = None

    def dump(self) -> Dict[str, Any]:
        with self._events_lock:
            events = list(self.events)
        return {"chaos_events": events,
                "flight": self.flight.dump("serving_chaos")}
