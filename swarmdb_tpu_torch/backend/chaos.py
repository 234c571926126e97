"""Deterministic fault injection for the serving path.

The counterpart of ``swarmdb_tpu/backend/chaos.py``, over a lane group
(``parallel/lanes.py``) or one engine (lane 0). Faults land at two seams
each engine owns, and each injection lands in the flight recorder (the
group's) as an event naming its lane:

    chaos = ServingChaos(group)
    chaos.kill_lane(1)          # lane 1's loop thread dies at its next
                                # iteration (LaneKilled escapes its
                                # recovery handler)
    chaos.wedge(0)              # lane 0's loop blocks at the seam: beats
                                # starve, the thread stays alive
    chaos.slow(1, 0.05)         # per-step latency on lane 1
    chaos.squeeze_pool(0.9)     # withdraw 90% of every lane's free pages
    chaos.heal(0)               # clear wedge / slow on lane 0
    chaos.heal_pool()           # return every squeezed page

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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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
    """Scripted fault injection over a lane group (or one engine)."""

    def __init__(self, engine_or_group: Any,
                 flight: Optional[FlightRecorder] = None) -> None:
        self.lanes: List[Engine] = list(
            getattr(engine_or_group, "lanes", None) or [engine_or_group])
        self.flight = (flight if flight is not None
                       else engine_or_group.flight)
        self.events: List[Dict[str, Any]] = []
        self._events_lock = make_lock(
            "backend.chaos.ServingChaos._events_lock")
        self._timers: List[threading.Timer] = []
        self._t0 = time.monotonic()
        # lane -> (allocator generation, withdrawn pages): a reset in
        # between reclaimed them already, so heal must not free them twice
        self._reserved: Dict[int, Tuple[int, List[int]]] = {}
        self.faults: List[_LaneFault] = []
        for idx, eng in enumerate(self.lanes):
            fault = _LaneFault(
                lambda what, i=idx: self._log(what, i, fired=True))
            self.faults.append(fault)
            eng.chaos_step = fault

    def _log(self, action: str, lane: int, **detail: Any) -> None:
        if detail.get("fired") and action == "wedge_holding":
            return
        ev = {"t_mono": round(time.monotonic() - self._t0, 4),
              "action": action, "lane": lane, **detail}
        with self._events_lock:
            self.events.append(ev)
        self.flight.record_event(
            {"kind": f"chaos.{action}", "lane": lane,
             **{k: v for k, v in detail.items() if k != "fired"}})

    # --------------------------------------------------------------- faults

    def kill_lane(self, lane: int) -> None:
        """Arm a one-shot loop death at the lane's next iteration."""
        self._log("kill_lane", lane)
        self.faults[lane]._kill.set()

    def wedge(self, lane: int) -> None:
        """Pin the lane's thread at the seam until heal()."""
        self._log("wedge", lane)
        self.faults[lane]._wedge.set()

    def slow(self, lane: int, seconds: float) -> None:
        """Per-step latency (a degraded, not dead, lane)."""
        self._log("slow", lane, seconds=seconds)
        self.faults[lane]._delay = float(seconds)

    def heal(self, lane: int) -> None:
        """Clear wedge / slow on one lane (a kill is one-shot; the
        supervisor owns the restart)."""
        self._log("heal", lane)
        self.faults[lane]._wedge.clear()
        self.faults[lane]._delay = 0.0

    def squeeze_pool(self, fraction: float = 1.0,
                     lane: Optional[int] = None,
                     drain_cache: bool = True) -> int:
        """Withdraw ``fraction`` of each paged lane's free pages (of
        ``lane`` only when given). ``drain_cache`` first evicts the
        unpinned prefix-cache pages into the free list (a warm cache is
        headroom admission would evict on demand). Returns the pages
        withdrawn (0 on dense engines)."""
        taken = 0
        for i in ([lane] if lane is not None else range(len(self.lanes))):
            eng = self.lanes[i]
            if eng.paged is None:
                continue
            alloc = eng.paged.allocator
            if drain_cache and eng._prefix is not None:
                evicted = eng._prefix.evict_lru(eng.paged.num_pages)
                if evicted:
                    alloc.add_free(evicted)
            pages = alloc.reserve(max(0, int(fraction * alloc.free_count())))
            gen, held = self._reserved.get(i, (alloc.generation, []))
            if gen != alloc.generation:
                held = []
            self._reserved[i] = (alloc.generation, held + pages)
            taken += len(pages)
            self._log("squeeze_pool", i, pages=len(pages),
                      fraction=fraction)
        return taken

    def heal_pool(self, lane: Optional[int] = None) -> None:
        """Return every squeezed page to its lane's free list (of ``lane``
        only when given)."""
        for i in ([lane] if lane is not None else list(self._reserved)):
            gen, pages = self._reserved.pop(i, (None, []))
            alloc = self.lanes[i].paged.allocator if pages else None
            if pages and gen == alloc.generation:
                alloc.add_free(pages)
                self._log("heal_pool", i, pages=len(pages))

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

    def run_script(self, script: Sequence[Tuple[float, str, tuple]]) -> None:
        """[(at_s, action, args), ...] -- a whole scenario at once."""
        for at_s, action, args in script:
            self.schedule(at_s, action, *args)

    # -------------------------------------------------------------- teardown

    def stop(self) -> None:
        """Cancel pending faults, heal everything, uninstall the seams."""
        for t in self._timers:
            t.cancel()
        self.heal_pool()
        for eng, fault in zip(self.lanes, self.faults):
            fault._kill.clear()
            fault._wedge.clear()
            fault._delay = 0.0
            eng.chaos_step = None

    def dump(self) -> Dict[str, Any]:
        with self._events_lock:
            events = list(self.events)
        return {"chaos_events": events,
                "flight": self.flight.dump("serving_chaos")}
