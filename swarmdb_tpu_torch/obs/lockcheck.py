"""Runtime lock sanitizer: a copy of ``swarmdb_tpu/obs/lockcheck.py``.

When ``SWARMDB_LOCKCHECK=1``, every lock the package allocates through
``utils/sync.py`` is a thin instrumented wrapper that maintains

- a **per-thread held set** (order-preserving),
- the **runtime acquisition-order graph** over lock *instances*, each
  new edge stamped with the acquiring site pair, thread, and a short
  stack -- on every new edge a DFS looks for a return path, and a found
  cycle is an **inversion violation**: recorded once per site-cycle,
  written to the flight recorders attached by the engines, dumped to
  ``lockcheck_<node>.json`` in ``SWARMDB_FLIGHT_DIR``, and surfaced at
  ``GET /admin/lockcheck``,
- per-site **hold-time / contended-acquire stats** (exported on
  ``/metrics`` as ``swarmdb_lock_contended_acquires_total`` and
  ``swarmdb_lock_hold_seconds`` for the top ``SWARMDB_LOCKCHECK_TOPN``
  sites).

The port's own locks go through the same factory with stable site
labels: the kernel launch-count lock (``ops.attention_cuda._LAUNCH_LOCK``),
the kernel build lock (``ops.build._lock``) and the per-device CUDA graph
capture locks (``backend.decode_graphs.device_lock``), which sibling lanes
take while their engines serve.

With the flag off (default), ``utils/sync.py`` returns the plain
``threading`` classes and this module is never imported (type identity
pinned by tests/test_torch_lockcheck.py).

The registry's own mutex is a *leaf* lock: it is only ever taken with
user locks already held, never the reverse, and no user code runs
under it -- so the sanitizer cannot introduce the inversions it hunts.
Edge bookkeeping is graph-level work done once per novel (a, b)
instance pair; steady-state acquires pay one dict hit and two float
reads.
"""

from __future__ import annotations

import atexit
import itertools
import json
import logging
import os
import re
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Set, Tuple

logger = logging.getLogger("swarmdb_tpu_torch.obs")

__all__ = ["enabled", "checked", "registry", "LockCheckRegistry",
           "CheckedLock", "CheckedRLock", "CheckedCondition"]


def enabled() -> bool:
    return os.environ.get("SWARMDB_LOCKCHECK", "0") not in ("", "0")


def _topn() -> int:
    try:
        return max(1, int(os.environ.get("SWARMDB_LOCKCHECK_TOPN", "10")))
    except ValueError:
        return 10


def _short_stack(skip: int = 3, limit: int = 6) -> List[str]:
    """Compact acquisition stack: innermost frames outside this module."""
    out = []
    for fr in reversed(traceback.extract_stack()[:-skip]):
        if fr.filename.endswith(("lockcheck.py", "sync.py")):
            continue
        out.append(f"{os.path.basename(fr.filename)}:{fr.lineno} "
                   f"{fr.name}")
        if len(out) >= limit:
            break
    return out


class _SiteStats:
    __slots__ = ("acquires", "contended", "wait_s", "hold_s",
                 "max_hold_s", "instances")

    def __init__(self) -> None:
        self.acquires = 0
        self.contended = 0
        self.wait_s = 0.0
        self.hold_s = 0.0
        self.max_hold_s = 0.0
        self.instances = 0

    def to_json(self) -> Dict[str, Any]:
        return {
            "acquires": self.acquires,
            "contended": self.contended,
            "wait_s": round(self.wait_s, 6),
            "hold_s": round(self.hold_s, 6),
            "max_hold_s": round(self.max_hold_s, 6),
            "instances": self.instances,
        }


class LockCheckRegistry:
    """Process-global acquisition-order graph + per-site stats."""

    def __init__(self) -> None:
        # leaf lock (see module docstring): never held while taking a
        # user lock, no user code runs under it
        self._mu = threading.Lock()
        self._tls = threading.local()
        self._sites: Dict[str, _SiteStats] = {}
        # instance-level order graph: node = the wrapper's serial number,
        # never reused (an id() is reused once its lock is collected, and
        # a new lock of another site would inherit the dead one's edges:
        # a false cycle in a process that builds and drops services)
        self._serial = itertools.count(1)
        self._adj: Dict[int, Set[int]] = {}
        self._edges: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self._names: Dict[int, str] = {}
        self._cycles: List[Dict[str, Any]] = []
        self._cycle_keys: Set[Tuple[str, ...]] = set()
        self._flights: List[Any] = []
        self._atexit_armed = False

    # ----------------------------------------------------------- wiring

    def attach_flight(self, recorder: Any) -> None:
        """Violations also land as flight-recorder instants."""
        with self._mu:
            if recorder not in self._flights:
                self._flights.append(recorder)

    def register(self, wrapper: "CheckedLock") -> None:
        with self._mu:
            wrapper.node = next(self._serial)
            self._names[wrapper.node] = wrapper.site
            self._sites.setdefault(wrapper.site, _SiteStats()).instances \
                += 1
            if not self._atexit_armed:
                self._atexit_armed = True
                atexit.register(self._atexit_dump)

    def _held_list(self) -> List[List[Any]]:
        """Per-thread held entries ``[wrapper, t_acquired, depth]``.
        Depth lives HERE, not on the wrapper: an RLock's re-entry count
        is per-owner, and a shared instance counter is corrupted the
        moment a Condition.wait parks one thread's ownership while
        another thread acquires (the stale-held-entry bug the chaos
        drill caught on this module's first run)."""
        lst = getattr(self._tls, "held", None)
        if lst is None:
            lst = []
            self._tls.held = lst
        return lst

    def _find_entry(self, wrapper: "CheckedLock") -> Optional[List[Any]]:
        held = self._held_list()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is wrapper:
                return held[i]
        return None

    # ------------------------------------------------------------ events

    def on_acquired(self, wrapper: "CheckedLock", waited_s: float,
                    contended: bool, depth: int = 1) -> None:
        held = self._held_list()
        fresh_cycles: List[Dict[str, Any]] = []
        with self._mu:
            st = self._sites.setdefault(wrapper.site, _SiteStats())
            st.acquires += 1
            st.wait_s += waited_s
            if contended:
                st.contended += 1
            for entry in held:
                if entry[0] is not wrapper:
                    cycle = self._add_edge(entry[0], wrapper)
                    if cycle is not None:
                        fresh_cycles.append(cycle)
        held.append([wrapper, time.monotonic(), depth])
        # side effects OUTSIDE _mu: the flight recorder's event ring
        # takes its own (checked) lock, and re-entering the registry
        # from under its mutex would be this module's own deadlock
        for cycle in fresh_cycles:
            self._emit_violation(cycle)

    def reenter(self, wrapper: "CheckedLock") -> None:
        """Re-entrant acquire by the owning thread: bump depth only."""
        entry = self._find_entry(wrapper)
        if entry is not None:
            entry[2] += 1

    def on_released(self, wrapper: "CheckedLock") -> None:
        entry = self._find_entry(wrapper)
        if entry is None:
            return
        entry[2] -= 1
        if entry[2] > 0:
            return
        self._drop_entry(entry)

    def force_release(self, wrapper: "CheckedLock") -> int:
        """Condition.wait parking: the wait fully releases the lock no
        matter the re-entry depth; returns that depth so the wake-side
        re-acquire can restore it."""
        entry = self._find_entry(wrapper)
        if entry is None:
            return 1
        depth = entry[2]
        self._drop_entry(entry)
        return depth

    def _drop_entry(self, entry: List[Any]) -> None:
        held = self._held_list()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is entry:
                del held[i]
                break
        dt = time.monotonic() - entry[1]
        with self._mu:
            st = self._sites.setdefault(entry[0].site, _SiteStats())
            st.hold_s += dt
            if dt > st.max_hold_s:
                st.max_hold_s = dt

    def holds(self, wrapper: "CheckedLock") -> bool:
        return self._find_entry(wrapper) is not None

    # ------------------------------------------------------- graph/cycles

    # swarmlint: holds[self._mu]
    def _add_edge(self, a: "CheckedLock",
                  b: "CheckedLock") -> Optional[Dict[str, Any]]:
        """Called under ``self._mu``; returns a newly-detected cycle
        (side effects are the caller's job, outside the mutex)."""
        key = (a.node, b.node)
        edge = self._edges.get(key)
        if edge is not None:
            edge["count"] += 1
            return None
        self._edges[key] = {
            "from_site": a.site,
            "to_site": b.site,
            "count": 1,
            "thread": threading.current_thread().name,
            "stack": _short_stack(),
        }
        self._adj.setdefault(key[0], set()).add(key[1])
        self._adj.setdefault(key[1], set())
        path = self._find_path(key[1], key[0])
        if path is None:
            return None
        # path runs key[1] .. key[0]; the closing edge is the one just
        # added, so drop the terminal node to keep each cycle node
        # exactly once
        return self._record_cycle([key[0]] + path[:-1])

    # swarmlint: holds[self._mu]
    def _find_path(self, frm: int, to: int) -> Optional[List[int]]:
        """DFS instance path frm -> to, as a node list ending at to."""
        stack: List[Tuple[int, List[int]]] = [(frm, [frm])]
        seen = {frm}
        while stack:
            node, path = stack.pop()
            if node == to:
                return path
            for nxt in self._adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # swarmlint: holds[self._mu]
    def _record_cycle(self, nodes: List[int]
                      ) -> Optional[Dict[str, Any]]:
        """``nodes`` is the instance cycle (closing edge implied);
        called under ``self._mu``. Returns the cycle when it is new
        (dedup by site set irrespective of rotation/instances)."""
        sites = [self._names.get(n, "?") for n in nodes]
        key = tuple(sorted(sites))
        if key in self._cycle_keys:
            return None
        self._cycle_keys.add(key)
        edges = []
        for i, n in enumerate(nodes):
            nxt = nodes[(i + 1) % len(nodes)]
            info = self._edges.get((n, nxt))
            if info is not None:
                edges.append(dict(info))
        cycle = {
            "sites": sites,
            "edges": edges,
            "thread": threading.current_thread().name,
            "detected_at": time.time(),
        }
        self._cycles.append(cycle)
        return cycle

    def _emit_violation(self, cycle: Dict[str, Any]) -> None:
        """Runs OUTSIDE ``self._mu`` (the flight ring takes its own
        checked lock)."""
        sites = cycle["sites"]
        logger.warning("lockcheck: lock-order inversion cycle: %s",
                       " -> ".join(sites + [sites[0]]))
        for fl in list(self._flights):
            try:
                fl.record_event({
                    "kind": "lockcheck.inversion",
                    "ts": time.time(),
                    "sites": sites,
                })
            except Exception:
                pass
        # dump immediately: a SIGKILLed chaos victim never reaches
        # atexit, and the violation is the post-mortem
        directory = os.environ.get("SWARMDB_FLIGHT_DIR")
        if directory:
            try:
                self.dump_to(directory)
            except Exception:
                logger.exception("lockcheck dump failed")

    # ------------------------------------------------------------ reading

    def _node_identity(self) -> str:
        raw = (os.environ.get("SWARMDB_NODE_ID")
               or f"p{os.getpid()}")
        return re.sub(r"[^A-Za-z0-9_.-]", "_", raw)

    def report(self) -> Dict[str, Any]:
        with self._mu:
            edges = [dict(e) for e in self._edges.values()]
            cycles = [dict(c) for c in self._cycles]
            sites = {s: st.to_json() for s, st in self._sites.items()}
        return {
            "enabled": enabled(),
            "node": self._node_identity(),
            "sites": sites,
            "edges": edges,
            "cycles": cycles,
            "generated_at": time.time(),
        }

    def cycles(self) -> List[Dict[str, Any]]:
        with self._mu:
            return [dict(c) for c in self._cycles]

    def prometheus_lines(self, prefix: str = "swarmdb_") -> List[str]:
        """Top-N sites by contended acquires and by cumulative hold
        time (``SWARMDB_LOCKCHECK_TOPN``)."""
        with self._mu:
            items = [(s, st) for s, st in self._sites.items()]
            n_cycles = len(self._cycle_keys)
        n = _topn()
        lines = [f"# TYPE {prefix}lock_contended_acquires_total counter"]
        for s, st in sorted(items, key=lambda kv: -kv[1].contended)[:n]:
            lines.append(
                f'{prefix}lock_contended_acquires_total{{site="{s}"}} '
                f"{st.contended}")
        lines.append(f"# TYPE {prefix}lock_hold_seconds counter")
        for s, st in sorted(items, key=lambda kv: -kv[1].hold_s)[:n]:
            lines.append(f'{prefix}lock_hold_seconds{{site="{s}"}} '
                         f"{st.hold_s:.6f}")
        lines.append(f"# TYPE {prefix}lock_inversion_cycles gauge")
        lines.append(f"{prefix}lock_inversion_cycles {n_cycles}")
        return lines

    # swarmlint: holds[self._mu]
    def _write_dump(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory, f"lockcheck_{self._node_identity()}.json")
        tmp = f"{path}.{os.getpid()}.tmp"
        payload = {
            "enabled": True,
            "node": self._node_identity(),
            "sites": {s: st.to_json() for s, st in self._sites.items()},
            "edges": [dict(e) for e in self._edges.values()],
            "cycles": [dict(c) for c in self._cycles],
            "generated_at": time.time(),
        }
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
        return path

    def dump_to(self, directory: str) -> str:
        with self._mu:
            return self._write_dump(directory)

    def _atexit_dump(self) -> None:
        directory = os.environ.get("SWARMDB_FLIGHT_DIR")
        if not directory:
            return
        try:
            self.dump_to(directory)
        except Exception:  # pragma: no cover - shutdown best-effort
            pass

    def reset(self) -> None:
        """Tests only — forget the graph, stats, and violations."""
        with self._mu:
            self._sites.clear()
            self._adj.clear()
            self._edges.clear()
            self._names.clear()
            self._cycles.clear()
            self._cycle_keys.clear()


_REGISTRY = LockCheckRegistry()


def registry() -> LockCheckRegistry:
    return _REGISTRY


class CheckedLock:
    """Instrumented ``threading.Lock`` with held-set/order tracking."""

    _factory = staticmethod(threading.Lock)
    reentrant = False

    def __init__(self, site: str,
                 reg: Optional[LockCheckRegistry] = None) -> None:
        self.site = site
        self._reg = reg or _REGISTRY
        self._inner = self._factory()
        self._reg.register(self)

    # the threading.Lock surface ---------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self.reentrant and self._reg.holds(self):
            got = self._inner.acquire(blocking, timeout)
            if got:
                self._reg.reenter(self)
            return got
        got = self._inner.acquire(False)
        contended = not got
        waited = 0.0
        if not got and blocking:
            t0 = time.monotonic()
            got = self._inner.acquire(True, timeout)
            waited = time.monotonic() - t0
        elif not got and not blocking:
            return False
        if got:
            self._reg.on_acquired(self, waited, contended)
        return got

    def release(self) -> None:
        self._reg.on_released(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} site={self.site!r}>"


class CheckedRLock(CheckedLock):
    _factory = staticmethod(threading.RLock)
    reentrant = True

    def locked(self) -> bool:  # RLock has no locked() pre-3.12
        got = self._inner.acquire(blocking=False)
        if got:
            self._inner.release()
        return not got


class CheckedCondition:
    """Instrumented ``threading.Condition``: the underlying lock is a
    tracked node, and ``wait()`` models the release/re-acquire pair —
    re-acquiring after a wake records order edges against whatever
    else the thread still holds, which is precisely the shape that
    inverts in practice."""

    def __init__(self, site: str, lock: Optional[Any] = None,
                 reg: Optional[LockCheckRegistry] = None) -> None:
        # Condition's default lock is an RLock; the tracked node wraps
        # the SAME instance the condition synchronizes on
        self._lock = CheckedRLock(site, reg=reg) if lock is None else lock
        self.site = self._lock.site
        inner = getattr(self._lock, "_inner", self._lock)
        self._cond = threading.Condition(inner)
        self._reg = reg or _REGISTRY

    # lock surface -----------------------------------------------------

    def acquire(self, *args: Any, **kwargs: Any) -> bool:
        return self._lock.acquire(*args, **kwargs)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "CheckedCondition":
        self._lock.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._lock.release()

    # condition surface ------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> bool:
        # wait() fully releases the lock while parked (whatever the
        # re-entry depth) and re-acquires before returning: mirror that
        # in the held-set so (a) hold time stops accruing across the
        # park, (b) another thread's acquire during the park cannot
        # corrupt ownership bookkeeping, and (c) the re-acquire records
        # order edges against locks this thread still holds
        depth = self._reg.force_release(self._lock)
        try:
            # swarmlint: disable=SWL304 -- this wrapper IS the wait primitive; predicate loops live at its call sites
            return self._cond.wait(timeout)
        finally:
            self._reg.on_acquired(self._lock, 0.0, False, depth=depth)

    def wait_for(self, predicate: Any,
                 timeout: Optional[float] = None) -> Any:
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                waittime = endtime - time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait(None)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<CheckedCondition site={self.site!r}>"


def checked(kind: str, site: str) -> Any:
    if kind == "lock":
        return CheckedLock(site)
    if kind == "rlock":
        return CheckedRLock(site)
    if kind == "condition":
        return CheckedCondition(site)
    raise ValueError(f"unknown lock kind: {kind!r}")
