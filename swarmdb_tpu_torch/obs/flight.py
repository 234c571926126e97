"""Flight recorder: the last N engine steps, M requests and K events.

A copy of ``swarmdb_tpu/obs/flight.py``. With the lock sanitizer on
(``SWARMDB_LOCKCHECK=1``, :mod:`.lockcheck`) every recorder attaches
itself to its registry, so an inversion lands in the event ring as a
``lockcheck.inversion`` instant. Every automatic dump into a directory also writes the device-time profiler's
and the memory accountant's dumps beside it (``_profile_dump`` /
``_mem_dump``). Three fixed-size rings:

- **step records** and **request records**, written by the engine
  thread only (no locks on the record path): ``Engine._flight_step``
  after each admission and dispatch round that has work, and
  ``Engine._retire`` for each finished request.
- **event records**: rare discrete facts from any thread (lane
  supervision transitions, retries, pool backpressure, chaos
  injections), written under a small lock.

Readers snapshot racily, which at worst tears one record. Dumps are
taken on demand (``GET /admin/flight``), by ``Engine.restart`` and by
the SLO sentinel at an alert (tagged with the alert id).

Knobs: ``SWARMDB_FLIGHT_STEPS`` (default 512), ``SWARMDB_FLIGHT_REQUESTS``
(default 256), ``SWARMDB_FLIGHT_EVENTS`` (default 256),
``SWARMDB_FLIGHT_DIR`` (where automatic dumps land; unset = in-memory
``last_dump`` only).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import re
import time
from typing import Any, Dict, List, Optional

from ..utils.sync import make_lock

logger = logging.getLogger("swarmdb_tpu_torch.obs")

__all__ = ["FlightRecorder"]


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


# process-monotonic dump sequence shared by every recorder: two
# near-simultaneous dumps never draw the same file name
_DUMP_SEQ = itertools.count(1)


class _DictRing:
    """Fixed-size single-writer ring of dict records."""

    __slots__ = ("records", "idx", "cap")

    def __init__(self, cap: int) -> None:
        self.records: List[Optional[Dict[str, Any]]] = [None] * cap
        self.idx = 0
        self.cap = cap

    def put(self, rec: Dict[str, Any]) -> None:
        self.records[self.idx % self.cap] = rec
        self.idx += 1

    def snapshot(self) -> List[Dict[str, Any]]:
        idx = self.idx
        records = list(self.records)
        if idx <= self.cap:
            out = records[:idx]
        else:
            cut = idx % self.cap
            out = records[cut:] + records[:cut]
        return [r for r in out if r is not None]


class FlightRecorder:
    def __init__(self, n_steps: Optional[int] = None,
                 n_requests: Optional[int] = None,
                 n_events: Optional[int] = None) -> None:
        if n_steps is None:
            n_steps = _env_int("SWARMDB_FLIGHT_STEPS", 512)
        if n_requests is None:
            n_requests = _env_int("SWARMDB_FLIGHT_REQUESTS", 256)
        if n_events is None:
            n_events = _env_int("SWARMDB_FLIGHT_EVENTS", 256)
        self._steps = _DictRing(max(8, n_steps))
        self._requests = _DictRing(max(8, n_requests))
        self._events = _DictRing(max(8, n_events))
        self._events_lock = make_lock("obs.flight.FlightRecorder._events_lock")
        # free-form identity (backend id, model) that rides every dump
        self.meta: Dict[str, Any] = {}
        self.last_dump: Optional[Dict[str, Any]] = None
        self.last_dump_path: Optional[str] = None
        # with the lock sanitizer on, inversion violations land in this
        # event ring as `lockcheck.inversion` instants
        if os.environ.get("SWARMDB_LOCKCHECK", "0") not in ("", "0"):
            from . import lockcheck

            lockcheck.registry().attach_flight(self)

    # ---------------------------------------------------------- record path

    def record_step(self, rec: Dict[str, Any]) -> None:
        """One engine-step record (engine thread only -- no locks)."""
        self._steps.put(rec)

    def record_request(self, rec: Dict[str, Any]) -> None:
        """One completed/failed request timeline (engine thread only)."""
        self._requests.put(rec)

    def record_event(self, rec: Dict[str, Any]) -> None:
        """One discrete incident, from any thread (locked: events have no
        single owner)."""
        with self._events_lock:
            self._events.put(rec)

    # -------------------------------------------------------------- reading

    def steps(self) -> List[Dict[str, Any]]:
        return self._steps.snapshot()

    def requests(self) -> List[Dict[str, Any]]:
        return self._requests.snapshot()

    def events(self) -> List[Dict[str, Any]]:
        return self._events.snapshot()

    def dump(self, reason: str = "on_demand") -> Dict[str, Any]:
        return {
            "reason": reason,
            "dumped_at": time.time(),
            "meta": dict(self.meta),
            "steps": self.steps(),
            "requests": self.requests(),
            "events": self.events(),
        }

    def _dump_identity(self) -> str:
        """Node identity for dump file names: the recorder's meta, else
        ``SWARMDB_NODE_ID``, else the pid -- never empty, file-name safe."""
        raw = (str(self.meta.get("node_id") or "")
               or os.environ.get("SWARMDB_NODE_ID")
               or f"p{os.getpid()}")
        return re.sub(r"[^A-Za-z0-9_.-]", "_", raw)

    def dump_to(self, directory: str, reason: str = "on_demand") -> str:
        """Write a dump under ``directory``; the file name carries the
        node identity and a process-monotonic sequence number, so two
        dumps in one millisecond never overwrite each other."""
        os.makedirs(directory, exist_ok=True)
        payload = self.dump(reason)
        path = os.path.join(
            directory,
            f"flight_{int(payload['dumped_at'] * 1000)}_"
            f"{self._dump_identity()}_{next(_DUMP_SEQ)}_{reason}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
        self.last_dump = payload
        self.last_dump_path = path
        return path

    def auto_dump(self, reason: str,
                  directory: Optional[str] = None) -> Optional[str]:
        """Best-effort dump for failure paths (engine restart, an SLO
        alert): never raises. ``SWARMDB_FLIGHT_DIR`` overrides
        ``directory``; with neither, only the in-memory ``last_dump`` is
        kept. A directory dump also carries the profiler's and the
        accountant's dumps."""
        directory = os.environ.get("SWARMDB_FLIGHT_DIR") or directory
        try:
            if directory:
                path = self.dump_to(directory, reason)
                logger.info("flight record dumped to %s (%s)", path, reason)
                self._profile_dump(reason, directory)
                self._mem_dump(reason, directory)
                return path
            self.last_dump = self.dump(reason)
            return None
        except Exception:
            logger.exception("flight-record dump failed (%s)", reason)
            try:
                self.last_dump = self.dump(reason)
            except Exception:
                pass
            return None

    @staticmethod
    def _profile_dump(reason: str, directory: str) -> None:
        """The device-time profiler's dump riding every flight auto-dump:
        the failure paths that ship flight evidence ship the per-variant
        device-time picture too. Best-effort, never raises."""
        try:
            from .profiler import profile_enabled, profiler

            if profile_enabled():
                profiler().auto_dump(reason, directory)
        except Exception:
            logger.exception("profile dump failed (%s)", reason)

    @staticmethod
    def _mem_dump(reason: str, directory: str) -> None:
        """The memory accountant's snapshot riding every flight auto-dump
        (pool occupancy, temperature, miss-ratio curve). Best-effort,
        never raises."""
        try:
            from .memprof import memprof, memprof_enabled

            if memprof_enabled():
                memprof().auto_dump(reason, directory)
        except Exception:
            logger.exception("mem dump failed (%s)", reason)
