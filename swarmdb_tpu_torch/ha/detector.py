"""Failure detection: heartbeat freshness + out-of-band liveness probe.

Two independent signals feed one verdict:

- **In-band beats** — every frame the follower's :class:`ReplicaServer`
  receives from the active leader (records, heartbeat ``P`` frames,
  control frames) calls :meth:`FailureDetector.beat`. A healthy but idle
  leader still beats every ``SWARMDB_HA_HEARTBEAT_S`` via the stream
  heartbeat.
- **Out-of-band probes** — a tiny TCP liveness endpoint
  (:class:`LivenessServer`) on every node, dialed by the detector's
  probe thread when beats go stale. A stalled *replication stream* with
  a live *process* therefore reads SUSPECT, never DEAD: failover fires
  only when both signals are gone.

Clock discipline (same as ``obs/tracer.py``): every timestamp here is
``time.monotonic()`` — a wall-clock step can never fabricate or mask a
leader death.

Thread shape: the blocking probe I/O lives on its own thread; the state
machine (:meth:`FailureDetector._evaluate`) is pure arithmetic over two
monotonic floats, marked ``# swarmlint: heartbeat`` and machine-checked
lock-free and I/O-free (SWL601/SWL602) — a detector that can stall IS a
false-positive failover.

States: ALIVE → SUSPECT (freshest signal older than ``suspect_s``) →
DEAD (older than ``dead_s``). Knobs: ``SWARMDB_HA_SUSPECT_S`` (default
2.0), ``SWARMDB_HA_DEAD_S`` (default 2x suspect).
"""

from __future__ import annotations

import enum
import json
import logging
import os
import socket
import struct
import threading
import time
from typing import Callable, Optional, Tuple

logger = logging.getLogger("swarmdb_tpu_torch.ha")

__all__ = ["DetectorState", "FailureDetector", "LivenessServer",
           "probe_liveness", "probe_ends", "promotion_budget_s"]

_LIVENESS = struct.Struct("<qq")  # epoch, catch-up total (sum of ends)
_LEN = struct.Struct("<I")        # json length (the `#` ends probe)


def suspect_s_default() -> float:
    try:
        return float(os.environ.get("SWARMDB_HA_SUSPECT_S", "2.0"))
    except ValueError:
        return 2.0


def dead_s_default(suspect_s: float) -> float:
    try:
        return float(os.environ.get("SWARMDB_HA_DEAD_S",
                                    str(2.0 * suspect_s)))
    except ValueError:
        return 2.0 * suspect_s


def promotion_budget_s(suspect_s: Optional[float] = None,
                       dead_s: Optional[float] = None) -> float:
    """The time within which a failover re-seats a dead leader's
    partitions: the dead time plus six suspect times (the candidates'
    probes, the CAS, the clients' re-point), the JAX package's promotion
    budget in its failover tests. Unset times are the env defaults."""
    if suspect_s is None:
        suspect_s = suspect_s_default()
    if dead_s is None:
        dead_s = dead_s_default(suspect_s)
    return dead_s + 6.0 * suspect_s


class DetectorState(enum.IntEnum):
    ALIVE = 0
    SUSPECT = 1
    DEAD = 2


class LivenessServer:
    """One-shot TCP liveness endpoint: client sends ``?``, server answers
    ``!`` + <q epoch> + <q catchup> and closes. The catch-up total (sum
    of end offsets) is what the promotion coordinator ranks candidates
    by — "most-caught-up follower wins".

    A ``#`` request answers ``!`` + <u32 len> + JSON
    ``{"epoch": int, "catchup": int, "ends": {topic: {part: end}}}`` —
    the per-partition end offsets partition-level failover ranks the
    "most-caught-up live replica PER PARTITION" with. ``get_ends`` is
    optional; without it the JSON carries an empty ends map."""

    def __init__(self, get_epoch: Callable[[], int],
                 get_catchup: Callable[[], int],
                 host: str = "127.0.0.1", port: int = 0, *,
                 get_ends: Optional[Callable[[], dict]] = None,
                 gate: Optional[Callable[[], bool]] = None) -> None:
        self._get_epoch = get_epoch
        self._get_catchup = get_catchup
        self._get_ends = get_ends
        self.gate = gate
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(8)
        self.host, self.port = self._listener.getsockname()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "LivenessServer":
        self._thread = threading.Thread(
            target=self._serve, daemon=True,
            name=f"swarmdb-liveness-{self.port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for op in (lambda: self._listener.shutdown(socket.SHUT_RDWR),
                   self._listener.close):
            try:
                op()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            try:
                if self.gate is not None and not self.gate():
                    conn.close()  # chaos partition: probe sees EOF
                    continue
                conn.settimeout(2.0)
                op = conn.recv(1)
                if op == b"?":
                    conn.sendall(b"!" + _LIVENESS.pack(
                        int(self._get_epoch()), int(self._get_catchup())))
                elif op == b"#":
                    ends = {}
                    if self._get_ends is not None:
                        try:
                            ends = self._get_ends()
                        except Exception:
                            ends = {}
                    payload = json.dumps({
                        "epoch": int(self._get_epoch()),
                        "catchup": int(self._get_catchup()),
                        "ends": ends,
                    }).encode("utf-8")
                    conn.sendall(b"!" + _LEN.pack(len(payload)) + payload)
            except (OSError, ValueError):
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass


def probe_liveness(addr: str,
                   timeout_s: float = 1.0) -> Optional[Tuple[int, int]]:
    """Dial a node's liveness endpoint; ``(epoch, catchup)`` or None."""
    host, _, port = addr.rpartition(":")
    try:
        with socket.create_connection((host or "127.0.0.1", int(port)),
                                      timeout=timeout_s) as sock:
            sock.settimeout(timeout_s)
            sock.sendall(b"?")
            head = sock.recv(1)
            if head != b"!":
                return None
            buf = b""
            while len(buf) < _LIVENESS.size:
                chunk = sock.recv(_LIVENESS.size - len(buf))
                if not chunk:
                    return None
                buf += chunk
            epoch, catchup = _LIVENESS.unpack(buf)
            return int(epoch), int(catchup)
    except (OSError, ValueError):
        return None


def probe_ends(addr: str, timeout_s: float = 1.0) -> Optional[dict]:
    """Dial a node's liveness endpoint for the per-partition view:
    ``{"epoch": int, "catchup": int, "ends": {topic: {part: end}}}`` or
    None when the node is dead/partitioned. The partition-failover
    coordinator ranks candidates per partition with this."""
    host, _, port = addr.rpartition(":")
    try:
        with socket.create_connection((host or "127.0.0.1", int(port)),
                                      timeout=timeout_s) as sock:
            sock.settimeout(timeout_s)
            sock.sendall(b"#")
            if sock.recv(1) != b"!":
                return None
            head = b""
            while len(head) < _LEN.size:
                chunk = sock.recv(_LEN.size - len(head))
                if not chunk:
                    return None
                head += chunk
            (n,) = _LEN.unpack(head)
            buf = b""
            while len(buf) < n:
                chunk = sock.recv(min(65536, n - len(buf)))
                if not chunk:
                    return None
                buf += chunk
            return json.loads(buf.decode("utf-8"))
    except (OSError, ValueError):
        return None


class FailureDetector:
    """Watches ONE peer (the current leader) through beats + probes.

    ``target_fn`` resolves the peer's liveness address at probe time (it
    reads the cluster map, so a failover re-targets the detector with no
    restart). ``on_state(old, new)`` fires from the watch thread on every
    transition — callbacks must not block (spawn threads for real work).
    """

    def __init__(self, target_fn: Callable[[], Optional[str]], *,
                 suspect_s: Optional[float] = None,
                 dead_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 probe_timeout_s: Optional[float] = None,
                 on_state: Optional[
                     Callable[[DetectorState, DetectorState], None]] = None,
                 name: str = "") -> None:
        self._target_fn = target_fn
        self.suspect_s = (suspect_s if suspect_s is not None
                          else suspect_s_default())
        self.dead_s = (dead_s if dead_s is not None
                       else dead_s_default(self.suspect_s))
        self.poll_s = poll_s if poll_s is not None else self.suspect_s / 4.0
        self.probe_timeout_s = (probe_timeout_s if probe_timeout_s is not None
                                else max(0.05, self.suspect_s / 4.0))
        self._on_state = on_state
        self.name = name
        # Signal timestamps: plain float attributes written by one thread
        # each and read by _evaluate — torn reads are impossible for a
        # Python float slot, so the evaluation path stays lock-free.
        now = time.monotonic()
        self._last_beat = now
        self._last_probe_ok = now
        self._state = DetectorState.ALIVE
        self._stop = threading.Event()
        self._threads: list = []

    # ------------------------------------------------------------- signals

    def beat(self) -> None:
        """In-band liveness proof (replication frame arrived)."""
        self._last_beat = time.monotonic()

    def reset(self) -> None:
        """Fresh grace period (the detector was re-targeted at a newly
        promoted leader — judging it by the old leader's silence would
        re-fire failover instantly)."""
        now = time.monotonic()
        self._last_beat = now
        self._last_probe_ok = now

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "FailureDetector":
        for fn, tag in ((self._probe_loop, "probe"),
                        (self._watch_loop, "watch")):
            t = threading.Thread(
                target=fn, daemon=True,
                name=f"swarmdb-ha-{tag}-{self.name or id(self):x}"
                if not self.name else f"swarmdb-ha-{tag}-{self.name}")
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=2.0)

    # --------------------------------------------------------------- state

    @property
    def state(self) -> DetectorState:
        return self._state

    def signal_age_s(self) -> float:
        return time.monotonic() - max(self._last_beat, self._last_probe_ok)

    def status(self) -> dict:
        st = self._state
        return {
            "state": st.name.lower(),
            "state_code": int(st),
            "signal_age_s": round(self.signal_age_s(), 4),
            "suspect_s": self.suspect_s,
            "dead_s": self.dead_s,
        }

    # swarmlint: heartbeat
    def _evaluate(self, now: float) -> DetectorState:
        # Pure arithmetic over monotonic stamps — no locks, no I/O, no
        # allocation-heavy calls. SWL601/SWL602 police this: anything that
        # can stall here turns a healthy leader into a "dead" one.
        freshest = self._last_beat
        if self._last_probe_ok > freshest:
            freshest = self._last_probe_ok
        age = now - freshest
        if age < self.suspect_s:
            return DetectorState.ALIVE
        if age < self.dead_s:
            return DetectorState.SUSPECT
        return DetectorState.DEAD

    def _watch_loop(self) -> None:
        while not self._stop.is_set():
            new = self._evaluate(time.monotonic())
            old = self._state
            if new != old:
                self._state = new
                logger.info("detector %s: %s -> %s (signal age %.3fs)",
                            self.name, old.name, new.name,
                            self.signal_age_s())
                if self._on_state is not None:
                    try:
                        self._on_state(old, new)
                    except Exception:
                        logger.exception("detector on_state hook failed")
            self._stop.wait(self.poll_s)

    def _probe_loop(self) -> None:
        # Blocking socket I/O lives HERE, never on the evaluation path. A
        # fresh beat stream suppresses probing entirely (no probe traffic
        # against a healthy leader).
        while not self._stop.is_set():
            if time.monotonic() - self._last_beat >= self.suspect_s / 2.0:
                target = None
                try:
                    target = self._target_fn()
                except Exception:
                    logger.exception("detector target resolution failed")
                if target:
                    if probe_liveness(target, self.probe_timeout_s) is not None:
                        self._last_probe_ok = time.monotonic()
            self._stop.wait(self.poll_s)
