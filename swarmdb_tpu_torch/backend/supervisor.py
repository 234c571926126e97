"""Request supervision over a lane group or one engine: liveness verdicts
per lane, retries with deadlines, migration of a quarantined lane's
requests, re-admission.

The counterpart of ``swarmdb_tpu/backend/supervisor.py``. It supervises
the lanes of a ``parallel.lanes.ShardLaneGroup``, or one engine as a
group of one lane.

Two signals feed one verdict per lane:

- **In-band beats**: the engine loop stamps ``Engine._beat_mono`` every
  iteration, idle waits included. A wedged dispatch stops the beats while
  the thread stays alive.
- **Out-of-band liveness**: ``Engine.alive()``, and during recovery real
  probe generations through the lane.

States: ``ALIVE`` -> ``SUSPECT`` (beats stale for
``SWARMDB_LANE_SUSPECT_S``) -> ``QUARANTINED`` (stale for
``SWARMDB_LANE_QUARANTINE_S``, or the thread died). A stall inside a step
(``Engine._in_step``) is held at SUSPECT for
``SWARMDB_LANE_DISPATCH_GRACE_S``: a long legitimate step is not a wedge.
A quarantined lane takes no admissions (the group's routing skips it) and
its supervised requests **migrate**: each is replayed on a sibling lane
(with one engine, on the same engine, behind its restart, which fails it
with the retryable "engine_restart" and so hands it to the retry path),
at most ``SWARMDB_REQ_MIGRATIONS`` times (default 3), except a rolling-KV
request, which ends "lane_quarantined" (its context lives in pages a
replay cannot rebuild). A dead lane is restarted (with backoff) and
re-admitted after ``SWARMDB_LANE_PROBE_N`` clean probe generations. With
a fleet (``parallel/fleet.py``) placement goes through it, and it reports
each stage's lane (``note_lane``), so a migration finds a request on the
lane it occupies.

A replay is an idempotent re-prefill: its prompt is the original prompt
plus every token already emitted to the caller, its budget the rest, so
the stream continues where it stopped. Each attempt's callbacks are bound
to an attempt number and anything from a stale attempt is dropped, so the
caller's stream is append-only with no token repeated or lost; greedy
replays give the tokens of an undisturbed run up to the rounding of
prefill against decode.

Budgets: every request gets an absolute deadline
(``SWARMDB_REQ_DEADLINE_S``, default 600 s) and a retry budget
(``SWARMDB_REQ_RETRIES``, default 2). A retryable finish
(``engine.RETRYABLE_REASONS``) is requeued after a jittered exponential
backoff (``SWARMDB_RETRY_BACKOFF_S``, default 0.05 s, doubling per
retry); anything else, and anything that cannot be retried before its
deadline, reaches the caller at once. ``SWARMDB_RETRY_STORM_N`` retries
(default 8) within one poll mark a retry storm: a "retry.storm" flight
event and tracer instant; the SLO sentinel's retry-rate objective reads
the ``requests_retried`` counter. ``SWARMDB_SUPERVISE=0`` leaves the
serving layer without a supervisor.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..obs import TRACER, FlightRecorder
from ..utils.metrics import MetricsRegistry
from ..utils.sync import make_lock
from .engine import Engine, GenRequest, is_retryable_reason
from .sampling import SamplingParams

logger = logging.getLogger("swarmdb_tpu_torch.supervisor")

__all__ = ["LaneState", "LaneSupervisor"]


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        logger.warning("%s=%r is not a float; using %g", name,
                       os.environ.get(name), default)
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        logger.warning("%s=%r is not an int; using %d", name,
                       os.environ.get(name), default)
        return default


class LaneState(enum.IntEnum):
    ALIVE = 0
    SUSPECT = 1
    QUARANTINED = 2


@dataclasses.dataclass
class _LaneHealth:
    state: LaneState = LaneState.ALIVE
    since: float = dataclasses.field(default_factory=time.monotonic)
    quarantines: int = 0
    restarts: int = 0
    restart_fails: int = 0
    last_restart: float = 0.0
    clean_probes: int = 0


class _Tracked:
    """One supervised request across its attempts. ``attempt`` is the
    dedupe key: callbacks of a stale attempt are dropped under ``lock``;
    ``lane`` is where the current attempt lives."""

    __slots__ = ("request", "prompt", "user_on_token", "user_on_done",
                 "emitted", "attempt", "lane", "done", "retries_left",
                 "migrations_left", "deadline", "retried", "migrated",
                 "lock", "retry_timer")

    def __init__(self, request: GenRequest, migrations: int) -> None:
        self.request = request
        self.prompt = list(request.prompt)
        self.user_on_token = request.on_token
        self.user_on_done = request.on_done
        self.emitted: List[int] = []
        self.attempt = 0
        self.lane = 0
        self.done = False
        self.retries_left = request.retries_left
        self.migrations_left = migrations
        self.deadline = request.deadline
        self.retried = 0
        self.migrated = 0
        self.lock = make_lock("backend.supervisor._Tracked.lock")
        self.retry_timer: Optional[threading.Timer] = None

    @property
    def migratable(self) -> bool:
        """False for a rolling-KV request (keep or resume): its context
        lives in one lane's pages of the registry's custody, which a
        replay cannot rebuild (the registry restarts the conversation
        next turn)."""
        return (self.request.resume_pages is None
                and not self.request.keep_pages)


class LaneSupervisor:
    """Supervises the lanes of a ``ShardLaneGroup`` (or one ``Engine``):
    health verdicts, migration of cut-off requests, retry and deadline
    budgets, recovery of dead lanes."""

    def __init__(self, engine: Any, *,
                 metrics: Optional[MetricsRegistry] = None,
                 flight: Optional[FlightRecorder] = None,
                 suspect_s: Optional[float] = None,
                 quarantine_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 probe_clean_n: Optional[int] = None,
                 probe_timeout_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff_s: Optional[float] = None) -> None:
        self.group = engine if hasattr(engine, "lanes") else None
        self.lanes: List[Engine] = (list(self.group.lanes) if self.group
                                    else [engine])
        self.metrics = metrics or self.lanes[0].metrics
        self.flight = flight if flight is not None else engine.flight
        self.suspect_s = (suspect_s if suspect_s is not None
                          else _env_float("SWARMDB_LANE_SUSPECT_S", 2.0))
        self.quarantine_s = (
            quarantine_s if quarantine_s is not None
            else _env_float("SWARMDB_LANE_QUARANTINE_S",
                            2.0 * self.suspect_s))
        self.poll_s = poll_s if poll_s is not None else self.suspect_s / 4.0
        self.probe_clean_n = (probe_clean_n if probe_clean_n is not None
                              else _env_int("SWARMDB_LANE_PROBE_N", 3))
        self.probe_timeout_s = (
            probe_timeout_s if probe_timeout_s is not None
            else _env_float("SWARMDB_LANE_PROBE_TIMEOUT_S", 15.0))
        # bounds hangs (a lost stream must fail visibly), not slow but
        # progressing requests
        self.deadline_s = (deadline_s if deadline_s is not None
                           else _env_float("SWARMDB_REQ_DEADLINE_S", 600.0))
        self.retries = (retries if retries is not None
                        else _env_int("SWARMDB_REQ_RETRIES", 2))
        self.migrations = _env_int("SWARMDB_REQ_MIGRATIONS", 3)
        self.backoff_s = (backoff_s if backoff_s is not None
                          else _env_float("SWARMDB_RETRY_BACKOFF_S", 0.05))
        self.restart_backoff_s = _env_float(
            "SWARMDB_LANE_RESTART_BACKOFF_S", 0.25)
        # a loop stalled INSIDE a step may starve beats this long before
        # the stall reads as a wedge; a stall outside a step gets none.
        # The kernels are built before the loop starts (Engine.start), so
        # no step holds a build
        self.dispatch_grace_s = _env_float(
            "SWARMDB_LANE_DISPATCH_GRACE_S", 30.0)
        self.storm_n = _env_int("SWARMDB_RETRY_STORM_N", 8)
        self.health: List[_LaneHealth] = [_LaneHealth() for _ in self.lanes]
        # swarmlint: guarded-by[self._lock]: _tracked
        self._tracked: Dict[str, _Tracked] = {}
        self._lock = make_lock("backend.supervisor.LaneSupervisor._lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev_retried = self.metrics.counters["requests_retried"].value
        self._storming = False

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "LaneSupervisor":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._watch_loop, daemon=True,
                name="swarmdb-lane-supervisor")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._lock:
            trackers = list(self._tracked.values())
        for tr in trackers:
            with tr.lock:
                t = tr.retry_timer
            if t is not None:
                t.cancel()

    # ----------------------------------------------------------- submission

    def submit(self, request: GenRequest) -> str:
        """Adopt, route and submit one request. The returned id is stable
        across migrations and retries (replays reuse it), so cancel keeps
        working."""
        tr = self._adopt(request)
        # tracked before the dispatch: the fleet reports the request's lane
        # (note_lane) while the submit is still running
        with self._lock:
            self._tracked[request.request_id] = tr
        try:
            self._dispatch(request)
            return request.request_id
        except Exception:
            with self._lock:
                self._tracked.pop(request.request_id, None)
            raise

    def _adopt(self, request: GenRequest) -> _Tracked:
        """Stamp default budgets and bind attempt-scoped callbacks."""
        if request.deadline is None and self.deadline_s > 0:
            request.deadline = request.submitted_at + self.deadline_s
        if request.retries_left == 0:
            request.retries_left = max(0, self.retries)
        elif request.retries_left < 0:
            request.retries_left = 0
        tr = _Tracked(request, self.migrations)
        request.on_token, request.on_done = self._wrap(tr, 0)
        return tr

    def cancel(self, request_id: str) -> bool:
        """Cancel a supervised request wherever it lives, including a
        retry-timer wait that no engine knows about."""
        with self._lock:
            tr = self._tracked.get(request_id)
        if tr is None:
            return False
        with tr.lock:
            if tr.done:
                return False
            timer, tr.retry_timer = tr.retry_timer, None
        if timer is not None:
            timer.cancel()
            self._finalize(tr, "cancelled")
            return True
        # the engine's cancel flows through the wrapped on_done
        return any(eng.cancel(request_id) for eng in self.lanes)

    # ------------------------------------------------------------- routing

    def lane_admissible(self, idx: int) -> bool:
        return self.health[idx].state != LaneState.QUARANTINED

    def _route(self, request: GenRequest) -> Tuple[int, Engine]:
        if self.group is not None:
            return self.group._route(request)
        return 0, self.lanes[0]

    def _dispatch(self, request: GenRequest) -> int:
        """Route and submit one request (or replay): through the group's
        fleet when it has one (which reports lanes through
        ``note_lane``), else to the health-aware route. Returns the
        lane."""
        fleet = getattr(self.group, "fleet", None)
        if fleet is not None:
            idx = fleet.dispatch(request)
            if idx is not None:
                return idx
        idx, eng = self._route(request)
        self.note_lane(request.request_id, idx)
        eng.submit(request)
        return idx

    def note_lane(self, request_id: str, idx: int) -> None:
        """Record the lane a tracked request now lives on (the fleet calls
        it at each stage), so a quarantine finds it there."""
        with self._lock:
            tr = self._tracked.get(request_id)
        if tr is None:
            return
        with tr.lock:
            if not tr.done:
                tr.lane = idx

    # ------------------------------------------------------------ wrapping

    def _wrap(self, tr: _Tracked, attempt: int):
        def on_token(rid: str, token: int) -> None:
            with tr.lock:
                if tr.done or attempt != tr.attempt:
                    return  # stale attempt
                tr.emitted.append(token)
                cb = tr.user_on_token
            if cb is not None:
                cb(rid, token)

        def on_done(rid: str, tokens: List[int], reason: str) -> None:
            self._attempt_done(tr, attempt, reason)

        return on_token, on_done

    def _attempt_done(self, tr: _Tracked, attempt: int,
                      reason: str) -> None:
        """Final reasons (and exhausted budgets) reach the caller with the
        whole cross-attempt stream; retryable ones requeue after a
        jittered exponential backoff."""
        retry_delay = None
        with tr.lock:
            if tr.done or attempt != tr.attempt:
                return
            if (is_retryable_reason(reason) and len(tr.emitted)
                    >= tr.request.sampling.max_new_tokens):
                reason = "length"  # the stream completed before the loss
            if (is_retryable_reason(reason) and tr.retries_left > 0
                    and not self._stop.is_set()):
                delay = (self.backoff_s * (2 ** tr.retried)
                         * (1.0 + random.random()))
                if tr.deadline is None or time.time() + delay < tr.deadline:
                    tr.retries_left -= 1
                    tr.retried += 1
                    tr.attempt += 1
                    retry_delay = delay
                    next_attempt = tr.attempt
        if retry_delay is None:
            self._finalize(tr, reason)
            return
        self.metrics.counters["requests_retried"].inc()
        self.flight.record_event(
            {"kind": "request.retried", "rid": tr.request.request_id,
             "reason": reason, "attempt": next_attempt,
             "backoff_s": round(retry_delay, 4)})
        timer = threading.Timer(retry_delay, self._resubmit,
                                args=(tr, next_attempt))
        timer.daemon = True
        with tr.lock:
            if tr.done:  # cancelled while the timer was built
                return
            tr.retry_timer = timer
        timer.start()

    def _resubmit(self, tr: _Tracked, attempt: int) -> None:
        """Timer target: requeue the replay on a healthy lane."""
        with tr.lock:
            if tr.done or attempt != tr.attempt:
                return
            tr.retry_timer = None
            replay = self._build_replay(tr, attempt)
        try:
            self._dispatch(replay)
        except Exception:
            logger.exception("retry resubmit failed for %s",
                             tr.request.request_id)
            self._finalize(tr, "engine_error")

    def _build_replay(self, tr: _Tracked, attempt: int) -> GenRequest:
        """Prompt = original prompt + everything already emitted; decode
        budget reduced by the same amount (caller holds ``tr.lock``)."""
        emitted = list(tr.emitted)
        sp = tr.request.sampling
        replay = dataclasses.replace(
            tr.request,
            prompt=tr.prompt + emitted,
            sampling=dataclasses.replace(
                sp, max_new_tokens=max(1, sp.max_new_tokens - len(emitted))),
            submitted_at=time.time(),
            # a replay owns no registry pages: referencing or keeping them
            # would alias what the registry still holds
            resume_pages=None, resume_len=0, resume_epoch=None,
            keep_pages=False, on_pages=None, promote_payload=None)
        replay.on_token, replay.on_done = self._wrap(tr, attempt)
        return replay

    def _finalize(self, tr: _Tracked, reason: str) -> None:
        with tr.lock:
            if tr.done:
                return
            tr.done = True
            timer, tr.retry_timer = tr.retry_timer, None
            tokens = list(tr.emitted)
            cb = tr.user_on_done
        if timer is not None:
            timer.cancel()
        with self._lock:
            self._tracked.pop(tr.request.request_id, None)
        if cb is not None:
            try:
                cb(tr.request.request_id, tokens, reason)
            except Exception:
                logger.exception("on_done callback failed for %s",
                                 tr.request.request_id)

    # ------------------------------------------------------------ verdicts

    # swarmlint: heartbeat
    def _evaluate(self, eng: Engine, now: float) -> LaneState:
        # plain arithmetic over the engine's single-writer stamps
        if eng._thread is None:
            # never started or deliberately stopped: not a failure
            return LaneState.ALIVE
        if not eng.alive():
            return LaneState.QUARANTINED
        age = eng.beat_age_s(now)
        if age < self.suspect_s:
            return LaneState.ALIVE
        if eng._in_step and age < self.dispatch_grace_s:
            return LaneState.SUSPECT  # a long step, not yet a wedge
        if age < self.quarantine_s:
            return LaneState.SUSPECT
        return LaneState.QUARANTINED

    def _watch_loop(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            for idx, eng in enumerate(self.lanes):
                h = self.health[idx]
                if h.state == LaneState.QUARANTINED:
                    self._try_readmit(idx, eng, h)
                    continue
                new = self._evaluate(eng, now)
                if new != h.state:
                    self._transition(idx, eng, h, new)
            self._sweep_deadlines()
            self._detect_retry_storm()
            self._stop.wait(self.poll_s)

    def _transition(self, idx: int, eng: Engine, h: _LaneHealth,
                    new: LaneState) -> None:
        old, h.state = h.state, new
        h.since = time.monotonic()
        logger.warning("lane %d: %s -> %s (beat age %.3fs, thread %s)",
                       idx, old.name, new.name, eng.beat_age_s(),
                       "alive" if eng.alive() else "dead")
        self.flight.record_event(
            {"kind": f"lane.{new.name.lower()}", "lane": idx,
             "beat_age_s": round(eng.beat_age_s(), 4),
             "thread_alive": eng.alive()})
        TRACER.instant(f"lane.{new.name.lower()}", cat="supervisor",
                       args={"lane": idx})
        if new == LaneState.QUARANTINED:
            h.quarantines += 1
            h.clean_probes = 0
            self.metrics.counters["lane_quarantines"].inc()
            self._migrate_lane(idx)

    # ----------------------------------------------------------- migration

    def _migrate_lane(self, idx: int) -> None:
        """Replay every supervised request of quarantined lane ``idx`` on
        a healthy sibling. The attempt bump comes first (under the tracker
        lock), so whatever the dying lane still emits for the old attempt
        is dropped; then the old copy is cancelled; then the replay is
        dispatched. A request past its deadline ends "deadline" (in the
        JAX package the cancel's "cancelled" can win that race); a
        rolling-KV request, or one out of migrations, ends
        "lane_quarantined", as in the JAX package: a replay of a resume
        would prompt with its turn's delta alone."""
        with self._lock:
            victims = [tr for tr in self._tracked.values()
                       if tr.lane == idx]
        moved = 0
        for tr in victims:
            final = None
            with tr.lock:
                if tr.done or tr.lane != idx:
                    continue
                # every branch bumps the attempt first, so the cancel
                # below (which can fire on_done) reads as stale
                tr.attempt += 1
                bump = tr.attempt
                if len(tr.emitted) >= tr.request.sampling.max_new_tokens:
                    # generation finished before the loss: replaying would
                    # decode an extra token
                    final = "length"
                elif not tr.migratable:
                    final = "lane_quarantined"
                elif (tr.deadline is not None
                      and time.time() >= tr.deadline):
                    final = "deadline"
                elif tr.migrations_left <= 0:
                    final = "lane_quarantined"
                else:
                    tr.migrations_left -= 1
                    tr.migrated += 1
            # outside the tracker lock: cancel can fire the stale on_done
            try:
                self.lanes[idx].cancel(tr.request.request_id)
            except Exception:
                logger.exception("cancel on quarantined lane %d failed",
                                 idx)
            if final is not None:
                if final == "deadline":
                    self.metrics.counters["requests_deadline_expired"].inc()
                self._finalize(tr, final)
                continue
            with tr.lock:
                if tr.done or tr.attempt != bump:
                    continue
                replay = self._build_replay(tr, bump)
            try:
                new_idx = self._dispatch(replay)
                moved += 1
                self.metrics.counters["requests_migrated"].inc()
                self.flight.record_event(
                    {"kind": "request.migrated",
                     "rid": tr.request.request_id,
                     "from_lane": idx, "to_lane": new_idx,
                     "emitted": len(replay.prompt) - len(tr.prompt)})
            except Exception:
                logger.exception("migration resubmit failed for %s",
                                 tr.request.request_id)
                self._finalize(tr, "engine_error")
        if moved:
            logger.warning("lane %d quarantined: migrated %d request(s)",
                           idx, moved)

    # ------------------------------------------------------------ recovery

    def _try_readmit(self, idx: int, eng: Engine, h: _LaneHealth) -> None:
        """Restart a dead lane (with backoff), then require fresh beats
        and ``probe_clean_n`` clean probe generations."""
        now = time.monotonic()
        if not eng.alive():
            h.clean_probes = 0
            wait = self.restart_backoff_s * (2 ** min(h.restart_fails, 5))
            if now - h.last_restart < wait:
                return
            h.last_restart = now
            try:
                eng.restart()
                h.restarts += 1
                h.restart_fails = 0
            except Exception:
                h.restart_fails += 1
                logger.exception("lane %d restart failed (attempt %d)",
                                 idx, h.restart_fails)
            return
        if eng.beat_age_s() >= self.suspect_s:
            h.clean_probes = 0  # alive but not stepping: wedge not healed
            return
        if self._probe_lane(eng, h):
            h.state = LaneState.ALIVE
            self.metrics.counters["lane_readmissions"].inc()
            self.flight.record_event(
                {"kind": "lane.readmitted", "lane": idx,
                 "after_s": round(time.monotonic() - h.since, 3),
                 "restarts": h.restarts})
            h.since = time.monotonic()
            TRACER.instant("lane.readmitted", cat="supervisor",
                           args={"lane": idx})

    # swarmlint: retry
    def _probe_lane(self, eng: Engine, h: _LaneHealth) -> bool:
        """The probes still owed, bounded per tick, spaced, and under a
        deadline."""
        deadline = time.monotonic() + self.probe_timeout_s
        attempt = 0
        while h.clean_probes < self.probe_clean_n:
            if attempt >= self.probe_clean_n or self._stop.is_set():
                return False
            if time.monotonic() >= deadline or not self._probe_once(eng):
                h.clean_probes = 0
                return False
            h.clean_probes += 1
            attempt += 1
            time.sleep(self.poll_s * (attempt + 1))
        return True

    def _probe_once(self, eng: Engine) -> bool:
        done = threading.Event()
        result: Dict[str, Any] = {}

        def on_done(rid, toks, reason):
            result["reason"] = reason
            done.set()

        try:
            eng.submit(GenRequest(
                prompt=[1, 2, 3],
                sampling=SamplingParams(max_new_tokens=1, temperature=0.0),
                priority=3, on_done=on_done, metadata={"probe": True}))
        except Exception:
            logger.exception("lane probe submit failed")
            return False
        if not done.wait(self.probe_timeout_s):
            return False
        return result.get("reason") in ("length", "eos")

    # ---------------------------------------------------------- watchdogs

    def _sweep_deadlines(self) -> None:
        """Requests past their deadline fail now with "deadline", whether
        queued, decoding, or parked on a retry timer."""
        now = time.time()
        with self._lock:
            expired = [tr for tr in self._tracked.values()
                       if tr.deadline is not None and now > tr.deadline]
        for tr in expired:
            with tr.lock:
                if tr.done:
                    continue
                tr.attempt += 1  # stale-proof in-flight callbacks
                lane = tr.lane
            try:
                self.lanes[lane].cancel(tr.request.request_id)
            except Exception:
                logger.exception("deadline cancel failed")
            self.metrics.counters["requests_deadline_expired"].inc()
            self._finalize(tr, "deadline")

    def _detect_retry_storm(self) -> None:
        """At least ``storm_n`` retries within one poll: one "retry.storm"
        flight event and tracer instant, until a poll sees none."""
        cur = self.metrics.counters["requests_retried"].value
        delta, self._prev_retried = cur - self._prev_retried, cur
        if delta >= self.storm_n and not self._storming:
            self._storming = True
            self.flight.record_event(
                {"kind": "retry.storm", "retries_in_window": delta,
                 "window_s": round(self.poll_s, 3)})
            TRACER.instant("retry.storm", cat="supervisor",
                           args={"retries": delta})
        elif delta == 0:
            self._storming = False

    # -------------------------------------------------------------- status

    def status(self) -> Dict[str, Any]:
        """Per-lane state (the JAX package's ``lanes`` list), the request
        counters and the config."""
        with self._lock:
            tracked = len(self._tracked)
        c = self.metrics.counters
        return {
            "lanes": [
                {"lane": i,
                 "state": h.state.name.lower(),
                 "state_code": int(h.state),
                 "beat_age_s": round(eng.beat_age_s(), 4),
                 "thread_alive": eng.alive(),
                 "quarantines": h.quarantines,
                 "restarts": h.restarts}
                for i, (eng, h) in enumerate(zip(self.lanes, self.health))
            ],
            "tracked_requests": tracked,
            "requests_migrated": c["requests_migrated"].value,
            "requests_retried": c["requests_retried"].value,
            "requests_shed": c["requests_shed"].value,
            "requests_deadline_expired":
                c["requests_deadline_expired"].value,
            "lane_quarantines": c["lane_quarantines"].value,
            "lane_readmissions": c["lane_readmissions"].value,
            "config": {
                "suspect_s": self.suspect_s,
                "quarantine_s": self.quarantine_s,
                "probe_clean_n": self.probe_clean_n,
                "deadline_s": self.deadline_s,
                "retries": self.retries,
                "migrations": self.migrations,
                "backoff_s": self.backoff_s,
                "dispatch_grace_s": self.dispatch_grace_s,
            },
        }

    def prometheus_lines(self) -> List[str]:
        """``swarmdb_lane_state{lane=}`` (0 alive, 1 suspect, 2
        quarantined) and ``swarmdb_lane_beat_age_seconds{lane=}`` gauges
        for /metrics; the retry / shed counters ride the shared
        registry."""
        lines = ["# TYPE swarmdb_lane_state gauge"]
        lines += [f'swarmdb_lane_state{{lane="{i}"}} {int(h.state)}'
                  for i, h in enumerate(self.health)]
        lines.append("# TYPE swarmdb_lane_beat_age_seconds gauge")
        lines += [f'swarmdb_lane_beat_age_seconds{{lane="{i}"}} '
                  f"{round(eng.beat_age_s(), 4)}"
                  for i, eng in enumerate(self.lanes)]
        return lines
