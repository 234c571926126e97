"""Disaggregated prefill and decode lane pools.

The counterpart of ``swarmdb_tpu/parallel/fleet.py``.
``SWARMDB_FLEET=prefill:N,decode:M`` splits a ``ShardLaneGroup``'s lanes
into two pools, so that prefill waves and decode sessions stop sharing
lanes:

- **Prefill lanes** run admission waves only. A staged request lands
  there with ``max_new_tokens=1`` and ``keep_pages``; the lane retires it
  straight off the prefill sample (``Engine._drain_prefill_only``), and
  ``on_pages`` gathers its written K/V into the transit store: an
  ``ops.host_pool.HostPageStore`` over one slab of host memory
  (``SWARMDB_FLEET_TRANSIT_MB``, default 256; page-locked on the card).
  The gather runs on the prefill lane's stream and an event recorded
  after it passes before the store publishes the payload.
- **Decode lanes** run decode sessions. Stage 2 reserves device pages on
  a decode lane and submits the request again with the payload to insert
  (``GenRequest.promote_payload``: the decode lane copies it on its own
  stream and keeps it until that copy's event passes), ``resume_pages``
  / ``resume_len`` over it and the first sampled token as its prompt: the
  decode lane's resume prefill feeds that token, as colocated decode
  feeds it as row 0 of its first block.

``SWARMDB_FLEET_TIERS`` gives per-lane speed weights that the group's
routing folds into its load score, and priority >= 3 requests pin to the
fastest admissible lanes. Every fallback serves the request all the
same: a quarantined pool sends the whole request to the other pool, a
payload that is gone (evicted, no pages) re-prefills from the prompt and
the emitted tokens, and the supervisor's migration re-stages the
requests of a killed lane. Without ``SWARMDB_FLEET`` the group is the
colocated design.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops.host_pool import HostPageStore
from ..ops.paged_kv import pool_gather_pages
from ..utils.sync import make_lock

logger = logging.getLogger("swarmdb_tpu_torch.fleet")

__all__ = ["FleetManager", "build_fleet", "parse_fleet_spec",
           "parse_tier_weights"]


def parse_fleet_spec(n_lanes: int, spec: Optional[str] = None
                     ) -> Optional[Dict[str, List[int]]]:
    """``prefill:N,decode:M`` (default ``SWARMDB_FLEET``) -> the pool
    map, prefill lanes first, or None (fleet off). A spec that does not
    exactly split the lanes into two non-empty pools is refused with a
    warning, never resized."""
    if spec is None:
        spec = os.environ.get("SWARMDB_FLEET", "")
    spec = (spec or "").strip()
    if not spec:
        return None
    counts: Dict[str, int] = {}
    try:
        for part in spec.split(","):
            role, sep, cnt = part.strip().partition(":")
            role = role.strip().lower()
            if not sep or role not in ("prefill", "decode"):
                raise ValueError(part)
            counts[role] = int(cnt)
    except (ValueError, TypeError):
        logger.warning("SWARMDB_FLEET=%r is not 'prefill:N,decode:M'; "
                       "fleet disabled (colocated lanes)", spec)
        return None
    n_pre, n_dec = counts.get("prefill", 0), counts.get("decode", 0)
    if n_pre <= 0 or n_dec <= 0 or n_pre + n_dec != n_lanes:
        logger.warning(
            "SWARMDB_FLEET=%r does not partition %d lanes into non-empty "
            "prefill+decode pools; fleet disabled", spec, n_lanes)
        return None
    return {"prefill": list(range(n_pre)),
            "decode": list(range(n_pre, n_pre + n_dec))}


def parse_tier_weights(n_lanes: int, spec: Optional[str] = None
                       ) -> Optional[List[float]]:
    """``1.0,1.0,0.5,...`` (default ``SWARMDB_FLEET_TIERS``) -> one
    positive weight per lane, or None (homogeneous)."""
    if spec is None:
        spec = os.environ.get("SWARMDB_FLEET_TIERS", "")
    spec = (spec or "").strip()
    if not spec:
        return None
    try:
        w = [float(x) for x in spec.split(",")]
    except (ValueError, TypeError):
        logger.warning("SWARMDB_FLEET_TIERS=%r is not a float list; "
                       "ignoring tier weights", spec)
        return None
    if len(w) != n_lanes or any(x <= 0 for x in w):
        logger.warning("SWARMDB_FLEET_TIERS needs %d positive weights "
                       "(got %r); ignoring tier weights", n_lanes, spec)
        return None
    return w


def transit_capacity_bytes() -> int:
    """``SWARMDB_FLEET_TRANSIT_MB`` in bytes (default 256 MiB)."""
    try:
        mb = float(os.environ.get("SWARMDB_FLEET_TRANSIT_MB", "256"))
    except ValueError:
        mb = 256.0
    return max(1, int(mb * (1 << 20)))


class _Handoff:
    """One staged request between the pools. Its callbacks close over
    this object: a migration that stages the same request id again
    replaces it in ``FleetManager._active``, and a stale callback finds
    itself replaced."""

    __slots__ = ("request", "prefill_idx", "tokens", "lps", "written",
                 "n_pages", "has_payload", "in_transit", "cancelled", "t0")

    def __init__(self, request: Any, prefill_idx: int) -> None:
        self.request = request
        self.prefill_idx = prefill_idx
        self.tokens: List[int] = []
        self.lps: List[float] = []
        self.written = 0
        self.n_pages = 0
        self.has_payload = False
        self.in_transit = False
        self.cancelled = False
        self.t0 = 0.0


class FleetManager:
    """The pool map and the two-stage handoff of one ``ShardLaneGroup``."""

    def __init__(self, group: Any, pools: Dict[str, List[int]],
                 weights: Optional[List[float]] = None,
                 store: Optional[HostPageStore] = None) -> None:
        self.group = group
        self.pools = pools
        self.weights = weights
        self.store = store if store is not None else HostPageStore(
            capacity_bytes=transit_capacity_bytes(), label="fleet",
            pinned=any(e.device.type == "cuda" for e in group.lanes))
        self._lock = make_lock("parallel.fleet.FleetManager._lock")
        # swarmlint: guarded-by[self._lock]: _active
        self._active: Dict[str, _Handoff] = {}
        self._handoff_ms: "deque[float]" = deque(maxlen=1024)
        self._gather_s = 0.0
        self._gathered_pages = 0
        self.metrics = group.metrics
        self._role_by_lane: Dict[int, str] = {}
        for role in ("prefill", "decode"):
            for j in pools[role]:
                self._role_by_lane[j] = role
                eng = group.lanes[j]
                eng._role = role
                # the profiler's pools_report groups duty cycles and MFU
                # by role (the shared NullLane has no pool)
                if hasattr(eng._prof, "set_pool"):
                    eng._prof.set_pool(role)

    # ------------------------------------------------------------- routing

    def lane_role(self, idx: int) -> Optional[str]:
        return self._role_by_lane.get(idx)

    def _admissible(self, role: str) -> List[int]:
        sup = self.group.supervisor
        idxs = self.pools[role]
        if sup is None:
            return list(idxs)
        return [j for j in idxs if sup.lane_admissible(j)]

    def _route_in(self, request: Any, role: str) -> Tuple[int, Any]:
        return self.group._route(request, within=self.pools[role])

    def _note(self, rid: str, idx: int) -> None:
        sup = self.group.supervisor
        if sup is not None:
            sup.note_lane(rid, idx)

    def _submit_direct(self, request: Any, role: str) -> int:
        idx, eng = self._route_in(request, role)
        self._note(request.request_id, idx)
        eng.submit(request)
        return idx

    def _stageable(self, request: Any) -> bool:
        if (request.resume_pages is not None or request.keep_pages
                or request.promote_payload is not None
                or request.on_pages is not None):
            return False  # page custody cannot span the handoff
        if request.sampling.max_new_tokens < 2 or not request.prompt:
            return False
        dec = self.group.lanes[self.pools["decode"][0]]
        covering = -(-len(request.prompt) // dec.paged.page_size)
        if not 0 < covering <= dec._prefix_pp_buckets[-1]:
            return False
        # stage 2 resumes from len(prompt) with a one-token prompt
        return len(request.prompt) + 1 < dec.max_seq

    # ------------------------------------------------------------ dispatch

    def dispatch(self, request: Any) -> Optional[int]:
        """Route and submit one request through the fleet: the lane it
        landed on (a staged request's prefill lane), or None when both
        pools are quarantined (the caller routes it colocated)."""
        c = self.metrics.counters
        pre_ok = self._admissible("prefill")
        dec_ok = self._admissible("decode")
        if not pre_ok and not dec_ok:
            return None
        if not dec_ok or not pre_ok:
            # one pool quarantined: the other serves whole requests until
            # the supervisor re-admits its siblings
            c["fleet_colocated_fallback"].inc()
            return self._submit_direct(request,
                                       "prefill" if pre_ok else "decode")
        if (request.resume_pages is not None
                or request.promote_payload is not None
                or request.keep_pages):
            # rolling custody lives in one pool's pages: the decode pool
            c["fleet_direct_decode"].inc()
            return self._submit_direct(request, "decode")
        if request.sampling.max_new_tokens <= 1:
            # admission-only work: the prefill lane retires it in place
            c["fleet_direct_prefill"].inc()
            return self._submit_direct(request, "prefill")
        if not self._stageable(request):
            c["fleet_colocated_fallback"].inc()
            return self._submit_direct(request, "decode")
        return self._stage1_submit(request)

    # ------------------------------------------------------------- stage 1

    def _stage1_submit(self, request: Any) -> int:
        rid = request.request_id
        idx, eng = self._route_in(request, "prefill")
        h = _Handoff(request, idx)
        with self._lock:
            old = self._active.pop(rid, None)
            self._active[rid] = h
        if old is not None:
            # a migration staged the same request again: the old
            # attempt's payload is stale
            self._drop_payload(old)
        sp = request.sampling
        stage1 = dataclasses.replace(
            request,
            sampling=dataclasses.replace(sp, max_new_tokens=1),
            keep_pages=True,
            on_pages=lambda r, pages, written, tail:
                self._on_pages(h, r, pages, written, tail),
            on_done=lambda r, toks, reason:
                self._stage1_done(h, r, toks, reason),
        )
        self._note(rid, idx)
        try:
            eng.submit(stage1)
        except Exception:
            with self._lock:
                if self._active.get(rid) is h:
                    del self._active[rid]
            raise
        return idx

    def _on_pages(self, h: _Handoff, rid: str, pages: List[int],
                  written: int, tail: List[int]) -> None:
        """Prefill lane's thread, at retirement: gather the request's
        written K/V into the transit store and free the device pages, as
        a demotion does (``backend/tiering.py``)."""
        eng = self.group.lanes[h.prefill_idx]
        with self._lock:
            stale = self._active.get(rid) is not h or h.cancelled
        if stale or not pages or written <= 0:
            if pages:
                eng.rolling_free(pages)
            return
        evicted: List[Any] = []

        def host(shape, dtype):
            # the store's slab, older payloads evicted for room
            t, out = self.store.host_tensor(shape, dtype, evict=True)
            evicted.extend(out)
            return t

        stored = False
        t0 = time.perf_counter()
        # the page sanitizer sees transit custody as host_resident, as a
        # demotion's
        pc = getattr(eng, "_pagecheck", None)
        try:
            if pc is not None:
                pc.on_demote(pages, rid)
            k_pay = pool_gather_pages(eng.cache["k"], pages, host)
            v_pay = (pool_gather_pages(eng.cache["v"], pages, host)
                     if k_pay is not None else None)
            if eng.device.type == "cuda":
                # enqueued on this lane's stream: publish once landed
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
            if v_pay is not None:
                evicted += self.store.put(rid, k_pay, v_pay, len(pages),
                                          written)
                stored = rid not in evicted
        except Exception:
            logger.exception("fleet handoff gather failed for %s", rid)
        finally:
            eng.rolling_free(pages)
            if not stored and pc is not None:
                pc.on_host_drop(rid)
        for ek in evicted:
            if ek != rid:
                self._evict_handoff(ek)
        if stored:
            h.written = written
            h.n_pages = len(pages)
            h.has_payload = True
            with self._lock:
                self._gather_s += time.perf_counter() - t0
                self._gathered_pages += len(pages)

    def _evict_handoff(self, rid: str) -> None:
        """Another handoff's payload left the store for room: its stage
        2 re-prefills."""
        with self._lock:
            victim = self._active.get(rid)
        if victim is None:
            return
        victim.has_payload = False
        pc = getattr(self.group.lanes[victim.prefill_idx], "_pagecheck",
                     None)
        if pc is not None:
            pc.on_host_drop(rid)

    def _stage1_done(self, h: _Handoff, rid: str, toks: List[int],
                     reason: str) -> None:
        """Prefill lane's thread, inside retirement's on_done (never
        raises): build and submit stage 2, or a fallback."""
        req = h.request
        with self._lock:
            if self._active.get(rid) is not h:
                return  # replaced by a migration's new attempt
            if h.cancelled:
                return  # the cancel reported on_done already
            h.in_transit = True
            h.t0 = time.monotonic()
        try:
            h.tokens = list(toks)
            lps = req.metadata.get("logprobs")
            h.lps = list(lps) if isinstance(lps, list) else []
            if reason == "length" and toks:
                self._submit_stage2(h, rid)
                return
            # eos at the first token, a cancel, a loss: the stage-1
            # verdict stands (the supervisor retries what is retryable)
            self._drop_payload(h)
            self._finish(h, rid, list(toks), reason)
        except Exception:
            logger.exception("fleet stage-2 build failed for %s", rid)
            try:
                self._cold_replay(h, rid)
            except Exception:
                logger.exception("fleet cold replay failed for %s", rid)
                self._finish(h, rid, list(h.tokens), "engine_error")

    # ------------------------------------------------------------- stage 2

    def _submit_stage2(self, h: _Handoff, rid: str) -> None:
        c = self.metrics.counters
        req = h.request
        entry = self.store.pop(rid)
        pre_pc = getattr(self.group.lanes[h.prefill_idx], "_pagecheck",
                         None)
        if pre_pc is not None:
            # custody leaves the prefill pool whether or not the payload
            # survived (a miss re-prefills)
            pre_pc.on_host_drop(rid)
        dec_ok = self._admissible("decode")
        if entry is None or not h.has_payload or not dec_ok:
            c["fleet_handoff_fallbacks"].inc()
            self._cold_replay(h, rid)
            return
        idx, eng = self.group._route(req, within=dec_ok)
        alloc = eng.paged.allocator
        ids = alloc.reserve(entry.n_pages)
        if len(ids) < entry.n_pages:
            alloc.add_free(ids)
            c["fleet_handoff_fallbacks"].inc()
            self._cold_replay(h, rid)
            return
        pc = getattr(eng, "_pagecheck", None)
        if pc is not None:
            pc.on_promote(ids, rid)
        sp = req.sampling
        epoch = eng.pool_epoch()
        stage2 = dataclasses.replace(
            req,
            prompt=list(h.tokens),
            sampling=dataclasses.replace(
                sp, max_new_tokens=sp.max_new_tokens - len(h.tokens)),
            resume_pages=ids, resume_len=h.written, resume_epoch=epoch,
            promote_payload=(entry.k, entry.v),
            keep_pages=False, on_pages=None,
            on_done=lambda r, toks, reason:
                self._stage2_done(h, eng, ids, epoch, r, toks, reason),
        )
        with self._lock:
            if h.cancelled:
                # cancelled between the stages: cancel() reported on_done
                eng.rolling_free(ids)
                return
            h.in_transit = False
        self._note(rid, idx)
        # the handoff is counted before stage 2 is submitted: the decode
        # lane can finish it, and its caller read the counters, before
        # this thread runs again (a failed submit then counts a fallback
        # beside it)
        dt_ms = (time.monotonic() - h.t0) * 1e3
        with self._lock:
            self._handoff_ms.append(dt_ms)
        c["fleet_handoffs"].inc()
        self.metrics.latencies["fleet_handoff_s"].observe(dt_ms / 1e3)
        try:
            eng.submit(stage2)
        except Exception:
            logger.exception("fleet stage-2 submit failed for %s", rid)
            eng.rolling_free(ids)
            c["fleet_handoff_fallbacks"].inc()
            self._cold_replay(h, rid)

    def _stage2_done(self, h: _Handoff, eng: Any, ids: List[int],
                     epoch: int, rid: str, toks: List[int],
                     reason: str) -> None:
        """Decode lane's thread, at retirement: free the resumed pages
        (unless a restart reclaimed them) and report the whole stream."""
        if epoch == eng.pool_epoch():
            try:
                eng.rolling_free(ids)
            except Exception:
                logger.exception("fleet resume-page free failed for %s",
                                 rid)
        req = h.request
        lps = req.metadata.get("logprobs")
        if isinstance(lps, list):
            req.metadata["logprobs"] = h.lps + lps
        self._finish(h, rid, list(h.tokens) + list(toks), reason)

    # ----------------------------------------------------------- fallbacks

    def _cold_replay(self, h: _Handoff, rid: str) -> None:
        """The payload is gone (evicted, no pages, a failed submit):
        prefill again from the prompt plus the emitted tokens, the
        supervisor's replay discipline."""
        self._drop_payload(h)
        req = h.request
        emitted = list(h.tokens)
        sp = req.sampling
        left = sp.max_new_tokens - len(emitted)
        if left <= 0:
            self._finish(h, rid, emitted, "length")
            return
        replay = dataclasses.replace(
            req,
            prompt=list(req.prompt) + emitted,
            sampling=dataclasses.replace(sp, max_new_tokens=left),
            resume_pages=None, resume_len=0, resume_epoch=None,
            promote_payload=None, keep_pages=False, on_pages=None,
            on_done=lambda r, toks, reason:
                self._finish(h, r, emitted + list(toks), reason),
        )
        pool = (self._admissible("decode") or self._admissible("prefill")
                or list(range(len(self.group.lanes))))
        with self._lock:
            if h.cancelled:
                return
            h.in_transit = False
        idx, eng = self.group._route(replay, within=pool)
        self._note(rid, idx)
        eng.submit(replay)

    def _drop_payload(self, h: _Handoff) -> None:
        rid = h.request.request_id
        if self.store.drop(rid) or h.has_payload:
            pc = getattr(self.group.lanes[h.prefill_idx], "_pagecheck",
                         None)
            if pc is not None:
                pc.on_host_drop(rid)
        h.has_payload = False

    def _finish(self, h: _Handoff, rid: str, tokens: List[int],
                reason: str) -> None:
        with self._lock:
            if self._active.get(rid) is h:
                del self._active[rid]
        req = h.request
        if req.on_done is not None:
            try:
                req.on_done(rid, tokens, reason)
            except Exception:
                logger.exception("fleet on_done failed for %s", rid)

    # -------------------------------------------------------------- cancel

    def cancel(self, request_id: str) -> bool:
        """Cancel a request between the stages (stage 1 retired, stage 2
        not submitted), where no lane knows it; a request inside a lane
        cancels through that lane."""
        with self._lock:
            h = self._active.get(request_id)
            if h is None or not h.in_transit or h.cancelled:
                return False
            h.cancelled = True
        self._drop_payload(h)
        self._finish(h, request_id, list(h.tokens), "cancelled")
        return True

    # --------------------------------------------------------------- intro

    def stats(self) -> Dict[str, Any]:
        """The JAX package's fleet stats, and the port's gather cost
        (``gather_ms_per_page``: gather, copy into the slab and the
        event's wait, per page) and transit slab (``transit_slab``)."""
        c = self.metrics.counters
        with self._lock:
            lat = sorted(self._handoff_ms)
            active = len(self._active)
            gather_ms = (self._gather_s * 1e3 / self._gathered_pages
                         if self._gathered_pages else None)

        def pct(p: float) -> Optional[float]:
            if not lat:
                return None
            return round(lat[min(len(lat) - 1, int(p * (len(lat) - 1)))], 3)

        return {
            "pools": {r: list(v) for r, v in self.pools.items()},
            "pool_sizes": {r: len(v) for r, v in self.pools.items()},
            "weights": list(self.weights) if self.weights else None,
            "handoffs": c["fleet_handoffs"].value,
            "handoff_fallbacks": c["fleet_handoff_fallbacks"].value,
            "direct_prefill": c["fleet_direct_prefill"].value,
            "direct_decode": c["fleet_direct_decode"].value,
            "colocated_fallback": c["fleet_colocated_fallback"].value,
            "in_flight": active,
            "handoff_ms_p50": pct(0.50),
            "handoff_ms_p95": pct(0.95),
            "gather_ms_per_page": gather_ms,
            "transit_store": self.store.stats(),
            "transit_slab": self.store.slab_stats(),
        }


def build_fleet(group: Any) -> Optional[FleetManager]:
    """A ``FleetManager`` over ``group`` from ``SWARMDB_FLEET`` (and
    ``SWARMDB_FLEET_TIERS``), or None: colocated lanes."""
    n = len(group.lanes)
    pools = parse_fleet_spec(n)
    if pools is None:
        return None
    for d in pools["decode"]:
        if not group.lanes[d].supports_rolling():
            logger.warning(
                "SWARMDB_FLEET disabled: decode lane %d lacks the resume "
                "prefill (paged engines with the prefix cache only)", d)
            return None
    return FleetManager(group, pools, parse_tier_weights(n))
