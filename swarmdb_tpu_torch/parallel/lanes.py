"""Per-lane admission: data-parallel serving as N independent paged
engines behind one Engine-shaped facade.

The counterpart of ``swarmdb_tpu/parallel/lanes.py``. One engine per
device of a device list, which may repeat a card: every lane is a
complete paged engine (its own page pool and prefix cache, admission
queue, decode loop thread, CUDA stream and decode graphs), and lanes on
one device share one read-only copy of the weights. Admission is per
lane, so one lane's prefill never stalls a sibling's decode session
(``engine_admission_overlap_steps`` counts the waves admitted while a
sibling lane was inside one).

Routing keeps a conversation's turns on one lane (its prefix-cache pages
live in that lane's pool only): a request's ``shard_hint`` (the serving
layer's stable hash of the conversation pair) pins it; without one, a
tier locator, then the critical-tier pin, then the least-loaded lane
with a round-robin tiebreak. A lane supervisor attached to the group
(``attach_supervisor``) adopts every request and keeps quarantined lanes
out of routing; ``SWARMDB_FLEET`` splits the lanes into prefill and
decode pools (``parallel/fleet.py``).

The facade carries what ``ServingService``, the API and the tests read of
an engine (submit / cancel / stats / warmup / flight / paged / prefix).
Rolling KV is refused on a group: page custody cannot span lanes.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..backend.engine import Engine, GenRequest
from ..obs import TRACER, FlightRecorder
from ..utils.device import DeviceLike, resolve_device
from ..utils.metrics import MetricsRegistry
from ..utils.sync import make_lock

logger = logging.getLogger("swarmdb_tpu_torch.lanes")

__all__ = ["LaneGroupInfo", "ShardLaneGroup", "build_lane_group"]


@dataclass
class LaneGroupInfo:
    """What ``build_serving_engine`` returns beside the engine: the config,
    the lanes' devices and their count."""

    cfg: Any
    devices: List[torch.device]
    data_size: int


class _LaneAllocatorView:
    """The lanes' allocators as one: ``n_shards`` routes the serving
    layer's shard hints (and refuses rolling), ``stats()`` sums them."""

    def __init__(self, group: "ShardLaneGroup") -> None:
        self._group = group

    @property
    def n_shards(self) -> int:
        return len(self._group.lanes)

    def stats(self) -> Dict[str, Any]:
        per = [e.paged.allocator.stats() for e in self._group.lanes]
        return {
            "num_pages": sum(s["num_pages"] for s in per),
            "page_size": per[0]["page_size"],
            "free_pages": sum(s["free_pages"] for s in per),
            "lanes": len(per),
            "pages_allocated_total": sum(s["pages_allocated_total"]
                                         for s in per),
            "pages_freed_total": sum(s["pages_freed_total"] for s in per),
        }


class _LanePagedView:
    """``Engine.paged`` of the group: truthy, with the allocator view and
    the page size."""

    def __init__(self, group: "ShardLaneGroup") -> None:
        self.allocator = _LaneAllocatorView(group)
        self.page_size = group.lanes[0].paged.page_size
        self.num_pages = sum(e.paged.num_pages for e in group.lanes)


class _LanePrefixView:
    """``Engine._prefix`` of the group: the lanes' prefix-cache counters
    summed (a conversation hits its own lane's pages only)."""

    def __init__(self, group: "ShardLaneGroup") -> None:
        self._group = group

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for e in self._group.lanes:
            if e._prefix is None:
                continue
            for k, v in e._prefix.stats().items():
                if isinstance(v, (int, float)):
                    out[k] = out.get(k, 0) + v
        return out


class ShardLaneGroup:
    """N paged engines behind the Engine facade."""

    def __init__(self, lanes: List[Engine], info: LaneGroupInfo,
                 flight_dir: Optional[str] = None) -> None:
        if not lanes:
            raise ValueError("a lane group needs at least one engine")
        self.lanes = lanes
        self.info = info
        ref = lanes[0]
        self.max_batch = sum(e.max_batch for e in lanes)
        self.max_seq = ref.max_seq
        self.decode_chunk = ref.decode_chunk
        self.prefill_batch = ref.prefill_batch
        self.metrics = ref.metrics
        self.params = ref.params
        self.device = ref.device
        self._flight_dir = (flight_dir if flight_dir is not None
                            else ref._flight_dir)
        # one flight recorder for the group: events carry their lane in
        # "shard" (event writes are locked; lanes write from their threads)
        self.flight = FlightRecorder()
        self.tracer = TRACER
        self._sentinel = None
        self.flight.meta.update({
            "devices": [str(d) for d in info.devices],
            "paged_shards": len(lanes),
            "admit_overlap": True,
            "ragged_prefill": bool(ref._ragged),
            "max_batch": self.max_batch,
            "max_seq": self.max_seq,
        })
        self.paged = _LanePagedView(self)
        self._prefix = (_LanePrefixView(self)
                        if any(e._prefix is not None for e in lanes)
                        else None)
        self._prefix_ps = ref._prefix_ps
        # the lane supervisor (attach_supervisor): adopts submissions and
        # keeps quarantined lanes out of routing
        self.supervisor = None
        # tier-aware routing hook: request -> the lane whose warm store
        # holds its conversation, or None (no caller sets it while groups
        # refuse rolling; kept for the routing order)
        self.tier_locator: Optional[Callable[[GenRequest],
                                             Optional[int]]] = None
        self._rr = 0
        self._rr_lock = make_lock("parallel.lanes.ShardLaneGroup._rr_lock")
        for idx, eng in enumerate(lanes):
            eng.flight = self.flight
            eng.flight_shard = idx
            eng._flight_dir = self._flight_dir
            eng.overlap_probe = self._make_probe(idx)
        # SWARMDB_FLEET=prefill:N,decode:M splits the lanes into role
        # pools; built before warmup(), which a prefill lane shortens
        from .fleet import build_fleet, parse_tier_weights

        # SWARMDB_FLEET_TIERS: per-lane speed weights (None: homogeneous)
        self.lane_weights: Optional[List[float]] = parse_tier_weights(
            len(lanes))
        self.fleet = build_fleet(self)

    def _make_probe(self, idx: int) -> Callable[[], bool]:
        def probe() -> bool:
            return any(e._lane_busy for j, e in enumerate(self.lanes)
                       if j != idx)
        return probe

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        for e in self.lanes:
            e.start()

    def stop(self) -> None:
        for e in self.lanes:
            e.stop()

    def alive(self) -> bool:
        """Without a supervisor any dead lane makes the group read dead
        (the serving watchdog then calls ``restart``); with one, a lane's
        death is the supervisor's to handle, and the group reads dead only
        when every lane is."""
        if self.supervisor is not None:
            return any(e.alive() for e in self.lanes)
        return all(e.alive() for e in self.lanes)

    def restart(self) -> None:
        """Restart the dead lanes only: one lane's death must not fail
        the healthy lanes' requests."""
        for e in self.lanes:
            if not e.alive():
                e.restart()

    def warmup(self) -> float:
        """Warm every lane at once, each on its own thread; captures on
        one card take turns on its graph lock. Returns the seconds
        spent."""
        t0 = time.perf_counter()
        if len(self.lanes) == 1:
            self.lanes[0].warmup()
        else:
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=min(8, len(self.lanes))) as ex:
                list(ex.map(lambda e: e.warmup(), self.lanes))
        return time.perf_counter() - t0

    # -------------------------------------------------------- scheduling

    def _admissible(self) -> List[int]:
        """Lanes taking admissions: all but the supervisor's quarantined
        ones, or all of them when every lane is quarantined (queueing on
        a recovering lane beats refusing; deadlines bound the wait)."""
        sup = self.supervisor
        if sup is None:
            return list(range(len(self.lanes)))
        ok = [j for j in range(len(self.lanes)) if sup.lane_admissible(j)]
        return ok or list(range(len(self.lanes)))

    def _route(self, request: GenRequest,
               within: Optional[List[int]] = None) -> Tuple[int, Engine]:
        """(lane index, lane) for ``request``, among ``within`` when given
        (a fleet pool; its admissible lanes, or all admissible ones when
        the whole pool is quarantined): the hinted lane (a quarantined
        one's requests remap deterministically, so a conversation's turns
        keep meeting), the tier locator's lane, the fastest tier for
        priority >= 3 under tier weights, else the least-loaded lane
        (weighted), ties broken round-robin."""
        ok = self._admissible()
        if within:
            sel = [j for j in within if j in ok]
            ok = sel or ok
        if request.shard_hint is not None:
            j = request.shard_hint % len(self.lanes)
            if j in ok:
                return j, self.lanes[j]
            j = ok[request.shard_hint % len(ok)]
            return j, self.lanes[j]
        if self.tier_locator is not None:
            try:
                t = self.tier_locator(request)
            except Exception:
                logger.exception("tier locator failed")
                t = None
            if t is not None:
                t = t % len(self.lanes)
                if t in ok:
                    return t, self.lanes[t]
        w = self.lane_weights
        if w is not None and request.priority >= 3:
            top = max(w[j] for j in ok)
            ok = [j for j in ok if w[j] >= top] or ok
        # racy load reads: balance is a heuristic, never a correctness
        # condition
        with self._rr_lock:
            self._rr += 1
            rot = self._rr
        loads = []
        for j in ok:
            e = self.lanes[j]
            load = len(e._queue) + sum(1 for s in e.slots if s.active)
            if w is not None:
                load = load / w[j]
            loads.append((load, (j + rot) % len(self.lanes), j))
        _, _, j = min(loads)
        return j, self.lanes[j]

    def submit(self, request: GenRequest) -> str:
        """Through the supervisor when one is attached (it routes through
        the fleet), else through the fleet, else to the routed lane."""
        if self.supervisor is not None:
            return self.supervisor.submit(request)
        if self.fleet is not None:
            if self.fleet.dispatch(request) is not None:
                return request.request_id
        return self._route(request)[1].submit(request)

    def cancel(self, request_id: str) -> bool:
        if self.supervisor is not None and self.supervisor.cancel(
                request_id):
            return True
        if self.fleet is not None and self.fleet.cancel(request_id):
            # between the fleet's two stages no lane knows the id
            return True
        return any(e.cancel(request_id) for e in self.lanes)

    def generate_sync(self, prompt: List[int], sampling: Any,
                      timeout: float = 120.0) -> Tuple[List[int], str]:
        """Blocking convenience API (tests)."""
        import threading

        done = threading.Event()
        result: Dict[str, Any] = {}

        def on_done(rid, toks, reason):
            result["tokens"], result["reason"] = toks, reason
            done.set()

        self.submit(GenRequest(prompt=prompt, sampling=sampling,
                               on_done=on_done))
        if not done.wait(timeout):
            raise TimeoutError("generation timed out")
        return result["tokens"], result["reason"]

    # ------------------------------------------------------------- hooks

    @property
    def sentinel(self):
        return self._sentinel

    @sentinel.setter
    def sentinel(self, value) -> None:
        # every lane's loop drives window closes (maybe_tick elects one
        # closer without blocking, so concurrent lanes are its design)
        self._sentinel = value
        for e in self.lanes:
            e.sentinel = value

    @property
    def on_pool_pressure(self):
        return self.lanes[0].on_pool_pressure

    @on_pool_pressure.setter
    def on_pool_pressure(self, hook) -> None:
        for e in self.lanes:
            e.on_pool_pressure = hook

    def supports_rolling(self) -> bool:
        """Page custody cannot span lanes."""
        return False

    def pool_epoch(self) -> int:
        return sum(e.pool_epoch() for e in self.lanes)

    # -------------------------------------------------------------- info

    def stats(self) -> Dict[str, Any]:
        per = [e.stats() for e in self.lanes]
        out = {
            "active_slots": sum(p["active_slots"] for p in per),
            "max_batch": self.max_batch,
            "queued": sum(p["queued"] for p in per),
            "total_requests": sum(p["total_requests"] for p in per),
            "total_generated": sum(p["total_generated"] for p in per),
            "tokens_per_sec_60s": per[0]["tokens_per_sec_60s"],
            "latencies": per[0]["latencies"],
            "lanes": len(per),
            "queued_by_lane": [p["queued"] for p in per],
            "active_by_lane": [p["active_slots"] for p in per],
            "ragged_prefill": bool(self.lanes[0]._ragged),
        }
        if self._prefix is not None:
            out["prefix_cache"] = self._prefix.stats()
        if self.fleet is not None:
            out["fleet"] = self.fleet.stats()
        if self.lane_weights is not None:
            out["lane_weights"] = list(self.lane_weights)
        if self.supervisor is not None:
            out["lane_states"] = [
                lane["state"] for lane in self.supervisor.status()["lanes"]]
        return out

    def attach_supervisor(self, **kwargs: Any) -> Any:
        """Build, attach and start a ``LaneSupervisor`` over the group
        (once); the serving layer calls it unless ``SWARMDB_SUPERVISE=0``."""
        if self.supervisor is None:
            from ..backend.supervisor import LaneSupervisor

            self.supervisor = LaneSupervisor(self, **kwargs).start()
        return self.supervisor


def build_lane_group(
    model_name_or_cfg: Any,
    devices: Sequence[DeviceLike],
    *,
    max_batch: int,
    max_seq: int = 1024,
    seed: int = 0,
    page_size: int = 16,
    kv_pool_tokens: Optional[int] = None,
    metrics: Optional[MetricsRegistry] = None,
    decode_chunk: int = 8,
    prefill_batch: Optional[int] = None,
    flight_dir: Optional[str] = None,
    kv_dtype: Optional[torch.dtype] = None,
    params: Optional[Dict[str, Any]] = None,
) -> ShardLaneGroup:
    """One paged engine per entry of ``devices`` (a device may repeat:
    lanes sharing it share one weights dict), ``max_batch / n`` slots
    each. Weights are random from ``seed`` (one init per distinct
    device), or ``params`` (the port's dict layout), copied to each other
    device. Each lane's pool covers its slots' full windows plus its
    share of the prefix budget (``SWARMDB_PREFIX_TOKENS``, default one
    window per slot), or ``kv_pool_tokens / n``. With more than one lane,
    lane d's slot keys come from seed ``seed + 7919 * (d + 1)``, the JAX
    package's rows, so sampling does not correlate across lanes."""
    from ..backend.sampling import make_slot_keys
    from ..backend.service import build_backend_engine
    from ..models import llama, mixtral
    from ..models.configs import ModelConfig, get_config
    from ..ops.paged_kv import pages_per_slot

    cfg = (model_name_or_cfg if isinstance(model_name_or_cfg, ModelConfig)
           else get_config(model_name_or_cfg))
    devs = [resolve_device(d) for d in devices]
    n = len(devs)
    if n == 0:
        raise ValueError("a lane group needs at least one device")
    if max_batch % n:
        raise ValueError(f"max_batch {max_batch} must divide the lane "
                         f"count {n} (slot-to-lane affinity)")
    slots_per = max_batch // n
    metrics = metrics or MetricsRegistry()
    if kv_pool_tokens is None:
        # a lane's cache is private (a conversation hits its own lane's
        # pages only), so each lane gets a whole window per slot of prefix
        # budget, twice the single pool's default share
        maxp = pages_per_slot(max_seq, page_size)
        lane_pool = slots_per * maxp * page_size + int(os.environ.get(
            "SWARMDB_PREFIX_TOKENS", n * slots_per * max_seq)) // n
    else:
        lane_pool = max(1, kv_pool_tokens // n)
    mod = mixtral if cfg.is_moe else llama
    weights: Dict[torch.device, Dict[str, Any]] = {}
    lanes: List[Engine] = []
    for d, dev in enumerate(devs):
        if dev not in weights:
            weights[dev] = (_params_on(params, dev) if params is not None
                            else mod.init_params(cfg, seed=seed, device=dev))
        eng, _tok = build_backend_engine(
            cfg, max_batch=slots_per, max_seq=max_seq, seed=seed,
            decode_chunk=decode_chunk, paged=True, page_size=page_size,
            kv_pool_tokens=lane_pool, prefill_batch=prefill_batch,
            metrics=metrics, device=dev, kv_dtype=kv_dtype,
            params=weights[dev], flight_dir=flight_dir)
        if n > 1:
            eng._default_keys_np = make_slot_keys(seed + 7919 * (d + 1),
                                                  slots_per)
            eng._base_keys_np = eng._default_keys_np.copy()
        lanes.append(eng)
    info = LaneGroupInfo(cfg=cfg, devices=devs, data_size=n)
    return ShardLaneGroup(lanes, info, flight_dir=flight_dir)


def _params_on(params: Dict[str, Any], dev: torch.device) -> Dict[str, Any]:
    """``params`` on ``dev``: the same dict when it is there already."""
    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        return x.to(dev) if isinstance(x, torch.Tensor) else x

    return params if params["embed"].device == dev else move(params)
