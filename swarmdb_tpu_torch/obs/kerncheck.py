"""Runtime kernel sanitizer: the card's counterpart of
``swarmdb_tpu/obs/kerncheck.py``.

The JAX package shadows every concrete Pallas call through a host-side
grid interpreter over bounds-checked refs. The port's kernels are CUDA,
which has no interpreter; when ``SWARMDB_KERNCHECK=1`` the same checks
take these forms:

- a **bounds-checked build** of the CUDA kernels (``ops/build.py``'s
  ``-kc`` variant, ``-DSWARM_KERNCHECK`` in ``csrc/attn_common.cuh``):
  every clamp of the plain build (page ids into ``[0, P)``, table columns
  into ``maxp``, a ragged row's end into the stream, a decode walk into
  the cache's coverage) still clamps, so a launch stays memory-safe, and
  records an ``oob-block`` violation naming the entry point, the block
  (x, y, z), its cluster rank, the raw index and its bound; on eager
  launches every output store stamps a writer map, and a second block
  writing one (row, head) entry is a ``write-race`` naming both blocks
  (the device face of the JAX interpreter's per-grid-step diff). The
  record reaches the host at waits the caller already makes
  (``ops.attention_cuda.kerncheck_poll``);
- **checked dispatchers** (``checked_ragged_prefill_dispatch``,
  ``checked_paged_attention_dispatch``), which the engine's forwards get
  when the engine is built (``ops.layers.attention_dispatchers``). On
  every eager call no wider than ``SWARMDB_KERNCHECK_MAX_W`` (a call
  made while a CUDA graph is captured is skipped, the counterpart of the
  JAX package's tracer skip): a **host descriptor audit** before the
  launch (page ids in ``[0, P)``; each row's ``[start, start + len)``
  inside the stream and disjoint from every other row's; prefix lengths
  within ``maxp * ps``; decode lengths within the coverage), an **output
  canary** (the output is pre-filled with ``CANARY`` over its live rows;
  a live row still holding it is a ``short-write``), and **parity**
  against the plain PyTorch version at ``parity_tol`` (relative to a
  row's largest value where that exceeds 1);
- the ragged **write audit** (``check_wave_descriptors``, which the
  engine runs over every wave, and ``checked_paged_write_ragged``, which
  replays the scatter against the pool);
- the **differential soups** (``differential_ragged_prefill``,
  ``differential_paged_decode``): the JAX package's random descriptor
  mixes (mixed lengths, page-boundary crossings, empty rows, split rows)
  through the kernels against their plain versions.

Violations are recorded once, written to attached flight recorders as
``kerncheck.violation`` instants, dumped immediately to
``kerncheck_<node>.json`` in ``SWARMDB_FLIGHT_DIR``, surfaced at ``GET
/admin/kerncheck`` and exported on ``/metrics`` as
``swarmdb_kernel_violations_total``: the JAX package's contract and report
schema (``rule`` names the JAX package's static rule a kind is the runtime
face of).

With the flag off (default) the checked factories return the functions
they were given, exactly (identity pinned by tests/test_torch_kerncheck.py),
and this module is never imported on the serving path.

The registry's mutex is a *leaf* lock: no user code runs under it.
"""

from __future__ import annotations

import atexit
import functools
import json
import logging
import os
import re
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("swarmdb_tpu_torch.obs")

__all__ = ["enabled", "registry", "KernCheckRegistry", "CANARY",
           "parity_tol", "check_wave_descriptors", "audit_ragged",
           "audit_decode", "random_ragged_case", "random_decode_case",
           "differential_ragged_prefill", "differential_paged_decode",
           "checked_ragged_prefill_dispatch",
           "checked_paged_attention_dispatch",
           "checked_paged_write_ragged", "record_device_hit"]

#: float canary pre-filling checked outputs: exactly representable in bf16
#: and f32 and far outside attention's output range (softmax-weighted
#: averages of unit-scale values), so surviving canary == never written
CANARY = -16384.0

# parity tolerance between a kernel and its plain version: both
# accumulate in fp32 but tile reductions differently; bf16 outputs round
# to ~1e-2
_PARITY_TOL = 2e-2

# int8 pools: the plain version dequantizes after the gather, the kernel
# per tile (same values, another multiplication order), and every scale
# product rounds through bf16 once more
_PARITY_TOL_INT8 = 6e-2


def parity_tol(dtype_name: Optional[str] = None) -> float:
    """Kernel-vs-plain tolerance for the ACTIVE pool dtype
    (``SWARMDB_KV_DTYPE``); pass ``dtype_name`` to override."""
    if dtype_name is None:
        from ..ops.paged_kv import kv_dtype_name

        try:
            dtype_name = kv_dtype_name()
        except ValueError:
            dtype_name = "bf16"
    return _PARITY_TOL_INT8 if dtype_name == "int8" else _PARITY_TOL


def enabled() -> bool:
    return os.environ.get("SWARMDB_KERNCHECK", "0") not in ("", "0")


def _max_shadow_width() -> int:
    """Checked dispatches copy descriptors to the host and run the plain
    version beside the kernel: bound the packed width they chase so a
    production-sized wave does not stall serving."""
    try:
        return int(os.environ.get("SWARMDB_KERNCHECK_MAX_W", "512"))
    except ValueError:
        return 512


def _short_stack(skip: int = 3, limit: int = 5) -> List[str]:
    out = []
    for fr in reversed(traceback.extract_stack()[:-skip]):
        if fr.filename.endswith(("kerncheck.py",)):
            continue
        out.append(f"{os.path.basename(fr.filename)}:{fr.lineno} "
                   f"{fr.name}")
        if len(out) >= limit:
            break
    return out


# violation kind -> the JAX package's static rule it is the runtime face of
_KIND_RULE = {
    "oob-block": "SWL901",
    "oob-ref": "SWL901",
    "write-race": "SWL902",
    "short-write": "SWL905",
}


class KernCheckRegistry:
    """Process-global kernel-sanitizer state (violations + check tallies)."""

    def __init__(self) -> None:
        # leaf lock: no user code runs under it
        self._mu = threading.Lock()
        self._violations: List[Dict[str, Any]] = []
        self._violation_keys: set = set()
        self._checks: Dict[str, int] = {}
        self._flights: List[Any] = []
        self._atexit_armed = False

    # ------------------------------------------------------------ wiring

    def attach_flight(self, recorder: Any) -> None:
        with self._mu:
            if recorder not in self._flights:
                self._flights.append(recorder)
            if not self._atexit_armed:
                self._atexit_armed = True
                atexit.register(self._atexit_dump)

    def note_check(self, check: str) -> None:
        """Tally one checked pass (coverage evidence for the report)."""
        with self._mu:
            self._checks[check] = self._checks.get(check, 0) + 1

    # ----------------------------------------------------------- events

    def record(self, kind: str, kernel: str, message: str,
               where: Optional[Dict[str, Any]] = None) -> None:
        """Record one violation (dedup by kind/kernel/site) and emit the
        side effects (flight instants, immediate dump) OUTSIDE the
        mutex."""
        key = (kind, kernel, str(sorted((where or {}).items()))[:160])
        with self._mu:
            if key in self._violation_keys:
                return
            self._violation_keys.add(key)
            v = {
                "kind": kind,
                "rule": _KIND_RULE.get(kind),
                "kernel": kernel,
                "message": message,
                "where": dict(where or {}),
                "thread": threading.current_thread().name,
                "stack": _short_stack(),
                "detected_at": time.time(),
            }
            self._violations.append(v)
        self._emit(v)

    def _emit(self, violation: Dict[str, Any]) -> None:
        logger.warning("kerncheck: %s violation in %s: %s",
                       violation["kind"], violation["kernel"],
                       violation["message"])
        # swarmlint: disable=SWL303 -- benign racy snapshot of an append-only list: flight rings take their own locks
        for fl in list(self._flights):
            try:
                fl.record_event({
                    "kind": "kerncheck.violation",
                    "ts": time.time(),
                    "violation_kind": violation["kind"],
                    "kernel": violation["kernel"],
                    "rule": violation["rule"],
                })
            except Exception:
                pass
        directory = os.environ.get("SWARMDB_FLIGHT_DIR")
        if directory:
            try:
                self.dump_to(directory)
            except Exception:
                logger.exception("kerncheck dump failed")

    # ------------------------------------------------------------ reading

    def _node_identity(self) -> str:
        raw = (os.environ.get("SWARMDB_NODE_ID") or f"p{os.getpid()}")
        return re.sub(r"[^A-Za-z0-9_.-]", "_", raw)

    def violations(self) -> List[Dict[str, Any]]:
        with self._mu:
            return [dict(v) for v in self._violations]

    def report(self) -> Dict[str, Any]:
        with self._mu:
            violations = [dict(v) for v in self._violations]
            checks = dict(self._checks)
        return {
            "enabled": enabled(),
            "node": self._node_identity(),
            "checks": checks,
            "violations": violations,
            "generated_at": time.time(),
        }

    def prometheus_lines(self, prefix: str = "swarmdb_") -> List[str]:
        with self._mu:
            n = len(self._violations)
            checks = dict(self._checks)
        lines = [f"# TYPE {prefix}kernel_violations_total counter",
                 f"{prefix}kernel_violations_total {n}",
                 f"# TYPE {prefix}kernel_checks_total counter"]
        for k in sorted(checks):
            lines.append(
                f'{prefix}kernel_checks_total{{check="{k}"}} {checks[k]}')
        return lines

    def dump_to(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory, f"kerncheck_{self._node_identity()}.json")
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.report(), f, indent=1)
        os.replace(tmp, path)
        return path

    def _atexit_dump(self) -> None:
        directory = os.environ.get("SWARMDB_FLIGHT_DIR")
        if not directory:
            return
        try:
            self.dump_to(directory)
        except Exception:  # pragma: no cover - shutdown best-effort
            pass

    def reset(self) -> None:
        """Tests only -- forget violations, tallies, and flights."""
        with self._mu:
            self._violations.clear()
            self._violation_keys.clear()
            self._checks.clear()
            self._flights.clear()


_REGISTRY = KernCheckRegistry()


def registry() -> KernCheckRegistry:
    return _REGISTRY


# ------------------------------------------------- the checked build's hits

def record_device_hit(hit: Dict[str, Any]) -> None:
    """One slot of a device's violation record (``ops.attention_cuda.
    kerncheck_poll``: the record's fields by name, ``kind``, ``kernel``)
    as a registry violation."""
    from ..ops.attention_cuda import KC_SITES

    block = [hit["bx"], hit["by"], hit["bz"]]
    site = KC_SITES.get(hit["site"], str(hit["site"]))
    rank = f" (cluster rank {hit['rank']})" if hit["rank"] >= 0 else ""
    if hit["kind"] == "write-race":
        other = [hit["ox"], hit["oy"], hit["oz"]]
        registry().record(
            "write-race", hit["kernel"],
            f"output row {hit['raw']} head {hit['bound']} written by block "
            f"{tuple(other)} and by block {tuple(block)}{rank} "
            f"({hit['hits']} such store(s)) -- two blocks racing on one "
            f"output row",
            {"row": hit["raw"], "head": hit["bound"],
             "blocks": [other, block]})
        return
    registry().record(
        "oob-block", hit["kernel"],
        f"block {tuple(block)}{rank} read {site} {hit['raw']} outside "
        f"[0, {hit['bound']}) ({hit['hits']} hit(s)); the checked build "
        f"clamped it, as the plain build does silently",
        {"block": block, "rank": hit["rank"], "site": site,
         "index": hit["raw"], "bound": hit["bound"]})


# -------------------------------------------------- host descriptor audits

def check_wave_descriptors(tok_row, tok_pos, row_tables, num_pages: int,
                           page_size: int) -> int:
    """Host-side sanity over a ragged wave's WRITE descriptors (the
    ``paged_write_ragged`` operands the engine builds): live tokens must
    target in-range, non-trash pages, and no two live tokens may land on
    the same (page, offset) cell. Returns the number of violations."""
    tok_row = np.asarray(tok_row)
    tok_pos = np.asarray(tok_pos)
    row_tables = np.asarray(row_tables)
    R, maxp = row_tables.shape
    registry().note_check("wave-descriptors")
    before = len(registry().violations())
    live = ((tok_row >= 0) & (tok_row < R)
            & (tok_pos >= 0) & (tok_pos < maxp * page_size))
    if live.any():
        rows = tok_row[live]
        cols = tok_pos[live] // page_size
        pages = row_tables[rows, cols]
        offs = tok_pos[live] % page_size
        oob = (pages < 0) | (pages >= num_pages)
        if oob.any():
            which = np.nonzero(oob)[0][:4]
            registry().record(
                "oob-block", "paged_write_ragged",
                f"live token(s) at stream offset(s) "
                f"{[int(np.nonzero(live)[0][i]) for i in which]} target "
                f"page id(s) {[int(pages[i]) for i in which]} outside "
                f"the pool [0,{num_pages}) -- the scatter would write "
                f"out of bounds",
                {"pages": [int(pages[i]) for i in which]})
        trash = (pages == 0) & ~oob
        if trash.any():
            which = np.nonzero(trash)[0][:4]
            registry().record(
                "oob-block", "paged_write_ragged",
                f"live token(s) target trash page 0 (stream offset(s) "
                f"{[int(np.nonzero(live)[0][i]) for i in which]}) -- a "
                f"row table handed the write path an unallocated page",
                {"rows": [int(rows[i]) for i in which]})
        cell = pages.astype(np.int64) * page_size + offs
        ok = ~oob
        uniq, counts = np.unique(cell[ok], return_counts=True)
        dup = uniq[counts > 1]
        if dup.size:
            registry().record(
                "write-race", "paged_write_ragged",
                f"{int(dup.size)} (page, offset) cell(s) written by "
                f"more than one live token (first: page "
                f"{int(dup[0] // page_size)} offset "
                f"{int(dup[0] % page_size)}) -- colliding descriptors "
                f"would leave the pool dependent on scatter order",
                {"cells": [int(d) for d in dup[:4]]})
    return len(registry().violations()) - before


def _audit_pages(kernel: str, tables: np.ndarray, rows: np.ndarray,
                 used: np.ndarray, num_pages: int) -> None:
    """The page ids row ``rows[i]`` reads (its first ``used[i]`` table
    columns) must lie in ``[0, P)``."""
    for r, n in zip(rows, used):
        ids = tables[r, :n]
        bad = (ids < 0) | (ids >= num_pages)
        if bad.any():
            col = int(np.nonzero(bad)[0][0])
            registry().record(
                "oob-block", kernel,
                f"row {int(r)} reads page id {int(ids[col])} (table column "
                f"{col}) outside the pool [0,{num_pages}) -- the kernel "
                f"would clamp it and read another page",
                {"row": int(r), "column": col, "page": int(ids[col])})


def audit_ragged(kernel: str, tables: np.ndarray, starts: np.ndarray,
                 lens: np.ndarray, plens: np.ndarray, W: int,
                 num_pages: int, page_size: int) -> int:
    """Host audit of a ragged prefill launch's descriptors: each live
    row's ``[start, start + len)`` inside the stream and disjoint from
    every other live row's, its prefix within the table's coverage, and
    the page ids it reads in ``[0, P)``. Returns the violations
    recorded."""
    before = len(registry().violations())
    R, maxp = tables.shape
    cov = maxp * page_size
    live = np.nonzero(lens > 0)[0]
    for r in live:
        s, e = int(starts[r]), int(starts[r]) + int(lens[r])
        if s < 0 or e > W:
            registry().record(
                "oob-block", kernel,
                f"row {int(r)} spans stream [{s},{e}) outside [0,{W})",
                {"row": int(r), "start": s, "len": int(lens[r])})
        if plens[r] > cov or plens[r] < 0:
            registry().record(
                "oob-block", kernel,
                f"row {int(r)} has a prefix of {int(plens[r])} tokens, "
                f"outside its table's coverage of {cov}",
                {"row": int(r), "prefix_len": int(plens[r])})
    order = live[np.argsort(starts[live], kind="stable")]
    for a, b in zip(order[:-1], order[1:]):
        if starts[b] < starts[a] + lens[a]:
            registry().record(
                "write-race", kernel,
                f"rows {int(a)} [{int(starts[a])},"
                f"{int(starts[a] + lens[a])}) and {int(b)} "
                f"[{int(starts[b])},{int(starts[b] + lens[b])}) overlap "
                f"in the stream -- both rows' blocks would write the "
                f"shared positions",
                {"rows": [int(a), int(b)]})
    used = np.minimum(-(-np.clip(plens[live], 0, cov) // page_size), maxp)
    _audit_pages(kernel, tables, live, used, num_pages)
    return len(registry().violations()) - before


def audit_decode(kernel: str, table: np.ndarray, lengths: np.ndarray,
                 num_pages: int, page_size: int) -> int:
    """Host audit of a paged decode launch: each slot's length within its
    table's coverage and the page ids it reads in ``[0, P)``."""
    before = len(registry().violations())
    B, maxp = table.shape
    cov = maxp * page_size
    for b in np.nonzero(lengths > cov)[0]:
        registry().record(
            "oob-block", kernel,
            f"slot {int(b)} decodes at length {int(lengths[b])}, past its "
            f"table's coverage of {cov}",
            {"slot": int(b), "length": int(lengths[b])})
    live = np.nonzero(lengths > 0)[0]
    used = np.minimum(-(-np.clip(lengths[live], 0, cov) // page_size), maxp)
    _audit_pages(kernel, table, live, used, num_pages)
    return len(registry().violations()) - before


def _coverage_rows(kernel: str, out: torch.Tensor, starts: np.ndarray,
                   lens: np.ndarray) -> None:
    """Output coverage: a descriptor-live row still holding the canary
    was never written (the short-write)."""
    canary = (out == CANARY).reshape(out.shape[0], -1).any(dim=1).cpu()
    canary = canary.numpy()
    for r in range(len(lens)):
        if lens[r] <= 0:
            continue
        s, e = int(starts[r]), int(starts[r]) + int(lens[r])
        n = int(canary[s:e].sum())
        if n:
            registry().record(
                "short-write", kernel,
                f"row {r} (stream [{s},{e})) still carries the canary in "
                f"{n} position(s) -- the kernel finished without writing "
                f"output this row's descriptor declares live",
                {"row": r, "start": s, "len": int(lens[r])})


def _parity(kernel: str, got: torch.Tensor, want: torch.Tensor,
            starts: np.ndarray, lens: np.ndarray,
            tol: float = _PARITY_TOL) -> float:
    """Compare a kernel's output with its plain version on descriptor-live
    rows; a gap above ``tol`` is a ``parity`` violation. The gap is taken
    relative to the row's largest plain value where that exceeds 1: a
    served model's attention outputs reach magnitudes where one bf16 step
    is 2^-5 (the kernels phase's unit-scale inputs stay below 1, where the
    gap is absolute)."""
    worst = 0.0
    for r in range(len(lens)):
        if lens[r] <= 0:
            continue
        s, e = int(starts[r]), int(starts[r]) + int(lens[r])
        w = want[s:e].float()
        d = (got[s:e].float() - w).abs().max() / w.abs().max().clamp(min=1)
        worst = max(worst, float(d))
    if worst > tol:
        registry().record(
            "parity", kernel,
            f"kernel vs plain version disagree by {worst:.3e} (> {tol}, "
            f"relative to values above 1) on live rows -- the kernel and "
            f"the plain math diverged",
            {"max_err": worst})
    return worst


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _poll(device: torch.device) -> None:
    if device.type == "cuda":
        from ..ops.attention_cuda import kerncheck_poll

        kerncheck_poll(device)


# ----------------------------------------------------- checked factories

def checked_ragged_prefill_dispatch(fn: Callable) -> Callable:
    """Wrap ``ops.layers.ragged_prefill_dispatch`` (or a stand-in launch
    of its signature) with the descriptor audit, the output canary and
    parity against the plain version. Flag off: returns ``fn`` itself."""
    if not enabled():
        return fn

    @functools.wraps(fn)
    def wrapper(q, sfx_k, sfx_v, k_pages, v_pages, row_tables, starts,
                lens, prefix_lens, *, window=None, out=None):
        from ..ops.attention_cuda import ragged_prefill_plain
        from ..ops.paged_kv import pool_data

        if _capturing() or q.shape[0] > _max_shadow_width():
            return fn(q, sfx_k, sfx_v, k_pages, v_pages, row_tables, starts,
                      lens, prefix_lens, window=window, out=out)
        name = "ragged_paged_prefill_attention"
        registry().note_check("shadow.ragged-prefill")
        W = q.shape[0]
        P, ps = pool_data(k_pages).shape[:2]
        tables = row_tables.cpu().numpy()
        st, ln = starts.cpu().numpy(), lens.cpu().numpy()
        pl = prefix_lens.cpu().numpy()
        clean = audit_ragged(name, tables, st, ln, pl, W, P, ps) == 0
        buf = torch.zeros_like(q) if out is None else out
        if clean:
            for r in np.nonzero(ln > 0)[0]:
                buf[int(st[r]):int(st[r] + ln[r])] = CANARY
        res = fn(q, sfx_k, sfx_v, k_pages, v_pages, row_tables, starts,
                 lens, prefix_lens, window=window, out=buf)
        if clean:
            _coverage_rows(name, res, st, ln)
            want = ragged_prefill_plain(q, sfx_k, sfx_v, k_pages, v_pages,
                                        row_tables, starts, lens,
                                        prefix_lens, window=window)
            _parity(name, res, want, st, ln, tol=parity_tol())
        _poll(q.device)
        return res

    return wrapper


def checked_paged_attention_dispatch(fn: Callable) -> Callable:
    """Wrap ``ops.layers.paged_attention_dispatch`` (single-step paged
    decode) the same way; flag off returns ``fn`` itself."""
    if not enabled():
        return fn

    @functools.wraps(fn)
    def wrapper(q, k_pages, v_pages, page_table, q_positions, *,
                window=None, out=None):
        from ..ops.attention_cuda import paged_decode_plain
        from ..ops.paged_kv import pool_data

        if _capturing() or q.shape[0] > _max_shadow_width():
            return fn(q, k_pages, v_pages, page_table, q_positions,
                      window=window, out=out)
        name = "paged_decode_gqa_attention"
        registry().note_check("shadow.paged-decode")
        B = q.shape[0]
        P, ps = pool_data(k_pages).shape[:2]
        lengths = (q_positions[:, 0] + 1).to(torch.int32)
        len_np = lengths.cpu().numpy()
        clean = audit_decode(name, page_table.cpu().numpy(), len_np, P,
                             ps) == 0
        buf = (torch.full_like(q[:, 0], CANARY) if out is None else out)
        res = fn(q, k_pages, v_pages, page_table, q_positions,
                 window=window, out=buf)
        if clean:
            live = (len_np > 0).astype(np.int32)
            rows = np.arange(B, dtype=np.int32)
            _coverage_rows(name, res[:, 0], rows, live)
            want = paged_decode_plain(q[:, 0], k_pages, v_pages, page_table,
                                      lengths, window=window)
            _parity(name, res[:, 0], want, rows, live, tol=parity_tol())
        _poll(q.device)
        return res

    return wrapper


def checked_paged_write_ragged(fn: Callable) -> Callable:
    """Wrap ``ops.paged_kv.paged_write_ragged`` with the descriptor audit
    and a replay of the scatter against the pages it touches; flag off
    returns ``fn`` itself. The write is in place, so the touched pages
    are read before it."""
    if not enabled():
        return fn

    @functools.wraps(fn)
    def wrapper(k_pages, v_pages, sfx_k, sfx_v, tok_row, tok_pos,
                row_tables):
        from ..ops.paged_kv import is_quantized, pool_data

        if _capturing():
            return fn(k_pages, v_pages, sfx_k, sfx_v, tok_row, tok_pos,
                      row_tables)
        registry().note_check("shadow.paged-write-ragged")
        data = pool_data(k_pages)
        tr, tp = tok_row.cpu().numpy(), tok_pos.cpu().numpy()
        tables = row_tables.cpu().numpy()
        n = check_wave_descriptors(tr, tp, tables, data.shape[1],
                                   data.shape[2])
        replay = n == 0 and tr.shape[0] <= _max_shadow_width()
        if replay:
            R, maxp = tables.shape
            ps = data.shape[2]
            live = (tr >= 0) & (tr < R) & (tp >= 0) & (tp < maxp * ps)
            t_idx = np.nonzero(live)[0]
            page = tables[tr[live], tp[live] // ps].astype(np.int64)
            off = (tp[live] % ps).astype(np.int64)
            before = None
            if not is_quantized(k_pages) and t_idx.size:
                before = data.index_select(
                    1, torch.as_tensor(np.unique(page), device=data.device))
        out = fn(k_pages, v_pages, sfx_k, sfx_v, tok_row, tok_pos,
                 row_tables)
        if replay and t_idx.size:
            if is_quantized(k_pages):
                _replay_write_parity_quant(k_pages, sfx_k, t_idx, page, off)
            else:
                _replay_write_parity(k_pages, before, sfx_k, t_idx, page,
                                     off)
        return out

    return wrapper


def _replay_write_parity(k_pages, before, sfx_k, t_idx, page, off) -> None:
    """Replay the ragged scatter over the live tokens' pages (their state
    before the write; trash page 0, where padding lands in any order, is
    never a live token's) and compare the K result there."""
    dev = k_pages.device
    pages = np.unique(page)
    slot = {int(p): i for i, p in enumerate(pages)}
    want = before.clone()
    pi = torch.as_tensor([slot[int(p)] for p in page], device=dev)
    want[:, pi, torch.as_tensor(off, device=dev)] = sfx_k[
        :, torch.as_tensor(t_idx, device=dev)].to(want.dtype)
    got = k_pages.index_select(1, torch.as_tensor(pages, device=dev))
    ndiff = int((got.float() != want.float()).sum())
    if ndiff:
        registry().record(
            "parity", "paged_write_ragged",
            f"scatter result differs from the per-token replay in "
            f"{ndiff} element(s) -- positional write math diverged",
            {"ndiff": ndiff})


def _replay_write_parity_quant(k_pages, sfx_k, t_idx, page, off) -> None:
    """Positional check for the QUANTIZED ragged write: dequantize each
    live token's landing slot from the written pool and compare with the
    suffix value within half a scale step (a token scattered to the wrong
    (page, offset) misses its value by far more)."""
    dev = k_pages.data.device
    pg = torch.as_tensor(page, device=dev)
    of = torch.as_tensor(off, device=dev)
    s = k_pages.scale[:, pg]                             # [L, n, Hkv]
    deq = k_pages.data[:, pg, of].float() * s[..., None]
    err = (deq - sfx_k[:, torch.as_tensor(t_idx, device=dev)].float()).abs()
    worst = float((err - (0.5 * s[..., None] + 1e-6)).max())
    if worst > 0.0:
        registry().record(
            "parity", "paged_write_ragged",
            f"quantized scatter: a live token's dequantized slot misses "
            f"its suffix value by {worst:.3e} beyond the half-step "
            f"rounding budget -- positional write math or scale "
            f"bookkeeping diverged",
            {"max_over": worst})


# ------------------------------------------------- differential harness

def random_ragged_case(rng: np.random.Generator, *, D: int = 16
                       ) -> Dict[str, np.ndarray]:
    """One randomized ragged-prefill scenario, the JAX package's
    ``_random_ragged_case`` (mixed row lengths, page-boundary-crossing
    prefixes, empty rows, a split row with a mid-page prefix) at head dim
    ``D`` (16, the narrowest the kernels are built for). numpy f32
    arrays: q [W, Hq, D], sfx_k / sfx_v [W, Hkv, D], k_pages / v_pages [P,
    ps, Hkv, D], tables [R, maxp], starts / lens / plens [R], tok_row
    [W]."""
    Hkv, G, ps, maxp = 2, 2, 4, 3
    Hq = Hkv * G
    R = 4
    P = 2 + R * maxp
    lens = np.zeros(R, np.int32)
    plens = np.zeros(R, np.int32)
    live = rng.permutation(R)[: int(rng.integers(2, R + 1))]
    for r in live:
        lens[r] = int(rng.integers(1, 7))
        # mix: fresh rows, page-aligned prefixes, mid-page splits
        plens[r] = int(rng.choice([0, ps, ps + 1, 2 * ps - 1]))
        plens[r] = min(plens[r], maxp * ps - lens[r])
    starts = np.zeros(R, np.int32)
    acc = 0
    for r in range(R):
        if lens[r]:
            starts[r] = acc
            acc += int(lens[r])
    W = max(8, -(-acc // 8) * 8)
    tables = np.zeros((R, maxp), np.int32)
    free = list(range(1, P))
    rng.shuffle(free)
    for r in range(R):
        need = max(1, -(-int(plens[r] + lens[r]) // ps))
        for c in range(need):
            tables[r, c] = free.pop()
    tok_row = np.full(W, R, np.int32)
    for r in range(R):
        if lens[r]:
            tok_row[starts[r]:starts[r] + lens[r]] = r
    f32 = np.float32
    return {
        "q": rng.standard_normal((W, Hq, D)).astype(f32),
        "sfx_k": rng.standard_normal((W, Hkv, D)).astype(f32),
        "sfx_v": rng.standard_normal((W, Hkv, D)).astype(f32),
        "k_pages": rng.standard_normal((P, ps, Hkv, D)).astype(f32),
        "v_pages": rng.standard_normal((P, ps, Hkv, D)).astype(f32),
        "tables": tables, "starts": starts, "lens": lens, "plens": plens,
        "tok_row": tok_row,
    }


def random_decode_case(rng: np.random.Generator, *, D: int = 16
                       ) -> Dict[str, np.ndarray]:
    """One randomized paged-decode scenario, the JAX package's
    ``differential_paged_decode`` soup (lengths 0..coverage, empty slots
    included) at head dim ``D``: q [B, Hq, D], k_pages / v_pages [P, ps,
    Hkv, D], table [B, maxp], lengths [B]."""
    B, Hkv, G, ps, maxp = 4, 2, 2, 4, 3
    Hq = Hkv * G
    P = 1 + B * maxp
    lengths = rng.integers(0, maxp * ps + 1, B).astype(np.int32)
    table = np.zeros((B, maxp), np.int32)
    free = list(range(1, P))
    rng.shuffle(free)
    for b in range(B):
        for c in range(max(1, -(-int(lengths[b]) // ps))):
            table[b, c] = free.pop()
    f32 = np.float32
    return {
        "q": rng.standard_normal((B, Hq, D)).astype(f32),
        "k_pages": rng.standard_normal((P, ps, Hkv, D)).astype(f32),
        "v_pages": rng.standard_normal((P, ps, Hkv, D)).astype(f32),
        "table": table, "lengths": lengths,
    }


def _quantized(pages: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    from ..ops.paged_kv import _quantize_pages

    return _quantize_pages(pages)


def _mismatch(kernel: str, i: int, seed: int, err: float, tol: float,
              what: str) -> int:
    if err <= tol:
        return 0
    registry().record(
        "parity", kernel,
        f"differential round {i} (seed {seed}): kernel vs {what} disagree "
        f"by {err:.3e} (> {tol}) on live rows -- descriptor handling "
        f"diverged",
        {"round": i, "seed": seed, "max_err": err})
    return 1


def differential_ragged_prefill(seed: int = 0, rounds: int = 4,
                                tol: float = _PARITY_TOL,
                                quantized: bool = False,
                                device: Any = "cuda",
                                dtype: torch.dtype = torch.float32) -> int:
    """Randomized kernel-vs-plain parity of the ragged prefill over the
    JAX package's descriptor soups; a mismatch on any live token is a
    ``parity`` violation. ``quantized`` int8-quantizes the random pools
    and runs the int8 kernel; ``dtype`` is the query's and suffix's (and
    plain pools') type (bf16 runs the tensor-core body). Returns the
    number of mismatching rounds."""
    from ..ops.attention_cuda import (ragged_paged_prefill_attention,
                                      ragged_paged_prefill_attention_quant,
                                      ragged_prefill_plain)
    from ..ops.paged_kv import QuantPool

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    bad = 0
    for i in range(rounds):
        c = random_ragged_case(rng)
        t = {k: torch.as_tensor(v, device=dev) for k, v in c.items()}
        q, sk, sv = (t[k].to(dtype) for k in ("q", "sfx_k", "sfx_v"))
        desc = (t["tables"], t["starts"], t["lens"], t["plens"])
        if quantized:
            registry().note_check("differential.ragged-prefill.int8")
            kq, ks = _quantized(t["k_pages"])
            vq, vs = _quantized(t["v_pages"])
            got = ragged_paged_prefill_attention_quant(
                q, sk, sv, kq, ks, vq, vs, *desc)
            kp, vp = QuantPool(kq, ks), QuantPool(vq, vs)
        else:
            registry().note_check("differential.ragged-prefill")
            kp, vp = t["k_pages"].to(dtype), t["v_pages"].to(dtype)
            got = ragged_paged_prefill_attention(q, sk, sv, kp, vp, *desc)
        want = ragged_prefill_plain(q, sk, sv, kp, vp, *desc)
        live = torch.as_tensor(c["tok_row"] < c["tables"].shape[0],
                               device=dev)
        err = (float((got[live].float() - want[live].float()).abs().max())
               if bool(live.any()) else 0.0)
        bad += _mismatch("ragged_paged_prefill_attention", i, seed, err,
                         tol, "plain version")
        _poll(dev)
    return bad


def differential_paged_decode(seed: int = 0, rounds: int = 4,
                              tol: float = _PARITY_TOL,
                              quantized: bool = False,
                              device: Any = "cuda",
                              dtype: torch.dtype = torch.float32) -> int:
    """Randomized kernel-vs-plain parity of the decode kernels over the
    JAX package's paged-decode soup (mixed lengths incl. empty slots):
    per round the single-step and the two-segment paged kernels (int8
    ones when ``quantized``) and, over the soup gathered into dense lanes,
    the two dense kernels; the two-segment ones with the round's lengths
    as chunk starts and a 4-entry chunk buffer at a random step. Returns
    the number of mismatching rounds."""
    from ..ops import attention_cuda as ac
    from ..ops.paged_kv import QuantPool, paged_gather_kv

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    bad = 0
    for i in range(rounds):
        c = random_decode_case(rng)
        B, Hq, D = c["q"].shape
        Hkv = c["k_pages"].shape[2]
        Kc = 4
        step = int(rng.integers(0, Kc))
        ck_np = rng.standard_normal((B, Kc, Hkv, D)).astype(np.float32)
        cv_np = rng.standard_normal((B, Kc, Hkv, D)).astype(np.float32)
        q = torch.as_tensor(c["q"], device=dev).to(dtype)
        table = torch.as_tensor(c["table"], device=dev)
        lengths = torch.as_tensor(c["lengths"], device=dev)
        ck = torch.as_tensor(ck_np, device=dev).to(dtype)
        cv = torch.as_tensor(cv_np, device=dev).to(dtype)
        kp32 = torch.as_tensor(c["k_pages"], device=dev)
        vp32 = torch.as_tensor(c["v_pages"], device=dev)
        liveb = torch.as_tensor(c["lengths"] > 0, device=dev)
        alls = torch.ones(B, dtype=torch.bool, device=dev)
        pairs = []
        if quantized:
            registry().note_check("differential.paged-decode.int8")
            kq, ks = _quantized(kp32)
            vq, vs = _quantized(vp32)
            kp, vp = QuantPool(kq, ks), QuantPool(vq, vs)
            pairs.append(("paged_decode_gqa_attention_quant", liveb,
                          ac.paged_decode_gqa_attention_quant(
                              q, kq, ks, vq, vs, table, lengths),
                          ac.paged_decode_plain(q, kp, vp, table, lengths)))
            pairs.append(("paged_decode_gqa_attention_chunked_quant", alls,
                          ac.paged_decode_gqa_attention_chunked_quant(
                              q, kq, ks, vq, vs, table, ck, cv, lengths,
                              step),
                          ac.paged_decode_chunked_plain(
                              q, kp, vp, table, ck, cv, lengths, step)))
        else:
            registry().note_check("differential.paged-decode")
            kp, vp = kp32.to(dtype), vp32.to(dtype)
            pairs.append(("paged_decode_gqa_attention", liveb,
                          ac.paged_decode_gqa_attention(
                              q, kp, vp, table, lengths),
                          ac.paged_decode_plain(q, kp, vp, table, lengths)))
            pairs.append(("paged_decode_gqa_attention_chunked", alls,
                          ac.paged_decode_gqa_attention_chunked(
                              q, kp, vp, table, ck, cv, lengths, step),
                          ac.paged_decode_chunked_plain(
                              q, kp, vp, table, ck, cv, lengths, step)))
            lk, lv = (x.contiguous() for x in paged_gather_kv(kp, vp, table))
            pairs.append(("decode_gqa_attention", liveb,
                          ac.decode_gqa_attention(q, lk, lv, lengths),
                          ac.decode_plain(q, lk, lv, lengths)))
            pairs.append(("decode_gqa_attention_chunked", alls,
                          ac.decode_gqa_attention_chunked(
                              q, lk, lv, ck, cv, lengths, step),
                          ac.decode_chunked_plain(q, lk, lv, ck, cv,
                                                  lengths, step)))
        worst = 0.0
        kernel = pairs[0][0]
        for name, live, got, want in pairs:
            if not bool(live.any()):
                continue
            err = float((got[live].float() - want[live].float()).abs().max())
            if err > worst:
                worst, kernel = err, name
        bad += _mismatch(kernel, i, seed, worst, tol, "plain version")
        _poll(dev)
    return bad
