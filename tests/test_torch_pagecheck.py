"""The port's runtime page sanitizer against the JAX package's.

The same call sequences go through the JAX package's checked allocator
and prefix cache and through the port's (whose ``PageAllocator`` moves
custody inside other methods, so its checked subclass mirrors those):
the same violation kinds, pages and counts come out. The canary is held
in place in the port's pools (bf16 and int8) and agrees with the JAX
package's on the same rogue write. Then a tiny-debug engine serves clean
under the flag, its canary fires on a rogue write into a freed page, and
a flag-off engine has no hooks. Each fixture resets both registries.
"""

import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmdb_tpu.obs import pagecheck as jax_pagecheck
from swarmdb_tpu.ops import paged_kv as jax_kv
from swarmdb_tpu.ops import prefix_cache as jax_prefix
from swarmdb_tpu_torch.obs import pagecheck as torch_pagecheck
from swarmdb_tpu_torch.ops import paged_kv as torch_kv
from swarmdb_tpu_torch.ops import prefix_cache as torch_prefix

PKGS = {"jax": (jax_kv, jax_prefix, jax_pagecheck),
        "torch": (torch_kv, torch_prefix, torch_pagecheck)}


@pytest.fixture()
def pagecheck_on(monkeypatch, tmp_path):
    monkeypatch.setenv("SWARMDB_PAGECHECK", "1")
    monkeypatch.setenv("SWARMDB_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("SWARMDB_NODE_ID", "testnode")
    for *_, pc in PKGS.values():
        pc.registry().reset()
    yield PKGS
    for *_, pc in PKGS.values():
        pc.registry().reset()


def _kinds(pc):
    return [(v["kind"], sorted(v["pages"]))
            for v in pc.registry().violations()]


# ------------------------------------------------------------ sequences

def _double_free(kv, prefix, pc):
    alloc = kv.make_page_allocator(9, 4, 16, 2, label="dfree")
    taken = alloc.reserve(2)
    alloc.add_free(taken)
    alloc.add_free(taken)


def _cross_lane(kv, prefix, pc):
    lane_a = kv.make_page_allocator(9, 4, 16, 2, label="laneA")
    lane_b = kv.make_page_allocator(9, 4, 16, 2, label="laneB")
    lane_a.pagecheck.set_lane("lane0")
    lane_b.pagecheck.set_lane("lane1")
    assert lane_a.allocate(0, 2) is not None
    pages = lane_a.pages_for(0)
    lane_a.transfer_to_cache(0, pages)
    assert lane_a.allocate_with_prefix(1, pages, 1) is not None  # legit
    lane_b.allocate_with_prefix(0, pages, 1)     # replayed on lane B


def _epoch(kv, prefix, pc):
    alloc = kv.make_page_allocator(5, 4, 8, 2, label="epoch")
    assert alloc.allocate(0, 2) is not None
    alloc.mark_retired(0)
    alloc.release_taken(alloc.take_pending_frees())
    assert alloc.allocate(1, 2) is not None
    alloc.pagecheck.set_owner(1, "rid-new")
    alloc.pagecheck.validate_row(0)


def _pins(kv, prefix, pc):
    alloc = kv.make_page_allocator(9, 4, 16, 2, label="pins")
    lru = prefix.make_prefix_lru(9, 4, manage_free=False, pool=alloc)
    assert alloc.allocate(0, 2) is not None
    pages = alloc.pages_for(0)
    alloc.transfer_to_cache(0, pages)
    lru.pin(pages)
    alloc.add_free([pages[0]])
    lru.unpin([pages[1]])
    lru.unpin([pages[1]])


def _tiers(kv, prefix, pc):
    """Demote, reference the demoted pages, demote twice, promote into
    unreserved pages, then a clean promote."""
    alloc = kv.make_page_allocator(12, 4, 16, 2, label="tiers")
    assert alloc.allocate(0, 2) is not None
    pages = alloc.pages_for(0)
    alloc.transfer_to_cache(0, pages)
    alloc.pagecheck.on_demote(pages, "conv")
    alloc.allocate_with_prefix(1, pages, 1)      # use-after-demote
    alloc.pagecheck.on_demote(pages, "conv")     # double-demote
    alloc.add_free(pages)
    fresh = alloc.pages_for(1)
    alloc.pagecheck.on_promote(fresh, "conv")    # not reserved
    ids = alloc.reserve(2)
    alloc.pagecheck.on_promote(ids, "conv2")     # clean


def _churn(kv, prefix, pc):
    """A clean life cycle: allocate, retire, re-allocate, prefix custody,
    eviction back to the pool, a reset."""
    alloc = kv.make_page_allocator(9, 4, 16, 2, label="churn")
    lru = prefix.make_prefix_lru(9, 4, manage_free=False, pool=alloc)
    for slot in range(2):
        assert alloc.allocate(slot, 3) is not None
    p0 = alloc.pages_for(0)
    alloc.transfer_to_cache(0, p0[:2])
    lru.pin(p0[:2])
    lru.unpin(p0[:2])
    alloc.mark_retired(0)
    alloc.mark_retired(1)
    alloc.release_taken(alloc.take_pending_frees())
    alloc.add_free(p0[:2])
    assert alloc.allocate(0, 4) is not None
    alloc.pagecheck.validate_row(0)
    alloc.reset()


SEQUENCES = {"double-free": _double_free, "cross-lane": _cross_lane,
             "epoch": _epoch, "pins": _pins, "tiers": _tiers,
             "churn": _churn}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_same_sequence_same_violations(name, pagecheck_on):
    """One call sequence through both packages' checked classes: the same
    violation kinds and pages, in the same order, and the same shadow
    state counts per pool."""
    out = {}
    for pkg, (kv, prefix, pc) in PKGS.items():
        SEQUENCES[name](kv, prefix, pc)
        rep = pc.registry().report()
        out[pkg] = (_kinds(pc),
                    {p["pool"]: (p["states"], p["churn_allocated"],
                                 p["churn_freed"], p["lane"])
                     for p in rep["pools"]})
    assert out["torch"] == out["jax"]
    want = {"double-free": ["double-free"],
            "cross-lane": ["stale-reference"],
            "epoch": ["epoch-mismatch"],
            "pins": ["free-pinned", "unpin-unpinned"],
            "tiers": ["use-after-demote", "double-demote",
                      "promote-unreserved"],
            "churn": []}[name]
    assert [k for k, _ in out["torch"][0]] == want


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_factories_return_plain_types_when_off(pkg, monkeypatch):
    kv, prefix, _ = PKGS[pkg]
    monkeypatch.delenv("SWARMDB_PAGECHECK", raising=False)
    assert type(kv.make_page_allocator(8, 4, 16, 2)) is kv.PageAllocator
    assert type(prefix.make_prefix_lru(8, 4)) is prefix.PrefixLRU


def test_factories_return_checked_types_when_on(pagecheck_on):
    a = torch_kv.make_page_allocator(8, 4, 16, 2)
    assert type(a).__name__ == "CheckedPageAllocator"
    assert isinstance(a, torch_kv.PageAllocator)
    p = torch_prefix.make_prefix_lru(8, 4, manage_free=False, pool=a)
    assert type(p).__name__ == "CheckedPrefixLRU"
    assert isinstance(p, torch_prefix.PrefixLRU)
    assert p.pagecheck.pool_id == a.pagecheck.pool_id
    d = torch_prefix.make_prefix_lru(8, 4)
    assert d.pagecheck.pool_id != a.pagecheck.pool_id


def test_double_free_dump_and_metrics(pagecheck_on, tmp_path):
    _double_free(torch_kv, torch_prefix, torch_pagecheck)
    dump = json.loads((tmp_path / "pagecheck_testnode.json").read_text())
    assert dump["violations"][0]["kind"] == "double-free"
    assert any(p["pool"] == "dfree" for p in dump["pools"])
    text = "\n".join(torch_pagecheck.registry().prometheus_lines())
    assert "swarmdb_page_violations_total 1" in text
    assert 'swarmdb_page_state{state="trash"} 1' in text


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_canary_write_after_free_matches_jax(kind, pagecheck_on):
    """Freed pages poisoned in place; one rogue element written while
    they are free is found by both packages' canary check, on the same
    page; the port's fill keeps the pool's storage (captured graphs read
    fixed addresses)."""
    L, P, ps, H, D = 2, 9, 4, 1, 8
    rogue = {}
    for pkg, (kv, _prefix, _pc) in PKGS.items():
        alloc = kv.make_page_allocator(P, ps, 16, 2, label=f"canary-{pkg}")
        assert alloc.allocate(0, 3) is not None
        pages = alloc.pages_for(0)
        alloc.mark_retired(0)
        alloc.release_taken(alloc.take_pending_frees())
        if pkg == "jax":
            if kind == "int8":
                k = jax_kv.QuantPool(jnp.zeros((L, P, ps, H, D), jnp.int8),
                                     jnp.ones((L, P, H), jnp.float32))
                v = jax_kv.QuantPool(k.data, k.scale)
            else:
                k = jnp.zeros((L, P, ps, H, D), jnp.bfloat16)
                v = jnp.zeros_like(k)
            k, v = kv.canary_fill(k, v, pages)
            assert kv.canary_check(k, v, pages) == []
            if kind == "int8":
                k = jax_kv.QuantPool(k.data.at[1, pages[1], 2].set(5),
                                     k.scale)
            else:
                k = k.at[1, pages[1], 2].set(0.5)
        else:
            if kind == "int8":
                k = torch_kv.QuantPool(
                    torch.zeros((L, P, ps, H, D), dtype=torch.int8),
                    torch.ones((L, P, H)))
                v = torch_kv.QuantPool(torch.zeros_like(k.data),
                                       torch.ones((L, P, H)))
            else:
                k = torch.zeros((L, P, ps, H, D), dtype=torch.bfloat16)
                v = torch.zeros_like(k)
            ptr = torch_kv.pool_data(k).data_ptr()
            k2, v2 = kv.canary_fill(k, v, pages)
            assert k2 is k and torch_kv.pool_data(k).data_ptr() == ptr
            assert kv.canary_check(k, v, pages) == []
            torch_kv.pool_data(k)[1, pages[1], 2] = 5 if kind == "int8" \
                else 0.5
        alloc.pagecheck.mark_poisoned(pages)
        bad = kv.canary_check(k, v, alloc.pagecheck.poisoned_pages(pages))
        alloc.pagecheck.canary_violation(bad)
        rogue[pkg] = (bad, pages[1])
    assert rogue["torch"] == rogue["jax"]
    assert rogue["torch"][0] == [rogue["torch"][1]]
    kinds = {v["kind"] for v in torch_pagecheck.registry().violations()}
    assert kinds == {"canary"}


def test_int8_scale_canary(pagecheck_on):
    """A quantized pool's scale rows carry their own canary: a write that
    only recomputes a freed page's scale is caught."""
    k = torch_kv.QuantPool(torch.zeros((1, 5, 4, 1, 8), dtype=torch.int8),
                           torch.ones((1, 5, 1)))
    v = torch_kv.QuantPool(torch.zeros_like(k.data), torch.ones((1, 5, 1)))
    torch_kv.canary_fill(k, v, [2, 3])
    assert int(k.data[0, 2].min()) == torch_kv.INT8_CANARY_VALUE
    assert float(v.scale[0, 3, 0]) == torch_kv.SCALE_CANARY_VALUE
    v.scale[0, 3, 0] = 0.25
    assert torch_kv.canary_check(k, v, [2, 3]) == [3]


# ----------------------------------------------------- the port's engine


def _tiny_engine(monkeypatch, kv_dtype="bf16", prefix=True):
    from swarmdb_tpu_torch.backend.service import build_backend_engine

    monkeypatch.setenv("SWARMDB_KV_DTYPE", kv_dtype)
    # without the prefix cache every page a request takes is freed at its
    # retirement (the JAX test's engine: reclaim 4, reuse 2)
    monkeypatch.setenv("SWARMDB_PREFIX", "1" if prefix else "0")
    eng, _tok = build_backend_engine(
        "tiny-debug", paged=True, device="cpu", max_batch=4, max_seq=96,
        page_size=16, decode_chunk=4, kv_pool_tokens=4 * 96)
    return eng


def _pair(eng, tag, sp):
    ts = [threading.Thread(target=eng.generate_sync,
                           args=([tag + i] * 20, sp)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60.0)
        assert not t.is_alive()


@pytest.fixture()
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_engine_clean_under_sanitizer(pagecheck_on, monkeypatch,
                                      one_thread):
    """The serving loop commits no page crimes: replies are normal, the
    shadow state stays consistent, every re-allocation's canary verify
    runs, zero violations, and the verify reads do not count as the
    engine's host syncs."""
    from swarmdb_tpu_torch.backend.sampling import SamplingParams

    eng = _tiny_engine(monkeypatch)
    eng.start()
    try:
        assert eng._pagecheck is not None
        sp = SamplingParams(max_new_tokens=8)
        for i in range(3):
            _pair(eng, 1 + 2 * i, sp)
        toks, reason = eng.generate_sync([9] * 20, sp)
        assert reason in ("length", "eos")
        time.sleep(0.2)
        assert torch_pagecheck.registry().violations() == []
        pool = torch_pagecheck.registry().report()["pools"][0]
        assert pool["churn_allocated"] >= 8 and pool["churn_freed"] >= 4
        states = pool["states"]
        assert states.get("trash") == 1
        assert sum(states.values()) == pool["num_pages"]
        for rec in eng.flight.requests():
            assert rec["host_syncs"] <= 3
    finally:
        eng.stop()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_canary_fires_on_rogue_write(kv_dtype, pagecheck_on,
                                            monkeypatch, one_thread):
    """A real write-after-free into the pool between admission rounds:
    the next time the page is handed out, the engine's canary verify
    fires and names it."""
    from swarmdb_tpu_torch.backend.sampling import SamplingParams

    eng = _tiny_engine(monkeypatch, kv_dtype, prefix=False)
    eng.start()
    try:
        sp = SamplingParams(max_new_tokens=8)
        _pair(eng, 1, sp)
        eng.generate_sync([9] * 20, sp)
        time.sleep(0.2)
        shadow = torch_pagecheck.registry()._pools[
            eng.paged.allocator.pagecheck.pool_id]
        poisoned = [p for p in range(1, eng.paged.num_pages)
                    if shadow.pages[p].poisoned]
        assert poisoned, "expected lingering poisoned pages"
        rogue = poisoned[0]
        torch_kv.pool_data(eng.cache["k"])[:, rogue] = 3
        for i in range(6):
            _pair(eng, 20 + 2 * i, sp)
            if any(v["kind"] == "canary"
                   for v in torch_pagecheck.registry().violations()):
                break
        bad = [v for v in torch_pagecheck.registry().violations()
               if v["kind"] == "canary"]
        assert bad and rogue in bad[0]["pages"]
    finally:
        eng.stop()


def test_flag_off_engine_has_no_sanitizer_hooks(monkeypatch, one_thread):
    monkeypatch.delenv("SWARMDB_PAGECHECK", raising=False)
    eng = _tiny_engine(monkeypatch)
    assert type(eng.paged.allocator) is torch_kv.PageAllocator
    assert type(eng._prefix) is torch_prefix.PrefixLRU
    assert eng._pagecheck is None
