"""``--explain SWL<code>``: per-rule doc + a minimal bad/good pair.

The port's copy of ``swarmdb_tpu/analysis/explain.py``: the entries of
the copied families are the JAX package's, those of the card's families
(host-sync, graph-capture, capture-leak, kernel-check) its own. The
snippets are just enough to recognize the shape in a code review; the
CLI prints each entry verbatim.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["EXPLAIN"]

#: rule id -> {doc, bad, good}
EXPLAIN: Dict[str, Dict[str, str]] = {
    "SWL101": {
        "doc": "Explicit host syncs (torch.cuda.synchronize, "
               "Event.synchronize, Stream.synchronize) inside a hot "
               "function stall the host until the card drains. The "
               "engine's contract is one wait per decode chunk "
               "(ChunkOut.host); mark a declared per-request drain "
               "`# swarmlint: sanctioned-drain`.",
        "bad": "# swarmlint: hot\n"
               "def _dispatch(self):\n"
               "    out = self._runner.launch(v, inputs)\n"
               "    torch.cuda.synchronize()  # stalls every launch",
        "good": "# swarmlint: hot\n"
                "def _process_block(self, out):\n"
                "    # swarmlint: sanctioned-drain -- the chunk's one wait\n"
                "    out.event.synchronize()",
    },
    "SWL102": {
        "doc": "Reading a CUDA tensor's value on the host (.item(), "
               ".tolist(), .cpu(), .numpy(), .to('cpu'), np.asarray, "
               "int/float/bool, or an `if` on it) waits for every launch "
               "queued before it. Device values are tracked from CUDA "
               "factories, .cuda()/.to('cuda') and `device-state` "
               "attributes.",
        "bad": "# swarmlint: hot\n"
               "def _admit(self):\n"
               "    if self._last_tokens[slot] == eos:  # device read\n"
               "        ...",
        "good": "# swarmlint: hot\n"
                "def _admit(self):\n"
                "    if self._host_tokens[slot] == eos:  # host mirror\n"
                "        ...",
    },
    "SWL105": {
        "doc": "A host sync inside a loop of hot code (including an "
               "Event.query() polled in a loop) waits once per "
               "iteration. The sanctioned-drain marker never applies in "
               "a loop: keep the loop on the card or wait once outside "
               "it.",
        "bad": "# swarmlint: hot\n"
               "def _drain(self, outs):\n"
               "    for o in outs:\n"
               "        o.event.synchronize()",
        "good": "# swarmlint: hot\n"
                "def _drain(self, outs):\n"
                "    # swarmlint: sanctioned-drain -- one wait\n"
                "    outs[-1].event.synchronize()",
    },
    "SWL201": {
        "doc": "Building a torch.cuda.CUDAGraph or entering "
               "torch.cuda.graph(...) inside a loop or a hot function "
               "captures per call; each capture synchronizes the device "
               "and takes the device's capture lock.",
        "bad": "# swarmlint: hot\n"
               "def _decode(self):\n"
               "    g = torch.cuda.CUDAGraph()\n"
               "    with torch.cuda.graph(g):\n"
               "        self._chunk()",
        "good": "def warmup(self):\n"
                "    self._runner.capture_all()\n"
                "# swarmlint: hot\n"
                "def _decode(self):\n"
                "    self._runner.launch(variant)",
    },
    "SWL202": {
        "doc": "Not applicable on the card: eager PyTorch compiles "
               "nothing per argument value, and a graph is keyed by its "
               "sampling variant alone. The rule never fires.",
        "bad": "(none)",
        "good": "(none)",
    },
    "SWL203": {
        "doc": "In a class with `warmup`, every graph runner or "
               "CUDAGraph attribute it replays must be captured from "
               "code the warmup reaches; a variant the warmup misses is "
               "captured at its first replay, mid-traffic.",
        "bad": "def warmup(self):\n"
               "    build.build_all()\n"
               "def _decode(self):\n"
               "    self._runner.launch(v)  # captured here, first time",
        "good": "def warmup(self):\n"
                "    build.build_all()\n"
                "    self._runner.capture_all()",
    },
    "SWL204": {
        "doc": "A tensor allocated inside a capture body with a shape "
               "from len(...) keeps the captured shape at every replay: "
               "a per-call count becomes a stale size.",
        "bad": "def _chunk_body(self, v):\n"
               "    mask = torch.zeros(len(self._live), device=dev)",
        "good": "def __init__(self):\n"
                "    self._mask = torch.zeros(max_batch, device=dev)\n"
                "def _chunk_body(self, v):\n"
                "    self._mask.copy_(...)",
    },
    "SWL205": {
        "doc": "Not applicable on the card: the ragged prefill kernels "
               "take the wave width as a launch argument, so a width "
               "read off the descriptors compiles no variant. The rule "
               "never fires.",
        "bad": "(none)",
        "good": "(none)",
    },
    "SWL301": {
        "doc": "A `guarded-by[...]`-declared attribute read or written "
               "outside `with <guard>:`. Constructors are exempt "
               "(construction happens-before sharing); nested defs "
               "inherit the declaration but not any held lock.",
        "bad": "# swarmlint: guarded-by[self._mu]: _queue\n"
               "def size(self):\n"
               "    return len(self._queue)",
        "good": "def size(self):\n"
                "    with self._mu:\n"
                "        return len(self._queue)",
    },
    "SWL302": {
        "doc": "Lock-order inversion: the interprocedural acquisition "
               "graph (with/acquire nesting propagated through calls) "
               "contains a cycle — two threads taking the locks in "
               "opposite orders deadlock. Each edge in the cycle is a "
               "finding; the message prints both witness paths. The "
               "runtime twin is SWARMDB_LOCKCHECK=1 (obs/lockcheck.py).",
        "bad": "def alloc(self):\n"
               "    with self._a:\n"
               "        self._count()   # _count takes self._b\n"
               "def report(self):\n"
               "    with self._b:\n"
               "        with self._a: ...",
        "good": "def report(self):\n"
                "    with self._a:      # same order everywhere\n"
                "        with self._b: ...",
    },
    "SWL303": {
        "doc": "Inferred guarded-by (RacerD-style): a self-attribute "
               "accessed under one lock at >= 3 sites (a strict "
               "majority, with at least one write) is inferred guarded; "
               "the unguarded access elsewhere is the race. No "
               "annotations needed — a `guarded-by[...]` declaration "
               "moves the field to SWL301.",
        "bad": "def add(self, k, v):\n"
               "    with self._mu: self._items[k] = v\n"
               "def size(self):\n"
               "    return len(self._items)  # raced",
        "good": "def size(self):\n"
                "    with self._mu:\n"
                "        return len(self._items)",
    },
    "SWL304": {
        "doc": "Blocking while holding: (a) Condition.wait whose "
               "predicate is not re-checked in a `while` loop — a "
               "spurious wakeup or stale notify returns with the "
               "predicate false; (b) in hot code, a blocking call "
               "(socket ops, join, sleep, device_get, open) while any "
               "lock is held — every queued thread inherits the stall.",
        "bad": "with cv:\n"
               "    if not ready():\n"
               "        cv.wait(timeout)\n"
               "    consume()",
        "good": "with cv:\n"
                "    while not ready():\n"
                "        cv.wait(remaining())\n"
                "    consume()",
    },
    "SWL305": {
        "doc": "A stored hook/callback attribute (Callable field, attr "
               "bound from a constructor arg or lambda, hook/handler "
               "name) invoked while holding a lock: a re-entrant "
               "callback can call back in and re-acquire (deadlock on a "
               "plain Lock) or observe half-updated state. Snapshot "
               "under the lock, invoke outside it.",
        "bad": "with self._mu:\n"
               "    self._seq += 1\n"
               "    self._on_chunk(self._seq, tok)",
        "good": "with self._mu:\n"
                "    self._seq += 1\n"
                "    seq = self._seq\n"
                "self._on_chunk(seq, tok)",
    },
    "SWL401": {
        "doc": "Inside a CUDA graph capture, a tensor made there and "
               "stored on self / a global / a nonlocal lives in the "
               "graph's pool and is overwritten by the next replay; and "
               "an attribute a capture reads, rebound elsewhere, leaves "
               "the graph reading the old storage (copy_ into it).",
        "bad": "def _chunk_body(self, v):\n"
               "    self._last = self._forward(self._io.tokens)\n"
               "def _reset(self):\n"
               "    self.cache = self._new_cache()  # graph reads old",
        "good": "def _chunk_body(self, v):\n"
                "    self._io.block.copy_(self._forward(self._io.tokens))\n"
                "def _reset(self):\n"
                "    self.cache = self._new_cache()\n"
                "    self._runner = self._new_runner()  # recapture",
    },
    "SWL501": {
        "doc": "span_begin without any span_end in the function (or a "
               "discarded stamp) silently drops the span.",
        "bad": "t = TRACER.span_begin()\n"
               "do_work()  # never ended",
        "good": "t = TRACER.span_begin()\n"
                "do_work()\n"
                "TRACER.span_end(\"work\", t)",
    },
    "SWL502": {
        "doc": "The allocating span(...) context manager inside a hot "
               "function; hot paths use the span_begin/span_end ring "
               "writes.",
        "bad": "# swarmlint: hot\n"
               "def step(self):\n"
               "    with TRACER.span(\"step\"): ...",
        "good": "# swarmlint: hot\n"
                "def step(self):\n"
                "    t = TRACER.span_begin()\n"
                "    ...\n"
                "    TRACER.span_end(\"step\", t)",
    },
    "SWL503": {
        "doc": "A histogram allocated or looked up per observation in "
               "hot code; bind it once, observe through the bound "
               "object.",
        "bad": "# swarmlint: hot\n"
               "def record(self, dt):\n"
               "    HISTOGRAMS.get(\"ttft\").observe(dt)",
        "good": "self._ttft = HISTOGRAMS.register(\"ttft\", ...)  # init\n"
                "# swarmlint: hot\n"
                "def record(self, dt):\n"
                "    self._ttft.observe(dt)",
    },
    "SWL504": {
        "doc": "Per-observation allocation (dict/list/str construction, "
               "comprehension, f-string) in hot exemplar/sentinel "
               "record-path code; retention must be an in-place slot "
               "write.",
        "bad": "def observe(self, v, rid):\n"
               "    self._ex[bucket] = {\"rid\": rid, \"v\": v}",
        "good": "def observe(self, v, rid):\n"
                "    self._ex_rids[bucket] = rid\n"
                "    self._ex_vals[bucket] = v",
    },
    "SWL506": {
        "doc": "Compile-time introspection (cost_analysis() or an "
               "argful lower(...)) inside hot code: lowering re-traces "
               "the function and the cost model runs at compile speed; "
               "the swarmprof harvest belongs in warmup.",
        "bad": "# swarmlint: hot\n"
               "def _dispatch(self, fn, args):\n"
               "    ca = fn.lower(*specs).cost_analysis()  # per call!",
        "good": "def warmup(self):\n"
                "    self.profile_harvest()  # lower+cost_analysis once\n"
                "# swarmlint: hot\n"
                "def _dispatch(self, fn, args):\n"
                "    prof.dispatch(key, t0, dur)  # counters only",
    },
    "SWL507": {
        "doc": "Per-access allocation (container display, comprehension, "
               "f-string, dict()/list()/set()/str() construction) in a "
               "hot method of a memory-accountant ledger class "
               "(MemPool/PrefixProbe/ConvLedger/ReuseSampler): the "
               "memprof hooks run INSIDE locks the page allocator and "
               "prefix cache already hold, so their record path must "
               "stay int adds and slot writes.",
        "bad": "# swarmlint: hot\n"
               "def page_alloc(self, pages):\n"
               "    self.events.append({\"pages\": list(pages)})",
        "good": "# swarmlint: hot\n"
                "def page_alloc(self, pages):\n"
                "    t = time.monotonic_ns()\n"
                "    for p in pages:\n"
                "        self.ages[p] = t\n"
                "    self.alloc_events += 1",
    },
    "SWL601": {
        "doc": "A blocking call inside `# swarmlint: heartbeat` code: a "
               "stalled failure-detector evaluation reads as a dead "
               "peer and triggers false-positive failover.",
        "bad": "# swarmlint: heartbeat\n"
               "def verdict(self):\n"
               "    sock.connect(addr)  # detector blocks on I/O",
        "good": "# swarmlint: heartbeat\n"
                "def verdict(self):\n"
                "    return now - self._last_beat > self.suspect_s",
    },
    "SWL602": {
        "doc": "Lock acquisition inside `# swarmlint: heartbeat` code: "
               "a writer holding the lock stalls the verdict.",
        "bad": "# swarmlint: heartbeat\n"
               "def verdict(self):\n"
               "    with self._mu:\n"
               "        return self._state",
        "good": "# swarmlint: heartbeat\n"
                "def verdict(self):\n"
                "    return self._state  # single-writer float slot",
    },
    "SWL603": {
        "doc": "A partition-log append in `# swarmlint: ha` code with no "
               "epoch-fence check before the write: a deposed leader's "
               "unfenced append forks the replicated log.",
        "bad": "# swarmlint: ha\n"
               "def append(self, topic, part, rec):\n"
               "    self._log.append(topic, part, rec)",
        "good": "# swarmlint: ha\n"
                "def append(self, topic, part, rec):\n"
                "    self._check_fence(topic, part)\n"
                "    self._log.append(topic, part, rec)",
    },
    "SWL801": {
        "doc": "A page handle taken from the allocator/prefix cache "
               "(allocate, allocate_with_prefix, reserve, acquire, "
               "evict_lru, take_pending_frees) must reach a free sink, "
               "registration, or custody transfer on EVERY path out — "
               "including exception paths: a handle destined for a "
               "free sink held across a raising call with no try "
               "protection leaks when the call throws. Declare "
               "transfer at call boundaries with `# swarmlint: "
               "owns[page]:` / `borrows[page]:`. Runtime twin: "
               "SWARMDB_PAGECHECK=1 (obs/pagecheck.py).",
        "bad": "pending = alloc.take_pending_frees()\n"
               "dispatch_zero_rows(pending)  # can raise -> pages leak\n"
               "alloc.release_taken(pending)",
        "good": "pending = alloc.take_pending_frees()\n"
                "try:\n"
                "    dispatch_zero_rows(pending)\n"
                "except Exception:\n"
                "    alloc.requeue_pending(pending)  # retry next round\n"
                "    raise\n"
                "alloc.release_taken(pending)",
    },
    "SWL802": {
        "doc": "A handle that reached a free sink is dead: flowing it "
               "into a page-table write, a dispatch descriptor, or any "
               "later call blesses pages that another conversation may "
               "already own — the paged-KV use-after-free that aliases "
               "two requests' KV.",
        "bad": "alloc.add_free(row)\n"
               "set_page_table_rows(table, [slot], row)  # freed row",
        "good": "set_page_table_rows(table, [slot], row)\n"
                "alloc.add_free(row)  # free only after the write",
    },
    "SWL803": {
        "doc": "Freeing the same handle twice puts its pages on the "
               "free list twice: two future allocations receive the "
               "same page ids and silently alias each other's KV.",
        "bad": "alloc.add_free(pages)\n"
               "alloc.add_free(pages)  # second free forks custody",
        "good": "alloc.add_free(pages)\n"
                "pages = None  # handle is dead after the free",
    },
    "SWL804": {
        "doc": "Every PrefixLRU.pin / match_and_pin must be matched by "
               "unpin/release or a custody handoff on all paths out of "
               "the function. A leaked pin permanently inflates "
               "evictable_count — which the pool backpressure gate "
               "trusts as reclaimable headroom — so admission keeps "
               "betting on pages it can never evict.",
        "bad": "hits = prefix.match_and_pin(chains, prompt)\n"
               "if too_long(hits):\n"
               "    return []  # pins leak on the early return",
        "good": "hits = prefix.match_and_pin(chains, prompt)\n"
                "if too_long(hits):\n"
                "    prefix.unpin(hits)\n"
                "    return []",
    },
    "SWL805": {
        "doc": "A handle written into a page-table row BEFORE the "
               "allocator call that produces it on this path: the row "
               "blesses page ids the pool has not granted, so the "
               "device can read/write pages owned by nobody (or "
               "somebody else).",
        "bad": "set_page_table_rows(table, [slot], row)  # row not yet real\n"
               "row = alloc.allocate(slot, need)",
        "good": "row = alloc.allocate(slot, need)\n"
                "if row is not None:\n"
                "    set_page_table_rows(table, [slot], row)",
    },
    "SWL701": {
        "doc": "A retry loop in `# swarmlint: retry` code must carry a "
               "bound, a backoff, and a deadline check — otherwise one "
               "failure becomes a retry storm and a hung dependency a "
               "hung caller.",
        "bad": "# swarmlint: retry\n"
               "def fetch(self):\n"
               "    while True:\n"
               "        if self._try(): return",
        "good": "# swarmlint: retry\n"
                "def fetch(self):\n"
                "    for i in range(self.retries):\n"
                "        if time.time() > deadline: break\n"
                "        if self._try(): return\n"
                "        time.sleep(backoff * 2 ** i)",
    },
    "SWL901": {
        "doc": "Not applicable on the card: the rule parses "
               "pl.pallas_call index maps. The CUDA kernels' bounds are "
               "checked at run time by the bounds-checked build "
               "(SWARMDB_KERNCHECK=1).",
        "bad": "(none)",
        "good": "(none)",
    },
    "SWL902": {
        "doc": "Not applicable on the card: the rule parses "
               "pl.pallas_call output block maps; a CUDA block writes "
               "what its own code indexes (the checked build stamps "
               "each output row's writer).",
        "bad": "(none)",
        "good": "(none)",
    },
    "SWL903": {
        "doc": "Shared memory per block of a CUDA entry point, mirrored "
               "from its C++ layout (DecodeLayout::bytes, "
               "MmaSmem<D, NG>::bytes, the fp32 prefill's two KT x D "
               "tiles) at a registry model's dims and the dtypes the "
               "engines launch, over the H100's opt-in limit per block "
               "(227 KiB): the launch would be refused.",
        "bad": "ModelConfig(name='mqa-256', dim=32768, n_heads=256,\n"
               "            n_kv_heads=1, ...)  # G 256: the decode's\n"
               "# fp32 query + accumulator alone are 256 KiB",
        "good": "ModelConfig(name='llama3-8b', dim=4096, n_heads=32,\n"
                "            n_kv_heads=8, ...)  # D 128",
    },
    "SWL904": {
        "doc": "Not applicable on the card: TPU sublane x lane tiling "
               "of Pallas blocks has no CUDA counterpart.",
        "bad": "(none)",
        "good": "(none)",
    },
    "SWL905": {
        "doc": "Not applicable on the card: the rule parses "
               "pl.pallas_call output refs; the CUDA kernels' coverage "
               "is checked by the kernel sanitizer's output canaries.",
        "bad": "(none)",
        "good": "(none)",
    },
}
