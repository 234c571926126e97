#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``swarmdb_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives the port on the card in phases, prints one JSON line per phase
and exits non-zero at the first failure:

1. device   -- the card's name and power limit (``nvidia-smi``).
2. build    -- compiles the eight CUDA kernels from
               ``swarmdb_tpu_torch/csrc``, one ``nvcc`` per source, all
               started together; then their bounds-checked variants
               (``-DSWARM_KERNCHECK``, the sanitize phase's) the same way,
               left building through phase 4 (the line comes after it).
2b. lint    -- ``python -m swarmdb_tpu_torch.analysis`` (the port's
               swarmlint against its own baseline), run beside the build,
               must exit 0 under this machine's Python.
2c. smem    -- for each of the eight entry points at Hq 32, Hkv 8, D 128,
               every dtype the engines launch it with (and the prefill at
               a 64- and a 4096-token wave: two thread groups a block, and
               one), ``analysis.kernelcheck.estimate_smem`` (the Python
               mirror of the C++ layouts) must equal the library's own
               shared memory per block (``swarm_<kernel>_smem``: the
               dynamic bytes its launch passes plus the instance's static
               bytes), fit the instance's dynamic limit after the launch's
               opt-in (the tensor-core prefill opts in to exactly its
               size) and the device's opt-in limit; registers, spills and
               static shared memory from the parsed build log are printed
               beside ``cudaFuncGetAttributes``. The serving instance's
               numbers join each kernel's ``kernels`` line.
3. kernels  -- each kernel at the serving path's shapes (Llama-3-8B heads:
               Hq 32, Hkv 8, D 128; 8 slots of 64 pages of 16, or a dense
               slot cache of 8 x 1024 positions) against its plain PyTorch
               version on the same inputs (the same int8 payload and
               scales for the int8 kernels): bf16 query / chunk / suffix
               within 2e-2 absolute, f32 within 1e-4, an f32 query over
               bf16 pages or lanes within 2e-2, each with a windowed case
               (the two dense decode kernels, 7 and 8, also at Hq 16, Hkv
               4: one rank's heads in the tp phase);
               the two prefill kernels (whose bf16 calls run the tensor-
               core body) also on a seeded sweep of 16 waves over their
               edges (``prefill_sweep``), within 2e-2, and the six decode
               kernels (one cluster-split body) on a seeded sweep of 14
               waves over theirs (``decode_sweep``), bf16 within 2e-2 and
               f32 within 1e-4 (and the single-step paged decode once
               more with all slots at lengths 0, 32, 256 and 1024: its
               fixed cost and its cost per tile, ``decode_lengths``);
               then timed with
               CUDA events (median of 30 after warm-up): the kernel, its
               plain version, and one PyTorch
               ``scaled_dot_product_attention`` call over the gathered
               (for int8: already dequantized) dense view, or straight
               over the dense lanes (``library_ms``, gather and
               dequantization excluded); the prefill kernels once more on
               a 1024-token turn-1 wave, held against their plain
               versions within 2e-2 and timed (its own ``kernels``
               line); the chunked and single-step paged decode (2, 3)
               also on a data rank's view of a 2-shard pool
               (``localized_case``: its slots, its sub-pool, its table
               rows localized, a retired row and entries past each
               slot's pages on local page 0).
4. parity   -- tiny-debug in f32 with the same weights, served on the card
               (kernels) and on the CPU (plain versions): the paged engine
               chunked and single-step over an f32 pool (logits within
               1e-4), a bf16 pool single-step and an int8 pool both ways
               (logits within the bounds in ``PARITY_CASES``), and the
               dense engine chunked and single-step over an f32 slot cache
               (1e-4); greedy tokens equal in every case. Then tiny-moe
               (Mixtral's family) in f32 the same way (``MOE_PARITY_CASES``):
               both engines, chunked and single-step, one paged case with
               ``SWARMDB_MOE_DISPATCH=einsum``; the paged engine prefills it
               in row-bucketed and prefix waves, so only the decode kernel
               launches; logits of the bucketed prefill, the prefix wave
               and the decode steps within 1e-4. Last, the binding-
               capacity case (tiny-moe with 8 experts, where idle and
               retired rows take capacity) at the default decode loops,
               both engines chunked and single-step: the card's graph
               replays and the CPU's eager chunks give equal greedy
               tokens (``run_binding_parity``). Last, rolling KV
               (``run_rolling_parity``, ``ROLL_PARITY_CASES``): one
               tiny-debug f32 conversation of five chat and
               ``function_call`` turns, on the paged engine (f32 and int8
               pools, chunked with an f32 and with the engine's bf16
               chunk buffer, and single-step) with the tier manager --
               demoted to host memory before turn 3 (a warm promotion)
               and into a store too small for it before turn 4 (a cold
               resume) -- and on the dense engine (chunked and single-
               step, kept pages composed into the lane): origins equal on
               both sides, greedy tokens equal, every prefill row's
               logits and the decode logprobs within each case's bound,
               and the bf16 chunk buffer's cases within 1e-4 of the CPU
               served the kernels' way (weights unrounded).
5. serve    -- Llama-3-8B at full width (32 layers, bf16 weights from seed
               0, built once) through SwarmDB + LocalBroker +
               ServingService, six times, each at the default decode
               loop (paged: resident sessions; dense: two chunks in
               flight), every chunk a CUDA graph replay, the graphs
               captured by ``start(warmup=True)`` (SWARMDB_PREWARM's path;
               the api phase captures at first use): the paged engine (``paged=True``)
               over a bf16 pool chunked (4 users x 2 turns), an int8 pool
               chunked (4 x 2: turn 2 reads int8 prefix pages), a bf16
               pool single-step and an int8 pool single-step (4 x 1); then
               the dense engine, built with ``paged=None`` and
               ``SWARMDB_PAGED`` unset (the default), chunked (4 x 2: turn
               2 reads the side prefix pool) and single-step (4 x 1); 32
               new tokens each, one request sampled (temperature 0.8,
               top-p 0.9, seed 7). Checks every reply, prefix reuse on
               turn 2, and that the path's kernels (and no other) advanced
               by 32 launches per prefill wave (paged; dense prefill
               attention is plain PyTorch, as in the JAX package) and by
               exactly 32 per decode step (counted from the replays);
               prints TTFT, decode tokens/s, KV bytes per token, the
               cache's (and side pool's) size, peak device memory, the
               decode loop, its graphs and counters per serve. Each serve then runs one more turn under
               ``torch.profiler`` (device time by kernel, the device's
               idle share, the prefill's time in each of its two bodies,
               the decode kernels' time by name); a paged serve fails if
               its prefill ran in the fp32 body, and any serve fails if
               its decode kernel shows no device time.
6. api      -- the wire API and supervised serving on the same weights:
               (a) ``create_app`` served on 127.0.0.1:0 (aiohttp
               ``AppRunner``) over the default dense engine (its
               tokenizer renders ids outside the byte range as ``<id>``,
               or random weights would stream empty text): four users
               each stream one ``POST /messages`` at once, 32 new tokens;
               every stream's text must equal its reply's body (client
               TTFT printed beside the service's ``send_to_first_token_s``);
               (b) a seeded message with ``n = 2`` must come back with one
               alternative of 32 tokens that differs from the body; (c) a
               group of two LLM-backed members streams through
               ``/groups/message``; (d) ``ServingChaos.kill_lane(0)`` at
               the 8th token of a decode: the service's supervisor must
               finish it "length" with 32 tokens, the streamed tokens equal
               to the final ones and at least one retry; then, on the paged
               bf16 engine, ``squeeze_pool(1.0)`` must shed the
               low-priority request and, after ``heal_pool()``, a
               supervisor built with a wider retry budget and backoff
               (printed) must serve it before its deadline; (e)
               ``python -m swarmdb_tpu_torch.api.server`` with
               ``SERVE_MODEL=tiny-debug`` and ``SWARMDB_PREWARM=1`` as a
               subprocess: ``/health`` must name the card and show the
               three variants' graphs captured at start, one message is
               answered, then SIGTERM.
               Kernels 7 (dense chunked decode), 1 and 2 must launch in
               the phase (its in-process steps; the subprocess's launches
               are its own).
6b. obs     -- the observability feeds on the same weights, in process
               through ``create_app`` as in the api phase: the default
               dense engine and the paged bf16 engine, both chunked, each
               with the tracer, histograms and SLO sentinel on
               (``OBS_SLO_ENV``: 2 s windows, one warm-up window, four
               completions a window; ``SWARMDB_FLIGHT_DIR`` a temporary
               directory), 4 users x 2 streamed turns of ~400-token chat
               messages, 32 new tokens. Fails unless every message's
               spans are there (``runtime.send``, ``broker.publish``,
               ``serve.request`` by message id; ``engine.admit``,
               ``engine.prefill`` and at least two ``engine.decode_chunk``
               by engine request id; an ``api.request`` per POST and an
               ``engine.host_sync`` in the process), the decode-chunk
               spans equal the live snapshot slots of every processed
               chunk (counted outside the engine), ``/admin/flight`` has
               both rings and its last step's counters equal the
               registry's, ``/metrics`` has the six histogram blocks and
               ``ttft_seconds_count`` equals the requests served,
               ``phase_us_queue_wait`` and ``phase_us_host_sync`` are
               positive, ``/admin/cluster/trace`` gives the span count of
               ``/admin/trace/export``, and, with
               ``SWARMDB_SLO_TTFT_P95_S=0.001`` for a third round (each
               try in a window of its own that holds the whole turn, at
               most ``OBS_ROUND_TRIES`` until an alert names the TTFT),
               ``/admin/slo`` reports the breach with an alert whose shares
               sum to 1 and whose flight and trace dumps land in the
               directory. The paged engine then prints one profiled
               turn's idle share beside its phase counters, and
               ``tracer_overhead_pct`` from three alternating on / off
               turn pairs (fails above 20%); then an echo-loop A/B on the
               runtime alone (``bench.py``'s ``_echo_loop``). The A/B
               switches the device-time profiler and the memory
               accountant with the rest.
6c. prof    -- the device-time profiler and the memory accountant on the
               same weights, in process through ``create_app``: the
               default dense engine and the paged bf16 engine, both
               chunked, ``SWARMDB_PROFILE=1 SWARMDB_MEMPROF=1``, fresh
               registries, ``start(warmup=True)`` (the harvest), 4 users x
               2 streamed turns of ~400 tokens (a follow-up round repeats,
               at most ``OBS_ROUND_TRIES``, until a window closed during
               the traffic carries ``mfu``, ``min_lane_duty``,
               ``prefix_hit_rate`` and, paged, ``mem_headroom_frac``),
               then one one-wave turn of fresh users with the profiler and
               accountant on and one with them off, then one turn under
               ``torch.profiler``. Fails unless every variant reads 0
               device seconds after warmup and ``harvest_calls`` stays flat
               through the traffic, host syncs per request are equal on
               and off, every executed variant has device time and a
               roofline row and ``/admin/profile``'s ``mfu`` lies in
               (0, 1], the profiler's busy time over the profiled turn's
               union of kernel intervals lies in [0.9, wall / union],
               ``/admin/profile`` and ``/admin/mem`` answer their
               ``kind``, the paged pool's occupancy (free + active +
               cached-evictable + pinned) equals the engine's custody
               (free + retired slots + prefix cache = the pool),
               ``/metrics`` carries the profiler's and accountant's lines,
               the trace export a ``device:`` track, and ``python -m
               swarmdb_tpu_torch.obs.analyze --roofline`` / ``--memory``
               read the phase's dumps; every kernel variant carries its
               build's ptxas facts, and on the paged engine its shared
               memory per block (``vmem_est_bytes``), which ``--roofline``
               prints as its column (an ``smem`` line per engine). Prints
               each decode variant's chunk
               ms, MFU, achieved bytes/s and share of 3.35 TB/s beside its
               byte bound, the dispatch-shape profile and the lane's duty.
7. decode_loop -- graph against eager on Llama-3-8B (``LOOP_LLAMA``: paged
               bf16 and int8 chunked, dense chunked, paged bf16 and dense
               single-step): per mode one engine whose ``warmup`` (on a
               fresh thread) captures the three variants, four requests
               admitted, then one greedy chunk replayed and the same chunk
               run eagerly from the same saved state: greedy tokens equal,
               logprobs within 2e-2, the ms per chunk each way (CUDA
               events, median of 20), launches per replay, the graph
               pool's bytes; in the paged single-step mode the decode
               kernel's device time inside a replayed chunk beside its
               time alone and its fixed cost.

7b. rolling -- rolling KV and the three conversation tiers on Llama-3-8B
               at full width, 16 of its 32 layers (the serve phase's
               weights, its first 16 layers, and settings: max_batch 8,
               max_seq 1024, chunk 8, pages of 16, graphs captured at
               start): ``bench.py``'s ``bench_swarm1M`` cut to
               one card -- 12 users x 4 assistants, one ~600-token context
               turn each, then two rounds of 48 ~40-token deltas drawn
               Zipf(1.1) (numpy seed 0), 32 new tokens, at most 10 in
               flight -- on the paged engine over bf16 and int8 pools (769
               pages; ``SWARMDB_TIER_WARM_MB=512``, the pages 1024 held
               at full depth; min idle 0.05 s) and
               the dense engine (rolling and eviction only). Prints turns
               and prefill tokens by origin (hot / warm / cold / fresh /
               keep / plain), TTFT by origin, restarts, evictions, tier
               counters, pages by tier, ms per page of demotion and of
               promotion, pinned host bytes, peak device memory and the
               launches. Fails unless every reply ends length / eos, each
               paged engine shows a hot, a warm and a cold resume, and page
               custody balances (free + registry + retired slots + prefix
               cache = the pool); prints the memory accountant's
               ``tier_validation`` (its what-if warm share against the
               measured promotions / cold resumes, every prefix access
               sampled). Each paged engine then runs ``tier_ab``:
               a conversation demoted to pinned host memory and promoted
               back must have its pool bytes equal (``torch.equal``) and
               its next greedy turn equal to the same turn kept hot; the
               engine otherwise idle, the turn's TTFT kept hot, promoted
               (warm) and re-prefilled whole (cold) is printed, with the
               promotion's host-to-device GB/s.
               PyTorch's page-locked bytes are read before each engine and
               after it stopped: a stopped engine may leave at most
               ``ROLL_PINNED_SLACK`` (64 MiB) behind.
7c. lanes -- lane groups and the fleet on Llama-3-8B at full width, the
               serve phase's weights shared by two lanes on one card
               (``build_serving_engine`` over ``["cuda:0", "cuda:0"]``: 2
               lanes x 4 slots, 513 pages of 16 per lane, each lane its
               own CUDA stream, graphs captured by ``warmup()``): (1) the
               supervised group through SwarmDB + LocalBroker +
               ServingService, 8 users x 2 turns of ~400 tokens, 32 new
               tokens: every reply length / eos, both lanes serving, each
               conversation's turns on one lane, turn 2 reusing pages on
               both, lanes 0 and 1 equal on a greedy prompt; per lane its
               requests, ragged waves, chunks and waves admitted while the
               sibling decoded; flight steps stamped with lanes 0 and 1
               and the runtime's sentinel on both lane engines; TTFT,
               tokens/s, peak memory; one profiled
               turn (device busy as the union of both streams' kernel
               intervals, beside their sum); each lane's duty cycle from
               the device-time profiler. (2) 4 greedy streams on lane
               1, lane 1 killed at the 8th token (``ServingChaos.run_script``
               with one ``kill_lane``): they
               migrate to lane 0 and end "length" with the undisturbed
               tokens, lane 1 is restarted, probed and re-admitted,
               custody balances on both lanes. (3)
               ``SWARMDB_FLEET=prefill:1,decode:1`` with a 1 GiB transit
               store over bf16 and int8 pools: 8 requests of ~400 tokens
               hand off with no fallback, the prefill lane runs no decode
               chunk and the decode lane no ragged wave, custody balances
               and the transit store empties; handoff ms, gather and
               insert ms per page, page-locked bytes before and after,
               staged against colocated TTFT, and the profiler's per-pool
               rows (``pools_report``). Greedy streams that part
               from their reference (migrated, or handed off) must part
               where the plain forward's top-2 gap is below the measured
               max logit difference of the two paths at the first step
               (``first_step_logit_diff``), a near tie.
7c'. ha    -- the broker, replication and HA control plane on the same
               weights (``run_ha``). (a) In process: three HA nodes
               (``build_local_cluster``, partition leadership, the JAX
               package's detector: suspect 0.3 s, dead 0.6 s) each on the
               broker ``BROKER_IMPL=auto`` picks, which must be the port's
               ``NativeBroker``; a ``SwarmDB`` over ``n0.client_broker()``
               (6 partitions) and a ``ServingService`` on the lanes
               phase's 2-lane group bound with
               ``bind_partition_leadership(n0)``; 8 users x 2 turns of
               ~400 tokens to 8 assistants, 32 greedy tokens; mid-turn 2
               the non-controller leading most partitions is killed. Fails
               unless every reply ends "length", every acknowledged message
               is read back from the survivors, each orphan is re-seated
               within ``HA_PROMOTE_BUDGET_S`` (2.4 s), the blast radius is
               at most 1/3 + one partition, ``ha.repin`` events from the
               victim name exactly its conversations' partitions, and after
               the kill each conversation's pin names its partition's
               leader and the lane derived from it, which a probe turn's
               requests carry as their hint; each turn-2 prompt must hold
               turn 1's exchange, and the replies must equal those of the
               same turns served undisturbed (a fresh runtime on
               ``LocalBroker`` and a fresh service on the same group, its
               prefix caches flushed, no kill), or part where both tokens
               lie within the undisturbed serve's measured difference from
               a plain bf16 forward of the top logit (``ha_compare``).
               Replies retry their produce through the failover at the
               service's defaults. Prints time to promote, blast radius,
               acked records, repins, TTFT per turn with and without the
               kill, the replies that retried, and the echo loop's msgs/s
               on the native broker beside LocalBroker's. (b) Across
               processes: two
               ``python -m swarmdb_tpu_torch.ha.node`` nodes and the port's
               server (``SWARMDB_HA_NODE_ID``, ``SERVE_MODEL=tiny-debug``,
               the dense engine: kernel 7, in its own process) as the
               third over a ``FileClusterMap``; one SSE message, the
               controller SIGKILLed, a second message: both replies,
               ``/admin/ha`` showing the promotion, ``metadata.unreachable``
               naming the dead node, and a merged
               ``/admin/cluster/trace?trace_id=`` over two or more pids
               holding the ``ha.promoted`` instant.
7c''. tp   -- one serving program over a model axis (tensor parallelism,
               ``parallel/``) on Llama-3-8B at full width and depth, 4
               greedy requests of 380-420 seeded token ids submitted
               together, 32 new tokens each, max_batch 4, max_seq 512
               (one prefill wave of 4 x 512), chunk 8. (a) The reference: the default dense engine,
               chunked, on the serve phase's weights, without its prefix
               cache (the pod's engine has none, as the JAX package's
               sharded engine). (b) World size 1 over NCCL (a TCP store on
               127.0.0.1): the pod's coordinator (``enable_multihost``, no
               worker) on the same weights, its chunks captured as CUDA
               graphs at ``warmup()`` with their collectives in them:
               tokens equal to (a)'s, kernel 7 launched. (c) World size 2
               on ``cuda:0`` over gloo (NCCL refuses two ranks on one
               card): two ``--tp-child`` processes, each drawing
               Llama-3-8B at full width and ``TP_WS2_LAYERS`` (8) of its
               32 layers from seed 0 a tensor at a time and keeping its
               half (Hq 16, Hkv 4), its chunks eager (the depth is cut:
               gloo stages each collective through host memory); rank 0
               serves the same requests on the dense engine chunked
               (kernel 7) and single-step (kernel 8) and rank 1 replays
               them: each mode's tokens equal to those of (a)'s engine at
               the same depth (served here first) or parting at a near
               tie, held to a plain bf16 forward over that reference's
               tokens: ``tol`` is the reference's own largest
               |log-probability difference| of its chosen tokens from that
               forward (no path under test), and (c)'s chosen tokens'
               log-probabilities must lie within twice ``tol`` of it at
               every step up to the parting, where both tokens must lie
               within twice ``tol`` of its top logit. Prints init seconds
               per rank, TTFT and tokens/s per world size, the
               collectives per decode step and each one's ms alone.
               (d) The dp step, on (c)'s two ranks and process group once
               their model-axis engines are freed: the single program over
               a data axis of two (``build_serving_engine(data=2)``), each
               rank drawing Llama-3-8B whole from seed 0 and holding 2 of
               the 4 slots, rank 0 serving the same requests and rank 1
               replaying: the sharded paged engine (bf16 pool, 97 pages of
               16 a shard, prefix cache on) chunked (kernel 2) and
               single-step (kernel 3) under ``SWARMDB_KERNCHECK=1`` (the
               bounds-checked build), then the dense engine chunked
               (kernel 7) (``DP_SERVES``), each with its greedy chunk's
               graph captured before traffic. References, served in this
               process before the ranks start: the single paged engine
               chunked and single-step, and (a), at full depth. Each
               serve's tokens equal
               its reference's or part at a near tie under (c)'s rule
               (``tol`` now the reference's own), every reply length /
               eos, each rank launched the serve's kernel on its own two
               slots, zero kernel violations, ``paged_shards`` 2 in a
               paged serve's flight meta. Prints each rank's slots and
               pool pages, TTFT and tokens/s per serve, whether its chunks
               replayed as graphs, the per-chunk gather's ms alone, init
               seconds and peak memory per rank.
               (e) The local step, once (c)'s ranks have exited: the same
               programs built by this process over two devices of it
               (``build_serving_engine(cfg, ["cuda:0", "cuda:0"])`` with
               no process group: it spawns the second rank itself and
               this process serves as rank 0, over gloo; ``LOCAL_SERVES``)
               -- the dense engine over a model axis of two at (c)'s depth
               (kernel 7), then the sharded paged engine
               (``admit_overlap=False``) over a data axis of two at full
               depth (kernel 2), both chunked, each rank drawing its
               weights from seed 0; the model axis's program takes
               ``LOCAL_KNOBS`` (``pipeline_depth`` 1, ``aging_s`` 30)
               through ``build_serving_engine``, which its coordinator
               must hold before and after ``restart()``. Each serve's tokens equal the pod
               serve's of its program ((c)'s chunked serve, (d)'s paged
               chunked serve) or, where they part, are held to that
               serve's reference under (c)'s rule; rank 0 launched the
               kernel. The paged program, whose chunks replay as graphs
               (captured by its first serve), serves once more, warm (its
               prompts now hit the prefix cache): held as the first
               serve. On the model axis the worker is then SIGKILLed at
               a serve's first token: every request must end
               "engine_error" within the process group's timeout
               (``LOCAL_PG_TIMEOUT_S``) and a minute; ``restart()`` spawns
               a new worker and the prompts are served again with the
               same tokens. Each ``stop()`` must leave its worker exited 0
               and no process group. Prints its own ``tp_local`` line:
               spawn, init and build seconds, TTFT, tokens/s, the kill's
               seconds and the restart's, with the card's name and power
               limit.
               (f) The prefix step: the dense engine chunked with its
               prefix lane over a side pool of ``TP_PREFIX_PAGES`` (129)
               pages of 16 (``build_serving_engine(prefix_pages=)``) on
               (b)'s world size 1 (full depth, graphs captured before
               traffic), on (c)'s two ranks (8 layers, the model axis: its
               worker replays each prefix wave, the JAX engine's mirrored
               call 4) and on (d)'s (the data axis: every rank runs each
               prefix wave whole) over the weights each already holds;
               rank 0 serves the tp prompts queued together (``cold``:
               full misses registering their pages), then each prompt
               followed by its reply (``hit``: a second turn reading turn
               1's pages). References, served in this process before:
               the single dense engine with its lane over the same pool
               at full depth and at (c)'s. Per program and turn the
               tokens equal the reference's at its depth or part at a
               near tie under (c)'s rule, ``prefix_reused_tokens`` equal
               the reference's (above 0 on the hit turn), every reply
               length / eos, kernel 7 launched on every rank. Prints its
               own ``tp_prefix`` line: reused tokens, TTFT of each turn
               and the hit turn's median over the cold one's, tokens/s,
               launches and collectives per rank, with the card's name
               and power limit.
7d. sanitize -- the three runtime sanitizers, in a child process
               (``--sanitize-child``) run with ``SWARMDB_LOCKCHECK=1
               SWARMDB_PAGECHECK=1 SWARMDB_KERNCHECK=1`` and a temporary
               ``SWARMDB_FLIGHT_DIR`` once this process has freed its
               Llama-3-8B weights; the child draws Llama-3-8B at full width
               and depth from seed 0. (a) Five clean serves
               (``SANITIZE_SERVES``: paged bf16 and int8, dense, all
               chunked; rolling paged bf16 with the warm tier, every
               conversation demoted between its turns and promoted back;
               a ``prefill:1,decode:1`` fleet over two lanes on cuda:0),
               each 4 users x 2 turns of ~400 tokens, 32 greedy new
               tokens, each turn's requests sent together, with the
               sanitizers on and again off: zero lock cycles, page
               violations and kernel violations, and every reply's tokens
               equal to the sanitizers-off ones or parting at a near tie,
               checked as the lanes phase checks one (``compare_replies``:
               a plain bf16 forward over the conversation); TTFT and
               decode tokens/s on and off. (b) The differential soups (``obs/kerncheck.py``)
               through all eight entry points, f32 and bf16, on the plain
               and on the checked build: zero mismatches, zero violations;
               each kernel's checked-build ms per call beside its plain
               build's. (c) Four seeded defects, each caught with its kind:
               a write into a freed, poisoned page through
               ``paged_write_decode`` (``canary`` at the next admission), a
               ragged launch whose table holds page id P + 5 (``oob-block``
               from the checked build naming the block and the id; the
               plain build's clamped result held against the plain version
               on the clamped table), two ragged rows overlapping in the
               stream (``write-race`` from the host audit and from the
               device writer map), two ``make_lock`` locks taken in both
               orders on two threads (a lockcheck cycle naming both
               sites). (d) The three routes over HTTP, their ``/metrics``
               lines, and ``python -m swarmdb_tpu_torch.obs.analyze`` over
               the dump directory listing all three kinds of dump.
7e. ckpt  -- weights read from disk: Llama-3-8B at full width and
               ``CKPT_LLAMA_LAYERS`` (4) of 32 layers, then Mixtral-8x7B
               at full width and ``CKPT_MIXTRAL_LAYERS`` (1), each drawn
               from seed 0 on the card, written as an HF checkpoint (HF
               key names, ``[out, in]``, bf16, two safetensors shards and
               an index, by ``write_hf_checkpoint``), read back by
               ``utils.checkpoint.load_hf_checkpoint`` onto the card (bit
               for bit), served (4 greedy requests of ~400 tokens, 32 new,
               submitted together) with the loaded weights and with the
               drawn ones -- Llama on the paged bf16 engine (kernels 1 and
               2) and the dense engine (kernel 7), Mixtral on the dense
               engine -- with identical tokens, then a ``save_params`` /
               ``restore_params`` round trip onto the card (bit for bit);
               bytes written, load seconds and GB/s printed; each
               directory deleted before the next step.
8. mixtral -- Mixtral-8x7B at full width (dim 4096, 32 / 8 heads of 128,
               8 experts of FFN 14336, top-2, vocab 32000, rope theta 1e6)
               and 8 of its 32 layers (``reduced``: all 32 do not fit one
               80 GB card; 8 keep the script in its time limit), bf16
               weights from seed 0, after Llama-3-8B's
               are freed. Layer 0's MoE block timed at a decode step and
               an 8 x 256 prefill wave, whole and its expert products alone,
               with the kernels each launches. Then six serves through
               SwarmDB + LocalBroker + ServingService (max_batch 8,
               max_seq 1024, decode_chunk 8, page 16, prefix cache on) of
               ``function_call`` messages (``bench.py``'s tool-use payload),
               4 users, 32 new tokens: the default dense engine chunked
               (3 turns) and single-step (1), the paged engine over bf16
               and int8 pools, chunked (3 turns) and single-step (1). A
               tool call renders differently in its own turn and in later
               history, so turn 2 shares no full page with turn 1 and turn
               3 reuses turn 2's pages. Checks every reply is a
               ``function_result`` ending length/eos, prefix reuse by turn
               3, the path's decode kernel (7, 8, 2, 5, 3, 6) and no other
               launched 16 times per decode step, kernels 1 and 4 never
               (Mixtral prefills in row-bucketed waves); prints TTFT,
               decode tokens/s, weight, KV and cache sizes, peak memory and
               the decode step (engine wall, and one step timed alone)
               beside its byte bound. The dense and paged bf16 chunked
               serves profile one more turn (device time by kernel, GEMMs,
               indexing, the decode kernel, idle share). Then the
               decode_loop comparison on Mixtral (``LOOP_MIXTRAL``: dense
               and paged bf16 chunked), its step beside the byte bound. A
               seventh serve repeats the paged bf16 chunked one with
               ``SWARMDB_ROLLING_KV=1``; the tokens each turn prefilled are
               printed beside the non-rolling serve's. Last, the ep
               phase's reference on the same weights (``ep_reference``):
               the dense engine (max_batch 4, max_seq 512, chunk 8, no
               prefix cache, chunks run eagerly as the pods' do) serving
               the ep prompts (4 x 380-420 seeded ids, 32 new tokens,
               queued before it starts so that they share every wave and
               step), and the plain bf16 forward over its tokens batched
               as the engine batches them (``moe_plain_steps``); ``tol``
               is the serve's own largest |log-probability difference|
               from it, ``router_tol`` its router logits' largest distance
               from those of the plain forward that follows its expert
               choices (``routing``). Then the rows step
               (``run_moe_rows``): the paged bf16 chunked engine, prefix
               cache off, serves the tool-use workload's first turn (4
               prompts as the service renders them, queued, 32 greedy
               tokens, chunks eager) at ``prefill_batch`` 2 under
               ``SWARMDB_PREFILL_ROWS=0`` (rows [2]) and at 8 under "1"
               (the ladder 1, 2, 4, 8); its ``rows`` line gives per
               setting the row buckets, each wave's rows, TTFT, decode
               tokens/s and kernel 2's launches. Each serve is held as
               the ep pods are: every step's logprob and greedy pick
               within twice the reference's ``tol`` of the plain forward
               that replays its waves and steps following its expert
               choices (``moe_plain_steps(waves=)``).
9. ep     -- the single program over Mixtral's axes, and pipeline and
               sequence parallelism, on two ``--ep-child`` processes on
               ``cuda:0`` over gloo (one spawn, after the mixtral phase
               freed its weights). (a) Mixtral-8x7B at full width and the
               mixtral phase's 8 of 32 layers, each rank drawing every
               tensor from seed 0 and keeping its share, over an expert
               axis of 2 (4 experts a rank), a model axis of 2 (the JAX
               server pod's default mesh: heads, F and vocab halved) and a
               data axis of 2 (2 slots a rank, the MoE block counting the
               whole decode step and prefill wave), each the dense engine
               chunked serving the reference's prompts queued (rank 0;
               rank 1 replays): up to the batch's first parting from the
               reference serve, logprobs within twice its ``tol`` of the
               plain forward over the reference's tokens, and a near tie
               where they part (``batch_hold``; capacity couples a batch's
               rows, so later partings follow from the first). Then the
               ranks run the plain forward over their shares on the
               serve's own tokens, following the serve's expert choices on
               the expert and model axes (``routing``: bf16 sums split
               over a model axis tip near-tied routings, and a tipped
               routing moves every later step): every step's logprob and
               greedy pick of every request within twice ``tol`` of it
               (``forced_hold``), the router logits within twice
               ``router_tol`` of its own, the ranks' choices equal, and
               the choices the plain router would not make counted
               (``routing_stats``); every
               reply length / eos, kernel 7 on each rank,
               eager chunks (gloo), the scatter dispatch, and the
               collectives of one decode step per axis
               (``EP_STEP_COLLECTIVES``: 8 expert combines, Llama's 18,
               or 8 exchanges of expert choices). Prints per serve TTFT,
               tokens/s, init seconds, weights and peak memory per rank,
               one collective's ms alone (``ep_combine_ms``). (b)
               Llama-3-8B at full width and ``PP_LAYERS`` (8) layers:
               ``forward_pipelined`` over a pipe axis of 2 (4 layers a
               stage, the tp prompts as one [4, 420] batch, 2
               microbatches), ``forward_seq_parallel`` over a data axis of
               2 on one ``SP_TOKENS`` (4096)-token prompt, and
               ``ring_attention`` alone at Hq 32, Hkv 8, D 128 over that
               length; each against one rank's plain path (``forward``
               over the whole model and prompt; for ring attention the
               dense engine's prefill attention ``gqa_attention`` over the
               whole sequence), held within twice the plain bf16 path's
               own largest distance from the same path in f32, logits and
               K/V apart.

Then one ``{"kernels": [...]}`` line (launches summed over the six Llama
serves, the api, obs, prof, rolling, lanes and ha phases, the sanitize
phase's five sanitizers-on serves, the ckpt phase's serves of the loaded
weights, the tp phase's world-size-1 serve and both ranks' serves (its dp step's
too, its local step's rank 0, and its prefix step's on every rank), the
seven Mixtral serves and the ep phase's three
serves on both ranks, each
counted from zero
just before it and read just after; a graph replay adds the launches its
capture recorded; ``checked_ms`` is the bounds-checked build's time;
``smem_bytes``, ``smem_limit``, ``regs``, ``local_bytes``, ``spill_stores``
/ ``spill_loads`` the smem step's serving instance) and,
last,
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
PEAK_BF16_FLOPS = 989e12        # dense tensor cores, same data sheet


#: when this process started: every phase line carries the seconds since
#: (``t_s``), so a run's lines say where its time went
T_START = time.monotonic()


#: the phase of the last line printed: a new one is also named on
#: standard error, so that the end of that stream says how far a run came
_PHASE = [None]


def emit(phase: str, **fields) -> None:
    t_s = round(time.monotonic() - T_START, 1)
    if phase != _PHASE[0]:
        _PHASE[0] = phase
        print(f"chip_smoke: {phase} at {t_s} s", file=sys.stderr, flush=True)
    print(json.dumps({"phase": phase, "t_s": t_s, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ------------------------------------------------------------------ timing


def time_graph(fn, reps: int = 10, iters: int = 30) -> float:
    """Median device ms of one ``fn()`` call: ``reps`` calls captured in a
    CUDA graph (no host launch gaps), replayed ``iters`` times between
    CUDA events after warm-up."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_events(graph.replay, iters) / reps


def time_events(fn, iters: int = 30, warm: int = 3) -> float:
    """Median ms of one eager ``fn()`` call between CUDA events, after
    ``warm`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    return _median_events(fn, iters)


def _median_events(fn, iters: int) -> float:
    import torch

    pairs = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, flops: float) -> tuple:
    """(least ms the card could take for bf16 work, what bounds it)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_BF16_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------- kernel cases


HQ, HKV, D, PS, MAXP, NPAGES = 32, 8, 128, 16, 64, 769
LANE = MAXP * PS                                   # dense slot length
STARTS = [37, 300, 1000, 5, 513, 128, 777, 250]   # the decode slots


def page_args(pdt, dev, g):
    """K/V pages of the 769-page pool as the wrappers take them: plain
    pages in ``pdt``, or for ``torch.int8`` the port's quantization of
    the same draws (``k_pages``/``k_scale``/``v_pages``/``v_scale``)."""
    import torch

    from swarmdb_tpu_torch.ops.paged_kv import _quantize_pages

    kp = torch.randn(NPAGES, PS, HKV, D, generator=g)
    vp = torch.randn(NPAGES, PS, HKV, D, generator=g)
    if pdt == torch.int8:
        (kq, ks), (vq, vs) = _quantize_pages(kp), _quantize_pages(vp)
        return dict(k_pages=kq.to(dev), k_scale=ks.to(dev),
                    v_pages=vq.to(dev), v_scale=vs.to(dev))
    return dict(k_pages=kp.to(pdt).to(dev), v_pages=vp.to(pdt).to(dev))


def side_dtype(qdt, pdt):
    """The chunk buffer / packed suffix dtype of a case: the pages' for
    plain pages, the query's for int8 pages (their logical dtype is bf16;
    an f32 case keeps the whole check in f32)."""
    import torch

    return qdt if pdt == torch.int8 else pdt


def decode_case(qdt, pdt, dev, window=None):
    """The chunked decode step's inputs at the serving shape: 8 slots with
    mixed chunk starts, pages drawn from the 769-page pool, chunk of 8 at
    step 5."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(1)
    B, Kc, step = 8, 8, 5
    perm = torch.randperm(NPAGES - 1, generator=g)[:B * MAXP] + 1
    table = perm.reshape(B, MAXP).to(torch.int32)
    cdt = side_dtype(qdt, pdt)
    r = lambda dt, *s: torch.randn(*s, generator=g).to(dt).to(dev)
    return dict(q=r(qdt, B, HQ, D), **page_args(pdt, dev, g),
                page_table=table.to(dev), chunk_k=r(cdt, B, Kc, HKV, D),
                chunk_v=r(cdt, B, Kc, HKV, D),
                starts=torch.tensor(STARTS, dtype=torch.int32).to(dev),
                step=step, window=window)


def single_case(qdt, pdt, dev, window=None):
    """The single-step decode's inputs: the same slots, each attending its
    pages up to its position (lengths = start + 6, as after step 5)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(3)
    B = 8
    perm = torch.randperm(NPAGES - 1, generator=g)[:B * MAXP] + 1
    table = perm.reshape(B, MAXP).to(torch.int32)
    q = torch.randn(B, HQ, D, generator=g).to(qdt).to(dev)
    return dict(q=q, **page_args(pdt, dev, g), page_table=table.to(dev),
                lengths=torch.tensor([s + 6 for s in STARTS],
                                     dtype=torch.int32).to(dev),
                window=window)


def localized_case(c):
    """Decode case ``c`` as rank 1 of a data axis of two sees it: its
    pool is shard 1 of a 2-shard pool of 2 x 769 pages (global ids
    [769, 1538), 769 its trash page), its slots are 4-7, and their global
    table rows -- one of them a retired slot's, zeroed, and every row's
    entries past its pages zeroed too -- are localized as the engine
    localizes them (``Engine._localize``: clip(table - 769, 0, 768)), so
    each retired or zeroed entry reads local page 0."""
    import torch

    pl, rows = NPAGES, slice(4, 8)
    out = {k: (v[rows] if torch.is_tensor(v) and v.dim() and k not in (
        "k_pages", "k_scale", "v_pages", "v_scale") else v)
           for k, v in c.items()}
    table = c["page_table"][rows].long() + pl             # global ids
    ends = out.get("starts", out.get("lengths")).long() + 8
    cover = -(-ends // PS)
    past = torch.arange(MAXP, device=table.device)[None] >= cover[:, None]
    table = torch.where(past, torch.zeros_like(table), table)
    table[1] = 0                                         # a retired slot
    local = torch.clamp(table - pl, 0, pl - 1).to(torch.int32)
    if int(local.max()) >= pl or int((local == 0).sum()) < MAXP:
        fail("localized table: a foreign id or no retired row")
    out["page_table"] = local
    return out


def prefill_case(qdt, pdt, dev, window=None):
    """A 512-token ragged wave over 8 rows: prefix rows (96 and 512 cached
    tokens), a fresh row, a split row (its head already written, 250
    tokens), dead rows."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(2)
    R, W = 8, 512
    lens = torch.tensor([150, 0, 120, 130, 112, 0, 0, 0], dtype=torch.int32)
    plens = torch.tensor([96, 0, 0, 250, 512, 0, 0, 0], dtype=torch.int32)
    starts = torch.zeros(R, dtype=torch.int32)
    starts[1:] = torch.cumsum(lens, 0)[:-1].to(torch.int32)
    perm = torch.randperm(NPAGES - 1, generator=g)[:R * MAXP] + 1
    tables = perm.reshape(R, MAXP).to(torch.int32)
    sdt = side_dtype(qdt, pdt)
    r = lambda dt, *s: torch.randn(*s, generator=g).to(dt).to(dev)
    to = lambda t: t.to(dev)
    q, sk, sv = r(qdt, W, HQ, D), r(sdt, W, HKV, D), r(sdt, W, HKV, D)
    return dict(q=q, sfx_k=sk, sfx_v=sv, **page_args(pdt, dev, g),
                row_tables=to(tables), starts=to(starts), lens=to(lens),
                prefix_lens=to(plens), window=window)


def wide_prefill_case(qdt, pdt, dev, window=None):
    """A turn-1 wave of width 1024: four fresh rows of ~250 tokens, no
    prefix, four dead rows (the compute-heavy end of the prefill)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(8)
    R, W = 8, 1024
    lens = torch.tensor([250, 262, 241, 255, 0, 0, 0, 0], dtype=torch.int32)
    starts = torch.zeros(R, dtype=torch.int32)
    starts[1:] = torch.cumsum(lens, 0)[:-1].to(torch.int32)
    perm = torch.randperm(NPAGES - 1, generator=g)[:R * MAXP] + 1
    sdt = side_dtype(qdt, pdt)
    r = lambda dt, *s: torch.randn(*s, generator=g).to(dt).to(dev)
    return dict(q=r(qdt, W, HQ, D), sfx_k=r(sdt, W, HKV, D),
                sfx_v=r(sdt, W, HKV, D), **page_args(pdt, dev, g),
                row_tables=perm.reshape(R, MAXP).to(torch.int32).to(dev),
                starts=starts.to(dev), lens=lens.to(dev),
                prefix_lens=torch.zeros(R, dtype=torch.int32).to(dev),
                window=window)


#: Rows of query heads x tokens per block of the tensor-core prefill body
#: (csrc/ragged_prefill_mma.cuh): a query tile holds 64 // G tokens.
MMA_ROWS = 64


def prefill_sweep():
    """Sixteen waves that walk the prefill's edges, as (label, spec)
    pairs; ``sweep_case`` turns a spec into wrapper arguments. Specs name
    the GQA group G, the head dim, the KV heads, the table width (maxp
    pages of 16), the rows' lengths and prefix lengths, the stream width W
    and the window. Covered: row lengths 1, QT - 1, QT, QT + 1 (QT = 64 //
    G tokens per query tile) and a row filling the stream; prefixes ending
    mid-page, mid-tile and past the table's coverage; dead rows; W not a
    multiple of QT; windows of 1, below the 64-key tile and above the
    prefix; G 1 / 2 / 4 / 8; every head dim the body is built for (16, 32,
    64, 128), each in a wave the launch runs with one warp group per block
    and in one it runs with two."""
    import random

    def spec(G, Dh, Hkv, maxp, lens, plens, window, pad=3):
        return dict(G=G, D=Dh, Hkv=Hkv, maxp=maxp, lens=list(lens),
                    plens=list(plens), W=sum(lens) + pad, window=window)

    edges = lambda QT: [1, QT - 1, QT, QT + 1]
    waves = [
        ("g4_d128_edges", spec(4, 128, 8, 32, edges(16) + [0, 37],
                               [0, 24, 64, 100, 0, 1000], None)),
        ("g4_d128_edges_w1", spec(4, 128, 8, 32, edges(16) + [0, 37],
                                  [0, 24, 64, 100, 0, 1000], 1)),
        ("g1_d64_w40", spec(1, 64, 4, 32, edges(64) + [200],
                            [130, 0, 31, 512, 700], 40)),
        ("g8_d128_w700", spec(8, 128, 2, 40, edges(8) + [0, 0, 50],
                              [80, 5, 0, 640, 0, 0, 333], 700)),
        ("g4_d128_full_row", spec(4, 128, 8, 32, [300, 0, 0], [77, 0, 0],
                                  None, pad=0)),
        ("g8_d64_full_row_w1", spec(8, 64, 4, 16, [0, 203], [0, 256], 1,
                                    pad=0)),
        ("g2_d16_edges", spec(2, 16, 2, 16, edges(32) + [0, 45],
                              [0, 15, 16, 33, 0, 300], None)),
        ("g2_d16_full_row_w40", spec(2, 16, 8, 16, [0, 700], [0, 100], 40,
                                     pad=0)),
        ("g2_d32_w1", spec(2, 32, 4, 24, edges(32) + [150],
                           [17, 0, 200, 64, 500], 1)),
        ("g8_d32_full_row", spec(8, 32, 8, 16, [0, 700], [0, 100], None,
                                 pad=0)),
    ]
    rnd = random.Random(20)
    while len(waves) < 16:
        G, Dh = rnd.choice((1, 4, 8)), rnd.choice((64, 128))
        R, maxp = 8, rnd.choice((16, 32, 48))
        lens = [rnd.choice((0, 1, rnd.randint(2, 160))) for _ in range(R)]
        lens[rnd.randrange(R)] = rnd.randint(64 // G + 1, 200)
        plens = [rnd.choice((0, rnd.randint(1, maxp * 16),
                             maxp * 16 + rnd.randint(1, 300)))
                 for _ in range(R)]
        window = rnd.choice((None, 1, 40, 700))
        waves.append((f"random{len(waves)}_g{G}_d{Dh}",
                      spec(G, Dh, 32 // max(G, 4), maxp, lens, plens, window,
                           pad=rnd.randint(0, 20))))
    return waves


def sweep_case(sp, quant, dev, seed):
    """Wrapper arguments of one sweep wave: bf16 query and suffix over bf16
    pages, or over int8 pages (the port's quantization of the same draws)
    for ``quant``; each row's table a fresh draw of the pool's pages."""
    import torch

    from swarmdb_tpu_torch.ops.paged_kv import _quantize_pages

    g = torch.Generator(device="cpu").manual_seed(seed)
    G, Dh, Hkv, maxp = sp["G"], sp["D"], sp["Hkv"], sp["maxp"]
    R, W = len(sp["lens"]), sp["W"]
    lens = torch.tensor(sp["lens"], dtype=torch.int32)
    starts = torch.zeros(R, dtype=torch.int32)
    starts[1:] = torch.cumsum(lens, 0)[:-1].to(torch.int32)
    n_pages = R * maxp + 1
    tables = (torch.randperm(n_pages - 1, generator=g) + 1).reshape(R, maxp)
    r = lambda *s: torch.randn(*s, generator=g)
    bf = torch.bfloat16
    kp, vp = r(n_pages, PS, Hkv, Dh), r(n_pages, PS, Hkv, Dh)
    if quant:
        (kq, ks), (vq, vs) = _quantize_pages(kp), _quantize_pages(vp)
        pages = dict(k_pages=kq.to(dev), k_scale=ks.to(dev),
                     v_pages=vq.to(dev), v_scale=vs.to(dev))
    else:
        pages = dict(k_pages=kp.to(bf).to(dev), v_pages=vp.to(bf).to(dev))
    return dict(q=r(W, G * Hkv, Dh).to(bf).to(dev),
                sfx_k=r(W, Hkv, Dh).to(bf).to(dev),
                sfx_v=r(W, Hkv, Dh).to(bf).to(dev), **pages,
                row_tables=tables.to(torch.int32).to(dev),
                starts=starts.to(dev), lens=lens.to(dev),
                prefix_lens=torch.tensor(sp["plens"],
                                         dtype=torch.int32).to(dev),
                window=sp["window"])


def run_prefill_sweep(dev, name, sp_kernel, tol=2e-2):
    """The prefill kernel ``name`` against its plain version on every
    sweep wave; fails on an error above ``tol``. Returns the errors."""
    return {label: check_kernel(
                name, sp_kernel, sweep_case(sp, sp_kernel["quant"], dev,
                                            seed=100 + i), tol,
                f"sweep {label}")
            for i, (label, sp) in enumerate(prefill_sweep())}


#: Positions per key tile and cluster ranks per (slot, KV head) of the
#: decode body (csrc/decode.cuh): a slot's tiles go to the ranks in turn.
DECODE_KT, DECODE_SPLIT = 32, 8


def decode_sweep():
    """Waves that walk the decode body's edges, as (label, spec) pairs;
    ``decode_sweep_case`` turns a spec into the arguments of any of the six
    decode entry points. A spec names the GQA group G, the head dim, the
    KV heads, the table width (maxp pages of 16: the coverage, also the
    dense lanes' length), the slots' lengths (a single step's lengths, a
    chunked step's starts), the chunk (Kc entries, this step's index), the
    window and the page table's kind (``perm``: a permutation of the pool;
    ``repeat``: ids repeated within and across rows; ``wild``: ids below 0
    and past the pool, which the kernels clamp). Covered: lengths 0, 1, <
    KT, NS * KT, NS * KT + 1, at and past the coverage; slots shorter than
    NS tiles (empty ranks); windows of 1, below a tile and spanning several
    ranks; step 0 and Kc - 1; G 1 / 2 / 4 / 8; D 16 / 32 / 64 / 128; one
    slot, and a batch whose grid has more clusters than the H100 has SMs;
    repeated and out-of-range page ids."""
    import random

    def spec(G, Dh, Hkv, maxp, lens, Kc=8, step=5, window=None,
             table="perm"):
        return dict(G=G, D=Dh, Hkv=Hkv, maxp=maxp, lens=list(lens), Kc=Kc,
                    step=step, window=window, table=table)

    edges = [1, 17, 256, 257, 384, 400, 40, 0]   # coverage 24 * 16 = 384
    rnd = random.Random(21)
    waves = [
        ("g4_d128_lengths", spec(4, 128, 2, 24, edges, step=0)),
        ("g4_d128_w1_last_step", spec(4, 128, 2, 24, edges, step=7,
                                      window=1)),
        ("g1_d64_w20", spec(1, 64, 4, 20, [300, 33, 257, 320, 5], Kc=4,
                            step=3, window=20)),
        ("g8_d32_w200", spec(8, 32, 2, 24, [384, 256, 100, 500, 1], step=2,
                             window=200)),
        ("g2_d16_repeat", spec(2, 16, 4, 16, [256, 257, 31, 32, 200],
                               Kc=16, step=15, table="repeat")),
        ("g4_d64_wild", spec(4, 64, 2, 16, [256, 100, 3, 257], step=0,
                             table="wild")),
        ("b1_g4_d128_w96", spec(4, 128, 8, 64, [1006], window=96)),
        ("b20_g4_d64", spec(4, 64, 8, 20, [rnd.randint(1, 320)
                                           for _ in range(20)], step=3)),
        ("g8_d128_w1", spec(8, 128, 1, 32, [512, 7, 258], step=7,
                            window=1)),
        ("g2_d32_w33", spec(2, 32, 8, 8, [128, 129, 64, 0], Kc=4, step=0,
                            window=33)),
    ]
    while len(waves) < 14:
        G, Dh = rnd.choice((1, 2, 4, 8)), rnd.choice((16, 32, 64, 128))
        maxp, Kc = rnd.choice((8, 16, 40)), rnd.choice((4, 8, 16))
        cov = maxp * PS
        lens = [rnd.choice((0, 1, rnd.randint(2, cov), cov + 7,
                            DECODE_KT * rnd.randint(1, 9)))
                for _ in range(rnd.randint(1, 9))]
        waves.append((f"random{len(waves)}_g{G}_d{Dh}", spec(
            G, Dh, rnd.choice((1, 2, 4)), maxp, lens, Kc=Kc,
            step=rnd.randrange(Kc), window=rnd.choice((None, 1, 20, 300)),
            table=rnd.choice(("perm", "repeat", "wild")))))
    return waves


#: The six decode entry points: (paged, int8 pages, chunked).
DECODE_KINDS = {
    "paged_decode_chunked": (True, False, True),
    "paged_decode": (True, False, False),
    "paged_decode_chunked_quant": (True, True, True),
    "paged_decode_quant": (True, True, False),
    "dense_decode_chunked": (False, False, True),
    "dense_decode": (False, False, False),
}


def decode_sweep_case(sp, name, dt, dev, seed):
    """Arguments of decode entry point ``name`` on sweep wave ``sp``: query,
    chunk buffer and plain pages or lanes in ``dt`` (torch.bfloat16 or
    torch.float32), or int8 pages (the port's quantization of the same
    draws) for the ``_quant`` entry points."""
    import torch

    from swarmdb_tpu_torch.ops.paged_kv import _quantize_pages

    paged, quant, chunked = DECODE_KINDS[name]
    g = torch.Generator(device="cpu").manual_seed(seed)
    G, Dh, Hkv, maxp = sp["G"], sp["D"], sp["Hkv"], sp["maxp"]
    B, cov = len(sp["lens"]), maxp * PS
    r = lambda *s: torch.randn(*s, generator=g)
    to = lambda t, d=dt: t.to(d).to(dev)
    c = dict(q=to(r(B, G * Hkv, Dh)), window=sp["window"])
    if paged:
        n_pages = B * maxp + 1
        if sp["table"] == "repeat":
            table = torch.randint(1, 4, (B, maxp), generator=g)
        else:
            table = torch.randperm(n_pages - 1, generator=g) + 1
            table = table.reshape(B, maxp)
            if sp["table"] == "wild":
                table[:, ::3] = -5
                table[:, 1::4] = n_pages + 7
        kp, vp = r(n_pages, PS, Hkv, Dh), r(n_pages, PS, Hkv, Dh)
        if quant:
            (kq, ks), (vq, vs) = _quantize_pages(kp), _quantize_pages(vp)
            c.update(k_pages=kq.to(dev), k_scale=ks.to(dev),
                     v_pages=vq.to(dev), v_scale=vs.to(dev))
        else:
            c.update(k_pages=to(kp), v_pages=to(vp))
        c["page_table"] = to(table, torch.int32)
    else:
        c.update(cache_k=to(r(B, cov, Hkv, Dh)),
                 cache_v=to(r(B, cov, Hkv, Dh)))
    lens = to(torch.tensor(sp["lens"]), torch.int32)
    if chunked:
        Kc = sp["Kc"]
        c.update(chunk_k=to(r(B, Kc, Hkv, Dh)), chunk_v=to(r(B, Kc, Hkv, Dh)),
                 starts=lens, step=sp["step"])
    else:
        c["lengths"] = lens
    return c


def run_decode_sweep(dev, name, sp_kernel):
    """Decode entry point ``name`` against its plain version on every sweep
    wave, bf16 within 2e-2 and f32 within 1e-4 (int8 pages under a bf16
    or an f32 query); fails on a larger error. Returns the errors."""
    import torch

    errs = {}
    for i, (label, sp) in enumerate(decode_sweep()):
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            key = f"{label}_{str(dt)[6:]}"
            errs[key] = check_kernel(
                name, sp_kernel, decode_sweep_case(sp, name, dt, dev,
                                                   seed=200 + i),
                tol, f"sweep {key}")
    return errs


def check_kernel(name, sp, c, tol, key):
    """Kernel ``name`` against its plain version on case ``c``: fails if
    the output's dtype is not the query's or the largest absolute error is
    above ``tol``; returns the error."""
    import torch

    got = sp["kernel"](**c)
    want = sp["plain"](**c)
    torch.cuda.synchronize()
    if got.dtype != c["q"].dtype:
        fail(f"{name} {key}: output {got.dtype}, query {c['q'].dtype}")
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        fail(f"{name} {key}: max abs err {err} > {tol}")
    return err


def dense_chunked_case(qdt, cdt, dev, window=None, heads=(HQ, HKV)):
    """The dense chunked decode step at the serving shape: 8 slots of a
    [8, 1024, 8, 128] slot cache with the same chunk starts (each lane
    full of draws past its start: a prefill's padding garbage), chunk of
    8 at step 5. ``heads`` (Hq, Hkv): (16, 4) is one rank's share of the
    tp phase's model axis of two."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(4)
    B, Kc, step = 8, 8, 5
    hq, hkv = heads
    r = lambda dt, *s: torch.randn(*s, generator=g).to(dt).to(dev)
    return dict(q=r(qdt, B, hq, D), cache_k=r(cdt, B, LANE, hkv, D),
                cache_v=r(cdt, B, LANE, hkv, D),
                chunk_k=r(cdt, B, Kc, hkv, D), chunk_v=r(cdt, B, Kc, hkv, D),
                starts=torch.tensor(STARTS, dtype=torch.int32).to(dev),
                step=step, window=window)


def dense_single_case(qdt, cdt, dev, window=None, heads=(HQ, HKV)):
    """The dense single-step decode: the same slots, each attending its
    lane up to its position (lengths = start + 6, as after step 5).
    ``heads`` as in ``dense_chunked_case``."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(5)
    B = 8
    hq, hkv = heads
    r = lambda dt, *s: torch.randn(*s, generator=g).to(dt).to(dev)
    return dict(q=r(qdt, B, hq, D), cache_k=r(cdt, B, LANE, hkv, D),
                cache_v=r(cdt, B, LANE, hkv, D),
                lengths=torch.tensor([s + 6 for s in STARTS],
                                     dtype=torch.int32).to(dev),
                window=window)


def _nbytes(t):
    return t.numel() * t.element_size()


def _lane_rows_bytes(c, positions):
    """Bytes of ``positions`` K and V rows of the case's dense lanes."""
    return sum(positions) * HKV * D * c["cache_k"].element_size() * 2


def _page_rows_bytes(c, positions):
    """Bytes of ``positions`` K and V rows of the case's pages, plus the
    scale rows of the pages they lie in (int8 pools)."""
    kp = c["k_pages"]
    rows = sum(positions) * HKV * D * kp.element_size() * 2
    if "k_scale" in c:
        pages = sum(-(-p // PS) for p in positions)
        rows += pages * HKV * c["k_scale"].element_size() * 2
    return rows


def decode_work(c):
    B = c["q"].shape[0]
    keys = sum(c["starts"].tolist()) + B * (c["step"] + 1)
    chunk_rows = B * (c["step"] + 1) * HKV * D * c["chunk_k"].element_size()
    nbytes = (2 * _nbytes(c["q"])                       # q in, out
              + _page_rows_bytes(c, c["starts"].tolist())
              + 2 * chunk_rows
              + _nbytes(c["page_table"]) + _nbytes(c["starts"]))
    return nbytes, 4.0 * HQ * D * keys


def single_work(c):
    lengths = c["lengths"].tolist()
    nbytes = (2 * _nbytes(c["q"]) + _page_rows_bytes(c, lengths)
              + _nbytes(c["page_table"]) + _nbytes(c["lengths"]))
    return nbytes, 4.0 * HQ * D * sum(lengths)


def dense_chunked_work(c):
    B = c["q"].shape[0]
    keys = sum(c["starts"].tolist()) + B * (c["step"] + 1)
    chunk_rows = B * (c["step"] + 1) * HKV * D * c["chunk_k"].element_size()
    nbytes = (2 * _nbytes(c["q"]) + _lane_rows_bytes(c, c["starts"].tolist())
              + 2 * chunk_rows + _nbytes(c["starts"]))
    return nbytes, 4.0 * HQ * D * keys


def dense_single_work(c):
    lengths = c["lengths"].tolist()
    nbytes = (2 * _nbytes(c["q"]) + _lane_rows_bytes(c, lengths)
              + _nbytes(c["lengths"]))
    return nbytes, 4.0 * HQ * D * sum(lengths)


def prefill_work(c):
    lens = c["lens"].tolist()
    plens = c["prefix_lens"].tolist()
    keys = sum(n * p + n * (n + 1) // 2 for n, p in zip(lens, plens))
    nbytes = (2 * _nbytes(c["q"]) + _nbytes(c["sfx_k"]) + _nbytes(c["sfx_v"])
              + _page_rows_bytes(c, [p for p, n in zip(plens, lens) if n])
              + _nbytes(c["row_tables"]) + 3 * len(lens) * 4)
    return nbytes, 4.0 * HQ * D * keys


def dense_pages(c):
    """The case with int8 pages replaced by their dequantized values in
    the query's dtype (what one library call would read); plain pages as
    they are."""
    from swarmdb_tpu_torch.ops.paged_kv import _dequantize_pages

    if "k_scale" not in c:
        return c
    out = {k: v for k, v in c.items() if k not in ("k_scale", "v_scale")}
    for x in "kv":
        out[f"{x}_pages"] = _dequantize_pages(
            c[f"{x}_pages"], c[f"{x}_scale"]).to(c["q"].dtype)
    return out


def decode_library(c):
    """SDPA over the gathered dense view: pages + chunk buffer per slot,
    a boolean mask for the live positions (the gather is done here, once,
    outside the timed call)."""
    import torch

    from swarmdb_tpu_torch.ops.paged_kv import paged_gather_kv

    c = dense_pages(c)
    kg, vg = paged_gather_kv(c["k_pages"], c["v_pages"], c["page_table"])
    k = torch.cat([kg, c["chunk_k"].to(kg.dtype)], 1)   # [B, S+Kc, Hkv, D]
    v = torch.cat([vg, c["chunk_v"].to(vg.dtype)], 1)
    S = kg.shape[1]
    Kc = c["chunk_k"].shape[1]
    pos = torch.arange(S + Kc, device=k.device)
    st = c["starts"].long()[:, None]
    live = torch.where(pos < S, pos[None] < st, pos[None] - S <= c["step"])
    return _sdpa_decode(c["q"], k, v, live)


def single_library(c):
    """SDPA over the gathered dense pages, masked to each slot's length."""
    import torch

    from swarmdb_tpu_torch.ops.paged_kv import paged_gather_kv

    c = dense_pages(c)
    k, v = paged_gather_kv(c["k_pages"], c["v_pages"], c["page_table"])
    pos = torch.arange(k.shape[1], device=k.device)
    return _sdpa_decode(c["q"], k, v,
                        pos[None] < c["lengths"].long()[:, None])


def dense_chunked_library(c):
    """SDPA straight over each slot's lane plus its chunk buffer (the
    concatenation is done here, once, outside the timed call), masked to
    positions < start and chunk entries <= step."""
    import torch

    k = torch.cat([c["cache_k"], c["chunk_k"].to(c["cache_k"].dtype)], 1)
    v = torch.cat([c["cache_v"], c["chunk_v"].to(c["cache_v"].dtype)], 1)
    Kc = c["chunk_k"].shape[1]
    pos = torch.arange(LANE + Kc, device=k.device)
    st = c["starts"].long()[:, None]
    live = torch.where(pos < LANE, pos[None] < st,
                       pos[None] - LANE <= c["step"])
    return _sdpa_decode(c["q"], k, v, live)


def dense_single_library(c):
    """SDPA straight over the lanes (no gather), masked to each slot's
    length."""
    import torch

    pos = torch.arange(LANE, device=c["q"].device)
    return _sdpa_decode(c["q"], c["cache_k"], c["cache_v"],
                        pos[None] < c["lengths"].long()[:, None])


def _sdpa_decode(q, k, v, live):
    import torch.nn.functional as F

    G = HQ // HKV
    q = q[:, :, None]                                   # [B, Hq, 1, D]
    k = k.transpose(1, 2).repeat_interleave(G, 1).contiguous()
    v = v.transpose(1, 2).repeat_interleave(G, 1).contiguous()
    mask = live[:, None, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def prefill_library(c):
    """SDPA over a dense [rows, Hq, L, S] view of the wave: each live row's
    prefix keys then its suffix keys, a causal-plus-prefix mask."""
    import torch
    import torch.nn.functional as F

    c = dense_pages(c)
    lens = c["lens"].tolist()
    plens = c["prefix_lens"].tolist()
    starts = c["starts"].tolist()
    rows = [r for r, n in enumerate(lens) if n]
    Lm = max(lens[r] for r in rows)
    Sm = max(plens[r] + lens[r] for r in rows)
    dev, dt = c["q"].device, c["q"].dtype
    G = HQ // HKV
    q = torch.zeros(len(rows), HQ, Lm, D, device=dev, dtype=dt)
    k = torch.zeros(len(rows), HQ, Sm, D, device=dev, dtype=dt)
    v = torch.zeros_like(k)
    mask = torch.zeros(len(rows), 1, Lm, Sm, device=dev, dtype=torch.bool)
    for i, r in enumerate(rows):
        n, p, s = lens[r], plens[r], starts[r]
        pages = c["row_tables"][r, :(p + PS - 1) // PS].long()
        pk = c["k_pages"][pages].reshape(-1, HKV, D)[:p].to(dt)
        pv = c["v_pages"][pages].reshape(-1, HKV, D)[:p].to(dt)
        kk = torch.cat([pk, c["sfx_k"][s:s + n].to(dt)]).transpose(0, 1)
        vv = torch.cat([pv, c["sfx_v"][s:s + n].to(dt)]).transpose(0, 1)
        q[i, :, :n] = c["q"][s:s + n].transpose(0, 1)
        k[i, :, :p + n] = kk.repeat_interleave(G, 0)
        v[i, :, :p + n] = vv.repeat_interleave(G, 0)
        qi = torch.arange(n, device=dev)[:, None]
        kj = torch.arange(Sm, device=dev)[None]
        mask[i, 0, :n] = kj <= p + qi
    mask[:, :, :, 0] |= True   # padded query rows: keep softmax finite
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def kernel_specs():
    """The eight kernels: wrapper, plain version, case, work, library
    call, source and the TPU kernel each replaces."""
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    pallas = "swarmdb_tpu/ops/attention_pallas.py"
    csrc = "swarmdb_tpu_torch/csrc"
    pre = dict(case=prefill_case, work=prefill_work, library=prefill_library)
    chk = dict(case=decode_case, work=decode_work, library=decode_library)
    one = dict(case=single_case, work=single_work, library=single_library)
    dchk = dict(case=dense_chunked_case, work=dense_chunked_work,
                library=dense_chunked_library)
    done = dict(case=dense_single_case, work=dense_single_work,
                library=dense_single_library)
    return {
        "ragged_prefill": dict(
            pre, quant=False, kernel=ac.ragged_paged_prefill_attention,
            plain=ac.ragged_prefill_plain,
            source=f"{csrc}/ragged_prefill.cu", replaces=f"{pallas}:356"),
        "paged_decode_chunked": dict(
            chk, quant=False, kernel=ac.paged_decode_gqa_attention_chunked,
            plain=ac.paged_decode_chunked_plain,
            source=f"{csrc}/paged_decode_chunked.cu",
            replaces=f"{pallas}:211"),
        "paged_decode": dict(
            one, quant=False, kernel=ac.paged_decode_gqa_attention,
            plain=ac.paged_decode_plain, source=f"{csrc}/paged_decode.cu",
            replaces=f"{pallas}:180"),
        "ragged_prefill_quant": dict(
            pre, quant=True, kernel=ac.ragged_paged_prefill_attention_quant,
            plain=ac.ragged_prefill_quant_plain,
            source=f"{csrc}/ragged_prefill_quant.cu",
            replaces=f"{pallas}:909"),
        "paged_decode_chunked_quant": dict(
            chk, quant=True,
            kernel=ac.paged_decode_gqa_attention_chunked_quant,
            plain=ac.paged_decode_chunked_quant_plain,
            source=f"{csrc}/paged_decode_chunked_quant.cu",
            replaces=f"{pallas}:791"),
        "paged_decode_quant": dict(
            one, quant=True, kernel=ac.paged_decode_gqa_attention_quant,
            plain=ac.paged_decode_quant_plain,
            source=f"{csrc}/paged_decode_quant.cu",
            replaces=f"{pallas}:696"),
        "dense_decode_chunked": dict(
            dchk, quant=False, kernel=ac.decode_gqa_attention_chunked,
            plain=ac.decode_chunked_plain,
            source=f"{csrc}/dense_decode_chunked.cu",
            replaces=f"{pallas}:513"),
        "dense_decode": dict(
            done, quant=False, kernel=ac.decode_gqa_attention,
            plain=ac.decode_plain, source=f"{csrc}/dense_decode.cu",
            replaces=f"{pallas}:43"),
    }


def run_kernels(dev):
    """Each kernel against its plain version (every dtype case, with and
    without a window), then timed in bf16 beside its plain version, one
    library call and its bound."""
    import torch

    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    rows = {}
    for name, sp in kernel_specs().items():
        checks = ([(bf, i8, 2e-2), (f32, i8, 1e-4)] if sp["quant"] else
                  [(bf, bf, 2e-2), (f32, f32, 1e-4), (f32, bf, 2e-2)])
        errs = {}
        for qdt, pdt, tol in checks:
            for window in (None, 96):
                key = f"q{str(qdt)[6:]}_p{str(pdt)[6:]}_w{window or 0}"
                errs[key] = check_kernel(
                    name, sp, sp["case"](qdt, pdt, dev, window), tol, key)
        if sp["case"] in (dense_chunked_case, dense_single_case):
            # one rank's heads on the tp phase's model axis of two
            for qdt, pdt, tol in checks:
                key = f"hq16_hkv4_q{str(qdt)[6:]}_p{str(pdt)[6:]}"
                errs[key] = check_kernel(
                    name, sp, sp["case"](qdt, pdt, dev, heads=(16, 4)),
                    tol, key)
        if sp["case"] in (decode_case, single_case) and not sp["quant"]:
            # a data rank's view: its slots over its sub-pool of a
            # 2-shard pool, the table localized
            for qdt, pdt, tol in checks:
                key = f"dp_localized_q{str(qdt)[6:]}_p{str(pdt)[6:]}"
                errs[key] = check_kernel(
                    name, sp, localized_case(sp["case"](qdt, pdt, dev)),
                    tol, key)
        prefill = sp["case"] is prefill_case
        if prefill:
            errs["sweep"] = run_prefill_sweep(dev, name, sp)
        else:
            errs["sweep"] = run_decode_sweep(dev, name, sp)
        pdt = i8 if sp["quant"] else bf
        rows[name] = time_kernel(name, sp, sp["case"](bf, pdt, dev), errs)
        if prefill:
            c = wide_prefill_case(bf, pdt, dev)
            key = f"qbfloat16_p{str(pdt)[6:]}_w0"
            wide = {key: check_kernel(name, sp, c, 2e-2, f"w1024 {key}")}
            time_kernel(name, sp, c, wide, shape="w1024_turn1")
        if name == "paged_decode":
            time_decode_lengths(dev, sp)
    return rows


def time_decode_lengths(dev, sp):
    """The bf16 single-step paged decode with all 8 slots at one length: 0
    (no live key: launch, cluster and merge alone), one key tile, one tile
    per cluster rank, four per rank (the table's whole coverage); each
    checked against the plain version, timed and emitted beside its bound
    in one ``decode_lengths`` line -- a call's fixed cost and its cost per
    tile."""
    import torch

    bf = torch.bfloat16
    out = {}
    for n in (0, DECODE_KT, DECODE_SPLIT * DECODE_KT, LANE):
        c = single_case(bf, bf, dev)
        c["lengths"] = torch.full_like(c["lengths"], n)
        err = check_kernel("paged_decode", sp, c, 2e-2, f"length {n}")
        out[f"L{n}"] = dict(ms=time_graph(lambda: sp["kernel"](**c)),
                            bound_ms=bound(*single_work(c))[0],
                            max_abs_err=err)
    emit("decode_lengths", kernel="paged_decode", **out)


def time_kernel(name, sp, c, errs, shape="serving"):
    """One kernel timed on case ``c`` beside its plain version, one library
    call and its bound; emits a ``kernels`` line and returns the kernel's
    row of the final ``{"kernels": [...]}`` line."""
    nbytes, flops = sp["work"](c)
    b_ms, b_by = bound(nbytes, flops)
    ms = time_graph(lambda: sp["kernel"](**c))
    plain_ms = time_events(lambda: sp["plain"](**c), iters=20)
    library_ms = time_graph(sp["library"](c))
    emit("kernels", kernel=name, shape=shape, errors=errs, ms=ms,
         plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
         bound_by=b_by, bytes=nbytes, flops=flops)
    return {
        "name": name, "route": "cuda", "source": sp["source"],
        "replaces": sp["replaces"], "launches": 0,
        "max_abs_err": errs[next(iter(errs))] if errs else None, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms}


# ------------------------------------------------------------------ parity


#: (name, cache dtype, chunked, logits bound, paged). An f32 pool or slot
#: cache holds 1e-4 (float32 sums in another order; the chunked step
#: there uses an f32 chunk buffer). A bf16 pool: the plain version
#: rounds the softmax weights to the pages' bf16 before the value product,
#: the kernels keep them in fp32 (the Pallas kernels' way); emulated on the
#: CPU this moves tiny-debug's logits by up to 1.4e-2. An int8 pool dequan-
#: tizes to f32 on both sides, but the packed suffix and the chunk buffer
#: are bf16, whose weights the plain version rounds (up to 3.5e-3 emulated),
#: and a K/V value that differs by float32 rounding between the card's and
#: the CPU's matmuls can flip one int8 code (amax / 127 of its page) where a
#: write requantizes a page.
PARITY_CASES = (("f32_chunked", "float32", True, 1e-4, True),
                ("f32_single_step", "float32", False, 1e-4, True),
                ("bf16_single_step", "bfloat16", False, 3e-2, True),
                ("int8_chunked", "int8", True, 2e-2, True),
                ("int8_single_step", "int8", False, 2e-2, True),
                ("dense_f32_chunked", "float32", True, 1e-4, False),
                ("dense_f32_single_step", "float32", False, 1e-4, False))


@contextlib.contextmanager
def env_scope(**values):
    """Environment variables set (a value of None: unset) for the block,
    restored after it."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def engine_env(chunked: bool, **values):
    """SWARMDB_CHUNKED set, and SWARMDB_PAGED unset, while an engine is
    built (both are read there), with any further ``values``."""
    return env_scope(SWARMDB_CHUNKED="1" if chunked else "0",
                     SWARMDB_PAGED=None, **values)


def parity_logits(p, cfg, d, kind, chunked):
    """Logits of one prefill wave and of decode steps (one chunked step
    with an f32 chunk buffer, or three single steps that write the pool)
    from the same seeded pool, on device ``d``."""
    import numpy as np
    import torch

    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.ops.paged_kv import QuantPool, _quantize_pages

    rng = np.random.default_rng(6)
    W, ps, maxp = 96, 16, 16
    toks = torch.from_numpy(rng.integers(3, 259, W).astype(np.int32))
    tok_row = torch.zeros(W, dtype=torch.int32)
    tok_row[60:] = 1
    tok_pos = torch.cat([torch.arange(60), torch.arange(36) + 20]).int()
    tables = torch.arange(1, 2 * maxp + 1, dtype=torch.int32).reshape(2, -1)
    starts = torch.tensor([0, 60], dtype=torch.int32)
    lens = torch.tensor([60, 36], dtype=torch.int32)
    plens = torch.tensor([0, 20], dtype=torch.int32)
    shape = (cfg.n_layers, 2 * maxp + 1, ps, cfg.n_kv_heads, cfg.head_dim)
    t = lambda x: x.to(d)

    def pools():
        kf, vf = (torch.randn(shape, generator=torch.Generator().manual_seed(
            s)) for s in (3, 13))
        if kind == "int8":
            return tuple(QuantPool(*map(t, _quantize_pages(x)))
                         for x in (kf, vf))
        return tuple(t(x.to(getattr(torch, kind))) for x in (kf, vf))

    kp, vp = pools()
    out = [llama.forward_ragged_prefill(
        p, cfg, t(toks), t(tok_row), t(tok_pos), t(tables), t(starts),
        t(lens), t(plens), kp, vp)[0]]
    kp, vp = pools()
    cache = {"k": kp, "v": vp, "page_table": t(tables)}
    if chunked:
        hk = torch.randn((cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.head_dim),
                         generator=torch.Generator().manual_seed(4))
        out.append(llama.forward_paged_chunked(
            p, cfg, t(toks[:2, None].long()), t(torch.tensor([[70], [90]])),
            cache, (t(hk), t(hk.clone())), 3)[0])
    else:
        for s in range(3):
            logits, cache = llama.forward_paged(
                p, cfg, t(toks[s:s + 2, None].long()),
                t(torch.tensor([[70 + s], [90 + s]])), cache)
            out.append(logits)
    return [x.cpu() for x in out]


def dense_parity_logits(p, cfg, d, chunked):
    """Logits of one bucketed dense prefill (two rows, the head at each
    row's last token) and of decode steps over a seeded f32 slot cache
    (one chunked step with an f32 chunk buffer, or three single steps that
    write the cache), on device ``d``."""
    import numpy as np
    import torch

    from swarmdb_tpu_torch.models import llama

    rng = np.random.default_rng(7)
    T, S = 64, 128
    toks = torch.from_numpy(rng.integers(3, 259, (2, T)).astype(np.int32))
    pos = torch.arange(T, dtype=torch.int32).expand(2, T)
    t = lambda x: x.to(d)
    temp = llama.init_kv_cache(cfg, 2, T, torch.float32, device=d)
    out = [llama.forward(p, cfg, t(toks), t(pos), temp,
                         logits_at=t(torch.tensor([T - 1, 40])))[0]]
    shape = (cfg.n_layers, 2, S, cfg.n_kv_heads, cfg.head_dim)
    cache = tuple(t(torch.randn(shape, generator=torch.Generator()
                                .manual_seed(s))) for s in (3, 13))
    if chunked:
        hk = torch.randn((cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.head_dim),
                         generator=torch.Generator().manual_seed(4))
        out.append(llama.forward_chunked(
            p, cfg, t(toks[:, :1]), t(torch.tensor([[70], [90]])), cache,
            (t(hk), t(hk.clone())), 3)[0])
    else:
        for s in range(3):
            logits, cache = llama.forward(
                p, cfg, t(toks[:, s:s + 1]),
                t(torch.tensor([[70 + s], [90 + s]])), cache)
            out.append(logits)
    return [x.cpu() for x in out]


def path_kernels(kind: str, chunked: bool, paged: bool,
                 ragged: bool = True) -> tuple:
    """The kernels an engine runs. Paged, over a ``kind`` pool: ragged
    prefill at admission (Llama; Mixtral's row-bucketed and prefix waves
    attend in plain PyTorch, as in the JAX package), then chunked or
    single-step decode. Dense: the dense decode kernel only (its prefill
    attention is plain PyTorch, as in the JAX package)."""
    if not paged:
        return ("dense_decode_chunked" if chunked else "dense_decode",)
    quant = "_quant" if kind == "int8" else ""
    decode = "paged_decode_chunked" if chunked else "paged_decode"
    return (("ragged_prefill" + quant,) if ragged else ()) + (decode + quant,)


#: (name, paged, chunked, SWARMDB_MOE_DISPATCH): tiny-moe in f32 served on
#: the card and on the CPU through both engines (logits within 1e-4, like
#: the f32 Llama cases), the last case with the einsum dispatch form.
MOE_PARITY_CASES = (("moe_dense_f32_chunked", False, True, "scatter"),
                    ("moe_dense_f32_single_step", False, False, "scatter"),
                    ("moe_paged_f32_chunked", True, True, "scatter"),
                    ("moe_paged_f32_single_step", True, False, "scatter"),
                    ("moe_paged_f32_chunked_einsum", True, True, "einsum"))


def moe_parity_logits(p, cfg, d, paged, chunked, dispatch):
    """tiny-moe logits on device ``d``: a bucketed prefill (two rows, the
    head at each row's last token; a padded row whose padding takes
    capacity), then, paged, a prefix wave over a seeded f32 pool and
    decode steps over it (one chunked step with an f32 chunk buffer, or
    three single steps that write the pool); dense, decode steps over a
    seeded f32 slot cache."""
    import numpy as np
    import torch

    from swarmdb_tpu_torch.models import mixtral

    rng = np.random.default_rng(9)
    T, ps, maxp = 64, 16, 16
    toks = torch.from_numpy(rng.integers(3, 259, (2, T)).astype(np.int32))
    toks[1, 41:] = 0
    pos = torch.arange(T, dtype=torch.int32).expand(2, T)
    t = lambda x: x.to(d)
    temp = mixtral.init_kv_cache(cfg, 2, T, torch.float32, device=d)
    out = [mixtral.forward(p, cfg, t(toks), t(pos), temp,
                           logits_at=t(torch.tensor([T - 1, 40])),
                           moe_dispatch=dispatch)[0]]
    hk = torch.randn((cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.head_dim),
                     generator=torch.Generator().manual_seed(4))
    chunk = (t(hk), t(hk.clone()))
    if paged:
        shape = (cfg.n_layers, 2 * maxp + 1, ps, cfg.n_kv_heads,
                 cfg.head_dim)
        kp, vp = (t(torch.randn(shape, generator=torch.Generator()
                                .manual_seed(s))) for s in (3, 13))
        tables = t(torch.arange(1, 2 * maxp + 1, dtype=torch.int32)
                   .reshape(2, -1))
        out.append(mixtral.forward_prefix_pages(
            p, cfg, t(toks[:, :24]), tables[:, :4],
            t(torch.tensor([32, 48], dtype=torch.int32)), kp, vp,
            logits_at=t(torch.tensor([23, 10])), moe_dispatch=dispatch)[0])
        cache = {"k": kp, "v": vp, "page_table": tables}
        if chunked:
            out.append(mixtral.forward_paged_chunked(
                p, cfg, t(toks[:, :1].long()), t(torch.tensor([[70], [90]])),
                cache, chunk, 3, moe_dispatch=dispatch)[0])
        else:
            for s in range(3):
                logits, cache = mixtral.forward_paged(
                    p, cfg, t(toks[:, s:s + 1].long()),
                    t(torch.tensor([[70 + s], [90 + s]])), cache,
                    moe_dispatch=dispatch)
                out.append(logits)
        return [x.cpu() for x in out]
    shape = (cfg.n_layers, 2, 128, cfg.n_kv_heads, cfg.head_dim)
    cache = tuple(t(torch.randn(shape, generator=torch.Generator()
                                .manual_seed(s))) for s in (3, 13))
    if chunked:
        out.append(mixtral.forward_chunked(
            p, cfg, t(toks[:, :1]), t(torch.tensor([[70], [90]])), cache,
            chunk, 3, moe_dispatch=dispatch)[0])
    else:
        for s in range(3):
            logits, cache = mixtral.forward(
                p, cfg, t(toks[:, s:s + 1]),
                t(torch.tensor([[70 + s], [90 + s]])), cache,
                moe_dispatch=dispatch)
            out.append(logits)
    return [x.cpu() for x in out]


def run_parity(dev):
    """tiny-debug f32: the same weights served on the card and on the CPU,
    over each engine, cache kind and decode mode of ``PARITY_CASES``."""
    import numpy as np
    import torch

    from swarmdb_tpu_torch.backend.sampling import SamplingParams
    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("tiny-debug")
    p_cpu = llama.init_params(cfg, seed=11, device="cpu", dtype=torch.float32)
    p_gpu = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in p_cpu.items()}
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 259, n).tolist() for n in (40, 9, 200, 77)]
    for name, kind, chunked, tol, paged in PARITY_CASES:
        kv = getattr(torch, kind)
        engines = {}
        with engine_env(chunked):
            for where, d, p in (("gpu", dev, p_gpu), ("cpu", "cpu", p_cpu)):
                engines[where], _ = build_backend_engine(
                    "tiny-debug", max_batch=4, max_seq=256, device=d,
                    params=p, kv_dtype=kv, paged=paged)
                engines[where].start()
        ac.reset_launches()
        try:
            for pr in prompts:
                a = engines["gpu"].generate_sync(pr, SamplingParams(
                    max_new_tokens=16))
                b = engines["cpu"].generate_sync(pr, SamplingParams(
                    max_new_tokens=16))
                if a != b:
                    fail(f"parity {name}: greedy tokens differ card vs "
                         f"cpu: {a} {b}")
        finally:
            for e in engines.values():
                e.stop()
        launches = {k: n for k, n in ac.LAUNCHES.items() if n}
        if set(launches) != set(path_kernels(kind, chunked, paged)):
            fail(f"parity {name}: the card engine launched {launches}")
        outs = {where: (parity_logits(p, cfg, d, kind, chunked) if paged
                        else dense_parity_logits(p, cfg, d, chunked))
                for where, d, p in (("gpu", dev, p_gpu),
                                    ("cpu", "cpu", p_cpu))}
        errs = [float((a - b).abs().max())
                for a, b in zip(outs["gpu"], outs["cpu"])]
        if max(errs) > tol:
            fail(f"parity {name}: logits card vs cpu differ by {errs} > "
                 f"{tol}")
        emit("parity", case=name, cache=kind, paged=paged, chunked=chunked,
             prompts=len(prompts), greedy_equal=True,
             prefill_logits_max_abs_err=errs[0],
             decode_logits_max_abs_err=max(errs[1:]), bound=tol,
             launches=launches)
    run_moe_parity(dev, prompts)
    run_binding_parity(dev)
    run_rolling_parity(dev)


def run_moe_parity(dev, prompts):
    """tiny-moe f32 (``MOE_PARITY_CASES``): the same weights served on the
    card and on the CPU, greedy tokens equal, only the decode kernel of
    the path launched (tiny-moe has no ragged prefill), logits within
    1e-4."""
    import torch

    from swarmdb_tpu_torch.backend.sampling import SamplingParams
    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.models import mixtral
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    cfg, tol = get_config("tiny-moe"), 1e-4
    p_cpu = mixtral.init_params(cfg, seed=11, device="cpu",
                                dtype=torch.float32)
    p_gpu = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in p_cpu.items()}
    old = os.environ.get("SWARMDB_MOE_DISPATCH")
    for name, paged, chunked, dispatch in MOE_PARITY_CASES:
        os.environ["SWARMDB_MOE_DISPATCH"] = dispatch
        engines = {}
        with engine_env(chunked):
            for where, d, p in (("gpu", dev, p_gpu), ("cpu", "cpu", p_cpu)):
                engines[where], _ = build_backend_engine(
                    "tiny-moe", max_batch=4, max_seq=256, device=d,
                    params=p, kv_dtype=torch.float32, paged=paged)
                engines[where].start()
        ac.reset_launches()
        try:
            for pr in prompts:
                a = engines["gpu"].generate_sync(pr, SamplingParams(
                    max_new_tokens=16))
                b = engines["cpu"].generate_sync(pr, SamplingParams(
                    max_new_tokens=16))
                if a != b:
                    fail(f"parity {name}: greedy tokens differ card vs "
                         f"cpu: {a} {b}")
        finally:
            for e in engines.values():
                e.stop()
        launches = {k: n for k, n in ac.LAUNCHES.items() if n}
        want = path_kernels("float32", chunked, paged, ragged=False)
        if set(launches) != set(want):
            fail(f"parity {name}: the card engine launched {launches}")
        outs = {where: moe_parity_logits(p, cfg, d, paged, chunked, dispatch)
                for where, d, p in (("gpu", dev, p_gpu),
                                    ("cpu", "cpu", p_cpu))}
        errs = [float((a - b).abs().max())
                for a, b in zip(outs["gpu"], outs["cpu"])]
        if max(errs) > tol:
            fail(f"parity {name}: logits card vs cpu differ by {errs} > "
                 f"{tol}")
        emit("parity", case=name, model="tiny-moe", cache="float32",
             paged=paged, chunked=chunked, moe_dispatch=dispatch,
             prompts=len(prompts), greedy_equal=True,
             prefill_logits_max_abs_err=errs[0],
             prefix_logits_max_abs_err=errs[1] if paged else None,
             decode_logits_max_abs_err=max(errs[2 if paged else 1:]),
             bound=tol, launches=launches)
    if old is None:
        os.environ.pop("SWARMDB_MOE_DISPATCH", None)
    else:
        os.environ["SWARMDB_MOE_DISPATCH"] = old


#: (paged: True / None = the default dense engine, chunked) of the
#: binding-capacity parity case (``run_binding_parity``).
BINDING_MODES = ((None, True), (None, False), (True, True), (True, False))


def run_together(eng, prompts, news, timeout=120.0) -> list:
    """Submit greedy requests before the loop starts (one admission
    round), start, wait for all, stop: [(tokens, reason)] in order."""
    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams

    done = {}
    ids = [eng.submit(GenRequest(
        prompt=p, sampling=SamplingParams(max_new_tokens=n),
        on_done=lambda rid, toks, why: done.__setitem__(rid, (toks, why))))
        for p, n in zip(prompts, news)]
    eng.start()
    try:
        deadline = time.time() + timeout
        while len(done) < len(ids) and time.time() < deadline:
            time.sleep(0.02)
    finally:
        eng.stop()
    return [done.get(i) for i in ids]


def run_binding_parity(dev):
    """The binding-capacity case of ``tests/test_torch_decode_loop_*.py``
    on the card: tiny-moe with 8 experts (C = N / 2, so idle and retired
    rows take capacity and tokens drop) in f32, max_batch 4, max_seq 96,
    page 16, three requests submitted before start (prompt seeds 2, 3
    and 4; 21, 40 and 33 tokens; 6, 20 and 13 new), both engines chunked
    and single-step at the default loops (paged: resident sessions; dense:
    two chunks in flight). The card decodes through graph replays, the
    CPU eagerly: greedy tokens equal."""
    import numpy as np
    import torch

    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.models import mixtral
    from swarmdb_tpu_torch.models.configs import get_config

    cfg = get_config("tiny-moe", n_experts=8)
    p_cpu = mixtral.init_params(cfg, seed=1, device="cpu",
                                dtype=torch.float32)
    p_gpu = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in p_cpu.items()}
    for paged, chunked in BINDING_MODES:
        loops, graphs = set(), 0
        for seed in (2, 3, 4):
            rng = np.random.default_rng(seed)
            prompts = [rng.integers(3, 259, n).tolist() for n in (21, 40, 33)]
            outs = {}
            for where, d, p in (("gpu", dev, p_gpu), ("cpu", "cpu", p_cpu)):
                with engine_env(chunked):
                    eng, _ = build_backend_engine(
                        cfg, max_batch=4, max_seq=96, page_size=16, device=d,
                        params=p, kv_dtype=torch.float32, paged=paged)
                outs[where] = run_together(eng, prompts, (6, 20, 13))
                st = eng.stats()
                loops.add(st["decode_loop"])
                if where == "gpu":
                    graphs += st["decode_chunks"]["chunks"]
            if outs["gpu"] != outs["cpu"] or None in outs["gpu"]:
                fail(f"parity moe8 binding paged={paged} chunked={chunked} "
                     f"seed={seed}: card {outs['gpu']} cpu {outs['cpu']}")
        want = {"resident" if paged else "pipeline 2"}
        if loops != want:
            fail(f"parity moe8 binding: decode loops {loops}, not {want}")
        emit("parity", case="moe8_binding_default_loops",
             model="tiny-moe, 8 experts", cache="float32",
             paged=bool(paged), chunked=chunked, seeds=[2, 3, 4],
             decode_loop=want.pop(), greedy_equal=True,
             card_graph_replays=graphs)


# ---------------------------------------------------------------- rolling


class RollTrace:
    """What a rolling service did per message: the plan's mode and tier
    origin (``_rolling_plan``), the prompt it submitted (its length and
    resume length), and the request's tokens and logprobs; optionally the
    first-token logits of every prefill row (``_sample_into_slots``)."""

    def __init__(self, svc, logits: bool = False) -> None:
        self.plans, self.prompts, self.done = {}, {}, {}
        self.logits = []
        self.order = []
        plan, submit = svc._rolling_plan, svc.engine.submit

        def traced_plan(key, msg, sampling, pre_count=0):
            out = plan(key, msg, sampling, pre_count)
            self.plans[msg.id] = (out[0], msg.metadata.get("tier_origin"))
            return out

        def traced_submit(req):
            mid = req.metadata.get("message_id")
            self.prompts[mid] = (len(req.prompt), req.resume_len)
            self.order.append(mid)
            user_done = req.on_done

            def on_done(rid, toks, reason, req=req):
                self.done[mid] = (list(toks), reason,
                                  list(req.metadata.get("logprobs", [])))
                if user_done is not None:
                    user_done(rid, toks, reason)

            req.on_done = on_done
            return submit(req)

        svc._rolling_plan = traced_plan
        svc.engine.submit = traced_submit
        if logits:
            eng = svc.engine
            sample = eng._sample_into_slots

            def traced_sample(lg, gather, fold_pos, scatter):
                rows = [r for r in range(len(scatter))
                        if scatter[r] < eng.max_batch]
                if rows:   # a wave of split rows' heads samples nothing
                    self.logits.append(lg[rows].float().cpu())
                return sample(lg, gather, fold_pos, scatter)

            eng._sample_into_slots = traced_sample

    def by_origin(self, ids=None) -> dict:
        """origin (tier origin, else the plan's mode) -> the prefill
        tokens of each of its turns."""
        out: dict = {}
        for mid in ids if ids is not None else self.prompts:
            if mid not in self.prompts:
                continue
            mode, origin = self.plans.get(mid, ("plain", None))
            key = origin or ("hot" if mode == "resume" else mode)
            out.setdefault(key, []).append(self.prompts[mid][0])
        return out


def roll_send(db, user, assistant, content, max_new=32, function=False):
    from swarmdb_tpu_torch.core.messages import MessageType

    kw = ({"message_type": MessageType.FUNCTION_CALL} if function else {})
    return db.send_message(user, assistant, content, metadata={
        "generation": {"max_new_tokens": max_new, "temperature": 0.0}}, **kw)


def roll_wait(db, completed_target, timeout=300.0) -> None:
    completed = db.metrics.counters["completed_messages"]
    deadline = time.time() + timeout
    while completed.value < completed_target and time.time() < deadline:
        time.sleep(0.005)
    if completed.value < completed_target:
        fail(f"rolling: {completed.value} of {completed_target} replies "
             f"within {timeout} s")


def wait_parked(svc, key, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with svc._rolling_lock:
            st = svc._rolling.get(key)
            if st is not None and st.get("pages") and not st["in_flight"]:
                return st
        time.sleep(0.01)
    fail(f"rolling: {key} never parked its pages")


ROLL_PARITY_TURNS = ("chat", "function", "chat", "function", "chat")

#: (name, cache dtype, paged, chunked, f32 chunk buffer, bound): the
#: rolling parity cases, tiny-debug f32 weights on the card and on the
#: CPU. Paged cases run the tier manager (a warm promotion before turn 3,
#: a cold resume before turn 4); dense ones keep and resume through the
#: side pool (its lane composed from kept pages). Bounds on the first-token
#: logits and the decode logprobs: 1e-4 where both sides see the same
#: f32 operands (an f32 pool single-step, or chunked with an f32 chunk
#: buffer swapped in after the build). The engine's own chunk buffer is
#: bf16, as in the JAX package: its plain version rounds the chunk's
#: softmax weights to bf16 before the value product and the kernels keep
#: them in f32, a relative 2^-9 on each weight (``layers.py``
#: ``gqa_attention_chunked_reference``). Served on the CPU both ways
#: (``scripts/rolling_parity_emulation.py``), tiny-debug's rolling
#: logits and logprobs part by up to ROLL_BF16_GAP; those cases are held
#: to 4x it, and, against the CPU served the kernels' way
#: (``kernel_weights``), to 1e-4 with an f32 pool. The int8 cases add a
#: requantized page's int8 code flipping where the card's and the CPU's
#: K/V differ by float32 rounding (``PARITY_CASES``); tiny-debug's flat
#: logits then meet near ties, and their tokens may part once, at a tie
#: within the bound (``rolling_parity_errors``).
ROLL_BF16_GAP = 7.5e-4
ROLL_PARITY_CASES = (
    ("paged_f32_chunked_f32_buffer", "float32", True, True, True, 1e-4),
    ("paged_f32_chunked", "float32", True, True, False, 4 * ROLL_BF16_GAP),
    ("paged_f32_single_step", "float32", True, False, False, 1e-4),
    ("paged_int8_chunked", "int8", True, True, False, 2e-2),
    ("paged_int8_single_step", "int8", True, False, False, 2e-2),
    ("dense_f32_chunked", "float32", False, True, False, 4 * ROLL_BF16_GAP),
    ("dense_f32_single_step", "float32", False, False, False, 1e-4))


@contextlib.contextmanager
def kernel_weights():
    """The plain two-segment decode run the kernels' way for the block:
    its operands upcast to float32 first, so the softmax weights meet the
    (bf16-valued) chunk and page values unrounded."""
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    plain = ac.gqa_attention_chunked_reference

    def unrounded(q, cache_k, cache_v, chunk_k, chunk_v, *args, **kw):
        return plain(q, cache_k.float(), cache_v.float(), chunk_k.float(),
                     chunk_v.float(), *args, **kw)

    ac.gqa_attention_chunked_reference = unrounded
    try:
        yield
    finally:
        ac.gqa_attention_chunked_reference = plain


def rolling_parity_run(d, params, kind, paged, chunked, f32_buffer):
    """tiny-debug with rolling KV on device ``d`` (one
    ``ROLL_PARITY_CASES`` case): one 5-turn conversation
    (``ROLL_PARITY_TURNS``). Paged, with the tier manager: every idle
    conversation demoted before turn 3 (a warm promotion) and demoted
    into a store too small to hold it before turn 4 (a cold resume).
    Returns per turn (tokens, reason, logprobs), the origins, the prefill
    rows' first-token logits and the tier counters."""
    import tempfile

    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    import torch

    db = SwarmDB(broker=LocalBroker(),
                 save_dir=tempfile.mkdtemp(prefix="swarm_rollpar_"))
    with engine_env(chunked, SWARMDB_ROLLING_KV="1", SWARMDB_TIER="1"):
        eng, tok = build_backend_engine(
            "tiny-debug", max_batch=2, max_seq=256, page_size=8, device=d,
            params=params, kv_dtype=getattr(torch, kind), paged=paged,
            metrics=db.metrics)
        svc = ServingService(db, eng, tok, backend_id="b0")
    if f32_buffer:
        # an f32 chunk K/V buffer: the card's kernel and the CPU's plain
        # version then see the same f32 operands
        eng._chunk_kv = tuple(t.float() for t in eng._chunk_kv)
    if svc._rolling is None or paged != (svc._tier is not None):
        fail("rolling parity: rolling KV or the tier manager did not attach")
    if paged:
        svc._tier.min_idle_s = 0.0
    trace = RollTrace(svc, logits=True)
    key = ("user", "assistant")
    try:
        for a in key:
            db.register_agent(a)
        db.assign_llm_backend("assistant", "b0")
        svc.start(warmup=d != "cpu")
        for t, turn in enumerate(ROLL_PARITY_TURNS):
            if paged and t in (2, 3):
                wait_parked(svc, key)
                if t == 3:
                    svc._tier.store.capacity_bytes = 1   # falls to cold
                with svc._rolling_lock:
                    svc._tier.demote_now(10 ** 6)
            content = ({"name": "lookup_weather",
                        "arguments": {"city": f"city_{t}"}}
                       if turn == "function" else f"turn {t}: tell me more")
            roll_send(db, *key, content, max_new=12,
                      function=turn == "function")
            roll_wait(db, t + 1)
        origins = [trace.plans[m][1] or ("hot" if trace.plans[m][0]
                                         == "resume" else trace.plans[m][0])
                   for m in trace.order]
        turns = [trace.done[m] for m in trace.order]
        return turns, origins, trace.logits, (
            dict(svc._tier.status()["counters"]) if paged else None)
    finally:
        svc.stop()
        db.close()


def rolling_parity_errors(gpu, cpu, tol=None):
    """Compare two ``rolling_parity_run`` results turn by turn: (first-
    token logits, decode logprobs) max abs differences and where the
    greedy tokens part, (turn, token) or None.

    With ``tol`` (the int8 cases) the tokens may part once, at a near
    tie: a first token whose two choices each sit within ``tol`` of the
    top of the other side's logits, or a decode token whose two choices'
    logprobs differ by at most ``tol``. Past that point the conversations
    differ and nothing more is compared. Without ``tol`` they must not
    part."""
    if len(gpu[2]) != len(cpu[2]) or (tol is not None
                                      and len(gpu[2]) != len(gpu[0])):
        fail(f"rolling parity: {len(gpu[2])} prefill waves on the card, "
             f"{len(cpu[2])} on the CPU, {len(gpu[0])} turns")

    def logits_err(waves):
        return max((float((a - b).abs().max()) for a, b in
                    zip(gpu[2][:waves], cpu[2][:waves])), default=0.0)

    lp = 0.0
    for t, (a, b) in enumerate(zip(gpu[0], cpu[0])):
        i = next((j for j, (x, y) in enumerate(zip(a[0], b[0])) if x != y),
                 None)
        upto = len(a[2]) if i is None else i + 1
        lp = max([lp] + [abs(x - y) for x, y in zip(a[2][:upto],
                                                     b[2][:upto])])
        if i is None and a[:2] == b[:2]:
            continue
        if i is None or tol is None:
            fail(f"rolling parity: tokens differ card vs cpu at turn {t}: "
                 f"{a[:2]} {b[:2]}")
        if i == 0:
            ga, gb = gpu[2][t][0], cpu[2][t][0]
            if not (ga[b[0][0]] >= ga.max() - tol
                    and gb[a[0][0]] >= gb.max() - tol):
                fail(f"rolling parity: turn {t}'s first token parts card "
                     f"{a[0][0]} vs cpu {b[0][0]} with no near tie")
        # turn t's prefill still saw the same inputs on both sides
        return logits_err(t + 1), lp, (t, i)
    return logits_err(len(gpu[2])), lp, None


def run_rolling_parity(dev):
    """The rolling parity cases (``ROLL_PARITY_CASES``): each served on the
    card and on the CPU with the same f32 weights; greedy tokens equal
    (int8: until they part at a near tie, if they do), first-token
    logits and the decode logprobs within the case's bound
    (and within 1e-4 of the CPU served the kernels' way, for the bf16
    chunk buffer over an f32 cache), origins fresh, hot, warm, cold, hot
    (paged) or keep, hot, hot, keep, hot (dense), and the card engine
    launching its path's kernels."""
    import torch

    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    p_cpu = llama.init_params(get_config("tiny-debug"), seed=11,
                              device="cpu", dtype=torch.float32)
    p_gpu = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in p_cpu.items()}
    for name, kind, paged, chunked, f32_buffer, tol in ROLL_PARITY_CASES:
        ac.reset_launches()
        gpu = rolling_parity_run(dev, p_gpu, kind, paged, chunked,
                                 f32_buffer)
        launches = {k: n for k, n in ac.LAUNCHES.items() if n}
        cpu = rolling_parity_run("cpu", p_cpu, kind, paged, chunked,
                                 f32_buffer)
        # dense: turn 4 would overflow the 256-token window (211 kept
        # tokens), so the conversation restarts there
        want = (["fresh", "hot", "warm", "cold", "hot"] if paged
                else ["keep", "hot", "hot", "keep", "hot"])
        if gpu[1] != want or cpu[1] != want:
            fail(f"rolling parity {name}: origins card {gpu[1]} cpu "
                 f"{cpu[1]}, not {want}")
        lg_err, lp_err, parted = rolling_parity_errors(
            gpu, cpu, tol if kind == "int8" else None)
        if max(lp_err, lg_err) > tol:
            fail(f"rolling parity {name}: card vs cpu logits {lg_err}, "
                 f"logprobs {lp_err} > {tol}")
        kernel_way = None
        if chunked and not f32_buffer and kind == "float32":
            # the gap is the plain version's rounding: served the
            # kernels' way, the CPU meets the card at float32 rounding
            with kernel_weights():
                emul = rolling_parity_run("cpu", p_cpu, kind, paged,
                                          chunked, f32_buffer)
            kernel_way = rolling_parity_errors(gpu, emul)[:2]
            if max(kernel_way) > 1e-4:
                fail(f"rolling parity {name}: card vs the cpu served the "
                     f"kernels' way: logits, logprobs {kernel_way} > 1e-4")
        if set(launches) != set(path_kernels(kind, chunked, paged)):
            fail(f"rolling parity {name}: the card engine launched "
                 f"{launches}")
        emit("parity", case=f"rolling_{name}", model="tiny-debug",
             cache=kind, paged=paged, chunked=chunked,
             chunk_buffer=(None if not chunked else "float32"
                           if f32_buffer else "bfloat16"),
             turns=list(ROLL_PARITY_TURNS),
             origins=gpu[1], greedy_equal=parted is None,
             tokens_part_at_near_tie=parted,
             prefill_logits_max_abs_err=lg_err,
             decode_logprobs_max_abs_err=lp_err, bound=tol,
             kernel_way_max_abs_err=kernel_way, tier_counters=gpu[3],
             launches=launches)


#: the rolling phase's scenario (bench.py's bench_swarm1M cut to one card):
#: 12 users x 4 assistants, one ~600-token context turn per conversation,
#: then ROLL_ROUNDS rounds of 48 ~40-token deltas drawn Zipf(1.1) from
#: numpy seed 0, 32 new tokens each, at most ROLL_OUTSTANDING in flight
ROLL_USERS, ROLL_ASSISTANTS, ROLL_ROUNDS = 12, 4, 2
ROLL_OUTSTANDING = 10
#: the rolling engines run the first ROLL_LAYERS of Llama-3-8B's 32 layers
#: (views of the serve phase's weights: the script's time limit); the
#: warm store is cut with them, so it holds the pages 1024 MiB held at
#: full depth and the tiers see the same pressure
ROLL_LAYERS = 16
ROLL_WARM_MB = 1024 * ROLL_LAYERS // 32
#: how long a stopped scenario may take to settle every claim before its
#: custody is read
ROLL_SETTLE_S = 5.0
#: (name, cache dtype, paged): the three engines of the rolling phase
#: Page-locked bytes a stopped rolling engine may leave behind.
ROLL_PINNED_SLACK = 64 << 20
ROLL_MODES = (("paged_bf16", "bfloat16", True),
              ("paged_int8", "int8", True),
              ("dense", "bfloat16", None))


def zipf_indices(k: int, exponent: float, count: int, seed: int):
    """``bench.py``'s ``_zipf_indices``: ``count`` indices in [0, k) from
    a bounded Zipf (inverse CDF over rank ** -exponent)."""
    import numpy as np

    ranks = np.arange(1, k + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -exponent)
    cdf /= cdf[-1]
    rng = np.random.default_rng(seed)
    return np.searchsorted(cdf, rng.random(count)).astype(np.int64)


def run_rolling(card: str, params):
    """The rolling phase on Llama-3-8B at full width, ``ROLL_LAYERS``
    deep (``ROLL_MODES``). Returns the launches summed over its
    engines."""
    from swarmdb_tpu_torch.models.configs import get_config

    cfg = get_config("llama3-8b", n_layers=ROLL_LAYERS)
    params = dict(params, layers={k: v[:ROLL_LAYERS]
                                  for k, v in params["layers"].items()})
    total = {}
    for name, kind, paged in ROLL_MODES:
        before = host_pinned_bytes()
        for k, n in rolling_serve(card, cfg, params, name, kind,
                                  paged).items():
            total[k] = total.get(k, 0) + n
        # the stopped engine's warm store must not stay page-locked: the
        # next engine's would sit beside it
        after = host_pinned_bytes()
        emit("rolling", serve=name, part="stopped",
             page_locked_bytes_before_engine=before,
             page_locked_bytes_after_stop=after, card=card)
        if (before is not None and after is not None
                and after - before > ROLL_PINNED_SLACK):
            fail(f"rolling {name}: {after - before} page-locked bytes "
                 f"outlived the stopped engine (at most "
                 f"{ROLL_PINNED_SLACK})")
    return total


def _summary(xs):
    xs = sorted(xs)
    return ({"n": len(xs), "median": statistics.median(xs), "max": xs[-1]}
            if xs else {"n": 0})


def rolling_serve(card, cfg, params, name, kind, paged):
    """One engine of the rolling phase: build it with rolling KV (and,
    paged, the tier manager with a ``ROLL_WARM_MB`` warm store), capture
    its graphs, serve the scenario, check and print. Paged: then the
    demote -> promote A/B (``tier_ab``)."""
    import gc
    import tempfile

    import torch

    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.obs.memprof import ReuseSampler, memprof
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    t_build = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the accountant from zero for this engine, every prefix access
    # sampled (the scenario's few hundred accesses would leave a 1/16
    # sample nearly empty): its tier_validation reads this serve alone
    mp = memprof()
    mp.reset()
    mp.sampler = ReuseSampler(1, 65536)
    db = SwarmDB(broker=LocalBroker(),
                 save_dir=tempfile.mkdtemp(prefix="swarm_roll_"))
    backend = "h100-0"
    with env_scope(SWARMDB_ROLLING_KV="1", SWARMDB_TIER="1",
                   SWARMDB_TIER_WARM_MB=ROLL_WARM_MB,
                   SWARMDB_TIER_MIN_IDLE_S="0.05", SWARMDB_CHUNKED="1",
                   SWARMDB_PAGED=None):
        eng, tok = build_backend_engine(
            cfg, seed=0, device="cuda", params=params, paged=paged,
            kv_dtype=getattr(torch, kind) if paged else None,
            metrics=db.metrics)
        svc = ServingService(db, eng, tok, backend_id=backend)
    if svc._rolling is None or (paged and svc._tier is None):
        fail(f"rolling {name}: rolling KV or the tier manager did not "
             f"attach")
    users = [f"user{i}" for i in range(ROLL_USERS)]
    assistants = [f"assistant{j}" for j in range(ROLL_ASSISTANTS)]
    convs = [(u, a) for a in assistants for u in users]
    trace = RollTrace(svc)
    promote_s = [0.0, 0]
    insert = eng._promote_insert

    def timed_insert(req):
        n = len(req.resume_pages or ())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        insert(req)
        torch.cuda.synchronize()
        promote_s[0] += time.perf_counter() - t0
        promote_s[1] += n

    eng._promote_insert = timed_insert
    ctx = " ".join(f"ctx{j}" for j in range(100))
    pinned_peak = [0]
    pinned_before = host_pinned_bytes()
    try:
        for a in users + assistants:
            db.register_agent(a)
        for a in assistants:
            db.assign_llm_backend(a, backend)
        svc.start(warmup=True)
        start_s = time.perf_counter() - t_build
        ac.reset_launches()
        sent = 0
        draws = zipf_indices(len(convs), 1.1, ROLL_ROUNDS * len(convs), 0)
        plan = [(c, f"Conversation {c} context: {ctx}") for c in
                range(len(convs))] + [
            (int(c), f"Continue conversation {int(c)}, step {i}. d0 d1 d2")
            for i, c in enumerate(draws)]
        t_serve = time.perf_counter()
        for c, text in plan:
            roll_wait(db, sent - ROLL_OUTSTANDING + 1)
            roll_send(db, *convs[c], text)
            sent += 1
            if svc._tier is not None:
                pinned_peak[0] = max(pinned_peak[0],
                                     svc._tier.store.stats()["bytes"])
        roll_wait(db, sent)
        serve_s = time.perf_counter() - t_serve
        launches = dict(ac.LAUNCHES)
        replies = []
        for u in users:
            replies.extend(db.receive_messages(u, max_messages=10 ** 4,
                                               timeout=0.5))
        reasons = [m.metadata.get("finish_reason") for m in replies]
        # idle: every claim settled (a claim settles within milliseconds
        # of its reply, which was read above)
        t_settle = time.perf_counter()
        deadline = time.time() + ROLL_SETTLE_S
        while time.time() < deadline and (eng._any_active() or any(
                st.get("in_flight") for st in list(svc._rolling.values()))):
            time.sleep(0.01)
        settle_s = time.perf_counter() - t_settle
        unsettled = sum(1 for st in list(svc._rolling.values())
                        if st.get("in_flight"))
        c = db.metrics.counters
        lat = db.metrics.latencies
        by_origin = trace.by_origin()
        origins = {k: len(v) for k, v in by_origin.items()}
        custody = rolling_custody(svc)
        record = dict(
            serve=name, model="llama3-8b", layers=cfg.n_layers,
            reduced=f"depth {cfg.n_layers} of 32 layers", cache=kind,
            engine="paged" if paged else "dense (default)",
            conversations=len(convs), turns=sent, replies=len(replies),
            finish_reasons={r: reasons.count(r) for r in set(reasons)},
            turns_by_origin=origins,
            prefill_tokens_per_turn={k: statistics.mean(v) for k, v in
                                     by_origin.items()},
            rolling_resumes=c["rolling_resumes"].value,
            rolling_restarts=c["rolling_restarts"].value,
            rolling_evictions=c["rolling_evictions"].value,
            custody=custody, build_and_start_s=start_s, serve_wall_s=serve_s,
            settle_s=settle_s, claims_in_flight_after_settle=unsettled,
            ttft_all_s=_summary(lat["send_to_first_token_s"].values()),
            launches={k: n for k, n in launches.items() if n},
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
            card=card)
        checks = {
            f"{sent} replies, length/eos": len(replies) == sent and all(
                r in ("length", "eos") for r in reasons),
            "custody balances": custody["balanced"],
            "resumed turns": c["rolling_resumes"].value > 0,
            # no claim outlives the settle: a demotion the tier worker
            # planned after the last admission round runs on the idle
            # engine, not at the next submit
            "claims_in_flight_after_settle 0": unsettled == 0,
        }
        if paged:
            tier = svc._tier
            st = tier.status()
            record.update(
                tier_counters=st["counters"], pages_by_tier=st["pages"],
                warm_store=st["warm_store"],
                ttft_by_origin_s={o: _summary(lat[f"tier_ttft_{o}_s"]
                                              .values())
                                  for o in ("hot", "warm", "cold", "fresh")
                                  if f"tier_ttft_{o}_s" in lat},
                demote_ms_per_page=(tier.demote_s * 1e3 / tier.demoted_pages
                                    if tier.demoted_pages else None),
                promote_ms_per_page=(promote_s[0] * 1e3 / promote_s[1]
                                     if promote_s[1] else None),
                pinned_host_bytes_peak=pinned_peak[0],
                pinned_host_bytes_end=st["warm_store"]["bytes"],
                warm_slab=tier.store.slab_stats(),
                # the accountant's what-if warm tier against the tier's
                # measured promotions and cold resumes (/admin/tiers)
                tier_validation=mp.tier_validation(),
                mem_verdict=mp.verdict())
            # PyTorch's page-locked host allocator (pin_memory): what this
            # engine added is its store's slab, not a block per demotion
            pinned_after = host_pinned_bytes()
            record["pinned_host_allocator_bytes"] = [pinned_before,
                                                     pinned_after]
            if pinned_after is not None:
                checks["page-locked growth within the warm slab + 64 MiB"] \
                    = (pinned_after - pinned_before
                       <= tier.store.slab_stats()["bytes"] + (64 << 20))
            for o in ("hot", "warm", "cold"):
                checks[f"at least one {o} resume"] = origins.get(o, 0) > 0
        bad = [k for k, ok in checks.items() if not ok]
        emit("rolling", **record)
        if bad:
            fail(f"rolling {name} checks failed: {bad}")
        if paged:
            tier_ab(svc, eng, tok, name, card)
        return launches
    finally:
        svc.stop()
        db.close()
        # the trace and the timed insert hold the service and the engine:
        # drop them before the collection, not after it
        del eng._promote_insert
        del svc, eng, trace, insert, timed_insert
        gc.collect()
        torch.cuda.empty_cache()


def host_pinned_bytes():
    """Bytes PyTorch's page-locked host allocator holds (None where this
    PyTorch does not report them)."""
    import torch

    stats = (torch.cuda.host_memory_stats()
             if hasattr(torch.cuda, "host_memory_stats") else {})
    return stats.get("allocated_bytes.current")


def rolling_custody(svc) -> dict:
    """Every page of the pool (paged) or side pool (dense) accounted for,
    the engine idle: free + the registry's device pages + pages still
    owned by retired slots (paged) + prefix-cache pages == all but the
    trash page (``tests/test_rolling.py``'s custody equation)."""
    eng = svc.engine
    with svc._rolling_lock:
        held = sum(len(st["pages"]) for st in svc._rolling.values()
                   if st.get("pages"))
    cached = eng._prefix.stats()["cached_pages"]
    if eng.paged is not None:
        alloc = eng.paged.allocator
        with alloc._lock:
            in_slot = sum(len(sp.pages) for sp in alloc._by_slot.values())
        free, pool = alloc.free_count(), alloc.num_pages - 1
    else:
        in_slot = 0
        free, pool = eng._prefix.free_count(), eng._prefix.num_pages - 1
    return dict(free=free, registry=held, in_slot=in_slot,
                prefix_cached=cached, pool=pool,
                balanced=free + held + in_slot + cached == pool)


def tier_ab(svc, eng, tok, name, card):
    """Demote -> promote against the hot path on one engine, the same
    inputs: a ~600-token conversation kept, its next greedy turn (a
    ~40-token delta) resumed hot; the same conversation again, its pages
    demoted through the tier manager into pinned host memory and promoted
    back into freshly reserved pages before the same turn. The promoted
    pages must equal (``torch.equal``) the demoted ones, and the turn's
    tokens the hot turn's. Times one demotion and one promotion per
    page (synchronized)."""
    import threading

    import torch

    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams
    from swarmdb_tpu_torch.ops.paged_kv import QuantPool

    prompt = tok.encode("probe: Conversation ab context: " + " ".join(
        f"ctx{j}" for j in range(100)) + "\nassistant0:")
    delta = tok.encode("\nprobe: Continue conversation ab. d0 d1 d2"
                       "\nassistant0:", add_bos=False)

    def keep(p, resume=None, payload=None):
        done = threading.Event()
        out = {}
        req = GenRequest(prompt=list(p), sampling=SamplingParams(
            max_new_tokens=32), keep_pages=True,
            on_token=lambda r, t: out.setdefault(
                "ttft_s", time.perf_counter() - t_submit),
            on_pages=lambda r, pg, w, t: out.update(pages=pg, written=w,
                                                    tail=t),
            on_done=lambda r, t, why: (out.update(toks=t, reason=why),
                                       done.set()))
        if resume is not None:
            req.resume_pages, req.resume_len = list(resume[0]), resume[1]
            req.promote_payload = payload
        t_submit = time.perf_counter()
        eng.submit(req)
        if not done.wait(300):
            fail(f"tier A/B {name}: a turn timed out")
        return out

    def snap(ids):
        idx = torch.tensor(ids, device=eng.device)
        out = []
        for pool in (eng.cache["k"], eng.cache["v"]):
            if isinstance(pool, QuantPool):
                out += [pool.data[:, idx].clone(), pool.scale[:, idx].clone()]
            else:
                out.append(pool[:, idx].clone())
        return out

    first = keep(prompt)
    hot = keep(first["tail"] + delta, (first["pages"], first["written"]))
    eng.rolling_free(hot["pages"])
    again = keep(prompt)
    if (again["written"], again["tail"]) != (first["written"],
                                             first["tail"]):
        fail(f"tier A/B {name}: the repeated turn 1 differs")
    before = snap(again["pages"])
    key = ("probe", "ab")
    st = {"pages": list(again["pages"]), "len": again["written"],
          "tail": list(again["tail"]), "epoch": eng.pool_epoch(),
          "in_flight": False, "last": time.time()}
    n = len(st["pages"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with svc._rolling_lock:
        svc._rolling[key] = st
        freed = svc._tier._demote_locked(key, st)
    demote_s = time.perf_counter() - t0
    if freed != n or not svc._tier.store.has(key):
        fail(f"tier A/B {name}: the demotion did not land in host memory")
    with svc._rolling_lock:
        got = svc._tier.begin_promote(key, st, eng.pool_epoch())
        svc._rolling.pop(key, None)
    if got is None:
        fail(f"tier A/B {name}: the promotion found no pages")
    ids, payload = got
    pinned = all(t.is_pinned() for side in payload
                 for t in (side if isinstance(side, tuple) else (side,)))
    after, t_promote = [], [0.0]
    insert = eng._promote_insert

    def watched(req):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        insert(req)
        torch.cuda.synchronize()
        t_promote[0] = time.perf_counter() - t1
        after.extend(snap(req.resume_pages))

    eng._promote_insert = watched
    try:
        warm = keep(again["tail"] + delta, (ids, again["written"]), payload)
    finally:
        eng._promote_insert = insert
    eng.rolling_free(warm["pages"])
    # the same turn as a cold resume: the whole history prefilled fresh
    cold = keep(prompt + first["toks"] + delta)
    eng.rolling_free(cold["pages"])
    equal = len(after) == len(before) and all(
        torch.equal(a, b) for a, b in zip(after, before))
    emit("rolling", step="tier_ab", serve=name, pages=n,
         page_bytes=sum(t.numel() * t.element_size() for t in before) // n,
         pinned_payload=pinned, promoted_bytes_equal=equal,
         warm_tokens_equal_hot=warm["toks"] == hot["toks"],
         demote_ms_per_page=demote_s * 1e3 / n,
         promote_ms_per_page=t_promote[0] * 1e3 / n,
         # the host-to-device rate of the promotion: what the memory
         # accountant's SWARMDB_MEM_H2D_GBPS default stands for
         promote_h2d_gbps=(sum(t.numel() * t.element_size() for t in before)
                           / t_promote[0] / 1e9 if t_promote[0] else None),
         ttft_s={"hot": hot["ttft_s"], "warm": warm["ttft_s"],
                 "cold": cold["ttft_s"]},
         prefill_tokens={"hot": len(first["tail"] + delta),
                         "warm": len(again["tail"] + delta),
                         "cold": len(prompt) + len(first["toks"])
                         + len(delta)}, card=card)
    if not (equal and pinned and warm["toks"] == hot["toks"]):
        fail(f"tier A/B {name}: promoted bytes equal {equal}, pinned "
             f"{pinned}, warm {warm['toks']} hot {hot['toks']}")


# ------------------------------------------------------------------- serve


USER_TEXT = (
    "I am planning a three-day trip to a city I have never visited and I "
    "want a schedule that balances museums, long walks and good food. "
    "Please suggest a plan for each morning, afternoon and evening, keep "
    "travel between places short, and mention one rainy-day alternative. "
    "My name is {u} and I prefer quiet places over crowded ones.")
FOLLOW_UP = ("Thanks. Now shorten the second day to a half day and add "
             "one place for coffee, {u} speaking again.")

#: (name, cache dtype, chunked, turns, paged): the six serves, in order.
#: ``paged=None`` builds the default engine (``SWARMDB_PAGED`` unset):
#: the dense one, with its bf16 slot cache.
SERVES = (("bf16_chunked", "bfloat16", True, 2, True),
          ("int8_chunked", "int8", True, 2, True),
          ("bf16_single_step", "bfloat16", False, 1, True),
          ("int8_single_step", "int8", False, 1, True),
          ("dense_chunked", "bfloat16", True, 2, None),
          ("dense_single_step", "bfloat16", False, 1, None))


def run_serves(card: str):
    """Llama-3-8B at full width, weights built once, served six times
    (``SERVES``); each engine is freed before the next. Returns the
    launches summed over the serves, and the weights."""
    import torch

    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    params = llama.init_params(get_config("llama3-8b"), seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    total = {}
    for spec in SERVES:
        launches = run_serve(card, params, init_s, *spec)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total, params


def run_serve(card, params, init_s, name, kind, chunked, turns, paged):
    import gc
    import tempfile

    import torch

    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.ops import attention_cuda as ac
    from swarmdb_tpu_torch.ops.paged_kv import (is_quantized, pool_data,
                                                pool_page_bytes)

    quant = kind == "int8"
    kernels = path_kernels(kind, chunked, bool(paged))
    prefill_k, decode_k = kernels[0] if paged else None, kernels[-1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    db = SwarmDB(broker=LocalBroker(),
                 save_dir=tempfile.mkdtemp(prefix="swarm_serve_"))
    backend = "h100-0"
    with engine_env(chunked):
        eng, tok = build_backend_engine(
            "llama3-8b", seed=0, device="cuda", params=params, paged=paged,
            kv_dtype=getattr(torch, kind) if paged else None,
            metrics=db.metrics)
    svc = ServingService(db, eng, tok, backend_id=backend)
    users = [f"user{i}" for i in range(4)]
    try:
        for a in users + ["assistant"]:
            db.register_agent(a)
        db.assign_llm_backend("assistant", backend)
        t_start = time.perf_counter()
        svc.start(warmup=True)   # SWARMDB_PREWARM's path: graphs first
        start_s = time.perf_counter() - t_start
        c = db.metrics.counters
        base = {k: c[k].value for k in ("prefill_waves",
                                        "engine_decode_chunks",
                                        "tokens_generated",
                                        "phase_us_decode")}
        ac.reset_launches()
        replies = []
        t_serve = time.perf_counter()
        for turn, text in enumerate((USER_TEXT, FOLLOW_UP)[:turns]):
            for i, u in enumerate(users):
                gen = {"max_new_tokens": 32}
                if turn == 0 and i == 3:
                    gen.update(temperature=0.8, top_p=0.9, seed=7)
                db.send_message(u, "assistant", text.format(u=u),
                                metadata={"generation": gen})
            got = await_replies(db, users)
            if len(got) < len(users):
                fail(f"serve {name} turn {turn + 1}: {len(got)} of "
                     f"{len(users)} replies")
            replies.extend(got.values())
        serve_s = time.perf_counter() - t_serve
        launches = dict(ac.LAUNCHES)
        loop = eng.stats()["decode_chunks"]
        waves = c["prefill_waves"].value - base["prefill_waves"]
        chunks = c["engine_decode_chunks"].value - base["engine_decode_chunks"]
        steps = chunks * eng.decode_chunk
        L = eng.params["layers"]["wq"].shape[0]
        reasons = [m.metadata.get("finish_reason") for m in replies]
        reused = eng.metrics.counters["prefix_reused_tokens"].value
        checks = {
            f"{len(users) * turns} replies, length/eos":
                len(replies) == len(users) * turns
                and all(r in ("length", "eos") for r in reasons),
            "prefix reuse on turn 2": turns < 2 or reused > 0,
            f"{decode_k} launches == 32 per step":
                chunks > 0 and launches[decode_k] == L * steps,
            "decode through CUDA graph replays": loop["chunks"] > 0
                and bool(loop["graphs"]),
            "only this path's kernels": all(
                n == 0 for k, n in launches.items() if k not in kernels),
            "params on cuda": eng.params["layers"]["wq"].is_cuda,
        }
        if paged:
            checks.update({
                f"{prefill_k} launches == 32 per wave":
                    waves > 0 and launches[prefill_k] >= L * waves,
                "pool kind": is_quantized(eng.cache["k"]) == quant,
                "pool on cuda": pool_data(eng.cache["k"]).is_cuda})
        else:
            checks["the default builds the dense engine, bf16 on cuda"] = (
                eng.paged is None and waves > 0 and all(
                    t.is_cuda and t.dtype == torch.bfloat16
                    for t in (*eng.cache, *eng._prefix_pool)))
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"serve {name} checks failed: {bad}; reasons={reasons} "
                 f"reused={reused} waves={waves} chunks={chunks} "
                 f"launches={launches}")
        ttft = sorted(db.metrics.latencies["send_to_first_token_s"].values())
        dec_s = (c["phase_us_decode"].value - base["phase_us_decode"]) / 1e6
        gen_tok = c["tokens_generated"].value - base["tokens_generated"]
        if paged:
            sizes = dict(
                kv_bytes_per_token=pool_page_bytes(eng.cache["k"]) * 2
                // eng.paged.page_size,
                pool_gib=2 * pool_page_bytes(eng.cache["k"])
                * eng.paged.num_pages / 2**30)
        else:
            ck = eng.cache[0]
            sizes = dict(
                kv_bytes_per_token=2 * ck[:, 0, 0].numel()
                * ck.element_size(),
                slot_cache_gib=sum(map(_nbytes, eng.cache)) / 2**30,
                side_pool_gib=sum(map(_nbytes, eng._prefix_pool)) / 2**30)
        record = dict(
            serve=name, model="llama3-8b", layers=L, weights="bfloat16",
            engine="paged" if paged else "dense (default)", cache=kind,
            chunked=chunked, turns=turns, replies=len(replies),
            finish_reasons=reasons, prefix_reused_tokens=reused,
            prefill_waves=waves, decode_chunks=chunks, launches={
                k: n for k, n in launches.items() if n},
            ttft_p50_s=statistics.median(ttft), ttft_max_s=ttft[-1],
            decode_tokens_per_s=gen_tok / dec_s if dec_s else None,
            generated_tokens=gen_tok, serve_wall_s=serve_s, **sizes,
            weight_init_s=init_s, card=card, max_step_s=eng.max_step_s,
            start_with_warmup_s=start_s, **loop_record(eng),
            logits_mm_out_dtype=llama._MM_OUT_DTYPE.get(eng.device),
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        emit("serve", **record)
        prof = profile_turn(db, users, text=FOLLOW_UP)
        # tracing slows the profiled turn; its device time against the
        # untraced turns' mean wall time gives the idle share of serving
        prof["untraced_turn_wall_ms"] = serve_s / turns * 1e3
        prof["device_idle_share_vs_untraced"] = 1.0 - prof[
            "device_busy_ms"] / prof["untraced_turn_wall_ms"]
        emit("profile", serve=name, **prof)
        attn = prof["attention_ms"]
        if paged and not (attn["ragged_prefill_fp32"] == 0
                          and attn["ragged_prefill_mma"] > 0):
            fail(f"serve {name}: the profiled turn's prefill ran outside "
                 f"the tensor-core body: {attn}")
        if not attn[decode_k.replace("_quant", "")] > 0:
            fail(f"serve {name}: no device time under the decode kernel "
                 f"{decode_k} in the profiled turn: {attn}")
        return launches
    finally:
        svc.stop()
        db.close()
        del svc, eng
        gc.collect()
        torch.cuda.empty_cache()


def loop_record(eng) -> dict:
    """A serve's decode loop: which loop, its chunk graphs (captured
    variants, launches per replay, pool bytes, chunks run) and its
    counters (resident sessions and chunks, host waits on the device)."""
    st = eng.stats()
    c = eng.metrics.counters
    return dict(decode_loop=st["decode_loop"],
                decode_graphs=st["decode_chunks"],
                resident_sessions=c["engine_resident_sessions"].value,
                resident_chunks=c["engine_resident_chunks"].value,
                host_syncs=c["engine_host_syncs"].value)


def await_replies(db, users, timeout=300.0):
    got = {}
    deadline = time.time() + timeout
    while len(got) < len(users) and time.time() < deadline:
        for u in users:
            for m in db.receive_messages(u, timeout=0.05):
                got[u] = m
    return got


#: Profiler names of the two ragged-prefill bodies: the fp32 one (any
#: float32 operand) and the tensor-core one (bf16 query and suffix).
PREFILL_BODIES = ("ragged_prefill_kernel<", "ragged_prefill_mma_kernel<")
#: Profiler names of the decode body's four kernels (csrc/decode.cuh),
#: by the profile key their device time is summed under; the int8 entry
#: points run the paged kernels.
DECODE_BODIES = {
    "paged_decode_chunked": ("paged_decode_chunked_cluster_kernel<",),
    "paged_decode": ("paged_decode_cluster_kernel<",),
    "dense_decode_chunked": ("dense_decode_chunked_cluster_kernel<",),
    "dense_decode": ("dense_decode_cluster_kernel<",)}


def profile_turn(db, users, text):
    """One more greedy turn (after the main path's counts were read) under
    ``torch.profiler`` tracing the device only: device time by kernel, and
    the device's idle share of the turn's wall time (kernels run on one
    stream, so their device times add up without overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for u in users:
            db.send_message(u, "assistant", text.format(u=u),
                            metadata={"generation": {"max_new_tokens": 32}})
        got = await_replies(db, users)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if len(got) < len(users):
        fail(f"profiled turn: {len(got)} of {len(users)} replies")

    kernels = _kernel_times(prof)
    busy_ms = sum(k[1] for k in kernels)
    attn = {"ragged_prefill": PREFILL_BODIES, **DECODE_BODIES}
    attn.update({f"ragged_prefill_{body}": (pat,)
                 for body, pat in zip(("fp32", "mma"), PREFILL_BODIES)})
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "attention_ms": {k: sum(t for n, t, _ in kernels
                                if any(p in n for p in v))
                         for k, v in attn.items()},
        "top": [{"kernel": n[:90], "ms": t, "calls": c}
                for n, t, c in kernels[:12]],
    }


# ------------------------------------------------------------ decode_loop


#: (name, engine: True = paged / None = the default dense one, cache kind,
#: chunked): the decode_loop phase's modes, run on Llama-3-8B, then the
#: ``LOOP_MIXTRAL`` ones on Mixtral-8x7B.
LOOP_LLAMA = (("paged_bf16_chunked", True, "bfloat16", True),
              ("paged_int8_chunked", True, "int8", True),
              ("dense_chunked", None, "bfloat16", True),
              ("paged_bf16_single_step", True, "bfloat16", False),
              ("dense_single_step", None, "bfloat16", False))
LOOP_MIXTRAL = (("dense_chunked", None, "bfloat16", True),
                ("paged_bf16_chunked", True, "bfloat16", True))
#: Largest |logprob| difference allowed between a chunk replayed as a
#: graph and the same chunk run eagerly (same kernels, same inputs; bf16
#: GEMMs may pick other algorithms inside a capture).
LOOP_LP_TOL = 2e-2
#: The single-step paged decode kernel alone (kernels phase, PERF.md
#: section 6): its time at the serving shape and its fixed cost (all
#: slots at length 0), NVIDIA H100 80GB HBM3 at 700 W.
PAGED_DECODE_ALONE_MS, PAGED_DECODE_FIXED_MS = 0.0158, 0.0063
#: Mixtral-8x7B's decode step (16 layers) beside which its graph step is
#: printed: its byte bound, and the step the eager decode loop took
#: (engine wall and alone, PERF.md section 6), on the same card.
MIXTRAL_STEP_BOUND_MS, MIXTRAL_STEP_EAGER_MS = 13.96, (23.0, 87.0)


def _state_tensors(eng) -> list:
    """Every tensor a decode chunk writes: the fed-token vectors, the
    positions and the cache (pool payload, scales and table, or the dense
    slot cache)."""
    from swarmdb_tpu_torch.ops.paged_kv import QuantPool

    out = [eng._last_tokens, eng._last_lps, eng._io.positions]
    parts = (eng.cache.values() if isinstance(eng.cache, dict)
             else eng.cache)
    for t in parts:
        out.extend((t.data, t.scale) if isinstance(t, QuantPool) else (t,))
    return out


def graph_vs_eager(model, params, paged, kind, chunked, card) -> dict:
    """One engine (max_batch 8, max_seq 1024, decode_chunk 8) on
    ``params``: ``warmup`` captures its three variants' chunk graphs
    before any request (SWARMDB_PREWARM's path), on a fresh thread, four
    greedy requests
    (prompts of 300, 180, 420 and 90 tokens) are admitted, and from that
    saved state one greedy chunk is replayed as a graph and then run
    eagerly (``Engine._chunk_body``, the function the graph captured).
    Returns the comparison, the ms per chunk each way (CUDA events,
    median of 20 after 3; the positions reset before each run) and the
    graph's launches per replay."""
    import gc

    import numpy as np
    import torch

    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams
    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    with engine_env(chunked):
        eng, _tok = build_backend_engine(
            model, seed=0, device="cuda", params=params, paged=paged,
            kv_dtype=getattr(torch, kind) if paged else None)
    try:
        # on a thread of its own, as a server's start() may run it: one
        # that has run no GEMM yet (the capture must create its handles)
        warm = {}
        th = threading.Thread(target=lambda: warm.update(s=eng.warmup()))
        th.start()
        th.join()
        if "s" not in warm:
            fail(f"decode_loop: warmup failed on a fresh thread "
                 f"({model}, paged={paged}, {kind}, chunked={chunked})")
        warm_s = warm["s"]
        runner, io, K = eng._runner, eng._io, eng.decode_chunk
        rng = np.random.default_rng(3)
        for n in (300, 180, 420, 90):
            eng.submit(GenRequest(prompt=rng.integers(3, 30000, n).tolist(),
                                  sampling=SamplingParams(max_new_tokens=64)))
        eng._admit()
        live = [i for i, s in enumerate(eng.slots) if s.active]
        positions = np.array([s.dispatched_position if s.active else 0
                              for s in eng.slots], np.int32)
        inputs = eng._chunk_inputs(positions)
        saved = [t.clone() for t in _state_tensors(eng)]
        variant = 2
        ac.reset_launches()
        g_tok, g_lp = runner.launch(variant, inputs).host()
        replay_launches = dict(ac.LAUNCHES)
        for t, v in zip(_state_tensors(eng), saved):
            t.copy_(v)
        for buf, a in zip(io.inputs(), inputs):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        eng._chunk_body(variant)
        e_tok = io.block.cpu().numpy()
        e_lp = io.block_lps.cpu().numpy()
        equal = bool(np.array_equal(g_tok[:, live], e_tok[:, live]))
        lp_err = float(np.abs(g_lp[:, live] - e_lp[:, live]).max())
        pos0 = saved[2]
        graph = runner.graphs[variant]

        def replay():
            io.positions.copy_(pos0)
            graph.replay()

        def eager():
            io.positions.copy_(pos0)
            eng._chunk_body(variant)

        graph_ms = time_events(replay, iters=20)
        # an eager chunk takes up to a third of a second: five of them
        eager_ms = time_events(eager, iters=5, warm=1)
        rec = dict(
            live_slots=len(live), variant=variant, greedy_equal=equal,
            logprob_max_abs_err=lp_err, logprob_bound=LOOP_LP_TOL,
            graph_ms_per_chunk=graph_ms, eager_ms_per_chunk=eager_ms,
            graph_ms_per_step=graph_ms / K, eager_ms_per_step=eager_ms / K,
            eager_over_graph=eager_ms / graph_ms,
            launches_per_replay=runner.graph_launches[variant],
            launches_counted_by_one_replay={k: n for k, n in
                                            replay_launches.items() if n},
            graphs=sorted(runner.graphs), capture_s=runner.capture_s,
            warmup_s=warm_s, graph_pool_bytes=runner.pool_bytes, card=card)
        if paged and not chunked and kind == "bfloat16":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    replay()
                torch.cuda.synchronize()
            hits = [(t, c) for n, t, c in _kernel_times(prof)
                    if DECODE_BODIES["paged_decode"][0] in n]
            calls = sum(c for _, c in hits)
            rec.update(
                paged_decode_in_graph_ms=(sum(t for t, _ in hits) / calls
                                          if calls else None),
                paged_decode_in_graph_calls=calls,
                paged_decode_alone_ms=PAGED_DECODE_ALONE_MS,
                paged_decode_fixed_ms=PAGED_DECODE_FIXED_MS)
        return rec
    finally:
        del eng
        gc.collect()
        torch.cuda.empty_cache()


def run_decode_loop(card, model, params, modes) -> None:
    """The decode_loop phase on one model: graph against eager in every
    mode of ``modes`` (``graph_vs_eager``); fails on unequal greedy
    tokens, logprobs past ``LOOP_LP_TOL`` or a replay that counted other
    launches than its capture recorded."""
    from swarmdb_tpu_torch.models.configs import ModelConfig

    name = model.name if isinstance(model, ModelConfig) else model
    for mode, paged, kind, chunked in modes:
        rec = graph_vs_eager(model, params, paged, kind, chunked, card)
        if name.startswith("mixtral"):
            rec.update(step_byte_bound_ms=MIXTRAL_STEP_BOUND_MS,
                       eager_loop_step_ms=MIXTRAL_STEP_EAGER_MS)
        emit("decode_loop", model=name, mode=mode, **rec)
        if not rec["greedy_equal"]:
            fail(f"decode_loop {name} {mode}: greedy tokens differ graph "
                 f"vs eager")
        if not rec["logprob_max_abs_err"] <= LOOP_LP_TOL:
            fail(f"decode_loop {name} {mode}: logprobs differ by "
                 f"{rec['logprob_max_abs_err']} > {LOOP_LP_TOL}")
        if rec["launches_counted_by_one_replay"] != rec["launches_per_replay"]:
            fail(f"decode_loop {name} {mode}: a replay counted "
                 f"{rec['launches_counted_by_one_replay']}, its capture "
                 f"recorded {rec['launches_per_replay']}")
        if "paged_decode_in_graph_calls" in rec and not rec[
                "paged_decode_in_graph_calls"]:
            fail(f"decode_loop {name} {mode}: the profiler saw no "
                 f"paged_decode kernel inside the replays")


# --------------------------------------------------------------------- api


API_GEN = {"max_new_tokens": 32}


def visible_tokenizer(vocab_size: int):
    """The byte tokenizer, except that an id outside the byte range
    decodes to ``<id>`` instead of nothing. Random Llama-3-8B weights
    sample from 128256 ids, 256 of them bytes: with the plain byte
    tokenizer a reply is nearly always empty text, and a stream carries
    no token event to compare or to time."""
    from swarmdb_tpu_torch.backend.tokenizer import ByteTokenizer

    class VisibleIds(ByteTokenizer):
        def decode(self, ids):
            out, run = [], []
            for i in ids:
                if self._OFFSET <= i < 256 + self._OFFSET:
                    run.append(i)
                    continue
                if run:
                    out.append(super().decode(run))
                    run = []
                if i >= 256 + self._OFFSET:
                    out.append(f"<{i}>")
            if run:
                out.append(super().decode(run))
            return "".join(out)

    return VisibleIds(vocab_size)


def _sse_events(lines):
    """(event, JSON data) pairs from an SSE body's lines."""
    out, event = [], None
    for ln in lines:
        if ln.startswith("event: "):
            event = ln[7:]
        elif ln.startswith("data: ") and event is not None:
            out.append((event, json.loads(ln[6:])))
            event = None
    return out


async def _stream_post(session, url, path, headers, body):
    """POST one streamed request; returns (events, seconds from the send
    to the first token event, or None)."""
    t0 = time.perf_counter()
    first = None
    lines = []
    async with session.post(url + path, json=body, headers=headers) as r:
        if r.status != 200:
            fail(f"api: POST {path} gave {r.status}: {await r.text()}")
        async for raw in r.content:
            ln = raw.decode().rstrip("\r\n")
            if first is None and ln == "event: token":
                first = time.perf_counter() - t0
            lines.append(ln)
    return _sse_events(lines), first


async def _api_http(db, svc, backend, then):
    """Steps (a)-(c) over HTTP: create_app served on 127.0.0.1:0 with
    aiohttp's AppRunner, driven by an aiohttp client; then ``then()`` off
    the loop, before the app's shutdown stops the service and closes the
    runtime."""
    import aiohttp
    from aiohttp import web

    from swarmdb_tpu_torch.api.app import ApiConfig, create_app

    app = create_app(db, ApiConfig(jwt_secret_key="chip-smoke",
                                   rate_limit_per_minute=100_000),
                     serving=svc)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    out = {}
    try:
        async with aiohttp.ClientSession() as s:
            async def token(user):
                async with s.post(url + "/auth/token", json={
                        "username": user, "password": "pw"}) as r:
                    return {"Authorization":
                            f"Bearer {(await r.json())['access_token']}"}

            admin = await token("admin")
            users = [f"user{i}" for i in range(4)]
            hdr = {u: await token(u) for u in users}
            for a in users + ["assistant", "helper"]:
                async with s.post(url + "/agents/register",
                                  json={"agent_id": a}, headers=admin) as r:
                    assert r.status == 200
            for a in ("assistant", "helper"):
                async with s.post(url + "/admin/llm_backend", json={
                        "agent_id": a, "backend_id": backend},
                        headers=admin) as r:
                    if r.status != 200:
                        fail(f"api: llm_backend gave {r.status}")
            # (a) one streamed message per user, all at once
            runs = await asyncio.gather(*[
                _stream_post(s, url, "/messages", hdr[u], {
                    "receiver_id": "assistant", "stream": True,
                    "content": USER_TEXT.format(u=u),
                    "metadata": {"generation": API_GEN}})
                for u in users])
            streams = []
            for u, (events, ttft) in zip(users, runs):
                text = "".join(d for e, d in events if e == "token")
                reply = [d for e, d in events if e == "reply"]
                sent = [d for e, d in events if e == "message"][0]
                stages = db.get_message(sent["id"]).metadata["stages"]
                streams.append(dict(
                    user=u, client_ttft_s=ttft,
                    service_send_to_first_token_s=(
                        stages["first_token"] - stages["enqueued"]),
                    tokens_streamed=sum(e == "token" for e, _ in events),
                    reply_tokens=(reply[0]["metadata"]["completion_tokens"]
                                  if reply else None),
                    finish_reason=(reply[0]["metadata"]["finish_reason"]
                                   if reply else None),
                    streamed_equals_reply=bool(reply)
                    and text == reply[0]["content"]))
            out["a"] = streams
            # (b) n = 2, seeded and sampled
            events, _ = await _stream_post(s, url, "/messages", hdr["user0"], {
                "receiver_id": "assistant", "stream": True,
                "content": FOLLOW_UP.format(u="user0"),
                "metadata": {"generation": dict(
                    API_GEN, n=2, temperature=0.8, top_p=0.9, seed=11)}})
            reply = [d for e, d in events if e == "reply"][0]
            out["b"] = dict(body=reply["content"],
                            body_tokens=reply["metadata"]["completion_tokens"],
                            alternatives=reply["metadata"].get(
                                "alternatives"))
            # (c) a group of two LLM-backed members, streamed
            async with s.post(url + "/groups", json={
                    "group_name": "crew",
                    "agent_ids": ["user1", "assistant", "helper"]},
                    headers=hdr["user1"]) as r:
                assert r.status == 200
            events, ttft = await _stream_post(
                s, url, "/groups/message", hdr["user1"], {
                    "group_name": "crew", "stream": True,
                    "content": FOLLOW_UP.format(u="user1"),
                    "metadata": {"generation": API_GEN}})
            done = [d for e, d in events if e == "reply_done"]
            stored = {}
            for d in done:
                rid = db.get_message(d["message_id"]).metadata.get(
                    "reply_id")
                stored[d["message_id"]] = db.get_message(rid).content
            out["c"] = dict(
                members=len([e for e, _ in events if e == "message"]),
                token_events=sum(e == "token" for e, _ in events),
                client_ttft_s=ttft,
                replies=[dict(finish_reason=d["finish_reason"],
                              text_equals_stored=d["text"]
                              == stored[d["message_id"]])
                         for d in done])
            async with s.get(url + "/metrics") as r:
                out["metrics_lane_state"] = [
                    ln for ln in (await r.text()).splitlines()
                    if ln.startswith("swarmdb_lane_state")]
        report_http(out)
        await asyncio.get_running_loop().run_in_executor(None, then)
    finally:
        await runner.cleanup()


def _served_once(svc, msg, on_token=None, timeout=300.0):
    """serve_message through the service; returns (tokens, reason,
    streamed)."""
    import threading

    done = threading.Event()
    got, streamed = {}, []

    def tok(rid, t):
        streamed.append(t)
        if on_token is not None:
            on_token(streamed)

    def fin(rid, toks, reason):
        got.update(toks=toks, reason=reason)
        done.set()

    svc.serve_message(msg, on_token=tok, on_done=fin)
    if not done.wait(timeout):
        fail("api: a supervised request never finished")
    return got["toks"], got["reason"], streamed


def report_http(out):
    """Print and check steps (a)-(c)."""
    emit("api", step="a_http_streams", streams=out["a"])
    b = out["b"]
    emit("api", step="b_n2", body_tokens=b["body_tokens"],
         alternatives=[dict(finish_reason=a["finish_reason"],
                            completion_tokens=a["completion_tokens"],
                            differs=a["text"] != b["body"])
                       for a in (b["alternatives"] or [])])
    emit("api", step="c_group_stream", **out["c"],
         metrics_lane_state=out["metrics_lane_state"])
    checks = {
        "(a) 4 of 4 streams equal their reply, 32 tokens": all(
            s["streamed_equals_reply"] and s["reply_tokens"] == 32
            and s["client_ttft_s"] is not None for s in out["a"])
        and len(out["a"]) == 4,
        "(b) one alternative of 32 tokens, not the body": (
            len(b["alternatives"] or []) == 1
            and b["alternatives"][0]["completion_tokens"] == 32
            and b["alternatives"][0]["text"] != b["body"]),
        "(c) two members streamed, replies stored": (
            out["c"]["members"] == 2 and out["c"]["token_events"] > 0
            and len(out["c"]["replies"]) == 2
            and all(r["text_equals_stored"] for r in out["c"]["replies"])),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"api: {bad}")


def kill_replay(svc, eng):
    """(d), dense: a decode killed mid-stream, replayed by the service's
    supervisor."""
    from swarmdb_tpu_torch.backend.chaos import ServingChaos, wait_until
    from swarmdb_tpu_torch.core.messages import Message

    chaos = ServingChaos(eng)
    try:
        killed = []

        def kill_at_8(streamed):
            if len(streamed) == 8 and not killed:
                killed.append(True)
                chaos.kill_lane(0)

        msg = Message(sender_id="user2", receiver_id="assistant",
                      content=FOLLOW_UP.format(u="user2"),
                      metadata={"generation": dict(API_GEN)})
        t0 = time.perf_counter()
        toks, reason, streamed = _served_once(svc, msg, kill_at_8)
        took = time.perf_counter() - t0
        st = svc.supervisor.status()
        wait_until(lambda: svc.supervisor.status()["lanes"][0]["state"]
                   == "alive", 120.0, what="the engine re-admitted")
        after = svc.supervisor.status()
        emit("api", step="d_kill_replay", killed=bool(killed),
             reason=reason, tokens=len(toks),
             streamed_equals_final=streamed == toks, seconds=took,
             requests_retried=st["requests_retried"],
             requests_migrated=st["requests_migrated"],
             restarts=after["lanes"][0]["restarts"],
             readmissions=after["lane_readmissions"],
             dense_max_step_s=eng.max_step_s)
        if not (killed and reason == "length" and len(toks) == 32
                and streamed == toks and st["requests_retried"] >= 1):
            fail(f"api (d): kill/replay failed: reason={reason} "
                 f"tokens={len(toks)} streamed={len(streamed)} "
                 f"status={st}")
    finally:
        chaos.stop()


def shed_heal(params):
    """(d), paged bf16: a squeezed pool sheds the low-priority request;
    the supervisor's retries (budget and backoff from its constructor,
    covering the squeeze) serve it after heal_pool."""
    import threading

    import torch

    from swarmdb_tpu_torch.backend.chaos import ServingChaos, wait_until
    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams
    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.backend.supervisor import LaneSupervisor

    eng, tok = build_backend_engine("llama3-8b", seed=0, device="cuda",
                                    params=params, paged=True,
                                    kv_dtype=torch.bfloat16)
    retries, backoff_s = 8, 0.25
    sup = LaneSupervisor(eng, retries=retries, backoff_s=backoff_s,
                         deadline_s=120.0)
    chaos = ServingChaos(eng)
    try:
        eng.start()
        sup.start()
        results = {}
        events = {k: threading.Event() for k in ("low", "high")}

        def mk(name):
            def fin(rid, toks, reason):
                results[name] = (toks, reason, time.time())
                events[name].set()
            return fin

        prompt = tok.encode(USER_TEXT.format(u="user3"))
        squeezed = chaos.squeeze_pool(1.0)
        low = GenRequest(prompt=list(prompt), priority=0,
                         sampling=SamplingParams(max_new_tokens=32),
                         on_done=mk("low"))
        sup.submit(low)
        sup.submit(GenRequest(prompt=list(prompt), priority=3,
                              sampling=SamplingParams(max_new_tokens=32),
                              on_done=mk("high")))
        wait_until(lambda: eng.metrics.counters["requests_shed"].value >= 1,
                   30.0, what="a shed request")
        time.sleep(0.5)
        t_heal = time.time()
        chaos.heal_pool()
        for k, e in events.items():
            if not e.wait(120):
                fail(f"api (d): the {k}-priority request never finished")
        st = sup.status()
        low_toks, low_reason, low_t = results["low"]
        emit("api", step="d_shed_heal", squeezed_pages=squeezed,
             supervisor_retries=retries, supervisor_backoff_s=backoff_s,
             requests_shed=st["requests_shed"],
             requests_retried=st["requests_retried"],
             low=dict(reason=low_reason, tokens=len(low_toks),
                      served_s_after_heal=low_t - t_heal,
                      within_deadline=low_t < low.deadline),
             high=dict(reason=results["high"][1],
                       tokens=len(results["high"][0])),
             paged_max_step_s=eng.max_step_s)
        if not (st["requests_shed"] >= 1 and st["requests_retried"] >= 1
                and low_reason == "length" and len(low_toks) == 32
                and low_t < low.deadline
                and results["high"][1] == "length"):
            fail(f"api (d): shed/heal failed: {results} status={st}")
    finally:
        chaos.stop()
        sup.stop()
        eng.stop()


def run_api(card, params):
    """The api phase: the wire API and supervised serving on Llama-3-8B
    (the serves' weights), then the server entry point as a subprocess.
    Returns the launches of the in-process steps (counted from zero)."""
    import gc
    import tempfile

    import torch

    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    try:
        import aiohttp  # noqa: F401
        import yaml  # noqa: F401
        have_http = True
    except ImportError as exc:
        emit("api", step="imports", missing=str(exc))
        have_http = False
    emit("api", step="start", card=card)
    backend = "h100-0"
    save_dir = tempfile.mkdtemp(prefix="swarm_api_")
    launches_before = dict(ac.LAUNCHES)
    ac.reset_launches()
    # the default (dense) engine, supervised by the service
    db = SwarmDB(broker=LocalBroker(), save_dir=save_dir)
    with engine_env(chunked=True):
        eng, tok = build_backend_engine(
            "llama3-8b", seed=0, device="cuda", params=params,
            metrics=db.metrics)
    svc = ServingService(db, eng, visible_tokenizer(tok.vocab_size),
                         backend_id=backend)
    try:
        if eng.paged is not None or svc.supervisor is None:
            fail("api: expected the dense engine under a supervisor")
        svc.start()
        db.register_agent("assistant")
        if have_http:
            asyncio.run(_api_http(db, svc, backend,
                                  lambda: kill_replay(svc, eng)))
        else:
            kill_replay(svc, eng)
    finally:
        svc.stop()
        db.close()
        del svc, eng
        gc.collect()
        torch.cuda.empty_cache()
    shed_heal(params)
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict(ac.LAUNCHES)
    emit("api", step="kernels", launches_before_phase={
        k: n for k, n in launches_before.items() if n},
        launches_in_phase={k: n for k, n in launches.items() if n})
    need = ("dense_decode_chunked", "ragged_prefill", "paged_decode_chunked")
    if not all(launches[k] > 0 for k in need):
        fail(f"api: kernels {need} must launch in the phase: {launches}")
    if have_http:
        run_server_process(save_dir)
    return launches


def run_server_process(save_dir):
    """(e) ``python -m swarmdb_tpu_torch.api.server`` with SERVE_MODEL =
    tiny-debug on the card: /health names it, one message is answered,
    then the server stops on SIGTERM."""
    import socket
    import urllib.request

    import torch

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, SERVE_MODEL="tiny-debug", API_HOST="127.0.0.1",
               API_PORT=str(port), SAVE_DIR=os.path.join(save_dir, "srv"),
               JWT_SECRET_KEY="chip-smoke", SERVE_MAX_SEQ="256",
               SWARMDB_PREWARM="1", PYTHONPATH=str(ROOT))
    env.pop("SWARMDB_PAGED", None)
    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "swarmdb_tpu_torch.api.server"], cwd=str(ROOT),
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)

    def call(path, body=None, headers=None):
        req = urllib.request.Request(
            url + path, data=None if body is None else
            json.dumps(body).encode(), headers={
                "Content-Type": "application/json", **(headers or {})},
            method="GET" if body is None else "POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read().decode()

    try:
        health = None
        while time.perf_counter() - t0 < 180:
            if proc.poll() is not None:
                fail(f"api (e): the server exited with {proc.returncode}: "
                     f"{proc.stderr.read().decode()[-2000:]}")
            try:
                health = json.loads(call("/health"))
                break
            except OSError:
                time.sleep(0.5)
        if health is None:
            fail("api (e): the server never answered /health")
        up_s = time.perf_counter() - t0
        device = (health.get("tpu") or {}).get("device", "")
        # SWARMDB_PREWARM=1: start() captured every variant's graph on the
        # server's main thread, before any request
        prewarmed = health["tpu"]["engine"]["decode_chunks"]["graphs"]
        tokn = json.loads(call("/auth/token", {"username": "admin",
                                               "password": "pw"}))
        hdr = {"Authorization": f"Bearer {tokn['access_token']}"}
        call("/agents/register", {"agent_id": "assistant"}, hdr)
        call("/admin/llm_backend", {"agent_id": "assistant",
                                    "backend_id": "gpu-0"}, hdr)
        body = call("/messages", {
            "receiver_id": "assistant", "content": "hello from the smoke",
            "stream": True,
            "metadata": {"generation": {"max_new_tokens": 8}}}, hdr)
        events = _sse_events(body.splitlines())
        reply = [d for e, d in events if e == "reply"]
        emit("api", step="e_server_process", seconds_to_health=up_s,
             health_device=device, engine=health["tpu"]["engine"]["cache"],
             reply_finish_reason=(reply[0]["metadata"]["finish_reason"]
                                  if reply else None),
             token_events=sum(e == "token" for e, _ in events),
             prewarmed_graphs=prewarmed)
        if torch.cuda.get_device_name(0) not in device or not reply:
            fail(f"api (e): /health device {device!r}, reply {reply}")
        if prewarmed != [0, 1, 2]:
            fail(f"api (e): SWARMDB_PREWARM=1 captured graphs {prewarmed}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


# --------------------------------------------------------------------- obs


#: The obs phase's two engines: (name, paged), the default dense one and
#: the paged one over a bf16 pool, both chunked.
OBS_MODES = (("dense_chunked", None), ("paged_bf16_chunked", True))
#: The SLO sentinel's settings while the obs phase serves.
OBS_SLO_ENV = dict(SWARMDB_SLO_WINDOW_S="2", SWARMDB_SLO_WARMUP="1",
                   SWARMDB_SLO_MIN_COMPLETIONS="4")
OBS_USERS = 4
#: Spans every served message's trace must hold, by the id they carry:
#: the message id, and the engine request id (``serve.request`` joins
#: them); ``api.request`` and ``engine.host_sync`` carry neither.
OBS_MSG_SPANS = ("runtime.send", "broker.publish", "serve.request")
OBS_ENGINE_SPANS = ("engine.admit", "engine.prefill")
#: The six histogram blocks of /metrics, as the JAX package's server has
#: them.
OBS_HISTOGRAMS = ("broker_publish_seconds", "dataplane_rtt_seconds",
                  "decode_chunk_seconds", "queue_wait_seconds",
                  "replication_commit_seconds", "ttft_seconds")
#: The overhead A/B: alternating pairs of turns with the tracer, the
#: histograms and the sentinel on and off; the phase fails above the
#: bound of the JAX package's own smoke test (its budget is 5%).
OBS_AB_PAIRS = 3
OBS_OVERHEAD_FAIL_PCT = 20.0
OBS_ECHO_SEGMENT_S = 1.0
#: Turns a round may take to close a window of the sentinel's minimum
#: completions (a window boundary can fall inside a round's burst).
OBS_ROUND_TRIES = 3
OBS_THIRD = ("One more thing from {u}: which of the three days is best "
             "for a museum pass, and why?")
OBS_LAST = "Last question from {u}: how long is the walk?"


def _obs_set(db, on: bool) -> None:
    """Tracer, histograms (with exemplars), sentinel, device-time
    profiler and memory accountant, together."""
    from swarmdb_tpu_torch.obs import HISTOGRAMS, TRACER
    from swarmdb_tpu_torch.obs.memprof import memprof
    from swarmdb_tpu_torch.obs.profiler import profiler

    TRACER.set_enabled(on)
    HISTOGRAMS.set_enabled(on)
    HISTOGRAMS.set_exemplars_enabled(on)
    db.sentinel.set_enabled(on)
    profiler().set_enabled(on)
    memprof().set_enabled(on)


def _echo_loop(db, seconds: float) -> float:
    """``bench.py``'s ``_echo_loop``: ping-pong round trips through the
    runtime alone (no engine); messages per second."""
    db.register_agent("ping")
    db.register_agent("pong")
    for _ in range(50):
        db.send_message("ping", "pong", "warm")
        db.receive_messages("pong", max_messages=10, timeout=0.0)
    t0 = time.time()
    roundtrips = 0
    while time.time() - t0 < seconds:
        db.send_message("ping", "pong", "ping!")
        got = db.receive_messages("pong", max_messages=1, timeout=1.0)
        if got:
            db.send_message("pong", "ping", "pong!")
            back = db.receive_messages("ping", max_messages=1, timeout=1.0)
            if back:
                roundtrips += 1
    return 2 * roundtrips / (time.time() - t0)


def echo_ab() -> dict:
    """The host-only A/B: the echo loop in segments with the
    observability on and off (on, off, off, on, on, off) over one
    runtime, the sentinel's window short enough to close inside each
    segment; medians."""
    import tempfile

    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    db = SwarmDB(broker=LocalBroker(), autosave_interval=1e9,
                 save_dir=tempfile.mkdtemp(prefix="swarm_echo_"))
    db.sentinel.config.window_s = 0.25
    rates = {True: [], False: []}
    try:
        for on in (True, False, False, True, True, False):
            _obs_set(db, on)
            rates[on].append(_echo_loop(db, OBS_ECHO_SEGMENT_S))
    finally:
        _obs_set(db, True)
        db.close()
    on, off = (statistics.median(rates[True]),
               statistics.median(rates[False]))
    return {"echo_msgs_per_s_on": rates[True],
            "echo_msgs_per_s_off": rates[False],
            "echo_overhead_pct": (off - on) / off * 100 if off else None}


def run_obs(card, params):
    """The obs phase (Llama-3-8B at full width on the serve phase's
    weights): both engines through the wire API with the tracer,
    histograms and sentinel on, then the echo A/B. Returns the phase's
    launches."""
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    t0 = time.perf_counter()
    ac.reset_launches()
    for name, paged in OBS_MODES:
        obs_serve(card, params, name, paged)
    launches = dict(ac.LAUNCHES)
    echo = echo_ab()
    emit("obs", part="done", seconds=time.perf_counter() - t0,
         launches={k: n for k, n in launches.items() if n}, card=card,
         **echo)
    need = ("dense_decode_chunked", "ragged_prefill", "paged_decode_chunked")
    if not all(launches[k] > 0 for k in need):
        fail(f"obs: kernels {need} must launch in the phase: {launches}")
    return launches


def obs_serve(card, params, name, paged):
    """One engine of the obs phase, served in process through
    ``create_app`` on 127.0.0.1:0 (the api phase's way)."""
    import tempfile

    import torch

    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.obs import HISTOGRAMS, TRACER

    flight_dir = tempfile.mkdtemp(prefix="swarm_obs_flight_")
    drop_app_cache()
    TRACER.reset()
    HISTOGRAMS.reset()
    with env_scope(SWARMDB_FLIGHT_DIR=flight_dir, SWARMDB_SENTINEL=None,
                   SWARMDB_TRACE=None, SWARMDB_HISTOGRAMS=None,
                   SWARMDB_SLO_TTFT_P95_S=None, **OBS_SLO_ENV):
        db = SwarmDB(broker=LocalBroker(),
                     save_dir=tempfile.mkdtemp(prefix="swarm_obs_"))
        _obs_set(db, True)
        with engine_env(chunked=True):
            eng, tok = build_backend_engine(
                "llama3-8b", seed=0, device="cuda", params=params,
                paged=paged, kv_dtype=torch.bfloat16 if paged else None,
                metrics=db.metrics)
        svc = ServingService(db, eng, visible_tokenizer(tok.vocab_size),
                             backend_id="h100-obs")
        # the live snapshot slots of every processed chunk, counted
        # outside the engine's own span code
        slots = [0]
        process = eng._process_host_block

        def counted(block, lps, snapshot, t_dispatch_ns):
            slots[0] += len(snapshot)
            return process(block, lps, snapshot, t_dispatch_ns)

        eng._process_host_block = counted
        try:
            svc.start(warmup=True)
            asyncio.run(_obs_http(db, svc, eng, slots, name, bool(paged),
                                  flight_dir, card))
        finally:
            svc.stop()
            db.close()
            del eng._process_host_block
            del svc, eng, process, counted
            drop_app_cache()
            torch.cuda.empty_cache()


async def _obs_http(db, svc, eng, slots, name, paged, flight_dir, card):
    import aiohttp
    from aiohttp import web

    from swarmdb_tpu_torch.api.app import ApiConfig, create_app
    from swarmdb_tpu_torch.obs.sentinel import SLOConfig

    app = create_app(db, ApiConfig(jwt_secret_key="chip-smoke",
                                   rate_limit_per_minute=100_000),
                     serving=svc)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    url = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
    c = db.metrics.counters
    try:
        async with aiohttp.ClientSession() as s:
            async def token(user):
                async with s.post(url + "/auth/token", json={
                        "username": user, "password": "pw"}) as r:
                    return {"Authorization":
                            f"Bearer {(await r.json())['access_token']}"}

            async def get(path):
                async with s.get(url + path, headers=admin) as r:
                    if r.status != 200:
                        fail(f"obs {name}: GET {path} gave {r.status}")
                    if path.startswith("/metrics"):
                        return await r.text()
                    return await r.json()

            admin = await token("admin")
            hdr = {}

            async def turn(users, text, one_wave=False):
                """One message per user at once, streamed; every reply
                must end length / eos. Returns (message ids, wall s).
                ``one_wave``: the engine's loop is held at its chaos seam
                until every message is queued, so the turn admits in one
                wave (the A/B's turns then differ by the observability,
                not by how the arrivals met the loop); the wall starts
                at the release."""
                for u in users:
                    if u not in hdr:
                        hdr[u] = await token(u)
                        db.register_agent(u)
                gate = threading.Event()
                if one_wave:
                    eng.chaos_step = lambda e: gate.wait(30)
                t0 = time.perf_counter()
                runs = [asyncio.ensure_future(_stream_post(
                    s, url, "/messages", hdr[u], {
                        "receiver_id": "assistant", "stream": True,
                        "content": text.format(u=u),
                        "metadata": {"generation": API_GEN}}))
                    for u in users]
                if one_wave:
                    deadline = time.time() + 30
                    while time.time() < deadline:
                        with eng._cv:
                            if len(eng._queue) >= len(users):
                                break
                        await asyncio.sleep(0.002)
                    eng.chaos_step = None
                    t0 = time.perf_counter()
                    gate.set()
                runs = await asyncio.gather(*runs)
                wall = time.perf_counter() - t0
                ids = []
                for events, _ in runs:
                    reply = [d for e, d in events if e == "reply"]
                    if not reply or reply[0]["metadata"].get(
                            "finish_reason") not in ("length", "eos"):
                        fail(f"obs {name}: a reply did not end length/eos")
                    ids.append([d for e, d in events
                                if e == "message"][0]["id"])
                return ids, wall

            async def close_window():
                """Wait out the sentinel's window, then close it
                (``?tick=1``)."""
                wait = db.sentinel._deadline - time.monotonic()
                await asyncio.sleep(max(0.0, wait) + 0.05)
                return await get("/admin/slo?tick=1")

            async def idle():
                deadline = time.time() + 60
                while (eng._any_active() or eng._in_step) and \
                        time.time() < deadline:
                    await asyncio.sleep(0.02)
                await asyncio.sleep(0.3)

            db.register_agent("assistant")
            db.assign_llm_backend("assistant", "h100-obs")
            users = [f"user{i}" for i in range(OBS_USERS)]
            # rounds 1-2: 4 users x 2 turns; a round repeats (at most
            # OBS_ROUND_TRIES) while no window of the sentinel's minimum
            # completions has closed to train the baseline
            ids, tries = [], 0
            for text in (USER_TEXT, FOLLOW_UP):
                got, _ = await turn(users, text)
                ids += got
                slo = await close_window()
            while slo["baseline"] is None and tries < OBS_ROUND_TRIES:
                tries += 1
                got, _ = await turn(users, FOLLOW_UP)
                ids += got
                slo = await close_window()
            await idle()
            served = len(ids)
            # spans, by message id and engine request id
            trace = await get("/admin/trace/export")
            spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
            by_rid = {}
            for e in spans:
                rid = (e.get("args") or {}).get("rid")
                by_rid.setdefault(rid, []).append(e)
            names = [e["name"] for e in spans]
            missing, engine_rids = [], []
            for mid in ids:
                mnames = [e["name"] for e in by_rid.get(mid, [])]
                serve = [e for e in by_rid.get(mid, [])
                         if e["name"] == "serve.request"]
                rid = serve[0]["args"]["engine_rid"] if serve else None
                engine_rids.append(rid)
                enames = [e["name"] for e in by_rid.get(rid, [])]
                if (not all(n in mnames for n in OBS_MSG_SPANS)
                        or not all(n in enames for n in OBS_ENGINE_SPANS)
                        or enames.count("engine.decode_chunk") < 2):
                    missing.append((mid, sorted(set(mnames)),
                                    sorted(set(enames))))
            api_posts = sum(1 for e in spans if e["name"] == "api.request"
                            and e["args"].get("path") == "/messages")
            # the same trace through the cluster merge, trace by trace
            # (the export also carries the profiler's device tracks, cat
            # "device", which the cluster merge of host spans does not)
            cluster_equal = True
            for tid in ids[:2] + engine_rids[:2]:
                a = await get(f"/admin/trace/export?trace_id={tid}")
                b = await get(f"/admin/cluster/trace?trace_id={tid}")
                cluster_equal &= (
                    sum(e.get("ph") == "X" and e.get("cat") != "device"
                        for e in a["traceEvents"])
                    == sum(e.get("ph") == "X" for e in b["traceEvents"])
                    and b["metadata"]["unreachable"] == [])
            flight = await get("/admin/flight")
            last = flight["steps"][-1] if flight["steps"] else {}
            settled = {k: (last.get(k), c[ctr].value) for k, ctr in (
                ("tokens_generated", "tokens_generated"),
                ("prompt_tokens", "prompt_tokens"),
                ("prefill_packed_tokens", "prefill_packed_tokens"),
                ("host_syncs", "engine_host_syncs"),
                ("restarts", "engine_restarts"))}
            metrics = await get("/metrics")
            hist_blocks = sorted(
                ln.split()[2][len("swarmdb_"):] for ln in
                metrics.splitlines() if ln.startswith("# TYPE swarmdb_")
                and ln.endswith(" histogram"))
            ttft_count = next(int(ln.split()[1]) for ln in
                              metrics.splitlines()
                              if ln.startswith("swarmdb_ttft_seconds_count"))
            phase = {k: c[f"phase_us_{k}"].value for k in
                     ("queue_wait", "prefill", "decode", "host_sync")}
            checks = {
                "every message's spans": not missing,
                f"api.request per POST /messages ({served})":
                    api_posts >= served,
                "engine.host_sync in the process":
                    names.count("engine.host_sync") >= 1,
                "export not truncated": not trace["metadata"].get(
                    "truncated"),
                "decode_chunk spans == live snapshot slots":
                    names.count("engine.decode_chunk") == slots[0] > 0,
                "flight step and request rings": bool(
                    flight["steps"]) and bool(flight["requests"]),
                "last step's counters == db.metrics": all(
                    a == b for a, b in settled.values()),
                "six histogram blocks": hist_blocks == list(OBS_HISTOGRAMS),
                "ttft_seconds_count == requests served": ttft_count
                    == served,
                "phase_us_queue_wait > 0": phase["queue_wait"] > 0,
                "phase_us_host_sync > 0": phase["host_sync"] > 0,
                "cluster trace == trace export": cluster_equal,
                "baseline learned": slo["baseline"] is not None,
            }
            emit("obs", serve=name, model="llama3-8b", served=served,
                 extra_rounds=tries, spans={n: names.count(n) for n in
                                            sorted(set(names))},
                 decode_chunk_slots=slots[0], api_message_posts=api_posts,
                 flight_steps=len(flight["steps"]),
                 flight_requests=len(flight["requests"]),
                 last_step=last, settled=settled,
                 request_record=flight["requests"][-1]
                 if flight["requests"] else None,
                 histograms=hist_blocks, ttft_seconds_count=ttft_count,
                 phase_us=phase, host_syncs=c["engine_host_syncs"].value,
                 decode_chunks=c["engine_decode_chunks"].value,
                 sentinel=dict(windows_total=slo["windows_total"],
                               baseline=slo["baseline"],
                               last_window=slo["last_window"],
                               alerts_total=slo["alerts_total"]),
                 missing=missing[:4], card=card, checks=checks)
            bad = [k for k, ok in checks.items() if not ok]
            if bad:
                fail(f"obs {name} checks failed: {bad}")
            # a forced breach: TTFT p95 over 1 ms. Each try's turn gets a
            # window of its own, opened after the engine went idle and
            # closed after the turn's last completion: a dense turn takes
            # about as long as a 2 s window, and a deadline inside it
            # splits its first tokens from its completions (a window
            # under the minimum completions is idle, and the other
            # carries no TTFT)
            def ttft_alert(s):
                return next((a for a in reversed(s["alerts"]) if any(
                    b["slo"] == "ttft_p95_s" and b["limit"] == 0.001
                    for b in a["breaches"])), None)

            async def close_now():
                db.sentinel._deadline = time.monotonic()
                return await get("/admin/slo?tick=1")

            with env_scope(SWARMDB_SLO_TTFT_P95_S="0.001"):
                db.sentinel.config.ttft_p95_s = SLOConfig().ttft_p95_s
            db.sentinel.config.window_s = 3600.0
            third, tries = 0, 0
            while tries < OBS_ROUND_TRIES:
                tries += 1
                await idle()
                await close_now()
                got, _ = await turn(users, OBS_THIRD)
                third += len(got)
                await idle()
                slo = await close_now()
                if ttft_alert(slo) is not None:
                    break
            db.sentinel.config.window_s = SLOConfig().window_s
            db.sentinel._deadline = (time.monotonic()
                                     + db.sentinel.config.window_s)
            alert = ttft_alert(slo)
            shares = alert["diagnosis"]["shares"] if alert else {}
            dumps = sorted(os.listdir(flight_dir))
            breach = {
                "/admin/slo breached": slo["breached"] is True,
                "an alert on ttft_p95_s > 0.001": alert is not None,
                "shares sum to 1 within 1e-3": bool(shares) and abs(
                    sum(shares.values()) - 1.0) <= 1e-3,
                "dominant contributor named": bool(alert) and alert[
                    "dominant"] in shares,
                "flight dump with the alert id": bool(alert) and bool(
                    alert["flight_dump"]) and alert["id"] in
                    os.path.basename(alert["flight_dump"])
                    and os.path.exists(alert["flight_dump"]),
                "trace dump with the alert id": bool(alert) and bool(
                    alert["trace_dump"]) and alert["id"] in
                    os.path.basename(alert["trace_dump"])
                    and os.path.exists(alert["trace_dump"]),
            }
            emit("obs", serve=name, part="forced_breach", turns=third,
                 tries=tries, breached=slo["breached"],
                 alerts_total=slo["alerts_total"],
                 alert=None if alert is None else dict(
                     id=alert["id"], breaches=alert["breaches"],
                     dominant=alert["dominant"], shares=shares,
                     explanation=alert["diagnosis"]["explanation"],
                     flight_dump=alert["flight_dump"],
                     trace_dump=alert["trace_dump"]),
                 flight_dir_files=dumps, card=card, checks=breach)
            bad = [k for k, ok in breach.items() if not ok]
            if bad:
                fail(f"obs {name} forced breach failed: {bad}")
            with env_scope(SWARMDB_SLO_TTFT_P95_S=None):
                db.sentinel.config.ttft_p95_s = SLOConfig().ttft_p95_s
            if not paged:
                return
            # the idle share split: one untraced turn's wall and phase
            # counters, then the same turn profiled (on this thread: the
            # profiler registers with the device here) for the device's
            # busy time; the streamed turns' replies are read first, so
            # each turn waits for its own
            await idle()
            for u in users:
                db.receive_messages(u, max_messages=10 ** 4, timeout=0.05)
            before = {k: c[f"phase_us_{k}"].value for k in phase}
            syncs0 = c["engine_host_syncs"].value
            t0 = time.perf_counter()
            for u in users:
                db.send_message(u, "assistant", OBS_LAST.format(u=u),
                                metadata={"generation": API_GEN})
            if len(await_replies(db, users)) < len(users):
                fail(f"obs {name}: the untraced turn lost a reply")
            wall_ms = (time.perf_counter() - t0) * 1e3
            await idle()
            split = {k: (c[f"phase_us_{k}"].value - before[k]) / 1e3
                     for k in phase}
            syncs = c["engine_host_syncs"].value - syncs0
            prof = profile_turn(db, users, OBS_LAST)
            emit("obs", serve=name, part="turn_split",
                 untraced_turn_wall_ms=wall_ms, phase_ms=split,
                 host_syncs=syncs,
                 profiled_turn_wall_ms=prof["wall_ms"],
                 device_busy_ms=prof["device_busy_ms"],
                 device_idle_share_vs_untraced=1.0
                 - prof["device_busy_ms"] / wall_ms,
                 note="queue_wait sums over the turn's requests; decode "
                      "holds the host's waits (host_sync)",
                 card=card)
            # the overhead A/B: one-wave turns of fresh users (no history)
            # with the observability on and off, alternating in the order
            # on-off, off-on, on-off (an order effect cancels)
            walls, turns_ab = {True: [], False: []}, []
            order = [(True, False), (False, True), (True, False)]
            for i, pair in enumerate(order[:OBS_AB_PAIRS]):
                for on in pair:
                    await idle()
                    _obs_set(db, on)
                    c0 = {k: c[k].value for k in (
                        "engine_admission_waves", "engine_decode_chunks",
                        "phase_us_queue_wait", "phase_us_prefill",
                        "phase_us_decode", "phase_us_host_sync")}
                    _, wall = await turn(
                        [f"ab{i}_{int(on)}_{j}" for j in range(OBS_USERS)],
                        USER_TEXT, one_wave=True)
                    walls[on].append(wall)
                    turns_ab.append(dict(on=on, wall_s=wall, **{
                        k: c[k].value - v for k, v in c0.items()}))
            _obs_set(db, True)
            on, off = (statistics.median(walls[True]),
                       statistics.median(walls[False]))
            pct = (on - off) / off * 100
            emit("obs", serve=name, part="overhead_ab",
                 turn_wall_s_on=walls[True], turn_wall_s_off=walls[False],
                 tracer_overhead_pct=pct,
                 spread_pct=[(max(walls[True]) - min(walls[False]))
                             / min(walls[False]) * 100,
                             (min(walls[True]) - max(walls[False]))
                             / max(walls[False]) * 100],
                 turns=turns_ab, budget_pct=5.0,
                 fail_above_pct=OBS_OVERHEAD_FAIL_PCT, card=card)
            if pct > OBS_OVERHEAD_FAIL_PCT:
                fail(f"obs {name}: tracer_overhead_pct {pct:.2f} above "
                     f"{OBS_OVERHEAD_FAIL_PCT}")
    finally:
        await runner.cleanup()


# -------------------------------------------------------------------- prof


#: (name, engine: True = paged / None = the default dense one) of the prof
#: phase, both chunked over bf16 caches.
PROF_MODES = (("dense_chunked", None), ("paged_bf16_chunked", True))
PROF_USERS = 4
#: The profiler's busy seconds against the torch.profiler union of kernel
#: intervals of one turn: at least this share (prefill event spans may
#: exceed the union by launch gaps; the upper bound is the turn's wall
#: over the union).
PROF_BUSY_MIN_RATIO = 0.9
PROF_FIRST = "Profile me, {u}: plan a short walking tour of the old town."


def run_prof(card, params):
    """The prof phase (Llama-3-8B at full width on the serve phase's
    weights): the device-time profiler and the memory accountant on the
    dense and paged bf16 chunked engines through the wire API. Returns
    the phase's launches."""
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    t0 = time.perf_counter()
    ac.reset_launches()
    for name, paged in PROF_MODES:
        prof_serve(card, params, name, paged)
    launches = dict(ac.LAUNCHES)
    emit("prof", part="done", seconds=time.perf_counter() - t0,
         launches={k: n for k, n in launches.items() if n}, card=card)
    need = ("dense_decode_chunked", "ragged_prefill", "paged_decode_chunked")
    if not all(launches[k] > 0 for k in need):
        fail(f"prof: kernels {need} must launch in the phase: {launches}")
    return launches


def prof_serve(card, params, name, paged):
    """One engine of the prof phase: fresh profiler and accountant
    registries, the engine warmed (the harvest), then served in process
    through ``create_app`` on 127.0.0.1:0."""
    import tempfile

    import torch

    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.obs.memprof import memprof
    from swarmdb_tpu_torch.obs.profiler import profiler

    dump_dir = tempfile.mkdtemp(prefix="swarm_prof_")
    drop_app_cache()
    with env_scope(SWARMDB_PROFILE="1", SWARMDB_MEMPROF="1",
                   SWARMDB_SENTINEL=None, SWARMDB_FLIGHT_DIR=None,
                   SWARMDB_SLO_TTFT_P95_S=None, **OBS_SLO_ENV):
        profiler().reset()
        memprof().reset()
        profiler().set_enabled(True)
        memprof().set_enabled(True)
        db = SwarmDB(broker=LocalBroker(),
                     save_dir=tempfile.mkdtemp(prefix="swarm_prof_db_"))
        with engine_env(chunked=True):
            eng, tok = build_backend_engine(
                "llama3-8b", seed=0, device="cuda", params=params,
                paged=paged, kv_dtype=torch.bfloat16 if paged else None,
                metrics=db.metrics)
        svc = ServingService(db, eng, visible_tokenizer(tok.vocab_size),
                             backend_id="h100-prof")
        try:
            svc.start(warmup=True)
            asyncio.run(_prof_http(db, svc, eng, name, bool(paged),
                                   dump_dir, card))
        finally:
            svc.stop()
            db.close()
            del svc, eng
            drop_app_cache()
            torch.cuda.empty_cache()


def drop_app_cache() -> None:
    """Let go of the services that earlier in-process servers served:
    aiohttp caches each handler's middleware chain per application
    (``web_app._cached_build_middleware``, an ``lru_cache``), which holds
    the application, and through it its service and engine, after the
    runner is cleaned up. Then collect, so their profiler lanes and
    accountant pools leave the process-global registries."""
    import gc

    from aiohttp import web_app

    cached = getattr(web_app, "_cached_build_middleware", None)
    if cached is not None and hasattr(cached, "cache_clear"):
        cached.cache_clear()
    gc.collect()


def prof_turn_union(db, users, text, lane):
    """One more turn under ``torch.profiler`` (device only): the union of
    its kernel intervals, and the profiler's busy time of the engine's
    lane over the same turn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    busy0 = lane.busy_ns
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for u in users:
            db.send_message(u, "assistant", text.format(u=u),
                            metadata={"generation": API_GEN})
        got = await_replies(db, users)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if len(got) < len(users):
        fail(f"prof: profiled turn: {len(got)} of {len(users)} replies")
    spans = [(s, e) for _, s, e in _device_events(prof) if e > s]
    if not spans:
        fail("prof: the profiled turn shows no device interval")
    return dict(wall_ms=wall_ms, union_ms=_union_us(spans) / 1e3,
                profiler_busy_ms=(lane.busy_ns - busy0) / 1e6,
                kernel_intervals=len(spans))


async def _prof_http(db, svc, eng, name, paged, dump_dir, card):
    import aiohttp
    from aiohttp import web

    from swarmdb_tpu_torch.api.app import ApiConfig, create_app
    from swarmdb_tpu_torch.obs.memprof import memprof
    from swarmdb_tpu_torch.obs.profiler import profiler

    prof = profiler()
    variants0 = prof.variants_report()
    harvest0 = prof.harvest_calls
    app = create_app(db, ApiConfig(jwt_secret_key="chip-smoke",
                                   rate_limit_per_minute=100_000),
                     serving=svc)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    url = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
    c = db.metrics.counters
    try:
        async with aiohttp.ClientSession() as s:
            async def token(user):
                async with s.post(url + "/auth/token", json={
                        "username": user, "password": "pw"}) as r:
                    return {"Authorization":
                            f"Bearer {(await r.json())['access_token']}"}

            async def get(path):
                async with s.get(url + path, headers=admin) as r:
                    if r.status != 200:
                        fail(f"prof {name}: GET {path} gave {r.status}")
                    if path.startswith("/metrics"):
                        return await r.text()
                    return await r.json()

            admin = await token("admin")
            hdr = {}

            async def turn(users, text, one_wave=False):
                """One streamed message per user at once; every reply
                must end length / eos. ``one_wave``: the loop is held at
                its chaos seam until every message is queued (the obs
                phase's way), so the turn admits in one wave."""
                for u in users:
                    if u not in hdr:
                        hdr[u] = await token(u)
                        db.register_agent(u)
                gate = threading.Event()
                if one_wave:
                    eng.chaos_step = lambda e: gate.wait(30)
                runs = [asyncio.ensure_future(_stream_post(
                    s, url, "/messages", hdr[u], {
                        "receiver_id": "assistant", "stream": True,
                        "content": text.format(u=u),
                        "metadata": {"generation": API_GEN}}))
                    for u in users]
                if one_wave:
                    deadline = time.time() + 30
                    while time.time() < deadline:
                        with eng._cv:
                            if len(eng._queue) >= len(users):
                                break
                        await asyncio.sleep(0.002)
                    eng.chaos_step = None
                    gate.set()
                runs = await asyncio.gather(*runs)
                for events, _ in runs:
                    reply = [d for e, d in events if e == "reply"]
                    if not reply or reply[0]["metadata"].get(
                            "finish_reason") not in ("length", "eos"):
                        fail(f"prof {name}: a reply did not end "
                             f"length/eos")

            async def close_window():
                wait = db.sentinel._deadline - time.monotonic()
                await asyncio.sleep(max(0.0, wait) + 0.05)
                return await get("/admin/slo?tick=1")

            async def idle():
                deadline = time.time() + 60
                while (eng._any_active() or eng._in_step) and \
                        time.time() < deadline:
                    await asyncio.sleep(0.02)
                await asyncio.sleep(0.3)

            db.register_agent("assistant")
            db.assign_llm_backend("assistant", "h100-prof")
            users = [f"puser{i}" for i in range(PROF_USERS)]
            need_w = ["mfu", "min_lane_duty", "prefix_hit_rate"] + (
                ["mem_headroom_frac"] if paged else [])

            def carries(w):
                return bool(w) and all(w.get(k) is not None for k in need_w)

            # 2 turns; a follow-up round repeats (at most OBS_ROUND_TRIES)
            # while no window closed during the traffic carries the four
            # fields (the first closes only anchor the deltas)
            windows, tries = [], 0
            for text in (USER_TEXT, FOLLOW_UP):
                await turn(users, text)
                windows.append((await close_window())["last_window"])
            while not any(carries(w) for w in windows) and \
                    tries < OBS_ROUND_TRIES:
                tries += 1
                await turn(users, FOLLOW_UP)
                windows.append((await close_window())["last_window"])
            await idle()
            # host syncs per request with the profiler and accountant on
            # and off, over the same one-turn requests of fresh users
            syncs = {}
            for on in (True, False):
                prof.set_enabled(on)
                memprof().set_enabled(on)
                s0, r0 = c["engine_host_syncs"].value, c[
                    "engine_completed"].value
                await turn([f"sync{int(on)}_{j}" for j in
                            range(PROF_USERS)], USER_TEXT, one_wave=True)
                await idle()
                syncs[on] = ((c["engine_host_syncs"].value - s0)
                             / max(1, c["engine_completed"].value - r0))
            prof.set_enabled(True)
            memprof().set_enabled(True)
            for u in users:
                db.receive_messages(u, max_messages=10 ** 4, timeout=0.05)
            ratio = prof_turn_union(db, users, PROF_FIRST, eng._prof)
            await idle()
            report = await get("/admin/profile")
            mem = await get("/admin/mem")
            metrics = await get("/metrics")
            trace = await get("/admin/trace/export")
            ppath = prof.dump_to(dump_dir, name)
            mpath = memprof().dump_to(dump_dir, name)
            analyzers = {}
            for flag, path in (("--roofline", ppath), ("--memory", mpath)):
                out = subprocess.run(
                    [sys.executable, "-m", "swarmdb_tpu_torch.obs.analyze",
                     flag, path], cwd=str(ROOT), capture_output=True,
                    text=True, timeout=120)
                body = json.loads(out.stdout) if out.returncode == 0 else {}
                analyzers[flag] = (out.returncode, body)
            roof = analyzers["--roofline"][1].get("dumps", [{}])[0]
            memrep = analyzers["--memory"][1].get("dumps", [{}])[0]
            ran = [v for v in report["variants"] if v["invocations"] > 0]
            kern = [v for v in ran if (v.get("meta") or {}).get("kernel")]
            decode = []
            for v in ran:
                if not v["variant"].startswith(("decode.", "resident.")):
                    continue
                per_ms = v["device_s"] / v["invocations"] * 1e3
                bps = (v["bytes_per_call"] * v["invocations"]
                       / v["device_s"])
                decode.append(dict(
                    variant=v["variant"], chunks=v["invocations"],
                    ms_per_chunk=per_ms, mfu=v.get("mfu"),
                    flops_per_chunk=v["flops_per_call"],
                    bytes_per_chunk=v["bytes_per_call"],
                    achieved_bytes_per_s=bps,
                    share_of_hbm=bps / HBM_BYTES_PER_S,
                    byte_bound_ms=v["bytes_per_call"] / HBM_BYTES_PER_S
                    * 1e3,
                    arithmetic_intensity=v.get("arithmetic_intensity"),
                    roofline=v.get("roofline")))
            occ = mem["occupancy"]
            custody = None
            if paged:
                alloc = eng.paged.allocator
                with alloc._lock:
                    in_slot = sum(len(sp.pages)
                                  for sp in alloc._by_slot.values())
                cached = eng._prefix.stats()["cached_pages"]
                pool = alloc.num_pages - 1
                custody = dict(free=alloc.free_count(), in_slot=in_slot,
                               prefix_cached=cached, pool=pool)
            window = next((w for w in reversed(windows) if carries(w)),
                          windows[-1] or {})
            upper = ratio["wall_ms"] / ratio["union_ms"]
            busy_ratio = ratio["profiler_busy_ms"] / ratio["union_ms"]
            checks = {
                "warmup harvested": harvest0 > 0,
                "device_s == 0 after warmup": all(
                    v["device_s"] == 0 for v in variants0),
                "harvest_calls flat across traffic":
                    report["harvest_calls"] == harvest0
                    == prof.harvest_calls,
                "host syncs per request equal on / off":
                    syncs[True] == syncs[False],
                "every executed variant timed, with a roofline row":
                    bool(ran) and all(
                        v["device_s"] > 0 and v.get("mfu") is not None
                        and v.get("roofline") for v in ran),
                "a decode variant executed": bool(decode),
                "report mfu in (0, 1]": report["mfu"] is not None
                    and 0 < report["mfu"] <= 1,
                f"busy / union in [{PROF_BUSY_MIN_RATIO}, wall / union]":
                    PROF_BUSY_MIN_RATIO <= busy_ratio <= upper,
                "/admin/profile kind": report["kind"] == "swarmdb.profile",
                "/admin/mem kind": mem["kind"] == "swarmdb.mem",
                # the dense engine has no page pool: its side prefix
                # pool's pages show as cached only
                "occupancy: total = free + active + cached_evictable "
                "+ pinned": not paged or occ["total_pages"] == occ["free"]
                    + occ["active"] + occ["cached_evictable"]
                    + occ["pinned"],
                "occupancy equals custody": custody is None or (
                    occ["total_pages"] == custody["pool"]
                    and occ["free"] == custody["free"]
                    and occ["active"] == custody["in_slot"]
                    and occ["cached_evictable"] + occ["pinned"]
                    == custody["prefix_cached"]
                    and custody["free"] + custody["in_slot"]
                    + custody["prefix_cached"] == custody["pool"]),
                "prefix lookups": mem["prefix"]["lookups"] > 0,
                f"a window carries {need_w}": carries(window),
                "/metrics profiler and accountant lines": all(
                    k in metrics for k in (
                        "swarmdb_mfu ", "swarmdb_lane_duty_cycle{",
                        "swarmdb_kernel_device_seconds_total{",
                        "swarmdb_mem_pool_pages{")),
                "trace export device tracks":
                    trace["metadata"].get("device_tracks", 0) >= 1,
                "analyze --roofline lists the variants":
                    analyzers["--roofline"][0] == 0
                    and bool(roof.get("top_variants")),
                "analyze --memory reads the dump":
                    analyzers["--memory"][0] == 0
                    and memrep.get("occupancy") is not None,
                "kernel variants carry their build's ptxas facts": all(
                    v["meta"].get("ptxas") for v in kern),
                # the paged dispatchers record shared memory per block
                # (the dense engine's decode dispatch records none, as in
                # the JAX package)
                "paged: kernel variants carry vmem_est_bytes": not paged
                    or (bool(kern) and all(
                        v.get("vmem_est_bytes") for v in kern)),
                "paged: analyze --roofline prints the column": not paged
                    or bool(roof.get("vmem_variants")),
            }
            emit("smem", step="served_profile", serve=name,
                 variants=[{k: v.get(k) for k in (
                     "variant", "vmem_est_bytes", "vmem_budget_bytes",
                     "vmem_utilization")} for v in kern],
                 ptxas={v["variant"]: v["meta"].get("ptxas") for v in kern},
                 roofline_budget=roof.get("vmem_budget_bytes"),
                 roofline_column=roof.get("vmem_variants"))
            emit("prof", serve=name, model="llama3-8b",
                 harvest_calls=harvest0, mfu=report["mfu"],
                 peaks=report["peaks"], platform=report["platform"],
                 device_kind=report["device_kind"], decode=decode,
                 variants=[{k: v.get(k) for k in (
                     "variant", "invocations", "device_s", "mfu",
                     "arithmetic_intensity", "roofline")} for v in ran],
                 lanes=report["lanes"],
                 dispatch_profile=report["dispatch_profile"],
                 tiny_flush_waves=report["tiny_flush_waves"],
                 host_syncs_per_request={"on": syncs[True],
                                         "off": syncs[False]},
                 profiled_turn=dict(ratio, busy_over_union=busy_ratio,
                                    wall_over_union=upper),
                 occupancy={k: occ[k] for k in (
                     "total_pages", "free", "active", "cached_evictable",
                     "pinned", "headroom_pages")},
                 custody=custody, prefix=mem["prefix"],
                 warm_tier=mem["warm_tier"][:1],
                 cold_resume=mem["cold_resume"], window=window,
                 extra_rounds=tries,
                 card=card, checks=checks)
            bad = [k for k, ok in checks.items() if not ok]
            if bad:
                fail(f"prof {name} checks failed: {bad}")
    finally:
        await runner.cleanup()


# ------------------------------------------------------------------- lanes


#: The lanes phase's group: ``build_serving_engine``'s lane defaults on
#: one card, two lanes of four slots sharing the serve phase's weights.
LANE_MODEL = "llama3-8b"
LANE_DEVICES = ("cuda:0", "cuda:0")
LANE_BATCH = 8
LANE_USERS = 8
LANE_NEW = 32
LANE_TRANSIT_MB = 1024


def lane_prompt(tok, i: int) -> list:
    """A ~400-token chat prompt that differs from every other from its
    first page on (no prefix-cache hit between them)."""
    return tok.encode(f"Message {i} from lane_user{i}. "
                      + USER_TEXT.format(u=f"lane_user{i}"))


def build_lanes(params, kind: str, metrics, fleet: bool = False):
    """A 2-lane Llama-3-8B group on ``LANE_DEVICES`` (pools of 512 pages
    of 16 per lane, the default rule), its graphs captured by
    ``warmup()``, and per-lane counters the engine does not keep apart
    (its metrics are the group's): ragged waves (calls of the lane's
    ragged forward) and waves admitted while the sibling decoded.
    ``fleet``: ``SWARMDB_FLEET=prefill:1,decode:1`` with a
    ``LANE_TRANSIT_MB`` transit store."""
    import torch

    from swarmdb_tpu_torch.parallel import build_serving_engine

    with env_scope(
            SWARMDB_FLEET="prefill:1,decode:1" if fleet else None,
            SWARMDB_FLEET_TRANSIT_MB=LANE_TRANSIT_MB if fleet else None,
            SWARMDB_FLEET_TIERS=None, SWARMDB_CHUNKED="1",
            SWARMDB_PAGED=None, SWARMDB_PREFIX_TOKENS=None,
            SWARMDB_EMIT_RING=None):
        g, info = build_serving_engine(
            LANE_MODEL, list(LANE_DEVICES), max_batch=LANE_BATCH,
            max_seq=1024, paged=True, page_size=16, decode_chunk=8,
            params=params, kv_dtype=getattr(torch, kind), metrics=metrics)
    if info.data_size != 2 or (g.fleet is not None) != fleet:
        fail(f"lanes: build gave {info.data_size} lanes, fleet "
             f"{g.fleet is not None}")
    waves = [0] * len(g.lanes)
    overlaps = [0] * len(g.lanes)
    for j, e in enumerate(g.lanes):
        fwd, probe = e.paged.prefill_ragged, e.overlap_probe

        def counted_fwd(*a, _f=fwd, _j=j):
            waves[_j] += 1
            return _f(*a)

        def counted_probe(_p=probe, _j=j):
            hit = _p()
            overlaps[_j] += bool(hit)
            return hit

        e.paged.prefill_ragged, e.overlap_probe = counted_fwd, counted_probe
    t0 = time.perf_counter()
    g.warmup()
    return g, waves, overlaps, time.perf_counter() - t0


def lane_custody(g) -> list:
    """Per lane, the engine idle: pages not free, in no slot and in no
    prefix-cache entry (0 when custody balances)."""
    out = []
    for e in g.lanes:
        alloc = e.paged.allocator
        held = sum(len(alloc.pages_for(s)) for s in range(e.max_batch))
        cached = e._prefix.stats()["cached_pages"]
        out.append(e.paged.num_pages - 1 - alloc.free_count() - held
                   - cached)
    return out


def lane_run(g, prompts, hints=None, on_token=None, timeout=300.0):
    """Submit greedy requests of ``LANE_NEW`` tokens through the group
    at once and wait: per request its tokens, reason, streamed tokens,
    logprobs and TTFT (first streamed token after submit)."""
    import threading

    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams

    n = len(prompts)
    done = [threading.Event() for _ in range(n)]
    outs = [{"streamed": []} for _ in range(n)]
    reqs = []
    for i, p in enumerate(prompts):
        def tok(rid, t, _o=outs[i], _i=i):
            if not _o["streamed"]:
                _o["ttft_s"] = time.perf_counter() - _o["t0"]
            _o["streamed"].append(t)
            if on_token is not None:
                on_token(_i, _o["streamed"])

        req = GenRequest(prompt=list(p), on_token=tok,
                         sampling=SamplingParams(max_new_tokens=LANE_NEW),
                         shard_hint=None if hints is None else hints[i])

        def fin(rid, toks, reason, _o=outs[i], _d=done[i], _r=req):
            # the finishing attempt's logprobs (a migration's replay, or
            # the fleet's two stages merged), read before any later
            # retirement of a killed attempt can overwrite them
            _o.update(toks=toks, reason=reason, logprobs=list(
                _r.metadata.get("logprobs") or []))
            _d.set()

        req.on_done = fin
        reqs.append(req)
    for o, r in zip(outs, reqs):
        o["t0"] = time.perf_counter()
        g.submit(r)
    for i, d in enumerate(done):
        if not d.wait(timeout):
            fail(f"lanes: request {i} never finished")
    return outs


def path_logprob_diffs(ref, got, start):
    """|logprob difference| of the chosen token at each step from
    ``start`` on while the two runs' tokens agree: ``ref`` and ``got`` are
    ``lane_run`` outputs; ``got``'s logprobs may cover only its last
    steps (a migration's replay)."""
    off = LANE_NEW - len(got["logprobs"])
    out = []
    for s in range(max(start, off), LANE_NEW):
        if ref["toks"][:s + 1] != got["toks"][:s + 1]:
            break
        out.append(abs(ref["logprobs"][s] - got["logprobs"][s - off]))
    return out


def first_step_logit_diff(eng, prompt) -> float:
    """Max |logit difference| of the two paths that decode the first
    token after ``prompt`` on lane ``eng`` (idle), over the same pages:
    the colocated decode's first step (the chunked paged forward, kernel 2
    over the pages and the chunk buffer) and the fleet's first stage-2
    step (the resume prefill, plain attention over the pages). The prompt's
    K/V comes from one kept admission of it (``keep_pages``); its pages are
    freed after. Kernel launches here are a measurement's, kept out of
    ``LAUNCHES``."""
    import threading

    import torch

    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams
    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    done, got = threading.Event(), {}
    eng.submit(GenRequest(
        prompt=list(prompt), sampling=SamplingParams(max_new_tokens=1),
        keep_pages=True,
        on_pages=lambda rid, pages, written, tail: got.update(
            pages=pages, written=written),
        on_done=lambda rid, toks, reason: (got.update(toks=toks),
                                           done.set())))
    if not done.wait(120) or "pages" not in got or not got["toks"]:
        fail(f"lanes: the kept admission for the logit check failed: {got}")
    cfg, dev = get_config(LANE_MODEL), eng.device
    pages, P = got["pages"], got["written"]
    i32 = dict(dtype=torch.int32, device=dev)
    tok = torch.tensor([[got["toks"][0]]], **i32)
    table = torch.zeros((1, eng.paged.allocator.maxp), **i32)
    table[0, :len(pages)] = torch.tensor(pages, **i32)
    ptab = torch.zeros((1, eng._pp_bucket_for(len(pages))), **i32)
    ptab[0, :len(pages)] = torch.tensor(pages, **i32)
    try:
        with ac.launches_into({}):
            a, _ = llama.forward_paged_chunked(
                eng.params, cfg, tok, torch.tensor([[P]], **i32),
                {"k": eng.cache["k"], "v": eng.cache["v"],
                 "page_table": table},
                llama.init_chunk_kv(cfg, 1, eng.decode_chunk, device=dev), 0)
            b, _, _ = llama.forward_prefix_pages(
                eng.params, cfg, tok, ptab, torch.tensor([P], **i32),
                eng.cache["k"], eng.cache["v"],
                logits_at=torch.zeros(1, dtype=torch.long, device=dev))
        return float((a[:, 0].float() - b.float()).abs().max())
    finally:
        eng.rolling_free(pages)


def first_parting(params, prompt, ref, got, tol):
    """Where ``got`` first parts from the greedy ``ref`` after ``prompt``:
    None when they are equal; else the step, the top-2 logit gap there
    (and the two parting tokens' gap) from a plain bf16 forward over the
    prompt and ``ref``'s tokens before the step, and whether the top-2 gap
    is below ``tol``, the difference this run measured between the two
    paths where they agree: then the parting is a near tie."""
    import torch

    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config

    i = next((k for k, (a, b) in enumerate(zip(ref, got)) if a != b), None)
    if i is None:
        return None
    cfg = get_config(LANE_MODEL)
    ctx = list(prompt) + list(ref[:i])
    T, dev = len(ctx), params["embed"].device
    logits, _ = llama.forward(
        params, cfg, torch.tensor([ctx], dtype=torch.int32, device=dev),
        torch.arange(T, dtype=torch.int32, device=dev)[None],
        llama.init_kv_cache(cfg, 1, T, device=dev),
        logits_at=torch.tensor([T - 1], device=dev))
    lg = logits[0].float()
    top2 = torch.topk(lg, 2).values
    pair = abs(float(lg[ref[i]] - lg[got[i]]))
    gap = float(top2[0] - top2[1])
    return dict(step=i, top2_gap=gap, pair_gap=pair, tol=tol,
                near_tie=gap < tol)


def profile_lanes_turn(db, users, text):
    """One more turn under ``torch.profiler`` (device only). Two lanes'
    kernels run on two streams and may overlap, so the device's busy time
    is the union of the kernels' intervals; the sum of their times is
    printed beside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for u in users:
            db.send_message(u, "assistant", text.format(u=u),
                            metadata={"generation": {
                                "max_new_tokens": LANE_NEW}})
        got = await_replies(db, users)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if len(got) < len(users):
        fail(f"lanes: profiled turn: {len(got)} of {len(users)} replies")
    spans = [(s, e) for _, s, e in _device_events(prof) if e > s]
    sum_ms = sum(t for _, t, _ in _kernel_times(prof))
    if not spans:
        fail("lanes: the profiled turn shows no device interval")
    return dict(wall_ms=wall_ms, device_busy_union_ms=_union_us(spans) / 1e3,
                device_kernel_sum_ms=sum_ms, kernel_intervals=len(spans))


def lanes_colocated(card, params, tok):
    """(1) the colocated group, supervised, through SwarmDB + LocalBroker
    + ServingService; then (2) chaos on the same group. Returns the group,
    its service and the bf16 reference of (3)."""
    import tempfile

    import torch

    from swarmdb_tpu_torch.backend.service import ServingService
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    torch.cuda.reset_peak_memory_stats()
    db = SwarmDB(broker=LocalBroker(),
                 save_dir=tempfile.mkdtemp(prefix="swarm_lanes_"))
    g, waves, overlaps, warm_s = build_lanes(params, "bfloat16", db.metrics)
    lanes_of = []   # (message id, lane) of every submission
    for j, e in enumerate(g.lanes):
        def recorded(r, _s=e.submit, _j=j):
            lanes_of.append((r.metadata.get("message_id"), _j))
            return _s(r)
        e.submit = recorded
    svc = ServingService(db, g, tok, backend_id="h100-lanes")
    if svc.supervisor is None or svc.supervisor is not g.supervisor:
        fail("lanes: the service did not attach the group's supervisor")
    users = [f"user{i}" for i in range(LANE_USERS)]
    for a in users + ["assistant"]:
        db.register_agent(a)
    db.assign_llm_backend("assistant", "h100-lanes")
    svc.start(warmup=False)   # warmup() ran in build_lanes
    c = db.metrics.counters
    replies = []
    t_serve = time.perf_counter()
    for turn, text in enumerate((USER_TEXT, FOLLOW_UP)):
        for u in users:
            db.send_message(u, "assistant", text.format(u=u),
                            metadata={"generation": {
                                "max_new_tokens": LANE_NEW}})
        got = await_replies(db, users)
        if len(got) < len(users):
            fail(f"lanes (1) turn {turn + 1}: {len(got)} of {len(users)} "
                 "replies")
        replies.extend(got.values())
    serve_s = time.perf_counter() - t_serve
    conv = {}
    for mid, lane in lanes_of:
        if mid is not None:
            conv.setdefault(db.get_message(mid).sender_id, set()).add(lane)
    fixed = lane_prompt(tok, 99)
    same = lane_run(g, [fixed, fixed], hints=[0, 1])
    reasons = [m.metadata.get("finish_reason") for m in replies]
    hits = [e._prefix.stats()["hit_tokens"] for e in g.lanes]
    checks = {
        "16 replies, length/eos": len(replies) == 2 * LANE_USERS
            and all(r in ("length", "eos") for r in reasons),
        "both lanes serve": all(e.total_requests > 0 for e in g.lanes),
        "each conversation on one lane": len(conv) == LANE_USERS
            and all(len(v) == 1 for v in conv.values()),
        "turn 2 reuses turn 1's pages on both lanes": all(h > 0
                                                          for h in hits),
        "lane 0 and lane 1 give equal greedy tokens": same[0]["toks"]
            == same[1]["toks"] and same[0]["reason"] == "length",
        "decode through graph replays on both lanes": all(
            e._runner.chunks > 0 and e._runner.graphs for e in g.lanes),
        "flight steps carry shard 0 and 1": {0, 1} <= {
            st.get("shard") for st in g.flight.steps()},
        "group.sentinel is the runtime's on every lane": g.sentinel
            is db.sentinel and all(e.sentinel is db.sentinel
                                   for e in g.lanes),
    }
    ttft = sorted(db.metrics.latencies["send_to_first_token_s"].values())
    gen_tok = c["tokens_generated"].value
    rec = dict(
        part="colocated", model=LANE_MODEL, lanes=len(g.lanes),
        devices=list(LANE_DEVICES), slots_per_lane=g.lanes[0].max_batch,
        pages_per_lane=[e.paged.num_pages for e in g.lanes],
        warmup_s=warm_s, users=LANE_USERS, turns=2, replies=len(replies),
        finish_reasons=sorted(set(reasons)),
        lane_of_conversation={u: sorted(v)[0] for u, v in conv.items()},
        per_lane=[dict(requests=e.total_requests, ragged_waves=waves[j],
                       decode_chunks=e._runner.chunks,
                       overlap_waves=overlaps[j],
                       prefix_hit_tokens=hits[j])
                  for j, e in enumerate(g.lanes)],
        engine_admission_overlap_steps=c[
            "engine_admission_overlap_steps"].value,
        ttft_p50_s=statistics.median(ttft), ttft_max_s=ttft[-1],
        decode_tokens_per_s_wall=gen_tok / serve_s,
        decode_tokens_per_s_chunks=(
            gen_tok / (c["phase_us_decode"].value / 1e6)
            if c["phase_us_decode"].value else None),
        serve_wall_s=serve_s,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        # each lane's device-time profile: its own stream's busy time over
        # the time since warmup (the two streams overlap on one card, so
        # the card's busy share is the profiled turn's union, not a sum)
        lane_duty=[dict(lane=e._prof.label,
                        busy_s=getattr(e._prof, "busy_ns", 0) / 1e9,
                        duty_cycle=e._prof.duty_cycle()
                        if hasattr(e._prof, "duty_cycle") else None)
                   for e in g.lanes],
        card=card, checks=checks)
    emit("lanes", **rec)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"lanes (1) checks failed: {bad}")
    prof = profile_lanes_turn(db, users, FOLLOW_UP)
    prof["untraced_turn_wall_ms"] = serve_s / 2 * 1e3
    prof["device_idle_share_vs_untraced"] = 1.0 - prof[
        "device_busy_union_ms"] / prof["untraced_turn_wall_ms"]
    emit("lanes", part="profile", card=card, **prof)
    lanes_chaos(card, params, tok, g, svc)
    return g, svc, db


def lanes_chaos(card, params, tok, g, svc):
    """(2) four greedy streams hinted to lane 1, lane 1 killed mid-stream
    (``ServingChaos.run_script``, at the 8th token): the requests migrate
    to lane 0 and end "length" with the undisturbed
    run's tokens (or part at a checked near tie), lane 1 is restarted,
    probed and re-admitted, and custody balances on both lanes."""
    from swarmdb_tpu_torch.backend.chaos import ServingChaos, wait_until

    sup = svc.supervisor
    sup.poll_s = 0.1
    prompts = [lane_prompt(tok, 10 + i) for i in range(4)]
    ref = lane_run(g, prompts, hints=[1] * 4)
    st0 = sup.status()
    c = g.metrics.counters
    migrated0 = c["requests_migrated"].value
    chaos = ServingChaos(g)
    killed = []

    def kill_at_8(i, streamed):
        if len(streamed) == 8 and not killed:
            killed.append(time.perf_counter())
            # the scenario through the scripted entry point: one kill, now
            chaos.run_script([(0.0, "kill_lane", (1,))])

    try:
        got = lane_run(g, prompts, hints=[1] * 4, on_token=kill_at_8)
        t_done = time.perf_counter()
        wait_until(lambda: sup.status()["lanes"][1]["state"] == "alive",
                   120.0, what="lane 1 re-admitted")
        readmit_s = time.perf_counter() - killed[0] if killed else None
    finally:
        chaos.stop()
    st = sup.status()
    moves = [e for e in g.flight.events()
             if e.get("kind") == "request.migrated"]
    # a replay re-prefills on lane 0 what the undisturbed run decoded: the
    # chosen tokens' logprob differences where the runs agree measure the
    # two paths' rounding
    diffs = [path_logprob_diffs(r, o, 0) for r, o in zip(ref, got)]
    wait_until(lambda: all(not any(s.active for s in e.slots)
                           for e in g.lanes), 60.0, what="idle lanes")
    logit_diff = max(first_step_logit_diff(g.lanes[0], p)
                     for p in prompts[:2])
    tol = max([logit_diff] + [d for ds in diffs for d in ds])
    partings = [first_parting(params, p, r["toks"], o["toks"], tol)
                for p, r, o in zip(prompts, ref, got)]
    custody = lane_custody(g)
    checks = {
        "killed mid-stream": bool(killed),
        "4 replies length, 32 tokens, stream == reply": all(
            o["reason"] == "length" and len(o["toks"]) == LANE_NEW
            and o["streamed"] == o["toks"] for o in got),
        "migrated to lane 0": c["requests_migrated"].value > migrated0
            and all(m["to_lane"] == 0 for m in moves[-4:]),
        "tokens equal the undisturbed run's, or part at a near tie": all(
            p is None or p["near_tie"] for p in partings),
        "lane 1 restarted, probed, re-admitted":
            st["lanes"][1]["restarts"] > st0["lanes"][1]["restarts"]
            and st["lane_readmissions"] > st0["lane_readmissions"]
            and st["lanes"][1]["state"] == "alive",
        "custody balances on both lanes": custody == [0, 0],
    }
    emit("lanes", part="chaos", card=card,
         requests_migrated=c["requests_migrated"].value - migrated0,
         migrations=[(m["from_lane"], m["to_lane"], m["emitted"])
                     for m in moves[-4:]],
         equal_to_undisturbed=[o["toks"] == r["toks"]
                               for r, o in zip(ref, got)],
         first_step_max_logit_diff=logit_diff,
         replay_logprob_diff_max=[max(d, default=None) for d in diffs],
         replay_first_token_logprob_diff=[d[0] if d else None
                                          for d in diffs],
         partings=partings,
         lane_states=[lane["state"] for lane in st["lanes"]],
         restarts=[lane["restarts"] for lane in st["lanes"]],
         readmissions=st["lane_readmissions"],
         kill_to_readmitted_s=readmit_s,
         kill_to_last_reply_s=(t_done - killed[0]) if killed else None,
         custody=custody, checks=checks)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"lanes (2) checks failed: {bad}")


def lanes_fleet(card, params, tok, kind, colo):
    """(3) ``SWARMDB_FLEET=prefill:1,decode:1`` over ``kind`` pools: 8
    greedy requests handed off prefill lane -> pinned transit store ->
    decode lane, against ``colo`` (the colocated group of the same pool
    kind) on the same prompts."""
    import gc

    import torch

    from swarmdb_tpu_torch.ops.paged_kv import (pool_gather_pages,
                                                pool_insert_raw)
    from swarmdb_tpu_torch.utils.metrics import MetricsRegistry

    prompts = [lane_prompt(tok, 20 + i) for i in range(8)]
    ref = lane_run(colo, prompts, hints=[i % 2 for i in range(8)])
    pinned_before = host_pinned_bytes()
    metrics = MetricsRegistry()
    f, waves, _, warm_s = build_lanes(params, kind, metrics, fleet=True)
    f.start()
    try:
        got = lane_run(f, prompts)
        wait_until_idle(f)
        waves = list(waves)   # the run's, before the measurements below
        chunks = [e._runner.chunks for e in f.lanes]
        fst = f.fleet.stats()
        pinned_after = host_pinned_bytes()
        custody = lane_custody(f)
        pre, dec = f.lanes
        # the two paths' difference where they agree, from the first
        # stage-2 step on (the decode lane's resume prefill of the first
        # token, against the colocated lane's first decode step)
        diffs = [path_logprob_diffs(r, o, 1) for r, o in zip(ref, got)]
        logit_diff = max(first_step_logit_diff(dec, p) for p in prompts[:2])
        tol = max([logit_diff] + [d for ds in diffs for d in ds])
        partings = [first_parting(params, p, r["toks"], o["toks"], tol)
                    for p, r, o in zip(prompts, ref, got)]
        lat = sorted(metrics.latencies["fleet_handoff_s"].values())
        # the decode lane's promote insert alone: a payload of the first
        # prompt's pages, copied from page-locked memory into reserved
        # pages and synchronized (the lanes are idle)
        n_pages = -(-len(prompts[0]) // dec.paged.page_size)
        src = dec.paged.allocator.reserve(n_pages)
        pinned = lambda shape, dt: torch.empty(
            shape, dtype=dt, pin_memory=dec.device.type == "cuda")
        payload = [pool_gather_pages(dec.cache[n], src, pinned)
                   for n in ("k", "v")]
        ids = torch.tensor(src, device=pre.device)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for n, pay in zip(("k", "v"), payload):
            pool_insert_raw(dec.cache[n], ids, pay)
        ev[1].record()
        ev[1].synchronize()
        dec.paged.allocator.add_free(src)
        insert_ms_page = ev[0].elapsed_time(ev[1]) / n_pages
        checks = {
            "8 handoffs, no fallback": fst["handoffs"] == 8
                and fst["handoff_fallbacks"] == 0,
            "8 replies length, 32 tokens, stream == reply": all(
                o["reason"] == "length" and len(o["toks"]) == LANE_NEW
                and o["streamed"] == o["toks"] for o in got),
            "the prefill lane ran no decode chunk": chunks[0] == 0
                and not pre._runner.graphs,
            "the decode lane ran no ragged wave": waves[1] == 0
                and waves[0] > 0,
            "tokens equal colocated, or part at a near tie": all(
                p is None or p["near_tie"] for p in partings),
            "custody balances, transit store empty": custody == [0, 0]
                and fst["transit_store"]["entries"] == 0
                and fst["in_flight"] == 0,
        }
        from swarmdb_tpu_torch.obs.profiler import profiler

        emit("lanes", part=f"fleet_{kind}", card=card, warmup_s=warm_s,
             handoffs=fst["handoffs"], fallbacks=fst["handoff_fallbacks"],
             # the profiler's per-pool rows: duty cycles and MFU of the
             # prefill and decode pools
             pools=profiler().pools_report(),
             handoff_ms_p50=1e3 * statistics.median(lat) if lat else None,
             handoff_ms_max=1e3 * lat[-1] if lat else None,
             gather_ms_per_page=fst["gather_ms_per_page"],
             insert_ms_per_page=insert_ms_page, insert_pages=n_pages,
             transit_store=fst["transit_store"],
             transit_slab=fst["transit_slab"],
             pinned_bytes_before=pinned_before,
             pinned_bytes_after=pinned_after,
             prefill_lane=dict(ragged_waves=waves[0],
                               decode_chunks=chunks[0]),
             decode_lane=dict(ragged_waves=waves[1],
                              decode_chunks=chunks[1],
                              promote_inserts=metrics.counters[
                                  "engine_tier_promote_inserts"].value),
             ttft_staged=_summary([o["ttft_s"] for o in got]),
             ttft_colocated=_summary([r["ttft_s"] for r in ref]),
             equal_to_colocated=[o["toks"] == r["toks"]
                                 for r, o in zip(ref, got)],
             first_stage2_max_logit_diff=logit_diff,
             first_stage2_logprob_diff=[d[0] if d else None
                                        for d in diffs],
             path_logprob_diff_max=[max(d, default=None) for d in diffs],
             partings=partings,
             custody=custody, checks=checks)
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"lanes (3) fleet {kind} checks failed: {bad}")
    finally:
        f.stop()
        del f
        gc.collect()


def wait_until_idle(g, timeout=60.0):
    from swarmdb_tpu_torch.backend.chaos import wait_until

    wait_until(lambda: all(not any(s.active for s in e.slots)
                           for e in g.lanes), timeout, what="idle lanes")


def run_lanes(card, params):
    """The lanes phase (Llama-3-8B at full width on the serve phase's
    weights): (1) the colocated group through the service, profiled; (2)
    a lane killed mid-stream; (3) the fleet over bf16 and int8 pools.
    Returns the phase's launches."""
    import gc

    import torch

    from swarmdb_tpu_torch.backend.tokenizer import default_tokenizer
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.ops import attention_cuda as ac
    from swarmdb_tpu_torch.utils.metrics import MetricsRegistry

    tok = default_tokenizer(get_config(LANE_MODEL).vocab_size)
    t0 = time.perf_counter()
    ac.reset_launches()
    g, svc, db = lanes_colocated(card, params, tok)
    try:
        lanes_fleet(card, params, tok, "bfloat16", g)
    finally:
        svc.stop()
        db.close()
        del svc, g
        gc.collect()
    colo8, _, _, _ = build_lanes(params, "int8", MetricsRegistry())
    colo8.start()
    try:
        lanes_fleet(card, params, tok, "int8", colo8)
    finally:
        colo8.stop()
        del colo8
        gc.collect()
    launches = dict(ac.LAUNCHES)
    torch.cuda.empty_cache()
    emit("lanes", part="done", seconds=time.perf_counter() - t0,
         launches={k: n for k, n in launches.items() if n}, card=card)
    return launches


# ---------------------------------------------------------------------- ha


#: The ha phase's in-process cluster: three nodes with partition
#: leadership, the JAX package's detector times (build_local_cluster's
#: defaults: suspect 0.3 s, dead 0.6 s, heartbeats every 0.05 s) and its
#: promotion budget (tests/test_partition_leadership.py: dead_s +
#: 6 x suspect_s).
HA_NODES = ("n0", "n1", "n2")
HA_SUSPECT_S, HA_DEAD_S = 0.3, 0.6
HA_PROMOTE_BUDGET_S = HA_DEAD_S + 6 * HA_SUSPECT_S
#: partitions of the messages topic: two a node
HA_PARTITIONS = 6
HA_USERS = 8
#: new tokens of the probe turn after the kill (its hints are checked)
HA_PROBE_NEW = 8
#: the across-process step's detector times (its server process loads
#: PyTorch and the card while its node runs)
HA_PROC_ENV = dict(SWARMDB_HA_SUSPECT_S="1.0", SWARMDB_HA_DEAD_S="2.0",
                   SWARMDB_HA_HEARTBEAT_S="0.1")


def ha_pick(db, users, mids, timeout=300.0):
    """Each user's reply to its message in ``mids`` (message id -> user),
    reading through failovers (a read on a partition mid-failover raises
    the retryable LeaderChangedError)."""
    got = {}
    deadline = time.time() + timeout
    while len(got) < len(mids) and time.time() < deadline:
        for u in users:
            try:
                msgs = db.receive_messages(u, timeout=0.05)
            except Exception as exc:
                if not getattr(exc, "retryable", False):
                    raise
                time.sleep(0.02)
                continue
            for m in msgs:
                if m.metadata.get("reply_to") in mids:
                    got[m.metadata["reply_to"]] = m
    return got


def ha_send(db, user, bot, text, new):
    """One greedy message, re-sent while its partition fails over (the
    failed first copy stays in the conversation's history, which the
    phase's prompt checks would show)."""
    deadline = time.time() + 60
    while True:
        try:
            return db.send_message(user, bot, text, metadata={
                "generation": {"max_new_tokens": new,
                               "temperature": 0.0}})
        except Exception as exc:
            if not getattr(exc, "retryable", False) or time.time() > deadline:
                raise
            time.sleep(0.05)


def ha_record(svc) -> dict:
    """Wrap ``svc``'s submission and reply emission. Per message id: its
    prompt and lane hint, the wall time of its first token, its tokens,
    finish and logprobs, and its reply's produce attempts (``emits``) with
    the seconds from the first attempt to the one that landed
    (``emit_s``)."""
    seen = {}
    submit, emit = svc._submit, svc._emit_reply

    def recorded(req):
        mid = req.metadata.get("message_id")
        rec = seen.setdefault(mid, {})
        rec.update(prompt=list(req.prompt), hint=req.shard_hint)
        done, on_tok = req.on_done, req.on_token

        def tok_seen(rid, t, _rec=rec, _t=on_tok):
            _rec.setdefault("first", time.time())
            if _t is not None:
                _t(rid, t)

        def fin(rid, toks, reason, _r=req, _rec=rec, _d=done):
            _rec.update(toks=list(toks), reason=reason, logprobs=list(
                _r.metadata.get("logprobs") or []))
            return _d(rid, toks, reason)

        req.on_token, req.on_done = tok_seen, fin
        return submit(req)

    def emitted(msg, *a):
        rec = seen.setdefault(msg.id, {})
        t0 = rec.setdefault("emit_t0", time.perf_counter())
        rec["emits"] = rec.get("emits", 0) + 1
        out = emit(msg, *a)
        rec["emit_s"] = time.perf_counter() - t0
        return out

    svc._submit, svc._emit_reply = recorded, emitted
    return seen


def ha_turns(db, users, bots, seen, mid_turn=None):
    """Two greedy turns (``USER_TEXT``, ``FOLLOW_UP``) of every (user,
    bot) pair, ``LANE_NEW`` new tokens; ``mid_turn(turn, tokens0)`` runs
    once a turn's messages are sent, ``tokens0`` the runtime's generated
    tokens when the turn began. Per turn, {message id: user} and the
    replies by message id; and each turn's TTFT from send."""
    turns, replies, ttft = [], {}, {}
    generated = db.metrics.counters["tokens_generated"]
    for turn, text in enumerate((USER_TEXT, FOLLOW_UP)):
        mids, sent, tokens0 = {}, {}, generated.value
        for u, b in zip(users, bots):
            t_send = time.time()
            mid = ha_send(db, u, b, text.format(u=u), LANE_NEW)
            mids[mid], sent[mid] = u, t_send
        if mid_turn is not None:
            mid_turn(turn, tokens0)
        got = ha_pick(db, users, mids)
        if len(got) < len(mids):
            fail(f"ha (a) turn {turn + 1}: {len(got)} of {len(mids)} "
                 "replies")
        turns.append(mids)
        replies.update(got)
        ttft[f"turn{turn + 1}"] = _summary(
            [seen[m]["first"] - sent[m] for m in mids
             if "first" in seen.get(m, {})])
    return turns, replies, ttft


def ha_flush_prefix(g) -> None:
    """Return every idle lane's prefix-cache pages to its pool: the next
    serve on the group starts from no cached page."""
    wait_until_idle(g)
    for e in g.lanes:
        e.paged.allocator.add_free(e._prefix.evict_lru(e.paged.num_pages))
        if e._prefix.stats()["cached_pages"]:
            fail("ha (a): a lane's prefix cache kept pages after the flush")


def ha_compare(params, tok, users, bots, ha, ref) -> dict:
    """The HA serve's replies against the undisturbed serve's, conversation
    by conversation (``ha`` and ``ref``: (seen, turns, replies) of
    ``ha_record`` / ``ha_turns``). Each HA turn-2 prompt must hold turn
    1's exchange as history lines. A reply whose prompt equals the
    reference's is compared: equal tokens, or a parting at a near tie by
    the sanitize phase's rule (``compare_replies``): a plain bf16 forward
    over the prompt and the reference's tokens gives each step's logits,
    and at the parting step both tokens must lie within ``tol`` of the top
    logit. ``tol`` comes only from paths outside the run under test: the
    largest |log-probability difference| of the chosen token between the
    undisturbed serve and the plain forward, over every reference reply.
    A prompt that differs from the reference's is allowed only after that
    conversation parted in turn 1, and is then counted, not compared."""
    import torch

    (hseen, hturns, hrep), (rseen, rturns, rrep) = ha, ref
    bot_of = dict(zip(users, bots))
    by = {}
    for side, turns in (("ha", hturns), ("ref", rturns)):
        for t, mids in enumerate(turns):
            for mid, u in mids.items():
                by.setdefault((t, u), {})[side] = mid
    # turn 1's exchange in every HA turn-2 prompt: the failover kept the
    # conversation's history
    history_ok = {}
    for u in users:
        m1, m2 = by[(0, u)]["ha"], by[(1, u)]["ha"]
        reply = hrep[m1].content
        text = "\n" + tok.decode(hseen[m2]["prompt"]) + "\n"
        history_ok[u] = (reply == tok.decode(hseen[m1]["toks"])
                         and f"\n{u}: {USER_TEXT.format(u=u)}\n" in text
                         and f"\n{bot_of[u]}: {reply}\n" in text)
    plain, diffs = {}, []
    for key, ids in by.items():
        r = rseen[ids["ref"]]
        logits = plain_step_logits(params, r["prompt"], r["toks"])
        plain[key] = logits
        lp = torch.log_softmax(logits, -1)
        off = len(r["toks"]) - len(r["logprobs"])
        for s in range(off, len(r["toks"])):
            diffs.append(abs(float(lp[s, r["toks"][s]])
                             - r["logprobs"][s - off]))
    if not diffs:
        fail("ha (a): the undisturbed serve returned no logprobs")
    tol = max(diffs)
    equal, parted, after_tie, partings = 0, set(), 0, []
    for key in sorted(by):
        h, r = hseen[by[key]["ha"]], rseen[by[key]["ref"]]
        if h["prompt"] != r["prompt"]:
            if key[0] == 1 and key[1] in parted:
                after_tie += 1
                continue
            fail(f"ha (a): turn {key[0] + 1} of {key[1]} saw another "
                 f"prompt than the undisturbed serve's")
        a, b = r["toks"], h["toks"]
        i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            if len(a) != len(b):
                fail(f"ha (a): {key} replies of {len(a)} and {len(b)} "
                     "tokens agree to the shorter one's end")
            equal += 1
            continue
        parted.add(key[1])
        z = plain[key][i]
        top = float(z.max())
        p = dict(turn=key[0] + 1, user=key[1], step=i, ref_token=a[i],
                 ha_token=b[i], gap_ref=top - float(z[a[i]]),
                 gap_ha=top - float(z[b[i]]), tol=tol)
        p["near_tie"] = p["gap_ref"] < tol and p["gap_ha"] < tol
        partings.append(p)
    return dict(equal=equal, near_ties=len(partings),
                after_a_tie=after_tie, tol=tol, partings=partings,
                history_ok=history_ok)


def ha_in_process(card, params):
    """(a) A 3-node partition-leadership cluster on the port's native
    broker feeds the lanes phase's 2-lane group (``build_lanes``) bound
    to partition leadership; the non-controller node leading most of the
    messages topic's partitions is killed mid-stream in turn 2. The same
    turns are then served undisturbed on the same group, its prefix caches
    flushed, through a fresh ``SwarmDB`` on ``LocalBroker`` and a fresh
    ``ServingService``: the reference the replies are held to
    (``ha_compare``). Returns the record."""
    import tempfile

    import torch

    from swarmdb_tpu_torch.backend.service import ServingService
    from swarmdb_tpu_torch.backend.tokenizer import default_tokenizer
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.broker.native import NativeBroker
    from swarmdb_tpu_torch.core.messages import BrokerConfig
    from swarmdb_tpu_torch.core.runtime import SwarmDB, _default_broker
    from swarmdb_tpu_torch.ha import build_local_cluster, tp_key, wait_until
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.obs import TRACER

    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="swarm_ha_")
    # each node's broker is what BROKER_IMPL=auto picks: it must be the
    # native engine, never a quiet fallback to LocalBroker
    harness, cluster, client = build_local_cluster(
        list(HA_NODES), partition_leadership=True,
        suspect_s=HA_SUSPECT_S, dead_s=HA_DEAD_S,
        broker_factory=lambda nid: _default_broker(BrokerConfig(
            implementation="auto", log_dir=os.path.join(tmp, nid))))
    kinds = {nid: type(n.broker).__name__ for nid, n in
             harness.nodes.items()}
    if any(not isinstance(n.broker, NativeBroker)
           for n in harness.nodes.values()):
        harness.stop()
        fail(f"ha (a): the nodes' brokers are {kinds}, not NativeBroker")
    n0 = harness.nodes["n0"]
    db = svc = g = ref_db = ref_svc = None
    try:
        wait_until(lambda: cluster.read()["leader"] == "n0", 30.0,
                   what="bootstrap leader")
        db = SwarmDB(config=BrokerConfig(num_partitions=HA_PARTITIONS),
                     broker=n0.client_broker(), autosave_interval=1e9,
                     save_dir=os.path.join(tmp, "hist"))
        topic = db.topic_name

        def assignments():
            return {int(k.rpartition(":")[2]): a for k, a in
                    cluster.read()["assignments"].items()
                    if k.rpartition(":")[0] == topic}

        def spread_and_leased():
            a = assignments()
            leaders = [x["leader"] for x in a.values()]
            if sorted(leaders) != sorted(
                    HA_NODES * (HA_PARTITIONS // len(HA_NODES))):
                return False
            for p, x in a.items():
                node = harness.nodes[x["leader"]]
                if (node._pbroker is None
                        or node._pbroker.leases.epoch_of(topic, p) is None):
                    return False
            return True

        # the steady state before any send: the topic is assigned to the
        # controller first and spread after, and the map names a leader
        # before it takes the partition's lease (an append in between is
        # refused, and a re-sent message leaves its failed copy in the
        # conversation's history)
        wait_until(spread_and_leased, 30.0,
                   what="the messages topic spread and leased")
        tok = default_tokenizer(get_config(LANE_MODEL).vocab_size)
        g, _, _, warm_s = build_lanes(params, "bfloat16", db.metrics)
        svc = ServingService(db, g, tok, backend_id="h100-ha")
        svc.bind_partition_leadership(n0)
        if svc._locality is None:
            fail("ha (a): bind_partition_leadership left no locality")
        seen = ha_record(svc)
        users = [f"ha_user{i}" for i in range(HA_USERS)]
        bots = [f"ha_assistant{i}" for i in range(HA_USERS)]
        for a in users + bots:
            db.register_agent(a)
        for b in bots:
            db.assign_llm_backend(b, "h100-ha")
        svc.start(warmup=False)
        kill = {}
        tokens = db.metrics.counters["tokens_generated"]

        def kill_in_turn_2(turn, tokens0):
            if turn != 1:
                return
            # mid-stream: once turn 2 has decoded a few tokens
            wait_until(lambda: tokens.value - tokens0 >= 2 * HA_USERS,
                       120.0, poll_s=0.005, what="turn 2 decoding")
            counts = {}
            for a in assignments().values():
                counts[a["leader"]] = counts.get(a["leader"], 0) + 1
            victim = max(("n1", "n2"), key=lambda n: counts.get(n, 0))
            orphans = sorted(p for p, a in assignments().items()
                             if a["leader"] == victim)
            t_kill, wall_kill = time.perf_counter(), time.time()
            harness.kill(victim)
            reseat = {}
            while (len(reseat) < len(orphans)
                   and time.perf_counter() - t_kill < 30.0):
                now_a = assignments()
                for p in orphans:
                    if p not in reseat and now_a[p]["leader"] != victim:
                        reseat[p] = time.perf_counter() - t_kill
                time.sleep(0.002)
            kill.update(victim=victim, orphans=orphans, reseat=reseat,
                        leaders_before=counts, wall=wall_kill)

        turns, replies, ttft = ha_turns(db, users, bots, seen,
                                        kill_in_turn_2)
        # locality converged: every pin names its partition's leader and
        # the lane derived from it
        def pins_agree():
            a = assignments()
            for u, b in zip(users, bots):
                pin = svc._locality.pin(u, b)
                if (pin.leader != a[pin.partition]["leader"]
                        or pin.lane != svc._locality._lane_for(
                            pin.partition, pin.leader)):
                    return False
            return True

        wait_until(pins_agree, 30.0, what="locality converged")
        # a probe turn after the kill: each request's hint is its pin
        probe, sent = {}, {}
        for u, b in zip(users, bots):
            t_send = time.time()
            mid = ha_send(db, u, b, f"One line from {u}, please.",
                          HA_PROBE_NEW)
            probe[mid], sent[mid] = u, t_send
        got_probe = ha_pick(db, users, probe)
        ttft["probe_after_kill"] = _summary(
            [seen[m]["first"] - sent[m] for m in probe
             if "first" in seen.get(m, {})])
        hints_ok = all(
            seen.get(mid, {}).get("hint")
            == svc._locality.pin(u, bots[users.index(u)]).lane
            for mid, u in probe.items())
        # every acknowledged message read back from the survivors
        acked = {m.id for m in list(db.messages.values())
                 if "offset" in m.metadata}
        found = set()
        for p in range(HA_PARTITIONS):
            off = 0
            while True:
                recs = client.fetch(topic, p, off, 1024)
                if not recs:
                    break
                found.update(r.key.decode() for r in recs if r.key)
                off = recs[-1].offset + 1
        lost = sorted(acked - found)
        # the reference: the same turns served undisturbed, no cluster,
        # no kill, from no cached page, through a fresh runtime and
        # service (unsupervised: the group keeps the HA service's
        # supervisor)
        ha_flush_prefix(g)
        ref_db = SwarmDB(config=BrokerConfig(num_partitions=HA_PARTITIONS),
                         broker=LocalBroker(), autosave_interval=1e9,
                         save_dir=os.path.join(tmp, "ref_hist"))
        with env_scope(SWARMDB_SUPERVISE="0"):
            ref_svc = ServingService(ref_db, g, tok, backend_id="h100-ref")
        ref_seen = ha_record(ref_svc)
        for a in users + bots:
            ref_db.register_agent(a)
        for b in bots:
            ref_db.assign_llm_backend(b, "h100-ref")
        ref_svc.start(warmup=False)
        ref_turns, ref_replies, ref_ttft = ha_turns(ref_db, users, bots,
                                                    ref_seen)
        cmp = ha_compare(params, tok, users, bots,
                         (seen, turns, replies),
                         (ref_seen, ref_turns, ref_replies))
        victim, orphans = kill["victim"], kill["orphans"]
        reseat = sorted(kill["reseat"].values())
        repins = [ev for ev in g.flight.events()
                  if ev.get("kind") == "ha.repin"
                  and ev.get("t", 0) >= kill["wall"]]
        from_victim = {ev["partition"] for ev in repins
                       if ev.get("from_leader") == victim}
        conv_parts = {pin.partition for pin in
                      (svc._locality.pin(u, b) for u, b in zip(users, bots))}
        want_repin = {tp_key(topic, p) for p in orphans if p in conv_parts}
        instants = [e for e in TRACER.to_chrome_trace()["traceEvents"]
                    if e.get("name") == "ha.repin"]
        ha_mids = [m for t in turns for m in t]
        reasons = [replies[m].metadata.get("finish_reason")
                   for m in ha_mids]
        emits = sorted((seen[m]["emits"], seen[m]["emit_s"])
                       for m in ha_mids if "emits" in seen[m])
        blast = len(orphans) / HA_PARTITIONS
        checks = {
            "every node on NativeBroker": set(kinds.values())
                == {"NativeBroker"},
            "16 replies, finish length": all(r == "length"
                                             for r in reasons)
                and len(reasons) == 2 * HA_USERS,
            "probe turn answered": len(got_probe) == HA_USERS,
            "acked_loss == 0": not lost and bool(acked),
            "every orphan re-seated within the promotion budget":
                len(reseat) == len(orphans) and bool(orphans)
                and reseat[-1] < HA_PROMOTE_BUDGET_S,
            "blast radius <= 1/3 + one partition":
                blast <= 1 / 3 + 1 / HA_PARTITIONS + 1e-9,
            "pins, hints and leaders agree after the kill":
                pins_agree() and hints_ok,
            "ha.repin names exactly the victim's partitions":
                from_victim == want_repin and len(instants) >= len(
                    from_victim),
            "each turn-2 prompt holds turn 1's exchange":
                all(cmp["history_ok"].values()),
            "tokens equal the undisturbed serve's, or part at a near tie":
                all(p["near_tie"] for p in cmp["partings"]),
        }
        # the native broker's appends beside LocalBroker's: the obs
        # phase's echo loop over each (runtime alone, no cluster)
        echo = {}
        for name, mk in (("native", lambda: NativeBroker(
                log_dir=os.path.join(tmp, "echo"))),
                         ("local", LocalBroker)):
            edb = SwarmDB(broker=mk(), autosave_interval=1e9,
                          save_dir=os.path.join(tmp, f"echo_{name}"))
            try:
                echo[f"{name}_msgs_per_s"] = _echo_loop(edb, 2.0)
            finally:
                edb.close()
        rec = dict(
            part="in_process", card=card, model=LANE_MODEL,
            lanes=len(g.lanes), warmup_s=warm_s, brokers=kinds,
            partitions=HA_PARTITIONS, users=HA_USERS, turns=2,
            victim=victim, leaders_before_kill=kill["leaders_before"],
            orphaned_partitions=orphans,
            time_to_promote_s=dict(p50=statistics.median(reseat)
                                   if reseat else None,
                                   max=reseat[-1] if reseat else None,
                                   budget=HA_PROMOTE_BUDGET_S),
            blast_radius=blast, blast_radius_bound=1 / 3 + 1 / HA_PARTITIONS,
            acked_records=len(acked), acked_loss=len(lost),
            repins=len(repins), repinned_from_victim=sorted(from_victim),
            locality=svc._locality.stats(),
            ttft_s=ttft, ttft_undisturbed_s=ref_ttft,
            equal_to_undisturbed=cmp["equal"],
            near_ties=cmp["near_ties"], after_a_tie=cmp["after_a_tie"],
            tol=cmp["tol"], partings=cmp["partings"],
            finish_reasons=reasons,
            reply_retries=db.metrics.counters["reply_retries"].value,
            reply_retry_budget_s=svc._failover_budget_s,
            # (produce attempts, seconds from the first to the one that
            # landed) of every reply that needed more than one
            retried_replies=[e for e in emits if e[0] > 1],
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
            checks=checks, **echo)
        emit("ha", **rec)
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"ha (a) checks failed: {bad}")
        return rec
    finally:
        for s_, d_ in ((ref_svc, ref_db), (svc, db)):
            if s_ is not None:
                s_.stop()
            if d_ is not None:
                d_.close()
        harness.stop()
        client.close()
        for n in harness.nodes.values():
            try:
                n.broker.close()
            except Exception:
                pass


def ha_cluster_trace(card):
    """(b) Across processes: two ``python -m swarmdb_tpu_torch.ha.node``
    nodes over a ``FileClusterMap`` and the port's server as the third
    node (``SWARMDB_HA_NODE_ID``, ``SERVE_MODEL=tiny-debug`` on the card,
    the default dense engine: kernel 7); one message streamed, the
    controller node SIGKILLed, a second streamed; ``/admin/ha`` shows the
    promotion and ``/admin/cluster/trace`` merges the cluster's rings
    with the dead node listed unreachable. Every child is killed at the
    end."""
    import signal
    import socket
    import tempfile
    import urllib.error
    import urllib.request

    from swarmdb_tpu_torch.ha import FileClusterMap

    tmp = tempfile.mkdtemp(prefix="swarm_ha_proc_")
    cluster_path = os.path.join(tmp, "cluster.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT), **HA_PROC_ENV)
    for k in ("SWARMDB_HA_NODE_ID", "SWARMDB_HA_CLUSTER", "BROKER_IMPL",
              "SWARMDB_PAGED", "SWARMDB_HA_PARTITION_LEADERSHIP"):
        env.pop(k, None)
    procs = {}

    def spawn_node(node_id, role):
        proc = subprocess.Popen(
            [sys.executable, "-m", "swarmdb_tpu_torch.ha.node",
             "--node-id", node_id, "--role", role,
             "--log-dir", os.path.join(tmp, node_id),
             "--cluster", cluster_path, "--listen", "127.0.0.1:0",
             "--liveness", "127.0.0.1:0", "--data", "127.0.0.1:0",
             "--advertise-host", "127.0.0.1"],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        procs[node_id] = proc
        line = proc.stdout.readline()
        if not line.startswith(f"HA_NODE_READY {node_id}"):
            fail(f"ha (b): node {node_id} did not start: {line!r}")

    cmap = FileClusterMap(cluster_path)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    url = f"http://127.0.0.1:{port}"

    def call(path, body=None, headers=None, timeout=120):
        req = urllib.request.Request(
            url + path, data=None if body is None else
            json.dumps(body).encode(), headers={
                "Content-Type": "application/json", **(headers or {})},
            method="GET" if body is None else "POST")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read().decode()

    def wait(pred, timeout, what):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            try:
                if pred():
                    return time.perf_counter() - t0
            except (OSError, ValueError, KeyError):
                pass
            time.sleep(0.05)
        fail(f"ha (b): timed out waiting for {what}")

    try:
        spawn_node("p0", "leader")
        spawn_node("p1", "follower")
        wait(lambda: cmap.read()["leader"] == "p0", 30, "bootstrap")
        senv = dict(env, SERVE_MODEL="tiny-debug", API_HOST="127.0.0.1",
                    API_PORT=str(port), SAVE_DIR=os.path.join(tmp, "srv"),
                    JWT_SECRET_KEY="chip-smoke", SERVE_MAX_SEQ="256",
                    SWARMDB_HA_NODE_ID="p2",
                    SWARMDB_HA_CLUSTER=cluster_path,
                    SWARMDB_HA_ROLE="follower",
                    SWARMDB_HA_LISTEN="127.0.0.1:0",
                    SWARMDB_HA_LIVENESS="127.0.0.1:0",
                    SWARMDB_HA_DATA="127.0.0.1:0",
                    SWARMDB_HA_ADVERTISE_HOST="127.0.0.1",
                    BROKER_LOG_DIR=os.path.join(tmp, "p2"),
                    SWARMDB_NODE_ID="p2")
        t0 = time.perf_counter()
        # the server's log goes to a file: a pipe nobody drains fills up
        # with the failover's retry tracebacks and then blocks the
        # process, its HA node's threads included
        err_path = os.path.join(tmp, "server.err")
        with open(err_path, "wb") as err:
            procs["p2"] = subprocess.Popen(
                [sys.executable, "-m", "swarmdb_tpu_torch.api.server"],
                cwd=str(ROOT), env=senv, stdout=subprocess.DEVNULL,
                stderr=err)
        health = {}

        def healthy():
            if procs["p2"].poll() is not None:
                with open(err_path, "rb") as f:
                    tail = f.read()[-2000:].decode(errors="replace")
                fail(f"ha (b): the server exited: {tail}")
            health.update(json.loads(call("/health", timeout=10)))
            return True

        wait(healthy, 300, "the server's /health")
        up_s = time.perf_counter() - t0
        tokn = json.loads(call("/auth/token", {"username": "admin",
                                               "password": "pw"}))
        hdr = {"Authorization": f"Bearer {tokn['access_token']}"}
        call("/agents/register", {"agent_id": "assistant"}, hdr)
        call("/admin/llm_backend", {"agent_id": "assistant",
                                    "backend_id": "gpu-0"}, hdr)
        wait(lambda: any(k.startswith("swarm_messages:") for k in
                         cmap.read()["assignments"]), 30,
             "the messages topic's assignment")

        def stream(text):
            """One streamed message, re-sent while the cluster fails over:
            (message id, reply event, seconds)."""
            t = time.perf_counter()
            while time.perf_counter() - t < 120:
                try:
                    body = call("/messages", {
                        "receiver_id": "assistant", "content": text,
                        "stream": True, "metadata": {"generation": {
                            "max_new_tokens": 8}}}, hdr)
                except (urllib.error.HTTPError, OSError):
                    time.sleep(0.2)
                    continue
                events = _sse_events(body.splitlines())
                first = next((d for e, d in events if e == "message"), {})
                reply = [d for e, d in events if e == "reply"]
                if reply:
                    return first.get("id"), reply[0], time.perf_counter() - t
                time.sleep(0.2)
            fail(f"ha (b): no reply to {text!r}")

        mid_a, reply_a, _ = stream("hello before the kill")
        st0 = cmap.read()
        t_kill = time.perf_counter()
        procs["p0"].send_signal(signal.SIGKILL)
        procs["p0"].wait(timeout=30)
        # at once, while the map still lists p0 (its peers deregister it
        # once their detectors call it dead): the merge skips the dead
        # node and names it
        early = json.loads(call("/admin/cluster/trace?last_n=50",
                                headers=hdr))
        early_s = time.perf_counter() - t_kill
        unreachable = [u["node"] for u in early["metadata"]["unreachable"]]
        wait(lambda: cmap.read()["leader"] not in ("p0", None)
             and cmap.read()["epoch"] > st0["epoch"], 60, "a new controller")
        promote_s = time.perf_counter() - t_kill
        wait(lambda: all(a["leader"] != "p0"
                         for a in cmap.read()["assignments"].values()),
             60, "every partition of p0 re-seated")
        reseat_s = time.perf_counter() - t_kill
        mid_b, reply_b, b_s = stream("hello after the kill")
        admin_ha = json.loads(call("/admin/ha", headers=hdr))
        trace = json.loads(call(f"/admin/cluster/trace?trace_id={mid_b}",
                                headers=hdr))
        events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
        pids = {e["pid"] for e in events}
        names = {e["name"] for e in events}
        kinds = {ev.get("kind") for ev in admin_ha.get("events", [])}
        table = (admin_ha.get("partition_leadership") or {}).get(
            "partitions", {})
        checks = {
            "both replies arrive": bool(reply_a and reply_b),
            "/admin/ha shows the promotion": admin_ha.get("leader")
                not in ("p0", None)
                and admin_ha.get("cluster_epoch", 0) > st0["epoch"]
                and bool(table)
                and all(r.get("leader") != "p0" for r in table.values()),
            "the merge spans >= 2 pids": len(pids) >= 2,
            "the promotion instant is in the merge": "ha.promoted" in names,
            "metadata.unreachable names p0": "p0" in unreachable,
        }
        rec = dict(part="across_processes", card=card,
                   server_seconds_to_health=up_s,
                   server_device=(health.get("tpu") or {}).get("device"),
                   server_ha=health.get("ha"), kill_to_controller_s=promote_s,
                   kill_to_reseated_s=reseat_s,
                   kill_to_second_reply_s=time.perf_counter() - t_kill,
                   second_stream_s=b_s,
                   replies=[r.get("metadata", {}).get("finish_reason")
                            for r in (reply_a, reply_b)],
                   admin_ha_leader=admin_ha.get("leader"),
                   admin_ha_events=sorted(k for k in kinds if k),
                   merged_pids=len(pids), merged_events=len(events),
                   merged_names=sorted(names), unreachable=unreachable,
                   unreachable_read_s_after_kill=early_s,
                   checks=checks)
        emit("ha", **rec)
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"ha (b) checks failed: {bad}")
        return rec
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass


def run_ha(card, params):
    """The ha phase: (a) Llama-3-8B at full width on two lanes fed by a
    3-node partition-leadership cluster through a node kill; (b) the
    cluster trace across processes. Returns (a)'s launches."""
    import gc

    import torch

    from swarmdb_tpu_torch.ops import attention_cuda as ac

    t0 = time.perf_counter()
    ac.reset_launches()
    ha_in_process(card, params)
    launches = dict(ac.LAUNCHES)
    gc.collect()
    torch.cuda.empty_cache()
    ha_cluster_trace(card)
    emit("ha", part="done", seconds=time.perf_counter() - t0,
         launches={k: n for k, n in launches.items() if n}, card=card)
    return launches


# ---------------------------------------------------------------- sanitize


#: The sanitize phase's five clean serves: (name, paged, cache dtype,
#: rolling with the warm tier, fleet). Each runs with the three sanitizers
#: on and again with them off, 4 users x 2 turns of ~400 tokens, 32 new
#: greedy tokens, each turn's requests sent together.
SANITIZE_SERVES = (("paged_bf16_chunked", True, "bfloat16", False, False),
                   ("paged_int8_chunked", True, "int8", False, False),
                   ("dense_chunked", None, "bfloat16", False, False),
                   ("rolling_paged_bf16", True, "bfloat16", True, False),
                   ("fleet_paged_bf16", True, "bfloat16", False, True))
SANITIZE_FLAGS = ("SWARMDB_LOCKCHECK", "SWARMDB_PAGECHECK",
                  "SWARMDB_KERNCHECK")
#: Rounds of each differential soup (``obs/kerncheck.py``) per build.
SANITIZE_SOUP_ROUNDS = 4


def run_sanitize(card: str):
    """The sanitize phase in a child process (the flags are read at
    import by module-level locks, and the child must not share the
    parent's freed Llama weights): ``python3 chip_smoke.py
    --sanitize-child <result>`` with ``SWARMDB_LOCKCHECK=1
    SWARMDB_PAGECHECK=1 SWARMDB_KERNCHECK=1`` and a temporary
    ``SWARMDB_FLIGHT_DIR``. Returns the child's clean serves' launches and
    each kernel's checked-build and plain-build ms."""
    import tempfile

    work = tempfile.mkdtemp(prefix="swarm_sanitize_")
    result = os.path.join(work, "result.json")
    env = dict(os.environ, SWARMDB_FLIGHT_DIR=os.path.join(work, "dumps"),
               SWARMDB_NODE_ID="sanitize", PYTHONPATH=str(ROOT),
               **{f: "1" for f in SANITIZE_FLAGS})
    for k in ("SWARMDB_PAGED", "SWARMDB_FLEET", "SWARMDB_ROLLING_KV"):
        env.pop(k, None)
    sys.stdout.flush()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--sanitize-child",
         result], cwd=str(ROOT), env=env, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(result):
        fail(f"sanitize: the child exited with {proc.returncode}")
    with open(result, encoding="utf-8") as f:
        out = json.load(f)
    emit("sanitize", step="done", seconds=seconds,
         child_seconds=out["seconds"], card=card,
         launches={k: n for k, n in out["launches"].items() if n})
    return out["launches"], out["checked_ms"]


def sanitize_child(result_path: str) -> int:
    """The sanitize phase's body, in the child: Llama-3-8B at full width
    and depth from seed 0; (a) five clean serves with the sanitizers on
    and off; (b) the differential soups on all eight entry points, plain
    and checked build; then each kernel timed in both builds; (c) four
    seeded defects, each caught with its kind; (d) the three routes over
    HTTP, their ``/metrics`` lines and the analyzer over the dumps."""
    import torch

    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.ops import build

    t0 = time.perf_counter()
    missing = [f for f in SANITIZE_FLAGS if os.environ.get(f) != "1"]
    if missing:
        fail(f"sanitize: the child runs with {missing} unset")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build.build_all(checked=True)   # built with the parent's, up front
    with torch.no_grad():
        params = llama.init_params(get_config("llama3-8b"), seed=0,
                                   device=dev)
        torch.cuda.synchronize()
        emit("sanitize", step="weights", seconds=time.perf_counter() - t0)
        launches = sanitize_clean_serves(params)
        sanitize_soups(dev)
        checked_ms = sanitize_timing(dev)
        sanitize_seeded(params, dev)
        sanitize_endpoints()
    out = dict(launches=launches, checked_ms=checked_ms,
               seconds=time.perf_counter() - t0)
    with open(result_path, "w", encoding="utf-8") as f:
        json.dump(out, f)
    return 0


def _registries():
    from swarmdb_tpu_torch.obs import kerncheck, lockcheck, pagecheck

    return lockcheck.registry(), pagecheck.registry(), kerncheck.registry()


def _violation_counts() -> dict:
    lk, pc, kc = _registries()
    return {"lock_cycles": len(lk.cycles()),
            "page_violations": len(pc.violations()),
            "kernel_violations": len(kc.violations())}


def sanitize_serve(params, name, paged, kind, rolling, fleet, on: bool):
    """One clean serve with the sanitizers on (``on``) or off: the engine
    (or the two-lane fleet on ``cuda:0``) built and served under the flags
    (the kernels' checked build is picked per launch, the checked classes
    and dispatchers when the engine is built). Returns every request's
    (prompt, tokens, logprobs, reason), the launches, TTFT and decode
    tokens/s, and the tier and fleet counters; ``conv`` maps each user
    message's id to its (turn, user)."""
    import gc
    import tempfile

    import torch

    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.backend.tokenizer import default_tokenizer
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.ops import attention_cuda as ac
    from swarmdb_tpu_torch.parallel import build_serving_engine

    flags = {f: "1" if on else None for f in SANITIZE_FLAGS}
    env = dict(flags, SWARMDB_CHUNKED="1", SWARMDB_PAGED=None,
               SWARMDB_ROLLING_KV="1" if rolling else "0",
               SWARMDB_FLEET="prefill:1,decode:1" if fleet else None,
               SWARMDB_FLEET_TRANSIT_MB=LANE_TRANSIT_MB if fleet else None,
               SWARMDB_FLEET_TIERS=None, SWARMDB_PREFIX_TOKENS=None,
               SWARMDB_EMIT_RING=None)
    users = [f"user{i}" for i in range(4)]
    with env_scope(**env):
        torch.cuda.empty_cache()
        db = SwarmDB(broker=LocalBroker(),
                     save_dir=tempfile.mkdtemp(prefix="swarm_sanitize_"))
        cfg = get_llama_cfg()
        kv = getattr(torch, kind)
        if fleet:
            eng, info = build_serving_engine(
                "llama3-8b", ["cuda:0", "cuda:0"], max_batch=LANE_BATCH,
                max_seq=1024, paged=True, page_size=16, decode_chunk=8,
                params=params, kv_dtype=kv, metrics=db.metrics)
            if eng.fleet is None:
                fail(f"sanitize {name}: the group built no fleet")
            eng.warmup()
            tok = default_tokenizer(cfg.vocab_size)
        else:
            eng, tok = build_backend_engine(
                "llama3-8b", seed=0, device="cuda", params=params,
                paged=paged, kv_dtype=kv if paged else None,
                metrics=db.metrics)
        svc = ServingService(db, eng, tok, backend_id="h100-0")
        records, conv = [], {}
        submit = svc._submit

        def recording_submit(req):
            done = req.on_done

            def fin(rid, toks, reason, _r=req, _d=done):
                records.append(dict(
                    prompt=list(_r.prompt), toks=list(toks), reason=reason,
                    lps=list(_r.metadata.get("logprobs") or []),
                    mid=_r.metadata.get("message_id"),
                    resume_len=_r.resume_len))
                if _d is not None:
                    _d(rid, toks, reason)

            req.on_done = fin
            return submit(req)

        svc._submit = recording_submit
        try:
            for a in users + ["assistant"]:
                db.register_agent(a)
            db.assign_llm_backend("assistant", "h100-0")
            svc.start(warmup=not fleet)
            if rolling:
                svc._tier.min_idle_s = 0.0
            c = db.metrics.counters
            base = {k: c[k].value for k in ("tokens_generated",
                                            "phase_us_decode")}
            ac.reset_launches()
            for turn, text in enumerate((USER_TEXT, FOLLOW_UP)):
                if rolling and turn == 1:
                    # every parked conversation to the warm tier: turn 2
                    # promotes it back
                    for u in users:
                        wait_parked(svc, (u, "assistant"))
                    with svc._rolling_lock:
                        svc._tier.demote_now(10 ** 6)
                for u in users:
                    conv[db.send_message(
                        u, "assistant", text.format(u=u),
                        metadata={"generation": {"max_new_tokens": 32,
                                                 "temperature": 0.0}})] = (
                        turn, u)
                got = await_replies(db, users)
                if len(got) < len(users):
                    fail(f"sanitize {name} ({'on' if on else 'off'}) turn "
                         f"{turn + 1}: {len(got)} of {len(users)} replies")
            launches = dict(ac.LAUNCHES)
            ttft = sorted(db.metrics.latencies[
                "send_to_first_token_s"].values())
            dec_s = (c["phase_us_decode"].value
                     - base["phase_us_decode"]) / 1e6
            gen = c["tokens_generated"].value - base["tokens_generated"]
            out = dict(records=records, conv=conv, launches=launches,
                       ttft_p50_s=statistics.median(ttft),
                       decode_tokens_per_s=gen / dec_s if dec_s else None,
                       demotions=c["tier_demotions"].value,
                       promotions=c["tier_promotions"].value,
                       handoffs=(eng.fleet.stats()["handoffs"] if fleet
                                 else None),
                       kerncheck_engine=bool(getattr(
                           eng.lanes[0] if fleet else eng, "_kerncheck",
                           False)))
            # the page sanitizer's hooks: the paged engines' checked
            # allocator, the dense engine's checked side-pool prefix cache
            out["pagecheck_engine"] = [
                e._pagecheck is not None
                or type(e._prefix).__name__ == "CheckedPrefixLRU"
                for e in (eng.lanes if fleet else [eng])]
            return out
        finally:
            svc.stop()
            db.close()
            del svc, eng
            gc.collect()
            torch.cuda.empty_cache()


def get_llama_cfg():
    from swarmdb_tpu_torch.models.configs import get_config

    return get_config("llama3-8b")


def serve_contexts(name, out) -> dict:
    """Each reply of a ``sanitize_serve`` by its (turn, user): the full
    token context the model saw before its first new token, and its
    record. A rolling turn's prompt is only the delta after the kept pages
    (``resume_len`` tokens of the previous turn's context and reply), so
    its context is rebuilt from that turn's."""
    by = {}
    for r in out["records"]:
        key = out["conv"].get(r["mid"])
        if key is None:
            fail(f"sanitize {name}: a reply to no message of the serve")
        by[key] = r
    ctx = {}
    for key in sorted(by):
        r = by[key]
        if r["resume_len"]:
            prev = ctx.get((key[0] - 1, key[1]))
            if prev is None:
                fail(f"sanitize {name}: a resumed turn {key} with no turn "
                     f"before it")
            seen = prev[0] + prev[1]["toks"]
            tail = seen[r["resume_len"]:]
            if r["prompt"][:len(tail)] != tail:
                fail(f"sanitize {name}: turn {key}'s delta does not start "
                     f"with the tokens past its kept pages")
            ctx[key] = (seen[:r["resume_len"]] + r["prompt"], r)
        else:
            ctx[key] = (list(r["prompt"]), r)
    return ctx


def plain_step_logits(params, ctx, toks, cfg=None):
    """The plain bf16 forward (``llama.forward``, one sequence, a dense
    cache) over ``ctx`` and ``toks``: the f32 logits that pick each of
    ``toks``, one row per step (``cfg``: Llama-3-8B unless given)."""
    import torch

    from swarmdb_tpu_torch.models import llama

    cfg = cfg or get_llama_cfg()
    seq = list(ctx) + list(toks)
    T0, T, dev = len(ctx), len(seq), params["embed"].device
    logits, _ = llama.forward(
        params, cfg, torch.tensor([seq], dtype=torch.int32, device=dev),
        torch.arange(T, dtype=torch.int32, device=dev)[None],
        llama.init_kv_cache(cfg, 1, T, device=dev),
        logits_at=torch.arange(T0 - 1, T - 1, device=dev))
    return logits.float()


def compare_replies(name, params, ref, got) -> dict:
    """Every sanitizers-on reply against the sanitizers-off one of the same
    conversation turn: equal tokens, or a parting at a near tie checked as
    the lanes phase checks one. A plain bf16 forward over the turn's
    context and the sanitizers-off tokens gives each step's logits; the
    tolerance is the largest difference this run measured between any two
    of the three paths (off, on, plain) in the chosen tokens' log-
    probabilities where they agree; at the parting step both runs' tokens
    must lie within it of the plain forward's top logit. A conversation
    that parted leaves its next turn without a partner: counted, never
    compared."""
    import torch

    def lp_at(rec, s):
        off = len(rec["toks"]) - len(rec["lps"])
        return rec["lps"][s - off] if s >= off else None

    rctx, gctx = serve_contexts(name, ref), serve_contexts(name, got)
    if sorted(rctx) != sorted(gctx):
        fail(f"sanitize {name}: the two serves answered different turns")
    equal = orphans = 0
    parted_users, diffs, tops = set(), [], []
    for key in sorted(gctx):
        (c, o), (_, r) = rctx[key], gctx[key]
        if r["reason"] not in ("length", "eos"):
            fail(f"sanitize {name}: a reply ended {r['reason']}")
        if key[1] in parted_users:
            orphans += 1
            continue
        if gctx[key][0] != c:
            fail(f"sanitize {name}: turn {key} saw another context with "
                 f"the sanitizers on, its conversation never parted")
        a, b = o["toks"], r["toks"]
        i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None and len(a) != len(b):
            fail(f"sanitize {name}: replies of {len(a)} and {len(b)} "
                 f"tokens agree to the shorter one's end")
        logits = plain_step_logits(params, c, a)
        lp = torch.log_softmax(logits, -1)
        for s in range(len(a) if i is None else i):
            vals = [float(lp[s, a[s]]), lp_at(o, s), lp_at(r, s)]
            vals = [v for v in vals if v is not None]
            diffs += [abs(x - y) for k, x in enumerate(vals)
                      for y in vals[k + 1:]]
        if i is None:
            equal += 1
            continue
        parted_users.add(key[1])
        z = logits[i]
        top = float(z.max())
        tops.append(dict(step=i, turn=key[0], lp_off=lp_at(o, i),
                         lp_on=lp_at(r, i),
                         gap_off=top - float(z[a[i]]),
                         gap_on=top - float(z[b[i]])))
    tol = max(diffs, default=0.0)
    for p in tops:
        p["tol"] = tol
        p["near_tie"] = p["gap_off"] < tol and p["gap_on"] < tol
        if not p["near_tie"]:
            fail(f"sanitize {name}: sanitizers-on tokens part from the "
                 f"sanitizers-off ones at step {p['step']}, not at a near "
                 f"tie: {p}")
    return dict(equal=equal, near_ties=len(tops), after_a_tie=orphans,
                tol=tol, partings=tops)


def sanitize_clean_serves(params) -> dict:
    """(a) The five clean serves, each off then on; zero lock cycles, page
    violations and kernel violations after them all. Returns the
    sanitizers-on serves' launches (counted from zero before each, read
    after it)."""
    total = {}
    for spec in SANITIZE_SERVES:
        name, paged, kind, rolling, fleet = spec
        t0 = time.perf_counter()
        ref = sanitize_serve(params, *spec, on=False)
        got = sanitize_serve(params, *spec, on=True)
        cmp = compare_replies(name, params, ref, got)
        checks = {
            "flags on: checked allocator and kernel sanitizer in the engine":
                all(got["pagecheck_engine"]) and got["kerncheck_engine"],
            "flags off: plain engine": not any(ref["pagecheck_engine"])
                and not ref["kerncheck_engine"],
            "8 replies": len(got["records"]) >= 8,
        }
        if rolling:
            checks["demoted and promoted"] = (got["demotions"] > 0
                                             and got["promotions"] > 0)
        if fleet:
            checks["handoffs"] = got["handoffs"] >= 4
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"sanitize {name}: {bad}")
        for k, n in got["launches"].items():
            total[k] = total.get(k, 0) + n
        emit("sanitize", step="a_clean_serve", serve=name, **cmp,
             seconds=time.perf_counter() - t0,
             ttft_p50_s_on=got["ttft_p50_s"], ttft_p50_s_off=ref["ttft_p50_s"],
             decode_tokens_per_s_on=got["decode_tokens_per_s"],
             decode_tokens_per_s_off=ref["decode_tokens_per_s"],
             demotions=got["demotions"], promotions=got["promotions"],
             handoffs=got["handoffs"],
             launches={k: n for k, n in got["launches"].items() if n},
             **_violation_counts())
    counts = _violation_counts()
    if any(counts.values()):
        lk, pc, kc = _registries()
        fail(f"sanitize (a): the clean serves left {counts}: "
             f"{lk.cycles()[:2]} {pc.violations()[:2]} "
             f"{kc.violations()[:2]}")
    _, pc, kc = _registries()
    emit("sanitize", step="a_clean", **counts,
         kernel_checks=kc.report()["checks"],
         page_pools=len(pc.report()["pools"]))
    return total


def sanitize_soups(dev) -> None:
    """(b) The differential soups through all eight entry points (the
    ragged prefill plain and int8, the six decode kernels), in f32 and
    bf16, on the plain and on the checked build: zero mismatching rounds,
    zero violations (the checked build's record included). The launches
    are a comparison's, kept out of ``LAUNCHES``."""
    import torch

    from swarmdb_tpu_torch.obs import kerncheck as kc
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    t0 = time.perf_counter()
    out = {}
    with ac.launches_into({}):
        for checked in (False, True):
            with ac.use_checked_build(checked):
                for dt in (torch.float32, torch.bfloat16):
                    for quant in (False, True):
                        tol = (kc.parity_tol("int8") if quant else
                               1e-4 if dt == torch.float32 else
                               kc.parity_tol("bf16"))
                        key = (f"{'checked' if checked else 'plain'}_"
                               f"{str(dt)[6:]}_{'int8' if quant else 'pages'}")
                        out[key] = dict(
                            ragged_prefill=kc.differential_ragged_prefill(
                                seed=11, rounds=SANITIZE_SOUP_ROUNDS,
                                tol=tol, quantized=quant, device=dev,
                                dtype=dt),
                            decode=kc.differential_paged_decode(
                                seed=12, rounds=SANITIZE_SOUP_ROUNDS,
                                tol=tol, quantized=quant, device=dev,
                                dtype=dt))
    torch.cuda.synchronize()
    ac.kerncheck_poll(dev)
    bad = {k: v for k, v in out.items() if any(v.values())}
    counts = _violation_counts()
    emit("sanitize", step="b_soups", rounds=SANITIZE_SOUP_ROUNDS,
         mismatching_rounds=out, seconds=time.perf_counter() - t0,
         checks=kc.registry().report()["checks"], **counts)
    if bad or counts["kernel_violations"]:
        fail(f"sanitize (b): soups mismatched {bad}; "
             f"{kc.registry().violations()[:3]}")


def sanitize_timing(dev) -> dict:
    """Each kernel at the kernels phase's bf16 serving shape, its checked
    build's ms per call beside its plain build's (CUDA graphs of 10
    calls, median of 30 replays; plain, checked, checked, plain). Returns
    the checked ms per kernel."""
    import torch

    from swarmdb_tpu_torch.ops import attention_cuda as ac

    bf, i8 = torch.bfloat16, torch.int8
    rows, out = {}, {}
    with ac.launches_into({}):
        for name, sp in kernel_specs().items():
            c = sp["case"](bf, i8 if sp["quant"] else bf, dev)
            t = {}
            for checked in (False, True, True, False):
                with ac.use_checked_build(checked):
                    t.setdefault(checked, []).append(
                        time_graph(lambda: sp["kernel"](**c)))
            plain_ms = min(t[False])
            checked_ms = min(t[True])
            out[name] = checked_ms
            rows[name] = dict(plain_ms=plain_ms, checked_ms=checked_ms,
                              checked_over_plain=checked_ms / plain_ms)
    ac.kerncheck_poll(dev)
    emit("sanitize", step="b_timing", kernels=rows,
         **_violation_counts())
    if _violation_counts()["kernel_violations"]:
        fail("sanitize (b): the timed checked launches recorded a "
             "violation")
    return out


def sanitize_seeded(params, dev) -> None:
    """(c) Four seeded defects, each caught with its kind (registries
    reset first: the clean part is over)."""
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    for reg in _registries():
        reg.reset()
    ac.kerncheck_poll(dev)
    found = dict(canary=seed_canary(params, dev), oob_block=seed_oob(dev),
                 write_race=seed_race(dev), lock_cycle=seed_lock_cycle())
    _, pc, kc = _registries()
    emit("sanitize", step="c_seeded", caught=found,
         page_kinds=sorted({v["kind"] for v in pc.violations()}),
         kernel_kinds=sorted({v["kind"] for v in kc.violations()}))


def seed_canary(params, dev) -> dict:
    """A write into a freed, poisoned page through ``paged_write_decode``
    on a Llama-3-8B paged engine (prefix cache off, so freed pages
    linger poisoned): the page sanitizer's canary check at the page's
    next admission names it."""
    import threading

    import torch

    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams
    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.ops.paged_kv import paged_write_decode, pool_layer

    _, pc, _ = _registries()
    with env_scope(SWARMDB_CHUNKED="1", SWARMDB_PAGED=None,
                   SWARMDB_PREFIX="0", SWARMDB_ROLLING_KV="0"):
        eng, _tok = build_backend_engine(
            "llama3-8b", seed=0, device="cuda", params=params, paged=True,
            max_batch=4, max_seq=256, kv_pool_tokens=4 * 256,
            kv_dtype=torch.bfloat16)
    eng.start()
    try:
        def wave(tags):
            done = [threading.Event() for _ in tags]
            for t, d in zip(tags, done):
                eng.submit(GenRequest(
                    prompt=[1000 + t] * 40,
                    sampling=SamplingParams(max_new_tokens=8),
                    on_done=lambda rid, toks, reason, _d=d: _d.set()))
            for d in done:
                if not d.wait(120):
                    fail("sanitize (c1): a request never finished")

        wave([1, 2])
        wave([3])     # reclaims the first wave's pages, reuses half
        shadow = pc._pools[eng.paged.allocator.pagecheck.pool_id]
        poisoned = [p for p in range(1, eng.paged.num_pages)
                    if shadow.pages[p].poisoned]
        if not poisoned:
            fail("sanitize (c1): no freed page carries the canary")
        rogue = poisoned[0]
        cfg = get_llama_cfg()
        table = torch.zeros((1, eng.paged.allocator.maxp),
                            dtype=torch.int32, device=dev)
        table[0, 0] = rogue
        kv = torch.ones((1, 1, cfg.n_kv_heads, cfg.head_dim),
                        dtype=torch.bfloat16, device=dev)
        with torch.cuda.stream(eng.stream):
            paged_write_decode(pool_layer(eng.cache["k"], 1),
                               pool_layer(eng.cache["v"], 1), kv, kv,
                               torch.tensor([[5]], device=dev), table)
        torch.cuda.synchronize()
        hit = []
        for i in range(6):
            wave([10 + 2 * i, 11 + 2 * i])
            hit = [v for v in pc.violations() if v["kind"] == "canary"]
            if hit:
                break
        if not hit or rogue not in hit[0]["pages"]:
            fail(f"sanitize (c1): the rogue write to page {rogue} was not "
                 f"caught: {pc.violations()}")
        return dict(page=rogue, message=hit[0]["message"])
    finally:
        eng.stop()
        del eng


def seed_oob(dev) -> dict:
    """A ragged launch (the kernels phase's bf16 512-token wave) whose
    table holds page id P + 5: the checked build records an oob-block
    naming the block and the id; the plain build records nothing and
    returns its clamped result, held against the plain version on the
    clamped table."""
    import torch

    from swarmdb_tpu_torch.ops import attention_cuda as ac

    sp = kernel_specs()["ragged_prefill"]
    c = prefill_case(torch.bfloat16, torch.bfloat16, dev)
    P = c["k_pages"].shape[0]
    c["row_tables"][0, 0] = P + 5     # row 0 reads its first prefix page
    with ac.launches_into({}):
        with ac.use_checked_build(False):
            plain = sp["kernel"](**c)
        torch.cuda.synchronize()
        quiet = ac.kerncheck_poll(dev)
        with ac.use_checked_build(True):
            checked = sp["kernel"](**c)
        torch.cuda.synchronize()
        hits = ac.kerncheck_poll(dev)
    clamped = dict(c, row_tables=c["row_tables"].clamp(0, P - 1))
    want = sp["plain"](**clamped)
    err = float((plain.float() - want.float()).abs().max())
    builds = float((plain.float() - checked.float()).abs().max())
    oob = [h for h in hits if h["kind"] == "oob-block"]
    if (quiet or not oob or oob[0]["raw"] != P + 5
            or oob[0]["bound"] != P or not builds < 2e-2
            or not err < 2e-2):
        fail(f"sanitize (c2): plain-build record {quiet}, checked-build "
             f"record {hits}, plain vs checked build {builds}, clamped "
             f"result vs plain version {err}")
    return dict(kernel=oob[0]["kernel"],
                block=[oob[0]["bx"], oob[0]["by"], oob[0]["bz"]],
                page_id=oob[0]["raw"], bound=oob[0]["bound"],
                hits=oob[0]["hits"], clamped_vs_plain_version=err,
                plain_vs_checked_build=builds)


def seed_race(dev) -> dict:
    """Two ragged rows overlapping in the stream, through the checked
    dispatcher onto the checked build: a write-race from the host audit
    (naming both rows) and from the device writer map (naming both
    blocks)."""
    import torch

    from swarmdb_tpu_torch.obs import kerncheck
    from swarmdb_tpu_torch.ops import attention_cuda as ac
    from swarmdb_tpu_torch.ops import layers

    _, _, kc = _registries()
    c = prefill_case(torch.bfloat16, torch.bfloat16, dev)
    c["starts"][2] = c["starts"][0]    # rows 0 and 2 share positions
    checked_dispatch = kerncheck.checked_ragged_prefill_dispatch(
        layers.ragged_prefill_dispatch)
    with ac.launches_into({}):
        checked_dispatch(c["q"], c["sfx_k"], c["sfx_v"], c["k_pages"],
                         c["v_pages"], c["row_tables"], c["starts"],
                         c["lens"], c["prefix_lens"])
        torch.cuda.synchronize()
        ac.kerncheck_poll(dev)
    races = [v for v in kc.violations() if v["kind"] == "write-race"]
    host = [v for v in races if "rows" in v["where"]]
    device = [v for v in races if "blocks" in v["where"]]
    if not host or not device:
        fail(f"sanitize (c3): write-race from the host audit {host}, from "
             f"the device writer map {device}")
    return dict(host_rows=host[0]["where"]["rows"],
                device_blocks=device[0]["where"]["blocks"],
                device_kernel=device[0]["kernel"])


def seed_lock_cycle() -> dict:
    """Two ``make_lock`` locks taken in both orders on two threads: one
    lockcheck cycle naming both sites."""
    import threading

    from swarmdb_tpu_torch.utils import sync

    lk, _, _ = _registries()
    a = sync.make_lock("chip_smoke.sanitize.lock_a")
    b = sync.make_lock("chip_smoke.sanitize.lock_b")

    def order(x, y):
        with x:
            with y:
                pass

    for x, y in ((a, b), (b, a)):
        t = threading.Thread(target=order, args=(x, y))
        t.start()
        t.join(10)
    cycles = lk.cycles()
    if (len(cycles) != 1 or set(cycles[0]["sites"])
            != {"chip_smoke.sanitize.lock_a", "chip_smoke.sanitize.lock_b"}):
        fail(f"sanitize (c4): lock cycles {cycles}")
    return dict(sites=cycles[0]["sites"])


def sanitize_endpoints() -> None:
    """(d) ``/admin/lockcheck``, ``/admin/pagecheck`` and
    ``/admin/kerncheck`` over HTTP (create_app on 127.0.0.1:0), their
    ``/metrics`` lines, then ``python -m swarmdb_tpu_torch.obs.analyze``
    over a trace exported into the dump directory: it must list all
    three kinds of dump."""
    import tempfile

    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.obs import TRACER

    async def drive(db):
        import aiohttp
        from aiohttp import web

        from swarmdb_tpu_torch.api.app import ApiConfig, create_app

        runner = web.AppRunner(create_app(db, ApiConfig(
            jwt_secret_key="chip-smoke", rate_limit_per_minute=100_000)))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        url = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
        try:
            async with aiohttp.ClientSession() as s:
                async with s.post(url + "/auth/token", json={
                        "username": "admin", "password": "pw"}) as r:
                    hdr = {"Authorization":
                           f"Bearer {(await r.json())['access_token']}"}
                out = {}
                for path in ("/admin/lockcheck", "/admin/pagecheck",
                             "/admin/kerncheck"):
                    async with s.get(url + path, headers=hdr) as r:
                        out[path] = (r.status, await r.json())
                async with s.get(url + "/metrics") as r:
                    out["metrics"] = await r.text()
                return out
        finally:
            await runner.cleanup()

    dumps = os.environ["SWARMDB_FLIGHT_DIR"]
    db = SwarmDB(save_dir=tempfile.mkdtemp(prefix="swarm_sanitize_db_"))
    try:
        out = asyncio.run(drive(db))
    finally:
        db.close()
    drop_app_cache()
    lines = {k: [ln for ln in out["metrics"].splitlines()
                 if ln.startswith(k)]
             for k in ("swarmdb_lock_inversion_cycles",
                       "swarmdb_page_violations_total",
                       "swarmdb_kernel_violations_total")}
    routes = {}
    for p in ("/admin/lockcheck", "/admin/pagecheck", "/admin/kerncheck"):
        st, body = out[p]
        routes[p] = dict(status=st, keys=sorted(body)[:8],
                         violations=len(body.get("violations",
                                                 body.get("cycles", []))))
    for reg in _registries():
        reg.dump_to(dumps)
    trace = os.path.join(dumps, "trace.json")
    with open(trace, "w", encoding="utf-8") as f:
        json.dump(TRACER.to_chrome_trace(), f)
    proc = subprocess.run(
        [sys.executable, "-m", "swarmdb_tpu_torch.obs.analyze", trace],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    try:
        report = json.loads(proc.stdout)
    except ValueError:
        report = {}
    listed = {k: [dict(node=d.get("node"),
                       count=d.get("cycles", d.get("violations")),
                       kinds=d.get("violation_kinds", d.get("cycle_sites")))
                  for d in report.get(k, [])]
              for k in ("lockcheck_dumps", "pagecheck_dumps",
                        "kerncheck_dumps")}
    emit("sanitize", step="d_endpoints", routes=routes, metrics=lines,
         analyzer_rc=proc.returncode, analyzer=listed)
    bad = ([p for p, r in routes.items() if r["status"] != 200
            or not r["violations"]]
           + [k for k, v in lines.items() if not v]
           + [k for k, v in listed.items() if not v])
    if proc.returncode != 0 or bad:
        fail(f"sanitize (d): {bad}; analyzer rc {proc.returncode}: "
             f"{proc.stderr[-1500:]}")


# ----------------------------------------------------------------- mixtral


#: Mixtral-8x7B at full width, 8 of its 32 layers: all 32 (~87 GiB of
#: bf16 layers by their shapes) do not fit one 80 GB card (ROADMAP.md
#: queue 1 item 11), and 8 (16 before) keep the script inside its time
#: limit on a slow host.
MIXTRAL_LAYERS = 8

#: (name, cache dtype, chunked, turns, paged, profiled): the six Mixtral
#: serves, in order. ``paged=None`` builds the default (dense) engine.
MIXTRAL_SERVES = (
    ("dense_chunked", "bfloat16", True, 3, None, True),
    ("dense_single_step", "bfloat16", False, 1, None, False),
    ("paged_bf16_chunked", "bfloat16", True, 3, True, True),
    ("paged_int8_chunked", "int8", True, 3, True, False),
    ("paged_bf16_single_step", "bfloat16", False, 1, True, False),
    ("paged_int8_single_step", "int8", False, 1, True, False),
    # SWARMDB_ROLLING_KV=1: each turn prefills only its delta on top of
    # the conversation's kept pages (printed beside the serve above)
    ("paged_bf16_chunked_rolling", "bfloat16", True, 3, True, False))


def send_tool_call(db, user, turn, i, **gen):
    """One ``function_call`` message of the tool-use workload (the payload
    shape of ``bench.py``'s tool-use mode) to the assistant."""
    from swarmdb_tpu_torch.core.messages import MessageType

    k = turn * 4 + i
    db.send_message(
        user, "assistant",
        {"name": "lookup_weather",
         "arguments": {"city": f"city_{k % 7}", "unit": "C"}},
        message_type=MessageType.FUNCTION_CALL,
        metadata={"generation": {"max_new_tokens": 32, **gen}})


def free_weights(params) -> None:
    """Release a weight tree's device memory now: every tensor's storage
    shrinks to nothing, whoever still holds the tensors (the stopped
    engines of earlier phases may), then the allocator's cache is
    emptied. Emits the device memory still allocated."""
    import gc

    import torch

    before = torch.cuda.memory_allocated()
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            node.untyped_storage().resize_(0)
    gc.collect()
    torch.cuda.empty_cache()
    emit("mixtral", step="free_llama_weights",
         allocated_gib_before=before / 2**30,
         allocated_gib_after=torch.cuda.memory_allocated() / 2**30)


def run_mixtral(card: str):
    """The mixtral phase: Mixtral-8x7B (``MIXTRAL_LAYERS`` layers, bf16
    weights from seed 0, built once) served six times through SwarmDB +
    ServingService on ``function_call`` messages, then the ep phase's
    reference and the rows step (``run_moe_rows``). Returns the launches
    summed over the serves."""
    import gc

    import torch

    from swarmdb_tpu_torch.models import mixtral
    from swarmdb_tpu_torch.models.configs import get_config

    dev = torch.device("cuda", 0)
    full = get_config("mixtral-8x7b")
    cfg = get_config("mixtral-8x7b", n_layers=MIXTRAL_LAYERS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = mixtral.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    layer_bytes = sum(_nbytes(t) for t in params["layers"].values())
    weights_gib = (layer_bytes + _nbytes(params["embed"])
                   + _nbytes(params["lm_head"])
                   + _nbytes(params["final_norm"])) / 2**30
    emit("mixtral", step="weights", model=full.name, layers=cfg.n_layers,
         reduced=f"depth {cfg.n_layers} of {full.n_layers} layers",
         full_depth_layer_gib=layer_bytes / cfg.n_layers * full.n_layers
         / 2**30,
         dim=cfg.dim, heads=[cfg.n_heads, cfg.n_kv_heads],
         experts=[cfg.n_experts, cfg.experts_per_token],
         ffn=cfg.ffn_dim, vocab=cfg.vocab_size, rope_theta=cfg.rope_theta,
         weights_gib=weights_gib, weight_init_s=init_s, card=card)
    expert_gemms = moe_layer_breakdown(params, cfg, card)
    total = {}
    try:
        for spec in MIXTRAL_SERVES:
            launches = run_moe_serve(card, cfg, params, weights_gib,
                                     expert_gemms, *spec)
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
        emit("mixtral", step="rolling_vs_plain",
             prefill_tokens_per_turn={
                 k: MOE_PREFILL_PER_TURN[k] for k in (
                     "paged_bf16_chunked", "paged_bf16_chunked_rolling")})
        run_decode_loop(card, cfg, params, LOOP_MIXTRAL)
        EP_REF.update(ep_reference(cfg, params))
        for k, n in run_moe_rows(card, cfg, params, EP_REF["tol"]).items():
            total[k] = total.get(k, 0) + n
    finally:
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return total


#: serve name -> tokens prefilled per turn (all users), by run_moe_serve
MOE_PREFILL_PER_TURN: dict = {}


def run_moe_serve(card, cfg, params, weights_gib, expert_gemms, name, kind,
                  chunked, turns, paged, profiled):
    """One Mixtral serve of ``MIXTRAL_SERVES`` (a name ending in
    "_rolling" turns on ``SWARMDB_ROLLING_KV``). Records the tokens each
    turn prefilled (prompt tokens less the reused ones) in
    ``MOE_PREFILL_PER_TURN``."""
    import gc
    import tempfile

    import torch

    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.messages import MessageType
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.ops import attention_cuda as ac
    from swarmdb_tpu_torch.ops.paged_kv import (is_quantized, pool_data,
                                                pool_page_bytes)

    quant = kind == "int8"
    decode_k = path_kernels(kind, chunked, bool(paged), ragged=False)[-1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    db = SwarmDB(broker=LocalBroker(),
                 save_dir=tempfile.mkdtemp(prefix="swarm_moe_"))
    backend = "h100-0"
    rolling = name.endswith("_rolling")
    with engine_env(chunked, SWARMDB_ROLLING_KV="1" if rolling else "0"):
        eng, tok = build_backend_engine(
            cfg, seed=0, device="cuda", params=params, paged=paged,
            kv_dtype=getattr(torch, kind) if paged else None,
            metrics=db.metrics)
        svc = ServingService(db, eng, tok, backend_id=backend)
    if rolling != (svc._rolling is not None):
        fail(f"mixtral {name}: rolling KV {'off' if rolling else 'on'}")
    users = [f"user{i}" for i in range(4)]
    try:
        for a in users + ["assistant"]:
            db.register_agent(a)
        db.assign_llm_backend("assistant", backend)
        t_start = time.perf_counter()
        svc.start(warmup=True)   # SWARMDB_PREWARM's path: graphs first
        start_s = time.perf_counter() - t_start
        c = db.metrics.counters
        keys = ("prefill_waves", "engine_decode_chunks", "tokens_generated",
                "phase_us_decode", "prompt_tokens", "engine_admitted")
        base = {k: c[k].value for k in keys}
        ac.reset_launches()
        replies = []
        per_turn = []
        t_serve = time.perf_counter()
        for turn in range(turns):
            seen = (c["prompt_tokens"].value
                    - eng.metrics.counters["prefix_reused_tokens"].value)
            for i, u in enumerate(users):
                gen = ({"temperature": 0.8, "top_p": 0.9, "seed": 7}
                       if turn == 0 and i == 3 and not rolling else {})
                send_tool_call(db, u, turn, i, **gen)
            got = await_replies(db, users)
            if len(got) < len(users):
                fail(f"mixtral {name} turn {turn + 1}: {len(got)} of "
                     f"{len(users)} replies")
            replies.extend(got.values())
            per_turn.append(c["prompt_tokens"].value
                            - eng.metrics.counters[
                                "prefix_reused_tokens"].value - seen)
        MOE_PREFILL_PER_TURN[name] = per_turn
        serve_s = time.perf_counter() - t_serve
        launches = dict(ac.LAUNCHES)
        loop = eng.stats()["decode_chunks"]
        d = {k: c[k].value - base[k] for k in keys}
        steps = d["engine_decode_chunks"] * eng.decode_chunk
        L = cfg.n_layers
        reasons = [m.metadata.get("finish_reason") for m in replies]
        reused = eng.metrics.counters["prefix_reused_tokens"].value
        checks = {
            f"{len(users) * turns} function_result replies, length/eos":
                len(replies) == len(users) * turns
                and all(r in ("length", "eos") for r in reasons)
                and all(m.type == MessageType.FUNCTION_RESULT
                        for m in replies),
            "prefix reuse by the last turn": turns < 3 or reused > 0,
            f"{decode_k} launches == {L} per decode step":
                steps > 0 and launches[decode_k] == L * steps,
            "no ragged prefill (row-bucketed waves)": not any(
                launches[k] for k in ("ragged_prefill",
                                      "ragged_prefill_quant")),
            "only the decode kernel": all(
                n == 0 for k, n in launches.items() if k != decode_k),
            "decode through CUDA graph replays": loop["chunks"] > 0
                and bool(loop["graphs"]),
            "params on cuda": eng.params["layers"]["w_gate"].is_cuda,
        }
        if paged:
            checks.update({
                "paged without a ragged forward":
                    eng.paged.prefill_ragged is None and not eng._ragged,
                "pool kind": is_quantized(eng.cache["k"]) == quant,
                "pool on cuda": pool_data(eng.cache["k"]).is_cuda})
        else:
            checks["the default builds the dense engine, bf16 on cuda"] = (
                eng.paged is None and d["prefill_waves"] > 0 and all(
                    t.is_cuda and t.dtype == torch.bfloat16
                    for t in (*eng.cache, *eng._prefix_pool)))
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"mixtral {name} checks failed: {bad}; reasons={reasons} "
                 f"reused={reused} waves={d['prefill_waves']} "
                 f"steps={steps} launches={launches}")
        ttft = sorted(db.metrics.latencies["send_to_first_token_s"].values())
        dec_s = d["phase_us_decode"] / 1e6
        if paged:
            kv_tok = pool_page_bytes(eng.cache["k"]) * 2 // eng.paged.page_size
            cache_gib = (2 * pool_page_bytes(eng.cache["k"])
                         * eng.paged.num_pages / 2**30)
        else:
            ck = eng.cache[0]
            kv_tok = 2 * ck[:, 0, 0].numel() * ck.element_size()
            cache_gib = sum(map(_nbytes, (*eng.cache, *eng._prefix_pool))
                            ) / 2**30
        # a decode step reads every layer's weights (each expert computes
        # its queue) and the head, plus each live slot's KV
        mean_ctx = d["prompt_tokens"] / max(1, d["engine_admitted"]) + 16
        step_bytes = (sum(_nbytes(t) for t in eng.params["layers"].values())
                      + _nbytes(eng.params["lm_head"])
                      + len(users) * mean_ctx * kv_tok)
        record = dict(
            serve=name, model=cfg.name, layers=L, weights="bfloat16",
            engine="paged" if paged else "dense (default)", cache=kind,
            chunked=chunked, turns=turns, replies=len(replies),
            reply_type="function_result", finish_reasons=reasons,
            prefix_reused_tokens=reused, prefill_waves=d["prefill_waves"],
            prefill_tokens_per_turn=per_turn,
            rolling_resumes=c["rolling_resumes"].value,
            decode_steps=steps, launches={k: n for k, n in launches.items()
                                          if n},
            ttft_p50_s=statistics.median(ttft), ttft_max_s=ttft[-1],
            decode_tokens_per_s=(d["tokens_generated"] / dec_s
                                 if dec_s else None),
            generated_tokens=d["tokens_generated"], serve_wall_s=serve_s,
            weights_gib=weights_gib, kv_bytes_per_token=kv_tok,
            cache_gib=cache_gib, mean_prompt_tokens=mean_ctx - 16,
            decode_step_wall_ms=dec_s * 1e3 / steps if steps else None,
            decode_step_bytes=step_bytes,
            decode_step_byte_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
            card=card, max_step_s=eng.max_step_s, **loop_record(eng),
            start_with_warmup_s=start_s, eager_loop_step_ms=MIXTRAL_STEP_EAGER_MS,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        if profiled:
            prof = profile_moe_turn(
                db, users, lambda u, i: send_tool_call(db, u, turns, i),
                decode_k, expert_gemms)
            prof["untraced_turn_wall_ms"] = serve_s / turns * 1e3
            prof["device_idle_share_vs_untraced"] = 1.0 - prof[
                "device_busy_ms"] / prof["untraced_turn_wall_ms"]
            emit("profile", serve=f"mixtral_{name}", **prof)
            if not prof["decode_kernel_ms"] > 0:
                fail(f"mixtral {name}: no device time under the decode "
                     f"kernel {decode_k} in the profiled turn")
        record["decode_step_ms"] = time_moe_step(eng, len(users))
        emit("mixtral", step="serve", **record)
        return launches
    finally:
        svc.stop()
        db.close()
        del svc, eng
        gc.collect()
        torch.cuda.empty_cache()


def time_moe_step(eng, live: int, ctx: int = 300) -> float:
    """Median ms (CUDA events, 5 eager calls after 2) of one decode step of
    the serve's own forward over its cache, the engine idle: ``live``
    slots at position ``ctx``, the rest at 0, as the engine feeds idle
    slots. Run after the serve (it writes garbage K/V)."""
    import torch

    B = eng.max_batch
    pos = torch.zeros((B, 1), dtype=torch.int32, device=eng.device)
    pos[:live] = ctx
    tok = torch.zeros((B, 1), dtype=torch.int32, device=eng.device)
    if eng._chunked_fns is not None:
        fwd = eng._chunked_fns[0]
        step = lambda: fwd(eng.params, tok, pos, eng.cache, eng._chunk_kv, 0)
    else:
        step = lambda: eng._decode_forward(eng.params, tok, pos, eng.cache)
    with torch.no_grad():
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        return _median_events(step, 5)


#: the mixtral phase's rows step: (setting, prefill_batch (None: the
#: serve's usual, 8), SWARMDB_PREFILL_ROWS, the row buckets it must give)
ROWS_SETTINGS = (("rows_off_pb2", 2, "0", [2]),
                 ("ladder_pb8", None, "1", [1, 2, 4, 8]))


def tool_prompts(tok) -> list:
    """The tool-use workload's first turn as the service renders it: the
    four users' ``function_call`` messages (``send_tool_call``) to the
    assistant, each through ``build_prompt`` on a fresh SwarmDB, in user
    order."""
    import tempfile

    from swarmdb_tpu_torch.backend.service import build_prompt
    from swarmdb_tpu_torch.broker.local import LocalBroker
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    db = SwarmDB(broker=LocalBroker(),
                 save_dir=tempfile.mkdtemp(prefix="swarm_rows_"))
    try:
        users = [f"user{i}" for i in range(4)]
        for a in users + ["assistant"]:
            db.register_agent(a)
        for i, u in enumerate(users):
            send_tool_call(db, u, 0, i)
        msgs = {}
        deadline = time.time() + 60
        while len(msgs) < len(users) and time.time() < deadline:
            for m in db.receive_messages("assistant", timeout=0.1):
                msgs[m.sender_id] = m
        if len(msgs) < len(users):
            fail(f"rows: {len(msgs)} of {len(users)} tool calls arrived")
        return [build_prompt(db, msgs[u], tok) for u in users]
    finally:
        db.close()


def record_waves(eng) -> list:
    """Wrap a paged engine's row-bucketed waves: per wave, in the order
    they ran, its real rows' request ids and slots, and its padded ids
    [rows, bucket] and lengths [rows] (1 on a padding row), as
    ``moe_plain_steps(waves=)`` replays them."""
    waves = []
    batch_fn, forward = eng._prefill_batch, eng._prefill_forward

    def prefill_batch(batch):
        waves.append(dict(rids=[it[1].request_id for it in batch],
                          slots=[it[0] for it in batch]))
        return batch_fn(batch)

    def prefill_forward(padded, lengths, rows=None):
        waves[-1].update(padded=padded.copy(), lengths=lengths.copy())
        return forward(padded, lengths, rows)

    eng._prefill_batch, eng._prefill_forward = prefill_batch, prefill_forward
    return waves


def run_moe_rows(card, cfg, params, tol) -> dict:
    """The rows step: ``SWARMDB_PREFILL_ROWS`` on the paged bf16 chunked
    engine (max_batch 8, max_seq 1024, chunk 8; its prefix cache off, so
    every prompt prefills in a row-bucketed wave) over the phase's
    weights. For each of ``ROWS_SETTINGS``: the tool-use workload's first
    turn (``tool_prompts``) queued before the engine starts (one
    admission round), TP_NEW greedy tokens each, the chunks eager so that
    ``routing`` sees every MoE call. Checks the row buckets, every wave's
    rows a bucket, kernel 2 launched and no prefill kernel, every reply
    length / eos, and holds the serve as the ep phase holds its pods:
    every step's logprob and greedy pick within 2 x ``tol`` (the ep
    reference's) of the plain forward that replays the serve's waves and
    steps following its expert choices (``moe_plain_steps(waves=)``,
    ``forced_hold``). Prints the ``rows`` line; returns the launches of
    both serves."""
    import gc

    import torch

    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.backend.tokenizer import default_tokenizer
    from swarmdb_tpu_torch.ops import attention_cuda as ac

    t_step = time.perf_counter()
    decode_k = path_kernels("bfloat16", True, True, ragged=False)[-1]
    prompts = tool_prompts(default_tokenizer(cfg.vocab_size))
    bound = TP_WS2_TOL_FACTOR * tol
    total, out, checks = {}, {}, {}
    for name, pb, env, buckets in ROWS_SETTINGS:
        with engine_env(True, SWARMDB_PREFILL_ROWS=env, SWARMDB_PREFIX="0"):
            eng, _ = build_backend_engine(
                cfg, seed=0, device="cuda", params=params, paged=True,
                kv_dtype=torch.bfloat16, prefill_batch=pb)
        eng._runner.use_graphs = False
        waves = record_waves(eng)
        c = eng.metrics.counters
        ac.reset_launches()
        with routing() as served:
            got = tp_serve(eng, prompts, queued=True)
        torch.cuda.synchronize()
        launches = {k: n for k, n in ac.LAUNCHES.items() if n}
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        index = {rid: i for i, rid in enumerate(got["rids"])}
        for w in waves:
            w["requests"] = [index[r] for r in w["rids"]]
        with routing(forced=served):
            plain = moe_plain_steps(params, cfg, prompts, got["tokens"],
                                    eng.pad_id, None, waves=waves,
                                    rows=eng.max_batch)
        hold = forced_hold(forced_errors(plain, got), bound)
        rows = [int(w["padded"].shape[0]) for w in waves]
        dec_s = c["phase_us_decode"].value / 1e6
        out[name] = dict(
            prefill_batch=eng.prefill_batch, env=env,
            row_buckets=list(eng._row_buckets), wave_rows=rows,
            wave_real_rows=[len(w["slots"]) for w in waves],
            wave_buckets=[int(w["padded"].shape[1]) for w in waves],
            prompt_tokens=[len(p) for p in prompts],
            ttft_s=got["ttft_s"], ttft_p50_s=statistics.median(
                got["ttft_s"]),
            decode_tokens_per_s=(c["tokens_generated"].value / dec_s
                                 if dec_s else None),
            tokens_per_s=got["tokens_per_s"], reasons=got["reasons"],
            launches=launches, graphs=False, hold=hold,
            tokens=got["tokens"])
        checks.update({
            f"rows {name}: buckets {buckets}": eng._row_buckets == buckets,
            f"rows {name}: every wave's rows a bucket": bool(rows) and all(
                r in buckets for r in rows),
            f"rows {name}: {decode_k} launched, no prefill kernel": (
                launches.get(decode_k, 0) > 0
                and set(launches) == {decode_k}),
            f"rows {name}: replies length/eos": all(
                r in ("length", "eos") for r in got["reasons"]),
            f"rows {name}: every step within {TP_WS2_TOL_FACTOR:g} x tol "
            "of the plain forward following its routing": hold["held"]})
        del eng, served, plain
        gc.collect()
        torch.cuda.empty_cache()
    checks["rows: the ladder pads the round to fewer rows than "
           "prefill_batch"] = max(out["ladder_pb8"]["wave_rows"]) < 8
    # whether the padding rows moved a token (a MoE block's capacity
    # counts them): a measurement, not a check
    tokens = [out[name].pop("tokens") for name, *_ in ROWS_SETTINGS]
    emit("mixtral", step="rows", card=card, model=cfg.name,
         layers=cfg.n_layers, engine="paged bf16 chunked, prefix cache off",
         new_tokens=TP_NEW, tol=tol, bound=bound, settings=out,
         same_tokens_across_settings=[a == b for a, b in zip(*tokens)],
         checks=checks, seconds=time.perf_counter() - t_step)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"mixtral rows checks failed: {bad}")
    return total


def profile_moe_turn(db, users, send, decode_k, expert_gemms):
    """One more turn under ``torch.profiler`` (device only; the engine's
    host ops run on its own thread, which the profiler does not follow):
    device time by kernel and summed by kind -- the GEMMs (attention
    projections, the head and the expert products), among them the
    kernels named ``expert_gemms`` (the GEMM kernels the expert products
    launched in ``moe_layer_breakdown``; by name, so a projection that
    picks one of them counts too), the indexing kernels (the MoE scatter
    and gather, cache and page writes), the router's top-k and scan, the
    decode attention kernel -- and the device's idle share of the turn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i, u in enumerate(users):
            send(u, i)
        got = await_replies(db, users)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if len(got) < len(users):
        fail(f"mixtral profiled turn: {len(got)} of {len(users)} replies")
    kernels = _kernel_times(prof)
    busy_ms = sum(k[1] for k in kernels)

    def of(pats):
        return sum(t for n, t, _ in kernels if any(p in n for p in pats))

    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "gemm_ms": of(GEMM_NAMES),
        "expert_gemm_ms": sum(t for n, t, _ in kernels if n in expert_gemms),
        "indexing_ms": of(INDEX_NAMES), "routing_ms": of(ROUTE_NAMES),
        "decode_kernel": decode_k,
        "decode_kernel_ms": of(DECODE_BODIES[decode_k.replace("_quant",
                                                              "")]),
        "top": [{"kernel": n[:90], "ms": t, "calls": c}
                for n, t, c in kernels[:12]],
    }


#: Kernel-name fragments of the GEMMs (cuBLAS's nvjet / xmma, CUTLASS),
#: of the indexing kernels (index_put / index_add / gather: the MoE
#: dispatch and combine, and cache and page writes) and of the router's
#: top-k and queue-position scan.
GEMM_NAMES = ("gemm", "Gemm", "xmma", "cutlass", "nvjet")
INDEX_NAMES = ("index", "Index", "scatter", "gather")
ROUTE_NAMES = ("scan", "TopK", "topk", "Sort", "sort")


def _device_events(prof) -> list:
    """[(name, start us, end us)] of a finished profile's device events
    (kernels, copies, sets), read from its raw results: ``key_averages()``
    and ``events()`` first build every event into a Python tree, seconds
    for one profiled turn."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def _kernel_times(prof):
    """[(kernel name, device ms, calls)] of a profile, longest first."""
    ms, calls = {}, {}
    for name, s, e in _device_events(prof):
        ms[name] = ms.get(name, 0.0) + (e - s) / 1e3
        calls[name] = calls.get(name, 0) + 1
    out = [(n, t, calls[n]) for n, t in ms.items() if t > 0]
    return sorted(out, key=lambda k: -k[1])


def _union_us(spans) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    union, cur = 0.0, None
    for s, e in sorted(spans):
        if cur is None or s > cur[1]:
            if cur is not None:
                union += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        union += cur[1] - cur[0]
    return union


def moe_layer_breakdown(params, cfg, card):
    """Layer 0's MoE block on the card at the serves' two shapes -- a
    decode step of 8 slots and an 8-row prefill wave of 256 -- timed whole
    and its expert products alone (CUDA events, eager, median of 20), each
    beside its bound, with the kernels each launches named (one profiled
    call): the expert GEMMs, and the routing, scatter and gather ops.
    Returns the names of the GEMM kernels the expert products launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from swarmdb_tpu_torch.models import mixtral

    lp = params["layers"]
    w = [lp[k][0] for k in ("router", "w_gate", "w_up", "w_down")]
    E, D, Fd, k = cfg.n_experts, cfg.dim, cfg.ffn_dim, cfg.experts_per_token
    g = torch.Generator(device="cuda").manual_seed(5)
    out, gemms = {}, set()
    for shape, (B, T) in (("decode_8", (8, 1)), ("prefill_8x256", (8, 256))):
        x = torch.randn((B, T, D), generator=g, device="cuda").bfloat16()
        C = max(1, int(B * T * k * mixtral.DEFAULT_CAPACITY_FACTOR / E))
        xe = torch.randn((E, C, D), generator=g, device="cuda").bfloat16()
        block = lambda: mixtral.moe_block(x, *w, top_k=k)
        experts = lambda: mixtral._experts(xe, *w[1:])
        names = {}
        for part, fn in (("block", block), ("experts", experts)):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            times = _kernel_times(prof)
            names[part] = [{"kernel": n[:90], "ms": t, "calls": c}
                           for n, t, c in times]
            if part == "experts":
                gemms.update(n for n, _, _ in times
                             if any(p in n for p in GEMM_NAMES))
        exp_bytes = 3 * E * D * Fd * 2 + 2 * E * C * D * 2
        exp_flops = 3 * 2 * E * C * D * Fd
        block_ms = time_events(block, iters=20)
        experts_ms = time_events(experts, iters=20)
        b_ms, b_by = bound(exp_bytes, exp_flops)
        out[shape] = dict(
            tokens=B * T, capacity=C, block_ms=block_ms,
            experts_ms=experts_ms,
            route_dispatch_combine_ms=block_ms - experts_ms,
            experts_bound_ms=b_ms, experts_bound_by=b_by,
            block_kernels=names["block"], expert_kernels=names["experts"])
    emit("mixtral", step="moe_layer", card=card, **out)
    return gemms


# -------------------------------------------------------------------- main


# ------------------------------------------------------------- smem / lint

#: the prefill waves the smem step asks about: one that fits a block per
#: SM twice over (two groups a block) and one that does not (one group)
SMEM_WAVES = (64, 4096)
SMEM_DIMS = {"Hq": 32, "Hkv": 8, "D": 128}
#: the kernel (template) each decode entry point runs
_SMEM_BODIES = {
    "paged_decode": "paged_decode_cluster_kernel",
    "paged_decode_quant": "paged_decode_cluster_kernel",
    "paged_decode_chunked": "paged_decode_chunked_cluster_kernel",
    "paged_decode_chunked_quant": "paged_decode_chunked_cluster_kernel",
    "dense_decode": "dense_decode_cluster_kernel",
    "dense_decode_chunked": "dense_decode_chunked_cluster_kernel",
}
_PTX_TYPE = {"f32": "float", "bf16": "bf16", "int8": "int8"}


def _ptxas_row(kernel: str, dims: dict, info: dict):
    """The parsed build log's row of the instance a query answered for."""
    from swarmdb_tpu_torch.analysis.kernelcheck import KERNEL_BODIES
    from swarmdb_tpu_torch.ops import build

    page = _PTX_TYPE["int8" if KERNEL_BODIES[kernel][2] else dims["page"]]
    if kernel.startswith("ragged_prefill"):
        body = ("ragged_prefill_mma_kernel" if info["groups"]
                else "ragged_prefill_kernel")
        tail = f", {info['groups']}>" if info["groups"] else ">"
    else:
        body, tail = _SMEM_BODIES[kernel], ">"
    return next((r for r in build.ptxas_instances(kernel, page, dims["D"])
                 if r["instance"].startswith(body + "<")
                 and r["instance"].endswith(tail)), None)


def run_smem(dev) -> dict:
    """The smem step: for each of the eight entry points at the shapes this
    script launches (``SMEM_DIMS``, every dtype the engines launch it
    with, the prefill at ``SMEM_WAVES``), ``estimate_smem`` (the Python
    mirror) must equal the library's own shared memory per block (its
    ``swarm_<kernel>_smem`` query: the dynamic bytes the launch passes
    plus the instance's static bytes), fit the instance's dynamic limit
    after the launch's own opt-in (exactly that limit for the tensor-core
    prefill, which opts in to its size) and the device's opt-in limit.
    Prints registers, spills and static shared memory from the parsed
    build log beside ``cudaFuncGetAttributes``. Returns per kernel its
    serving instance's numbers (bf16 operands, int8 pages for a quant
    kernel, the first wave) for the kernels line."""
    from swarmdb_tpu_torch.analysis.kernelcheck import (estimate_smem,
                                                        launch_dtypes,
                                                        smem_budget)
    from swarmdb_tpu_torch.ops import attention_cuda as ac
    from swarmdb_tpu_torch.ops import build

    limit = smem_budget(device=dev)
    rows, summary, bad = [], {}, []
    for kernel in build.KERNELS:
        waves = SMEM_WAVES if kernel.startswith("ragged") else (None,)
        for dt in launch_dtypes(kernel):
            for W in waves:
                dims = dict(SMEM_DIMS, **dt)
                if W is not None:
                    dims["W"] = W
                info = ac.smem_info(kernel, dims, device=dev)
                est = estimate_smem(kernel, dict(dims, sms=info["sms"]))
                lib = info["dynamic"] + info["static"]
                ptx = _ptxas_row(kernel, dims, info)
                row = dict(kernel=kernel, **dt, W=W, estimate=est,
                           library=lib, dynamic=info["dynamic"],
                           static=info["static"],
                           max_dynamic=info["max_dynamic"],
                           optin=info["optin"], groups=info["groups"],
                           regs=info["regs"], local=info["local"],
                           ptxas=ptx and {k: ptx[k] for k in (
                               "instance", "regs", "spill_stores",
                               "spill_loads", "stack", "smem_static")})
                rows.append(row)
                if est != lib:
                    bad.append(f"{kernel} {dt} W={W}: estimate {est} != "
                               f"library {lib}")
                if lib > info["optin"] or lib > limit:
                    bad.append(f"{kernel} {dt} W={W}: {lib} bytes over the "
                               f"opt-in limit {info['optin']}")
                if info["dynamic"] > info["max_dynamic"] or (
                        info["groups"]
                        and info["dynamic"] != info["max_dynamic"]):
                    bad.append(f"{kernel} {dt} W={W}: dynamic "
                               f"{info['dynamic']} against the instance's "
                               f"limit {info['max_dynamic']}")
                serving = (dt["q"] == "bf16" and dt.get("chunk", "bf16")
                           == "bf16" and dt["page"] in ("bf16", "int8")
                           and W in (None, SMEM_WAVES[0]))
                if serving:
                    summary[kernel] = dict(
                        smem_bytes=lib, smem_limit=info["optin"],
                        regs=info["regs"], local_bytes=info["local"],
                        spill_stores=ptx and ptx["spill_stores"],
                        spill_loads=ptx and ptx["spill_loads"],
                        instance=ptx and ptx["instance"])
    emit("smem", step="kernels", limit=limit, dims=SMEM_DIMS,
         waves=SMEM_WAVES, queries=len(rows), rows=rows)
    if bad:
        fail("smem: " + "; ".join(bad[:8]))
    missing = [k for k in build.KERNELS if k not in summary]
    if missing:
        fail(f"smem: no serving instance answered for {missing}")
    return summary


def start_lint():
    """The lint step, started beside the build: ``python -m
    swarmdb_tpu_torch.analysis`` (the port against its own baseline) must
    exit 0 under this machine's Python. Returns the function that waits
    for it and checks it."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "swarmdb_tpu_torch.analysis"], cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish() -> None:
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail("lint: python -m swarmdb_tpu_torch.analysis ran over 300 s")
        tail = (stdout.strip().splitlines() or [""])[-1]
        emit("lint", rc=proc.returncode, result=tail,
             python=sys.version.split()[0], seconds=time.perf_counter() - t0)
        if proc.returncode != 0:
            fail(f"lint: python -m swarmdb_tpu_torch.analysis exited "
                 f"{proc.returncode}: {stdout[-2000:]}{stderr[-2000:]}")

    return finish


# ------------------------------------------------------------------ ckpt

CKPT_LLAMA_LAYERS = 4
CKPT_MIXTRAL_LAYERS = 1
CKPT_PROMPT = 400
CKPT_NEW = 32


def hf_layout(params, cfg) -> list:
    """(HF key, tensor in HF layout) for every weight of a drawn tree:
    Linear weights as ``[out, in]``, experts under
    ``block_sparse_moe.experts.{e}.w{1,2,3}``."""
    L = params["layers"]
    out = [("model.embed_tokens.weight", params["embed"]),
           ("model.norm.weight", params["final_norm"])]
    if "lm_head" in params:
        out.append(("lm_head.weight", params["lm_head"].t()))
    names = {"attn_norm": ("input_layernorm.weight", False),
             "wq": ("self_attn.q_proj.weight", True),
             "wk": ("self_attn.k_proj.weight", True),
             "wv": ("self_attn.v_proj.weight", True),
             "wo": ("self_attn.o_proj.weight", True),
             "mlp_norm": ("post_attention_layernorm.weight", False)}
    if cfg.is_moe:
        names["router"] = ("block_sparse_moe.gate.weight", True)
    else:
        names.update({"w_gate": ("mlp.gate_proj.weight", True),
                      "w_up": ("mlp.up_proj.weight", True),
                      "w_down": ("mlp.down_proj.weight", True)})
    for i in range(cfg.n_layers):
        for name, (key, tr) in names.items():
            w = L[name][i]
            out.append((f"model.layers.{i}.{key}", w.t() if tr else w))
        if cfg.is_moe:
            for e in range(cfg.n_experts):
                for name, w in (("w_gate", "w1"), ("w_up", "w3"),
                                ("w_down", "w2")):
                    out.append((f"model.layers.{i}.block_sparse_moe."
                                f"experts.{e}.{w}.weight",
                                L[name][i, e].t()))
    return out


def write_hf_checkpoint(params, cfg, path: str, shards: int = 2) -> int:
    """Write a drawn tree as an HF checkpoint in bf16: ``shards``
    safetensors files (an 8-byte header length, a JSON header of dtype,
    shape and data offsets, then the bytes, 8-byte aligned) and
    ``model.safetensors.index.json``. Returns the bytes written. A test
    writer: it knows bf16 tensors only."""
    import torch

    tensors = hf_layout(params, cfg)
    total = sum(t.numel() * 2 for _, t in tensors)
    os.makedirs(path, exist_ok=True)
    groups, acc, cur = [], 0, []
    for key, t in tensors:
        cur.append((key, t))
        acc += t.numel() * 2
        if acc >= total * (len(groups) + 1) / shards and len(
                groups) < shards - 1:
            groups.append(cur)
            cur = []
    groups.append(cur)
    weight_map, written = {}, 0
    for n, group in enumerate(groups):
        fname = f"model-{n + 1:05d}-of-{len(groups):05d}.safetensors"
        header, off = {}, 0
        for key, t in group:
            if t.dtype != torch.bfloat16:
                raise ValueError(f"{key}: the test writer writes bf16")
            header[key] = {"dtype": "BF16", "shape": list(t.shape),
                           "data_offsets": [off, off + t.numel() * 2]}
            off += t.numel() * 2
            weight_map[key] = fname
        blob = json.dumps(header).encode()
        blob += b" " * (-len(blob) % 8)
        with open(os.path.join(path, fname), "wb") as f:
            f.write(len(blob).to_bytes(8, "little"))
            f.write(blob)
            for _key, t in group:
                host = t.contiguous().cpu().view(torch.int16).numpy()
                f.write(memoryview(host).cast("B"))
        written += 8 + len(blob) + off
    with open(os.path.join(path, "model.safetensors.index.json"), "w",
              encoding="utf-8") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    return written


def tree_bit_equal(a, b, key="") -> list:
    """Keys whose tensors differ in any bit (or shape / dtype)."""
    import torch

    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{key}: keys {sorted(set(a) ^ set(b))}"]
        return [k for n in sorted(a) for k in tree_bit_equal(
            a[n], b[n], f"{key}.{n}" if key else n)]
    if a.shape != b.shape or a.dtype != b.dtype:
        return [key]
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    same = (torch.equal(a.view(bits[a.dtype]), b.view(bits[b.dtype]))
            if a.dtype in bits else torch.equal(a, b))
    return [] if same else [key]


def ckpt_serve(cfg, params, paged: bool) -> list:
    """4 greedy requests of ~``CKPT_PROMPT`` tokens, ``CKPT_NEW`` new,
    submitted together on a fresh engine over ``params`` (paged bf16 or
    dense, chunked): their (tokens, reason)."""
    import numpy as np
    import torch

    from swarmdb_tpu_torch.backend.service import build_backend_engine

    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, min(cfg.vocab_size, 30000),
                            CKPT_PROMPT + 7 * i).tolist() for i in range(4)]
    with engine_env(chunked=True):
        eng, _tok = build_backend_engine(
            cfg, seed=0, device="cuda", params=params, paged=paged,
            kv_dtype=torch.bfloat16 if paged else None, max_seq=1024)
    try:
        return run_together(eng, prompts, [CKPT_NEW] * 4, timeout=300.0)
    finally:
        del eng
        torch.cuda.empty_cache()


def ckpt_model(card: str, model: str, layers: int, engines) -> dict:
    """One model of the ckpt phase: drawn at full width and ``layers``
    layers from seed 0 on the card, written as an HF checkpoint, read back
    through ``load_hf_checkpoint`` (bit for bit), served on ``engines``
    (paged flags) with the loaded and the drawn weights (identical
    tokens), then a ``save_params`` / ``restore_params`` round trip (bit
    for bit). Each checkpoint directory is deleted before the next step.
    Returns the kernel launches of its serves."""
    import gc
    import shutil
    import tempfile

    import torch

    from swarmdb_tpu_torch.models import llama, mixtral
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.ops import attention_cuda as ac
    from swarmdb_tpu_torch.utils.checkpoint import (load_hf_checkpoint,
                                                    restore_params,
                                                    save_params)

    cfg = get_config(model, n_layers=layers)
    mod = mixtral if cfg.is_moe else llama
    t0 = time.perf_counter()
    drawn = mod.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    work = tempfile.mkdtemp(prefix="swarm_ckpt_")
    free = shutil.disk_usage(work).free
    hf_dir = os.path.join(work, "hf")
    try:
        t0 = time.perf_counter()
        written = write_hf_checkpoint(drawn, cfg, hf_dir)
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_hf_checkpoint(hf_dir, cfg, dtype=torch.bfloat16,
                                    device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        shutil.rmtree(hf_dir)
        diff = tree_bit_equal(drawn, loaded)
        if diff:
            fail(f"ckpt: {model} loaded weights differ from the drawn ones "
                 f"at {diff[:5]}")
        serves, launches = [], {}
        for paged in engines:
            ac.reset_launches()
            got = ckpt_serve(cfg, loaded, paged)
            for k, n in ac.LAUNCHES.items():
                if n:
                    launches[k] = launches.get(k, 0) + n
            want = ckpt_serve(cfg, drawn, paged)
            toks = [g and g[0] for g in got]
            if (any(g is None or g[1] not in ("length", "eos") for g in got)
                    or toks != [w and w[0] for w in want]):
                fail(f"ckpt: {model} {'paged' if paged else 'dense'} "
                     f"tokens of the loaded weights differ from the drawn "
                     f"ones: {got} != {want}")
            serves.append(dict(engine="paged bf16" if paged else "dense",
                               requests=len(got),
                               tokens=sum(len(t) for t in toks)))
        del loaded
        gc.collect()
        tpath = os.path.join(work, "params.pt")
        t0 = time.perf_counter()
        save_params(drawn, tpath)
        save_s = time.perf_counter() - t0
        saved = os.path.getsize(tpath)
        t0 = time.perf_counter()
        back = restore_params(tpath, target=drawn, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        os.remove(tpath)
        diff = tree_bit_equal(drawn, back)
        if diff:
            fail(f"ckpt: {model} restore_params differs at {diff[:5]}")
        del back
    finally:
        shutil.rmtree(work, ignore_errors=True)
        del drawn
        gc.collect()
        torch.cuda.empty_cache()
    emit("ckpt", model=model, layers=layers, layers_full=get_config(
        model).n_layers, card=card, disk_free_bytes=free,
         draw_s=draw_s, bytes_written=written, write_s=write_s,
         load_s=load_s, load_gb_per_s=written / load_s / 1e9,
         bit_equal=True, serves=serves, save_bytes=saved, save_s=save_s,
         restore_s=restore_s,
         restore_gb_per_s=saved / restore_s / 1e9,
         launches={k: n for k, n in launches.items() if n})
    return launches


def run_ckpt(card: str) -> dict:
    """The ckpt phase: Llama-3-8B at full width and ``CKPT_LLAMA_LAYERS``
    layers served on the paged bf16 engine (kernels 1 and 2) and the
    dense engine (kernel 7), then Mixtral-8x7B at full width and
    ``CKPT_MIXTRAL_LAYERS`` layer on the dense engine (the expert order),
    all from weights read off disk. Returns the serves' launches."""
    launches = {}
    for model, layers, engines in (
            ("llama3-8b", CKPT_LLAMA_LAYERS, (True, False)),
            ("mixtral-8x7b", CKPT_MIXTRAL_LAYERS, (False,))):
        for k, n in ckpt_model(card, model, layers, engines).items():
            launches[k] = launches.get(k, 0) + n
    return launches


# ------------------------------------------------------------------- tp

TP_MODEL = "llama3-8b"
TP_DEVICE = "cuda:0"
TP_BATCH = 4
# 512 positions hold a ~420-token prompt and its 32 new tokens, and the
# one prefill wave is 4 x 512 (not 4 x 1024): gloo stages every
# all-reduce through host memory, so the two-rank run's prefill scales
# with the wave's bytes
TP_SEQ = 512
TP_NEW = 32
TP_PROMPT_LENS = (380, 400, 410, 420)
TP_COLLECTIVE_ITERS = 20
#: world size 2's depth: gloo stages each of a step's 2L + 2 collectives
#: through host memory (1.1-5.4 ms each, by host), so the two-rank model
#: axis runs 8 of Llama-3-8B's 32 layers, against a reference of the same
#: depth, to keep the script inside its time limit on a slow host
TP_WS2_LAYERS = 8
TP_CHILD = [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-child"]
#: the prefix step's side pool (``prefix_pages``, pages of 16): every page
#: the tp prompts and their second turns register (the 4 slots' windows of
#: TP_SEQ tokens) and the trash page, so that no page is evicted and every
#: program's hits are the single engine's
TP_PREFIX_PAGES = 1 + TP_BATCH * TP_SEQ // 16


def tp_prompts() -> list:
    """Four seeded prompts of ~400 token ids (numpy seed 16)."""
    import numpy as np

    from swarmdb_tpu_torch.models.configs import get_config

    rng = np.random.default_rng(16)
    vocab = get_config(TP_MODEL).vocab_size
    return [rng.integers(3, vocab, n).tolist() for n in TP_PROMPT_LENS]


def tp_serve(eng, prompts, queued: bool = False, stop: bool = True) -> dict:
    """The prompts submitted together on a started engine (``queued``:
    submitted before it starts, so that they share one prefill wave and
    every decode step, as a MoE model's capacity needs for a reply that
    does not hang on timing), greedy, TP_NEW new tokens each; the engine
    is stopped after unless ``stop`` is False (a pod coordinator's stop
    releases its workers).
    Returns the request ids, tokens, their logprobs, finish reasons, TTFT
    per request and the wall time."""
    import threading

    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams

    done, first, out = threading.Event(), {}, {}
    t0 = time.perf_counter()

    def on_token(rid, tok):
        first.setdefault(rid, time.perf_counter() - t0)

    def on_done(rid, toks, why):
        out[rid] = (list(toks), why)
        if len(out) == len(prompts):
            done.set()

    reqs = [GenRequest(prompt=list(p),
                       sampling=SamplingParams(max_new_tokens=TP_NEW),
                       on_token=on_token, on_done=on_done) for p in prompts]
    rids = [eng.submit(r) for r in reqs] if queued else None
    eng.start()
    try:
        rids = rids or [eng.submit(r) for r in reqs]
        if not done.wait(300):
            fail(f"tp: {len(out)} of {len(prompts)} requests finished")
        wall = time.perf_counter() - t0
    finally:
        if stop:
            eng.stop()
    return dict(rids=rids, tokens=[out[r][0] for r in rids],
                logprobs=[list(r.metadata.get("logprobs") or [])
                          for r in reqs],
                reasons=[out[r][1] for r in rids],
                ttft_s=[first.get(r) for r in rids], wall_s=wall,
                tokens_per_s=sum(len(out[r][0]) for r in rids) / wall)


def tp_collective_ms(sm, batch: int) -> dict:
    """One decode step's collectives timed alone on the model axis: the
    sum of a [batch, 1, dim] bf16 activation (the embedding's and two per
    layer) and the gather of the [batch, vocab / m] fp32 logits; ms each,
    median of TP_COLLECTIVE_ITERS, every rank in step (host clock around
    a synchronised call: gloo's collectives are host calls)."""
    import torch

    cfg, dev, tp = sm.cfg, sm.mesh.device, sm.model_axis
    m = sm.mesh.shape["model"]
    act = torch.ones((batch, 1, cfg.dim), dtype=torch.bfloat16, device=dev)
    lg = torch.ones((batch, cfg.vocab_size // m), dtype=torch.float32,
                    device=dev)
    out = {}
    for name, fn in (("all_reduce", lambda: tp.all_reduce(act)),
                     ("gather_logits", lambda: tp.gather_last(lg))):
        times = []
        for i in range(TP_COLLECTIVE_ITERS + 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        out[f"{name}_ms"] = statistics.median(times)
    per_step = 2 * cfg.n_layers + 1
    out["collectives_per_step"] = per_step + 1
    out["step_collective_ms"] = (per_step * out["all_reduce_ms"]
                                 + out["gather_logits_ms"])
    return out


def tp_engine(params, chunked: bool, model=None, layers=None,
              prefix_pages: int = 0):
    """This process's share of the dense single program (TP_BATCH slots,
    max_seq TP_SEQ, chunk 8; Llama-3-8B at ``layers`` layers, default
    all; with ``prefix_pages`` its prefix lane over a side pool of that
    many pages of 16): (engine, ShardedModel)."""
    import torch

    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.parallel.serving import build_serving_engine

    cfg = get_config(TP_MODEL, **({"n_layers": layers} if layers else {}))
    with engine_env(chunked):
        return build_serving_engine(
            cfg, [torch.device(TP_DEVICE)], model=model,
            max_batch=TP_BATCH, max_seq=TP_SEQ, decode_chunk=8, params=params,
            prefix_pages=prefix_pages)


def tp_prefix_serve(eng, prompts, stop: bool = True) -> dict:
    """The prefix step's two turns on an engine with the dense prefix
    lane: the tp prompts queued before it starts (``cold``: one prefix
    wave of full misses registering their full pages), then each prompt
    followed by its reply (``hit``: a conversation's second turn, reading
    turn 1's pages); per turn ``tp_serve``'s fields and the
    ``prefix_reused_tokens`` it added (``reused``). The engine is stopped
    after unless ``stop`` is False."""
    c = eng.metrics.counters["prefix_reused_tokens"]
    out = {}
    for turn in ("cold", "hit"):
        batch = prompts if turn == "cold" else [
            list(p) + t for p, t in zip(prompts, out["cold"]["tokens"])]
        before = c.value
        out[turn] = tp_serve(eng, batch, queued=turn == "cold",
                             stop=stop and turn == "hit")
        out[turn]["reused"] = c.value - before
    return out


def tp_prefix_ref(cfg, params, dev) -> dict:
    """The prefix step's reference: the single dense engine, chunked, with
    its prefix lane over a side pool of TP_PREFIX_PAGES pages, over
    ``params`` (Llama-3-8B at ``cfg``'s depth), its graphs captured before
    traffic: ``tp_prefix_serve``."""
    from swarmdb_tpu_torch.backend.service import build_backend_engine

    with engine_env(True, SWARMDB_PREFIX="1",
                    SWARMDB_PREFIX_TOKENS=str(TP_BATCH * TP_SEQ)):
        eng, _ = build_backend_engine(
            cfg, seed=0, device=dev, params=params, paged=None,
            max_batch=TP_BATCH, max_seq=TP_SEQ, decode_chunk=8)
    if eng._prefix_num_pages != TP_PREFIX_PAGES:
        fail(f"tp prefix: the reference's side pool has "
             f"{eng._prefix_num_pages} pages, not {TP_PREFIX_PAGES}")
    eng.warmup()
    return tp_prefix_serve(eng, prompts=tp_prompts())


def prefix_rank(eng, axis, rank: int, prompts, warm: bool = False) -> dict:
    """One rank's prefix step on a single-program engine with the lane:
    rank 0 publishes (``enable_multihost``; ``warm``: captures its chunk
    graphs then) and serves the two turns (``tp_prefix_serve``), the
    others replay its calls, call 4 among them; this rank's launches, its
    ``axis``'s collectives over the step, and its side pool's pages and KV
    heads."""
    import torch

    from swarmdb_tpu_torch.ops import attention_cuda as ac

    calls0 = axis.calls
    ac.reset_launches()
    if rank == 0:
        eng.enable_multihost()
        if warm:
            eng.warmup()
        res = tp_prefix_serve(eng, prompts)
    else:
        eng.worker_loop()
        res = {}
    torch.cuda.synchronize()
    res.update(launches={k: n for k, n in ac.LAUNCHES.items() if n},
               collectives=axis.calls - calls0,
               pool=[eng._prefix_pool[0].shape[1],
                     eng._prefix_pool[0].shape[3]])
    return res


def tp_child(rank: int, store: str, result_path: str) -> int:
    """One rank of the two-rank pod on cuda:0 over gloo: Llama-3-8B at
    full width and ``TP_WS2_LAYERS`` layers drawn from seed 0, each tensor
    whole then this rank's half kept; the dense engine chunked (kernel 7)
    and single-step (kernel 8), rank 0 serving and rank 1 replaying; then
    the prefix step's chunked engine with its prefix lane
    (``prefix_rank``); then the collectives timed alone; then the dp step
    (``dp_child``)."""
    import gc

    import torch
    import torch.distributed as dist

    from swarmdb_tpu_torch.ops import attention_cuda as ac
    from swarmdb_tpu_torch.ops import build
    from swarmdb_tpu_torch.parallel.distributed import init_distributed

    dev = torch.device(TP_DEVICE)
    torch.cuda.set_device(dev)
    build.build_all()
    t0 = time.perf_counter()
    init_distributed(f"file://{store}", 2, rank, backend="gloo", device=dev)
    out = {"rank": rank}
    with torch.no_grad():
        eng, sm = tp_engine(None, True, model=2, layers=TP_WS2_LAYERS)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        lp = sm.params["layers"]
        out["heads"] = [lp["wq"].shape[-1] // sm.cfg.head_dim,
                        eng.cache[0].shape[3]]
        out["backend"] = sm.model_axis.backend
        out["graphs"] = eng.flight.meta["graphs"]
        prompts = tp_prompts()
        for chunked in (True, False):
            if not chunked:
                del eng
                gc.collect()
                eng, sm = tp_engine(sm.params, False, model=2,
                                    layers=TP_WS2_LAYERS)
            tp = sm.model_axis
            calls0 = tp.calls
            ac.reset_launches()
            if rank == 0:
                eng.enable_multihost()
                res = tp_serve(eng, prompts)
            else:
                eng.worker_loop()
                res = {}
            torch.cuda.synchronize()
            res["launches"] = {k: n for k, n in ac.LAUNCHES.items() if n}
            res["collectives"] = tp.calls - calls0
            res["chunks"] = eng.metrics.counters[
                "engine_decode_chunks"].value
            out["chunked" if chunked else "single"] = res
        # the prefix step: the chunked engine with its prefix lane over the
        # same weights (rank 1 replays call 4)
        del eng
        gc.collect()
        eng, sm = tp_engine(sm.params, True, model=2, layers=TP_WS2_LAYERS,
                            prefix_pages=TP_PREFIX_PAGES)
        out["prefix"] = prefix_rank(eng, sm.model_axis, rank, prompts)
        out.update(tp_collective_ms(sm, TP_BATCH))
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        # the dp step, on the same two ranks and process group: the
        # model-axis engine and its weights go first
        del eng, sm, lp
        gc.collect()
        torch.cuda.empty_cache()
        out["dp"] = dp_child(rank, dev)
    with open(result_path, "w", encoding="utf-8") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


#: The tp phase's dp step: the single program over a data axis of two on
#: the tp phase's ranks, each holding Llama-3-8B whole and 2 of the 4
#: slots -- (serve, paged, chunked, under SWARMDB_KERNCHECK=1 (the
#: kernels' bounds-checked build and the checked dispatcher), the decode
#: kernel its ranks must launch). The paged serves run over the sharded
#: pool (97 pages of 16 a shard at max_seq 512, prefix cache on).
DP_SERVES = (("paged_chunked", True, True, False, "paged_decode_chunked"),
             ("paged_single_kerncheck", True, False, True, "paged_decode"),
             ("dense_chunked", False, True, False, "dense_decode_chunked"))
DP_GATHER_ITERS = 20


def dp_child(rank: int, dev) -> dict:
    """One rank's dp step: Llama-3-8B drawn whole from seed 0 (data 2,
    model 1), then each of ``DP_SERVES`` on the tp phase's prompts, rank 0
    serving and rank 1 replaying; per serve this rank's slots, pool pages,
    launches, kernel-sanitizer violations, flight meta and chunk runner;
    then the per-chunk block gather timed alone; then the prefix step's
    dense engine with its prefix lane over the data axis (each rank runs
    every prefix wave whole, ``prefix_rank``)."""
    import gc

    import torch

    from swarmdb_tpu_torch.obs import kerncheck
    from swarmdb_tpu_torch.ops import attention_cuda as ac
    from swarmdb_tpu_torch.parallel.serving import build_serving_engine

    torch.cuda.reset_peak_memory_stats(dev)
    prompts, params, out = tp_prompts(), None, {}
    t0 = time.perf_counter()
    for name, paged, chunked, checked, kernel in DP_SERVES:
        with engine_env(chunked, SWARMDB_KERNCHECK="1" if checked else None):
            eng, sm = build_serving_engine(
                TP_MODEL, [dev], data=2, paged=paged, max_batch=TP_BATCH,
                max_seq=TP_SEQ, decode_chunk=8, params=params)
            if params is None:
                torch.cuda.synchronize()
                out["init_s"] = time.perf_counter() - t0
            params = sm.params
            # the greedy chunk's graph captured before traffic (no
            # collective inside on a data axis), on each rank alone
            t_cap = time.perf_counter()
            eng._runner.capture(2)
            res = {"capture_s": time.perf_counter() - t_cap}
            kerncheck.registry().reset()
            ac.reset_launches()
            if rank == 0:
                eng.enable_multihost()
                res.update(tp_serve(eng, prompts))
            else:
                eng.worker_loop()
            torch.cuda.synchronize()
            ac.kerncheck_poll(dev)
        res.update(
            kernel=kernel, checked=checked,
            launches={k: n for k, n in ac.LAUNCHES.items() if n},
            kernel_violations=len(kerncheck.registry().violations()),
            slots=[eng._lo, eng._lo + eng._rows],
            pool_pages=eng.cache["k"].shape[1] if paged else None,
            paged_shards=eng.flight.meta["paged_shards"],
            graphs=eng.flight.meta["graphs"],
            chunks=eng.stats()["decode_chunks"])
        out[name] = res
        if name == "dense_chunked":
            out["gather_ms"] = dp_gather_ms(eng, dev)
        del eng
        gc.collect()
    with engine_env(True):
        eng, sm = build_serving_engine(
            TP_MODEL, [dev], data=2, paged=False, max_batch=TP_BATCH,
            max_seq=TP_SEQ, decode_chunk=8, params=params,
            prefix_pages=TP_PREFIX_PAGES)
    eng._runner.capture(2)
    out["dense_prefix"] = prefix_rank(eng, sm.mesh.axis("data"), rank,
                                      prompts)
    del eng, sm
    gc.collect()
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def dp_gather_ms(eng, dev) -> float:
    """One chunk's block gather over the data axis timed alone: a [9, 2]
    token and logprob block per rank joined into [9, 4], median of
    DP_GATHER_ITERS, both ranks in step (host clock around a synchronised
    call: gloo's collectives are host calls)."""
    import torch

    block = torch.zeros((9, eng._rows), dtype=torch.int32, device=dev)
    lps = torch.zeros((9, eng._rows), dtype=torch.float32, device=dev)
    times = []
    for i in range(DP_GATHER_ITERS + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._gather_block(block, lps)
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


#: engine keywords the model-axis program takes through
#: ``build_serving_engine`` (neither is a default, neither changes tokens):
#: its coordinator must hold them, before and after ``restart()``
LOCAL_KNOBS = {"pipeline_depth": 1, "aging_s": 30.0}

#: The tp phase's local step: the single program over two devices of this
#: process (``cuda:0`` twice, so gloo), this process rank 0 and one
#: spawned worker -- (serve, ``build_serving_engine``'s keywords, depth
#: (None: all 32 layers), the decode kernel rank 0 must launch). The model
#: axis runs at (c)'s depth and the sharded paged engine at the dp step's,
#: the depths of the pod serves they are held to.
LOCAL_SERVES = (
    ("model", {"paged": False, **LOCAL_KNOBS}, TP_WS2_LAYERS,
     "dense_decode_chunked"),
    ("data_paged", {"paged": True, "admit_overlap": False}, None,
     "paged_decode_chunked"))
LOCAL_DEVICES = ("cuda:0", "cuda:0")
#: the local program's SWARMDB_PG_TIMEOUT_S: bounds the kill's wait
LOCAL_PG_TIMEOUT_S = 30


def local_kill(eng, prompts) -> dict:
    """The tp prompts submitted together, the worker SIGKILLed at the first
    token: each request's finish reason, whether all finished within the
    process group's timeout and a minute, the seconds from the kill to the
    last, and the engine's pod state after."""
    import signal

    from swarmdb_tpu_torch.backend.engine import GenRequest
    from swarmdb_tpu_torch.backend.sampling import SamplingParams

    done, out, t_kill = threading.Event(), {}, []

    def on_token(rid, tok):
        if not t_kill:
            t_kill.append(time.perf_counter())
            os.kill(eng._owner.pids()[0], signal.SIGKILL)

    def on_done(rid, toks, why):
        out[rid] = why
        if len(out) == len(prompts):
            done.set()

    for p in prompts:
        eng.submit(GenRequest(prompt=list(p),
                              sampling=SamplingParams(max_new_tokens=TP_NEW),
                              on_token=on_token, on_done=on_done))
    finished = done.wait(LOCAL_PG_TIMEOUT_S + 60)
    return dict(reasons=list(out.values()), finished=finished,
                seconds=(time.perf_counter() - t_kill[0]) if t_kill else None,
                pod=eng.stats()["pod"])


def local_knobs(eng) -> dict:
    """The coordinator engine's values of ``LOCAL_KNOBS``."""
    return {"pipeline_depth": eng.pipeline_depth, "aging_s": eng._aging_s}


def tp_local(prompts) -> dict:
    """The tp phase's local step: for each of ``LOCAL_SERVES`` the program
    built by this process (its spawn, init and build seconds), the tp
    prompts served (TTFT, tokens/s, tokens and logprobs, rank 0's
    launches), and once more if its chunks replay as graphs (the first
    serve captured them); on the model axis then a serve whose worker is
    killed (``local_kill``), ``restart()`` (its seconds) and the prompts
    served again. After each ``stop()``: the workers' exit codes and
    whether a process group is left. ``launches`` adds up every serve's,
    ``step_s`` the step's seconds."""
    import gc

    import torch
    import torch.distributed as dist

    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.ops import attention_cuda as ac
    from swarmdb_tpu_torch.parallel.serving import build_serving_engine

    out, total, t_step = {}, {}, time.perf_counter()
    for name, kw, layers, kernel in LOCAL_SERVES:
        cfg = get_config(TP_MODEL, **({"n_layers": layers} if layers else {}))
        t0 = time.perf_counter()
        with engine_env(True, SWARMDB_PG_TIMEOUT_S=str(LOCAL_PG_TIMEOUT_S)):
            eng, sm = build_serving_engine(
                cfg, list(LOCAL_DEVICES), max_batch=TP_BATCH, max_seq=TP_SEQ,
                decode_chunk=8, **kw)
        owner = eng._owner
        res = dict(owner.timings, build_s=time.perf_counter() - t0,
                   layers=cfg.n_layers, backend=owner.backend,
                   mesh=dict(sm.mesh.shape), graphs=eng.flight.meta["graphs"],
                   paged_shards=eng.flight.meta["paged_shards"],
                   kernel=kernel)
        ac.reset_launches()
        res.update(tp_serve(eng, prompts, stop=False))
        torch.cuda.synchronize()
        res["launches"] = {k: n for k, n in ac.LAUNCHES.items() if n}
        if eng.flight.meta["graphs"]:
            # the first serve captured each rank's chunk graphs (the dp
            # step's pod captured them before traffic): once more, warm
            res["warm"] = tp_serve(eng, prompts, stop=False)
        if name == "model":
            res["knobs"] = local_knobs(eng)
            res["kill"] = local_kill(eng, prompts)
            t0 = time.perf_counter()
            eng.restart()
            res["restart_s"] = time.perf_counter() - t0
            res["respawn"] = dict(owner.timings)
            res["again"] = tp_serve(eng, prompts, stop=False)
            res["knobs_after_restart"] = local_knobs(eng)
            torch.cuda.synchronize()
        for k, n in ac.LAUNCHES.items():
            total[k] = total.get(k, 0) + n
        procs = list(owner.procs)
        eng.stop()
        res["left"] = dict(worker_codes=[p.returncode for p in procs],
                           group=dist.is_initialized())
        out[name] = res
        del eng, sm, owner
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = total
    out["step_s"] = time.perf_counter() - t_step
    return out


def local_checks(local, pods, holds, checks) -> dict:
    """The local step's checks, added to ``checks``: per serve, its tokens
    equal to the pod serve's (``pods``), or, where they part, held to the
    pod's reference by ``holds(name, i, tokens, logprobs)`` (``tp_hold``:
    equal to it or parting at a near tie); reasons length / eos; rank 0
    launched its kernel; the kill ended every request "engine_error" in
    time and ``restart()`` served the same tokens again; each ``stop()``
    left every worker exited 0 and no process group. Returns the step's
    summary for its line."""
    summary = {}
    for name, _kw, _layers, kernel in LOCAL_SERVES:
        res = local[name]
        parted = [i for i, (a, b) in enumerate(zip(res["tokens"],
                                                   pods[name])) if a != b]
        held = {i: holds(name, i, res["tokens"][i], res["logprobs"][i])
                for i in parted}
        checks[f"local {name} tokens == the pod's, or part at a near "
               "tie"] = all(h["step"] is None or h["near_tie"]
                            for h in held.values())
        checks[f"local {name} reasons length/eos"] = all(
            r in ("length", "eos") for r in res["reasons"])
        checks[f"local {name} rank 0 launched {kernel}"] = res[
            "launches"].get(kernel, 0) > 0
        checks[f"local {name} stop left no worker and no group"] = (
            res["left"]["worker_codes"] == [0]
            and not res["left"]["group"])
        summary[name] = {k: v for k, v in res.items()
                         if k not in ("tokens", "logprobs", "again", "warm")}
        summary[name]["parted"] = {str(i): h for i, h in held.items()}
        if "warm" in res:
            # its prompts hit the prefix cache the first serve filled, so
            # it prefills other waves: held as the first serve is
            warm = res["warm"]
            warm_held = {
                i: holds(name, i, warm["tokens"][i], warm["logprobs"][i])
                for i, (a, b) in enumerate(zip(warm["tokens"], pods[name]))
                if a != b}
            checks[f"local {name} warm serve: the pod's tokens, or part at "
                   "a near tie"] = all(h["step"] is None or h["near_tie"]
                                       for h in warm_held.values())
            checks[f"local {name} warm serve reasons length/eos"] = all(
                r in ("length", "eos") for r in warm["reasons"])
            summary[name]["warm"] = {k: warm[k] for k in (
                "ttft_s", "tokens_per_s", "wall_s", "reasons")}
            summary[name]["warm"]["parted"] = {
                str(i): h for i, h in warm_held.items()}
        if "kill" in res:
            kill, again = res["kill"], res["again"]
            checks[f"local {name} killed worker: every request "
                   "engine_error"] = (kill["finished"] and kill["reasons"]
                                      == ["engine_error"] * len(pods[name]))
            checks[f"local {name} restart serves the same tokens"] = (
                again["tokens"] == res["tokens"])
            checks[f"local {name} coordinator holds {LOCAL_KNOBS}, before "
                   "and after restart"] = (
                res["knobs"] == LOCAL_KNOBS
                and res["knobs_after_restart"] == LOCAL_KNOBS)
            summary[name]["again"] = {k: again[k] for k in (
                "ttft_s", "tokens_per_s", "wall_s", "reasons")}
    return summary


#: world size 2 against the plain forward is held to this many times the
#: reference serve's own distance from it (``tol``): its logits carry the
#: same engine path's rounding plus one more bf16 rounding of each split
#: sum (the all-reduce of two halves where one rank sums all), of the same
#: kind and no larger. A wrong split (a lost all-reduce, a bad masked
#: embedding, shards of other weights) moves them by whole units.
TP_WS2_TOL_FACTOR = 2.0


def tp_hold(plain, ref, got, got_lps, bound) -> dict:
    """World size 2's serve of one prompt against the plain bf16 forward
    over the reference's tokens (``plain``: f32 logits, one row per
    step): at every step whose context equals the reference's (up to and
    including the first parting) the |log-probability difference| of
    world size 2's token between it and the plain forward; and where the
    tokens first part, whether both lie within ``bound`` of the plain
    top logit there."""
    import torch

    lp = torch.log_softmax(plain, -1)
    i = next((k for k, (a, b) in enumerate(zip(ref, got)) if a != b), None)
    off = len(got) - len(got_lps)
    last = len(got) if i is None else i + 1
    err = max((abs(float(lp[s, got[s]]) - got_lps[s - off])
               for s in range(max(off, 0), min(last, len(ref)))),
              default=float("inf"))
    out = dict(logprob_err=err, held=err <= bound, step=i)
    if i is not None:
        z = plain[i]
        top = float(z.max())
        below = max(top - float(z[ref[i]]), top - float(z[got[i]]))
        out.update(below_top=below, near_tie=below <= bound)
    return out


def run_tp(card, params):
    """The tp phase (see the module docstring). Returns the launches of
    the world-size-1 pod's serve and of both ranks' serves."""
    import gc
    import socket
    import tempfile

    import torch
    import torch.distributed as dist

    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.ops import attention_cuda as ac
    from swarmdb_tpu_torch.parallel.distributed import init_distributed

    t_phase = time.perf_counter()
    dev = torch.device(TP_DEVICE)
    prompts = tp_prompts()
    # the reference: the default dense engine, chunked, as the serve
    # phase builds it but without the prefix cache (the pod's engine has
    # none, as the JAX package's sharded engine)
    with engine_env(True, SWARMDB_PREFIX="0"):
        ref_eng, _ = build_backend_engine(
            TP_MODEL, seed=0, device=dev, params=params, paged=None,
            max_batch=TP_BATCH, max_seq=TP_SEQ, decode_chunk=8)
    ref_eng.warmup()
    ref = tp_serve(ref_eng, prompts)
    del ref_eng
    # the dp step's paged references: the single paged engine (bf16 pool,
    # prefix cache on), chunked and single-step
    dp_refs = {"dense_chunked": ref}
    for mode, chunked in (("paged_chunked", True),
                          ("paged_single_kerncheck", False)):
        with engine_env(chunked):
            ref_eng, _ = build_backend_engine(
                TP_MODEL, seed=0, device=dev, params=params, paged=True,
                max_batch=TP_BATCH, max_seq=TP_SEQ, decode_chunk=8)
        dp_refs[mode] = tp_serve(ref_eng, prompts)
        del ref_eng
    # the prefix step's reference at full depth: the single dense engine
    # with its prefix lane, two turns
    prefix_ref = tp_prefix_ref(get_config(TP_MODEL), params, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # world size 1 over NCCL: the pod path on the serve phase's weights
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    init_distributed(f"tcp://127.0.0.1:{port}", 1, 0, device=dev)
    try:
        eng, sm = tp_engine(params, True)
        init_s = time.perf_counter() - t0
        tp = sm.model_axis
        eng.enable_multihost()
        calls0 = tp.calls
        eng.warmup()        # captures the three variants' chunk graphs
        captured = tp.calls - calls0
        ac.reset_launches()
        ws1 = tp_serve(eng, prompts)
        launches = dict(ac.LAUNCHES)
        ws1.update(tp_collective_ms(sm, TP_BATCH))
        # the ring step on a one-rank NCCL axis is the identity
        probe = torch.arange(8, device=dev)
        ws1.update(init_s=init_s, backend=tp.backend,
                   graphs=eng.flight.meta["graphs"],
                   collectives_captured_per_step=captured / (3 * 8),
                   chunks=eng.stats()["decode_chunks"],
                   shift_identity=tp.shift(probe) is probe)
        del eng, sm
        # the prefix step on world size 1: the pod engine with its lane,
        # its chunk graphs captured before traffic
        eng, sm = tp_engine(params, True, prefix_pages=TP_PREFIX_PAGES)
        ws1_prefix = prefix_rank(eng, sm.model_axis, 0, prompts, warm=True)
        del eng, sm
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    checks = {
        "ws1 NCCL pod tokens == the dense chunked engine's":
            ws1["tokens"] == ref["tokens"],
        "ws1 replays graphs": ws1["graphs"] is True
            and ws1["chunks"]["mode"] == "graphs",
        "ws1 kernel 7 launched": launches.get("dense_decode_chunked", 0) > 0,
        "ws1 Axis.shift is the identity": ws1["shift_identity"],
        "ws1 reasons length/eos": all(r in ("length", "eos")
                                      for r in ws1["reasons"]),
    }

    # world size 2's reference: the same dense engine at TP_WS2_LAYERS
    # layers, its weights drawn from seed 0 as the ranks draw theirs, and
    # the plain forward over its tokens; served before the ranks start
    cfg_ws2 = get_config(TP_MODEL, n_layers=TP_WS2_LAYERS)
    params_ws2 = llama.init_params(cfg_ws2, seed=0, device=dev)
    with engine_env(True, SWARMDB_PREFIX="0"):
        ref_eng, _ = build_backend_engine(
            cfg_ws2, seed=0, device=dev, params=params_ws2, paged=None,
            max_batch=TP_BATCH, max_seq=TP_SEQ, decode_chunk=8)
    ref_ws2 = tp_serve(ref_eng, prompts)
    del ref_eng
    prefix_ref_ws2 = tp_prefix_ref(cfg_ws2, params_ws2, dev)
    plain_ws2 = [plain_step_logits(params_ws2, p, t, cfg_ws2)
                 for p, t in zip(prompts, ref_ws2["tokens"])]
    del params_ws2
    gc.collect()
    torch.cuda.empty_cache()
    tol_ws2 = ref_logprob_tol(plain_ws2, ref_ws2)
    bound_ws2 = TP_WS2_TOL_FACTOR * tol_ws2

    # world size 2 on cuda:0 over gloo: two child processes
    work = tempfile.mkdtemp(prefix="swarm_tp_")
    store = os.path.join(work, "store")
    results = [os.path.join(work, f"rank{r}.json") for r in range(2)]
    env = dict(os.environ, PYTHONPATH=str(ROOT), SWARMDB_PG_TIMEOUT_S="300")
    for k in ("SWARMDB_PAGED", "SWARMDB_CHUNKED", "SWARMDB_PREFIX"):
        env.pop(k, None)
    sys.stdout.flush()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        TP_CHILD + [str(r), store, results[r]], cwd=str(ROOT), env=env)
        for r in range(2)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ws2_s = time.perf_counter() - t0
    if codes != [0, 0] or not all(os.path.exists(r) for r in results):
        fail(f"tp: the two ranks exited with {codes}")
    ranks = []
    for r in results:
        with open(r, encoding="utf-8") as f:
            ranks.append(json.load(f))
    # (e) the same programs, built by this process over two devices of it
    local = tp_local(prompts)
    # the tolerance comes only from paths outside the runs under test:
    # the largest |log-probability difference| of the chosen token
    # between a reference serve and a plain bf16 forward over its tokens,
    # over every step of every request; (c) is held to its reference at
    # its depth, the dp step to the full-depth references
    plain = [plain_step_logits(params, p, t)
             for p, t in zip(prompts, ref["tokens"])]
    tol = ref_logprob_tol(plain, ref)
    holds = {mode: [tp_hold(z, a, b, lps, bound_ws2)
                    for z, a, b, lps in zip(
                        plain_ws2, ref_ws2["tokens"],
                        ranks[0][mode]["tokens"],
                        ranks[0][mode]["logprobs"])]
             for mode in ("chunked", "single")}
    paged_plain = []

    def local_hold(name, i, got, lps):
        if name == "model":
            return tp_hold(plain_ws2[i], ref_ws2["tokens"][i], got, lps,
                           bound_ws2)
        ref_p = dp_refs["paged_chunked"]
        if not paged_plain:     # a parting on the paged serve: its plain
            paged_plain.extend(plain_step_logits(params, p, t) for p, t in
                               zip(prompts, ref_p["tokens"]))
        return tp_hold(paged_plain[i], ref_p["tokens"][i], got, lps,
                       TP_WS2_TOL_FACTOR * ref_logprob_tol(paged_plain,
                                                           ref_p))

    local_sum = local_checks(local, {
        "model": ranks[0]["chunked"]["tokens"],
        "data_paged": ranks[0]["dp"]["paged_chunked"]["tokens"]},
        local_hold, checks)
    del plain_ws2, paged_plain
    dp = dp_checks(params, prompts, dp_refs, plain, tol, ranks, checks)
    del plain
    prefix = tp_prefix_checks(params, cfg_ws2, prompts, {
        "ws1": (ws1_prefix, prefix_ref, TP_WS2_TOL_FACTOR * tol),
        "ws2": (ranks[0]["prefix"], prefix_ref_ws2, bound_ws2),
        "dp": (ranks[0]["dp"]["dense_prefix"], prefix_ref,
               TP_WS2_TOL_FACTOR * tol)}, checks)
    for r, rank in enumerate(ranks):
        for name, res in (("ws2", rank["prefix"]),
                          ("dp", rank["dp"]["dense_prefix"])):
            checks[f"prefix {name} rank {r} kernel 7 launched"] = res[
                "launches"].get("dense_decode_chunked", 0) > 0
            prefix[name][f"rank{r}"] = {k: res[k] for k in (
                "launches", "collectives", "pool")}
    checks["prefix ws1 kernel 7 launched"] = ws1_prefix["launches"].get(
        "dense_decode_chunked", 0) > 0
    prefix["ws1"]["rank0"] = {k: ws1_prefix[k] for k in (
        "launches", "collectives", "pool")}
    for r, rank in enumerate(ranks):
        checks[f"rank {r} runs Hq 16, Hkv 4"] = rank["heads"] == [16, 4]
        checks[f"rank {r} eager chunks over gloo"] = (
            rank["backend"] == "gloo" and rank["graphs"] is False)
        checks[f"rank {r} kernel 7 in the chunked serve"] = rank[
            "chunked"]["launches"].get("dense_decode_chunked", 0) > 0
        checks[f"rank {r} kernel 8 in the single-step serve"] = rank[
            "single"]["launches"].get("dense_decode", 0) > 0
    for mode, hs in holds.items():
        checks[f"ws2 {mode} logprobs within {TP_WS2_TOL_FACTOR:g} x tol "
               "of the plain forward"] = all(h["held"] for h in hs)
        checks[f"ws2 {mode} tokens == the {TP_WS2_LAYERS}-layer "
               "reference's, or part at a near tie"] = all(
            h["step"] is None or h["near_tie"] for h in hs)
        checks[f"ws2 {mode} reasons length/eos"] = all(
            r in ("length", "eos") for r in ranks[0][mode]["reasons"])
    bad = [k for k, ok in checks.items() if not ok]
    emit("tp_prefix", card=card, model=TP_MODEL, pool_pages=TP_PREFIX_PAGES,
         ws2_layers=TP_WS2_LAYERS, programs=prefix,
         refs={name: {turn: prefix_turn_summary(r[turn])
                      for turn in ("cold", "hit")}
               for name, r in (("full", prefix_ref),
                               ("ws2_layers", prefix_ref_ws2))},
         checks={k: v for k, v in checks.items() if k.startswith("prefix ")})
    emit("tp_local", card=card, model=TP_MODEL, devices=list(LOCAL_DEVICES),
         pg_timeout_s=LOCAL_PG_TIMEOUT_S, step_s=local["step_s"],
         serves=local_sum,
         checks={k: v for k, v in checks.items() if k.startswith("local ")})
    summary = {k: v for k, v in ws1.items()
               if k not in ("tokens", "logprobs")}
    emit("tp", card=card, model=TP_MODEL,
         layers=get_config(TP_MODEL).n_layers, batch=TP_BATCH,
         prompt_tokens=list(TP_PROMPT_LENS), new_tokens=TP_NEW,
         ref=dict(ttft_s=ref["ttft_s"], tokens_per_s=ref["tokens_per_s"]),
         ws1=summary, ws1_launches={k: n for k, n in launches.items() if n},
         ws2={f"rank{r['rank']}": {k: v for k, v in r.items()
                                   if k not in ("rank", "dp", "prefix")}
              | {m: {k: v for k, v in r[m].items()
                     if k not in ("tokens", "logprobs")}
                 for m in ("chunked", "single")} for r in ranks},
         dp=dp,
         ws2_layers=TP_WS2_LAYERS,
         ws2_ref=dict(ttft_s=ref_ws2["ttft_s"],
                      tokens_per_s=ref_ws2["tokens_per_s"]),
         ws2_wall_s=ws2_s, logprob_tol=tol, ws2_logprob_tol=tol_ws2,
         ws2_bound=bound_ws2, holds=holds,
         phase_s=time.perf_counter() - t_phase, checks=checks)
    if bad:
        fail(f"tp checks failed: {bad}")
    total = dict(launches)
    for k, n in (list(local["launches"].items())
                 + list(ws1_prefix["launches"].items())):
        total[k] = total.get(k, 0) + n
    for rank in ranks:
        for runs in (rank, rank["dp"]):
            for mode, res in runs.items():
                if isinstance(res, dict) and "launches" in res:
                    for k, n in res["launches"].items():
                        total[k] = total.get(k, 0) + n
    return total


def prefix_turn_summary(res) -> dict:
    """A prefix-step turn's numbers for its line: TTFT (each request's and
    the median), tokens/s, wall seconds, reused tokens, reasons."""
    return dict(ttft_s=res["ttft_s"],
                ttft_median_s=statistics.median(res["ttft_s"]),
                tokens_per_s=res["tokens_per_s"], wall_s=res["wall_s"],
                reused=res["reused"], reasons=res["reasons"])


def tp_prefix_checks(params, cfg_ws2, prompts, programs, checks) -> dict:
    """The prefix step's checks, added to ``checks``: for each program
    (name: (its rank 0's ``tp_prefix_serve``, the reference's, the bound))
    and turn, its tokens equal the single dense engine's with its lane at
    the same depth, or part at a near tie held by ``tp_hold`` against the
    plain bf16 forward over the reference's context and tokens (drawn
    only for a parting; a second turn whose first parted has another
    context, so is not compared); its reused tokens equal the reference's,
    the hit turn's above 0; every reply length / eos. Returns the step's
    summary: per program and turn TTFT, tokens/s, reused tokens and
    partings, and the hit turn's median TTFT over the cold one's."""
    import gc

    import torch

    from swarmdb_tpu_torch.models import llama

    small = []      # the reference weights at the pod's depth, once drawn

    def plain_of(name, ref, turn, i):
        ctx = list(prompts[i]) + ([] if turn == "cold"
                                  else ref["cold"]["tokens"][i])
        if name != "ws2":
            return plain_step_logits(params, ctx, ref[turn]["tokens"][i])
        if not small:
            small.append(llama.init_params(cfg_ws2, seed=0,
                                           device=TP_DEVICE))
        return plain_step_logits(small[0], ctx, ref[turn]["tokens"][i],
                                 cfg_ws2)

    out = {}
    for name, (got, ref, bound) in programs.items():
        out[name] = {"bound": bound}
        skip = set()
        for turn in ("cold", "hit"):
            g, r = got[turn], ref[turn]
            held = {i: tp_hold(plain_of(name, ref, turn, i), a, b,
                               g["logprobs"][i], bound)
                    for i, (a, b) in enumerate(zip(r["tokens"], g["tokens"]))
                    if a != b and i not in skip}
            checks[f"prefix {name} {turn} tokens == the single engine's, "
                   "or part at a near tie"] = all(
                h["step"] is None or h["near_tie"] for h in held.values())
            checks[f"prefix {name} {turn} reused == the single "
                   "engine's"] = g["reused"] == r["reused"]
            checks[f"prefix {name} {turn} reasons length/eos"] = all(
                x in ("length", "eos") for x in g["reasons"])
            out[name][turn] = dict(prefix_turn_summary(g),
                                   parted={str(i): h for i, h in held.items()},
                                   not_compared=sorted(skip))
            skip |= set(held)
        checks[f"prefix {name} hit turn reused > 0"] = got["hit"]["reused"] > 0
        turns = out[name]
        turns["hit_over_cold_ttft"] = (turns["hit"]["ttft_median_s"]
                                       / turns["cold"]["ttft_median_s"])
    small.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ref_logprob_tol(plain, ref) -> float:
    """The largest |log-probability difference| of a reference serve's
    chosen tokens from the plain bf16 forward over them (``plain``), over
    every step of every request: the tp phase's ``tol``."""
    import torch

    diffs = []
    for z, toks, lps in zip(plain, ref["tokens"], ref["logprobs"]):
        lp = torch.log_softmax(z, -1)
        off = len(toks) - len(lps)
        diffs += [abs(float(lp[s, toks[s]]) - lps[s - off])
                  for s in range(off, min(len(toks), lp.shape[0]))]
    if not diffs:
        fail("tp: a reference serve returned no logprobs")
    return max(diffs)


def dp_checks(params, prompts, refs, dense_plain, dense_tol, ranks,
              checks) -> dict:
    """The dp step's checks, added to ``checks``: per serve, rank 0's
    tokens against its single-engine reference (equal, or parting at a
    near tie by ``tp_hold`` with twice the reference's own ``tol``), every
    reply length / eos, each rank's decode kernel launched on its two
    slots, zero kernel-sanitizer violations, ``paged_shards`` 2 on a
    paged serve. Returns the step's summary for the ``tp`` line."""
    plains = {"dense_chunked": (dense_plain, dense_tol)}
    for mode in ("paged_chunked", "paged_single_kerncheck"):
        z = [plain_step_logits(params, p, t)
             for p, t in zip(prompts, refs[mode]["tokens"])]
        plains[mode] = (z, ref_logprob_tol(z, refs[mode]))
    out = {"refs": {m: dict(ttft_s=r["ttft_s"],
                            tokens_per_s=r["tokens_per_s"])
                    for m, r in refs.items()}}
    for name, paged, _chunked, checked, kernel in DP_SERVES:
        z, tol = plains[name]
        bound = TP_WS2_TOL_FACTOR * tol
        got = ranks[0]["dp"][name]
        holds = [tp_hold(zz, a, b, lps, bound) for zz, a, b, lps in zip(
            z, refs[name]["tokens"], got["tokens"], got["logprobs"])]
        checks[f"dp {name} logprobs within {TP_WS2_TOL_FACTOR:g} x tol "
               "of the plain forward"] = all(h["held"] for h in holds)
        checks[f"dp {name} tokens == the single engine's, or part at a "
               "near tie"] = all(h["step"] is None or h["near_tie"]
                                 for h in holds)
        checks[f"dp {name} reasons length/eos"] = all(
            r in ("length", "eos") for r in got["reasons"])
        for r, rank in enumerate(ranks):
            res = rank["dp"][name]
            checks[f"dp {name} rank {r} kernel {kernel} on slots "
                   f"{2 * r}-{2 * r + 1}"] = (
                res["launches"].get(kernel, 0) > 0
                and res["slots"] == [2 * r, 2 * r + 2])
            checks[f"dp {name} rank {r} kernel violations 0"] = (
                res["kernel_violations"] == 0)
            if paged:
                checks[f"dp {name} rank {r} paged_shards 2"] = (
                    res["paged_shards"] == 2)
        out[name] = dict(
            tol=tol, holds=holds, checked=checked,
            ttft_s=got["ttft_s"], tokens_per_s=got["tokens_per_s"],
            ranks=[{k: v for k, v in rank["dp"][name].items()
                    if k not in ("tokens", "logprobs", "reasons", "ttft_s",
                                 "tokens_per_s", "wall_s", "forced_errs",
                                 "routing")}
                   for rank in ranks])
    out["gather_ms"] = [rank["dp"]["gather_ms"] for rank in ranks]
    out["init_s"] = [rank["dp"]["init_s"] for rank in ranks]
    out["peak_memory_gib"] = [rank["dp"]["peak_memory_gib"]
                              for rank in ranks]
    return out


# ------------------------------------------------------------- ep phase

#: The ep phase's two ranks on cuda:0 over gloo: Mixtral-8x7B at the
#: mixtral phase's depth served over an expert, a model and a data axis of
#: two (the dense engine, chunked; ``EP_SERVES``: step, mesh), then the
#: Llama-3-8B library steps (pipeline, sequence parallelism, ring
#: attention)
EP_SERVES = (("expert", {"expert": 2}), ("model", {"model": 2}),
             ("data", {"data": 2}))
EP_CHILD = [sys.executable, str(ROOT / "chip_smoke.py"), "--ep-child"]
EP_COMBINE_ITERS = 20
#: expected collectives of one decode step on each axis (8 MoE layers):
#: one expert all-reduce a layer; Llama's 2L + 2 on the model axis; one
#: exchange of expert choices a layer on the data axis
EP_STEP_COLLECTIVES = {
    "expert": {"data": 0, "model": 0, "expert": MIXTRAL_LAYERS},
    "model": {"data": 0, "model": 2 * MIXTRAL_LAYERS + 2, "expert": 0},
    "data": {"data": MIXTRAL_LAYERS, "model": 0, "expert": 0}}
#: the Llama-3-8B steps' depth (8 of 32 layers, as the tp phase's world
#: size 2), the seq-parallel prompt and the ring-attention shape
PP_LAYERS = 8
PP_MICRO = 2
SP_TOKENS = 4096
RING_HEADS = (32, 8, 128)
#: the parent's Mixtral reference for the ep phase (``ep_reference``),
#: filled by the mixtral phase before it frees its weights
EP_REF: dict = {}


def ep_prompts() -> list:
    """Four seeded prompts of 380-420 Mixtral token ids (numpy seed 16):
    the tp phase's lengths over Mixtral's vocab."""
    import numpy as np

    from swarmdb_tpu_torch.models.configs import get_config

    rng = np.random.default_rng(16)
    vocab = get_config("mixtral-8x7b").vocab_size
    return [rng.integers(3, vocab, n).tolist() for n in TP_PROMPT_LENS]


def ep_engine(cfg, dev, params=None, **axes):
    """The ep phase's dense engine (TP_BATCH slots, max_seq TP_SEQ, chunk
    8, chunked, no prefix cache): on one process over ``dev`` without
    ``axes``, else this rank's share of the single program over them."""
    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.parallel.serving import build_serving_engine

    kw = dict(max_batch=TP_BATCH, max_seq=TP_SEQ, decode_chunk=8)
    with engine_env(True, SWARMDB_PREFIX="0"):
        if not axes:
            return build_backend_engine(cfg, seed=0, device=dev,
                                        params=params, paged=None, **kw)
        return build_serving_engine(cfg, [dev], params=params, **axes, **kw)


def moe_plain_steps(params, cfg, prompts, tokens, pad_id, bucket,
                    waves=None, rows=None, **axes) -> list:
    """The plain bf16 forward over a serve's tokens, batched as the engine
    batches them (a MoE block's capacity counts the call's rows): the
    four prompts as one [4, bucket] prefill wave padded with ``pad_id``
    (the head at each row's last token), then one [4, 1] step a token
    over the slot cache, each fed the serve's own tokens; over a rank's
    shares with ``axes`` (``tp``, ``ep``: ``mixtral.forward``'s). With
    ``waves`` (``record_waves``: a paged engine's row-bucketed waves as
    they ran, each its padded ids, lengths and the slots of its real
    rows) those waves instead, in order, then steps of ``rows`` rows, a
    request's row its slot and an idle slot fed ``pad_id`` at position 0.
    Returns per request the f32 logits that pick each token, one row a
    step."""
    import numpy as np
    import torch

    from swarmdb_tpu_torch.models import mixtral

    dev = params["embed"].device
    B, n = len(prompts), min(len(t) for t in tokens)
    if waves is None:
        padded = np.full((B, bucket), pad_id, np.int32)
        for i, p in enumerate(prompts):
            padded[i, :len(p)] = p
        waves = [dict(padded=padded, lengths=np.array([len(p) for p in
                                                       prompts]),
                      slots=list(range(B)), requests=list(range(B)))]
        rows = B
    # a model axis's rank holds its share of the KV heads
    tp = axes.get("tp")
    kv = cfg.n_kv_heads // (tp.size if tp is not None else 1)
    lengths = [len(p) for p in prompts]
    seq = max([TP_SEQ, max(lengths) + n]
              + [w["padded"].shape[1] for w in waves])
    cache = mixtral.init_kv_cache(cfg, rows, seq, device=dev, kv_heads=kv)
    slot_of, first = [None] * B, [None] * B
    for w in waves:
        Bp, width = w["padded"].shape
        pos = torch.arange(width, dtype=torch.int32, device=dev).expand(Bp,
                                                                        -1)
        temp = mixtral.init_kv_cache(cfg, Bp, width, device=dev,
                                     kv_heads=kv)
        logits, temp = mixtral.forward(
            params, cfg, torch.tensor(w["padded"], device=dev), pos, temp,
            logits_at=torch.tensor(w["lengths"] - 1, device=dev), **axes)
        for r, (slot, i) in enumerate(zip(w["slots"], w["requests"])):
            for full, fresh in zip(cache, temp):
                full[:, slot, :width] = fresh[:, r]
            slot_of[i], first[i] = slot, logits[r].float()
    steps = [torch.stack(first)]
    for s in range(n - 1):
        tok = torch.full((rows, 1), pad_id, dtype=torch.int32, device=dev)
        pos = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
        for i, t in enumerate(tokens):
            tok[slot_of[i], 0], pos[slot_of[i], 0] = t[s], lengths[i] + s
        lg, _ = mixtral.forward(params, cfg, tok, pos, cache, **axes)
        steps.append(lg[slot_of, 0].float())
    z = torch.stack(steps)                          # [n, B, V]
    return [z[:, i] for i in range(B)]


@contextlib.contextmanager
def routing(forced=None):
    """``mixtral.moe_block`` wrapped while open: each call's router logits
    [N, E] (f32, from the block's own inputs and arithmetic) appended to
    the yielded list, call after call (call j is layer j % L of forward
    j // L). With ``forced`` (such a list, from another run over the same
    tokens) call j routes each token to the top-k experts of forced[j]
    instead of its own, gated by its own router logits there: a plain
    forward that follows a serve's expert choices."""
    import torch

    from swarmdb_tpu_torch.models import mixtral

    inner, topk, calls = mixtral.moe_block, torch.topk, []

    def wrapped(x, router_w, *args, top_k, **kw):
        logits = torch.matmul(x.reshape(-1, x.shape[-1]).float(),
                              router_w.float())
        j = len(calls)
        calls.append(logits)
        if forced is None:
            return inner(x, router_w, *args, top_k=top_k, **kw)
        if j >= len(forced) or forced[j].shape != logits.shape:
            fail(f"ep: MoE call {j} {tuple(logits.shape)} has no forced "
                 "routing of its shape")
        ids = topk(forced[j], top_k, dim=-1).indices

        def pinned(t, k, dim=-1, sorted=True):
            vals = t.gather(-1, ids)
            order = vals.argsort(-1, descending=True)
            return vals.gather(-1, order), ids.gather(-1, order)

        torch.topk = pinned
        try:
            return inner(x, router_w, *args, top_k=top_k, **kw)
        finally:
            torch.topk = topk

    mixtral.moe_block = wrapped
    try:
        yield calls
    finally:
        mixtral.moe_block = inner


def routing_stats(served, plain, top_k: int) -> dict:
    """A serve's router logits (``served``, ``routing``) against those of
    the plain forward that followed its choices (``plain``), call by call:
    ``router_err`` the largest |difference|; the tokens whose served
    experts are not the plain router's own top-k (``differing``), and
    ``max_gap``, how far the served choice lies below the plain router's
    k-th logit at worst (greedy on logits within ``router_err`` of the
    plain ones lies at most twice that below)."""
    import torch

    err, differing, gap, tokens = 0.0, 0, 0.0, 0
    for a, b in zip(served, plain):
        err = max(err, float((a - b).abs().max()))
        mine = torch.topk(a, top_k, dim=-1).indices.sort(-1).values
        top = torch.topk(b, top_k, dim=-1)
        own = top.indices.sort(-1).values
        differ = (mine != own).any(-1)
        tokens += a.shape[0]
        if bool(differ.any()):
            differing += int(differ.sum())
            below = top.values[:, -1] - b.gather(-1, mine).min(-1).values
            gap = max(gap, float(below[differ].max()))
    return dict(calls=len(plain), tokens=tokens, router_err=err,
                differing=differing, max_gap=gap)


def forced_errors(forced, got) -> list:
    """Per request of a serve, at every step that ``forced`` (per request
    the f32 logits that pick each token, ``moe_plain_steps``) covers: the
    |log-probability difference| of the served token from them and how
    far its logit lies below their top (greedy picks the top of logits
    that agree with these)."""
    import torch

    out = []
    for z, g, lps in zip(forced, got["tokens"], got["logprobs"]):
        lp = torch.log_softmax(z.float(), -1)
        top = z.max(-1).values
        n = min(len(g), z.shape[0])
        off = len(g) - len(lps)
        out.append(dict(
            logprob_err=[abs(float(lp[s, g[s]]) - lps[s - off])
                         for s in range(max(off, 0), n)],
            below_top=[float(top[s] - z[s, g[s]]) for s in range(n)]))
    return out


def ep_reference(cfg, params) -> dict:
    """The ep phase's reference, on the mixtral phase's weights: the
    single dense engine (``ep_engine``, its chunks run eagerly as the
    pods' do, so that its routing is seen) serving the four prompts
    queued together; the plain batched forward over its tokens
    (``moe_plain_steps``) and ``tol``, the serve's own largest
    |log-probability difference| from it; and ``router_tol``, the
    serve's router logits' largest distance from those of the plain
    forward that follows its expert choices (``routing_stats``)."""
    import gc

    import torch

    dev = params["embed"].device
    prompts = ep_prompts()
    eng, _ = ep_engine(cfg, dev, params)
    eng._runner.use_graphs = False
    eng.warmup()
    with routing() as served:
        ref = tp_serve(eng, prompts, queued=True)
    bucket = eng._bucket_for(max(len(p) for p in prompts))
    plain = moe_plain_steps(params, cfg, prompts, ref["tokens"], eng.pad_id,
                            bucket)
    with routing(forced=served) as followed:
        moe_plain_steps(params, cfg, prompts, ref["tokens"], eng.pad_id,
                        bucket)
    routes = routing_stats(served, followed, cfg.experts_per_token)
    del eng, served, followed
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ref=ref, plain=plain, tol=ref_logprob_tol(plain, ref),
                bucket=bucket, routes=routes,
                router_tol=routes["router_err"])


def batch_hold(plain, ref, got, bound) -> dict:
    """A pod's serve against the reference serve of the same batch, under
    the tp phase's rule (``tp_hold``), up to the batch's first parting:
    the plain forward over the whole weights on the reference's tokens
    (``plain``) is every row's context until then; after it, every row's
    context differs (a MoE block couples a batch's rows through
    capacity), and the serve's own forced steps hold it
    (``forced_errors``)."""
    toks = got["tokens"]
    parts = [next((k for k, (a, b) in enumerate(zip(r, g)) if a != b), None)
             for r, g in zip(ref["tokens"], toks)]
    first = min((k for k in parts if k is not None), default=None)
    holds = []
    for z, r, g, lps in zip(plain, ref["tokens"], toks, got["logprobs"]):
        # the plain steps stop at the batch's shortest reply
        end = min(len(g) if first is None else first + 1, z.shape[0])
        off = len(g) - len(lps)
        holds.append(tp_hold(z, r[:end], g[:end], lps[:max(0, end - off)],
                             bound))
    return dict(first_parting=first, holds=holds,
                held=all(h["held"] for h in holds),
                near_ties=all(h["step"] is None or h["near_tie"]
                              for h in holds))


def forced_hold(errs, bound) -> dict:
    """A serve's ``forced_errors`` held: at every step of every request,
    the served token's |log-probability difference| and how far it lies
    below the top, each within ``bound``."""
    holds = [dict(steps=len(e["below_top"]),
                  logprob_err=max(e["logprob_err"], default=float("inf")),
                  below_top=max(e["below_top"], default=float("inf")))
             for e in errs]
    return dict(holds=holds, held=all(
        h["logprob_err"] <= bound and h["below_top"] <= bound
        for h in holds))


def ep_axes(sm) -> dict:
    return {a: sm.mesh.axis(a) for a in ("data", "model", "expert")}


def ep_step_collectives(eng, sm) -> dict:
    """One decode step of the engine's chunk forward on dummy inputs
    (every rank in step): the collectives it issues, per axis."""
    import torch

    axes = ep_axes(sm)
    before = {a: ax.calls for a, ax in axes.items()}
    tok = torch.zeros((eng._rows, 1), dtype=torch.int32, device=eng.device)
    eng._chunked_fns[0](eng.params, tok, tok + 1, eng.cache, eng._chunk_kv,
                        0)
    torch.cuda.synchronize()
    return {a: ax.calls - before[a] for a, ax in axes.items()}


def ep_combine_ms(sm, step: str) -> float:
    """One decode step's MoE collective on its axis timed alone, median of
    EP_COMBINE_ITERS, every rank in step (host clock around a synchronised
    call: gloo's collectives are host calls): the expert axis's combine
    and the model axis's all-reduce of a [4, 1, dim] bf16 output, the
    data axis's exchange of the step's [5, 2] int32 expert choices."""
    import torch

    dev, dim = sm.mesh.device, sm.cfg.dim
    if step == "data":
        ax = sm.mesh.axis("data")
        x = torch.ones((TP_BATCH + 1, 2), dtype=torch.int32, device=dev)
    else:
        ax = sm.mesh.axis(step)
        x = torch.ones((TP_BATCH, 1, dim), dtype=torch.bfloat16, device=dev)
    times = []
    for i in range(EP_COMBINE_ITERS + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ax.all_reduce(x)
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def ep_f32_tol(fn, params) -> list:
    """For each output of ``fn(params)``, its largest |difference| from
    the same output of ``fn`` on an f32 copy of the weights: the bf16
    path's own rounding, the steps' ``tol``."""
    import torch

    f32 = {k: ({kk: vv.float() for kk, vv in v.items()}
               if isinstance(v, dict) else v.float())
           for k, v in params.items()}
    a, b = fn(params), fn(f32)
    del f32
    return [float((x.float() - y.float()).abs().max()) for x, y in zip(a, b)]


def pp_step(rank, dev, full) -> dict:
    """``forward_pipelined`` over a pipe axis of the two ranks: Llama-3-8B
    at PP_LAYERS layers, this stage's half drawn from seed 0
    (``param_plan_pp``), the four tp prompts padded to one [4, 420]
    batch in PP_MICRO microbatches; against one rank's ``forward`` over
    the whole model (``full``), held within twice the bf16 forward's own
    distance from an f32 one (logits and K/V apart)."""
    import torch

    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.parallel.mesh import make_mesh, plan_leaf, \
        shard_leaf

    cfg = full["cfg"]
    mesh = make_mesh(data=1, model=1, expert=1, pipe=2, device=dev)
    plan = llama.param_plan_pp(cfg)
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, seed=0, device=dev,
        keep=lambda key, t: shard_leaf(t, plan_leaf(plan, key), mesh))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = tp_prompts()
    T = max(len(p) for p in prompts)
    tokens = torch.zeros((len(prompts), T), dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p, dtype=torch.int32, device=dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev).expand(
        len(prompts), T)
    axis = mesh.axis("pipe")
    calls0 = axis.calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, (ks, vs) = llama.forward_pipelined(params, cfg, tokens, pos,
                                               axis, microbatches=PP_MICRO)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = axis.calls - calls0
    del params

    def ref(p):
        lg, (k, v) = llama.forward(p, cfg, tokens, pos,
                                   llama.init_kv_cache(
                                       cfg, len(prompts), T,
                                       dtype=p["embed"].dtype, device=dev))
        return lg, k, v

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ref(full["params"])
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    tols = ep_f32_tol(ref, full["params"])
    per = cfg.n_layers // 2
    rows = slice(rank * per, (rank + 1) * per)
    errs = [float((logits - want[0]).abs().max()),
            float((ks.float() - want[1][rows].float()).abs().max()),
            float((vs.float() - want[2][rows].float()).abs().max())]
    return dict(layers=cfg.n_layers, stage_layers=int(ks.shape[0]),
                batch=list(tokens.shape), micro=PP_MICRO, init_s=init_s,
                ms=wall * 1e3, forward_ms=ref_s * 1e3, collectives=calls,
                err={"logits": errs[0], "k": errs[1], "v": errs[2]},
                tol={"logits": tols[0], "k": tols[1], "v": tols[2]},
                held=all(e <= 2 * t for e, t in zip(errs, tols)))


def sp_step(rank, dev, full) -> dict:
    """``forward_seq_parallel`` over a data axis of the two ranks: one
    SP_TOKENS-token prompt of seeded ids, each rank's half of it, ring
    attention in every layer; against one rank's ``forward`` over the
    whole prompt (its rows of the logits and of the slot cache), held
    within twice the bf16 forward's own distance from an f32 one."""
    import numpy as np
    import torch

    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.parallel.mesh import make_mesh

    cfg = full["cfg"]
    mesh = make_mesh(data=2, model=1, expert=1, device=dev)
    rng = np.random.default_rng(17)
    ids = rng.integers(3, cfg.vocab_size, SP_TOKENS)
    tokens = torch.tensor(ids[None], dtype=torch.int32, device=dev)
    pos = torch.arange(SP_TOKENS, dtype=torch.int32, device=dev)[None]
    half = SP_TOKENS // 2
    mine = slice(rank * half, (rank + 1) * half)
    axis = mesh.axis("data")
    calls0 = axis.calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, (ks, vs) = llama.forward_seq_parallel(
        full["params"], cfg, tokens[:, mine], pos[:, mine], axis)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = axis.calls - calls0

    def ref(p):
        lg, (k, v) = llama.forward(p, cfg, tokens, pos, llama.init_kv_cache(
            cfg, 1, SP_TOKENS, dtype=p["embed"].dtype, device=dev))
        return lg[:, mine], k[:, :, mine], v[:, :, mine]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ref(full["params"])
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    tols = ep_f32_tol(ref, full["params"])
    errs = [float((a.float() - b.float()).abs().max())
            for a, b in zip((logits, ks, vs), want)]
    return dict(layers=cfg.n_layers, tokens=SP_TOKENS, block=half,
                ms=wall * 1e3, forward_ms=ref_s * 1e3, collectives=calls,
                err={"logits": errs[0], "k": errs[1], "v": errs[2]},
                tol={"logits": tols[0], "k": tols[1], "v": tols[2]},
                held=all(e <= 2 * t for e, t in zip(errs, tols)))


def ring_step(rank, dev) -> dict:
    """``ops.ring_attention`` alone over a data axis of the two ranks at
    Hq 32, Hkv 8, D 128 on one SP_TOKENS-token sequence of seeded bf16
    q / k / v (each rank its half), against the port's plain attention
    over the whole sequence on one rank (``ops.layers.gqa_attention``,
    the prefill attention ``forward_pipelined`` runs: other code than the
    ring's blocks and merge), held within twice that plain bf16 path's
    own distance from the same path in f32; ms of each (host clock
    around synchronised calls, median of 5: the ring's shifts are gloo
    host calls)."""
    import torch

    from swarmdb_tpu_torch.ops.layers import gqa_attention
    from swarmdb_tpu_torch.ops.ring_attention import ring_attention
    from swarmdb_tpu_torch.parallel.mesh import make_mesh

    hq, hkv, d = RING_HEADS
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    q, k, v = (torch.randn((1, SP_TOKENS, h, d), generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    pos = torch.arange(SP_TOKENS, dtype=torch.int32, device=dev)[None]
    half = SP_TOKENS // 2
    mine = slice(rank * half, (rank + 1) * half)
    axis = make_mesh(data=2, model=1, expert=1, device=dev).axis("data")

    def timed(fn):
        times, out = [], None
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(times)

    got, ms = timed(lambda: ring_attention(
        q[:, mine], k[:, mine], v[:, mine], pos[:, mine], pos[:, mine],
        axis))
    plain, plain_ms = timed(lambda: gqa_attention(q, k, v, pos))
    plain32 = gqa_attention(q.float(), k.float(), v.float(), pos)
    tol = float((plain.float() - plain32).abs().max())
    err = float((got.float() - plain[:, mine].float()).abs().max())
    return dict(shape=[1, SP_TOKENS, hq, hkv, d], ms=ms, plain_ms=plain_ms,
                err=err, tol=tol, held=err <= 2 * tol)


def ep_child(rank: int, store: str, result_path: str) -> int:
    """One rank of the ep phase's two-rank pod on cuda:0 over gloo: each
    of ``EP_SERVES`` (Mixtral-8x7B at MIXTRAL_LAYERS layers, this rank's
    share drawn from seed 0; rank 0 serving the ep prompts queued
    together, rank 1 replaying), then the Llama-3-8B steps (``pp_step``,
    ``sp_step``, ``ring_step``)."""
    import gc

    import torch
    import torch.distributed as dist

    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.ops import attention_cuda as ac
    from swarmdb_tpu_torch.ops import build
    from swarmdb_tpu_torch.parallel.distributed import init_distributed

    dev = torch.device(TP_DEVICE)
    torch.cuda.set_device(dev)
    build.build_all()
    init_distributed(f"file://{store}", 2, rank, backend="gloo", device=dev)
    out = {"rank": rank}
    prompts = ep_prompts()
    cfg = get_config("mixtral-8x7b", n_layers=MIXTRAL_LAYERS)
    with torch.no_grad():
        for step, axes in EP_SERVES:
            t_step = time.perf_counter()
            torch.cuda.reset_peak_memory_stats(dev)
            eng, sm = ep_engine(cfg, dev, **axes)
            torch.cuda.synchronize()
            res = {"init_s": time.perf_counter() - t_step,
                   "weights_gib": sum(_nbytes(t) for t in (
                       list(sm.params["layers"].values())
                       + [sm.params["embed"], sm.params["lm_head"]]))
                   / 2**30,
                   "graphs": eng.flight.meta["graphs"],
                   "moe_dispatch": eng.flight.meta["moe_dispatch"],
                   "backend": eng.flight.meta["backend"],
                   "w_gate_share": list(sm.params["layers"]["w_gate"].shape),
                   "slots": [eng._lo, eng._lo + eng._rows]}
            axs = ep_axes(sm)
            calls0 = {a: ax.calls for a, ax in axs.items()}
            ac.reset_launches()
            # a data rank sees its own rows of a call only: the data
            # serve's routing is not recorded
            with routing() as served:
                if rank == 0:
                    eng.enable_multihost()
                    res.update(tp_serve(eng, prompts, queued=True))
                else:
                    eng.worker_loop()
            torch.cuda.synchronize()
            res.update(
                launches={k: n for k, n in ac.LAUNCHES.items() if n},
                collectives={a: ax.calls - calls0[a]
                             for a, ax in axs.items()},
                chunks=eng.stats()["decode_chunks"],
                peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
            res["collectives_per_step"] = ep_step_collectives(eng, sm)
            res["combine_ms"] = ep_combine_ms(sm, step)
            # the plain forward over this rank's shares on the serve's
            # tokens (rank 0's, sent to rank 1), following the serve's
            # expert choices where a rank saw every row of each call
            t0 = time.perf_counter()
            sent = [res.get("tokens")]
            dist.broadcast_object_list(sent, src=0)
            follow = served if step != "data" else None
            with routing(forced=follow) as followed:
                z = moe_plain_steps(
                    sm.params, cfg, prompts, sent[0], eng.pad_id,
                    eng._bucket_for(max(len(p) for p in prompts)),
                    tp=sm.model_axis, ep=sm.mesh.axis("expert"))
            if follow is not None:
                # the ranks' choices: equal, as they route from the same
                # bits
                mine = [torch.topk(c, cfg.experts_per_token).indices.sort(
                    -1).values.cpu() for c in served]
                both = [None, None]
                dist.all_gather_object(both, mine)
                res["ranks_routed_alike"] = all(
                    torch.equal(a, b) for a, b in zip(*both))
                res["routing"] = routing_stats(served, followed,
                                               cfg.experts_per_token)
            if rank == 0:
                res["forced_errs"] = forced_errors(z, res)
            del z, served, followed
            res["forced_s"] = time.perf_counter() - t0
            res["t_s"] = time.perf_counter() - t_step
            out[step] = res
            del eng, sm, axs
            gc.collect()
            torch.cuda.empty_cache()
        # the Llama-3-8B steps, on the same ranks
        t_step = time.perf_counter()
        lcfg = get_config(TP_MODEL, n_layers=PP_LAYERS)
        full = {"cfg": lcfg,
                "params": llama.init_params(lcfg, seed=0, device=dev)}
        torch.cuda.reset_peak_memory_stats(dev)
        out["pipeline"] = pp_step(rank, dev, full)
        out["pipeline"]["t_s"] = time.perf_counter() - t_step
        t_step = time.perf_counter()
        out["seq_parallel"] = sp_step(rank, dev, full)
        out["seq_parallel"]["t_s"] = time.perf_counter() - t_step
        del full
        gc.collect()
        torch.cuda.empty_cache()
        t_step = time.perf_counter()
        out["ring"] = ring_step(rank, dev)
        out["ring"]["t_s"] = time.perf_counter() - t_step
        out["llama_peak_memory_gib"] = (torch.cuda.max_memory_allocated(dev)
                                        / 2**30)
    with open(result_path, "w", encoding="utf-8") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def run_ep(card) -> dict:
    """The ep phase (see the module docstring). Returns the launches of
    both ranks' serves."""
    import tempfile

    t_phase = time.perf_counter()
    if not EP_REF:
        fail("ep: the mixtral phase left no reference")
    ref, plain, tol = EP_REF["ref"], EP_REF["plain"], EP_REF["tol"]
    router_tol = EP_REF["router_tol"]
    bound = TP_WS2_TOL_FACTOR * tol
    work = tempfile.mkdtemp(prefix="swarm_ep_")
    store = os.path.join(work, "store")
    results = [os.path.join(work, f"rank{r}.json") for r in range(2)]
    env = dict(os.environ, PYTHONPATH=str(ROOT), SWARMDB_PG_TIMEOUT_S="300")
    for k in ("SWARMDB_PAGED", "SWARMDB_CHUNKED", "SWARMDB_PREFIX",
              "SWARMDB_MOE_DISPATCH"):
        env.pop(k, None)
    sys.stdout.flush()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        EP_CHILD + [str(r), store, results[r]], cwd=str(ROOT), env=env)
        for r in range(2)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t0
    if codes != [0, 0] or not all(os.path.exists(r) for r in results):
        fail(f"ep: the two ranks exited with {codes}")
    ranks = []
    for r in results:
        with open(r, encoding="utf-8") as f:
            ranks.append(json.load(f))
    checks, serves = {}, {}
    for step, _axes in EP_SERVES:
        got = ranks[0][step]
        hold = batch_hold(plain, ref, got, bound)
        forced = forced_hold(got["forced_errs"], bound)
        checks[f"ep {step} logprobs within {TP_WS2_TOL_FACTOR:g} x tol of "
               "the plain forward up to the batch's first parting"] = hold[
                   "held"]
        checks[f"ep {step} tokens == the single engine's, or part first at "
               "a near tie"] = hold["near_ties"]
        checks[f"ep {step} every step's logprob and greedy pick within "
               f"{TP_WS2_TOL_FACTOR:g} x tol of the plain forward over the "
               "pod's shares on its own tokens"] = forced["held"]
        if step != "data":
            routes = got["routing"]
            checks[f"ep {step} the ranks' expert choices equal"] = all(
                rank[step]["ranks_routed_alike"] for rank in ranks)
            checks[f"ep {step} router logits within {TP_WS2_TOL_FACTOR:g} "
                   "x the single engine's distance from the plain forward "
                   "that follows its choices"] = (
                routes["router_err"] <= TP_WS2_TOL_FACTOR * router_tol)
        checks[f"ep {step} reasons length/eos"] = all(
            r in ("length", "eos") for r in got["reasons"])
        for r, rank in enumerate(ranks):
            res = rank[step]
            checks[f"ep {step} rank {r} kernel 7 launched"] = res[
                "launches"].get("dense_decode_chunked", 0) > 0
            checks[f"ep {step} rank {r} eager chunks over gloo, scatter "
                   "dispatch"] = (res["graphs"] is False
                                  and res["backend"] == "gloo"
                                  and res["moe_dispatch"] == "scatter")
            checks[f"ep {step} rank {r} collectives per decode step"] = (
                res["collectives_per_step"] == EP_STEP_COLLECTIVES[step])
        serves[step] = dict(
            hold=hold, forced=forced, routing=got.get("routing"),
            ttft_s=got["ttft_s"], tokens_per_s=got["tokens_per_s"],
            ranks=[{k: v for k, v in rank[step].items()
                    if k not in ("tokens", "logprobs", "reasons", "ttft_s",
                                 "tokens_per_s", "wall_s", "forced_errs",
                                 "routing")}
                   for rank in ranks])
    for r, rank in enumerate(ranks):
        for step in ("pipeline", "seq_parallel", "ring"):
            checks[f"{step} rank {r} within 2 x tol"] = rank[step]["held"]
        checks[f"pipeline rank {r} holds {PP_LAYERS // 2} layers"] = (
            rank["pipeline"]["stage_layers"] == PP_LAYERS // 2)
    bad = [k for k, ok in checks.items() if not ok]
    emit("ep", card=card, model="mixtral-8x7b", layers=MIXTRAL_LAYERS,
         reduced=f"depth {MIXTRAL_LAYERS} of 32 layers; two ranks on one "
                 "card over gloo",
         batch=TP_BATCH, prompt_tokens=list(TP_PROMPT_LENS),
         new_tokens=TP_NEW, ref=dict(ttft_s=ref["ttft_s"],
                                     tokens_per_s=ref["tokens_per_s"]),
         logprob_tol=tol, bound=bound, router_tol=router_tol,
         ref_routing=EP_REF["routes"], serves=serves,
         llama={step: [rank[step] for rank in ranks]
                for step in ("pipeline", "seq_parallel", "ring")},
         llama_layers=PP_LAYERS,
         llama_peak_memory_gib=[rank["llama_peak_memory_gib"]
                                for rank in ranks],
         ranks_s=ranks_s, phase_s=time.perf_counter() - t_phase,
         checks=checks)
    if bad:
        fail(f"ep checks failed: {bad}")
    total = {}
    for rank in ranks:
        for step, _axes in EP_SERVES:
            for k, n in rank[step]["launches"].items():
                total[k] = total.get(k, 0) + n
    return total




def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    if not (ROOT / "swarmdb_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository (no "
              "swarmdb_tpu_torch/ next to it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from swarmdb_tpu_torch.ops import build

    if len(sys.argv) == 3 and sys.argv[1] == "--sanitize-child":
        return sanitize_child(sys.argv[2])
    if len(sys.argv) == 5 and sys.argv[1] == "--tp-child":
        return tp_child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if len(sys.argv) == 5 and sys.argv[1] == "--ep-child":
        return ep_child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        smi = []
    card = smi[0] if smi else "nvidia-smi gave no answer"
    print(card, flush=True)
    emit("device", name=name, nvidia_smi=card,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lint = start_lint()
    # the plain variant of every kernel, one nvcc each, all started
    # together; then the bounds-checked ones (the sanitize phase's) the
    # same way, left to build while the parity phase runs (after the
    # kernels phase, whose eager plain versions the compilers would slow)
    try:
        logs = build.build_all(checked=False)
    finally:
        lint()     # waited for on a failure too: it leaves no process
    plain_s = time.perf_counter() - t0

    with torch.no_grad():
        smem = run_smem(dev)
        rows = run_kernels(dev)
        checked_build = build.start_all(checked=True)
        try:
            run_parity(dev)
        finally:
            logs.update(checked_build())
        emit("build", plain_seconds=plain_s,
             seconds=time.perf_counter() - t0,
             ptxas={k: [f"{r['instance']}: {r['regs']} registers, spills "
                        f"{r['spill_stores']}/{r['spill_loads']}"
                        for r in build.parse_ptxas(v)]
                    for k, v in logs.items()})
        launches, params = run_serves(card)
        for k, n in run_api(card, params).items():
            launches[k] = launches.get(k, 0) + n
        for k, n in run_obs(card, params).items():
            launches[k] = launches.get(k, 0) + n
        for k, n in run_prof(card, params).items():
            launches[k] = launches.get(k, 0) + n
        run_decode_loop(card, "llama3-8b", params, LOOP_LLAMA)
        for k, n in run_rolling(card, params).items():
            launches[k] = launches.get(k, 0) + n
        for k, n in run_lanes(card, params).items():
            launches[k] = launches.get(k, 0) + n
        for k, n in run_ha(card, params).items():
            launches[k] = launches.get(k, 0) + n
        for k, n in run_tp(card, params).items():
            launches[k] = launches.get(k, 0) + n
        free_weights(params)   # Llama-3-8B's weights go before Mixtral's
        del params
        # the child draws its own Llama-3-8B: it runs while this process
        # holds no weights
        san_launches, checked_ms = run_sanitize(card)
        for k, n in san_launches.items():
            launches[k] = launches.get(k, 0) + n
        for k, n in run_ckpt(card).items():
            launches[k] = launches.get(k, 0) + n
        for k, n in run_mixtral(card).items():
            launches[k] = launches.get(k, 0) + n
        for k, n in run_ep(card).items():
            launches[k] = launches.get(k, 0) + n
    for k, n in launches.items():
        rows[k]["launches"] = n
    for k, ms in checked_ms.items():
        rows[k]["checked_ms"] = ms
    for k, row in smem.items():
        rows[k].update(row)
    idle = [k for k, row in rows.items() if not row["launches"]]
    if idle:
        fail(f"kernels never launched by the serves: {idle}")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
