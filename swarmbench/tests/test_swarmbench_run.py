"""A whole run at a tiny size on the CPU, the look for a card skipped:
sound, it comes out correct; with the served path broken underneath (a
token altered where it is produced, half of the messages never served),
``correct`` comes out false. The fp8 control, put in the program's
place, fails the gap limit; on the card, at the cell's own widths, by at
least three times the program's reading."""

import json
import os
import time

import pytest
import torch

from swarmbench import run, spec, weights
from swarmbench.reference import Reference, served_gaps

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = {"name": "tiny", "vocab_size": 512, "hidden_size": 64,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 128,
        "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "max_position_embeddings": 512, "sliding_window": None,
        "tie_word_embeddings": False,
        "engine": {"max_batch": 4, "max_seq": 256, "page_size": 16,
                   "decode_chunk": 4},
        "runtime": {"broker": "python", "num_partitions": 4}}
MIX = {"agents": 4, "assistants": 2, "kind": "chat", "turns": [2, 3],
       "first_tokens": {"lo": 20, "hi": 40},
       "later_tokens": {"lo": 8, "hi": 16, "dist": "loguniform"},
       "reply_tokens": {"lo": 6, "hi": 10}, "max_prompt_tokens": 200,
       "start_spread_s": 0.1, "warmup_agents": 2, "warmup_reply_tokens": 2}
#: the tiny set's gap limit, set between its two readings on the CPU
#: (seeds 2**31 + 101 .. 112, 2 s windows, ``calibrate_seed``): the bf16
#: program's widest gap 0.0305, the fp8 control's smallest 0.117
LIMITS = {"sample_requests": 4, "sample_tokens": 24,
          "checks": {"unanswered": 0, "misdelivered": 0,
                     "reply_mismatch": 0, "stamps_out_of_order": 0,
                     "max_logit_gap": 0.07}}
SEED = 2 ** 31 + 101


def tiny_cell():
    conf = dict(TINY)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    return spec.Cell(name="tiny", chips=1, config_name="tiny", config=conf,
                     traffic="tiny", mix=MIX, limits=LIMITS,
                     end_to_end=bench["end_to_end"],
                     per_layer=bench["per_layer"])


def go(tmp_path, cell, trace=False, seconds=2.0):
    return run.run(cell, SEED, seconds, trace, torch.device("cpu"),
                   str(tmp_path), time.time())


def test_a_sound_run_is_correct(tmp_path):
    res = go(tmp_path, tiny_cell())
    assert res["correct"], res["checks"]
    assert res["attempted"] > 4 and res["failed"] == 0
    names = [m["name"] for m in tiny_cell().end_to_end]
    assert sorted(res["metrics"]) == sorted(names)
    for m in res["metrics"].values():
        assert m["value"] > 0
    assert list(res)[-2:] == ["checks", "sample"]


def test_a_traced_run_reads_the_layers(tmp_path, monkeypatch):
    monkeypatch.setattr("swarmbench.drive.LEAD_S", 1.0)
    monkeypatch.setattr("swarmbench.drive.TRACE_S", 1.0)
    res = go(tmp_path, tiny_cell(), trace=True, seconds=5.0)
    assert res["correct"]
    pool = res["kv_pool"]
    assert 0 < pool["peak_pages_held"] <= pool["pages"]
    # the counters and stamps are read on the CPU too; the device metrics
    # need the card's trace and are left out here
    for name in ("ttft_p95_s", "tpot_p95_ms", "reply_p95_s",
                 "pickup_p50_ms", "deliver_p50_ms", "queue_wait_ms",
                 "prefix_hit_share", "decode_chunk_ms", "host_sync_share"):
        assert name in res["metrics"], name
    assert res["metrics"]["prefix_hit_share"]["value"] > 0
    for name in ("mfu", "decode_attn_roofline", "device_idle_share"):
        assert name not in res["metrics"]


def test_an_altered_token_is_caught(tmp_path, monkeypatch):
    from swarmdb_tpu_torch.backend.engine import Engine

    emit = Engine._emit_token

    def altered(self, slot_id, token, now, logprob):
        slot = self.slots[slot_id]
        if slot.request is not None and len(slot.generated) == 3:
            token = 3 + (token + 1 - 3) % 500
        return emit(self, slot_id, token, now, logprob)

    monkeypatch.setattr(Engine, "_emit_token", altered)
    res = go(tmp_path, tiny_cell())
    assert not res["correct"]
    assert res["checks"]["max_logit_gap"]["value"] > \
        LIMITS["checks"]["max_logit_gap"]


def test_half_the_messages_left_out_is_caught(tmp_path, monkeypatch):
    from swarmdb_tpu_torch.backend.service import ServingService

    serve = ServingService._serve
    seen = []

    def half(self, msg, on_token, on_done):
        seen.append(msg.id)
        if len(seen) % 2 == 0:
            return "dropped", False
        return serve(self, msg, on_token, on_done)

    monkeypatch.setattr(ServingService, "_serve", half)
    monkeypatch.setattr("swarmbench.drive.DRAIN_S", 2.0)
    res = go(tmp_path, tiny_cell(), seconds=1.5)
    assert not res["correct"]
    assert res["checks"]["unanswered"]["value"] > 0


def test_the_fp8_control_fails_the_tiny_limit():
    d = weights.Dims.of(TINY)
    w = weights.draw(d, SEED, "cpu")
    ref = Reference(d, w)
    ctl = Reference(d, w, precision="fp8")
    worst = 0.0
    for k in range(4):
        g = torch.Generator().manual_seed(k)
        prompt = torch.randint(3, 259, (40,), generator=g).tolist()
        served = []
        for _ in range(24):
            seq = prompt + served
            served.append(int(ref.logits(seq, len(seq) - 1)[-1].argmax()))
        gap, cgap = served_gaps(ref, prompt, served, ctl)
        assert gap == 0.0
        worst = max(worst, cgap)
    assert worst > LIMITS["checks"]["max_logit_gap"]


def test_no_thread_polls_for_the_service(tmp_path, monkeypatch):
    """The agents' loop sleeps until an agent is due or a reply has been
    sent: over a window of 64 waits for replies it wakes a few times per
    reply, not every few milliseconds."""
    import queue
    import threading

    from swarmbench import drive

    waits = []
    get = queue.Queue.get

    def counted(self, block=True, timeout=None):
        if timeout is not None and \
                threading.current_thread() is threading.main_thread():
            waits.append(timeout)
        return get(self, block, timeout)

    monkeypatch.setattr(queue.Queue, "get", counted)
    res = go(tmp_path, tiny_cell(), seconds=3.0)
    assert res["correct"]
    short = [w for w in waits if w < drive.RETRY_S * 2]
    assert len(waits) < 8 * res["attempted"] + 20, len(waits)
    assert len(short) <= res["attempted"], len(short)


@pytest.mark.cuda
def test_control_separates_on_the_card(tmp_path):
    """Mistral-7B's widths at 4 of its layers, 16 agents for 6 s: the fp8
    control's widest gap is at least three times the program's, and the
    control, judged against the cell's committed limits, is not
    correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    from swarmbench.calibrate import calibrate_seed

    cell = spec.cell(os.path.join(ROOT, "BENCHMARK.json"),
                     "mistral7b.agent_sessions")
    cell.config = dict(cell.config, num_hidden_layers=4)
    cell.mix = dict(cell.mix, agents=16)
    res = calibrate_seed(cell, SEED, 6.0, True, torch.device("cuda", 0),
                         str(tmp_path))
    assert res["unanswered"] == 0
    assert res["correct"]
    assert res["control_gap"] >= 3 * res["max_logit_gap"]
    assert res["control_correct"] is False
