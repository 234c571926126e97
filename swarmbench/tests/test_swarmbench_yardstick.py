"""The yardstick: percentiles over every request, rates over all the work
and the whole window, and work counts worked out by hand."""

import statistics
from types import SimpleNamespace

import pytest

from swarmbench import yardstick as ys
from swarmbench.view import RunView, agent_view
from swarmbench.weights import Dims, active_params

TINY = Dims(vocab=10, hidden=8, layers=2, heads=2, kv_heads=1, ffn=16,
            eps=1e-5, theta=1e4)
MOE = Dims(vocab=10, hidden=8, layers=2, heads=2, kv_heads=1, ffn=16,
           eps=1e-5, theta=1e4, experts=4, top_k=2)


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert ys.percentile(v, 95) == 95
    assert ys.percentile(v, 50) == 50
    assert ys.percentile([3.0], 95) == 3.0
    assert ys.percentile([1, 2], 95) == 2


def test_spread_uses_statistics_quantiles():
    v = [10.0, 11.0, 12.0, 13.0, 20.0, 9.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert ys.spread(v) == pytest.approx((q3 - q1) / statistics.median(v))


def test_active_params_by_hand():
    # attention: 8 x (2 + 2) x 4 + 2 x 4 x 8 = 128 + 64; SwiGLU 3 x 8 x 16
    assert active_params(TINY) == {"body": 2 * (192 + 384), "head": 80}
    # MoE: router 8 x 4 and two of the experts
    assert active_params(MOE) == {"body": 2 * (192 + 32 + 2 * 384),
                                  "head": 80}


def test_work_by_hand():
    w = ys.Work(prompt=5, reused=2, served=3)
    # prefill: 3 new tokens of the body, keys 3 + 4 + 5, one head
    attn = 4 * 2 * 4 * 2 * (3 + 4 + 5)
    assert w.prefill_flops(TINY) == 2 * 1152 * 3 + attn + 2 * 80
    # decode token 1: a step at position 5 over 6 keys
    assert w.decode_flops(TINY, 1) == 2 * (1152 + 80) + 4 * 2 * 4 * 6 * 2
    f, b = w.decode_attn(TINY, 2)
    assert f == 4 * 2 * 4 * 7 * 2
    assert b == 7 * 2 * 2 * 1 * 4 * 2           # keys, layers, K+V, Hkv, D, bf16
    f, b = w.prefill_attn(TINY)
    assert f == 4 * 2 * 4 * 2 * 12
    assert b == 2 * (2 * 3 * 2 * 4 + 2 * 5 * 1 * 4) * 2


def test_least_seconds_names_its_bound():
    t, bound = ys.least_seconds(ys.PEAK_BF16_FLOPS, 1.0)
    assert (t, bound) == (1.0, "flops")
    t, bound = ys.least_seconds(1.0, ys.PEAK_HBM_BYTES * 2)
    assert (t, bound) == (2.0, "bytes")


def req(i, t_send, first, done, n, recv, in_window=True):
    """A request whose n tokens were heard evenly from first to done."""
    times = ys.token_times(first, done, n) if first is not None else None
    return SimpleNamespace(
        mid=str(i), turn=0, prompt=[1] * 10, prev=None, t_send=t_send,
        t_recv=recv, in_window=in_window, served=[7] * n, reason="length",
        generated=n, tok_times=times)


def test_end_to_end_over_every_request_and_the_whole_window():
    reqs = [req(i, 0.0, 1.0, 2.0, 11, 2.5) for i in range(19)]
    # one slow request: it must reach the p95 of 20, a median would hide it
    reqs.append(req(19, 0.0, 9.0, 9.5, 11, 10.0))
    # unanswered: counted at the drain's end
    reqs.append(req(20, 0.0, None, None, 0, None))
    window = SimpleNamespace(requests=reqs, t0=0.0, t1=4.0,
                             counters={}, trace=None)
    view = RunView(TINY, window)
    e = agent_view(view)
    # 21 requests: the 20th smallest is the slow one's 9 s; the
    # unanswered one counts at the drain's end (10 s)
    assert e["ttft_p95_s"] == 9.0
    assert e["reply_p95_s"] == 10.0
    assert e["tpot_p95_ms"] == pytest.approx(100.0)
    # tokens inside [0, 4): 19 x 11, and none of the slow one's
    assert e["output_tokens_per_s"] == pytest.approx(19 * 11 / 4.0)


def test_token_times_split_at_the_window():
    times = ys.token_times(1.0, 3.0, 5)
    assert times == [1.0, 1.5, 2.0, 2.5, 3.0]
    assert ys.count_in(times, 0.0, 2.0) == 2
