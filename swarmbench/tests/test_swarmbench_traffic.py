"""The traffic generator: exact repeats per seed, sizes inside each mix's
ranges, and every seed offering the same sizes in another order."""

import json
import os

import pytest

from swarmbench.traffic import Traffic

MIXES = os.path.join(os.path.dirname(__file__), "..", "mixes")


def mix(name):
    with open(os.path.join(MIXES, name + ".json")) as f:
        return json.load(f)


def sessions(m, seed, n, stream=0):
    t = Traffic(m, seed, stream)
    return [t.next_session() for _ in range(n)]


@pytest.mark.parametrize("name", ["agent_sessions", "tool_sessions",
                                  "oneshot_decode"])
def test_repeats_per_seed(name):
    m = mix(name)
    a = sessions(m, 2 ** 31 + 7, 2 * m["agents"])
    b = sessions(m, 2 ** 31 + 7, 2 * m["agents"])
    assert [vars(s) for s in a] == [vars(s) for s in b]
    c = sessions(m, 2 ** 31 + 8, 2 * m["agents"])
    assert [s.texts for s in a] != [s.texts for s in c]
    w = sessions(m, 2 ** 31 + 7, m["agents"], stream=1)
    assert [s.texts for s in w] != [s.texts for s in a[:m["agents"]]]


@pytest.mark.parametrize("name", ["agent_sessions", "tool_sessions",
                                  "oneshot_decode"])
def test_lengths_in_ranges(name):
    m = mix(name)
    for s in sessions(m, 123456789012, 3 * m["agents"]):
        lo, hi = m["turns"]
        assert lo <= len(s.lengths) <= hi
        assert len(s.replies) == len(s.lengths) == len(s.texts)
        f = m["first_tokens"]
        assert f["lo"] <= s.lengths[0] <= f["hi"]
        for n in s.lengths[1:]:
            assert m["later_tokens"]["lo"] <= n <= m["later_tokens"]["hi"]
        for n in s.replies:
            assert m["reply_tokens"]["lo"] <= n <= m["reply_tokens"]["hi"]
        for n, t in zip(s.lengths, s.texts):
            assert len(t.encode("utf-8")) == n
        assert s.kind == m["kind"]
        assert s.receiver.startswith("assistant-")
        assert int(s.receiver.split("-")[1]) < m["assistants"]


@pytest.mark.parametrize("name", ["agent_sessions", "tool_sessions",
                                  "oneshot_decode"])
def test_every_seed_offers_the_same_sizes(name):
    m = mix(name)
    n = m["agents"]

    def sizes(seed):
        ss = sessions(m, seed, n)
        return (sorted(len(s.lengths) for s in ss),
                sorted(s.lengths[0] for s in ss),
                sorted(s.replies[0] for s in ss))

    assert sizes(1) == sizes(2 ** 33 + 1) == sizes(987654321)


def test_senders_fresh_per_session():
    m = mix("oneshot_decode")
    ss = sessions(m, 5, 4 * m["agents"])
    heads = {s.sender[:15] for s in ss}
    assert len(heads) == len(ss)


@pytest.mark.parametrize("name", ["agent_sessions", "oneshot_decode"])
@pytest.mark.parametrize("part", ["first_tokens", "later_tokens",
                                  "reply_tokens"])
def test_lognormal_lengths_keep_their_median_and_tail(name, part):
    """A block's lengths have the mix's median and a right tail (mean
    above median), cut at ``lo`` and ``hi``."""
    import numpy as np

    from swarmbench.traffic import _values

    spec = mix(name)[part]
    assert spec["dist"] == "lognormal"
    n = mix(name)["agents"]
    v = _values(spec, (np.arange(n) + 0.5) / n)
    assert abs(np.median(v) - spec["median"]) <= 0.03 * spec["median"]
    assert v.mean() > np.median(v)
    assert v.min() >= spec["lo"] and v.max() <= spec["hi"]
