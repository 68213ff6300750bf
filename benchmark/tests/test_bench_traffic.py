"""The traffic generator: deterministic by seed, inside its clips, and the
same sizes for every seed in another order."""

from __future__ import annotations

import json
from collections import Counter

import numpy as np
import pytest

from benchmark import traffic
from conftest import BENCH


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def _same(a, b):
    return (len(a) == len(b) and all(
        x.max_new == y.max_new and x.due == y.due
        and np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b)))


def test_same_seed_same_requests():
    for name, rate in (("decode-long", None), ("chat-open", 2.5)):
        mix = _mix(name)
        a = traffic.requests(mix, 2**31 + 12345, 32000, 200, rate=rate)
        b = traffic.requests(mix, 2**31 + 12345, 32000, 200, rate=rate)
        c = traffic.requests(mix, 2**31 + 12346, 32000, 200, rate=rate)
        assert _same(a, b)
        assert not _same(a, c)


def test_lengths_keep_their_clips():
    for name, rate in (("decode-long", None), ("chat-open", 2.5)):
        mix = _mix(name)
        for seed in (0, 1, 2**31 + 99, 10**12):
            reqs = traffic.requests(mix, seed, 32000, 300, rate=rate)
            p = [len(r.prompt) for r in reqs]
            o = [r.max_new for r in reqs]
            assert min(p) >= mix["prompt"]["min"]
            assert max(p) <= mix["prompt"]["max"]
            # a closed loop's first requests are cut short (staggered)
            first = mix.get("clients", 0)
            assert min(o[first:]) >= mix["output"]["min"]
            assert max(o) <= mix["output"]["max"]
            assert min(o) >= traffic.STAGGER_MIN
            assert all(0 <= t < 32000 for r in reqs for t in r.prompt)


def test_every_stratum_holds_the_same_sizes():
    mix = _mix("chat-open")
    k = mix["strata"]
    a = traffic.requests(mix, 5, 32000, 4 * k, rate=3.0)
    b = traffic.requests(mix, 6, 32000, 4 * k, rate=3.0)
    for s in range(4):
        blk_a, blk_b = a[s * k:(s + 1) * k], b[s * k:(s + 1) * k]
        assert Counter(len(r.prompt) for r in blk_a) == Counter(
            len(r.prompt) for r in blk_b)
        assert Counter(r.max_new for r in blk_a) == Counter(
            r.max_new for r in blk_b)
    # the same arrival gaps in each stratum: the same due time at its end
    assert abs(a[k - 1].due - b[k - 1].due) < 1e-9
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]


def test_open_loop_arrivals_follow_the_rate():
    mix = _mix("chat-open")
    reqs = traffic.requests(mix, 3, 32000, 32 * 20, rate=2.0)
    due = np.array([r.due for r in reqs])
    assert np.all(np.diff(due) >= 0)
    assert len(due) / due[-1] == pytest.approx(2.0)


def test_lognormal_quantiles_have_the_median():
    dist = {"dist": "lognormal", "median": 512, "sigma": 0.8, "min": 64,
            "max": 1536}
    assert traffic.quantile(dist, np.array([0.5]))[0] == 512
    assert traffic.quantile(dist, np.array([0.0001, 0.9999])).tolist() == [
        64, 1536]


@pytest.mark.parametrize("name,rate", [("decode-long", None),
                                       ("chat-open", 2.5)])
def test_the_first_requests_do_not_depend_on_how_many_follow(name, rate):
    mix = _mix(name)
    a = traffic.requests(mix, 2**31 + 7, 32000, 40, rate=rate)
    b = traffic.requests(mix, 2**31 + 7, 32000, 400, rate=rate)
    assert _same(a, b[:40])
    assert [r.uid for r in b] == list(range(400))
