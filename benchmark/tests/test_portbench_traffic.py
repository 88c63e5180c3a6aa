"""The traffic generator: the same seed gives the same requests, every seed
the same sizes, and the parameters are as the mix file states them."""

import json
import os

import numpy as np
import pytest

from portbench import traffic
from reference import text as RT

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mix(name):
    with open(os.path.join(BENCH, "workloads", name + ".json")) as f:
        return json.load(f)


def test_same_seed_same_requests():
    m = mix("slots-mixed")
    a, b = traffic.open_loop(m, 2**31 + 77, 20.0), traffic.open_loop(m, 2**31 + 77, 20.0)
    assert [r["text"] for r in a] == [r["text"] for r in b]
    assert [r["due"] for r in a] == [r["due"] for r in b]
    assert all(np.array_equal(x["mel"], y["mel"]) for x, y in zip(a, b))
    c = traffic.open_loop(m, 2**31 + 78, 20.0)
    assert [r["text"] for r in a] != [r["text"] for r in c]


def test_every_seed_gets_the_same_sizes():
    m = mix("slots-mixed")
    sizes = lambda reqs: sorted((tuple(r["lengths"]), r["mel"].shape[-1] if r["voice"] is None else -1, r["stream"],
                                 r["greedy"]) for r in reqs if r["counted"])
    gaps = lambda reqs: sorted(np.round(np.diff([0.0] + [r["due"] for r in reqs if r["counted"]]), 9))
    a, b = traffic.open_loop(m, 5, 30.0), traffic.open_loop(m, 6, 30.0)
    assert sizes(a) == sizes(b)
    assert gaps(a) == gaps(b)


def test_fixed_order_gives_every_seed_one_schedule():
    # the open loop's order and voices are the shapes', whatever the seed; the content is the seed's
    m = mix("slots-mixed")
    assert m["fixed_order"] and m["prompts"]["voice_by_shape"]
    plan = lambda reqs: [(tuple(r["lengths"]), r["mel"].shape[-1], r["voice"], r["stream"], r["greedy"], r["due"])
                         for r in reqs]
    a, b = traffic.open_loop(m, 2**31 + 5, 30.0), traffic.open_loop(m, 2**32 + 6, 30.0)
    assert plan(a) == plan(b)
    assert [r["text"] for r in a] != [r["text"] for r in b]
    shuffled = traffic.open_loop(dict(m, fixed_order=False), 2**31 + 5, 30.0)
    assert plan(shuffled) != plan(a)


@pytest.mark.parametrize("name", ["slots-mixed", "batch-offline", "single-beam"])
def test_parameters_as_stated(name):
    m = mix(name)
    reqs = traffic.requests(m, 123, 64, traffic.voice_pool(m, 123))
    lo, hi = m["sentences"]["tokens"]
    counts = [len(r["lengths"]) for r in reqs]
    assert set(counts) <= set(m["sentences"]["counts"])
    for r in reqs:
        sentences = [s if s.endswith(".") else s + "." for s in r["text"].split(". ")]
        assert [len(RT.tokenize(s)) for s in sentences] == r["lengths"]
        assert all(lo <= n <= hi for n in r["lengths"])
        f_lo, f_hi = m["prompts"]["frames"]
        assert f_lo <= r["mel"].shape[-1] <= f_hi
    share = np.bincount(counts, minlength=4)[1:] / len(counts)
    w = np.asarray(m["sentences"]["weights"]) / np.sum(m["sentences"]["weights"])
    assert np.allclose(share[: len(w)], w, atol=1.0 / 64 + 1e-9)
    if "streaming_share" in m:
        assert abs(np.mean([r["stream"] for r in reqs]) - m["streaming_share"]) <= 1.0 / 64


def test_open_loop_rate_and_tail():
    m = mix("slots-mixed")
    reqs = traffic.open_loop(m, 9, 40.0)
    counted = [r for r in reqs if r["counted"]]
    assert len(counted) == round(m["rate_per_s"] * 40.0)
    assert counted[-1]["due"] == pytest.approx(40.0)
    assert all(a["due"] <= b["due"] for a, b in zip(reqs, reqs[1:]))
    tail = [r for r in reqs if not r["counted"]]
    assert len(tail) == round(m["rate_per_s"] * m["tail_s"]) and all(r["due"] > 40.0 for r in tail)


def test_batch_calls_are_the_mix_compositions():
    # a call's shapes are one composition's, whatever the seed; the
    # compositions differ from one another, and every seed runs them all
    m = mix("batch-offline")
    pool = traffic.voice_pool(m, 4)
    n, c = m["call"]["requests"], m["call"]["compositions"]
    key = lambda reqs: sorted((tuple(r["lengths"]), r["voice"]) for r in reqs)
    call = lambda seed, j: traffic.requests(m, seed, n * c, pool, subset=list(range(j * n, (j + 1) * n)))
    assert key(call([4, 6, 1], 0)) == key(call([7, 6, 2], 0))
    keys = [key(call(4, j)) for j in range(c)]
    assert len({repr(k) for k in keys}) == c
    assert sorted(x for k in keys for x in k) == key(traffic.requests(m, 9, n * c, pool))
    rows = {sum(len(ls) for ls, _v in k) for k in keys}
    assert len(rows) > 1  # calls of different sizes
