"""The one traffic generator: a mix's parameters (a JSON file under
benchmark/workloads/) and a seed -> the requests of a run.

Every seed gets the same work. The sizes of a mix (sentence counts and
lengths, prompt lengths, arrival gaps) are a fixed multiset drawn from the
mix's parameters with the mix's own `shape_seed`; the run's seed only orders
them and fills them in: the letters of the text, the prompt's mel values,
which preset voice a request takes, the sampling draws. So two seeds differ
in content and order, not in how much there is to do. A mix with
`fixed_order` (and `voice_by_shape`) keeps the order (and the preset voice
of each shape) too, so that an open loop's schedule, whose order decides
which requests meet in a tick, is the same for every seed.

A request is a dict: `text` (words of capital letters, sentences ending in
"."), `mel` (a [1, 100, frames] float32 prompt), `voice` (a preset voice's
index, or None for a unique one), `stream` (bool), `greedy` (bool: the
request's rows pick the best code, top_p = 0), and for an open loop `due`
(seconds after the window opens).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

LETTERS = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))


def _stratified(rng: np.random.Generator, n: int, lo: int, hi: int) -> np.ndarray:
    """n integers spread evenly over [lo, hi] (inclusive), in random order."""
    vals = np.round(lo + (hi - lo) * (np.arange(n) + 0.5) / n).astype(int)
    return rng.permutation(vals)


def _counts(rng: np.random.Generator, n: int, values: List[int], weights: List[float]) -> np.ndarray:
    """n values in the stated proportions (largest remainders), in random order."""
    w = np.asarray(weights, float) / np.sum(weights)
    base = np.floor(w * n).astype(int)
    rest = np.argsort(-(w * n - base))[: n - base.sum()]
    base[rest] += 1
    return rng.permutation(np.repeat(values, base))


def sentence(rng: np.random.Generator, tokens: int) -> str:
    """A sentence of exactly `tokens` pieces: words of 1-9 letters, each
    starting with the word piece, and the final "."."""
    words, left = [], tokens - 1
    while left > 0:
        size = min(left - 1, int(rng.integers(1, 10))) if left > 2 else left - 1
        size = max(size, 1)
        if left - (size + 1) == 1:  # a lone piece cannot be a word
            size += 1
        words.append("".join(rng.choice(LETTERS, size)))
        left -= size + 1
    return " ".join(words) + "."


def prompt_mel(rng: np.random.Generator, frames: int) -> np.ndarray:
    """A log-mel-like prompt [1, 100, frames]: N(-5, 2), smoothed over time."""
    x = rng.normal(-5.0, 2.0, (100, frames + 2)).astype(np.float32)
    return ((x[:, :-2] + x[:, 1:-1] + x[:, 2:]) / 3.0)[None]


def shapes(mix: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The mix's n request shapes, from its shape_seed alone: sentence
    lengths, prompt frames, streaming and greedy flags, and the arrival gaps
    of an open loop (exponential quantiles at the mix's rate)."""
    rng = np.random.default_rng(int(mix.get("shape_seed", 0)))
    s = mix["sentences"]
    counts = _counts(rng, n, s["counts"], s["weights"])
    lengths = _stratified(rng, int(counts.sum()), *s["tokens"])
    pr = mix["prompts"]
    frames = _stratified(rng, n, *pr["frames"])
    stream = _counts(rng, n, [True, False], [mix.get("streaming_share", 0.0), 1.0 - mix.get("streaming_share", 0.0)])
    pooled = _counts(rng, n, [True, False], [pr.get("pool_share", 0.0), 1.0 - pr.get("pool_share", 0.0)])
    every = int(mix.get("greedy_every", 0))
    out, at = [], 0
    for i in range(n):
        c = int(counts[i])
        out.append({"lengths": [int(v) for v in lengths[at : at + c]], "frames": int(frames[i]),
                    "stream": bool(stream[i]), "pooled": bool(pooled[i]), "greedy": bool(every and i % every == 0)})
        at += c
    if "rate_per_s" in mix:
        q = (np.arange(n) + 0.5) / n
        gaps = rng.permutation(-np.log1p(-q) / float(mix["rate_per_s"]))
        for sh, gap in zip(out, gaps):
            sh["gap"] = float(gap)
    return out


def voice_pool(mix: Dict[str, Any], seed) -> List[np.ndarray]:
    """The mix's preset voices (mix["prompts"]["pool"] prompts, their
    lengths spread over the prompt range), made from the seed."""
    pr = mix["prompts"]
    if not pr.get("pool"):
        return []
    frames = _stratified(np.random.default_rng(int(mix.get("shape_seed", 0)) + 1), int(pr["pool"]), *pr["frames"])
    rng = np.random.default_rng([int(seed), 1])
    return [prompt_mel(rng, int(f)) for f in sorted(frames)]


def requests(mix: Dict[str, Any], seed, n: int, pool: List[np.ndarray] = (),
             subset: Optional[List[int]] = None) -> List[Dict[str, Any]]:
    """n requests: the mix's shapes in the seed's order (in the shapes' own
    order, the same for every seed, when mix["fixed_order"]), filled in from
    the seed (an int, or a list of ints for a stream of draws within a run).
    With `subset`, only those indices of the mix's n shapes, in the seed's
    order.
    A pooled shape takes a preset voice of `pool`: the voice of its shape's
    index when mix["prompts"]["voice_by_shape"], else one drawn at random."""
    rng = np.random.default_rng(seed)
    if mix.get("fixed_order") and subset is None:
        order = np.arange(n)
    else:
        order = rng.permutation(n) if subset is None else rng.permutation(np.asarray(subset, int))
    sh = shapes(mix, n)
    by_shape = bool(mix["prompts"].get("voice_by_shape"))
    out, due = [], 0.0
    for i in order:
        s = sh[i]
        text = " ".join(sentence(rng, k) for k in s["lengths"])
        if s["pooled"] and pool:
            voice = int(i) % len(pool) if by_shape else int(rng.integers(len(pool)))
            mel = pool[voice]
        else:
            voice, mel = None, prompt_mel(rng, s["frames"])
        req = {"text": text, "mel": mel, "voice": voice, "stream": s["stream"], "greedy": s["greedy"],
               "lengths": s["lengths"]}
        if "gap" in s:
            due += s["gap"]
            req["due"] = due
        out.append(req)
    return out


def open_loop(mix: Dict[str, Any], seed: int, seconds: float) -> List[Dict[str, Any]]:
    """An open loop's requests for a window of `seconds`: the mix's rate
    times the window of them are due inside it (the last gap ends at the
    window's end), followed by `tail_s` seconds more at the same rate, which
    keep the load on while the window's requests finish and are not counted."""
    rate = float(mix["rate_per_s"])
    n_in = max(int(round(rate * seconds)), 1)
    n_tail = int(round(rate * float(mix.get("tail_s", 0.0))))
    pool = voice_pool(mix, seed)
    reqs = requests(mix, seed, n_in, pool)
    scale = seconds / reqs[-1]["due"]
    for r in reqs:
        r["due"] *= scale
        r["counted"] = True
    tail = requests(dict(mix, shape_seed=int(mix.get("shape_seed", 0)) + 7), [int(seed), 2], n_tail, pool) if n_tail else []
    for r in tail:
        r["due"] += seconds
        r["counted"] = False
    return reqs + tail
