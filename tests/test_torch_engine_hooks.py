"""The engine's progress and profiling hooks (set_gr_progress_callback,
torch_empty_cache, start_profiling / stop_profiling) on the port, against the
JAX engine on the same tiny float32 weights: the callback must receive the
same (value, description) sequence from both engines on infer, infer_fast and
infer_batch."""

import os

import numpy as np
import pytest

from tests.test_torch_infer_fast import engines  # noqa: F401  (engines is the fixture)

GREEDY = dict(do_sample=False, num_beams=1, max_mel_tokens=8, repetition_penalty=1.0)
TWO_SENTENCES = "HELLO WORLD. GOOD DAY TO YOU."


def _prompt(seed, frames=40):
    return np.random.default_rng(seed).standard_normal((1, 100, frames)).astype(np.float32) * 0.1


def _progress_of(engine, call):
    """The (value, description) pairs the engine's callback receives during call(engine)."""
    seen = []
    engine.set_gr_progress_callback(lambda value, desc: seen.append((float(value), desc)))
    try:
        call(engine)
    finally:
        engine.set_gr_progress_callback(None)
    return seen


# method -> (the call, the least number of progress reports it makes)
CALLS = {
    # one sentence: start, one "latent" and one "speech" step, save
    "infer": (lambda e: e.infer(_prompt(0), "HELLO WORLD.", None, **GREEDY), 4),
    # several sentence rows, one bucket each on the CPU: a "speech" step per bucket and five fixed steps
    "infer_fast": (lambda e: e.infer_fast(_prompt(1), TWO_SENTENCES, None, max_text_tokens_per_sentence=8, **GREEDY), 7),
    # two requests whose sentence rows share one decode bucket: text processing, one "speech" step, the vocoder
    "infer_batch": (lambda e: e.infer_batch([(_prompt(2), "HI THERE."), (_prompt(3), TWO_SENTENCES)],
                                            max_text_tokens_per_sentence=8, **GREEDY), 3),
}


@pytest.mark.parametrize("method", sorted(CALLS))
def test_progress_sequence_matches_jax(engines, method):
    je, te, _ = engines
    call, n_calls = CALLS[method]
    gold = _progress_of(je, call)
    mine = _progress_of(te, call)
    assert len(gold) >= n_calls, gold
    assert [d for _, d in mine] == [d for _, d in gold]
    np.testing.assert_allclose([v for v, _ in mine], [v for v, _ in gold], rtol=0, atol=1e-12)
    values = [v for v, _ in mine]
    assert values == sorted(values) and values[0] <= 0.1 and 0.7 <= values[-1] <= 0.9


def test_infer_progress_values(engines):
    """The reference's schedule for one sentence, spelled out."""
    _, te, _ = engines
    seen = _progress_of(te, CALLS["infer"][0])
    assert [d for _, d in seen] == ["start inference...", "gpt inference latent... 1/1", "gpt inference speech... 1/1",
                                    "save audio..."]
    np.testing.assert_allclose([v for v, _ in seen], [0.0, 0.2, 0.6, 0.9], atol=1e-12)


def test_no_callback_is_a_noop(engines):
    _, te, _ = engines
    assert te.gr_progress is None
    te._set_gr_progress(0.5, "nobody listens")
    sr, wav = te.infer(_prompt(0), "HELLO WORLD.", None, **GREEDY)
    assert sr == 24000 and wav.shape[0] > 0
    seen = []
    te.set_gr_progress_callback(lambda v, d: seen.append(d))
    te.set_gr_progress_callback(None)
    te.infer(_prompt(0), "HELLO WORLD.", None, **GREEDY)
    assert seen == []


def test_torch_empty_cache_returns_on_the_cpu(engines):
    _, te, _ = engines
    assert te.device.type == "cpu" and te.torch_empty_cache() is None


def test_profiling_writes_a_trace(engines, tmp_path):
    _, te, _ = engines
    assert te.stop_profiling() is None  # nothing running, nothing traced yet
    logdir = str(tmp_path / "trace")
    te.start_profiling(logdir)
    with pytest.raises(RuntimeError, match="already running"):
        te.start_profiling(logdir)
    te.infer(_prompt(0), "HELLO WORLD.", None, **GREEDY)
    assert te.stop_profiling() == logdir
    traces = [f for f in os.listdir(logdir) if f.endswith(".json")]
    assert len(traces) == 1 and os.path.getsize(os.path.join(logdir, traces[0])) > 1000
    # a second trace lands beside the first; stopping twice is harmless
    te.start_profiling(logdir)
    te.infer(_prompt(0), "HI.", None, **GREEDY)
    assert te.stop_profiling() == logdir and te.stop_profiling() == logdir
    assert len([f for f in os.listdir(logdir) if f.endswith(".json")]) == 2
