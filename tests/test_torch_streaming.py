"""The port's IndexTTS.infer_stream against the JAX engine's on the same tiny
float32 weights, prompt and text: the same number of chunks, the same chunk
sizes, samples within 8 int16 units (tests/test_torch_infer_fast.py's
tolerance against the JAX engine); greedy with teacher-forced latents, with
fast_latents, with the int8 KV cache, and sampled on one recorded uniform
stream (JAX's sample_token is monkeypatched in that test only). Then the
edge cases of tests/test_streaming.py on the port alone."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import indextts_tpu.models.gpt_decode as jdec
import indextts_tpu.ops.sampling as jsamp
import indextts_tpu_torch.models.gpt_decode as tdec
from indextts_tpu_torch.ops.sampling import inverse_cdf_token
from tests.test_torch_infer_fast import WAV_TOL, engines  # noqa: F401  (engines is the fixture)

SPC = 32  # samples per code of the tiny config: 4 x prod(upsample_rates)
CHUNKING = dict(first_chunk_codes=4, chunk_codes=6, overlap_codes=2)


@pytest.fixture(scope="module")
def prompt_mel():
    return np.random.default_rng(0).standard_normal((1, 100, 60)).astype(np.float32) * 0.1


def _compare(chunks_t, chunks_j):
    assert [c.size for c in chunks_t] == [c.size for c in chunks_j]
    assert all(c.dtype == np.float32 and c.ndim == 1 for c in chunks_t)
    for a, b in zip(chunks_t, chunks_j):
        assert np.abs(a - b).max() * 32767 <= WAV_TOL


@pytest.mark.parametrize("mode", ["teacher_forced", "fast_latents", "quant_kv"])
def test_greedy_stream_matches_jax_engine(engines, prompt_mel, mode):
    je, te, _ = engines
    kw = dict(text="HELLO WORLD HOW ARE YOU.", do_sample=False, max_mel_tokens=20, repetition_penalty=1.0, **CHUNKING)
    for e in (je, te):
        e.fast_latents, e.quant_kv = mode == "fast_latents", mode == "quant_kv"
    try:
        chunks_j = list(je.infer_stream(prompt_mel, **kw))
        chunks_t = list(te.infer_stream(prompt_mel, **kw))
        stats = dict(te.last_stats)
    finally:
        for e in (je, te):
            e.fast_latents = e.quant_kv = False
    _compare(chunks_t, chunks_j)
    assert len(chunks_t) >= 2 and chunks_t[0].size == 5 * SPC  # the prefill's code + 4 steps
    assert sum(c.size for c in chunks_t) % SPC == 0
    assert np.abs(np.concatenate(chunks_j)).max() * 32767 > 300  # an audible wav
    # the stream's account of itself
    assert stats["vocoder_calls"] == len(chunks_t) == len(stats["chunk_s"])
    assert stats["chunk_codes"] == [c.size // SPC for c in chunks_t]
    assert 0 < stats["ttfa_s"] <= stats["total_s"] and stats["gpt_steps"] == sum(stats["chunk_codes"]) - 1 + \
        (0 if sum(stats["chunk_codes"]) == 20 else 1)
    assert stats["tf_latent_rows"] == (0 if mode == "fast_latents" else len(chunks_t))


def test_sampled_stream_on_a_shared_uniform_stream(engines, prompt_mel, monkeypatch):
    """Both engines sample by inverse CDF from the uniforms the JAX engine's
    own key gives at each step (fold_in(sub, step), sub the next split of its
    RNG)."""
    je, te, _ = engines
    _, sub = jax.random.split(je._rng)
    uniforms = [np.asarray(jax.random.uniform(jax.random.fold_in(sub, s), (1,))) for s in range(18)]

    def jax_inverse_cdf(key, logits):
        u = jax.random.uniform(key, (logits.shape[0],))
        cdf = jnp.cumsum(jax.nn.softmax(logits.astype(jnp.float32), axis=-1), axis=-1)
        return jnp.minimum(jnp.sum(cdf <= u[:, None], axis=-1), logits.shape[-1] - 1)

    monkeypatch.setattr(jdec, "sample_token", jax_inverse_cdf)
    monkeypatch.setattr(jsamp, "sample_token", jax_inverse_cdf)  # the stream's step function imports it from there
    stream = iter(uniforms)
    monkeypatch.setattr(tdec, "sample_token", lambda logits, g: inverse_cdf_token(logits, torch.tensor(next(stream))))
    # max_mel_tokens and top_k of no other test: the JAX engine traces these functions anew, under the patch
    kw = dict(text="HELLO WORLD.", do_sample=True, top_k=25, max_mel_tokens=18, **CHUNKING)
    chunks_j = list(je.infer_stream(prompt_mel, **kw))
    chunks_t = list(te.infer_stream(prompt_mel, **kw))
    _compare(chunks_t, chunks_j)
    assert len(chunks_t) >= 2


def test_beams_are_forced_to_one(engines, prompt_mel, monkeypatch):
    """num_beams is overridden: the stream decodes with prefill_decode_state /
    decode_steps and never reaches a beam loop."""
    from indextts_tpu_torch import engine as engine_mod

    _, te, _ = engines
    monkeypatch.setattr(engine_mod, "generate_speech_beam", lambda *a, **k: pytest.fail("beam search in a stream"))
    gens = []
    prefill = engine_mod.prefill_decode_state
    monkeypatch.setattr(engine_mod, "prefill_decode_state", lambda *a, **k: gens.append(a[2]) or prefill(*a, **k))
    kw = dict(text="HELLO WORLD.", do_sample=False, max_mel_tokens=8, repetition_penalty=1.0, **CHUNKING)
    a = np.concatenate(list(te.infer_stream(prompt_mel, num_beams=3, **kw)))
    b = np.concatenate(list(te.infer_stream(prompt_mel, **kw)))
    assert [g.num_beams for g in gens] == [1, 1]
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown generation kwargs"):
        list(te.infer_stream(prompt_mel, "HELLO.", top_kk=3))
    with pytest.raises(ValueError, match="empty"):
        list(te.infer_stream(prompt_mel, ""))


# ---------------------------------------------------------------------------
# the edge cases of tests/test_streaming.py
# ---------------------------------------------------------------------------

GREEDY = dict(do_sample=False, repetition_penalty=1.0)


def test_full_capacity_sentence_bucket_clamp(engines, prompt_mel):
    """A sentence as long as the text positional table streams: the bucket of
    8 must not overrun it."""
    _, te, _ = engines
    cap = te.cfg.gpt.max_text_tokens
    text = " ".join(["HELLO"] * (2 * cap)) + "."
    chunks = list(te.infer_stream(prompt_mel, text, max_mel_tokens=6, first_chunk_codes=4, chunk_codes=6,
                                  max_text_tokens_per_sentence=cap, **GREEDY))
    assert te.last_stats["gpt_calls"] >= 2 and all(np.isfinite(c).all() for c in chunks)


def test_first_chunk_wider_than_max_mel_tokens(engines, prompt_mel):
    """first_chunk_codes > max_mel_tokens clamps to the codes buffer: the
    stream is as long as the one-piece synthesis."""
    _, te, _ = engines
    kw = dict(max_mel_tokens=6, **GREEDY)
    for fast in (False, True):
        te.fast_latents = fast
        try:
            chunks = list(te.infer_stream(prompt_mel, "HELLO WORLD.", first_chunk_codes=24, chunk_codes=6, **kw))
            sr, full = te.infer(prompt_mel, "HELLO WORLD.", None, num_beams=1, **kw)
        finally:
            te.fast_latents = False
        assert int(sum(c.size for c in chunks)) == full.shape[0] > 0
        assert len(chunks) == 1


def test_tiny_max_mel_tokens_one(engines, prompt_mel):
    """max_mel_tokens=1: the prefill's code is the synthesis; no extra step."""
    _, te, _ = engines
    chunks = list(te.infer_stream(prompt_mel, "HELLO.", max_mel_tokens=1, **GREEDY))
    assert sum(c.size for c in chunks) in (0, SPC) and te.last_stats["gpt_steps"] == 0


def test_nonpositive_chunk_codes_terminates(engines, prompt_mel):
    """chunk_codes <= 0 clamps to 1 instead of spinning without progress; a
    negative overlap clamps to 0."""
    _, te, _ = engines
    chunks = list(te.infer_stream(prompt_mel, "HELLO.", max_mel_tokens=6, first_chunk_codes=2, chunk_codes=0,
                                  overlap_codes=-3, **GREEDY))
    assert sum(c.size for c in chunks) % SPC == 0
    assert te.last_stats["chunk_codes"][1:] == [1] * (len(chunks) - 1)


def test_streamed_sample_count_and_first_chunk_match_infer(engines, prompt_mel):
    """The stream runs the one-piece path's sampling state machine: as many
    samples as infer(), and the first chunk's interior equals infer()'s wav
    (the same latents; near the window's right edge the receptive field sees
    zeros instead of the next frames, so the first 2 of its 8 codes are
    compared)."""
    _, te, _ = engines
    kw = dict(max_mel_tokens=12, **GREEDY)
    chunks = list(te.infer_stream(prompt_mel, "HELLO WORLD.", first_chunk_codes=7, chunk_codes=3, overlap_codes=2, **kw))
    streamed = np.concatenate(chunks)
    sr, full = te.infer(prompt_mel, "HELLO WORLD.", None, num_beams=1, **kw)
    assert streamed.size == full.shape[0]
    n = 2 * SPC
    np.testing.assert_allclose(np.clip(streamed[:n] * 32767, -32767, 32767), full[:n, 0].astype(np.float32), atol=3.0)
