"""The port's cross-request batching (IndexTTS.infer_batch, _conds_for_many)
against per-request infer on the port and against the JAX engine's
infer_batch on the same tiny float32 weights: the cases of
tests/test_infer_batch.py. Codes must be equal and the int16 wav within 8
units of the JAX engine's (2 units of the port's own per-request infer, the
rounding across batch shapes)."""

import os

import numpy as np
import pytest

from tests.test_torch_infer_fast import PROMPT, WAV_TOL, engines  # noqa: F401  (engines is the fixture)

GREEDY = dict(do_sample=False, num_beams=1, max_mel_tokens=8, repetition_penalty=1.0)


def _prompt(seed, frames=40):
    return np.random.default_rng(seed).standard_normal((1, 100, frames)).astype(np.float32) * 0.1


def _close(a, b, tol=2.0):
    assert a.shape == b.shape and a.dtype == b.dtype == np.int16
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= tol


def _recording(engine, fn):
    """fn() with engine._gpt_generate's codes recorded."""
    codes = []
    generate = engine._gpt_generate

    def recording(*a, **k):
        out = generate(*a, **k)
        codes.append(np.asarray(out[0]))
        return out

    engine._gpt_generate = recording
    try:
        return fn(), codes
    finally:
        del engine._gpt_generate


@pytest.fixture()
def serving(engines):
    """The port's engine in serving mode (fast_latents + quant_kv) for one test."""
    _, te, _ = engines
    te.fast_latents = te.quant_kv = True
    yield te
    te.fast_latents = te.quant_kv = False


def test_matches_per_request_infer_and_jax(engines):
    """Two requests, different prompts and texts: batched == solo, and the
    decode batch's codes equal the JAX engine's."""
    je, te, _ = engines
    items = [(_prompt(0), "HI THERE."), (_prompt(1), "HELLO WORLD AGAIN.")]
    solo = [te.infer(mel, text, None, **GREEDY) for mel, text in items]
    batched, codes_t = _recording(te, lambda: te.infer_batch(items, **GREEDY))
    st = te.last_stats
    gold, codes_j = _recording(je, lambda: je.infer_batch(items, **GREEDY))
    assert len(batched) == 2 and st["decode_batches"] == [2]
    assert len(codes_t) == len(codes_j) == 1
    np.testing.assert_array_equal(codes_t[0], codes_j[0])
    for (sr_s, wav_s), (sr_b, wav_b), (sr_j, wav_j) in zip(solo, batched, gold):
        assert sr_s == sr_b == sr_j == 24000
        _close(wav_s, wav_b)
        _close(wav_b, wav_j, WAV_TOL)
        assert wav_b.shape[0] > 3 * te._samples_per_code() and np.abs(wav_j.astype(np.int32)).max() > 300
    assert st["gpt_calls"] == 1 and st["tf_latent_rows"] == 2 and st["vocoder_calls"] >= 1
    assert st["audio_s"] == pytest.approx(sum(w.shape[0] for _, w in batched) / 24000)
    assert all(st[k] >= 0 for k in ("cond_s", "gpt_gen_s", "gpt_forward_s", "bigvgan_s")) and st["total_s"] > 0


MULTI = [("ONE. TWO THREE FOUR. FIVE.", 3), ("ALPHA BETA. GAMMA.", 2)]  # (text, sentences at 16 tokens a sentence)
SPLIT = dict(max_text_tokens_per_sentence=16)


def test_multi_sentence_requests_order(engines):
    """Requests of several sentences keep their own sentence order (rows are
    shuffled across buckets inside), against the request's own infer_fast
    (which pairs sentences into vocoder chunks the same way; infer vocodes
    sentence by sentence) and the JAX engine."""
    je, te, _ = engines
    items = [(_prompt(2), MULTI[0][0]), (_prompt(3, frames=52), MULTI[1][0])]
    out = te.infer_batch(items, **SPLIT, **GREEDY)
    assert te.last_stats["decode_batches"] == [5]
    gold = je.infer_batch(items, **SPLIT, **GREEDY)
    for (mel, text), (_, wav), (_, wav_j) in zip(items, out, gold):
        _close(te.infer_fast(mel, text, None, **SPLIT, **GREEDY)[1], wav)
        _close(wav, wav_j, WAV_TOL)
        assert wav.shape[0] > 8 * te._samples_per_code()  # more than one sentence's budget


def test_small_buckets_split_the_rows(engines):
    """sentences_bucket_max_size below the row count: several decode batches,
    the same result."""
    _, te, _ = engines
    items = [(_prompt(2), MULTI[0][0]), (_prompt(3, frames=52), MULTI[1][0])]
    whole = te.infer_batch(items, **SPLIT, **GREEDY)
    split = te.infer_batch(items, sentences_bucket_max_size=2, **SPLIT, **GREEDY)
    assert te.last_stats["decode_batches"] == [2, 2, 1] and te.last_stats["gpt_calls"] == 3
    for (_, a), (_, b) in zip(whole, split):
        _close(a, b)


def test_output_paths(engines, tmp_path):
    _, te, _ = engines
    mel = _prompt(4)
    paths = [str(tmp_path / "a.wav"), str(tmp_path / "b.wav")]
    assert te.infer_batch([(mel, "HI."), (mel, "YO.")], output_paths=paths, **GREEDY) == paths
    assert all(os.path.getsize(p) > 44 for p in paths)
    with pytest.raises(ValueError, match="output_paths"):
        te.infer_batch([(mel, "HI."), (mel, "YO.")], output_paths=paths[:1], **GREEDY)


def test_empty_text_raises_with_request_index(engines):
    _, te, _ = engines
    mel = _prompt(5)
    with pytest.raises(ValueError, match="Request 1"):
        te.infer_batch([(mel, "HI."), (mel, "")], **GREEDY)


def test_sampling_mode_runs(engines):
    """A sampled batch, with per-request temperatures and top_p: finite
    results of whole codes (no parity claim: the batch shares one generator)."""
    _, te, _ = engines
    mel = _prompt(6)
    out = te.infer_batch([(mel, "HI."), (mel, "HELLO.")], do_sample=True, top_k=5, num_beams=1, max_mel_tokens=8,
                         per_request_kwargs=[{"temperature": 0.7, "top_p": 0.9}, None])
    assert len(out) == 2 and all(sr == 24000 and w.shape[0] % te._samples_per_code() == 0 for sr, w in out)


def test_greedy_rep_penalty_per_request(engines):
    """Requests with DIFFERENT repetition penalties share one decode batch;
    each equals its solo run with that scalar."""
    _, te, _ = engines
    mels, text = [_prompt(10), _prompt(11)], "HELLO WORLD."
    base = dict(do_sample=False, num_beams=1, max_mel_tokens=8)
    solo = [te.infer(mels[0], text, None, repetition_penalty=1.0, **base),
            te.infer(mels[1], text, None, repetition_penalty=8.0, **base)]
    out = te.infer_batch([(mels[0], text), (mels[1], text)], repetition_penalty=5.0,  # overridden per request
                         per_request_kwargs=[{"repetition_penalty": 1.0}, {"repetition_penalty": 8.0}], **base)
    assert te.last_stats["decode_batches"] == [2]
    for (_, w_s), (_, w_b) in zip(solo, out):
        _close(w_s, w_b)


def test_beam_length_penalty_per_request(engines):
    """One beam batch, a length penalty per request: each equals its solo
    beam search, codes included, and the JAX engine's batch."""
    je, te, _ = engines
    mel = _prompt(12)
    base = dict(do_sample=False, num_beams=2, max_mel_tokens=8, repetition_penalty=1.0)
    solo_codes = []
    solo = []
    for lp in (0.0, 2.0):
        res, codes = _recording(te, lambda: te.infer(mel, "HI THERE.", None, length_penalty=lp, **base))
        solo.append(res)
        solo_codes.append(codes[0])
    per = [{"length_penalty": 0.0}, {"length_penalty": 2.0}]
    out, codes_t = _recording(te, lambda: te.infer_batch([(mel, "HI THERE.")] * 2, per_request_kwargs=per, **base))
    gold, codes_j = _recording(je, lambda: je.infer_batch([(mel, "HI THERE.")] * 2, per_request_kwargs=per, **base))
    np.testing.assert_array_equal(codes_t[0], np.concatenate(solo_codes))
    np.testing.assert_array_equal(codes_t[0], codes_j[0])
    for (_, w_s), (_, w_b), (_, w_j) in zip(solo, out, gold):
        _close(w_s, w_b)
        _close(w_b, w_j, WAV_TOL)


def test_static_override_rejected(engines):
    """The JAX engine's check and its text."""
    je, te, _ = engines
    mel = _prompt(13)
    msgs = []
    for e in (je, te):
        with pytest.raises(ValueError, match="static") as err:
            e.infer_batch([(mel, "HI."), (mel, "YO.")], per_request_kwargs=[{"num_beams": 1}, {}], **GREEDY)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="per_request_kwargs must match"):
        te.infer_batch([(mel, "HI."), (mel, "YO.")], per_request_kwargs=[{}], **GREEDY)


def test_serving_mode_matches_solo(serving):
    """fast_latents + quant_kv: the captured latents are sliced per batch
    row; batched == solo per request."""
    te = serving
    items = [(_prompt(20), "HI THERE."), (_prompt(21), "HELLO WORLD AGAIN.")]
    solo = [te.infer(mel, text, None, **GREEDY) for mel, text in items]
    for (_, w_s), (_, w_b) in zip(solo, te.infer_batch(items, **GREEDY)):
        _close(w_s, w_b)


@pytest.mark.parametrize("num_beams", [1, 2])
def test_fast_latents_skip_the_teacher_forced_pass(serving, monkeypatch, num_beams):
    """Codes that silence removal leaves alone: every row's latents come from
    the decode's capture (for beams, the winner's); neither teacher-forced
    helper runs."""
    te = serving
    calls = []
    monkeypatch.setattr(te, "_gpt_latent", lambda *a, **k: calls.append("solo"))
    monkeypatch.setattr(te, "_gpt_latent_many", lambda *a, **k: calls.append("many"))
    mel = _prompt(22)
    out = te.infer_batch([(mel, "HI."), (mel, "HELLO WORLD.")], **dict(GREEDY, num_beams=num_beams))
    assert len(out) == 2 and all(w.shape[0] > 0 and np.isfinite(w).all() for _, w in out)
    assert calls == [] and te.last_stats["tf_latent_rows"] == 0


def _drop_condvals(engine):
    for k in [k for k in engine._value_cache if k[0] == "condval"]:
        del engine._value_cache[k]


def test_conds_for_many_matches_solo_and_jax(engines):
    """Batched conditioning == solo _conds_for per prompt == the JAX
    engine's. Frames 40 and 46 share bucket 100 (a batched pair, padded to
    2); 140 goes to bucket 200, alone, by the solo path."""
    je, te, _ = engines
    mels = [_prompt(60, frames=40), _prompt(61, frames=46), _prompt(62, frames=140)]
    solo = [te._conds_for(m).numpy().copy() for m in mels]
    _drop_condvals(te)
    many = te._conds_for_many(mels)
    gold = je._conds_for_many(mels)
    for s, m, g in zip(solo, many, gold):
        assert m.shape == s.shape
        np.testing.assert_allclose(m.numpy(), s, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(m.numpy(), np.asarray(g), rtol=1e-4, atol=1e-4)


def test_conds_for_many_dedup_and_cache(engines, monkeypatch):
    """Duplicate prompts compute once; cache hits come back as they are (no
    model call) and misses land in the cache _conds_for shares."""
    from indextts_tpu_torch import engine as engine_mod

    _, te, _ = engines
    _drop_condvals(te)
    a, b, c = _prompt(63), _prompt(64, frames=46), _prompt(65, frames=33)
    pre = te._conds_for(a)
    batches = []
    cond = engine_mod.get_conditioning
    monkeypatch.setattr(engine_mod, "get_conditioning", lambda m, cfg, mel, lens: batches.append(mel.shape[0])
                        or cond(m, cfg, mel, lens))
    out = te._conds_for_many([a, b, a, c, b])
    assert out[0] is pre and out[2] is pre and out[1] is out[4]
    assert batches == [2]  # b and c, one call; a was cached
    assert te._conds_for_many([b])[0] is out[1] and te._conds_for(c) is out[3] and batches == [2]


def test_cli_batch_file(engines, tmp_path, monkeypatch):
    """--batch-file: 'text' lines take -v, 'voice<TAB>text' lines their own
    voice; one infer_batch call writes NNN.wav files into -o."""
    from indextts_tpu_torch import engine as engine_mod
    from indextts_tpu_torch.cli import main
    from indextts_tpu_torch.engine import IndexTTS

    _, _, cfg_path = engines
    seen = []

    class Recording(IndexTTS):
        def infer_batch(self, items, **kw):
            seen.append(list(items))
            return super().infer_batch(items, **kw)

    monkeypatch.setattr(engine_mod, "IndexTTS", Recording)
    jobs = tmp_path / "jobs.tsv"
    jobs.write_text(f"HELLO WORLD.\r\n\n{PROMPT}\tGOOD DAY.\n", encoding="utf-8")
    outdir = tmp_path / "out"
    main(["--batch-file", str(jobs), "-v", PROMPT, "-c", cfg_path, "--model_dir", str(tmp_path), "-o", str(outdir),
          "-d", "cpu"])
    assert seen == [[(PROMPT, "HELLO WORLD."), (PROMPT, "GOOD DAY.")]]
    assert sorted(os.listdir(outdir)) == ["000.wav", "001.wav"]
    assert all(os.path.getsize(outdir / f) >= 44 for f in os.listdir(outdir))  # a header, and what the random weights gave
    with pytest.raises(SystemExit):  # the outputs exist and --force is not given
        main(["--batch-file", str(jobs), "-v", PROMPT, "-c", cfg_path, "--model_dir", str(tmp_path), "-o",
              str(outdir), "-d", "cpu"])
