"""The port's SlotSession / IndexTTS.infer_slots (continuous batching) and
IndexTTS.warmup: the cases of tests/test_slot_session.py on the port, with
the JAX engine's infer_slots beside the greedy ones (same tiny float32
weights; codes equal, int16 wav within 8 units). Greedy slot output ==
per-request infer, for requests submitted mid-decode, for more requests than
slots, in serving mode (fast_latents + quant_kv); streaming requests' chunks
concatenate to the result; cancels; a seeded scheduler fuzz."""

import os

import numpy as np
import pytest

from indextts_tpu_torch.serving import SLOT_DYNAMIC_PARAMS, SlotSession
from tests.test_torch_infer_fast import WAV_TOL, engines  # noqa: F401  (engines is the fixture)

GREEDY = dict(do_sample=False, num_beams=1, max_mel_tokens=8, repetition_penalty=1.0)


def _prompt(seed, frames=40):
    return np.random.default_rng(seed).standard_normal((1, 100, frames)).astype(np.float32) * 0.1


def _close(a, b, tol=2.0):
    assert a.shape == b.shape and a.dtype == b.dtype == np.int16
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= tol


@pytest.fixture()
def serving(engines):
    """The port's engine in serving mode (fast_latents + quant_kv) for one test."""
    _, te, _ = engines
    te.fast_latents = te.quant_kv = True
    yield te
    te.fast_latents = te.quant_kv = False


# ---------------------------------------------------------------------------
# infer_slots
# ---------------------------------------------------------------------------


def test_matches_per_request_infer_and_jax(engines):
    je, te, _ = engines
    items = [(_prompt(0), "HI THERE."), (_prompt(1), "HELLO WORLD AGAIN.")]
    solo = [te.infer(mel, text, None, **GREEDY) for mel, text in items]
    out = te.infer_slots(items, n_slots=2, **GREEDY)
    gold = je.infer_slots(items, n_slots=2, **GREEDY)
    for (sr_s, wav_s), (sr_o, wav_o), (_, wav_j) in zip(solo, out, gold):
        assert sr_s == sr_o == 24000
        _close(wav_s, wav_o)
        _close(wav_o, wav_j, WAV_TOL)
        assert wav_o.shape[0] > 3 * te._samples_per_code() and np.abs(wav_j.astype(np.int32)).max() > 300


def test_slot_codes_equal_jax_session(engines):
    """The sessions' code buffers after a drain, row for row."""
    je, te, _ = engines
    items = [(_prompt(7), "HI THERE."), (_prompt(8), "HELLO WORLD AGAIN."), (_prompt(9), "GOOD DAY.")]
    codes = []
    for e in (te, je):
        sess = e.slot_session(n_slots=3, chunk_steps=3, **GREEDY)
        for mel, text in items:
            sess.submit(mel, text)
        assert len(sess.drain()) == 3
        codes.append(np.asarray(sess.state.codes))
    np.testing.assert_array_equal(codes[0], codes[1])
    assert (codes[0][:, :4] != te.stop_mel_token).all()


def test_multi_sentence_request_order(engines):
    """A request of three sentence rows through two slots: the rows come back
    in sentence order, paired into vocoder chunks as infer_fast pairs them."""
    je, te, _ = engines
    mel, text = _prompt(2), "ONE. TWO THREE FOUR. FIVE."
    kw = dict(max_text_tokens_per_sentence=16, **GREEDY)
    out = te.infer_slots([(mel, text)], n_slots=2, **kw)
    _close(te.infer_fast(mel, text, None, **kw)[1], out[0][1])
    _close(out[0][1], je.infer_slots([(mel, text)], n_slots=2, **kw)[0][1], WAV_TOL)
    assert out[0][1].shape[0] > 16 * te._samples_per_code()  # three rows of up to 8 codes


def test_output_paths(engines, tmp_path):
    _, te, _ = engines
    mel = _prompt(3)
    paths = [str(tmp_path / "a.wav"), str(tmp_path / "b.wav")]
    assert te.infer_slots([(mel, "HI."), (mel, "YO.")], output_paths=paths, n_slots=2, **GREEDY) == paths
    assert all(os.path.getsize(p) > 44 for p in paths)


def test_rejections(engines, monkeypatch):
    """Beams, per-request kwargs of the wrong length or outside the dynamic
    knobs, empty text, and a conditioning type of no fixed latent count."""
    _, te, _ = engines
    mel = _prompt(5)
    with pytest.raises(ValueError, match="num_beams=1"):
        te.slot_session(num_beams=3)
    with pytest.raises(ValueError, match="per_request_kwargs"):
        te.infer_slots([(mel, "HI."), (mel, "YO.")], n_slots=2, per_request_kwargs=[{}], **GREEDY)
    sess = te.slot_session(n_slots=1, **GREEDY)
    assert isinstance(sess, SlotSession) and "length_penalty" not in SLOT_DYNAMIC_PARAMS
    with pytest.raises(ValueError, match="length_penalty"):
        sess.submit(mel, "HI.", length_penalty=1.0)
    with pytest.raises(ValueError, match="empty"):
        sess.submit(mel, "")
    assert not sess.busy
    monkeypatch.setattr(te.cfg.gpt, "condition_type", "conformer_encoder")
    with pytest.raises(ValueError, match="conformer_encoder"):
        te.slot_session()


def test_cache_len_and_window_sizing(engines):
    """cache_len = round_up(latents + text bucket of the split length + 3 +
    max_new, 64); pos_off follows fast_latents; the streaming window is
    chunk_steps + overlap + 1 codes, at most max_new."""
    je, te, _ = engines
    kw = dict(n_slots=2, chunk_steps=3, max_text_tokens_per_sentence=20, **GREEDY)
    st, sj = te.slot_session(**kw), je.slot_session(**kw)
    g = te.cfg.gpt
    assert st.cache_len == sj.cache_len == -(-(g.condition_num_latent + 24 + 3 + 8) // 64) * 64
    assert (st.pos_off, st._win_w) == (sj.pos_off, sj._win_w) == (2, 8)
    assert te.slot_session(n_slots=2, chunk_steps=2, stream_overlap_codes=1, **GREEDY)._win_w == 4
    assert st.state.cache[0].shape == (g.layers, 2, g.heads, st.cache_len, g.model_dim // g.heads)


def test_per_request_dynamics(engines):
    """Requests with different repetition penalties share the session; each
    equals its solo run with that scalar."""
    _, te, _ = engines
    mel = _prompt(4)
    kw = dict(do_sample=False, num_beams=1, max_mel_tokens=8)
    solo_1 = te.infer(mel, "HI THERE.", None, repetition_penalty=1.0, **kw)
    solo_10 = te.infer(mel, "HI THERE.", None, repetition_penalty=10.0, **kw)
    out = te.infer_slots([(mel, "HI THERE."), (mel, "HI THERE.")], n_slots=2, repetition_penalty=5.0,
                         per_request_kwargs=[{"repetition_penalty": 1.0}, {"repetition_penalty": 10.0}], **kw)
    _close(out[0][1], solo_1[1])
    _close(out[1][1], solo_10[1])


# ---------------------------------------------------------------------------
# rolling admission
# ---------------------------------------------------------------------------


def test_submit_mid_decode(engines):
    """A request submitted after the session has started decoding joins at
    the next tick; neither output is perturbed."""
    _, te, _ = engines
    mel_a, mel_b = _prompt(5), _prompt(6)
    solo_a = te.infer(mel_a, "HI THERE.", None, **GREEDY)
    solo_b = te.infer(mel_b, "HELLO AGAIN.", None, **GREEDY)
    sess = te.slot_session(n_slots=2, chunk_steps=2, **GREEDY)
    ra = sess.submit(mel_a, "HI THERE.")
    got = dict(sess.tick())  # A decodes its first chunk alone
    assert not got and int(sess.state.i_b[0]) == 2
    rb = sess.submit(mel_b, "HELLO AGAIN.")
    while sess.busy:
        got.update(sess.tick())
    _close(got[ra][1], solo_a[1])
    _close(got[rb][1], solo_b[1])
    assert len(sess.chunk_s) == sess._seq >= 4


def test_more_requests_than_slots_reuses_slots(engines):
    """5 requests through 2 slots: the scheduler harvests and admits anew
    (slot reuse and the circular cursor, at the engine's level)."""
    je, te, _ = engines
    mels = [_prompt(10 + i) for i in range(5)]
    texts = ["HI.", "YO.", "HELLO.", "HEY.", "SUP."]
    solo = [te.infer(m, t, None, **GREEDY) for m, t in zip(mels, texts)]
    out = te.infer_slots(list(zip(mels, texts)), n_slots=2, **GREEDY)
    gold = je.infer_slots(list(zip(mels, texts)), n_slots=2, **GREEDY)
    for (_, wav_s), (_, wav_o), (_, wav_j) in zip(solo, out, gold):
        _close(wav_s, wav_o)
        _close(wav_o, wav_j, WAV_TOL)


# ---------------------------------------------------------------------------
# serving mode: fast_latents + quant_kv
# ---------------------------------------------------------------------------


def test_serving_mode_matches_solo_and_skips_the_teacher_forced_pass(serving, monkeypatch):
    """The slot path keeps the captured latents (no teacher-forced pass where
    silence removal changed nothing) and the int8 cache."""
    te = serving
    mel = _prompt(20)
    solo = te.infer(mel, "HI THERE.", None, **GREEDY)
    calls = []
    many = te._gpt_latent_many
    monkeypatch.setattr(te, "_gpt_latent_many", lambda rows: calls.append(len(rows)) or many(rows))
    sess = te.slot_session(n_slots=2, **GREEDY)
    assert len(sess.state.cache) == 4 and sess.state.lat is not None and sess.pos_off == 1
    out = te.infer_slots([(mel, "HI THERE."), (mel, "HELLO WORLD.")], n_slots=2, **GREEDY)
    _close(out[0][1], solo[1])
    assert calls == []


def test_compacted_codes_fall_back_to_teacher_forced(serving, monkeypatch):
    """When silence removal CHANGES a row's codes, its captured latents no
    longer describe what is vocoded: the harvest takes the batched
    teacher-forced pass, and the result still equals solo infer under the
    same change."""
    te = serving
    orig_rls = type(te).remove_long_silence

    def compact(self, codes, silent_token=52, max_consecutive=30):
        out, lens = orig_rls(self, codes, silent_token=silent_token, max_consecutive=max_consecutive)
        out = np.asarray(out).copy()
        out[:, -1] = np.where(out[:, -1] == 3, 4, 3)  # the last code's VALUE (a prefix trim keeps the latents valid)
        return out, lens

    monkeypatch.setattr(type(te), "remove_long_silence", compact)
    calls = []
    many = te._gpt_latent_many
    monkeypatch.setattr(te, "_gpt_latent_many", lambda rows: calls.append(len(rows)) or many(rows))
    mel = _prompt(22)
    sess = te.slot_session(n_slots=2, **GREEDY)
    rid = sess.submit(mel, "HI THERE.")
    out = sess.drain()[rid]
    assert calls == [1] and sess.tf_latent_rows == 1
    _close(out[1], te.infer(mel, "HI THERE.", None, **GREEDY)[1])


# ---------------------------------------------------------------------------
# streaming slot requests
# ---------------------------------------------------------------------------


def test_stream_chunks_concatenate_to_result(serving):
    te = serving
    got = []
    sess = te.slot_session(n_slots=2, chunk_steps=3, **GREEDY)
    mel = _prompt(30)
    rid_s = sess.submit(mel, "HI THERE.", on_chunk=lambda r, c: got.append((r, c.copy())))
    sess.submit(mel, "HELLO.")  # a plain request shares the batch
    out = sess.drain()
    assert len(out) == 2
    wav = out[rid_s][1]
    assert len(got) >= 2 and all(r == rid_s and c.dtype == np.int16 and c.ndim == 1 for r, c in got)
    np.testing.assert_array_equal(np.concatenate([c for _, c in got]), wav.reshape(-1))
    # the first chunk comes with the first tick: the prefill's code + 3 steps
    assert got[0][1].size == 4 * te._samples_per_code()


def test_stream_sample_count_matches_non_streamed(serving):
    """As many samples as the non-streamed slot output, and the same values in
    the first window's interior (the same latents; near a window's right edge
    the receptive field sees zeros instead of the next frames, so the first 2
    of the first chunk's 8 codes are compared, as for infer_stream)."""
    te = serving
    mel = _prompt(31)
    kw = dict(GREEDY, max_mel_tokens=16)
    got = []
    sess = te.slot_session(n_slots=2, chunk_steps=7, **kw)
    rid = sess.submit(mel, "HI THERE.", on_chunk=lambda r, c: got.append(c.copy()))
    wav = sess.drain()[rid][1]
    base = te.infer_slots([(mel, "HI THERE.")], n_slots=2, **kw)[0][1]
    spc = te._samples_per_code()
    assert wav.shape == base.shape and len(got) >= 2 and got[0].size == 8 * spc
    _close(wav[: 2 * spc], base[: 2 * spc], 3.0)


def test_multi_sentence_rows_stream_sequentially(serving):
    te = serving
    mel, text = _prompt(32), "ONE TWO. THREE FOUR FIVE."
    kw = dict(max_text_tokens_per_sentence=16, **GREEDY)
    got, live = [], []
    sess = te.slot_session(n_slots=2, chunk_steps=2, **kw)
    rid = sess.submit(mel, text, on_chunk=lambda r, c: got.append(c.copy())
                      or live.append(sum(s is not None for s in sess.slots)))
    assert len(sess.pending) == 1 and sess.requests[rid]["n_rows"] == 3
    wav = sess.drain()[rid][1]
    assert len(got) >= 3 and max(live) == 1  # never two rows of the stream at once
    np.testing.assert_array_equal(np.concatenate(got), wav.reshape(-1))
    assert wav.shape == te.infer_slots([(mel, text)], n_slots=2, **kw)[0][1].shape


def test_streaming_requires_fast_latents(engines):
    _, te, _ = engines
    sess = te.slot_session(n_slots=1, **GREEDY)
    with pytest.raises(ValueError, match="fast_latents"):
        sess.submit(_prompt(33), "HI.", on_chunk=lambda r, c: None)


def test_stop_terminated_stream_matches_non_streamed(serving):
    """A row that ends by a SAMPLED stop code: the streamed result does not
    vocode the stop code's latent. Two sessions from one seed draw the same
    uniforms (streaming adds vocoder calls only)."""
    te = serving
    mel = _prompt(5)
    kw = dict(do_sample=True, top_k=30, max_mel_tokens=24, num_beams=1, temperature=1.0, top_p=0.9,
              repetition_penalty=1.5)
    spc = te._samples_per_code()
    for seed in range(40):  # the first seed whose row stops before the budget
        plain = te.slot_session(n_slots=2, chunk_steps=3, seed=seed, **kw)
        rid = plain.submit(mel, "HI THERE.")
        base = plain.drain()[rid][1]
        if spc < base.size < 24 * spc:
            break
    else:
        pytest.fail("no seed exercises the stop path")
    got = []
    stream = te.slot_session(n_slots=2, chunk_steps=3, seed=seed, **kw)
    rid = stream.submit(mel, "HI THERE.", on_chunk=lambda r, c: got.append(c.copy()))
    wav = stream.drain()[rid][1]
    np.testing.assert_array_equal(np.concatenate(got), wav.reshape(-1))
    assert wav.shape == base.shape


def test_cancel_mid_decode_frees_slot_and_truncates(serving):
    """cancel(rid) mid-decode: the row stops at the next tick, its request
    completes with the audio produced so far (the delivered chunks == the
    result), and the other request is unaffected."""
    te = serving
    mel = _prompt(40)
    kw = dict(do_sample=False, max_mel_tokens=24, num_beams=1, repetition_penalty=1.0)
    spc = te._samples_per_code()
    full = te.infer_slots([(mel, "HELLO WORLD.")], n_slots=2, **kw)[0][1]
    sess = te.slot_session(n_slots=2, chunk_steps=3, **kw)
    got = []
    rid_c = sess.submit(mel, "HI THERE.", on_chunk=lambda r, c: got.append(c.copy()))
    rid_k = sess.submit(mel, "HELLO WORLD.")
    out = dict(sess.tick())
    assert rid_c not in out, "premise: still decoding after one tick"
    sess.cancel(rid_c)
    sess.cancel(12345)  # an unknown id is ignored
    out.update(sess.drain())
    assert set(out) == {rid_c, rid_k}
    wav_c = out[rid_c][1]
    assert 0 < wav_c.size <= 5 * spc  # the first tick's 4 codes, and at most the boundary code
    np.testing.assert_array_equal(np.concatenate(got), wav_c.reshape(-1))
    _close(out[rid_k][1], full)


@pytest.mark.parametrize("streaming", [True, False], ids=["stream", "plain"])
def test_cancel_before_admission_completes_empty(serving, streaming):
    """cancel(rid) while every row is still queued: the request completes
    with empty audio and never takes a slot, on both harvest branches."""
    te = serving
    mel = _prompt(41)
    sess = te.slot_session(n_slots=1, chunk_steps=2, **GREEDY)
    rid_a = sess.submit(mel, "HI THERE.")
    over = {"on_chunk": (lambda r, c: None)} if streaming else {}
    rid_b = sess.submit(mel, "HELLO.", **over)
    sess.cancel(rid_b)  # still queued behind rid_a (1 slot)
    out = sess.drain()
    assert out[rid_b][1].size == 0 and out[rid_b][1].dtype == np.int16
    assert out[rid_a][1].size > 0


def test_admit_seq_guards_a_reused_slot(engines):
    """A done flag in a snapshot older than a slot's admission must not
    harvest the new occupant."""
    _, te, _ = engines
    sess = te.slot_session(n_slots=1, chunk_steps=50, **GREEDY)
    ra = sess.submit(_prompt(42), "HI.")
    assert [r for r, _ in sess.tick()] == [ra]  # A ran to its end and was harvested
    stale = (sess._seq, sess.state.done.numpy().copy(), sess.state.i_b.numpy().copy(), sess.state.codes.numpy().copy())
    assert stale[1][0]
    rb = sess.submit(_prompt(43), "YO THERE.")
    sess._admit_one(sess.pending.popleft(), 0)  # B takes the slot A left
    assert sess._harvest(stale) == [] and sess.slots[0]["rid"] == rb
    out = sess.drain()
    _close(out[rb][1], te.infer(_prompt(43), "YO THERE.", None, **GREEDY)[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_schedule_matches_solo(engines, seed):
    """Random interleavings of submit / tick / cancel: every request that was
    not cancelled equals its solo run whatever the admission order, the slot
    reuse and the cancels around it; cancelled ones complete (cut short or
    empty) without wedging the session."""
    _, te, _ = engines
    rng = np.random.default_rng(seed)
    texts = ["HI.", "YO THERE.", "HELLO WORLD.", "HEY NOW.", "SUP."]
    sess = te.slot_session(n_slots=2, chunk_steps=2, **GREEDY)
    submitted, cancelled, results = {}, set(), {}
    n_target, ops = 5, 0
    while (len(results) < len(submitted) or len(submitted) < n_target) and ops < 200:
        ops += 1
        roll = rng.random()
        if len(submitted) < n_target and roll < 0.4:
            i = len(submitted)
            mel, text = _prompt(50 + i), texts[i % len(texts)]
            submitted[sess.submit(mel, text)] = (mel, text)
        elif roll < 0.5 and submitted and rng.random() < 0.3:
            victim = int(rng.choice(list(submitted)))
            if victim not in results:
                sess.cancel(victim)
                cancelled.add(victim)
        else:
            results.update(sess.tick())
    assert ops < 200, "scheduler failed to converge"
    assert set(results) == set(submitted) and not sess.busy
    for rid, (mel, text) in submitted.items():
        wav = results[rid][1]
        assert wav.dtype == np.int16
        if rid not in cancelled:
            _close(wav, te.infer(mel, text, None, **GREEDY)[1])


# ---------------------------------------------------------------------------
# warmup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("routing", ["infer", "batch", "slots", "slots_streaming", "infer_streaming"])
def test_warmup_routes_and_leaves_outputs_unchanged(engines, monkeypatch, routing):
    """Each routing of warmup goes through the entry points it names, returns
    the seconds it spent, and leaves the engine's outputs as they were."""
    _, te, _ = engines
    mel = _prompt(60)
    before = te.infer(mel, "HI THERE.", None, **GREEDY)[1]
    calls = []
    for name in ("infer", "infer_batch", "slot_session", "infer_stream", "_vocode_many"):
        fn = getattr(te, name)
        monkeypatch.setattr(te, name, lambda *a, _fn=fn, _n=name, **k: calls.append((_n, a, k)) or _fn(*a, **k))
    kw = dict(texts=("WARM UP.", "HELLO."), verbose=False, **GREEDY)
    names = lambda: [c[0] for c in calls if c[0] != "_vocode_many"]
    if routing == "infer":
        dt = te.warmup(**kw)
        assert names() == ["infer", "infer"]
    elif routing == "batch":
        dt = te.warmup(batch=3, **kw)
        assert names() == ["infer_batch"]
        (_, (items,), k), = [c for c in calls if c[0] == "infer_batch"]
        assert [t for _, t in items] == ["WARM UP.", "HELLO.", "WARM UP."] and k["sentences_bucket_max_size"] == 8
    elif routing == "slots":
        dt = te.warmup(n_slots=2, streaming=True, **kw)  # no fast_latents: no streaming requests, no windows
        assert names() == ["slot_session"]
        assert calls[0][2]["n_slots"] == 2 and "num_beams" not in calls[0][2]
    elif routing == "slots_streaming":
        te.fast_latents = True
        try:
            dt = te.warmup(n_slots=4, streaming=True, **kw)
        finally:
            te.fast_latents = False
        assert names() == ["slot_session"]
        # the last three vocoder calls are the window batches of 1, 2 and 4 rows, each 8 codes wide
        windows = [c[1][0] for c in calls if c[0] == "_vocode_many"][-3:]
        assert [len(w) for w in windows] == [1, 2, 4] and all(w[0][0].shape[1] == 8 for w in windows)
    else:
        dt = te.warmup(streaming=True, **kw)
        assert names() == ["infer", "infer", "infer_stream", "infer_stream"]
        assert "num_beams" not in calls[-1][2]
    assert dt > 0
    monkeypatch.undo()
    np.testing.assert_array_equal(te.infer(mel, "HI THERE.", None, **GREEDY)[1], before)
