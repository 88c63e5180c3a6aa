"""The port's bucketed batch path (IndexTTS.infer_fast) and the int8 KV cache
in the engine, against the JAX engine on the same tiny float32 weights, and
the batched stages against their per-row forms (as tests/test_infer_batch.py
pins them for JAX): batched == per-row is what makes batching legal.

Codes must be equal and the int16 wav within 8 units."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from indextts_tpu.config import save_config
from indextts_tpu.engine import IndexTTS as JaxIndexTTS
import indextts_tpu_torch.ops.quant as tquant
from indextts_tpu_torch.engine import IndexTTS
from indextts_tpu_torch.ops.cuda.qmatmul import int8_matmul_plain
from indextts_tpu_torch.weights import load_jax_params
from tests.test_engine import tiny_config
from tests.test_torch_checkpoint import ckpt_dir  # noqa: F401  (a fixture: tiny reference-format checkpoints)
from tests.test_torch_vocoder import scramble

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = os.path.join(REPO, "tests", "sample_prompt.wav")
WAV_TOL = 8


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_fast")
    cfg_path = str(d / "config.yaml")
    save_config(tiny_config(), cfg_path)
    je = JaxIndexTTS(cfg_path=cfg_path, model_dir=str(d), is_fp16=False, allow_random_init=True)
    rng = np.random.default_rng(31)
    # a sharper mel head (greedy runs several tokens before stop) and an
    # audible vocoder, in place of the init's near-zero weights
    je.gpt_params["mel_head"]["weight"] = jnp.asarray(
        rng.standard_normal(je.gpt_params["mel_head"]["weight"].shape).astype(np.float32) * 0.3)
    je.bigvgan_params = jax.tree_util.tree_map(
        jnp.asarray, scramble(jax.tree_util.tree_map(np.asarray, je.bigvgan_params), rng))
    te = IndexTTS(cfg_path=cfg_path, model_dir=str(d), is_fp16=False, device="cpu", allow_random_init=True)
    load_jax_params(te.gpt, je.gpt_params)
    load_jax_params(te.bigvgan, je.bigvgan_params)
    # one torch thread while these tests run: at this size the eager loops are
    # thousands of tiny ops, and an intra-op thread pool that shares the cores
    # with the other test workers slows each of them a hundredfold
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield je, te, cfg_path
    torch.set_num_threads(threads)


def _prompt(seed, frames=40):
    return np.random.default_rng(seed).standard_normal((1, 100, frames)).astype(np.float32) * 0.1


def _run_recording_codes(engine, method, **kw):
    codes = []
    generate = engine._gpt_generate

    def recording(*a, **k):
        out = generate(*a, **k)
        codes.append(np.asarray(out[0]))
        return out

    engine._gpt_generate = recording
    try:
        sr, wav = getattr(engine, method)(audio_prompt=PROMPT, **kw)
    finally:
        del engine._gpt_generate
    return sr, wav, codes


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lengths,bucket", [([5, 3, 9], 4), ([7, 2, 9, 4, 4, 11, 1, 6, 3], 4),
                                            ([7, 2, 9, 4, 4], 1), ([3, 8, 8, 1, 5, 2], 2)])
def test_bucket_sentences_matches_jax(engines, lengths, bucket):
    je, te, _ = engines
    sentences = [[f"T{i}"] * n for i, n in enumerate(lengths)]
    assert te.bucket_sentences(sentences, bucket_max_size=bucket) == je.bucket_sentences(sentences, bucket)


def test_pad_tokens_cat_matches_jax(engines):
    je, te, _ = engines
    tokens = [np.asarray([[3, 4, 5]]), np.asarray([[7]]), np.asarray([[1, 2, 3, 4, 5, 6]])]
    np.testing.assert_array_equal(te.pad_tokens_cat(tokens), je.pad_tokens_cat(tokens))


# ---------------------------------------------------------------------------
# batched stages against their per-row forms
# ---------------------------------------------------------------------------


def _latent_rows(engine, rng):
    g = engine.cfg.gpt
    rows = []
    for i, (lt, lc) in enumerate([(5, 6), (9, 6), (5, 20), (12, 18), (3, 3)]):
        conds = engine._conds_for(_prompt(30 + i))
        tt = rng.integers(0, g.number_text_tokens - 1, (1, lt)).astype(np.int64)
        cd = rng.integers(0, g.start_mel_token, (1, lc)).astype(np.int64)
        rows.append((conds, tt, cd, np.array([lc], np.int64)))
    return rows


def test_gpt_latent_many_matches_per_row(engines):
    """Rows spanning several (text, code) buckets and a group padded to a
    power of two."""
    _, te, _ = engines
    rows = _latent_rows(te, np.random.default_rng(7))
    many = te._gpt_latent_many(rows)
    assert len(many) == len(rows)
    for (conds, tt, cd, cl), lat in zip(rows, many):
        assert lat.shape == (1, cd.shape[1], te.cfg.gpt.model_dim)
        solo = te._gpt_latent(conds, tt, cd, cl)[:, : cd.shape[1]]
        np.testing.assert_allclose(lat.numpy(), solo.numpy(), rtol=2e-5, atol=2e-5)


def test_gpt_latent_text_lengths_match_jax(engines):
    """A batch of rows of different text lengths: each row's own length masks
    its padded text keys (the port once used the padded width for every
    row)."""
    je, te, _ = engines
    rows = _latent_rows(te, np.random.default_rng(9))[:2]  # text lengths 5 and 9, one code bucket
    text = te.pad_tokens_cat([r[1] for r in rows])
    codes = np.concatenate([r[2] for r in rows])
    tlens = np.asarray([r[1].shape[1] for r in rows])
    clens = np.asarray([6, 6])
    conds = np.concatenate([r[0].numpy() for r in rows])
    gold = je._gpt_latent(jnp.asarray(conds), text.astype(np.int32), codes.astype(np.int32), clens,
                          text_lengths=tlens)
    mine = te._gpt_latent(torch.from_numpy(conds), text, codes, clens, text_lengths=tlens)
    np.testing.assert_allclose(mine.numpy(), np.asarray(gold), atol=1e-4, rtol=0)
    solo = te._gpt_latent(rows[0][0], rows[0][1], rows[0][2], rows[0][3])
    np.testing.assert_allclose(mine[:1].numpy(), solo.numpy(), atol=2e-5, rtol=2e-5)


def _vocode_chunks(d, rng):
    return [(rng.standard_normal((1, tc, d)).astype(np.float32) * 0.1, nv, _prompt(40 + i, frames=fr))
            for i, (tc, nv, fr) in enumerate([(6, 5, 40), (9, 9, 40), (6, 6, 52), (17, 16, 40), (40, 40, 130)])]


def test_vocode_many_matches_per_chunk(engines):
    """Chunks of differing latent lengths and prompt frame counts; expected =
    per-chunk _vocode and the int16 cast on the host."""
    _, te, _ = engines
    chunks = _vocode_chunks(te.cfg.gpt.model_dim, np.random.default_rng(8))
    many = te._vocode_many([(torch.from_numpy(lat), nv, mel) for lat, nv, mel in chunks])
    spc = te._samples_per_code()
    for (lat, nv, mel), wav in zip(chunks, many):
        assert wav.dtype == np.int16 and wav.shape == (1, nv * spc)
        expected = np.clip(32767.0 * te._vocode(torch.from_numpy(lat), nv, mel), -32767.0, 32767.0).astype(np.int16)
        np.testing.assert_allclose(wav.astype(np.float32), expected.astype(np.float32), atol=2.0)


def test_vocode_many_matches_jax(engines):
    je, te, _ = engines
    chunks = _vocode_chunks(te.cfg.gpt.model_dim, np.random.default_rng(12))
    gold = je._vocode_many([(jnp.asarray(lat), nv, mel) for lat, nv, mel in chunks])
    mine = te._vocode_many([(torch.from_numpy(lat), nv, mel) for lat, nv, mel in chunks])
    for a, b in zip(mine, gold):
        assert a.shape == b.shape and np.abs(a).max() > 300  # an audible wav
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= WAV_TOL


@pytest.mark.parametrize("quant_kv", [False, True])
def test_batched_greedy_rows_equal_solo(engines, quant_kv):
    """Three texts of different lengths decoded as one batch give each row's
    solo codes, with either cache."""
    _, te, _ = engines
    te.quant_kv = quant_kv
    try:
        conds = te._conds_for(_prompt(3))
        gen, dyn, _ = te._parse_generation_kwargs(dict(do_sample=False, num_beams=1, max_mel_tokens=16,
                                                       repetition_penalty=1.0))
        args = (gen, dyn["temperature"], dyn["top_p"], dyn["repetition_penalty"])
        rows = [np.asarray([[5, 6, 7, 8, 9]]), np.asarray([[11, 12, 13]]), np.asarray([[20, 21, 22, 23, 24, 25, 26, 27, 28]])]
        batch, batch_lens, _, _ = te._gpt_generate(conds, te.pad_tokens_cat(rows), np.asarray([5, 3, 9]), *args)
        for i, r in enumerate(rows):
            solo, solo_lens, _, _ = te._gpt_generate(conds, r, np.asarray([r.shape[1]]), *args)
            np.testing.assert_array_equal(batch[i : i + 1], solo)
            np.testing.assert_array_equal(batch_lens[i : i + 1], solo_lens)
        assert batch_lens.min() > 3
    finally:
        te.quant_kv = False


# ---------------------------------------------------------------------------
# end to end against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,quant_kv,text,split", [
    ("infer_fast", False, "HELLO WORLD. THIS IS A TEST. GOOD DAY TO YOU.", 16),
    ("infer_fast", True, "HELLO WORLD. THIS IS A TEST. GOOD DAY TO YOU.", 16),
    ("infer_fast", False, "HELLO WORLD.", 120),
    ("infer", True, "HELLO WORLD. THIS IS A TEST.", 16),
])
def test_greedy_matches_jax_engine(engines, method, quant_kv, text, split):
    je, te, _ = engines
    kw = dict(text=text, do_sample=False, num_beams=1, max_mel_tokens=24, max_text_tokens_per_sentence=split)
    je.quant_kv = te.quant_kv = quant_kv
    try:
        sr_j, wav_j, codes_j = _run_recording_codes(je, method, **kw)
        sr_t, wav_t, codes_t = _run_recording_codes(te, method, **kw)
    finally:
        je.quant_kv = te.quant_kv = False
    assert len(codes_t) == len(codes_j) >= (1 if split == 120 else 2)
    for a, b in zip(codes_t, codes_j):
        np.testing.assert_array_equal(a, b)
    assert sr_t == sr_j and wav_t.shape == wav_j.shape and wav_t.dtype == np.int16
    assert wav_t.shape[0] > 3 * te._samples_per_code()  # a real decode, not an immediate stop
    assert np.abs(wav_j.astype(np.int32)).max() > 300  # and an audible wav
    assert np.abs(wav_t.astype(np.int32) - wav_j.astype(np.int32)).max() <= WAV_TOL
    assert te.last_stats["gpt_calls"] == len(codes_t)


@pytest.mark.parametrize("method,text,split", [
    ("infer", "HELLO WORLD. THIS IS A TEST.", 16),
    ("infer_fast", "HELLO WORLD. THIS IS A TEST. GOOD DAY TO YOU.", 16),
])
def test_default_kwargs_greedy_matches_jax_engine(engines, method, text, split):
    """The reference's default generation kwargs (num_beams=3, top-k 30,
    top-p 0.8, repetition penalty 10, length penalty 0), made deterministic
    with do_sample=False: beam codes equal the JAX engine's and the wav is
    within WAV_TOL."""
    je, te, _ = engines
    kw = dict(text=text, do_sample=False, max_mel_tokens=24, max_text_tokens_per_sentence=split)
    sr_j, wav_j, codes_j = _run_recording_codes(je, method, **kw)
    sr_t, wav_t, codes_t = _run_recording_codes(te, method, **kw)
    assert len(codes_t) == len(codes_j) >= 2
    for a, b in zip(codes_t, codes_j):
        np.testing.assert_array_equal(a, b)
    assert sr_t == sr_j and wav_t.shape == wav_j.shape and wav_t.dtype == np.int16
    assert wav_t.shape[0] > 3 * te._samples_per_code()
    assert np.abs(wav_j.astype(np.int32)).max() > 300
    assert np.abs(wav_t.astype(np.int32) - wav_j.astype(np.int32)).max() <= WAV_TOL


def test_engine_counts_match_k5_calls(engines, monkeypatch):
    """On int8 weights, the 2-D int8 matmuls of a request (K5 launches on the
    card) number gpt_calls + (4 * layers + 1) * gpt_steps of last_stats."""
    _, te, cfg_path = engines
    q = IndexTTS(cfg_path=cfg_path, model_dir=os.path.dirname(cfg_path), is_fp16=False, device="cpu",
                 allow_random_init=True, quant_kv=True)
    q.gpt.load_state_dict(te.gpt.state_dict())
    tquant.quantize_unified_voice(q.gpt)
    calls = []
    monkeypatch.setattr(tquant, "int8_matmul", lambda x, *a: calls.append(1) or int8_matmul_plain(x, *a))
    layers = q.cfg.gpt.layers
    for method in ("infer_fast", "infer"):
        calls.clear()
        getattr(q, method)(audio_prompt=PROMPT, text="HELLO WORLD. THIS IS A TEST.", do_sample=False, num_beams=1,
                           max_mel_tokens=16, max_text_tokens_per_sentence=16)
        st = q.last_stats
        assert st["gpt_calls"] == 2 and st["gpt_steps"] > 2
        assert len(calls) == st["gpt_calls"] + (4 * layers + 1) * st["gpt_steps"]


def test_cli_fast_quant_kv(ckpt_dir, tmp_path, monkeypatch):
    """--fast --quant-kv reach the engine: infer_fast on an engine built with
    quant_kv, writing the wav."""
    from indextts_tpu_torch import engine as engine_mod
    from indextts_tpu_torch.cli import main

    cfg_path = os.path.join(ckpt_dir, "config.yaml")
    seen = []

    class Recording(IndexTTS):
        def infer_fast(self, **kw):
            seen.append(self.quant_kv)
            return super().infer_fast(**kw)

    monkeypatch.setattr(engine_mod, "IndexTTS", Recording)
    out = str(tmp_path / "fast.wav")
    main(["HELLO WORLD.", "-v", PROMPT, "-c", cfg_path, "--model_dir", ckpt_dir, "-o", out, "-d", "cpu",
          "--fast", "--quant-kv"])
    assert seen == [True] and os.path.getsize(out) > 44


def test_cli_runs_the_engine_default_beams(ckpt_dir, tmp_path, monkeypatch):
    """The CLI passes no num_beams (the JAX CLI passes none either): the
    decode is the engine's default beam search, nb = 3; --fast-latents
    reaches the engine."""
    from indextts_tpu_torch import engine as engine_mod
    from indextts_tpu_torch.cli import main

    cfg_path = os.path.join(ckpt_dir, "config.yaml")
    gens, flags = [], []
    beam = engine_mod.generate_speech_beam
    monkeypatch.setattr(engine_mod, "generate_speech_beam", lambda *a, **k: gens.append(a[2]) or beam(*a, **k))

    class Recording(IndexTTS):
        def infer(self, **kw):
            flags.append(self.fast_latents)
            return super().infer(**kw)

    monkeypatch.setattr(engine_mod, "IndexTTS", Recording)
    out = str(tmp_path / "beams.wav")
    main(["HELLO WORLD.", "-v", PROMPT, "-c", cfg_path, "--model_dir", ckpt_dir, "-o", out, "-d", "cpu",
          "--fast-latents"])
    assert flags == [True] and [g.num_beams for g in gens] == [3] and os.path.getsize(out) > 44
