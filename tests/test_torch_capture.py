"""Decode-time latent capture (fast_latents): the port's captured latents
against JAX generate_speech / generate_speech_beam (capture_latents=True,
pos_off=1) and against the port's own teacher-forced latent pass, on the
same JAX-initialized tiny weights, float32 on the CPU, within 1e-4. Capture
does not change codes, and the engine skips the teacher-forced pass when
silence removal left the codes as they were."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import indextts_tpu.models.gpt_decode as jdec
import indextts_tpu_torch.models.gpt_decode as tdec
from indextts_tpu_torch.engine import IndexTTS
from indextts_tpu_torch.models.gpt import unified_voice_forward
from tests.test_torch_beam import LENS, TEXT, _t, setup  # noqa: F401  (fixture reuse)

TOL = 1e-4
MAX_NEW = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = os.path.join(REPO, "tests", "sample_prompt.wav")


def _gen(nb):
    return dict(do_sample=False, num_beams=nb, max_new_tokens=MAX_NEW)


def _port(setup, nb, capture=True, pos_off=1):
    cfg, _, model, conds = setup
    fn = tdec.generate_speech_beam if nb > 1 else tdec.generate_speech
    out = fn(model, cfg, tdec.GenerationConfig(**_gen(nb)), _t(np.repeat(conds, 2, 0)), _t(TEXT), _t(LENS),
             torch.Generator(), repetition_penalty=1.0, capture_latents=capture, pos_off=pos_off)
    return [o.numpy() for o in out]


def _n_codes(cfg, row):
    """Codes before the first stop token: the engine trims to them."""
    stop = np.nonzero(row == cfg.stop_mel_token)[0]
    return int(stop[0]) if stop.size else row.shape[0]


@pytest.mark.parametrize("nb", [1, 2])
def test_captured_latents_match_jax(setup, nb):
    cfg, params, _, conds = setup
    fn = jdec.generate_speech_beam if nb > 1 else jdec.generate_speech
    gold = [np.asarray(o) for o in fn(params, cfg, jdec.GenerationConfig(**_gen(nb)),
                                       jnp.asarray(np.repeat(conds, 2, 0)), jnp.asarray(TEXT), jnp.asarray(LENS),
                                       jax.random.PRNGKey(0), repetition_penalty=1.0, capture_latents=True,
                                       pos_off=1)]
    codes, lengths, lat = _port(setup, nb)
    np.testing.assert_array_equal(codes, gold[0])
    np.testing.assert_array_equal(lengths, gold[1])
    assert lat.shape == gold[2].shape == (2, MAX_NEW, cfg.model_dim)
    for r in range(2):
        n = int(lengths[r])
        np.testing.assert_allclose(lat[r, :n], gold[2][r, :n], atol=TOL, rtol=0)


@pytest.mark.parametrize("nb", [1, 2])
def test_captured_latents_match_teacher_forced(setup, nb):
    cfg, _, model, conds = setup
    codes, _, lat = _port(setup, nb)
    checked = 0
    for r in range(2):
        n = _n_codes(cfg, codes[r])
        if n == 0:
            continue
        with torch.no_grad():
            tf = unified_voice_forward(model, cfg, speech_conditioning_mel=None, text_inputs=_t(TEXT[r : r + 1]),
                                       text_lengths=_t(LENS[r : r + 1]), mel_codes=_t(codes[r : r + 1, :n]),
                                       wav_lengths=_t([n * cfg.mel_length_compression]), cond_mel_lengths=None,
                                       conds=_t(conds), mask_pad_keys=True).numpy()
        np.testing.assert_allclose(lat[r, :n], tf[0, :n], atol=TOL, rtol=0)
        checked += n
    assert checked > 4


@pytest.mark.parametrize("nb,pos_off", [(1, 1), (1, 2), (2, 1), (3, 2)])
def test_capture_does_not_change_codes(setup, nb, pos_off):
    a = _port(setup, nb, capture=False, pos_off=pos_off)
    b = _port(setup, nb, capture=True, pos_off=pos_off)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.fixture(scope="module")
def fast_engine(tmp_path_factory):
    from indextts_tpu.config import save_config
    from tests.test_engine import tiny_config

    d = tmp_path_factory.mktemp("ckpt_fastlat")
    cfg_path = str(d / "config.yaml")
    save_config(tiny_config(), cfg_path)
    engine = IndexTTS(cfg_path=cfg_path, model_dir=str(d), is_fp16=False, device="cpu", allow_random_init=True,
                      fast_latents=True)
    with torch.no_grad():
        engine.gpt.mel_head.weight.mul_(15.0)  # greedy runs several tokens before stop
    return engine


@pytest.mark.parametrize("method,num_beams", [("infer", 1), ("infer", 2), ("infer_fast", 3)])
def test_engine_skips_teacher_forced_pass_on_clean_codes(fast_engine, monkeypatch, method, num_beams):
    """As tests/test_capture_latents.py pins it for the JAX engine: with
    fast_latents the captured latents are used, and _gpt_latent (and its
    batched form) never run, when silence removal changed nothing."""
    calls = []
    orig = fast_engine._gpt_latent
    monkeypatch.setattr(fast_engine, "_gpt_latent", lambda *a, **k: calls.append(1) or orig(*a, **k))
    sr, wav = getattr(fast_engine, method)(audio_prompt=PROMPT, text="HELLO WORLD. GOOD DAY.", do_sample=False,
                                           num_beams=num_beams, max_mel_tokens=12, repetition_penalty=1.0,
                                           max_text_tokens_per_sentence=16)
    assert sr == 24000 and wav.shape[0] > 0 and np.isfinite(wav).all()
    assert calls == [] and fast_engine.last_stats["tf_latent_rows"] == 0


def test_engine_falls_back_when_silence_removal_changes_codes(fast_engine, monkeypatch):
    """Codes that silence removal compacted no longer line up with the
    captured latents: the teacher-forced pass runs for that row."""
    calls = []
    orig = fast_engine._gpt_latent
    monkeypatch.setattr(fast_engine, "_gpt_latent", lambda *a, **k: calls.append(1) or orig(*a, **k))
    remove = fast_engine.remove_long_silence

    def drop_first(codes, **kw):
        out, lens = remove(codes, **kw)
        return out[:, 1:], lens - 1

    monkeypatch.setattr(fast_engine, "remove_long_silence", drop_first)
    fast_engine.infer(audio_prompt=PROMPT, text="HELLO WORLD.", do_sample=False, num_beams=2, max_mel_tokens=12,
                      repetition_penalty=1.0)
    assert calls == [1] and fast_engine.last_stats["tf_latent_rows"] == 1
