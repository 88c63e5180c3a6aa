"""The port's engine end to end against the JAX engine: same tiny config,
same weights (the JAX engine's, bridged), same prompt wav and text; greedy
codes must be equal and the int16 wav within 1e-4 of full scale (plus one
unit for the int16 truncation). Also: the port imports no JAX, runs the
reference's default beams instead of downgrading them, and its CLI runs the
single-request path."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from indextts_tpu.config import save_config
from indextts_tpu.engine import IndexTTS as JaxIndexTTS
from indextts_tpu_torch.engine import IndexTTS
from indextts_tpu_torch.weights import load_jax_params
from tests.test_engine import tiny_config
from tests.test_torch_vocoder import scramble

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = os.path.join(REPO, "tests", "sample_prompt.wav")
WAV_TOL = 1e-4 * 32767 + 1


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    cfg_path = str(d / "config.yaml")
    save_config(tiny_config(), cfg_path)
    je = JaxIndexTTS(cfg_path=cfg_path, model_dir=str(d), is_fp16=False, allow_random_init=True)
    rng = np.random.default_rng(29)
    # a sharper mel head (greedy then runs several tokens before stop) and an
    # audible vocoder, in place of the init's near-zero weights
    je.gpt_params["mel_head"]["weight"] = jnp.asarray(
        rng.standard_normal(je.gpt_params["mel_head"]["weight"].shape).astype(np.float32) * 0.3)
    je.bigvgan_params = jax.tree_util.tree_map(
        jnp.asarray, scramble(jax.tree_util.tree_map(np.asarray, je.bigvgan_params), rng))
    te = IndexTTS(cfg_path=cfg_path, model_dir=str(d), is_fp16=False, device="cpu", allow_random_init=True)
    load_jax_params(te.gpt, je.gpt_params)
    load_jax_params(te.bigvgan, je.bigvgan_params)
    return je, te, cfg_path


def _infer_recording_codes(engine, **kw):
    codes = []
    generate = engine._gpt_generate

    def recording(*a, **k):
        out = generate(*a, **k)
        codes.append(np.asarray(out[0]))
        return out

    engine._gpt_generate = recording
    try:
        sr, wav = engine.infer(audio_prompt=PROMPT, **kw)
    finally:
        del engine._gpt_generate
    return sr, wav, codes


@pytest.mark.parametrize("text,split", [("HELLO WORLD.", 120), ("HELLO WORLD. THIS IS A TEST.", 16)])
def test_greedy_infer_matches_jax_engine(engines, text, split):
    je, te, _ = engines
    kw = dict(text=text, do_sample=False, num_beams=1, max_mel_tokens=24, max_text_tokens_per_sentence=split)
    sr_j, wav_j, codes_j = _infer_recording_codes(je, **kw)
    sr_t, wav_t, codes_t = _infer_recording_codes(te, **kw)
    assert len(codes_t) == len(codes_j) == (2 if split == 16 else 1)
    for a, b in zip(codes_t, codes_j):
        np.testing.assert_array_equal(a, b)
    assert sr_t == sr_j and wav_t.shape == wav_j.shape and wav_t.dtype == np.int16
    assert wav_t.shape[0] > 3 * te._samples_per_code()  # a real decode, not an immediate stop
    assert np.abs(wav_j.astype(np.int32)).max() > 300  # and an audible wav
    assert np.abs(wav_t.astype(np.int32) - wav_j.astype(np.int32)).max() <= WAV_TOL
    assert te.last_stats["vocoder_calls"] == len(codes_t)


def test_infer_writes_wav_file(engines, tmp_path):
    _, te, _ = engines
    out = str(tmp_path / "out.wav")
    assert te.infer(audio_prompt=PROMPT, text="HELLO.", output_path=out, num_beams=1, max_mel_tokens=8) == out
    from indextts_tpu_torch.utils.audio import read_wav

    audio, sr = read_wav(out)
    assert sr == 24000 and audio.shape[-1] > 0


def test_beams_raise_instead_of_downgrading(engines, monkeypatch):
    """The reference default (num_beams=3, sampled) reaches generate_speech_beam
    with nb = 3, not a greedy or single-beam decode; a misspelt knob still
    raises."""
    from indextts_tpu_torch import engine as engine_mod

    _, te, _ = engines
    seen = []
    beam = engine_mod.generate_speech_beam
    monkeypatch.setattr(engine_mod, "generate_speech_beam", lambda *a, **k: seen.append(a[2]) or beam(*a, **k))
    sr, wav = te.infer(audio_prompt=PROMPT, text="HELLO.", max_mel_tokens=8)
    assert [(g.num_beams, g.do_sample, g.top_k) for g in seen] == [(3, True, 30)] and wav.shape[0] > 0
    with pytest.raises(ValueError, match="unknown generation kwargs"):
        te.infer(audio_prompt=PROMPT, text="HELLO.", num_beams=1, top_kk=3)


def test_cli_single_request(engines, tmp_path, capsys):
    from indextts_tpu_torch.cli import main

    _, _, cfg_path = engines
    out = str(tmp_path / "cli.wav")
    main(["HELLO WORLD.", "-v", PROMPT, "-c", cfg_path, "--model_dir", str(tmp_path), "-o", out, "-d", "cpu"])
    assert os.path.getsize(out) > 44
    with pytest.raises(SystemExit):
        main(["--help"])
    help_text = capsys.readouterr().out
    assert "num_beams=3" in help_text and "--fast-latents" in help_text


def test_port_imports_no_jax():
    """Every module of the port imports in a fresh interpreter without
    bringing in jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import indextts_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'indextts_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'indextts_tpu' or m.startswith('indextts_tpu.'))\n"
        "assert 'indextts_tpu_torch.engine' in sys.modules and len(mods) > 15, mods\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_tokenizer_needs_bpe_model_or_random_init(tmp_path):
    """As the JAX engine (indextts_tpu/engine.py, its bpe.model lookup): a
    missing bpe.model raises FileNotFoundError unless random init was asked
    for, which builds the 28-piece vocabulary (26 upper-case letters, ".",
    "▁") that the JAX engine builds."""
    from indextts_tpu.utils.front import TextNormalizer as JaxNormalizer
    from indextts_tpu.utils.front import TextTokenizer as JaxTokenizer
    from indextts_tpu.utils.spm import SentencePieceProcessor, build_vocab_from_pieces
    from indextts_tpu_torch.engine import make_tokenizer
    from indextts_tpu_torch.utils.front import TextNormalizer

    missing = str(tmp_path / "bpe.model")
    normalizer = TextNormalizer()
    normalizer.load()
    with pytest.raises(FileNotFoundError, match="bpe.model"):
        make_tokenizer(missing, normalizer, allow_random_init=False)
    tok = make_tokenizer(missing, normalizer, allow_random_init=True)
    pieces = [(chr(65 + i), -float(i)) for i in range(26)] + [(".", -30.0), ("▁", -31.0)]
    jax_normalizer = JaxNormalizer()
    jax_normalizer.load()
    jax_tok = JaxTokenizer(sp_model=SentencePieceProcessor(vocab=build_vocab_from_pieces(pieces)),
                           normalizer=jax_normalizer)
    assert {p for p, _ in pieces} <= set(tok.get_vocab()) and tok.get_vocab() == jax_tok.get_vocab()
    text = "HELLO WORLD. GOOD DAY."
    assert tok.encode(text) == jax_tok.encode(text)
