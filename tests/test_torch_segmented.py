"""Segment-growing decode in the port: grow_cache on both cache kinds, the
segmented loops against the port's monolithic loops (codes and lengths
equal, captured latents within 1e-5: the shorter cache changes only the
order of float32 sums) and against JAX generate_speech_segmented /
generate_speech_beam_segmented (greedy, token for token), the early exit
between segments, and the engine's route at max_mel_tokens >= 320. Tiny
weights (tests/test_torch_beam.py's fixture), float32 on the CPU, small
segments."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import indextts_tpu.models.gpt_decode as jdec
import indextts_tpu_torch.models.gpt_decode as tdec
from indextts_tpu_torch.models.gpt import UnifiedVoice
from indextts_tpu_torch.weights import load_jax_params
from tests.test_torch_beam import LENS, TEXT, _t, setup  # noqa: F401  (setup is the fixture)

LAT_TOL = 1e-5


def _with_stop_bias(setup, stop_bias):
    """The fixture's weights with the stop logit raised by `stop_bias` (the
    fixture raises it by 2.0, which stops greedy decodes at once): (JAX
    params, port model)."""
    cfg, params, _, _ = setup
    bias = params["mel_head"]["bias"].at[cfg.stop_mel_token].add(stop_bias - 2.0)
    p2 = dict(params, mel_head=dict(params["mel_head"], bias=bias))
    model = UnifiedVoice(cfg)
    load_jax_params(model, p2)
    return p2, model


def _args(setup, b, stop_bias=0.0):
    cfg, _, _, conds = setup
    _, model = _with_stop_bias(setup, stop_bias)
    return model, cfg, _t(np.repeat(conds, b, 0)), _t(TEXT[:b]), _t(LENS[:b])


def _jargs(setup, b, stop_bias=0.0):
    cfg, _, _, conds = setup
    params, _ = _with_stop_bias(setup, stop_bias)
    return params, cfg, jnp.asarray(np.repeat(conds, b, 0)), jnp.asarray(TEXT[:b]), jnp.asarray(LENS[:b])


@pytest.mark.parametrize("quant_kv", [False, True])
def test_grow_cache(setup, quant_kv):
    model, cfg, conds, text, lens = _args(setup, 2)
    gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=12)
    p = conds.shape[1] + text.shape[1] + 3
    with torch.no_grad():
        state, ctx = tdec.prefill_decode_state(model, cfg, gen, conds, text, lens, torch.Generator(),
                                               quant_kv=quant_kv, cache_len=p + 4)
    assert len(state.cache) == (4 if quant_kv else 2)
    assert all(c.shape[3] == p + 4 for c in state.cache) and ctx.prefill_valid.shape == (2, p + 4)
    before = [c.clone() for c in state.cache]
    valid = ctx.prefill_valid.clone()
    tdec.grow_cache(state, ctx, 5)
    for old, new in zip(before, state.cache):
        assert new.shape[3] == p + 9 and new.shape[:3] == old.shape[:3] and new.dtype == old.dtype
        np.testing.assert_array_equal(new[:, :, :, : p + 4].numpy(), old.numpy())
        assert not new[:, :, :, p + 4 :].any()
    np.testing.assert_array_equal(ctx.prefill_valid[:, : p + 4].numpy(), valid.numpy())
    assert not ctx.prefill_valid[:, p + 4 :].any()
    if quant_kv:  # int8 data [L, B, H, S, Dh], one float32 scale per head pair and slot
        assert state.cache[0].dtype == torch.int8 and state.cache[1].shape[2] * 2 == state.cache[0].shape[2]


@pytest.mark.parametrize("quant_kv", [False, True])
@pytest.mark.parametrize("do_sample,stop_bias", [(False, 0.0), (False, 1.5), (True, 0.0)])
def test_segmented_matches_monolithic(setup, do_sample, stop_bias, quant_kv):
    """Greedy (to the budget of 20 codes, and with a raised stop logit that
    ends the rows in the second segment), and sampled from equal generator
    seeds; batch of 2 rows of different text lengths; segments of 6 (the last
    one short)."""
    model, cfg, conds, text, lens = _args(setup, 2, stop_bias)
    gen = tdec.GenerationConfig(do_sample=do_sample, top_k=30, max_new_tokens=20)
    kw = dict(quant_kv=quant_kv, capture_latents=True, pos_off=2, repetition_penalty=1.0)
    a = tdec.generate_speech(model, cfg, gen, conds, text, lens, torch.Generator().manual_seed(3), **kw)
    stats = {}
    b = tdec.generate_speech_segmented(model, cfg, gen, conds, text, lens, torch.Generator().manual_seed(3),
                                       segment=6, stats=stats, **kw)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    np.testing.assert_allclose(a[2].numpy(), b[2].numpy(), atol=LAT_TOL, rtol=0)
    assert stats["segments"] == min(4, -(-int(a[1].max()) // 6))
    assert int(a[1].max()) > 7  # more than one segment ran
    assert (stats["segments"] < 4) == (stop_bias == 1.5)


@pytest.mark.parametrize("quant_kv", [False, True])
def test_segmented_matches_jax_segmented(setup, quant_kv):
    model, cfg, conds, text, lens = _args(setup, 2)
    gen = dict(do_sample=False, max_new_tokens=20)
    params, jcfg, jconds, jtext, jlens = _jargs(setup, 2)
    gold = jdec.generate_speech_segmented(params, jcfg, jdec.GenerationConfig(**gen), jconds, jtext, jlens,
                                          jax.random.PRNGKey(0), segment=6, quant_kv=quant_kv)
    mine = tdec.generate_speech_segmented(model, cfg, tdec.GenerationConfig(**gen), conds, text, lens,
                                          torch.Generator(), segment=6, quant_kv=quant_kv)
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(gold[0]))
    np.testing.assert_array_equal(mine[1].numpy(), np.asarray(gold[1]))
    assert int(mine[1].max()) > 7


def test_early_exit_skips_segments(setup):
    """A mel head that always emits stop: every row stops in segment 0 and no
    later segment runs (tests/test_segmented.py's case)."""
    cfg, params, _, conds = setup
    bias = np.zeros(cfg.number_mel_codes, np.float32)
    bias[cfg.stop_mel_token] = 5.0
    p2 = dict(params, mel_head={"weight": jnp.zeros_like(params["mel_head"]["weight"]), "bias": jnp.asarray(bias)})
    model = UnifiedVoice(cfg)
    load_jax_params(model, p2)
    gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=40)
    stats = {}
    codes, lengths = tdec.generate_speech_segmented(model, cfg, gen, _t(conds), _t(TEXT[:1]), _t(LENS[:1]),
                                                    torch.Generator(), segment=8, stats=stats)
    assert stats["segments"] == 1 and int(lengths[0]) <= 8
    assert (codes < cfg.number_mel_codes).all()
    bstats = {}
    gen_b = dataclasses.replace(gen, num_beams=2)
    tdec.generate_speech_beam_segmented(model, cfg, gen_b, _t(conds), _t(TEXT[:1]), _t(LENS[:1]), torch.Generator(),
                                        segment=8, stats=bstats)
    assert bstats["segments"] == 1 and bstats["steps"] < 8


@pytest.mark.parametrize("quant_kv", [False, True])
@pytest.mark.parametrize("nb,stop_bias", [(2, 1.0), (3, 1.0), (3, 1.5)])
def test_beam_segmented_matches_monolithic_and_jax(setup, nb, stop_bias, quant_kv):
    """Greedy beams: the segmented loop == the port's generate_speech_beam
    (codes, lengths, captured latents, steps) == JAX
    generate_speech_beam_segmented, token for token. Stop bias 1.0: one row
    finishes a hypothesis in the first segment (its latents are snapshotted
    there and grow with the buffer) while the other runs to the budget; 1.5:
    the admissible bound ends the search in the second segment and the host
    skips the rest."""
    model, cfg, conds, text, lens = _args(setup, 2, stop_bias)
    gen = dict(do_sample=False, num_beams=nb, max_new_tokens=16)
    kw = dict(quant_kv=quant_kv, length_penalty=1.0, repetition_penalty=2.0)
    s_mono, s_seg = {}, {}
    a = tdec.generate_speech_beam(model, cfg, tdec.GenerationConfig(**gen), conds, text, lens, torch.Generator(),
                                  capture_latents=True, pos_off=2, stats=s_mono, **kw)
    b = tdec.generate_speech_beam_segmented(model, cfg, tdec.GenerationConfig(**gen), conds, text, lens,
                                            torch.Generator(), capture_latents=True, pos_off=2, segment=5,
                                            stats=s_seg, **kw)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    assert b[2].shape == a[2].shape
    np.testing.assert_allclose(a[2].numpy(), b[2].numpy(), atol=LAT_TOL, rtol=0)
    assert s_seg["steps"] == s_mono["steps"] and s_seg["segments"] == min(4, -(-(s_mono["steps"] + 1) // 5))
    params, jcfg, jconds, jtext, jlens = _jargs(setup, 2, stop_bias)
    gold = jdec.generate_speech_beam_segmented(params, jcfg, jdec.GenerationConfig(**gen), jconds, jtext, jlens,
                                               jax.random.PRNGKey(0), segment=5, pos_off=2, **kw)
    np.testing.assert_array_equal(b[0].numpy(), np.asarray(gold[0]))
    np.testing.assert_array_equal(b[1].numpy(), np.asarray(gold[1]))
    assert s_seg["steps"] > 5  # more than one segment ran
    assert (s_seg["segments"] < 4) == (stop_bias == 1.5)


def test_sampled_beam_segmented_matches_monolithic(setup):
    """Sampled beams from equal generator seeds: the segments change no draw."""
    model, cfg, conds, text, lens = _args(setup, 1, 1.0)
    gen = tdec.GenerationConfig(do_sample=True, num_beams=3, top_k=30, max_new_tokens=16)
    a = tdec.generate_speech_beam(model, cfg, gen, conds, text, lens, torch.Generator().manual_seed(5))
    b = tdec.generate_speech_beam_segmented(model, cfg, gen, conds, text, lens, torch.Generator().manual_seed(5),
                                            segment=4)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


@pytest.mark.parametrize("num_beams,max_mel,want", [(1, 320, "generate_speech_segmented"),
                                                    (3, 320, "generate_speech_beam_segmented"),
                                                    (1, 319, "generate_speech"), (3, 319, "generate_speech_beam")])
def test_engine_routes_long_requests_to_the_segmented_loops(tmp_path, monkeypatch, num_beams, max_mel, want):
    """The engine's _gpt_generate: max_mel_tokens >= 2 * 160 takes the
    segmented loops with segment 160 (as indextts_tpu/engine.py), anything
    shorter the monolithic loops; gpt_steps still counts the steps run."""
    from indextts_tpu_torch import engine as engine_mod
    from indextts_tpu_torch.config import save_config
    from tests.test_engine import tiny_config

    base = tiny_config()
    cfg = dataclasses.replace(base, gpt=dataclasses.replace(base.gpt, max_mel_tokens=320))
    cfg_path = str(tmp_path / "config.yaml")
    save_config(cfg, cfg_path)
    engine = engine_mod.IndexTTS(cfg_path=cfg_path, model_dir=str(tmp_path), is_fp16=False, device="cpu",
                                 allow_random_init=True)
    with torch.no_grad():  # stop wins early, so the 320-code budget costs a few steps
        engine.gpt.mel_head.bias[engine.stop_mel_token] += 3.0
    called = []
    for name in ("generate_speech", "generate_speech_beam", "generate_speech_segmented",
                 "generate_speech_beam_segmented"):
        fn = getattr(engine_mod, name)
        monkeypatch.setattr(engine_mod, name,
                            lambda *a, _fn=fn, _name=name, **k: called.append((_name, k.get("segment"))) or _fn(*a, **k))
    mel = np.random.default_rng(0).standard_normal((1, 100, 60)).astype(np.float32)
    sr, wav = engine.infer(mel, "HELLO WORLD.", do_sample=False, num_beams=num_beams, max_mel_tokens=max_mel)
    assert called == [(want, 160 if "segmented" in want else None)]
    assert engine.last_stats["gpt_steps"] >= 0 and wav.shape[0] % engine._samples_per_code() == 0
