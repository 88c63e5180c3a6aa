"""Forced input_tokens prefixes and inference_speech: the port against
indextts_tpu on the same JAX-initialized tiny weights, float32 on the CPU.
Mirrors tests/test_gpt_extras.py::TestInputTokens and ::TestInferenceSpeech.

Greedy codes and lengths must equal JAX's token for token, with and without
beams. Sampled rows cannot share RNG bits, so both decoders draw from one
recorded uniform stream (inverse CDF for num_beams = 1, Gumbel noise for
beams), as tests/test_torch_gpt.py and tests/test_torch_beam.py do."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import indextts_tpu.models.gpt_decode as jdec
from indextts_tpu.models.gpt import get_conditioning as jax_get_conditioning
from indextts_tpu.models.gpt import init_unified_voice
import indextts_tpu_torch.models.gpt_decode as tdec
from indextts_tpu_torch.models.gpt import UnifiedVoice, gpt2_apply
from indextts_tpu_torch.ops.sampling import inverse_cdf_token
from indextts_tpu_torch.weights import load_jax_params
from tests.test_gpt_extras import cfg_with

MAX_NEW = 12
TEXT = np.asarray([[5, 6, 7, 8, 9, 1, 1, 1], [11, 12, 13, 14, 15, 16, 17, 18]], np.int64)
LENS = np.asarray([5, 8], np.int64)
PREFIX = np.asarray([[3, 4, 5], [7, 7, 9]], np.int64)


@pytest.fixture(scope="module")
def setup():
    """cfg_with's tiny config, a sharper mel head and a raised stop logit, so
    that decodes run several tokens and beams finish at different lengths.
    One torch thread, as tests/test_torch_infer_fast.py:engines pins it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.default_rng(22)
    cfg = cfg_with("conformer_perceiver")
    params = init_unified_voice(jax.random.PRNGKey(0), cfg)
    params["mel_head"]["weight"] = jnp.asarray(
        rng.standard_normal(params["mel_head"]["weight"].shape).astype(np.float32) * 0.3)
    params["mel_head"]["bias"] = params["mel_head"]["bias"].at[cfg.stop_mel_token].add(1.5)
    model = UnifiedVoice(cfg)
    load_jax_params(model, params)
    mel = rng.standard_normal((1, 40, 100)).astype(np.float32)
    conds = np.array(jax_get_conditioning(params, cfg, jnp.asarray(mel), jnp.asarray([40])))
    yield cfg, params, model, conds, mel
    torch.set_num_threads(threads)


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a).long() if a.dtype.kind in "iu" else torch.from_numpy(a)


def _port(setup, b, gen, prefix, beams=False, **kw):
    cfg, _, model, conds, _ = setup
    fn = tdec.generate_speech_beam if beams else tdec.generate_speech
    out = fn(model, cfg, tdec.GenerationConfig(**gen), _t(np.repeat(conds, b, 0)), _t(TEXT[:b]), _t(LENS[:b]),
             torch.Generator().manual_seed(0), input_tokens=None if prefix is None else _t(prefix[:b]), **kw)
    return [o.numpy() for o in out]


def _both(setup, b, gen, prefix, beams=False, **kw):
    cfg, params, _, conds, _ = setup
    fn = jdec.generate_speech_beam if beams else jdec.generate_speech
    gold = fn(params, cfg, jdec.GenerationConfig(**gen), jnp.asarray(np.repeat(conds, b, 0)), jnp.asarray(TEXT[:b]),
              jnp.asarray(LENS[:b]), jax.random.PRNGKey(0),
              input_tokens=None if prefix is None else jnp.asarray(prefix[:b]), **kw)
    return _port(setup, b, gen, prefix, beams, **kw), [np.asarray(o) for o in gold]


@pytest.mark.parametrize("penalty", [1.0, 10.0])
def test_greedy_prefix_codes_match_jax(setup, penalty):
    mine, gold = _both(setup, 2, dict(do_sample=False, max_new_tokens=MAX_NEW), PREFIX, repetition_penalty=penalty)
    np.testing.assert_array_equal(mine[0], gold[0])
    np.testing.assert_array_equal(mine[1], gold[1])
    assert gold[1].max() > 3


def test_prefix_changes_generation(setup):
    gen = dict(do_sample=False, max_new_tokens=MAX_NEW)
    base, cont = _port(setup, 1, gen, None), _port(setup, 1, gen, PREFIX)
    assert cont[0].shape == base[0].shape
    assert not np.array_equal(cont[0], base[0])


def test_prefix_matches_forced_oracle(setup):
    """The cached decode with a forced prefix equals full-recompute greedy
    decoding (the port's gpt2_apply over the whole sequence each step) with
    the prefix at mel positions 1..S0 and the generated tokens at S0 + 2,
    S0 + 3, ... (the oracle of tests/test_gpt_extras.py)."""
    cfg, _, model, conds, _ = setup
    prefix, steps = _t(PREFIX[:1]), 6
    mine = _port(setup, 1, dict(do_sample=False, max_new_tokens=steps), PREFIX, repetition_penalty=1.0)
    s0 = prefix.shape[1]
    with torch.no_grad():
        emb0, mask0 = tdec.prepare_gpt_inputs(model, cfg, _t(conds), _t(TEXT[:1]), _t(LENS[:1]))
        embs = [emb0, model.mel_embedding[prefix] + model.mel_pos_embedding[1 : s0 + 1][None]]
        for t in range(steps):
            emb = torch.cat(embs, dim=1)
            mask = torch.cat([mask0, torch.ones(1, emb.shape[1] - mask0.shape[1], dtype=torch.bool)], dim=1)
            hidden = gpt2_apply(model.gpt, emb, cfg.heads, attention_mask=mask)
            tok = int(tdec._mel_logits(model, hidden[:, -1]).argmax(-1)[0])
            assert mine[0][0, t] == tok
            if tok == cfg.stop_mel_token:
                break
            embs.append((model.mel_embedding[tok] + model.mel_pos_embedding[s0 + 2 + t])[None, None])
    assert t >= 3


def test_prefix_tokens_join_the_seen_set(setup):
    cfg = setup[0]
    state, ctx = tdec.prefill_decode_state(setup[2], cfg, tdec.GenerationConfig(do_sample=False, max_new_tokens=4),
                                           _t(np.repeat(setup[3], 2, 0)), _t(TEXT), _t(LENS), torch.Generator(),
                                           input_tokens=_t(PREFIX))
    assert ctx.s0 == 3 and ctx.p == setup[3].shape[1] + TEXT.shape[1] + 3 + 3
    for r in range(2):
        assert state.seen[r, PREFIX[r]].all() and state.seen[r, [1, cfg.start_mel_token]].all()


def test_prefix_decode_resumes_in_two_calls(setup):
    """prefill_decode_state + decode_steps in two calls give generate_speech's
    codes with a prefix (the shift travels in ctx.s0)."""
    cfg, _, model, conds, _ = setup
    gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=MAX_NEW)
    whole = _port(setup, 2, dict(do_sample=False, max_new_tokens=MAX_NEW), PREFIX)
    with torch.no_grad():
        state, ctx = tdec.prefill_decode_state(model, cfg, gen, _t(np.repeat(conds, 2, 0)), _t(TEXT), _t(LENS),
                                               torch.Generator(), input_tokens=_t(PREFIX))
        state = tdec.decode_steps(model, cfg, state, ctx, 4)
        state = tdec.decode_steps(model, cfg, state, ctx, 100)
    np.testing.assert_array_equal(state.codes.numpy(), whole[0])


def test_sampled_prefix_codes_match_on_a_shared_uniform_stream(setup, monkeypatch):
    key = jax.random.PRNGKey(0)
    uniforms = [np.asarray(jax.random.uniform(jax.random.fold_in(key, s), (2,))) for s in range(MAX_NEW)]

    def jax_inverse_cdf(k, logits):
        u = jax.random.uniform(k, (logits.shape[0],))
        cdf = jnp.cumsum(jax.nn.softmax(logits.astype(jnp.float32), axis=-1), axis=-1)
        return jnp.minimum(jnp.sum(cdf <= u[:, None], axis=-1), logits.shape[-1] - 1)

    monkeypatch.setattr(jdec, "sample_token", jax_inverse_cdf)
    stream = iter(uniforms)
    monkeypatch.setattr(tdec, "sample_token", lambda logits, g: inverse_cdf_token(logits, torch.tensor(next(stream))))
    mine, gold = _both(setup, 2, dict(do_sample=True, top_k=30, max_new_tokens=MAX_NEW), PREFIX,
                       temperature=1.0, top_p=0.8, repetition_penalty=10.0)
    np.testing.assert_array_equal(mine[0], gold[0])
    np.testing.assert_array_equal(mine[1], gold[1])


def test_greedy_beam_prefix_codes_match_jax(setup):
    gen = dict(do_sample=False, num_beams=3, max_new_tokens=MAX_NEW)
    mine, gold = _both(setup, 2, gen, PREFIX, beams=True)
    np.testing.assert_array_equal(mine[0], gold[0])
    np.testing.assert_array_equal(mine[1], gold[1])
    base = _port(setup, 2, gen, None, beams=True)
    assert not (np.array_equal(base[0], mine[0]) and np.array_equal(base[1], mine[1]))


def test_sampled_beam_prefix_codes_match_on_a_shared_uniform_stream(setup, monkeypatch):
    cfg = setup[0]
    nb, b = 3, 2
    stream = np.random.default_rng(16).random((MAX_NEW, b, nb * cfg.number_mel_codes)).astype(np.float32)

    def jax_select(logp_joint, key, step, gen, nb_):
        u = jnp.take(jnp.asarray(stream), step, axis=0)
        g = -jnp.log(-jnp.log(u + 1e-20) + 1e-20)
        _, idx = jax.lax.top_k(logp_joint + g, 2 * nb_)
        vals = jnp.take_along_axis(logp_joint, idx, axis=1)
        order = jnp.argsort(-vals, axis=1)
        return jnp.take_along_axis(vals, order, axis=1), jnp.take_along_axis(idx, order, axis=1)

    monkeypatch.setattr(jdec, "_select_successors", jax_select)
    draws = iter(stream)
    monkeypatch.setattr(tdec, "beam_uniforms", lambda shape, g, dev: torch.from_numpy(next(draws)))
    gen = dict(do_sample=True, num_beams=nb, top_k=30, max_new_tokens=MAX_NEW)
    mine, gold = _both(setup, b, gen, PREFIX, beams=True, temperature=1.0, top_p=0.8, repetition_penalty=10.0)
    np.testing.assert_array_equal(mine[0], gold[0])
    np.testing.assert_array_equal(mine[1], gold[1])


def _inference(setup, text, lens, **kw):
    cfg, params, model, _, mel = setup
    gold = jdec.inference_speech(params, cfg, jnp.asarray(mel), jnp.asarray(text), jnp.asarray(lens),
                                 rng=jax.random.PRNGKey(1),
                                 **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    mine = tdec.inference_speech(model, cfg, _t(mel), _t(text), _t(lens), generator=torch.Generator().manual_seed(1),
                                 **{k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    return [o.numpy() for o in mine], [np.asarray(o) for o in gold]


@pytest.mark.parametrize("num_beams", [1, 3])
def test_inference_speech_greedy_matches_jax(setup, num_beams):
    """Conditioning, row tiling for num_return_sequences (one prefix per
    batch row, repeated), the prefix, and the beam route."""
    mine, gold = _inference(setup, TEXT[:1], LENS[:1], input_tokens=PREFIX[:1], num_return_sequences=2,
                            do_sample=False, num_beams=num_beams, max_generate_length=MAX_NEW)
    assert mine[0].shape == gold[0].shape == (2, MAX_NEW)
    np.testing.assert_array_equal(mine[0], gold[0])
    np.testing.assert_array_equal(mine[1], gold[1])
    np.testing.assert_array_equal(mine[0][0], mine[0][1])  # greedy tiled rows are copies


def test_num_return_sequences_rows_sample_independently(setup):
    cfg, _, model, _, mel = setup
    codes, _ = tdec.inference_speech(model, cfg, _t(mel), _t(TEXT[:1]), _t(LENS[:1]), num_return_sequences=3,
                                     max_generate_length=8, generator=torch.Generator().manual_seed(7))
    assert codes.shape[0] == 3
    assert len({tuple(r) for r in codes.numpy().tolist()}) >= 2


def test_num_return_sequences_tiles_a_batch(setup):
    """b = 2 rows, 4 sequences: each row twice, in order (repeat, not tile)."""
    mine, gold = _inference(setup, TEXT, LENS, num_return_sequences=4, do_sample=False, max_generate_length=6)
    assert mine[0].shape == (4, 6)
    np.testing.assert_array_equal(mine[0], gold[0])
    np.testing.assert_array_equal(mine[0][0], mine[0][1])


def test_typical_sampling_runs(setup):
    cfg, _, model, _, mel = setup
    codes, _ = tdec.inference_speech(model, cfg, _t(mel), _t(TEXT[:1]), _t(LENS[:1]), typical_sampling=True,
                                     typical_mass=0.9, max_generate_length=6)
    c = codes.numpy()
    assert ((c >= 0) & (c < cfg.number_mel_codes)).all()


def test_num_return_sequences_divisibility_enforced(setup):
    cfg, _, model, _, mel = setup
    text = np.asarray([[5, 6, 7, 1], [6, 7, 8, 1], [7, 8, 9, 1]])
    with pytest.raises(ValueError, match="multiple"):
        tdec.inference_speech(model, cfg, _t(mel), _t(text), _t([4, 4, 4]), num_return_sequences=4,
                              max_generate_length=6)


def test_input_tokens_prefix_caps_max_new(setup):
    """With a prefix of S0 codes, max_new is capped at max_mel_tokens - 1 - S0
    (every decode position inside the positional table); a prefix that fills
    the table leaves no room and raises."""
    cfg, _, model, _, mel = setup
    codes, lengths = tdec.inference_speech(model, cfg, _t(mel), _t(TEXT[:1]), _t(LENS[:1]), input_tokens=_t(PREFIX[:1]),
                                           do_sample=False, max_generate_length=cfg.max_mel_tokens)
    assert codes.shape == (1, cfg.max_mel_tokens - 1 - PREFIX.shape[1])
    assert int(lengths[0]) <= cfg.max_mel_tokens
    with pytest.raises(ValueError, match="no room"):
        tdec.inference_speech(model, cfg, _t(mel), _t(TEXT[:1]), _t(LENS[:1]),
                              input_tokens=_t([list(range(2, 2 + cfg.max_mel_tokens))]))
