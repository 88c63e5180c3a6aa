"""GPT parity: the port's prefill, KV-cached greedy / sampled decode and
teacher-forced latents against indextts_tpu on the same JAX-initialized
weights, float32 on the CPU.

Greedy codes must equal JAX generate_speech and the JAX full-recompute
oracle token for token. Sampled decode cannot share RNG bits, so both
decoders draw from one recorded uniform stream by inverse CDF: JAX's
sample_token is monkeypatched in this test only. Logits and latents agree
within 1e-4 absolute."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import indextts_tpu.models.gpt_decode as jdec
from indextts_tpu.models.gpt import get_conditioning as jax_get_conditioning
from indextts_tpu.models.gpt import init_unified_voice
from indextts_tpu.models.gpt import unified_voice_forward as jax_forward
import indextts_tpu_torch.models.gpt_decode as tdec
from indextts_tpu_torch.models.gpt import UnifiedVoice, unified_voice_forward
from indextts_tpu_torch.ops.sampling import inverse_cdf_token
from indextts_tpu_torch.weights import load_jax_params
from tests.test_gpt import oracle_generate, tiny_cfg

TOL = 1e-4
rng = np.random.default_rng(17)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    params = init_unified_voice(jax.random.PRNGKey(0), cfg)
    # sharper mel head than the 0.02 init, so decodes run for several tokens
    # before stopping and the logits are far from ties
    params["mel_head"]["weight"] = jnp.asarray(
        rng.standard_normal(params["mel_head"]["weight"].shape).astype(np.float32) * 0.3)
    model = UnifiedVoice(cfg)
    load_jax_params(model, params)
    mel = rng.standard_normal((1, 40, 100)).astype(np.float32)
    conds = np.asarray(jax_get_conditioning(params, cfg, jnp.asarray(mel), jnp.asarray([40])))
    return cfg, params, model, conds


TEXT = np.asarray([[5, 6, 7, 8, 9, 1, 1, 1]], np.int32)
LENS = np.asarray([5], np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long() if np.asarray(a).dtype.kind in "iu" else torch.from_numpy(a)


def test_prefill_logits_match(setup):
    cfg, params, model, conds = setup
    text = np.asarray([[5, 6, 7, 8, 9, 1, 1, 1], [11, 12, 13, 1, 1, 1, 1, 1]], np.int32)
    lens = np.asarray([5, 3], np.int32)
    conds2 = np.repeat(conds, 2, axis=0)
    emb_j, mask_j = jdec.prepare_gpt_inputs(params, cfg, jnp.asarray(conds2), jnp.asarray(text), jnp.asarray(lens))
    logits_j, _ = jdec._prefill(params, cfg, emb_j, mask_j, emb_j.shape[1] + 4)
    with torch.no_grad():
        emb_t, mask_t = tdec.prepare_gpt_inputs(model, cfg, _t(conds2), _t(text), _t(lens))
        logits_t, (k, v) = tdec._prefill(model, cfg, emb_t, mask_t, emb_t.shape[1] + 4)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=TOL, rtol=0)
    assert k.shape == (cfg.layers, 2, cfg.heads, emb_t.shape[1] + 4, cfg.head_dim)


def _jax_codes(setup, gen, text=TEXT, lens=LENS, b=1, **kw):
    """gen: GenerationConfig fields shared by both packages."""
    cfg, params, _, conds = setup
    codes, lengths = jdec.generate_speech(params, cfg, jdec.GenerationConfig(**gen),
                                          jnp.asarray(np.repeat(conds, b, 0)), jnp.asarray(text),
                                          jnp.asarray(lens), jax.random.PRNGKey(0), **kw)
    return np.asarray(codes), np.asarray(lengths)


def _port_codes(setup, gen, text=TEXT, lens=LENS, b=1, **kw):
    cfg, _, model, conds = setup
    codes, lengths = tdec.generate_speech(model, cfg, tdec.GenerationConfig(**gen),
                                          _t(np.repeat(conds, b, 0)), _t(text), _t(lens),
                                          torch.Generator().manual_seed(0), **kw)
    return codes.numpy(), lengths.numpy()


@pytest.mark.parametrize("penalty", [1.0, 10.0])
def test_greedy_codes_match_jax_generate_speech(setup, penalty):
    gen = dict(do_sample=False, max_new_tokens=16)
    gold_codes, gold_lens = _jax_codes(setup, gen, repetition_penalty=penalty)
    codes, lens = _port_codes(setup, gen, repetition_penalty=penalty)
    assert gold_lens[0] > 3  # a real decode, not an immediate stop
    np.testing.assert_array_equal(codes, gold_codes)
    np.testing.assert_array_equal(lens, gold_lens)


def test_greedy_codes_match_full_recompute_oracle(setup):
    cfg, params, _, conds = setup
    gen = dict(do_sample=False, max_new_tokens=12)
    gold = oracle_generate(params, cfg, jnp.asarray(conds), jnp.asarray(TEXT), jnp.asarray(LENS), 12)
    codes, _ = _port_codes(setup, gen, repetition_penalty=1.0)
    np.testing.assert_array_equal(codes, gold)


def test_greedy_padding_and_batch_invariance(setup):
    """Same text at another padded width, and inside a batch beside another
    row, decodes to the same codes."""
    gen = dict(do_sample=False, max_new_tokens=12)
    solo, _ = _port_codes(setup, gen)
    wide = np.full((1, 16), 1, np.int32)
    wide[0, :5] = TEXT[0, :5]
    padded, _ = _port_codes(setup, gen, text=wide)
    np.testing.assert_array_equal(padded, solo)
    batch_text = np.asarray([[20, 21, 22, 23, 24, 25, 26, 27], TEXT[0]], np.int32)
    batch, _ = _port_codes(setup, gen, text=batch_text, lens=np.asarray([8, 5], np.int32), b=2)
    np.testing.assert_array_equal(batch[1:], solo)


def test_sampled_codes_match_on_a_shared_uniform_stream(setup, monkeypatch):
    """Both decoders sample by inverse CDF from the uniforms JAX's own keys
    give at each step (fold_in(rng, step)); the processed logits are the
    same (tests/test_torch_ops.py), so the codes must be too."""
    cfg = setup[0]
    gen = dict(do_sample=True, top_k=30, max_new_tokens=16)
    rng_key = jax.random.PRNGKey(0)
    uniforms = [np.asarray(jax.random.uniform(jax.random.fold_in(rng_key, s), (1,))) for s in range(16)]

    def jax_inverse_cdf(key, logits):
        u = jax.random.uniform(key, (logits.shape[0],))
        cdf = jnp.cumsum(jax.nn.softmax(logits.astype(jnp.float32), axis=-1), axis=-1)
        return jnp.minimum(jnp.sum(cdf <= u[:, None], axis=-1), logits.shape[-1] - 1)

    monkeypatch.setattr(jdec, "sample_token", jax_inverse_cdf)
    stream = iter(uniforms)
    monkeypatch.setattr(tdec, "sample_token", lambda logits, g: inverse_cdf_token(logits, torch.tensor(next(stream))))
    kw = dict(temperature=1.0, top_p=0.8, repetition_penalty=10.0)
    gold_codes, gold_lens = _jax_codes(setup, gen, **kw)
    codes, lens = _port_codes(setup, gen, **kw)
    assert gold_lens[0] > 3
    np.testing.assert_array_equal(codes, gold_codes)
    np.testing.assert_array_equal(lens, gold_lens)


def test_sampled_decode_reproducible_from_seed(setup):
    gen = dict(do_sample=True, top_k=30, max_new_tokens=12)
    a, _ = _port_codes(setup, gen)
    b, _ = _port_codes(setup, gen)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < setup[0].number_mel_codes)).all()


@pytest.mark.parametrize("code_lens", [[9], [9, 4]])
def test_latents_match_unified_voice_forward(setup, code_lens):
    cfg, params, model, conds = setup
    b = len(code_lens)
    text = np.repeat(np.asarray([[5, 6, 7, 8, 9, 1, 1, 1]], np.int32), b, 0)
    tlens = np.asarray([5, 3][:b], np.int32)
    codes = rng.integers(0, 64, (b, 16)).astype(np.int32)
    wav_lens = np.asarray(code_lens) * cfg.mel_length_compression
    conds_b = np.repeat(conds, b, 0)
    gold = jax_forward(params, cfg, None, jnp.asarray(text), jnp.asarray(tlens), jnp.asarray(codes),
                       jnp.asarray(wav_lens), None, return_latent=True, conds=jnp.asarray(conds_b),
                       mask_pad_keys=True)
    with torch.no_grad():
        mine = unified_voice_forward(model, cfg, _t(text), _t(tlens), _t(codes), _t(wav_lens), _t(conds_b))
    assert mine.shape == gold.shape == (b, 16, cfg.model_dim)
    np.testing.assert_allclose(mine.numpy(), np.asarray(gold), atol=TOL, rtol=0)


def test_decode_steps_resume(setup):
    """Running the loop in two calls gives the one-call codes."""
    cfg, _, model, conds = setup
    gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=12)
    whole, _ = _port_codes(setup, dict(do_sample=False, max_new_tokens=12))
    with torch.no_grad():
        state, ctx = tdec.prefill_decode_state(model, cfg, gen, _t(conds), _t(TEXT), _t(LENS), torch.Generator())
        state = tdec.decode_steps(model, cfg, state, ctx, 4)
        assert state.i == 4 or bool(state.done.all())
        state = tdec.decode_steps(model, cfg, state, ctx, 100)
    np.testing.assert_array_equal(state.codes.numpy(), whole)

