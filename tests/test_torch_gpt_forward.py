"""The rest of the port's teacher-forced pass against indextts_tpu's
unified_voice_forward on the same JAX-initialized tiny weights, float32 on
the CPU: return_latent=False (text and mel losses, mel_logits [B, V, T]),
text_first=False, types, mask_pad_keys both ways and conds=None; the mel
encoder. Values within 1e-4 absolute.

The engine's latent call (conds given, mask_pad_keys=True) must stay bit
for bit what it was before the signature grew: a copy of that earlier
function is kept here as the reference."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from indextts_tpu.config import GPTConfig
from indextts_tpu.models.gpt import get_conditioning as jax_get_conditioning
from indextts_tpu.models.gpt import init_mel_encoder, init_unified_voice, mel_encoder_apply
from indextts_tpu.models.gpt import unified_voice_forward as jax_forward
from indextts_tpu_torch.models.gpt import (MelEncoder, UnifiedVoice, _ln, gpt2_apply, set_padding,
                                           unified_voice_forward)
from indextts_tpu_torch.weights import load_jax_params
from tests.test_gpt import tiny_cfg

TOL = 1e-4
rng = np.random.default_rng(41)

TEXT = np.asarray([[5, 6, 7, 8, 9, 1, 1, 1], [11, 12, 13, 14, 15, 16, 17, 18]], np.int64)
TLENS = np.asarray([5, 8], np.int64)
CODE_LENS = np.asarray([9, 14])


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    params = init_unified_voice(jax.random.PRNGKey(4), cfg)
    # heads far from the 0.02 init, so the losses and logits are not near-uniform
    for head in ("mel_head", "text_head"):
        params[head]["weight"] = jnp.asarray(rng.standard_normal(params[head]["weight"].shape).astype(np.float32) * 0.3)
    model = UnifiedVoice(cfg)
    load_jax_params(model, params)
    mel = rng.standard_normal((2, 40, 100)).astype(np.float32)
    mel_lens = np.asarray([40, 31])
    conds = np.array(jax_get_conditioning(params, cfg, jnp.asarray(mel), jnp.asarray(mel_lens)))
    codes = rng.integers(0, 64, (2, 16))
    return cfg, params, model, mel, mel_lens, conds, codes


def _port(setup, **kw):
    cfg, _, model, mel, mel_lens, conds, codes = setup
    wav = torch.from_numpy(CODE_LENS * cfg.mel_length_compression)
    kw = {"speech_conditioning_mel": None, "cond_mel_lengths": None, **kw}
    with torch.no_grad():
        return unified_voice_forward(model, cfg, text_inputs=torch.from_numpy(TEXT),
                                     text_lengths=torch.from_numpy(TLENS), mel_codes=torch.from_numpy(codes),
                                     wav_lengths=wav, **kw)


def _jax_call(setup, conds_given: bool, **kw):
    cfg, params, _, mel, mel_lens, conds, codes = setup
    wav = CODE_LENS * cfg.mel_length_compression
    fn = jax.jit(lambda p, c, *a: jax_forward(p, cfg, *a, conds=c, **kw))  # one compile, not one per op
    return fn(params, jnp.asarray(conds) if conds_given else None, jnp.asarray(mel), jnp.asarray(TEXT),
              jnp.asarray(TLENS), jnp.asarray(codes), jnp.asarray(wav), jnp.asarray(mel_lens))


def _port_kw(setup, conds_given: bool):
    _, _, _, mel, mel_lens, conds, _ = setup
    if conds_given:
        return dict(conds=torch.from_numpy(conds))
    return dict(speech_conditioning_mel=torch.from_numpy(mel), cond_mel_lengths=torch.from_numpy(mel_lens))


@pytest.mark.parametrize("mask_pad_keys", [False, True])
@pytest.mark.parametrize("text_first", [True, False])
def test_losses_and_logits_match_jax(setup, text_first, mask_pad_keys):
    gold = _jax_call(setup, True, return_latent=False, text_first=text_first, mask_pad_keys=mask_pad_keys)
    mine = _port(setup, **_port_kw(setup, True), return_latent=False, text_first=text_first,
                 mask_pad_keys=mask_pad_keys)
    cfg = setup[0]
    assert mine[2].shape == gold[2].shape == (2, cfg.number_mel_codes, 16 + 2)
    np.testing.assert_allclose(mine[2].numpy(), np.asarray(gold[2]), atol=TOL, rtol=0)
    for m, g in zip(mine[:2], gold[:2]):
        assert m.dim() == 0 and np.isfinite(float(m))
        np.testing.assert_allclose(float(m), float(g), atol=TOL, rtol=0)


def test_mask_pad_keys_changes_the_padded_rows(setup):
    """Row 0 has bucket padding (5 of 8 text tokens, 9 of 16 codes): its
    logits move with the mask; the losses follow JAX either way (above)."""
    a = _port(setup, **_port_kw(setup, True), return_latent=False, mask_pad_keys=False)[2]
    b = _port(setup, **_port_kw(setup, True), return_latent=False, mask_pad_keys=True)[2]
    assert np.abs(a[0].numpy() - b[0].numpy()).max() > 1e-4


@pytest.mark.parametrize("return_latent", [True, False])
def test_conds_none_computes_the_conditioning(setup, return_latent):
    gold = _jax_call(setup, False, return_latent=return_latent, mask_pad_keys=True)
    mine = _port(setup, **_port_kw(setup, False), return_latent=return_latent, mask_pad_keys=True)
    for m, g in zip(mine if not return_latent else [mine], gold if not return_latent else [gold]):
        np.testing.assert_allclose(np.asarray(m), np.asarray(g), atol=TOL, rtol=0)


@pytest.mark.parametrize("text_first", [True, False])
def test_latents_either_order_match_jax(setup, text_first):
    gold = _jax_call(setup, True, return_latent=True, text_first=text_first, mask_pad_keys=True)
    mine = _port(setup, **_port_kw(setup, True), return_latent=True, text_first=text_first, mask_pad_keys=True)
    assert mine.shape == gold.shape
    np.testing.assert_allclose(mine.numpy(), np.asarray(gold), atol=TOL, rtol=0)


def test_types_match_jax():
    """types [B] moves each row's text into its own embedding range
    (model.py:541-543): a config of two types."""
    cfg = GPTConfig(**{**tiny_cfg().__dict__, "types": 2})
    params = init_unified_voice(jax.random.PRNGKey(9), cfg)
    model = UnifiedVoice(cfg)
    load_jax_params(model, params)
    conds = rng.standard_normal((2, cfg.condition_num_latent, cfg.model_dim)).astype(np.float32)
    codes = rng.integers(0, 64, (2, 16))
    types = np.asarray([0, 1])
    wav = CODE_LENS * cfg.mel_length_compression
    gold = jax_forward(params, cfg, None, jnp.asarray(TEXT), jnp.asarray(TLENS), jnp.asarray(codes),
                       jnp.asarray(wav), None, return_latent=False, conds=jnp.asarray(conds),
                       types=jnp.asarray(types))
    with torch.no_grad():
        mine = unified_voice_forward(model, cfg, speech_conditioning_mel=None, text_inputs=torch.from_numpy(TEXT),
                                     text_lengths=torch.from_numpy(TLENS), mel_codes=torch.from_numpy(codes),
                                     wav_lengths=torch.from_numpy(wav), cond_mel_lengths=None,
                                     conds=torch.from_numpy(conds), return_latent=False, types=torch.from_numpy(types),
                                     mask_pad_keys=False)
    for m, g in zip(mine, gold):
        np.testing.assert_allclose(np.asarray(m), np.asarray(g), atol=TOL, rtol=0)


def _latents_before(model, cfg, text_inputs, text_lengths, mel_codes, wav_lengths, conds):
    """The port's unified_voice_forward as it was before return_latent=False
    and the other options were added (always masked, latents only)."""

    def frame(tokens, start, stop):
        b = tokens.shape[0]
        return torch.cat([tokens.new_full((b, 1), start), tokens, tokens.new_full((b, 1), stop)], dim=1)

    mel_code_lengths = (wav_lengths + cfg.mel_length_compression - 1) // cfg.mel_length_compression + 1
    mel_codes = set_padding(mel_codes, mel_code_lengths, cfg.stop_mel_token)
    text_inputs = set_padding(text_inputs, text_lengths, cfg.stop_text_token)
    text_in = frame(text_inputs, cfg.start_text_token, cfg.stop_text_token)
    mel_in = frame(mel_codes, cfg.start_mel_token, cfg.stop_mel_token)
    text_emb = model.text_embedding[text_in] + model.text_pos_embedding[: text_in.shape[1]][None]
    mel_emb = model.mel_embedding[mel_in] + model.mel_pos_embedding[: mel_in.shape[1]][None]
    emb = torch.cat([conds.to(text_emb.dtype), text_emb, mel_emb], dim=1)
    b, dev = emb.shape[0], emb.device
    text_ok = torch.arange(text_in.shape[1], device=dev)[None, :] < (text_lengths + 2)[:, None]
    mel_ok = torch.arange(mel_in.shape[1], device=dev)[None, :] < (mel_code_lengths + 1)[:, None]
    mask = torch.cat([torch.ones(b, conds.shape[1], dtype=torch.bool, device=dev), text_ok, mel_ok], dim=1)
    hidden = gpt2_apply(model.gpt, emb, cfg.heads, attention_mask=mask)
    enc = _ln(model.final_norm, hidden[:, conds.shape[1]:])
    return enc[:, -mel_emb.shape[1]:][:, :-2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_engine_latent_call_bit_identical_to_before(setup, dtype):
    cfg, _, model, _, _, conds, codes = setup
    args = (torch.from_numpy(TEXT), torch.from_numpy(TLENS), torch.from_numpy(codes),
            torch.from_numpy(CODE_LENS * cfg.mel_length_compression))
    m = UnifiedVoice(cfg)
    m.load_state_dict(model.state_dict())
    m.to(dtype)
    c = torch.from_numpy(conds).to(dtype)
    with torch.no_grad():
        before = _latents_before(m, cfg, *args, c)
        engine_call = unified_voice_forward(m, cfg, None, *args, None, conds=c, mask_pad_keys=True)
        positional = unified_voice_forward(m, cfg, None, *args, None, True, True, c, None, True)
    assert torch.equal(engine_call, before) and torch.equal(positional, before)


def test_positional_call_of_graft_entry_matches_jax(setup):
    """The argument list of __graft_entry__.dryrun_multichip's loss
    (params, cfg, mel, text, text_lens, codes, wav_lens, mel_lens,
    return_latent=False), positionally, through both functions: JAX's
    order and defaults (mask_pad_keys off), losses within 1e-4."""
    cfg, params, model, mel, mel_lens, _, codes = setup
    wav = CODE_LENS * cfg.mel_length_compression
    args = (mel, TEXT, TLENS, codes, wav, mel_lens)
    gold = jax.jit(lambda p, *a: jax_forward(p, cfg, *a, return_latent=False))(params, *map(jnp.asarray, args))
    with torch.no_grad():
        mine = unified_voice_forward(model, cfg, *map(torch.from_numpy, args), return_latent=False)
    for m, g in zip(mine[:2], gold[:2]):
        np.testing.assert_allclose(float(m), float(g), atol=1e-4, rtol=0)
    np.testing.assert_allclose(mine[2].numpy(), np.asarray(gold[2]), atol=TOL, rtol=0)


@pytest.mark.parametrize("channels,mel_channels,resblocks", [(64, 80, 1), (128, 100, 2)])
def test_mel_encoder_matches_jax(channels, mel_channels, resblocks):
    params = init_mel_encoder(jax.random.PRNGKey(channels), channels, mel_channels, resblocks)
    # GroupNorm affine away from the identity
    for name in ("gn_a", "gn_b"):
        c = params[name]["weight"].shape[0]
        params[name] = {"weight": jnp.asarray(1 + 0.2 * rng.standard_normal(c).astype(np.float32)),
                        "bias": jnp.asarray(0.2 * rng.standard_normal(c).astype(np.float32))}
    enc = MelEncoder(channels, mel_channels, resblocks)
    load_jax_params(enc, params)
    mel = rng.standard_normal((2, 36, mel_channels)).astype(np.float32)
    gold = np.asarray(jax.jit(lambda p, x: mel_encoder_apply(p, x, channels))(params, jnp.asarray(mel)))
    with torch.no_grad():
        mine = enc(torch.from_numpy(mel)).numpy()
    assert mine.shape == gold.shape == (2, 9, channels)
    np.testing.assert_allclose(mine, gold, atol=TOL, rtol=0)


def test_mel_encoder_init_distributions():
    enc = MelEncoder(64, 80)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    assert enc.conv_in.weight.abs().max() <= 1 / np.sqrt(80 * 3)
    assert torch.equal(enc.gn_a.weight, torch.ones(32)) and not enc.gn_b.bias.any()
    assert enc.gn_a.num_groups == 4 and enc.gn_b.num_groups == 8 and enc.res0[0].gn0.num_groups == 2
