"""Conditioning parity: the port's conformer + perceiver against
indextts_tpu's get_conditioning on the same JAX-initialized weights and
numpy-seeded prompt mels, float32 on the CPU. Tolerance 1e-4 absolute (six
LayerNorms in a row amplify summation-order differences)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from indextts_tpu.models.conformer import conformer_apply
from indextts_tpu.models.gpt import get_conditioning as jax_get_conditioning
from indextts_tpu.models.gpt import init_unified_voice
from indextts_tpu_torch.models.gpt import UnifiedVoice, get_conditioning
from indextts_tpu_torch.weights import load_jax_params
from tests.test_gpt import tiny_cfg

TOL = 1e-4
rng = np.random.default_rng(13)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    params = init_unified_voice(jax.random.PRNGKey(2), cfg)
    model = UnifiedVoice(cfg)
    load_jax_params(model, params)
    return cfg, params, model


def _mel(b, t):
    return rng.standard_normal((b, t, 100)).astype(np.float32)


@pytest.mark.parametrize("lens", [[50], [50, 37], [100, 12]])
def test_conditioning_matches_jax(setup, lens):
    cfg, params, model = setup
    mel = _mel(len(lens), max(lens))
    gold = np.asarray(jax_get_conditioning(params, cfg, jnp.asarray(mel), jnp.asarray(lens)))
    with torch.no_grad():
        mine = get_conditioning(model, cfg, torch.from_numpy(mel), torch.tensor(lens)).numpy()
    assert mine.shape == gold.shape == (len(lens), cfg.condition_num_latent, cfg.model_dim)
    np.testing.assert_allclose(mine, gold, atol=TOL, rtol=0)


def test_conformer_output_and_mask_match_jax(setup):
    cfg, params, model = setup
    mel = _mel(2, 41)
    lens = [41, 20]
    gold, gold_mask = conformer_apply(params["conditioning_encoder"], cfg.condition_module, jnp.asarray(mel),
                                      jnp.asarray(lens))
    with torch.no_grad():
        mine, mask = model.conditioning_encoder(torch.from_numpy(mel), torch.tensor(lens))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(gold_mask))
    np.testing.assert_allclose(mine.numpy(), np.asarray(gold), atol=TOL, rtol=0)


def test_bridge_rejects_mismatched_shapes(setup):
    cfg, params, _ = setup
    model = UnifiedVoice(cfg)
    bad = dict(params, mel_head={"weight": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="mel_head.weight"):
        load_jax_params(model, bad)
