"""Vocoder parity: the port's ECAPA and BigVGAN generator against
indextts_tpu's ecapa_apply and bigvgan_apply on the same JAX-initialized
weights (through weights.load_jax_params) and numpy-seeded inputs, float32
on the CPU. The JAX side runs with use_pallas=False (its default composed /
phase-folded path) and use_pallas=True (the Pallas K1 in interpret mode, at
the stage with C >= 128). The port runs K1's plain version (use_cuda_kernel,
the engine default) and its composed path. Tolerance 1e-4 absolute."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from indextts_tpu.config import BigVGANConfig
from indextts_tpu.models.bigvgan import bigvgan_apply as jax_bigvgan
from indextts_tpu.models.bigvgan import init_bigvgan
from indextts_tpu.models.ecapa import ecapa_apply as jax_ecapa
from indextts_tpu.models.ecapa import init_ecapa
from indextts_tpu_torch.models.bigvgan import BigVGAN, bigvgan_apply
from indextts_tpu_torch.models.ecapa import ECAPA
from indextts_tpu_torch.weights import load_jax_params

TOL = 1e-4
rng = np.random.default_rng(21)


def vocoder_cfg() -> BigVGANConfig:
    """Two stages, the first at C = 128 so the JAX Pallas route runs too."""
    return BigVGANConfig(
        gpt_dim=16, upsample_initial_channel=256, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
        resblock="1", resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)),
        activation="snakebeta", snake_logscale=True, feat_upsample=True,
        cond_d_vector_in_each_upsampling_layer=True, num_mels=100, speaker_embedding_dim=32,
    )


def scramble(tree, rng):
    """Replace the init's near-zero conv weights, zero biases and identity
    snake parameters with draws that give O(0.1-1) signals, so that the
    comparison sees every term. Weights keep a 1/sqrt(fan-in) scale; the
    BatchNorm statistics stay as they are."""

    def go(t, name=""):
        if isinstance(t, dict):
            return {k: go(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v, name) for v in t]
        a = np.asarray(t)
        if name == "weight" and a.ndim >= 2:
            return (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        if name == "bias":
            return (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        if name in ("alpha", "beta"):
            return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return go(tree)


@pytest.fixture(scope="module")
def ecapa_setup():
    params = scramble(jax.tree_util.tree_map(np.asarray, init_ecapa(jax.random.PRNGKey(0), 100, 32)), rng)
    model = ECAPA(100, 32)
    load_jax_params(model, params)
    return params, model


@pytest.mark.parametrize("lengths", [None, [1.0, 0.55]])
def test_ecapa_matches_jax(ecapa_setup, lengths):
    params, model = ecapa_setup
    x = rng.standard_normal((2, 40, 100)).astype(np.float32)
    lj = None if lengths is None else jnp.asarray(lengths, jnp.float32)
    lt = None if lengths is None else torch.tensor(lengths)
    gold = np.asarray(jax_ecapa(params, jnp.asarray(x), lj))
    with torch.no_grad():
        mine = model(torch.from_numpy(x), lt).numpy()
    assert mine.shape == gold.shape == (2, 1, 32)
    np.testing.assert_allclose(mine, gold, atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def vocoder_setup():
    h = vocoder_cfg()
    params = scramble(jax.tree_util.tree_map(np.asarray, init_bigvgan(jax.random.PRNGKey(1), h)), rng)
    model = BigVGAN(h)
    load_jax_params(model, params)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    mel = rng.standard_normal((2, 40, 100)).astype(np.float32)
    lens = np.asarray([1.0, 0.7], np.float32)
    with torch.no_grad():
        kernel = bigvgan_apply(model, h, torch.from_numpy(x), torch.from_numpy(mel), torch.from_numpy(lens))
        composed = bigvgan_apply(model, h, torch.from_numpy(x), torch.from_numpy(mel), torch.from_numpy(lens),
                                 use_cuda_kernel=False)
    return h, params, (x, mel, lens), kernel.numpy(), composed.numpy()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bigvgan_matches_jax(vocoder_setup, use_pallas):
    h, params, (x, mel, lens), kernel, composed = vocoder_setup
    gold = np.asarray(jax_bigvgan(params, h, jnp.asarray(x), jnp.asarray(mel), jnp.asarray(lens),
                                  use_pallas=use_pallas))
    assert kernel.shape == gold.shape == (2, 8 * 4 * 4, 1)
    assert np.abs(gold).max() > 0.05  # the comparison sees a real signal
    np.testing.assert_allclose(kernel, gold, atol=TOL, rtol=0)
    np.testing.assert_allclose(composed, gold, atol=TOL, rtol=0)


def test_speaker_embedding_cast_to_trunk_dtype(vocoder_setup):
    """A bf16 trunk stays bf16: the f32 ECAPA output is cast before the
    conditioning adds (the JAX hazard at bigvgan.py:357-361)."""
    h, params, (x, mel, lens), _, _ = vocoder_setup
    model = BigVGAN(h)
    load_jax_params(model, params)
    model.to(torch.bfloat16)
    with torch.no_grad():
        wav = bigvgan_apply(model, h, torch.from_numpy(x).bfloat16(), torch.from_numpy(mel).bfloat16(),
                            torch.from_numpy(lens))
    assert wav.dtype == torch.bfloat16
    assert torch.isfinite(wav.float()).all()
