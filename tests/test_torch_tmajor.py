"""K3's plain versions and the vocoder's INDEXTTS_WIDE_TMAJOR route against
the JAX package, on the CPU.

Each body's plain version (ops/cuda/antialias_tmajor.py) must equal JAX's
fused_anti_alias_snake_tmajor in interpret mode and the composed oracle
anti_aliased_activation: float32 within 2e-5 for both bodies
(tests/test_pallas.py's tolerance), within 5e-4 with the polynomial sin; bf16
within two bf16 ulps of the largest output (both sides round the output, and
the tensor-core body its 2x-rate samples too, from float32 sums taken in
different orders; the JAX kernel also patches its outer 4 frames with the
composed path). The ident body returns x. The port's bigvgan_apply under the
switches equals JAX bigvgan_apply under the same switches within 5e-5
(test_tmajor_bigvgan_routing's tolerance) and sends exactly the activations at
C >= 128 to K3, none when INDEXTTS_WIDE_BRANCH=1 has taken the half-branches."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import indextts_tpu.models.bigvgan as jbv
from indextts_tpu.ops.antialias import anti_aliased_activation
from indextts_tpu.ops.pallas.antialias_tmajor import fused_anti_alias_snake_tmajor as jax_k3
import indextts_tpu_torch.models.bigvgan as tbv
from indextts_tpu_torch.ops.cuda import aa_conv_branch as k2
from indextts_tpu_torch.ops.cuda import antialias as k1
from indextts_tpu_torch.ops.cuda import antialias_tmajor as k3
from indextts_tpu_torch.weights import load_jax_params
from tests.test_torch_vocoder import scramble, vocoder_cfg

# (b, t, c, the JAX kernel's tile_t), from tests/test_pallas.py: T of no tile
# with the halo across blocks, C = 130 (no multiple of a channel tile), T
# shorter than a tile, a wide stage in one short block
SHAPES = [(2, 300, 24, 128), (1, 200, 130, 128), (1, 64, 8, 128), (2, 96, 192, 512)]


def _inputs(b, t, c, seed, beta=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    alpha = (rng.standard_normal(c) * 0.3).astype(np.float32)
    return x, alpha, (rng.standard_normal(c) * 0.3).astype(np.float32) if beta else None


def _port(x, alpha, beta, logscale=True, dtype=torch.float32, **kw):
    """The port's call on the trunk layout [B, C, T], back on JAX's [B, T, C]."""
    xt = torch.from_numpy(x).transpose(1, 2).contiguous().to(dtype)
    out = k3.fused_anti_alias_snake_tmajor(xt, torch.from_numpy(alpha), None if beta is None else torch.from_numpy(beta),
                                           logscale, **kw)
    return out.float().transpose(1, 2).numpy()


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("b,t,c,tile_t", SHAPES)
def test_plain_matches_jax_kernel_and_composed(b, t, c, tile_t, mxu):
    x, alpha, beta = _inputs(b, t, c, seed=t + c)
    args = (jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta))
    gold = np.asarray(anti_aliased_activation(*args, alpha_logscale=True))
    kern = np.asarray(jax_k3(*args, alpha_logscale=True, tile_t=tile_t, interpret=True, mxu=mxu))
    mine = _port(x, alpha, beta, mxu=mxu)
    assert mine.shape == gold.shape
    np.testing.assert_allclose(mine, gold, atol=2e-5, rtol=0)
    np.testing.assert_allclose(mine, kern, atol=2e-5, rtol=0)


@pytest.mark.parametrize("mxu", [False, True])
def test_plain_poly_sin_matches_composed(mxu):
    x, alpha, beta = _inputs(2, 300, 24, seed=5)
    args = (jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta))
    gold = np.asarray(anti_aliased_activation(*args, alpha_logscale=True))
    kern = np.asarray(jax_k3(*args, alpha_logscale=True, tile_t=128, interpret=True, mxu=mxu, poly_sin=True))
    mine = _port(x, alpha, beta, mxu=mxu, poly_sin=True)
    np.testing.assert_allclose(mine, gold, atol=5e-4, rtol=0)
    np.testing.assert_allclose(mine, kern, atol=2e-5, rtol=0)  # the same polynomial on both sides
    assert np.abs(mine - _port(x, alpha, beta, mxu=mxu)).max() > 1e-6  # and it is not the exact sin


@pytest.mark.parametrize("mxu", [False, True])
def test_plain_snake_without_beta(mxu):
    x, alpha, _ = _inputs(1, 200, 16, seed=9, beta=False)
    alpha = np.abs(alpha) + 0.1
    gold = np.asarray(anti_aliased_activation(jnp.asarray(x), jnp.asarray(alpha), None, alpha_logscale=False))
    np.testing.assert_allclose(_port(x, alpha, None, logscale=False, mxu=mxu), gold, atol=2e-5, rtol=0)


@pytest.mark.parametrize("mxu", [False, True])
def test_plain_bf16_matches_jax_kernel(mxu):
    """bf16: the polynomial sin by default on both sides; the tensor-core body
    rounds its taps and its 2x-rate samples to bf16 as JAX's _kernel_mxu does."""
    x, alpha, beta = _inputs(2, 300, 24, seed=13)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kern = np.asarray(jax_k3(xb, jnp.asarray(alpha), jnp.asarray(beta), alpha_logscale=True, tile_t=128,
                             interpret=True, mxu=mxu).astype(jnp.float32))
    mine = _port(x, alpha, beta, dtype=torch.bfloat16, mxu=mxu)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(kern).max())) - 7)
    assert np.abs(mine - kern).max() <= 2 * ulp
    assert (mine != kern).mean() < 0.05  # most outputs agree to the bit
    if mxu:  # the rounding points are there: the body differs from the CUDA-core body's plain version
        assert (mine != _port(x, alpha, beta, dtype=torch.bfloat16)).any()


def test_ident_and_probe_arguments():
    x, alpha, beta = _inputs(1, 40, 8, seed=1)
    np.testing.assert_array_equal(_port(x, alpha, beta, probe="ident"), x)
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()
    with pytest.raises(ValueError, match="probe"):
        k3.fused_anti_alias_snake_tmajor(xt, torch.from_numpy(alpha), torch.from_numpy(beta), True, probe="wrapper")


def test_wrapper_on_cpu_takes_the_plain_path_uncounted():
    x, alpha, beta = _inputs(1, 40, 8, seed=2)
    before = k3.launches
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()
    for kw in ({}, {"mxu": True}, {"probe": "ident"}):
        mine = k3.fused_anti_alias_snake_tmajor(xt, torch.from_numpy(alpha), torch.from_numpy(beta), True, **kw)
        plain = k3.anti_alias_snake_tmajor_plain(xt, torch.from_numpy(alpha), torch.from_numpy(beta), True, **kw)
        np.testing.assert_array_equal(mine.numpy(), plain.numpy())
    assert k3.launches == before


@pytest.mark.parametrize("mxu", [False, True])
def test_bound_covers_a_rounding_flip(mxu):
    """anti_alias_snake_tmajor_bound, the card's tolerance: positive
    everywhere, and in bf16 at least an output ulp wide."""
    x, alpha, beta = _inputs(1, 64, 8, seed=3)
    xt = torch.from_numpy(x).transpose(1, 2).contiguous().to(torch.bfloat16)
    a, b = torch.from_numpy(alpha), torch.from_numpy(beta)
    ref = k3.anti_alias_snake_tmajor_plain(xt, a, b, True, mxu=mxu)
    bound = k3.anti_alias_snake_tmajor_bound(xt, a, b, ref, True, mxu=mxu)
    ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
    assert bound.shape == ref.shape and (bound >= 2 * ulp).all()
    f32 = k3.anti_alias_snake_tmajor_bound(xt.float(), a, b, ref.float(), True, mxu=mxu)
    assert (f32 > 0).all() and f32.max() < 2e-4


def _wide_cfg():
    """tests/test_torch_vocoder.py's config with the published resblocks
    (kernels 3, 7, 11 x dilations 1, 3, 5): 18 activations a stage, stage 1 at
    C = 128 and stage 2 at C = 64."""
    return dataclasses.replace(vocoder_cfg(), resblock_kernel_sizes=(3, 7, 11),
                               resblock_dilation_sizes=((1, 3, 5),) * 3)


def _count_wrappers(monkeypatch):
    counts = {"k1": 0, "k2": 0, "k3": 0}
    for key, name, mod in (("k1", "fused_anti_alias_snake", k1), ("k2", "fused_aa_snake_dconv", k2),
                           ("k3", "fused_anti_alias_snake_tmajor", k3)):
        fn = getattr(mod, name)
        monkeypatch.setattr(tbv, name, lambda *a, _fn=fn, _key=key, **kw: counts.__setitem__(_key, counts[_key] + 1)
                            or _fn(*a, **kw))
    return counts


@pytest.mark.parametrize("mxu", [False, True])
def test_bigvgan_wide_tmajor_matches_jax(monkeypatch, mxu):
    h = _wide_cfg()
    rng = np.random.default_rng(4)
    params = scramble(jax.tree_util.tree_map(np.asarray, jbv.init_bigvgan(jax.random.PRNGKey(1), h)), rng)
    model = tbv.BigVGAN(h)
    load_jax_params(model, params)
    x = rng.standard_normal((1, 8, 16)).astype(np.float32)
    mel = rng.standard_normal((1, 40, 100)).astype(np.float32)
    monkeypatch.setenv("INDEXTTS_WIDE_TMAJOR", "1")
    if mxu:
        monkeypatch.setenv("INDEXTTS_WIDE_TMAJOR_MXU", "1")
    gold = np.asarray(jbv.bigvgan_apply(params, h, jnp.asarray(x), jnp.asarray(mel)))
    counts = _count_wrappers(monkeypatch)
    with torch.no_grad():
        wav = tbv.bigvgan_apply(model, h, torch.from_numpy(x), torch.from_numpy(mel)).numpy()
    assert counts == {"k1": 18 + 1, "k2": 0, "k3": 18}
    assert np.abs(gold).max() > 0.05
    np.testing.assert_allclose(wav, gold, atol=5e-5, rtol=0)
    # without use_cuda_kernel no kernel wrapper runs, whatever the switches say
    counts.update(k1=0, k2=0, k3=0)
    with torch.no_grad():
        tbv.bigvgan_apply(model, h, torch.from_numpy(x), torch.from_numpy(mel), use_cuda_kernel=False)
    assert counts == {"k1": 0, "k2": 0, "k3": 0}


def test_wide_branch_is_tested_before_wide_tmajor(monkeypatch):
    """Both switches: the half-branches at C >= 128 go to K2 as in JAX
    _amp_block1, K3 sees no activation, and the waveform is the default
    route's (which tests/test_torch_vocoder.py holds against JAX)."""
    h = _wide_cfg()
    rng = np.random.default_rng(6)
    params = scramble(jax.tree_util.tree_map(np.asarray, jbv.init_bigvgan(jax.random.PRNGKey(2), h)), rng)
    model = tbv.BigVGAN(h)
    load_jax_params(model, params)
    x = torch.from_numpy(rng.standard_normal((1, 8, 16)).astype(np.float32))
    mel = torch.from_numpy(rng.standard_normal((1, 40, 100)).astype(np.float32))
    counts = _count_wrappers(monkeypatch)
    with torch.no_grad():
        gold = tbv.bigvgan_apply(model, h, x, mel).numpy()
    assert counts == {"k1": 2 * 18 + 1, "k2": 0, "k3": 0}
    counts.update(k1=0, k2=0, k3=0)
    monkeypatch.setenv("INDEXTTS_WIDE_TMAJOR", "1")
    monkeypatch.setenv("INDEXTTS_WIDE_BRANCH", "1")
    with torch.no_grad():
        wav = tbv.bigvgan_apply(model, h, x, mel).numpy()
    assert counts == {"k1": 18 + 1, "k2": 18, "k3": 0}
    np.testing.assert_allclose(wav, gold, atol=1e-4, rtol=0)
