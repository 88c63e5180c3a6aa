"""K4's plain version and the vocoder's INDEXTTS_FUSED_AA route against the
JAX package, on the CPU.

The port's fused_folded_aa works on the trunk's [B, C, T]; JAX's
fused_folded_aa (run in interpret mode, as tests/test_pallas.py runs it) on
the phase-folded grid [B, N, s*C], so the tests fold the input and unfold the
result in numpy (sample t = s*n + q of channel c sits at xf[b, n, q*C + c]).
float32: within 2e-5 of the JAX kernel and of both packages' composed paths;
bf16: within fused_folded_aa_bound, the card's tolerance, of the JAX kernel
(whose rounding points the plain version repeats). The port's bigvgan_apply
under the switch equals the default route within 1e-4 and sends exactly the
resblock activations of the stages at C <= 96 to K4."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import indextts_tpu.models.bigvgan as jbv
from indextts_tpu.ops.antialias import anti_aliased_activation
from indextts_tpu.ops.pallas.antialias_folded import fused_folded_aa as jax_k4
import indextts_tpu_torch.models.bigvgan as tbv
from indextts_tpu_torch.ops.antialias import activation1d
from indextts_tpu_torch.ops.cuda import antialias as k1
from indextts_tpu_torch.ops.cuda import antialias_folded as k4
from indextts_tpu_torch.ops.cuda import antialias_tmajor as k3
from indextts_tpu_torch.weights import load_jax_params
from tests.test_torch_tmajor import _wide_cfg
from tests.test_torch_vocoder import scramble

# (s, C, N) of tests/test_pallas.py's folded cases (the three narrow stages'
# folds at the published widths), then its small-N case, which the JAX wrapper
# hands to its XLA path and the port's kernel takes like any other
SHAPES = [(8, 24, 256), (4, 48, 256), (2, 96, 128), (4, 48, 20)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while these tests run (see tests/test_torch_infer_fast.py:engines)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, t, c, seed, beta=True, logscale=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    alpha = (rng.standard_normal(c) * 0.3).astype(np.float32)
    bt = (rng.standard_normal(c) * 0.3).astype(np.float32) if beta else None
    if not logscale:
        alpha, bt = np.abs(alpha) + 0.1, None if bt is None else np.abs(bt) + 0.1
    return x, alpha, bt


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _port(x, alpha, beta, logscale=True, dtype=torch.float32, fn=k4.fused_folded_aa, **kw):
    """The port's call on the trunk layout [B, C, T], back on JAX's [B, T, C]."""
    xt = torch.from_numpy(x).transpose(1, 2).contiguous().to(dtype)
    return fn(xt, _t(alpha), _t(beta), logscale, **kw).float().transpose(1, 2).numpy()


def _jax_folded(x, alpha, beta, s, logscale=True, dtype=jnp.float32):
    """JAX's kernel in interpret mode on the folded grid, unfolded to [B, T, C]."""
    b, t, c = x.shape
    xf = jnp.asarray(x.reshape(b, t // s, s * c)).astype(dtype)
    out = jax_k4(xf, jnp.asarray(alpha), None if beta is None else jnp.asarray(beta), logscale, s, c, interpret=True)
    return np.asarray(out.astype(jnp.float32)).reshape(b, t, c)


@pytest.mark.parametrize("s,c,n", SHAPES)
def test_plain_matches_jax_kernel_and_composed(s, c, n):
    x, alpha, beta = _inputs(2, n * s, c, seed=s + c + n)
    gold = np.asarray(anti_aliased_activation(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta), alpha_logscale=True))
    kern = _jax_folded(x, alpha, beta, s)
    mine = _port(x, alpha, beta)
    assert mine.shape == gold.shape
    np.testing.assert_allclose(mine, kern, atol=2e-5, rtol=0)
    np.testing.assert_allclose(mine, gold, atol=2e-5, rtol=0)
    # and the port's own composed path
    np.testing.assert_allclose(mine, _port(x, alpha, beta, fn=activation1d), atol=2e-5, rtol=0)


def test_plain_snake_without_beta_and_plain_parameters():
    s, c, n = 4, 48, 20
    x, alpha, _ = _inputs(1, n * s, c, seed=9, beta=False, logscale=False)
    np.testing.assert_allclose(_port(x, alpha, None, logscale=False), _jax_folded(x, alpha, None, s, logscale=False),
                               atol=2e-5, rtol=0)
    x, alpha, beta = _inputs(1, 256 * 8, 24, seed=10, logscale=False)
    np.testing.assert_allclose(_port(x, alpha, beta, logscale=False), _jax_folded(x, alpha, beta, 8, logscale=False),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("s,c,n", SHAPES[:3])
def test_plain_bf16_matches_jax_kernel_within_the_bound(s, c, n):
    """bf16: both sides round the taps and the activated 2x-rate samples to
    bf16, sum in float32 and take the polynomial sin. They differ in the order
    of the float32 sums, which fused_folded_aa_bound covers: two output ulps,
    and a sample next to a rounding tie may round the other way."""
    x, alpha, beta = _inputs(2, n * s, c, seed=13 + s)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))  # bf16 values
    kern = _jax_folded(x, alpha, beta, s, dtype=jnp.bfloat16)
    mine = _port(x, alpha, beta, dtype=torch.bfloat16)
    xt = torch.from_numpy(x).transpose(1, 2).contiguous().to(torch.bfloat16)
    ref = k4.fused_folded_aa_plain(xt, _t(alpha), _t(beta), True)
    bound = k4.fused_folded_aa_bound(xt, _t(alpha), _t(beta), ref, True).transpose(1, 2).numpy()
    assert (np.abs(mine - kern) <= bound).all()
    assert (mine != kern).mean() < 0.05  # most outputs agree to the bit
    # the rounding points are there: the composed path in float32, rounded once, differs
    composed = _port(x, alpha, beta, dtype=torch.bfloat16, fn=lambda xt, a, b, ls: activation1d(
        xt.float(), a, b, ls, approx_sin_=True).to(torch.bfloat16))
    assert (mine != composed).any()


def test_plain_poly_sin_switch():
    x, alpha, beta = _inputs(1, 300, 24, seed=5)
    exact, poly = _port(x, alpha, beta), _port(x, alpha, beta, poly_sin=True)
    assert 1e-6 < np.abs(exact - poly).max() < 5e-4
    np.testing.assert_array_equal(poly, _port(x, alpha, beta, fn=lambda xt, a, b, ls: activation1d(
        xt, a, b, ls, approx_sin_=True)))


def test_odd_shapes_have_no_fallback():
    """C of no tile, T of no vector, T shorter than the stencil, T = 1: the
    plain version is the composed path's at every one (the JAX wrapper sends
    such shapes to its XLA path; the port's takes them all)."""
    for b, c, t in ((1, 25, 1003), (2, 8, 5), (1, 3, 1)):
        x, alpha, beta = _inputs(b, t, c, seed=t)
        gold = np.asarray(anti_aliased_activation(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta),
                                                  alpha_logscale=True))
        np.testing.assert_allclose(_port(x, alpha, beta), gold, atol=2e-5, rtol=0)


def test_wrapper_on_cpu_takes_the_plain_path_uncounted():
    x, alpha, beta = _inputs(1, 40, 8, seed=2)
    before = k4.launches
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        mine = k4.fused_folded_aa(xt.to(dtype), _t(alpha), _t(beta), True)
        plain = k4.fused_folded_aa_plain(xt.to(dtype), _t(alpha), _t(beta), True)
        assert mine.dtype == dtype
        np.testing.assert_array_equal(mine.float().numpy(), plain.float().numpy())
    assert k4.launches == before


def test_bound_is_an_output_ulp_wide_and_sees_near_ties():
    """fused_folded_aa_bound: positive everywhere, in bf16 at least two
    output ulps; a sample set next to a rounding tie widens it, also just
    below a power of two, where the bf16 spacing halves."""
    x, alpha, beta = _inputs(1, 64, 8, seed=3)
    xt = torch.from_numpy(x).transpose(1, 2).contiguous().to(torch.bfloat16)
    a, b = _t(alpha), _t(beta)
    ref = k4.fused_folded_aa_plain(xt, a, b, True)
    bound = k4.fused_folded_aa_bound(xt, a, b, ref, True)
    ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
    assert bound.shape == ref.shape and (bound >= 2 * ulp).all()
    f32 = k4.fused_folded_aa_bound(xt.float(), a, b, ref.float(), True)
    assert (f32 > 0).all() and f32.max() < 2e-4
    # near-tie detection on chosen samples: 0.49902344 is the midpoint of the bf16
    # neighbours 0.49804688 and 0.5 (spacing 2^-9); 0.7519531 that of 0.75 and 0.7539
    ties = torch.tensor([[0.49902344 + 3e-6, 0.7519531 - 2e-6, 0.3]])
    se, so = ties.clone(), torch.full_like(ties, 0.3)
    orig = k3._phase_samples
    try:
        k3._phase_samples = lambda *a, **k: (se[None], so[None])
        flagged = k3.anti_alias_snake_tmajor_bound(torch.zeros(1, 1, 3, dtype=torch.bfloat16), torch.zeros(1),
                                                   torch.zeros(1), torch.zeros(1, 1, 3), mxu=True)
        k3._phase_samples = lambda *a, **k: (torch.full_like(se, 0.3)[None], so[None])
        clear = k3.anti_alias_snake_tmajor_bound(torch.zeros(1, 1, 3, dtype=torch.bfloat16), torch.zeros(1),
                                                 torch.zeros(1), torch.zeros(1, 1, 3), mxu=True)
    finally:
        k3._phase_samples = orig
    assert (flagged[0, 0, :2] > clear[0, 0, :2] + 1e-4).all()


def _count_wrappers(monkeypatch):
    counts = {"k1": 0, "k3": 0, "k4": 0}
    for key, name, mod in (("k1", "fused_anti_alias_snake", k1), ("k3", "fused_anti_alias_snake_tmajor", k3),
                           ("k4", "fused_folded_aa", k4)):
        fn = getattr(mod, name)
        monkeypatch.setattr(tbv, name, lambda *a, _fn=fn, _key=key, **kw: counts.__setitem__(_key, counts[_key] + 1)
                            or _fn(*a, **kw))
    return counts


def _vocoder(seed):
    """tests/test_torch_tmajor.py's config: 18 resblock activations a stage,
    stage 1 at C = 128, stage 2 at C = 64, activation_post at C = 64."""
    h = _wide_cfg()
    rng = np.random.default_rng(seed)
    params = scramble(jax.tree_util.tree_map(np.asarray, jbv.init_bigvgan(jax.random.PRNGKey(seed), h)), rng)
    model = tbv.BigVGAN(h)
    load_jax_params(model, params)
    x = torch.from_numpy(rng.standard_normal((1, 8, 16)).astype(np.float32))
    mel = torch.from_numpy(rng.standard_normal((1, 40, 100)).astype(np.float32))
    return h, model, x, mel


@pytest.mark.parametrize("wide_tmajor", [False, True])
def test_bigvgan_fused_aa_routing(monkeypatch, wide_tmajor):
    """INDEXTTS_FUSED_AA=1: the 18 resblock activations of the stage at C = 64
    go to K4; activation_post (C = 64 too) stays with K1, as in JAX, where it
    never reaches the folded stages' activation. The waveform is the default
    route's within 1e-4."""
    h, model, x, mel = _vocoder(4)
    counts = _count_wrappers(monkeypatch)
    with torch.no_grad():
        gold = tbv.bigvgan_apply(model, h, x, mel).numpy()
    assert counts == {"k1": 2 * 18 + 1, "k3": 0, "k4": 0}
    counts.update(k1=0, k3=0, k4=0)
    monkeypatch.setenv("INDEXTTS_FUSED_AA", "1")
    if wide_tmajor:
        monkeypatch.setenv("INDEXTTS_WIDE_TMAJOR", "1")
    with torch.no_grad():
        wav = tbv.bigvgan_apply(model, h, x, mel).numpy()
    assert counts == ({"k1": 1, "k3": 18, "k4": 18} if wide_tmajor else {"k1": 18 + 1, "k3": 0, "k4": 18})
    assert np.abs(gold).max() > 0.05
    np.testing.assert_allclose(wav, gold, atol=1e-4, rtol=0)
    # without use_cuda_kernel no kernel wrapper runs, whatever the switches say
    counts.update(k1=0, k3=0, k4=0)
    with torch.no_grad():
        tbv.bigvgan_apply(model, h, x, mel, use_cuda_kernel=False)
    assert counts == {"k1": 0, "k3": 0, "k4": 0}


def test_bigvgan_fused_aa_matches_jax_default(monkeypatch):
    """Under the switch the port still equals JAX's vocoder (whose own folded
    route is the same function) within 5e-5."""
    h, model, x, mel = _vocoder(5)
    params = jax.tree_util.tree_map(np.asarray, jbv.init_bigvgan(jax.random.PRNGKey(5), h))
    params = scramble(params, np.random.default_rng(5))
    gold = np.asarray(jbv.bigvgan_apply(params, h, jnp.asarray(x.numpy()), jnp.asarray(mel.numpy())))
    monkeypatch.setenv("INDEXTTS_FUSED_AA", "1")
    with torch.no_grad():
        wav = tbv.bigvgan_apply(model, h, x, mel).numpy()
    np.testing.assert_allclose(wav, gold, atol=5e-5, rtol=0)
