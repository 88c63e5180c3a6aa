"""K2's plain version and the vocoder's wide-branch route against the JAX
package, float32 on the CPU.

aa_snake_dconv_plain (K1's plain activation, then the 'same' dilated conv)
must equal JAX's fused_aa_snake_dconv_tmajor (interpret mode, float32 sin)
and its oracle aa_snake_dconv_ref at every (k, d) of the vocoder, within
1e-4; in bf16 within tests/test_pallas_branch.py's tolerance. The port's
AMPBlock1 under INDEXTTS_WIDE_BRANCH=1 equals JAX _amp_block1 under the same
switch, and bigvgan_apply sends exactly the C >= 128 half-branches to K2."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import indextts_tpu.models.bigvgan as jbv
from indextts_tpu.ops.pallas.aa_conv_branch import aa_snake_dconv_ref, fused_aa_snake_dconv_tmajor
import indextts_tpu_torch.models.bigvgan as tbv
from indextts_tpu_torch.ops.cuda import aa_conv_branch as k2
from indextts_tpu_torch.ops.cuda import antialias as k1
from indextts_tpu_torch.weights import load_jax_params
from tests.test_branch_routing import _cfg
from tests.test_torch_vocoder import scramble, vocoder_cfg

TOL = 1e-4


def _mk(b, t, c, k, seed):
    """JAX-layout inputs as tests/test_pallas_branch.py makes them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, c)) * 0.5).astype(np.float32)
    alpha = (rng.standard_normal((c,)) * 0.3).astype(np.float32)
    beta = (rng.standard_normal((c,)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((k, c, c)) / np.sqrt(c * k)).astype(np.float32)
    bias = (rng.standard_normal((c,)) * 0.1).astype(np.float32)
    return x, alpha, beta, w, bias


def _port(x, alpha, beta, w, bias, d, logscale=True, dtype=torch.float32):
    """The port's call on the trunk layout: x [B, C, T], weight [Cout, Cin, k]."""
    xt = torch.from_numpy(x).transpose(1, 2).contiguous().to(dtype)
    wt = torch.from_numpy(np.transpose(w, (2, 1, 0)).copy()).to(dtype)
    out = k2.fused_aa_snake_dconv(xt, torch.from_numpy(alpha), None if beta is None else torch.from_numpy(beta), wt,
                                  torch.from_numpy(bias).to(dtype), d, alpha_logscale=logscale)
    return out.float().transpose(1, 2).numpy()


@pytest.mark.parametrize("k,d", [(k, d) for k in (3, 7, 11) for d in (1, 3, 5)])
def test_plain_matches_jax_kernel_and_oracle(k, d):
    """C = 128 (the gate's width), T = 96 (not a multiple of the JAX tile)."""
    x, alpha, beta, w, bias = _mk(1, 96, 128, k, seed=k * 10 + d)
    args = (jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(w), jnp.asarray(bias))
    ref = np.asarray(aa_snake_dconv_ref(*args, d, alpha_logscale=True))
    mine = _port(x, alpha, beta, w, bias, d)
    np.testing.assert_allclose(mine, ref, atol=TOL, rtol=0)
    if (k, d) in ((3, 1), (7, 3), (11, 5)):  # the interpret-mode kernel, at three (k, d)
        kern = np.asarray(fused_aa_snake_dconv_tmajor(*args, d, alpha_logscale=True, tile_t=64, tile_co=64,
                                                      interpret=True, poly_sin=False))
        np.testing.assert_allclose(mine, kern, atol=TOL, rtol=0)


def test_plain_snake_without_beta_matches_oracle():
    x, alpha, _, w, bias = _mk(1, 50, 128, 7, seed=3)
    ref = np.asarray(aa_snake_dconv_ref(jnp.asarray(x), jnp.asarray(alpha), None, jnp.asarray(w), jnp.asarray(bias), 3,
                                        alpha_logscale=False))
    np.testing.assert_allclose(_port(x, alpha, None, w, bias, 3, logscale=False), ref, atol=TOL, rtol=0)


def test_plain_bf16_matches_oracle():
    """bf16 at tests/test_pallas_branch.py's tolerance for the bf16 path."""
    x, alpha, beta, w, bias = _mk(2, 128, 128, 7, seed=11)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(aa_snake_dconv_ref(xb, jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(w).astype(jnp.bfloat16),
                                        jnp.asarray(bias).astype(jnp.bfloat16), 1, alpha_logscale=True), np.float32)
    mine = _port(x, alpha, beta, w, bias, 1, dtype=torch.bfloat16)
    np.testing.assert_allclose(mine, ref, atol=0.06, rtol=0.06)


def test_wrapper_on_cpu_takes_the_plain_path_uncounted():
    x, alpha, beta, w, bias = _mk(1, 40, 128, 3, seed=5)
    before = k2.launches
    mine = _port(x, alpha, beta, w, bias, 3)
    assert k2.launches == before
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()
    plain = k2.aa_snake_dconv_plain(xt, torch.from_numpy(alpha), torch.from_numpy(beta),
                                    torch.from_numpy(np.transpose(w, (2, 1, 0)).copy()), torch.from_numpy(bias), 3,
                                    alpha_logscale=True)
    np.testing.assert_array_equal(mine, plain.transpose(1, 2).numpy())


def test_amp_block1_wide_branch_matches_jax(monkeypatch):
    """tests/test_branch_routing.py's setup: C = 128, k = 3, dilations 1, 3, 5."""
    h = _cfg()
    c, k, dil = 128, 3, (1, 3, 5)
    p = scramble(jax.tree_util.tree_map(np.asarray, jbv._amp_block_init(jax.random.PRNGKey(0), h, c, k, dil)),
                 np.random.default_rng(1))
    x = (np.random.default_rng(0).standard_normal((1, 96, c)) * 0.3).astype(np.float32)
    monkeypatch.setenv("INDEXTTS_WIDE_BRANCH", "1")
    gold = np.asarray(jbv._amp_block1(p, jnp.asarray(x), h, k, dil))
    block = tbv.AMPBlock1(h, c, k, dil)
    load_jax_params(block, p)
    calls = []

    def branch(sp, conv, y):
        calls.append(conv.dilation[0])
        return k2.fused_aa_snake_dconv(y, sp.alpha, sp.beta, conv.weight, conv.bias, conv.dilation[0],
                                       h.snake_logscale)

    with torch.no_grad():
        mine = block(torch.from_numpy(x).transpose(1, 2), None, branch).transpose(1, 2).numpy()
    assert calls == [1, 1, 3, 1, 5, 1]
    assert np.abs(gold).max() > 0.1
    np.testing.assert_allclose(mine, gold, atol=TOL, rtol=0)


def test_bigvgan_routes_wide_half_branches_to_k2(monkeypatch):
    """bigvgan_apply under the switch: K2 at every half-branch of the C >= 128
    stage and K1 at the others (counted through the CPU wrappers), and the
    waveform of the route without the switch (which tests/test_torch_vocoder.py
    holds against JAX bigvgan_apply)."""
    h = vocoder_cfg()  # stage 1 at C = 128 (2 resblocks x 2 dilations), stage 2 at C = 64
    rng = np.random.default_rng(4)
    params = scramble(jax.tree_util.tree_map(np.asarray, jbv.init_bigvgan(jax.random.PRNGKey(1), h)), rng)
    model = tbv.BigVGAN(h)
    load_jax_params(model, params)
    x = torch.from_numpy(rng.standard_normal((1, 8, 16)).astype(np.float32))
    mel = torch.from_numpy(rng.standard_normal((1, 40, 100)).astype(np.float32))
    counts = {"k1": 0, "k2": 0}
    monkeypatch.setattr(tbv, "fused_aa_snake_dconv",
                        lambda *a, **kw: counts.__setitem__("k2", counts["k2"] + 1) or k2.fused_aa_snake_dconv(*a, **kw))
    monkeypatch.setattr(tbv, "fused_anti_alias_snake",
                        lambda *a, **kw: counts.__setitem__("k1", counts["k1"] + 1) or k1.fused_anti_alias_snake(*a, **kw))
    monkeypatch.setenv("INDEXTTS_WIDE_BRANCH", "1")
    with torch.no_grad():
        wav = tbv.bigvgan_apply(model, h, x, mel).numpy()
    assert counts == {"k2": 2 * 2 * 2, "k1": 2 * 2 * 2 + 1}
    monkeypatch.delenv("INDEXTTS_WIDE_BRANCH")
    counts.update(k1=0, k2=0)
    with torch.no_grad():
        gold = tbv.bigvgan_apply(model, h, x, mel).numpy()
    assert counts == {"k2": 0, "k1": 4 * 2 * 2 + 1}
    assert np.abs(gold).max() > 0.05
    np.testing.assert_allclose(wav, gold, atol=TOL, rtol=0)
