"""The port's BigVGAN discriminators, GAN losses, convert_discriminator and
fidelity loop against indextts_tpu, float32 on the CPU.

MPD / MRD scores and every feature map ([B, H, W, C], the JAX layout) on the
same JAX-initialized weights at the oracle's tiny settings
(tests/test_reference_oracle.py: channel mult 0.25, periods 2 and 3, three
small resolutions), within 1e-4, with a T that no period divides too; the
three losses; convert_discriminator leaf for leaf against JAX's, flat and
nested, both weight-norm key forms; and indextts_tpu_torch.eval_fidelity.main
against tools/eval_fidelity.py's main, in process, on one tiny converted
checkpoint directory: the same JSON keys and weight sources, the numbers
within 1e-4 of each other (after both round to 4 or 6 decimals), the DVAE
codes-used count equal."""

import importlib.util
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import indextts_tpu.convert as jconv
import indextts_tpu.models.bigvgan as jb
import indextts_tpu_torch.convert as tconv
import indextts_tpu_torch.models.bigvgan as tb
from indextts_tpu.config import BigVGANConfig
from indextts_tpu_torch import eval_fidelity
from indextts_tpu_torch.utils.audio import load_audio, write_wav
from indextts_tpu_torch.weights import load_jax_params
from tests.make_torch_ckpt import make_discriminator_state_dict, write_checkpoints
from tests.test_engine import tiny_config
from tests.test_torch_checkpoint import _rewrite, assert_trees_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = os.path.join(REPO, "tests", "sample_prompt.wav")
TOL = 1e-4
rng = np.random.default_rng(61)


def tiny_h() -> BigVGANConfig:
    return BigVGANConfig(discriminator_channel_mult=0.25, mpd_reshapes=(2, 3),
                         resolutions=((128, 20, 80), (256, 40, 160), (64, 10, 40)))


@pytest.fixture(scope="module")
def setup():
    h = tiny_h()
    mpd_p, mrd_p = jb.init_mpd(jax.random.PRNGKey(1), h), jb.init_mrd(jax.random.PRNGKey(2), h)
    # biases away from init's zeros, so a bias in the wrong place shows
    for tree in (mpd_p, mrd_p):
        for d in tree["discriminators"]:
            for conv in d["convs"] + [d["conv_post"]]:
                conv["bias"] = jnp.asarray(0.1 * rng.standard_normal(conv["bias"].shape).astype(np.float32))
    mpd, mrd = tb.MultiPeriodDiscriminator(h), tb.MultiResolutionDiscriminator(h)
    load_jax_params(mpd, mpd_p)
    load_jax_params(mrd, mrd_p)
    # JAX's scoring, jitted once per shape instead of one compile per op
    jit = {"mpd": jax.jit(lambda p, a, b: jb.mpd_apply(p, h, a, b)),
           "mrd": jax.jit(lambda p, a, b: jb.mrd_apply(p, h, a, b))}
    return h, mpd_p, mrd_p, mpd, mrd, jit


def _waves(t):
    y = 0.3 * rng.standard_normal((2, t, 1)).astype(np.float32)
    return y, (y + 0.1 * rng.standard_normal(y.shape)).astype(np.float32)


def _compare(mine, gold):
    for m_list, g_list in zip(mine[:2], gold[:2]):  # scores real / generated
        for m, g in zip(m_list, g_list):
            assert m.shape == g.shape
            np.testing.assert_allclose(m.numpy(), np.asarray(g), atol=TOL, rtol=0)
    for m_maps, g_maps in zip(mine[2:], gold[2:]):  # feature maps real / generated
        for m_disc, g_disc in zip(m_maps, g_maps):
            assert len(m_disc) == len(g_disc) == 6
            for m, g in zip(m_disc, g_disc):
                assert tuple(m.shape) == g.shape
                np.testing.assert_allclose(m.numpy(), np.asarray(g), atol=TOL, rtol=0)


@pytest.mark.parametrize("t", [3000, 3001])
def test_mpd_scores_and_feature_maps_match_jax(setup, t):
    """t = 3001: no period divides it, the reflect pad runs for both."""
    h, mpd_p, _, mpd, _, jit = setup
    y, y_hat = _waves(t)
    gold = jit["mpd"](mpd_p, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        mine = tb.mpd_apply(mpd, h, torch.from_numpy(y), torch.from_numpy(y_hat))
    _compare(mine, gold)


@pytest.mark.parametrize("t", [3000, 2777])
def test_mrd_scores_and_feature_maps_match_jax(setup, t):
    h, _, mrd_p, _, mrd, jit = setup
    y, y_hat = _waves(t)
    gold = jit["mrd"](mrd_p, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        mine = tb.mrd_apply(mrd, h, torch.from_numpy(y), torch.from_numpy(y_hat))
    _compare(mine, gold)


def test_stft_magnitude_matches_jax():
    x = rng.standard_normal((2, 900)).astype(np.float32)
    for n_fft, hop, win in ((128, 20, 80), (64, 10, 64), (256, 40, 160)):
        gold = np.asarray(jb._stft_mag_jnp(jnp.asarray(x), n_fft, hop, win))
        mine = tb._stft_mag(torch.from_numpy(x), n_fft, hop, win).numpy()
        assert mine.shape == gold.shape
        np.testing.assert_allclose(mine, gold, atol=1e-4, rtol=1e-5)


def test_losses_match_jax(setup):
    h, mpd_p, _, mpd, _, jit = setup
    y, y_hat = _waves(3000)
    gold = jit["mpd"](mpd_p, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        mine = tb.mpd_apply(mpd, h, torch.from_numpy(y), torch.from_numpy(y_hat))
    f_mine, f_gold = tb.feature_loss(mine[2], mine[3]), jb.feature_loss(gold[2], gold[3])
    np.testing.assert_allclose(float(f_mine), float(f_gold), atol=TOL, rtol=1e-5)
    assert float(f_mine) > 0
    d_mine, d_gold = tb.discriminator_loss(mine[0], mine[1]), jb.discriminator_loss(gold[0], gold[1])
    np.testing.assert_allclose(float(d_mine[0]), float(d_gold[0]), atol=TOL, rtol=1e-5)
    for m_list, g_list in zip(d_mine[1:], d_gold[1:]):
        assert len(m_list) == len(g_list) == 2
        np.testing.assert_allclose([float(v) for v in m_list], [float(v) for v in g_list], atol=TOL, rtol=1e-5)
    g_mine, g_gold = tb.generator_loss(mine[1]), jb.generator_loss(gold[1])
    np.testing.assert_allclose(float(g_mine[0]), float(g_gold[0]), atol=TOL, rtol=1e-5)
    np.testing.assert_allclose([float(v) for v in g_mine[1]], [float(v) for v in g_gold[1]], atol=TOL, rtol=1e-5)


def test_reset_parameters_distributions():
    h = tiny_h()
    mpd = tb.MultiPeriodDiscriminator(h)
    mpd.reset_parameters(torch.Generator().manual_seed(0))
    conv = mpd.discriminators[0].convs[1]  # 8 -> 32 channels, (5, 1)
    bound = 1 / np.sqrt(8 * 5)
    top = float(conv.weight.detach().abs().max())
    assert bound / 2 < top <= bound
    assert all(not c.bias.any() for d in mpd.discriminators for c in list(d.convs) + [d.conv_post])


@pytest.mark.parametrize("form", ["legacy", "parametrize"])
@pytest.mark.parametrize("layout", ["flat", "nested"])
def test_convert_discriminator_matches_jax(setup, layout, form):
    h, jit = setup[0], setup[-1]
    sd = {k: v.numpy() for k, v in _rewrite(make_discriminator_state_dict(h), form).items()}
    if layout == "nested":
        sd = {mod: {k[len(mod) + 1:]: v for k, v in sd.items() if k.startswith(mod + ".")} for mod in ("mpd", "mrd")}
    mine, gold = tconv.convert_discriminator(sd, h), jconv.convert_discriminator(sd, h)
    assert_trees_equal(mine, gold)
    mpd, mrd = tb.MultiPeriodDiscriminator(h), tb.MultiResolutionDiscriminator(h)
    load_jax_params(mpd, mine["mpd"])
    load_jax_params(mrd, mine["mrd"])
    y, y_hat = _waves(3000)
    gold_s = jit["mrd"](jax.tree_util.tree_map(jnp.asarray, gold["mrd"]), jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        mine_s = tb.mrd_apply(mrd, h, torch.from_numpy(y), torch.from_numpy(y_hat))
    for m, g in zip(mine_s[0], gold_s[0]):
        np.testing.assert_allclose(m.numpy(), np.asarray(g), atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def fidelity_dir(tmp_path_factory):
    """One tiny checkpoint directory (dvae.pth, bigvgan_discriminator.pth,
    config.yaml) and a resynthesized stand-in: the prompt plus noise."""
    d = str(tmp_path_factory.mktemp("fidelity"))
    write_checkpoints(tiny_config(), d)
    wav = load_audio(PROMPT, 22050)
    noisy = wav + 0.02 * np.random.default_rng(0).standard_normal(wav.shape).astype(np.float32)
    write_wav(os.path.join(d, "hat.wav"), noisy * 32767.0, 22050)
    return d


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_eval_fidelity", os.path.join(REPO, "tools", "eval_fidelity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_eval_fidelity_matches_the_jax_tool(fidelity_dir, capsys):
    args = ["--wav", PROMPT, "--wav_hat", os.path.join(fidelity_dir, "hat.wav"), "--model_dir", fidelity_dir,
            "--cfg", os.path.join(fidelity_dir, "config.yaml")]
    _jax_tool().main(args + ["--cpu"])
    gold = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    returned, _ = eval_fidelity.main(args + ["-d", "cpu"])
    mine = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert mine == returned
    assert list(mine) == list(gold)
    assert mine["dvae_weights"] == gold["dvae_weights"] == os.path.join(fidelity_dir, "dvae.pth")
    assert mine["discriminator_weights"] == gold["discriminator_weights"]
    assert mine["discriminator_weights"].endswith("bigvgan_discriminator.pth")
    assert mine["dvae_codes_used"] == gold["dvae_codes_used"] > 1
    for k in ("dvae_round_trip_mse", "mpd_disc_loss", "mrd_disc_loss", "mpd_feature_loss", "mrd_feature_loss"):
        assert np.isfinite(mine[k])
        np.testing.assert_allclose(mine[k], gold[k], atol=TOL, rtol=1e-5, err_msg=k)
    assert mine["mpd_feature_loss"] > 0 and mine["mrd_feature_loss"] > 0


def test_eval_fidelity_codes_match_the_jax_dvae(fidelity_dir):
    """The DVAE codes behind dvae_codes_used, token for token."""
    import indextts_tpu.models.dvae as jd
    from indextts_tpu.config import load_config
    from indextts_tpu.utils.mel import dvae_wav_to_mel

    cfg_path = os.path.join(fidelity_dir, "config.yaml")
    _, extras = eval_fidelity.main(["--wav", PROMPT, "--model_dir", fidelity_dir, "--cfg", cfg_path, "-d", "cpu"])
    dvae_cfg = load_config(cfg_path).dvae
    params = jax.tree_util.tree_map(jnp.asarray, jconv.convert_dvae(
        jconv.load_torch_state_dict(os.path.join(fidelity_dir, "dvae.pth")), dvae_cfg))
    mel = dvae_wav_to_mel(load_audio(PROMPT, 22050))
    t4 = (mel.shape[2] // 4) * 4
    gold = np.asarray(jd.get_codebook_indices(params, dvae_cfg, jnp.asarray(mel.transpose(0, 2, 1)[:, :t4])))
    np.testing.assert_array_equal(extras["codes"], gold)
    assert extras["dvae_ms"] > 0 and extras["disc_ms"] > 0


def test_eval_fidelity_random_init_without_checkpoints(fidelity_dir, capsys):
    """No --model_dir: seeded random init, the same keys as the JAX tool."""
    report, _ = eval_fidelity.main(["--wav", PROMPT, "--cfg", os.path.join(fidelity_dir, "config.yaml"), "-d", "cpu"])
    assert report["dvae_weights"] == report["discriminator_weights"] == "random-init"
    assert set(report) == {"dvae_round_trip_mse", "dvae_codes_used", "mpd_disc_loss", "mrd_disc_loss",
                           "mpd_feature_loss", "mrd_feature_loss", "dvae_weights", "discriminator_weights"}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report


def test_eval_fidelity_sets_float32_on_cuda_and_restores(monkeypatch):
    """On a CUDA device the tool runs with cuDNN's and cuBLAS's TF32 off,
    whatever the caller set, and restores both flags afterwards (also when
    the run raises); on the CPU it leaves them alone."""
    import argparse

    import torch

    seen = []

    def run(args):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        if args.wav == "raise":
            raise RuntimeError("a failed run")
        return {}, {}

    monkeypatch.setattr(eval_fidelity, "_fidelity_report", run)
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        eval_fidelity.fidelity_report(argparse.Namespace(device="cuda", wav="a.wav"))
        assert seen[-1] == (False, False)
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
        with pytest.raises(RuntimeError, match="a failed run"):
            eval_fidelity.fidelity_report(argparse.Namespace(device="cuda:0", wav="raise"))
        assert seen[-1] == (False, False)
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
        eval_fidelity.fidelity_report(argparse.Namespace(device="cpu", wav="a.wav"))
        assert seen[-1] == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
