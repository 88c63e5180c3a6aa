"""The port's DiscreteVAE against indextts_tpu's on the same JAX-initialized
weights, float32 on the CPU. Mirrors every test of tests/test_dvae.py:
tokenize (codes exact), detokenize and the round trip (mel within 1e-4),
the 1-D and 2-D forms and num_layers == 0, the straight-through training
forward (losses within 1e-4, and its gradients by torch.autograd against
jax.grad within 1e-4), discretization_loss, the EMA codebook update in one
process and over a 2-process gloo group (each rank half the rows; equal to
the one-process update within 1e-5, as test_ema_update_psum_matches_single
holds JAX's psum), and convert_dvae leaf for leaf against JAX's."""

import socket

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import indextts_tpu.convert as jconv
import indextts_tpu.models.dvae as jd
import indextts_tpu_torch.convert as tconv
import indextts_tpu_torch.models.dvae as td
from indextts_tpu.config import DVAEConfig
from indextts_tpu_torch.weights import load_jax_params
from tests.make_torch_ckpt import make_dvae_state_dict
from tests.test_torch_checkpoint import assert_trees_equal

TOL = 1e-4
rng = np.random.default_rng(51)


def small_cfg(**kw):
    base = dict(channels=80, num_tokens=64, codebook_dim=16, hidden_dim=16, num_layers=2, num_resnet_blocks=1)
    return DVAEConfig(**{**base, **kw})


def cfg_2d():
    return DVAEConfig(channels=3, num_tokens=64, codebook_dim=16, hidden_dim=8, num_layers=2, num_resnet_blocks=1,
                      positional_dims=2)


def _pair(cfg, seed):
    """JAX-initialized weights in both packages, the codebook redrawn from the
    encoder's own logits plus noise: at init's N(0, 1) every frame is nearest
    to the same entry, and code equality would test one code."""
    params = jd.init_dvae(jax.random.PRNGKey(seed), cfg)
    shape = (4, 16, 16, cfg.channels) if cfg.positional_dims == 2 else (4, 64, cfg.channels)
    logits = np.asarray(jd.dvae_encode(params, cfg, jnp.asarray(rng.standard_normal(shape).astype(np.float32))))
    logits = logits.reshape(-1, cfg.codebook_dim)
    picks = logits[rng.integers(0, logits.shape[0], cfg.num_tokens)]
    embed = (picks + 0.1 * logits.std() * rng.standard_normal(picks.shape)).T.astype(np.float32)
    params["codebook"] = dict(params["codebook"], embed=jnp.asarray(embed), embed_avg=jnp.asarray(embed))
    model = td.DiscreteVAE(cfg)
    load_jax_params(model, params)
    return params, model


@pytest.fixture(scope="module")
def setup():
    cfg = small_cfg()
    return (cfg,) + _pair(cfg, 0)


@pytest.fixture(scope="module")
def setup2d():
    cfg = cfg_2d()
    return (cfg,) + _pair(cfg, 2)


def _jit(fn, cfg):
    return jax.jit(lambda p, x: fn(p, cfg, x))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_tokenize_shapes_and_codes(setup):
    cfg, params, model = setup
    mel = rng.standard_normal((2, 64, 80)).astype(np.float32)
    gold = np.asarray(_jit(jd.get_codebook_indices, cfg)(params, jnp.asarray(mel)))
    mine = td.get_codebook_indices(model, cfg, _t(mel)).numpy()
    assert mine.shape == (2, 64 // 4)  # two stride-2 layers
    assert ((mine >= 0) & (mine < cfg.num_tokens)).all()
    np.testing.assert_array_equal(mine, gold)
    assert len(np.unique(mine)) > 4


def test_decode_shapes_and_values(setup):
    cfg, params, model = setup
    codes = rng.integers(0, 64, (2, 16))
    gold = np.asarray(_jit(jd.decode, cfg)(params, jnp.asarray(codes)))
    with torch.no_grad():
        mine = td.decode(model, cfg, _t(codes)).numpy()
    assert mine.shape == gold.shape == (2, 64, 80)
    np.testing.assert_allclose(mine, gold, atol=TOL, rtol=0)


def test_round_trip_deterministic(setup):
    cfg, params, model = setup
    mel = rng.standard_normal((1, 32, 80)).astype(np.float32)
    with torch.no_grad():
        a = td.dvae_infer(model, cfg, _t(mel)).numpy()
        b = td.dvae_infer(model, cfg, _t(mel)).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, np.asarray(_jit(jd.dvae_infer, cfg)(params, jnp.asarray(mel))), atol=TOL, rtol=0)


def test_quantize_picks_nearest(setup):
    cfg, params, model = setup
    embed = model.codebook.embed.numpy()
    q, codes = td.quantize(model.codebook, _t(embed[:, 7][None, :]))
    assert int(codes[0]) == 7
    np.testing.assert_allclose(q[0].numpy(), embed[:, 7], atol=1e-5)
    flat = rng.standard_normal((3, 5, 16)).astype(np.float32)
    gq, gcodes = jd.quantize(params["codebook"], jnp.asarray(flat))
    q, codes = td.quantize(model.codebook, _t(flat))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(gcodes))
    np.testing.assert_allclose(q.numpy(), np.asarray(gq), atol=1e-6, rtol=0)


def _grads_match(cfg, params, model, x):
    """dvae_forward's losses and output against JAX's, and the gradient of
    recon + commitment with respect to every weight by torch.autograd
    against jax.grad. The codebook takes no gradient in either package."""
    gold = _jit(jd.dvae_forward, cfg)(params, jnp.asarray(x))
    jgrad = jax.jit(jax.grad(lambda p, y: sum(jd.dvae_forward(p, cfg, y)[:2])))(params, jnp.asarray(x))
    model.zero_grad()
    recon, commit, out = td.dvae_forward(model, cfg, _t(x))
    (recon + commit).backward()
    assert out.shape == x.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(gold[2]), atol=TOL, rtol=0)
    for m, g in zip((recon, commit), gold[:2]):
        assert np.isfinite(m.item())
        np.testing.assert_allclose(m.item(), float(g), atol=TOL, rtol=1e-5)
    assert not any(np.asarray(v).any() for v in jax.tree_util.tree_leaves(jgrad["codebook"]))
    want = td.DiscreteVAE(cfg)
    load_jax_params(want, jgrad)  # JAX's gradients in the port's layout
    n = 0
    for (name, p), (_, w) in zip(model.named_parameters(), want.named_parameters()):
        np.testing.assert_allclose(p.grad.numpy(), w.detach().numpy(), atol=TOL, rtol=0, err_msg=name)
        n += int(p.grad.abs().sum() > 0)
    assert n > 0
    model.zero_grad()


def test_training_forward_and_gradients(setup):
    cfg, params, model = setup
    _grads_match(cfg, params, model, rng.standard_normal((1, 32, 80)).astype(np.float32))


def test_training_forward_crops_time():
    """A T that is not a multiple of 2^L: the output is cropped to T."""
    cfg = small_cfg()
    params, model = _pair(cfg, 3)
    _grads_match(cfg, params, model, rng.standard_normal((2, 30, 80)).astype(np.float32))


def test_ema_update_single_process(setup):
    cfg, params, model = setup
    flat = rng.standard_normal((100, 16)).astype(np.float32)
    gold = jd.quantize_ema_update(params["codebook"], jnp.asarray(flat), cfg.num_tokens)
    cb = td.Codebook(cfg.codebook_dim, cfg.num_tokens)
    load_jax_params(cb, params["codebook"])
    out = td.quantize_ema_update(cb, _t(flat), cfg.num_tokens)
    assert out is cb and float(cb.cluster_size.sum()) > 0
    for k in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(getattr(cb, k).numpy(), np.asarray(gold[k]), atol=1e-5, rtol=1e-5, err_msg=k)


def _ema_worker(rank: int, world: int, port: int, codebook: dict, flat: np.ndarray, n_embed: int, out_path: str):
    """One rank of the gloo group: its half of the rows, the statistics summed
    over the group; rank 0 saves the updated codebook."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        cb = td.Codebook(*codebook["embed"].shape)
        load_jax_params(cb, codebook)
        rows = np.array_split(flat, world)[rank]
        td.quantize_ema_update(cb, torch.from_numpy(rows), n_embed, group=dist.group.WORLD)
        if rank == 0:
            np.savez(out_path, **{k: getattr(cb, k).numpy() for k in codebook})
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_ema_update_all_reduce_matches_single(setup, tmp_path):
    """quantize_ema_update over a 2-process gloo group, each rank half the
    rows, equals the one-process update on all of them (the reference's
    all_reduce contract, xtts_dvae.py:107-109)."""
    cfg, params, _ = setup
    flat = rng.standard_normal((128, 16)).astype(np.float32)
    codebook = {k: np.asarray(v) for k, v in params["codebook"].items()}
    single = td.Codebook(cfg.codebook_dim, cfg.num_tokens)
    load_jax_params(single, codebook)
    td.quantize_ema_update(single, _t(flat), cfg.num_tokens)
    out = str(tmp_path / "ema.npz")
    torch.multiprocessing.start_processes(_ema_worker, args=(2, _free_port(), codebook, flat, cfg.num_tokens, out),
                                          nprocs=2, join=True, start_method="spawn")
    with np.load(out) as got:
        for k in codebook:
            np.testing.assert_allclose(got[k], getattr(single, k).numpy(), atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("n_res", [0, 2])
def test_num_layers_zero_supported(n_res):
    cfg = small_cfg(num_layers=0, num_resnet_blocks=n_res)
    params, model = _pair(cfg, 0)
    assert hasattr(model, "enc_in0") and len(model.enc_convs) == 0
    mel = rng.standard_normal((2, 8, 80)).astype(np.float32)
    codes = td.get_codebook_indices(model, cfg, _t(mel))
    assert codes.shape == (2, 8)  # no striding at num_layers=0
    np.testing.assert_array_equal(codes.numpy(), np.asarray(_jit(jd.get_codebook_indices, cfg)(params, mel)))
    with torch.no_grad():
        rec = td.decode(model, cfg, codes).numpy()
    assert rec.shape == (2, 8, 80)
    np.testing.assert_allclose(rec, np.asarray(_jit(jd.decode, cfg)(params, jnp.asarray(codes.numpy()))),
                               atol=TOL, rtol=0)


def test_discretization_loss():
    soft = np.abs(rng.standard_normal((50, 64))).astype(np.float32)
    loss = td.discretization_loss(_t(soft), dim=1, expected_variance=1.0 / 128)
    gold = jd.discretization_loss(jnp.asarray(soft), dim=1, expected_variance=1.0 / 128)
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(gold), rtol=1e-5)
    # perfectly uniform utilization gives the minimum possible loss
    uniform = td.discretization_loss(torch.ones(50, 64), dim=1, expected_variance=1.0 / 128)
    assert float(uniform) <= float(loss)
    soft3 = np.abs(rng.standard_normal((4, 9, 32))).astype(np.float32)
    np.testing.assert_allclose(float(td.discretization_loss(_t(soft3), 2, 0.05)),
                               float(jd.discretization_loss(jnp.asarray(soft3), 2, 0.05)), rtol=1e-5)


def test_tokenize_shapes_2d(setup2d):
    cfg, params, model = setup2d
    img = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    codes = td.get_codebook_indices(model, cfg, _t(img)).numpy()
    assert codes.shape == (2, 4, 4)  # two stride-2 layers on both axes
    assert ((codes >= 0) & (codes < cfg.num_tokens)).all()
    np.testing.assert_array_equal(codes, np.asarray(_jit(jd.get_codebook_indices, cfg)(params, jnp.asarray(img))))


def test_decode_flat_codes_folds_square(setup2d):
    cfg, params, model = setup2d
    codes = rng.integers(0, 64, (2, 16))  # flat, like the reference
    with torch.no_grad():
        img = td.decode(model, cfg, _t(codes)).numpy()
    assert img.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(img, np.asarray(_jit(jd.decode, cfg)(params, jnp.asarray(codes))), atol=TOL, rtol=0)


def test_round_trip_2d(setup2d):
    cfg, params, model = setup2d
    img = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        out = td.dvae_infer(model, cfg, _t(img)).numpy()
        again = td.dvae_infer(model, cfg, _t(img)).numpy()
    assert out.shape == img.shape
    np.testing.assert_array_equal(out, again)
    np.testing.assert_allclose(out, np.asarray(_jit(jd.dvae_infer, cfg)(params, jnp.asarray(img))), atol=TOL, rtol=0)


def test_training_forward_2d(setup2d):
    """2-D: the crop takes the width (the last positional dim)."""
    cfg, params, model = setup2d
    _grads_match(cfg, params, model, rng.standard_normal((2, 16, 14, 3)).astype(np.float32))


def test_ema_update_2d(setup2d):
    cfg, params, model = setup2d
    img = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    logits = jd.dvae_encode(params, cfg, jnp.asarray(img))
    gold = jd.quantize_ema_update(params["codebook"], logits, cfg.num_tokens)
    cb = td.Codebook(cfg.codebook_dim, cfg.num_tokens)
    load_jax_params(cb, params["codebook"])
    with torch.no_grad():
        mine = td.dvae_encode(model, cfg, _t(img))
    np.testing.assert_allclose(mine.numpy(), np.asarray(logits), atol=TOL, rtol=0)
    td.quantize_ema_update(cb, _t(np.asarray(logits)), cfg.num_tokens)
    assert np.isfinite(cb.embed.numpy()).all()
    for k in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(getattr(cb, k).numpy(), np.asarray(gold[k]), atol=1e-5, rtol=1e-5, err_msg=k)


def test_transposed_convs_raise_as_in_jax():
    with pytest.raises(NotImplementedError, match="nearest-upsample"):
        td.DiscreteVAE(small_cfg(use_transposed_convs=True))


def test_reset_parameters_distributions():
    cfg = small_cfg()
    model = td.DiscreteVAE(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    cb = model.codebook
    assert torch.equal(cb.embed, cb.embed_avg) and not cb.cluster_size.any()
    assert 0.8 < float(cb.embed.std()) < 1.2
    w = model.enc_convs[0].weight
    assert float(w.abs().max()) <= 1 / np.sqrt(80 * 3) and float(w.abs().max()) > 0.5 / np.sqrt(80 * 3)


@pytest.mark.parametrize("kw", [{}, dict(num_layers=1), dict(num_layers=3, num_resnet_blocks=2)])
def test_convert_dvae_matches_jax(kw):
    """convert_dvae leaf for leaf against JAX's on make_dvae_state_dict, then
    the converted weights through both packages' round trip."""
    cfg = small_cfg(**kw)
    sd = {k: v.numpy() for k, v in make_dvae_state_dict(cfg).items()}
    mine, gold = tconv.convert_dvae(sd, cfg), jconv.convert_dvae(sd, cfg)
    assert_trees_equal(mine, gold)
    model = td.DiscreteVAE(cfg)
    load_jax_params(model, mine)
    mel = rng.standard_normal((1, 32, 80)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, gold)
    codes = td.get_codebook_indices(model, cfg, _t(mel))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(_jit(jd.get_codebook_indices, cfg)(jp, jnp.asarray(mel))))
    with torch.no_grad():
        np.testing.assert_allclose(td.dvae_infer(model, cfg, _t(mel)).numpy(),
                                   np.asarray(_jit(jd.dvae_infer, cfg)(jp, jnp.asarray(mel))), atol=TOL, rtol=0)
