"""The port's other conditioning encoders against indextts_tpu on the same
weights, float32 on the CPU: the legacy AttentionBlock ConditioningEncoder
("perceiver", "default"), "conformer_encoder", every conformer input layer
and position encoding, the relative position bias, group_norm and
_convert_legacy_conditioning. Mirrors tests/test_gpt_extras.py::
TestLegacyConditioning and tests/test_conditioning.py::TestConformerVariants.

The JAX init zeroes each AttentionBlock's proj_out, which makes the block an
identity that any port passes; every AttentionBlock compared here has its
proj_out overwritten with seeded non-zero values first. Values agree within
1e-4 absolute; bucket ids, masks and converted trees exactly."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import indextts_tpu.convert as jconv
import indextts_tpu_torch.convert as tconv
from indextts_tpu.config import ConditionModuleConfig
from indextts_tpu.models import attention_block as jab
from indextts_tpu.models.conformer import conformer_apply, init_conformer
from indextts_tpu.models.gpt import get_conditioning as jax_get_conditioning
from indextts_tpu.models.gpt import init_unified_voice
from indextts_tpu.ops.norms import group_norm as jax_group_norm
from indextts_tpu_torch.models import attention_block as tab
from indextts_tpu_torch.models.conformer import ConformerEncoder
from indextts_tpu_torch.models.gpt import UnifiedVoice, get_conditioning
from indextts_tpu_torch.ops.norms import group_norm
from indextts_tpu_torch.weights import load_jax_params
from tests.make_torch_ckpt import make_gpt_state_dict
from tests.test_gpt_extras import cfg_with
from tests.test_torch_checkpoint import assert_trees_equal

TOL = 1e-4
rng = np.random.default_rng(31)


def _proj_out_nonzero(block: dict, rng_: np.random.Generator) -> dict:
    c = block["proj_out"]["weight"].shape[0]
    block["proj_out"] = {
        "weight": jnp.asarray(rng_.standard_normal((c, c)).astype(np.float32) / np.sqrt(c)),
        "bias": jnp.asarray(0.1 * rng_.standard_normal(c).astype(np.float32)),
    }
    return block


def _jax_conds(cfg, params, mel, lens):
    """JAX get_conditioning, jitted: one compile instead of one per op."""
    return jax.jit(lambda p, x, n: jax_get_conditioning(p, cfg, x, n))(params, jnp.asarray(mel), jnp.asarray(lens))


def _legacy_params(condition_type: str, seed: int = 0):
    cfg = cfg_with(condition_type)
    params = init_unified_voice(jax.random.PRNGKey(seed), cfg)
    r = np.random.default_rng(seed + 100)
    for blk in params["conditioning_encoder"]["attn"]:
        _proj_out_nonzero(blk, r)
    return cfg, params


@pytest.mark.parametrize("condition_type,lens", [("perceiver", [30, 30]), ("default", [30, 30]),
                                                 ("default", [30, 17])])
def test_legacy_conditioning_matches_jax(condition_type, lens):
    cfg, params = _legacy_params(condition_type)
    model = UnifiedVoice(cfg)
    load_jax_params(model, params)
    mel = rng.standard_normal((len(lens), max(lens), 100)).astype(np.float32)
    gold = np.asarray(_jax_conds(cfg, params, mel, lens))
    with torch.no_grad():
        mine = get_conditioning(model, cfg, torch.from_numpy(mel), torch.tensor(lens)).numpy()
    n_lat = cfg.condition_num_latent if condition_type == "perceiver" else 1
    assert mine.shape == gold.shape == (len(lens), n_lat, cfg.model_dim)
    np.testing.assert_allclose(mine, gold, atol=TOL, rtol=0)
    # the non-zero projections make each block more than the identity
    no_blocks = dict(params, conditioning_encoder=dict(params["conditioning_encoder"], attn=[]))
    assert not np.allclose(mine, np.asarray(_jax_conds(cfg, no_blocks, mel, lens)), atol=1e-3)


def test_conformer_encoder_condition_type_matches_jax():
    cfg = cfg_with("conformer_encoder")
    cfg.condition_module.output_size = cfg.model_dim
    params = init_unified_voice(jax.random.PRNGKey(3), cfg)
    model = UnifiedVoice(cfg)
    load_jax_params(model, params)
    assert model.perceiver_encoder is None
    mel = rng.standard_normal((2, 41, 100)).astype(np.float32)
    lens = [41, 26]
    gold = np.asarray(_jax_conds(cfg, params, mel, lens))
    with torch.no_grad():
        mine = get_conditioning(model, cfg, torch.from_numpy(mel), torch.tensor(lens)).numpy()
    assert mine.shape == gold.shape == (2, 20, cfg.model_dim)
    np.testing.assert_allclose(mine, gold, atol=TOL, rtol=0)


def test_gst_unsupported_like_reference():
    cfg = cfg_with("gst")
    with pytest.raises(NotImplementedError) as port_err:
        UnifiedVoice(cfg)
    with pytest.raises(NotImplementedError) as jax_err:
        init_unified_voice(jax.random.PRNGKey(0), cfg)
    assert str(port_err.value) == str(jax_err.value)


def test_conformer_encoder_width_mismatch_raises_like_jax():
    cfg = cfg_with("conformer_encoder")  # output_size 32 != model_dim 64
    with pytest.raises(NotImplementedError) as port_err:
        UnifiedVoice(cfg)
    with pytest.raises(NotImplementedError) as jax_err:
        init_unified_voice(jax.random.PRNGKey(0), cfg)
    assert str(port_err.value) == str(jax_err.value)


def test_unknown_input_layer_raises_value_error():
    cm = ConditionModuleConfig(output_size=32, linear_units=64, attention_heads=4, num_blocks=1,
                               input_layer="conv2d4")
    with pytest.raises(ValueError, match="unsupported input_layer"):
        ConformerEncoder(cm)
    with pytest.raises(ValueError, match="unsupported input_layer"):
        init_conformer(jax.random.PRNGKey(0), cm)


@pytest.mark.parametrize("pos", ["rel_pos", "abs_pos", "no_pos"])
@pytest.mark.parametrize("input_layer", ["linear", "conv2d2", "conv2d", "conv2d6", "conv2d8"])
def test_conformer_variants_match_jax(input_layer, pos):
    cm = ConditionModuleConfig(output_size=32, linear_units=64, attention_heads=4, num_blocks=1,
                               input_layer=input_layer, pos_enc_layer_type=pos)
    params = init_conformer(jax.random.PRNGKey(5), cm, input_size=100)
    model = ConformerEncoder(cm)
    load_jax_params(model, params)
    t = 61
    mel = rng.standard_normal((2, t, 100)).astype(np.float32)
    lens = [t, 40]
    gold, gold_mask = jax.jit(lambda p, x, n: conformer_apply(p, cm, x, n))(params, jnp.asarray(mel),
                                                                            jnp.asarray(lens))
    with torch.no_grad():
        mine, mask = model(torch.from_numpy(mel), torch.tensor(lens))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(gold_mask))
    assert mine.shape == gold.shape and mine.shape[1] == mask.shape[2]
    np.testing.assert_allclose(mine.numpy(), np.asarray(gold), atol=TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 64), (16, 20)])
def test_relative_position_bucket_exact(causal, num_buckets, max_distance):
    t = 150  # past max_distance, so the clamp at the last bucket is reached
    rel = np.arange(-t, t + 1)
    gold = np.asarray(jab._relative_position_bucket(jnp.asarray(rel), causal, num_buckets, max_distance))
    mine = tab._relative_position_bucket(torch.from_numpy(rel), causal, num_buckets, max_distance).numpy()
    np.testing.assert_array_equal(mine, gold)
    assert mine.max() == num_buckets - 1  # the far distances reach the clamp


def test_relative_position_bias_matches_jax():
    p = jab.init_relative_position_bias(jax.random.PRNGKey(4), heads=4)
    bias = tab.RelativePositionBias(4)
    load_jax_params(bias, p)
    gold = np.asarray(jab.relative_position_bias(p, 9, 13, scale=2.5))
    with torch.no_grad():
        mine = bias(9, 13, scale=2.5).numpy()
    assert mine.shape == gold.shape == (4, 9, 13)
    np.testing.assert_allclose(mine, gold, atol=1e-6, rtol=0)


@pytest.mark.parametrize("rel_pos,masked", [(False, False), (True, False), (True, True)])
def test_attention_block_matches_jax(rel_pos, masked):
    c, heads = 32, 4
    p = _proj_out_nonzero(jab.init_attention_block(jax.random.PRNGKey(6), c, num_heads=heads,
                                                   relative_pos_embeddings=rel_pos), np.random.default_rng(7))
    p["norm"] = {"weight": jnp.asarray(1 + 0.1 * rng.standard_normal(c).astype(np.float32)),
                 "bias": jnp.asarray(0.1 * rng.standard_normal(c).astype(np.float32))}
    if rel_pos:  # a bias large enough to move the softmax
        p["rel_pos"]["emb"] = p["rel_pos"]["emb"] * 50
    block = tab.AttentionBlock(c, heads, relative_pos_embeddings=rel_pos)
    load_jax_params(block, p)
    x = rng.standard_normal((2, 11, c)).astype(np.float32)
    mask = (np.arange(11)[None, :] < np.asarray([[11], [6]])).astype(np.float32) if masked else None
    gold = np.asarray(jab.attention_block_apply(p, jnp.asarray(x), heads,
                                                None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        mine = block(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(mine, gold, atol=TOL, rtol=0)
    assert np.abs(mine - x).max() > 1e-2


def test_attention_block_zero_proj_is_identity_at_init():
    """The port's init zeroes proj_out as JAX's does (arch_util.py:10-16): a
    freshly initialized block is the identity."""
    enc = tab.ConditioningEncoder(100, 32, attn_blocks=2, num_attn_heads=4)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.standard_normal((1, 10, 32)).astype(np.float32))
    with torch.no_grad():
        for blk in enc.attn:
            assert not blk.proj_out.weight.any() and not blk.proj_out.bias.any()
            np.testing.assert_allclose(blk(x).numpy(), x.numpy(), atol=1e-6)
    assert not enc.init.bias.any() and enc.init.weight.abs().max() <= 0.1


@pytest.mark.parametrize("channels", [8, 12, 16, 24, 48, 64, 96, 100, 512, 1280])
def test_norm_groups_matches_jax(channels):
    assert tab.norm_groups(channels) == jab.norm_groups(channels)


@pytest.mark.parametrize("shape,groups", [((2, 9, 32), 8), ((3, 7, 48), 3), ((4, 5, 6, 16), 4)])
def test_group_norm_matches_jax(shape, groups):
    x = (3 * rng.standard_normal(shape) + 1).astype(np.float32)
    g = (1 + 0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    gold = np.asarray(jax_group_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), groups))
    mine = group_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), groups).numpy()
    np.testing.assert_allclose(mine, gold, atol=1e-5, rtol=0)


def _legacy_state_dict(cfg, with_perceiver: bool, rel_pos_block: bool) -> dict:
    """gpt.pth for a legacy condition type: make_gpt_state_dict's GPT part,
    the AttentionBlock ConditioningEncoder (1x1 convs [Cout, Cin, 1]) and,
    for "perceiver", a perceiver of init_perceiver's default heads / ff_mult."""
    r = np.random.default_rng(8)
    t = lambda *shape: torch.from_numpy((0.05 * r.standard_normal(shape)).astype(np.float32))
    sd = {k: v for k, v in make_gpt_state_dict(cfg_with("conformer_perceiver")).items()
          if not k.startswith(("conditioning_encoder.", "perceiver_encoder."))}
    d = cfg.model_dim
    ce = "conditioning_encoder"
    sd[f"{ce}.init.weight"], sd[f"{ce}.init.bias"] = t(d, 100, 1), t(d)
    for i in range(6):
        p = f"{ce}.attn.{i}"
        sd[f"{p}.norm.weight"], sd[f"{p}.norm.bias"] = 1 + t(d), t(d)
        sd[f"{p}.qkv.weight"], sd[f"{p}.qkv.bias"] = t(3 * d, d, 1), t(3 * d)
        sd[f"{p}.proj_out.weight"], sd[f"{p}.proj_out.bias"] = t(d, d, 1), t(d)
    if rel_pos_block:
        sd[f"{ce}.attn.0.relative_pos_embeddings.relative_attention_bias.weight"] = t(32, cfg.heads)
    if with_perceiver:
        pe, inner, ff = "perceiver_encoder", 64 * 8, int(d * 4 * 2 / 3)
        sd[f"{pe}.latents"], sd[f"{pe}.norm.gamma"] = t(cfg.condition_num_latent, d), 1 + t(d)
        for i in range(2):
            q = f"{pe}.layers.{i}"
            sd[f"{q}.0.to_q.weight"], sd[f"{q}.0.to_kv.weight"] = t(inner, d), t(2 * inner, d)
            sd[f"{q}.0.to_out.weight"] = t(d, inner)
            sd[f"{q}.1.0.weight"], sd[f"{q}.1.0.bias"] = t(2 * ff, d), t(2 * ff)
            sd[f"{q}.1.2.weight"], sd[f"{q}.1.2.bias"] = t(d, ff), t(d)
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("condition_type", ["perceiver", "default"])
def test_convert_legacy_conditioning_matches_jax(condition_type):
    """Leaf for leaf against the JAX converter, then the converted weights
    through both packages' get_conditioning."""
    cfg = cfg_with(condition_type)
    sd = _legacy_state_dict(cfg, condition_type == "perceiver", rel_pos_block=False)
    mine, gold = tconv.convert_unified_voice(sd, cfg), jconv.convert_unified_voice(sd, cfg)
    assert_trees_equal(mine, gold)
    model = UnifiedVoice(cfg)
    load_jax_params(model, mine)
    mel = rng.standard_normal((1, 24, 100)).astype(np.float32)
    want = np.asarray(_jax_conds(cfg, gold, mel, [24]))
    with torch.no_grad():
        got = get_conditioning(model, cfg, torch.from_numpy(mel), torch.tensor([24])).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_convert_legacy_conditioning_keeps_relative_bias():
    sd = _legacy_state_dict(cfg_with("default"), False, rel_pos_block=True)
    mine, gold = tconv._convert_legacy_conditioning(sd), jconv._convert_legacy_conditioning(sd)
    assert_trees_equal(mine, gold)
    assert "rel_pos" in mine["attn"][0] and "rel_pos" not in mine["attn"][1]
