"""Int8 parity: the port's weight quantizer, K5's plain version, the weight
bridge of a quantized tree, the int8 KV cache and the decode on int8
weights, against indextts_tpu on the same JAX-initialized weights, float32
on the CPU.

JAX takes its K5 route (ops/pallas/qmatmul.py, interpret mode on the CPU)
for 2-D int8 matmuls only when indextts_tpu.ops.quant.PALLAS_INT8 is set;
the tests of int8 weights set it with monkeypatch, so both packages run the
same kernel function. Quantized bytes must be equal, greedy codes token for
token, logits and latents within 1e-4 absolute."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import indextts_tpu.models.gpt_decode as jdec
import indextts_tpu.ops.quant as jquant
from indextts_tpu.models.gpt import get_conditioning as jax_get_conditioning
from indextts_tpu.models.gpt import init_unified_voice
from indextts_tpu.models.gpt import unified_voice_forward as jax_forward
from indextts_tpu.ops.pallas.qmatmul import int8_matmul as jax_int8_matmul
import indextts_tpu_torch.models.gpt_decode as tdec
import indextts_tpu_torch.ops.quant as tquant
from indextts_tpu_torch.models.gpt import UnifiedVoice, unified_voice_forward
from indextts_tpu_torch.ops.cuda.qmatmul import int8_matmul_plain
from indextts_tpu_torch.weights import load_jax_params
from tests.test_gpt import tiny_cfg

TOL = 1e-4
rng = np.random.default_rng(23)

TEXT = np.asarray([[5, 6, 7, 8, 9, 1, 1, 1], [11, 12, 13, 1, 1, 1, 1, 1]], np.int32)
LENS = np.asarray([5, 3], np.int32)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a).long() if a.dtype.kind in "iu" else torch.from_numpy(a)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    params = init_unified_voice(jax.random.PRNGKey(0), cfg)
    # a sharper mel head than the 0.02 init: decodes run several tokens and
    # the logits are far from ties
    params["mel_head"]["weight"] = jnp.asarray(
        rng.standard_normal(params["mel_head"]["weight"].shape).astype(np.float32) * 0.3)
    mel = rng.standard_normal((1, 40, 100)).astype(np.float32)
    conds = np.asarray(jax_get_conditioning(params, cfg, jnp.asarray(mel), jnp.asarray([40])))
    qparams = jquant.quantize_unified_voice(params)
    models = {}
    for name, tree, quantize in (("fp", params, False), ("int8", qparams, False), ("int8_port", params, True)):
        m = UnifiedVoice(cfg)
        load_jax_params(m, tree)
        if quantize:
            tquant.quantize_unified_voice(m)
        models[name] = m.eval()
    return cfg, params, qparams, models, np.repeat(conds, 2, axis=0)


# ---------------------------------------------------------------------------
# weights and K5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 96), (300, 700), (3, 16, 32)])
def test_quantize_weight_bytes_match_jax(shape):
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 2.0, shape[-1])).astype(np.float32)
    gold = jquant.quantize_weight(jnp.asarray(w))
    mine = tquant.quantize_weight(torch.from_numpy(w))
    assert mine["weight"].dtype == torch.int8 and mine["scale"].dtype == torch.float32
    assert tuple(mine["scale"].shape) == tuple(gold["scale"].shape) == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(mine["weight"].numpy(), np.asarray(gold["weight"]))
    np.testing.assert_allclose(mine["scale"].numpy(), np.asarray(gold["scale"]), rtol=1e-7, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(8, 300, 700), (3, 96, 514)])
def test_int8_matmul_plain_matches_jax_kernel(dtype, m, k, n):
    """K5's plain version against the Pallas kernel in interpret mode; the
    second shape has a ragged N (8194 = 2 mod 4, as the mel head). Both
    round x to bf16 and sum exact products in float32, so float32 output
    agrees to 1e-5 relative; bf16 output may differ by one bf16 rounding."""
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    qd = jquant.quantize_weight(jnp.asarray(w))
    xj = jnp.asarray(x, getattr(jnp, dtype))
    gold = np.asarray(jax_int8_matmul(xj, qd["weight"], qd["scale"], bias=jnp.asarray(b), interpret=True),
                      np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    mine = int8_matmul_plain(xt, torch.from_numpy(np.asarray(qd["weight"]).T.copy()),
                             torch.from_numpy(np.asarray(qd["scale"]).reshape(-1).copy()), torch.from_numpy(b))
    assert mine.dtype == xt.dtype and mine.shape == (m, n)
    err = np.abs(mine.float().numpy() - gold)
    bound = 1e-5 * np.abs(gold).max()
    if dtype == "bfloat16":
        bound = bound + 2.0 ** (np.floor(np.log2(np.maximum(np.abs(gold), 1e-30))) - 7)
    assert (err <= bound).all(), err.max()


def test_matmul_maybe_quantized_routes_match_dequantized():
    """2-D input (K5's plain version) and 3-D input (dequantize, then matmul)
    both equal JAX's dequantized matmul on the same bytes."""
    w = rng.standard_normal((64, 96)).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    qd = jquant.quantize_weight(jnp.asarray(w))
    gold = np.asarray(jquant.matmul_maybe_quantized(
        jnp.asarray(x), {"weight": qd["weight"], "scale": qd["scale"], "bias": jnp.asarray(b)}, use_pallas=False))
    wq = torch.from_numpy(np.asarray(qd["weight"]).T.copy())
    s = torch.from_numpy(np.asarray(qd["scale"]).reshape(-1).copy())
    three = tquant.matmul_maybe_quantized(torch.from_numpy(x), wq, s, torch.from_numpy(b))
    np.testing.assert_allclose(three.numpy(), gold, atol=1e-5, rtol=0)
    # the 2-D route rounds x to bf16 first, as the JAX kernel does: on
    # bf16-exact rows the two routes agree
    xb = torch.from_numpy(x[0]).to(torch.bfloat16).float()
    two = tquant.matmul_maybe_quantized(xb, wq, s, torch.from_numpy(b))
    np.testing.assert_allclose(two.numpy(), tquant.matmul_maybe_quantized(xb[None], wq, s, torch.from_numpy(b))[0],
                               atol=1e-5, rtol=0)


def test_quantize_unified_voice_bridge(setup):
    """A quantized JAX tree bridged into the port equals the port's own
    quantize_unified_voice of the bridged float weights, byte for byte; the
    four block linears and the mel head are QuantLinear, the text head not."""
    cfg, _, qparams, models, _ = setup
    bridged, own = models["int8"], models["int8_port"]
    for m in (bridged, own):
        assert isinstance(m.mel_head, tquant.QuantLinear) and isinstance(m.text_head, torch.nn.Linear)
        for blk in m.gpt.blocks:
            assert all(isinstance(getattr(blk, n), tquant.QuantLinear) for n in ("attn_qkv", "attn_proj", "mlp_fc", "mlp_proj"))
    sd_b, sd_o = bridged.state_dict(), own.state_dict()
    assert sd_b.keys() == sd_o.keys()
    for key in sd_b:
        np.testing.assert_array_equal(sd_b[key].numpy(), sd_o[key].numpy(), err_msg=key)
    jq = np.asarray(qparams["gpt"]["blocks"]["mlp_fc"]["weight"])  # [L, K, N]
    np.testing.assert_array_equal(bridged.gpt.blocks[1].mlp_fc.weight.numpy(), jq[1].T)
    np.testing.assert_array_equal(bridged.mel_head.scale.numpy(), np.asarray(qparams["mel_head"]["scale"])[0])
    with pytest.raises(TypeError, match="quantized"):
        load_jax_params(copy.deepcopy(own), jax.tree_util.tree_map(np.asarray, setup[1]))


# ---------------------------------------------------------------------------
# the int8 KV cache
# ---------------------------------------------------------------------------


def _unpair(t):
    """JAX head-paired [L, B, H/2, S, 2*Dh] -> [L, B, H, S, Dh]."""
    l, b, g2, s, dh2 = t.shape
    return np.asarray(t).reshape(l, b, g2, s, 2, dh2 // 2).transpose(0, 1, 2, 4, 3, 5).reshape(l, b, 2 * g2, s, dh2 // 2)


def test_quant_cols_scales_are_per_head_pair():
    cfg = tiny_cfg()
    t = rng.standard_normal((2, 3, cfg.heads, 7, cfg.head_dim)).astype(np.float32)
    t[:, :, 1::2] *= 0.01  # odd heads small: a per-head scale would differ
    q2, s2 = jdec._quant_cols(jdec._pair_heads(jnp.asarray(t)))
    q, s = tdec._quant_cols(torch.from_numpy(t))
    assert tuple(s.shape) == (2, 3, cfg.heads // 2, 7)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s2))
    np.testing.assert_array_equal(q.numpy(), _unpair(q2))
    np.testing.assert_allclose(s.numpy(), np.abs(t).reshape(2, 3, cfg.heads // 2, 2, 7, -1).max(axis=(3, 5)) / 127,
                               rtol=1e-6)


def test_prefill_int8_cache_matches_jax(setup):
    cfg, params, _, models, conds = setup
    emb_j, mask_j = jdec.prepare_gpt_inputs(params, cfg, jnp.asarray(conds), jnp.asarray(TEXT), jnp.asarray(LENS))
    p = emb_j.shape[1]
    logits_j, (k8j, ksj, v8j, vsj) = jdec._prefill(params, cfg, emb_j, mask_j, p + 4, quant_kv=True)
    with torch.no_grad():
        emb, mask = tdec.prepare_gpt_inputs(models["fp"], cfg, _t(conds), _t(TEXT), _t(LENS))
        logits, (k8, ks, v8, vs) = tdec._prefill(models["fp"], cfg, emb, mask, p + 4, quant_kv=True)
    assert k8.dtype == torch.int8 and k8.shape == (cfg.layers, 2, cfg.heads, p + 4, cfg.head_dim)
    assert ks.shape == (cfg.layers, 2, cfg.heads // 2, p + 4)
    np.testing.assert_array_equal(k8.numpy(), _unpair(k8j))
    np.testing.assert_array_equal(v8.numpy(), _unpair(v8j))
    np.testing.assert_allclose(ks.numpy(), np.asarray(ksj), rtol=1e-5, atol=0)
    np.testing.assert_allclose(vs.numpy(), np.asarray(vsj), rtol=1e-5, atol=0)
    assert not ks[..., p:].any() and not k8[..., p:, :].any()  # pad columns: zero bytes, zero scales
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), atol=TOL, rtol=0)


@pytest.mark.parametrize("weights", ["fp", "int8"])
def test_forced_step_logits_on_int8_cache_match_jax(setup, weights, monkeypatch):
    """Prefill and forced decode steps on the int8 cache: the logits of every
    step agree with JAX's within 1e-4."""
    cfg, params, qparams, models, conds = setup
    monkeypatch.setattr(jquant, "PALLAS_INT8", True)
    jparams, model = (params, models["fp"]) if weights == "fp" else (qparams, models["int8"])
    steps = 6
    forced = rng.integers(2, 60, (2, steps)).astype(np.int32)
    emb_j, mask_j = jdec.prepare_gpt_inputs(jparams, cfg, jnp.asarray(conds), jnp.asarray(TEXT), jnp.asarray(LENS))
    p = emb_j.shape[1]
    lg, cache_j = jdec._prefill(jparams, cfg, emb_j, mask_j, p + steps, quant_kv=True)
    gold = [np.asarray(lg)]
    pv = jnp.pad(mask_j, ((0, 0), (0, steps)))
    cpos = jnp.arange(p + steps)[None, :]
    for i in range(steps - 1):
        valid = pv | ((cpos >= p) & (cpos < p + i))
        lg, cache_j = jdec._decode_step(jparams, cfg, jnp.asarray(forced[:, i]), i + 2, cache_j, p + i, valid)
        gold.append(np.asarray(lg))
    with torch.no_grad():
        emb, mask = tdec.prepare_gpt_inputs(model, cfg, _t(conds), _t(TEXT), _t(LENS))
        lg_t, cache = tdec._prefill(model, cfg, emb, mask, p + steps, quant_kv=True)
        mine = [lg_t.numpy()]
        pv_t = torch.nn.functional.pad(mask, (0, steps))
        pos = torch.arange(p + steps)[None, :]
        for i in range(steps - 1):
            valid = pv_t | ((pos >= p) & (pos < p + i))
            mine.append(tdec._decode_step(model, cfg, _t(forced[:, i]), i + 2, cache, p + i, valid).numpy())
    np.testing.assert_allclose(np.stack(mine), np.stack(gold), atol=TOL, rtol=0)


@pytest.mark.parametrize("setup_name", ["quant_kv", "int8_weights", "both"])
def test_greedy_codes_match_jax(setup, setup_name, monkeypatch):
    cfg, params, qparams, models, conds = setup
    monkeypatch.setattr(jquant, "PALLAS_INT8", True)
    quant_kv = setup_name != "int8_weights"
    jparams, model = (params, models["fp"]) if setup_name == "quant_kv" else (qparams, models["int8"])
    gen = dict(do_sample=False, max_new_tokens=16)
    gold, gold_lens = jdec.generate_speech(jparams, cfg, jdec.GenerationConfig(**gen), jnp.asarray(conds),
                                           jnp.asarray(TEXT), jnp.asarray(LENS), jax.random.PRNGKey(0),
                                           repetition_penalty=1.0, quant_kv=quant_kv)
    codes, lens = tdec.generate_speech(model, cfg, tdec.GenerationConfig(**gen), _t(conds), _t(TEXT), _t(LENS),
                                       torch.Generator(), repetition_penalty=1.0, quant_kv=quant_kv)
    assert np.asarray(gold_lens).min() > 3  # a real decode, not an immediate stop
    np.testing.assert_array_equal(codes.numpy(), np.asarray(gold))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(gold_lens))


def test_k5_calls_per_generate(setup, monkeypatch):
    """On int8 weights a generate call runs the 2-D int8 matmul (K5 on the
    card) 1 + (4 * layers + 1) * steps times, steps = max(lengths) - 1: the
    prefill's mel head, then per step the four block matmuls of each layer
    and the mel head. The prefill and teacher-forced matmuls are 3-D."""
    cfg, _, _, models, conds = setup
    calls = []
    monkeypatch.setattr(tquant, "int8_matmul", lambda x, *a: calls.append(x.shape) or int8_matmul_plain(x, *a))
    _, lens = tdec.generate_speech(models["int8"], cfg, tdec.GenerationConfig(do_sample=False, max_new_tokens=16),
                                   _t(conds), _t(TEXT), _t(LENS), torch.Generator(), quant_kv=True)
    steps = int(lens.max()) - 1
    assert steps > 2 and len(calls) == 1 + (4 * cfg.layers + 1) * steps
    assert all(len(s) == 2 and s[0] == 2 for s in calls)


def test_teacher_forced_latents_on_int8_weights_match_jax(setup):
    cfg, _, qparams, models, conds = setup
    codes = rng.integers(0, 64, (2, 16)).astype(np.int32)
    wav_lens = np.asarray([9, 4]) * cfg.mel_length_compression
    gold = jax_forward(qparams, cfg, None, jnp.asarray(TEXT), jnp.asarray(LENS), jnp.asarray(codes),
                       jnp.asarray(wav_lens), None, return_latent=True, conds=jnp.asarray(conds), mask_pad_keys=True)
    with torch.no_grad():
        mine = unified_voice_forward(models["int8"], cfg, _t(TEXT), _t(LENS), _t(codes), _t(wav_lens), _t(conds))
    assert mine.shape == gold.shape == (2, 16, cfg.model_dim)
    np.testing.assert_allclose(mine.numpy(), np.asarray(gold), atol=TOL, rtol=0)
