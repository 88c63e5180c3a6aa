"""Port parity for the ops: norms, activations, convolutions and the logits
processors of indextts_tpu_torch against indextts_tpu, on the same
numpy-seeded inputs, in float32 on the CPU. Tolerance 1e-5 throughout."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from indextts_tpu.ops import activations as jact
from indextts_tpu.ops import conv as jconv
from indextts_tpu.ops import norms as jnorms
from indextts_tpu.ops import sampling as jsamp
from indextts_tpu_torch.ops import activations as tact
from indextts_tpu_torch.ops import conv as tconv
from indextts_tpu_torch.ops import norms as tnorms
from indextts_tpu_torch.ops import sampling as tsamp

TOL = 1e-5
rng = np.random.default_rng(5)


def _f32(*shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(mine, gold, tol=TOL):
    mine = mine.detach().numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    gold = np.asarray(gold)
    assert mine.shape == gold.shape
    np.testing.assert_allclose(mine, gold, atol=tol, rtol=0)


# ---------------------------------------------------------------- norms


def test_layer_norm():
    x, g, b = _f32(2, 7, 32), _f32(32), _f32(32)
    _close(tnorms.layer_norm(*map(torch.from_numpy, (x, g, b))), jnorms.layer_norm(*map(jnp.asarray, (x, g, b))))


def test_rms_norm():
    x, g = _f32(2, 5, 16), _f32(16)
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 4.0),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(g), 4.0))


def test_batch_norm_inference():
    x, g, b, m = _f32(2, 9, 12), _f32(12), _f32(12), _f32(12)
    v = np.abs(_f32(12)) + 0.5
    args = (x, g, b, m, v)
    _close(tnorms.batch_norm_inference(*map(torch.from_numpy, args)),
           jnorms.batch_norm_inference(*map(jnp.asarray, args)))


# ---------------------------------------------------------------- activations


def test_approx_sin():
    u = np.linspace(-50, 50, 4001).astype(np.float32)
    _close(tact.approx_sin(torch.from_numpy(u)), jact.approx_sin(jnp.asarray(u)))


@pytest.mark.parametrize("logscale", [False, True])
@pytest.mark.parametrize("approx", [False, True])
def test_snake_beta(logscale, approx):
    x, a, b = _f32(2, 11, 8), _f32(8, scale=0.3), _f32(8, scale=0.3)
    if not logscale:
        a, b = np.abs(a) + 0.2, np.abs(b) + 0.2
    _close(tact.snake_beta(*map(torch.from_numpy, (x, a, b)), logscale, approx),
           jact.snake_beta(*map(jnp.asarray, (x, a, b)), logscale, approx))


def test_snake():
    x, a = _f32(2, 11, 8), np.abs(_f32(8)) + 0.2
    _close(tact.snake(torch.from_numpy(x), torch.from_numpy(a)), jact.snake(jnp.asarray(x), jnp.asarray(a)))


def test_gelu_new():
    x = _f32(3, 40, scale=3.0)
    _close(tact.gelu_new(torch.from_numpy(x)), jact.gelu_new(jnp.asarray(x)))


def test_gelu():
    x = _f32(3, 40, scale=3.0)
    _close(tact.gelu(torch.from_numpy(x)), jact.gelu(jnp.asarray(x)))


# ---------------------------------------------------------------- convolutions


def _conv_w(k, cin, cout):
    """A JAX-layout conv weight and its torch-layout twin."""
    w = _f32(k, cin, cout, scale=1.0 / np.sqrt(k * cin))
    return w, np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


@pytest.mark.parametrize(
    "k,cin,cout,stride,padding,dilation,groups",
    [
        (3, 8, 6, 1, 1, 1, 1),
        (5, 8, 8, 1, 4, 2, 1),
        (12, 4, 4, 2, 0, 1, 4),  # depthwise stride 2: the anti-alias downsampler
        (7, 6, 4, 1, (2, 4), 1, 2),
        (1, 8, 3, 1, 0, 1, 1),
    ],
)
def test_conv1d(k, cin, cout, stride, padding, dilation, groups):
    x = _f32(2, 23, cin)
    wj, wt = _conv_w(k, cin // groups, cout)
    bias = _f32(cout)
    gold = jconv.conv1d(jnp.asarray(x), jnp.asarray(wj), jnp.asarray(bias), stride=stride, padding=padding,
                        dilation=dilation, groups=groups)
    mine = tconv.conv1d(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(bias), stride=stride,
                        padding=padding, dilation=dilation, groups=groups)
    _close(mine, gold)


@pytest.mark.parametrize("k,cin,cout,stride,padding,groups", [(8, 6, 4, 4, 2, 1), (4, 4, 2, 2, 1, 1),
                                                               (12, 5, 5, 2, 0, 5)])
def test_conv_transpose1d(k, cin, cout, stride, padding, groups):
    x = _f32(2, 9, cin)
    wj = _f32(k, cout // groups, cin, scale=0.3)  # JAX [K, Cout/g, Cin]
    wt = np.ascontiguousarray(np.transpose(wj, (2, 1, 0)))  # torch [Cin, Cout/g, K]
    bias = _f32(cout)
    gold = jconv.conv_transpose1d(jnp.asarray(x), jnp.asarray(wj), jnp.asarray(bias), stride=stride,
                                  padding=padding, groups=groups)
    mine = tconv.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(bias),
                                  stride=stride, padding=padding, groups=groups)
    _close(mine, gold)


@pytest.mark.parametrize("stride,padding", [(2, 0), (1, 1), ((2, 1), (0, 2))])
def test_conv2d(stride, padding):
    x = _f32(2, 13, 11, 3)
    wj = _f32(3, 3, 3, 5, scale=0.3)  # [Kh, Kw, Cin, Cout]
    wt = np.ascontiguousarray(np.transpose(wj, (3, 2, 0, 1)))
    bias = _f32(5)
    gold = jconv.conv2d(jnp.asarray(x), jnp.asarray(wj), jnp.asarray(bias), stride=stride, padding=padding)
    mine = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(bias), stride=stride,
                        padding=padding)
    _close(mine, gold)


@pytest.mark.parametrize("k,d", [(5, 1), (3, 2), (3, 4), (1, 1)])
@pytest.mark.parametrize("mode", ["reflect", "replicate"])
def test_sb_same_pad(k, d, mode):
    x = _f32(2, 17, 6)
    _close(tconv.sb_same_pad(torch.from_numpy(x), k, d, mode), jconv.sb_same_pad(jnp.asarray(x), k, d, mode))


# ---------------------------------------------------------------- logits processors


def _logits_and_seen(b=3, v=97):
    logits = _f32(b, v, scale=2.0)
    logits[0, :5] = logits[0, 5]  # ties at the top-k boundary
    seen = rng.random((b, v)) < 0.2
    return logits, seen


@pytest.mark.parametrize(
    "kw",
    [
        dict(do_sample=False, repetition_penalty=10.0),
        dict(do_sample=True, repetition_penalty=10.0, temperature=1.0, top_k=30, top_p=0.8),
        dict(do_sample=True, repetition_penalty=1.3, temperature=0.7, top_k=0, top_p=0.9),
        dict(do_sample=True, repetition_penalty=2.0, temperature=1.3, top_k=5, top_p=1.0),
    ],
)
def test_process_logits(kw):
    logits, seen = _logits_and_seen()
    gold = np.asarray(jsamp.process_logits(jnp.asarray(logits), jnp.asarray(seen), **kw))
    mine = tsamp.process_logits(torch.from_numpy(logits), torch.from_numpy(seen), **kw).numpy()
    masked = gold <= jsamp.NEG_INF
    np.testing.assert_array_equal(mine <= tsamp.NEG_INF, masked)
    np.testing.assert_allclose(mine[~masked], gold[~masked], atol=TOL, rtol=0)


def test_greedy_token_first_of_ties():
    logits = np.zeros((2, 10), np.float32)
    logits[0, [3, 7]] = 1.0
    logits[1, 9] = 2.0
    mine = tsamp.greedy_token(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(mine, np.asarray(jsamp.greedy_token(jnp.asarray(logits))))


def test_inverse_cdf_token_follows_distribution():
    """A draw lands on each id with its probability; masked ids never."""
    logits = torch.tensor([[0.0, 1.0, float(tsamp.NEG_INF), 2.0]])
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([tsamp.sample_token(logits, g) for _ in range(4000)]).flatten()
    freq = torch.bincount(draws, minlength=4).float() / draws.numel()
    want = torch.softmax(logits[0], dim=-1)
    assert freq[2] == 0
    np.testing.assert_allclose(freq.numpy(), want.numpy(), atol=0.03)
