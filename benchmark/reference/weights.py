"""The benchmark's weights: every tensor of a configuration's model (the
tensors its architecture's reference lists, reference/models/<architecture>.py
`weight_spec`) and of its vocoder (BigVGAN with its ECAPA speaker encoder,
listed here), named as the checkpoint's converted state dict names them,
made from a seed.

The weights are the benchmark's own: the program under test receives a copy
(through its modules' load_state_dict), and the plain reference reads the
same tensors. Values are drawn on the given device from one torch.Generator
in two large calls (one normal draw for every matrix, one for every vector),
then scaled per tensor, and stored in the type they are served in.

Distributions (random weights are enough for speed and for agreement with
the reference): matrices and convolutions ~ N(0, std) with the stds the
architecture's spec gives (for GPT-2: 0.02, residual projections
0.02 / sqrt(2 * layers)); in the
vocoder, gains that keep the signal's scale through the trunk (each upsample
1 / sqrt(fan_in / stride), each resblock convolution 0.5 / sqrt(fan_in), the
post convolution 0.25 / sqrt(fan_in): a waveform of about 0.2 RMS that never
saturates the tanh, far above int16's step); 1 / sqrt(3 * fan_in) elsewhere
(the variance of the usual U(+-1/sqrt(fan_in))); biases N(0, 0.01);
norm gains 1 + N(0, 0.05); snake parameters N(0, 0.1) in log scale;
BatchNorm statistics near the identity. The stop code's logit bias (the
architecture's `stop_logit`) is set to STOP_BIAS, so that no row stops
before its budget.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# the stop code's logit bias: rows run to their budget, so the work of a
# request is fixed by the traffic
STOP_BIAS = -40.0

# (name, shape, kind, std); kind: "w" a matrix drawn N(0, std), "b" a vector
# drawn N(0, std), "g" a gain 1 + N(0, std), "z" zeros, "pe" the conformer's
# sinusoidal table, "count" a BatchNorm counter, "var" 1 + |N(0, std)|
Spec = List[Tuple[str, Tuple[int, ...], str, float]]


def lin(spec: Spec, name: str, fan_out: int, fan_in: int, std: float, bias: bool = True) -> None:
    spec.append((f"{name}.weight", (fan_out, fan_in), "w", std))
    if bias:
        spec.append((f"{name}.bias", (fan_out,), "b", 0.01))


def conv(spec: Spec, name: str, cout: int, cin: int, k: int, std: float = None, bias: bool = True) -> None:
    std = std if std is not None else 1.0 / math.sqrt(3 * cin * k)
    spec.append((f"{name}.weight", (cout, cin, k), "w", std))
    if bias:
        spec.append((f"{name}.bias", (cout,), "b", 0.01))


def ln(spec: Spec, name: str, d: int) -> None:
    spec.append((f"{name}.weight", (d,), "g", 0.05))
    spec.append((f"{name}.bias", (d,), "b", 0.01))


def default_std(fan_in: int) -> float:
    return 1.0 / math.sqrt(3 * fan_in)


# ECAPA-TDNN's fixed widths (ECAPA_TDNN.py:470-484)
ECAPA_CHANNELS = (512, 512, 512, 512, 1536)
ECAPA_KERNELS = (5, 3, 3, 3, 1)
ECAPA_DILATIONS = (1, 2, 3, 4, 1)


def _bn(spec: Spec, name: str, c: int) -> None:
    spec.append((f"{name}.weight", (c,), "g", 0.05))
    spec.append((f"{name}.bias", (c,), "b", 0.01))
    spec.append((f"{name}.running_mean", (c,), "b", 0.05))
    spec.append((f"{name}.running_var", (c,), "var", 0.1))
    spec.append((f"{name}.num_batches_tracked", (), "count", 0.0))


def _tdnn(spec: Spec, name: str, cin: int, cout: int, k: int) -> None:
    conv(spec, f"{name}.conv", cout, cin, k)
    _bn(spec, f"{name}.bn", cout)


def vocoder_spec(h: dict) -> Spec:
    """BigVGAN's tensors for the `bigvgan` section of a configuration."""
    if h["resblock"] != "1" or h["activation"] != "snakebeta" or not h["feat_upsample"]:
        raise ValueError("the reference implements AMPBlock1 resblocks, SnakeBeta and the 4x feature upsample")
    c0 = h["upsample_initial_channel"]
    spk = h["speaker_embedding_dim"]
    spec: Spec = []
    conv(spec, "conv_pre", c0, h["gpt_dim"], 7)
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        cin, cout = c0 // 2**i, c0 // 2 ** (i + 1)
        spec.append((f"ups.{i}.weight", (cin, cout, k), "w", 1.0 / math.sqrt(cin * k / u)))
        spec.append((f"ups.{i}.bias", (cout,), "b", 0.01))
    n_k = len(h["resblock_kernel_sizes"])
    for i in range(len(h["upsample_rates"])):
        ch = c0 // 2 ** (i + 1)
        for j, (k, dils) in enumerate(zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"])):
            p = f"resblocks.{i * n_k + j}"
            for n in range(len(dils)):
                conv(spec, f"{p}.convs1.{n}", ch, ch, k, 0.5 / math.sqrt(ch * k))
            for n in range(len(dils)):
                conv(spec, f"{p}.convs2.{n}", ch, ch, k, 0.5 / math.sqrt(ch * k))
            for n in range(2 * len(dils)):
                spec.append((f"{p}.acts.{n}.alpha", (ch,), "b", 0.1))
                spec.append((f"{p}.acts.{n}.beta", (ch,), "b", 0.1))
    ch_last = c0 // 2 ** len(h["upsample_rates"])
    for i in range(len(h["upsample_rates"])):
        conv(spec, f"conds.{i}", c0 // 2 ** (i + 1), spk, 1)
    spec.append(("activation_post.alpha", (ch_last,), "b", 0.1))
    spec.append(("activation_post.beta", (ch_last,), "b", 0.1))
    conv(spec, "conv_post", 1, ch_last, 7, 0.25 / math.sqrt(ch_last * 7))
    e = "speaker_encoder"
    ch, ks, ds = ECAPA_CHANNELS, ECAPA_KERNELS, ECAPA_DILATIONS
    _tdnn(spec, f"{e}.block0", h["num_mels"], ch[0], ks[0])
    for i in range(1, 4):
        p = f"{e}.block{i}"
        hid = ch[i] // 8
        _tdnn(spec, f"{p}.tdnn1", ch[i - 1], ch[i], 1)
        for n in range(7):
            _tdnn(spec, f"{p}.res2net.{n}", hid, hid, ks[i])
        _tdnn(spec, f"{p}.tdnn2", ch[i], ch[i], 1)
        conv(spec, f"{p}.se_conv1", 128, ch[i], 1)
        conv(spec, f"{p}.se_conv2", ch[i], 128, 1)
    _tdnn(spec, f"{e}.mfa", ch[3] * 3, ch[4], ks[4])
    _tdnn(spec, f"{e}.asp_tdnn", ch[4] * 3, 128, 1)
    conv(spec, f"{e}.asp_conv", ch[4], 128, 1)
    _bn(spec, f"{e}.asp_bn", ch[4] * 2)
    conv(spec, f"{e}.fc", spk, ch[4] * 2, 1)
    conv(spec, "cond_layer", c0, spk, 1)
    return spec


def sinusoidal_pe(max_len: int, d: int) -> np.ndarray:
    """The conformer's sinusoidal position table (embedding.py:47-54)."""
    pe = np.zeros((max_len, d), np.float32)
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def make(spec: Spec, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every tensor of `spec`, from `seed`, on `device` in `dtype` (BatchNorm
    counters int64). Two draws: one normal buffer for the matrices, one for
    the vectors; each tensor is a scaled view of its slice."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {kind: sum(int(np.prod(s)) for _, s, k, _ in spec if k == kind) for kind in ("w", "b", "g", "var")}
    mats = torch.randn(sizes["w"], generator=gen, device=device, dtype=dtype)
    vecs = torch.randn(sizes["b"] + sizes["g"] + sizes["var"], generator=gen, device=device, dtype=dtype)
    out: Dict[str, torch.Tensor] = {}
    at = {"w": 0, "v": 0}
    for name, shape, kind, std in spec:
        n = int(np.prod(shape))
        if kind == "w":
            t = mats[at["w"] : at["w"] + n].view(shape).mul_(std)
            at["w"] += n
        elif kind in ("b", "g", "var"):
            t = vecs[at["v"] : at["v"] + n].view(shape).mul_(std)
            at["v"] += n
            if kind == "g":
                t.add_(1.0)
            elif kind == "var":
                t.abs_().add_(1.0)
        elif kind == "z":
            t = torch.zeros(shape, device=device, dtype=dtype)
        elif kind == "pe":
            t = torch.from_numpy(sinusoidal_pe(*shape)).to(device=device, dtype=dtype)
        elif kind == "count":
            t = torch.zeros(shape, device=device, dtype=torch.long)
        else:
            raise ValueError(kind)
        out[name] = t
    return out


def make_model(arch, g: dict, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The weights of the model section `g` of a configuration whose
    architecture's reference is the module `arch`, the stop code's bias
    lowered."""
    w = make(arch.weight_spec(g), seed, device, dtype)
    name, index = arch.stop_logit(g)
    w[name][index] = STOP_BIAS
    return w


def make_vocoder(h: dict, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The vocoder's weights (their own draw, from seed + 1)."""
    return make(vocoder_spec(h), seed + 1, device, dtype)
