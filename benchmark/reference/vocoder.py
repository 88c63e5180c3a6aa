"""Plain PyTorch reference of IndexTTS-1.5's vocoder: BigVGAN (anti-aliased
SnakeBeta AMP blocks, the 4x feature upsample, speaker conditioning at the
input and every upsampling stage) and its ECAPA-TDNN speaker encoder, in
float32, one request at a time.

Written from the published model (indextts/BigVGAN/models.py, activations.py,
alias_free_torch/, ECAPA_TDNN.py of the reference implementation). It imports
nothing of the program under test. `W` maps the checkpoint's tensor names to
float32 tensors; `act` is applied to the input of every convolution.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .weights import ECAPA_DILATIONS, ECAPA_KERNELS

Act = Callable[[torch.Tensor], torch.Tensor]


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def conv(W, name: str, x: torch.Tensor, act: Act = _same, **kw) -> torch.Tensor:
    return F.conv1d(act(x), W[f"{name}.weight"], W.get(f"{name}.bias"), **kw)


# ---------------------------------------------------------------------------
# anti-aliased activation: 2x up (Kaiser-windowed sinc), SnakeBeta, 2x down
# ---------------------------------------------------------------------------


def kaiser_sinc(cutoff: float, half_width: float, size: int) -> np.ndarray:
    """The low-pass filter of alias_free_torch/filter.py for an even size."""
    half = size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(size, beta)
    time = np.arange(-half, half) + 0.5
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    return (filt / filt.sum()).astype(np.float32)


FILTER = kaiser_sinc(0.25, 0.3, 12)


def aa_snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """x [B, C, T]; log-scale alpha, beta [C]. Replicate pads as
    alias_free_torch/resample.py: up 5 each side, cropped 15 / 15; down 5 / 6."""
    c = x.shape[1]
    f = torch.as_tensor(FILTER, device=x.device).view(1, 1, -1).expand(c, 1, -1)
    y = 2.0 * F.conv_transpose1d(F.pad(x, (5, 5), mode="replicate"), f, stride=2, groups=c)
    y = y[..., 15:-15]
    a, b = torch.exp(alpha)[:, None], torch.exp(beta)[:, None]
    y = y + (1.0 / (b + 1e-9)) * torch.sin(y * a) ** 2
    return F.conv1d(F.pad(y, (5, 6), mode="replicate"), f, stride=2, groups=c)


# ---------------------------------------------------------------------------
# ECAPA-TDNN (eval mode)
# ---------------------------------------------------------------------------


def _bn(W, name: str, x: torch.Tensor) -> torch.Tensor:
    """Eval BatchNorm over the channels of x [B, C, T]."""
    inv = torch.rsqrt(W[f"{name}.running_var"] + 1e-5)
    return ((x - W[f"{name}.running_mean"][:, None]) * inv[:, None] * W[f"{name}.weight"][:, None]
            + W[f"{name}.bias"][:, None])


def _tdnn(W, name: str, x: torch.Tensor, k: int, d: int, act: Act) -> torch.Tensor:
    """'same' reflect padding (SpeechBrain), conv, ReLU, BatchNorm."""
    if k > 1:
        total = d * (k - 1)
        x = F.pad(x, (total // 2, total - total // 2), mode="reflect")
    return _bn(W, f"{name}.bn", torch.relu(conv(W, f"{name}.conv", x, act, dilation=d)))


def ecapa(W, mel: torch.Tensor, rel: float, act: Act = _same) -> torch.Tensor:
    """mel [T, n_mels] zero-padded, `rel` the share of its T frames that are
    the prompt's -> speaker embedding [512]."""
    e = "speaker_encoder"
    x = mel.T[None]  # [1, C, T]
    t = x.shape[-1]
    # the relative length is a float32 tensor in the reference (length_to_mask): frames below
    # float32(rel) * T, as float32 computes it, are the prompt's
    lim = torch.tensor(rel, dtype=torch.float32, device=x.device) * t
    mask = (torch.arange(t, dtype=torch.float32, device=x.device) < lim).float()[None, None, :]
    h = _tdnn(W, f"{e}.block0", x, ECAPA_KERNELS[0], ECAPA_DILATIONS[0], act)
    feats = []
    for i in range(1, 4):
        p = f"{e}.block{i}"
        res = h
        y = _tdnn(W, f"{p}.tdnn1", h, 1, 1, act)
        parts = y.chunk(8, dim=1)
        outs, prev = [parts[0]], None
        for j in range(1, 8):
            prev = _tdnn(W, f"{p}.res2net.{j - 1}", parts[j] if j == 1 else parts[j] + prev, ECAPA_KERNELS[i],
                         ECAPA_DILATIONS[i], act)
            outs.append(prev)
        y = _tdnn(W, f"{p}.tdnn2", torch.cat(outs, dim=1), 1, 1, act)
        s = (y * mask).sum(-1, keepdim=True) / mask.sum(-1, keepdim=True).clamp(min=1.0)
        s = torch.sigmoid(conv(W, f"{p}.se_conv2", torch.relu(conv(W, f"{p}.se_conv1", s, act)), act))
        h = s * y + res
        feats.append(h)
    h = _tdnn(W, f"{e}.mfa", torch.cat(feats, dim=1), 1, 1, act)
    # attentive statistics pooling with global context
    m = mask / mask.sum(-1, keepdim=True).clamp(min=1.0)
    mean = (m * h).sum(-1, keepdim=True)
    std = torch.sqrt((m * (h - mean) ** 2).sum(-1, keepdim=True).clamp(min=1e-12))
    attn_in = torch.cat([h, mean.expand_as(h), std.expand_as(h)], dim=1)
    attn = conv(W, f"{e}.asp_conv", torch.tanh(_tdnn(W, f"{e}.asp_tdnn", attn_in, 1, 1, act)), act)
    attn = torch.softmax(attn.masked_fill(mask == 0, float("-inf")), dim=-1)
    mean = (attn * h).sum(-1)
    std = torch.sqrt((attn * (h - mean[..., None]) ** 2).sum(-1).clamp(min=1e-12))
    pooled = _bn(W, f"{e}.asp_bn", torch.cat([mean, std], dim=1)[..., None])
    return conv(W, f"{e}.fc", pooled, act)[0, :, 0]


# ---------------------------------------------------------------------------
# BigVGAN generator
# ---------------------------------------------------------------------------


def bigvgan(W, h: dict, latent: torch.Tensor, spk: torch.Tensor, act: Act = _same) -> torch.Tensor:
    """latent [T, gpt_dim] (zero-padded as the serving engine pads it),
    speaker embedding [512] -> waveform [T * 4 * prod(upsample_rates)]."""
    s = spk[None, :, None]
    y = F.interpolate(latent.T[None], scale_factor=4, mode="linear", align_corners=False)
    y = conv(W, "conv_pre", y, act, padding=3) + conv(W, "cond_layer", s, act)
    n_k = len(h["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        y = F.conv_transpose1d(act(y), W[f"ups.{i}.weight"], W[f"ups.{i}.bias"], stride=u, padding=(k - u) // 2)
        y = y + conv(W, f"conds.{i}", s, act)
        total = 0
        for j, (kk, dils) in enumerate(zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"])):
            p = f"resblocks.{i * n_k + j}"
            x = y
            for n, d in enumerate(dils):
                a1, a2 = f"{p}.acts.{2 * n}", f"{p}.acts.{2 * n + 1}"
                t = aa_snake(x, W[f"{a1}.alpha"], W[f"{a1}.beta"])
                t = conv(W, f"{p}.convs1.{n}", t, act, dilation=d, padding=(kk * d - d) // 2)
                t = aa_snake(t, W[f"{a2}.alpha"], W[f"{a2}.beta"])
                x = conv(W, f"{p}.convs2.{n}", t, act, padding=(kk - 1) // 2) + x
            total = total + x
        y = total / n_k
    y = aa_snake(y, W["activation_post.alpha"], W["activation_post.beta"])
    return torch.tanh(conv(W, "conv_post", y, act, padding=3))[0, 0]
