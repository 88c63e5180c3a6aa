"""BigVGAN2 vocoder generator, and its discriminators and GAN losses
(port of indextts_tpu/models/bigvgan.py).

Behavioral reference: indextts/BigVGAN/models.py:201-250 — latent ->
waveform with ECAPA speaker conditioning at conv_pre and every upsample stage,
AMPBlock1/2 anti-aliased residual stacks. Weight norm is folded at
conversion, as in the JAX package.

The trunk runs in torch's [B, C, T] layout; bigvgan_apply keeps the JAX
layout at its boundary (latents [B, T, D] in, waveform [B, T_wav, 1] out).
Every anti-aliased activation goes to the fused kernel K1
(ops/cuda/antialias.py) when `use_cuda_kernel` is set — on a CPU tensor that
is K1's plain version — and to the composed path otherwise. With
INDEXTTS_WIDE_BRANCH=1 (read once per bigvgan_apply call, as the JAX
package's _amp_block1 reads it) and `use_cuda_kernel`, each AMPBlock1
half-branch of a stage with C >= 128 (activation, then its conv) is one call
of the fused kernel K2 (ops/cuda/aa_conv_branch.py). With
INDEXTTS_WIDE_TMAJOR=1 (read the same way) and `use_cuda_kernel`, every
activation at C >= 128 that K2 has not taken goes to K3
(ops/cuda/antialias_tmajor.py): its CUDA-core body, or with
INDEXTTS_WIDE_TMAJOR_MXU=1 its tensor-core body; INDEXTTS_WIDE_TMAJOR_POLY=1
forces the polynomial sin. As in the JAX package's _amp_block1, the
wide-branch switch is tested first, so with both set K3 sees no resblock
activation. With INDEXTTS_FUSED_AA=1 (read the same way) and
`use_cuda_kernel`, every resblock activation of a stage with C <= 96 goes to
K4 (ops/cuda/antialias_folded.py); activation_post does not, as in the JAX
package, where it never reaches the folded stages' activation. The JAX
package's phase folding itself and its INDEXTTS_WIDE_POLY/PHASE and
INDEXTTS_FOLD_* knobs are TPU layouts and are not ported (ROADMAP.md): the
trunk stays [B, C, T].

The multi-period (MPD) and multi-resolution (MRD) discriminators score a
waveform [B, T, 1] for evaluation (models.py:278-417); they run in [B, C, H,
W] and return their feature maps as [B, H, W, C] views, the JAX package's
layout.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from indextts_tpu_torch.config import BigVGANConfig
from indextts_tpu_torch.models.ecapa import ECAPA
from indextts_tpu_torch.ops.antialias import activation1d
from indextts_tpu_torch.ops.cuda.aa_conv_branch import fused_aa_snake_dconv
from indextts_tpu_torch.ops.cuda.antialias import fused_anti_alias_snake
from indextts_tpu_torch.ops.cuda.antialias_folded import fused_folded_aa
from indextts_tpu_torch.ops.cuda.antialias_tmajor import fused_anti_alias_snake_tmajor
from indextts_tpu_torch.weights import fan_in, normal_, uniform_

# the widest stage whose resblock activations K4 takes under INDEXTTS_FUSED_AA=1
# (the JAX package's _FOLDED_MAX_CHANNELS)
FOLDED_MAX_CHANNELS = 96


def linear_interp_x4(x: torch.Tensor) -> torch.Tensor:
    """4x linear interpolation along time of x [B, C, T], align_corners=False
    (reference: models.py:213-218)."""
    return F.interpolate(x, scale_factor=4, mode="linear", align_corners=False)


class SnakeParams(nn.Module):
    """Per-channel alpha (and beta for SnakeBeta) of one activation."""

    def __init__(self, channels: int, snakebeta: bool):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels)) if snakebeta else None


class AMPBlock1(nn.Module):
    def __init__(self, h: BigVGANConfig, channels: int, kernel_size: int, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d, padding=(kernel_size * d - d) // 2)
            for d in dilations
        )
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2) for _ in dilations
        )
        self.acts = nn.ModuleList(SnakeParams(channels, h.activation == "snakebeta") for _ in range(2 * len(dilations)))

    def forward(self, x: torch.Tensor, act, branch=None) -> torch.Tensor:
        """[act -> dilated conv -> act -> conv] per dilation, with residuals
        (models.py:65-74). `branch(snake_params, conv, x)`, when given, runs
        each (act, conv) half-branch as one call at C >= 128 (the JAX
        package's INDEXTTS_WIDE_BRANCH gate)."""
        if branch is not None and x.shape[1] >= 128:
            for c1, c2, a1, a2 in zip(self.convs1, self.convs2, self.acts[::2], self.acts[1::2]):
                x = branch(a2, c2, branch(a1, c1, x)) + x
            return x
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, self.acts[::2], self.acts[1::2]):
            x = c2(act(a2, c1(act(a1, x)))) + x
        return x


class AMPBlock2(nn.Module):
    def __init__(self, h: BigVGANConfig, channels: int, kernel_size: int, dilations):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d, padding=(kernel_size * d - d) // 2)
            for d in dilations
        )
        self.acts = nn.ModuleList(SnakeParams(channels, h.activation == "snakebeta") for _ in dilations)

    def forward(self, x: torch.Tensor, act, branch=None) -> torch.Tensor:
        for c, a in zip(self.convs, self.acts):
            x = c(act(a, x)) + x
        return x


class BigVGAN(nn.Module):
    def __init__(self, h: BigVGANConfig):
        super().__init__()
        self.h = h
        c0 = h.upsample_initial_channel
        self.conv_pre = nn.Conv1d(h.gpt_dim, c0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        self.conds = nn.ModuleList()
        block = AMPBlock1 if h.resblock == "1" else AMPBlock2
        for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
            cin, cout = c0 // (2**i), c0 // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(cin, cout, k, stride=u, padding=(k - u) // 2))
            for kk, dd in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes):
                self.resblocks.append(block(h, cout, kk, tuple(dd)))
            if h.cond_d_vector_in_each_upsampling_layer:
                self.conds.append(nn.Conv1d(h.speaker_embedding_dim, cout, 1))
        ch_last = c0 // (2 ** len(h.upsample_rates))
        self.activation_post = SnakeParams(ch_last, h.activation == "snakebeta")
        self.conv_post = nn.Conv1d(ch_last, 1, 7, padding=3)
        self.speaker_encoder = ECAPA(h.num_mels, h.speaker_embedding_dim)
        self.cond_layer = nn.Conv1d(h.speaker_embedding_dim, c0, 1)

    def reset_parameters(self, g: torch.Generator) -> None:
        """init_bigvgan's distributions: normal(0.01) for the upsample,
        resblock and post convs, torch-default uniform weights for conv_pre
        and the speaker projections, zero biases, identity snake."""
        self.speaker_encoder.reset_parameters(g)
        resblock_convs = [c for rb in self.resblocks for c in rb.modules() if isinstance(c, nn.Conv1d)]
        for m in (*self.ups, self.conv_post, *resblock_convs):
            normal_(m.weight, 0.01, g)
        for m in (self.conv_pre, self.cond_layer, *self.conds):
            uniform_(m.weight, 1.0 / math.sqrt(fan_in(m)), g)
        with torch.no_grad():
            for m in (*self.ups, self.conv_post, *resblock_convs, self.conv_pre, self.cond_layer, *self.conds):
                m.bias.zero_()
            for m in self.modules():
                if isinstance(m, SnakeParams):
                    for p in (m.alpha, m.beta):
                        if p is not None:
                            p.fill_(0.0 if self.h.snake_logscale else 1.0)


def bigvgan_apply(
    model: BigVGAN,
    h: BigVGANConfig,
    x: torch.Tensor,
    mel_ref: torch.Tensor,
    lens: Optional[torch.Tensor] = None,
    speaker_embedding: Optional[torch.Tensor] = None,
    use_cuda_kernel: bool = True,
) -> torch.Tensor:
    """Generator forward (reference: models.py:201-250).

    x: GPT latents [B, T, gpt_dim]; mel_ref: prompt mel [B, frames, num_mels];
    lens: ECAPA relative lengths [B]. Returns the waveform [B, T_wav, 1].
    `speaker_embedding` [B, 1, spk_dim] may be given precomputed. With
    `use_cuda_kernel` and INDEXTTS_WIDE_BRANCH=1 the AMPBlock1 half-branches
    of the C >= 128 stages go through K2; with INDEXTTS_WIDE_TMAJOR=1 the
    remaining activations at C >= 128 through K3 (INDEXTTS_WIDE_TMAJOR_MXU=1:
    its tensor-core body; INDEXTTS_WIDE_TMAJOR_POLY=1: the polynomial sin);
    with INDEXTTS_FUSED_AA=1 the resblock activations at C <= 96 through K4;
    the other activations through K1."""
    if speaker_embedding is None:
        speaker_embedding = model.speaker_encoder(mel_ref, lens)
    # cast to the trunk dtype, or a bf16 trunk silently turns float32
    spk = speaker_embedding.to(x.dtype).transpose(1, 2)  # [B, spk_dim, 1]

    env = os.environ.get
    wide_tmajor = use_cuda_kernel and env("INDEXTTS_WIDE_TMAJOR", "") == "1"
    tmajor_mxu = env("INDEXTTS_WIDE_TMAJOR_MXU", "") == "1"
    tmajor_poly = True if env("INDEXTTS_WIDE_TMAJOR_POLY", "") == "1" else None

    fused_aa = use_cuda_kernel and env("INDEXTTS_FUSED_AA", "") == "1"

    def act(p: SnakeParams, y: torch.Tensor, resblock: bool = True) -> torch.Tensor:
        if fused_aa and resblock and y.shape[1] <= FOLDED_MAX_CHANNELS:
            return fused_folded_aa(y, p.alpha, p.beta, h.snake_logscale)
        if wide_tmajor and y.shape[1] >= 128:
            return fused_anti_alias_snake_tmajor(y, p.alpha, p.beta, h.snake_logscale, mxu=tmajor_mxu,
                                                 poly_sin=tmajor_poly)
        if use_cuda_kernel:
            return fused_anti_alias_snake(y, p.alpha, p.beta, h.snake_logscale)
        return activation1d(y, p.alpha, p.beta, h.snake_logscale)

    def branch(p: SnakeParams, conv: nn.Conv1d, y: torch.Tensor) -> torch.Tensor:
        return fused_aa_snake_dconv(y, p.alpha, p.beta, conv.weight, conv.bias, conv.dilation[0], h.snake_logscale)

    wide_branch = use_cuda_kernel and env("INDEXTTS_WIDE_BRANCH", "") == "1"
    y = x.transpose(1, 2)  # [B, D, T]
    if h.feat_upsample:
        y = linear_interp_x4(y)
    y = model.conv_pre(y) + model.cond_layer(spk)
    n_kernels = len(h.resblock_kernel_sizes)
    for i, up in enumerate(model.ups):
        y = up(y)
        if h.cond_d_vector_in_each_upsampling_layer:
            y = y + model.conds[i](spk)
        blocks = model.resblocks[i * n_kernels : (i + 1) * n_kernels]
        y = sum(rb(y, act, branch if wide_branch else None) for rb in blocks) / n_kernels
    y = model.conv_post(act(model.activation_post, y, resblock=False))
    return torch.tanh(y).transpose(1, 2)


# ---------------------------------------------------------------------------
# discriminators (evaluation scoring; reference: models.py:278-417)
# ---------------------------------------------------------------------------


def _disc_init_(module: nn.Module, g: torch.Generator) -> None:
    """The JAX _conv2d_init: weights U(+-1/sqrt(fan_in)), biases zero."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            uniform_(m.weight, 1.0 / math.sqrt(fan_in(m)), g)
            nn.init.zeros_(m.bias)


class DiscriminatorP(nn.Module):
    """One period of the MPD: (5, 1) convs over the waveform viewed as
    [T / period, period] (models.py:278-312)."""

    def __init__(self, h: BigVGANConfig, kernel_size: int = 5):
        super().__init__()
        dm = h.discriminator_channel_mult
        chans = [1, int(32 * dm), int(128 * dm), int(512 * dm), int(1024 * dm), int(1024 * dm)]
        self.convs = nn.ModuleList(nn.Conv2d(chans[i], chans[i + 1], (kernel_size, 1)) for i in range(5))
        self.conv_post = nn.Conv2d(chans[5], 1, (3, 1))


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, h: BigVGANConfig):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(h) for _ in h.mpd_reshapes)

    def reset_parameters(self, g: torch.Generator) -> None:
        _disc_init_(self, g)


class DiscriminatorR(nn.Module):
    """One resolution of the MRD: (3, 9) and (3, 3) convs over the magnitude
    spectrogram (models.py:315-395)."""

    def __init__(self, h: BigVGANConfig):
        super().__init__()
        c = int(32 * h.discriminator_channel_mult)
        self.convs = nn.ModuleList(
            [nn.Conv2d(1, c, (3, 9))] + [nn.Conv2d(c, c, (3, 9)) for _ in range(3)] + [nn.Conv2d(c, c, (3, 3))])
        self.conv_post = nn.Conv2d(c, 1, (3, 3))


class MultiResolutionDiscriminator(nn.Module):
    def __init__(self, h: BigVGANConfig):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorR(h) for _ in h.resolutions)

    def reset_parameters(self, g: torch.Generator) -> None:
        _disc_init_(self, g)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def discriminator_p_apply(d: DiscriminatorP, x: torch.Tensor, period: int, stride: int = 3):
    """x: [B, T, 1] -> (score [B, N], feature maps). The waveform is
    reflect-padded to a multiple of the period and viewed as [B, 1, T / p, p];
    convs 0-3 stride (3, 1) with padding (2, 0), the last stride 1; leaky
    ReLU 0.1 after each; conv_post padding (1, 0)."""
    b, t, _ = x.shape
    y = x[..., 0][:, None]  # [B, 1, T]
    if t % period:
        y = F.pad(y, (0, period - t % period), mode="reflect")
    y = y.reshape(b, 1, -1, period)
    fmap = []
    for i, conv in enumerate(d.convs):
        pad = ((conv.kernel_size[0] - 1) // 2, 0) if i < 4 else (2, 0)
        y = F.leaky_relu(F.conv2d(y, conv.weight, conv.bias, stride=(stride, 1) if i < 4 else 1, padding=pad), 0.1)
        fmap.append(_nhwc(y))
    y = F.conv2d(y, d.conv_post.weight, d.conv_post.bias, padding=(1, 0))
    fmap.append(_nhwc(y))
    return y.reshape(b, -1), fmap


def _stft_mag(x: torch.Tensor, n_fft: int, hop: int, win_length: int) -> torch.Tensor:
    """Magnitude STFT [B, n_fft/2 + 1, frames], center=False, with the
    RECTANGULAR window DiscriminatorR's torch.stft call gets when it passes
    none (models.py:381-389): ones over win_length, zero-padded and centred
    to n_fft."""
    window = torch.ones(win_length, dtype=x.dtype, device=x.device)
    return torch.stft(x, n_fft, hop_length=hop, win_length=win_length, window=window, center=False,
                      return_complex=True).abs()


def discriminator_r_apply(d: DiscriminatorR, x: torch.Tensor, resolution):
    """x: [B, T, 1] -> (score [B, N], feature maps) at one (n_fft, hop,
    win_length): reflect-pad by (n_fft - hop) / 2, the magnitude STFT as a
    [B, 1, F, frames] image, convs padded (1, 4) (the last (1, 1)), strided
    (1, 2) at convs 1-3, leaky ReLU 0.1; conv_post padding (1, 1)."""
    n_fft, hop, win_length = resolution
    pad = int((n_fft - hop) / 2)
    y = F.pad(x[..., 0][:, None], (pad, pad), mode="reflect")[:, 0]
    y = _stft_mag(y, n_fft, hop, win_length)[:, None]  # [B, 1, F, frames]
    fmap = []
    for i, conv in enumerate(d.convs):
        stride, padding = ((1, 2) if 0 < i < 4 else 1), ((1, 4) if i < 4 else (1, 1))
        y = F.leaky_relu(F.conv2d(y, conv.weight, conv.bias, stride=stride, padding=padding), 0.1)
        fmap.append(_nhwc(y))
    y = F.conv2d(y, d.conv_post.weight, d.conv_post.bias, padding=(1, 1))
    fmap.append(_nhwc(y))
    return y.reshape(y.shape[0], -1), fmap


def _score_pairs(apply, discs, settings, y: torch.Tensor, y_hat: torch.Tensor):
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
    for d, setting in zip(discs, settings):
        s_r, f_r = apply(d, y, setting)
        s_g, f_g = apply(d, y_hat, setting)
        y_d_rs.append(s_r)
        y_d_gs.append(s_g)
        fmap_rs.append(f_r)
        fmap_gs.append(f_g)
    return y_d_rs, y_d_gs, fmap_rs, fmap_gs


def mpd_apply(mpd: MultiPeriodDiscriminator, h: BigVGANConfig, y: torch.Tensor, y_hat: torch.Tensor):
    """Real and generated [B, T, 1] through every period: (scores real,
    scores generated, feature maps real, feature maps generated)."""
    return _score_pairs(discriminator_p_apply, mpd.discriminators, h.mpd_reshapes, y, y_hat)


def mrd_apply(mrd: MultiResolutionDiscriminator, h: BigVGANConfig, y: torch.Tensor, y_hat: torch.Tensor):
    """mpd_apply's outputs over every resolution."""
    return _score_pairs(discriminator_r_apply, mrd.discriminators, h.resolutions, y, y_hat)


# ---------------------------------------------------------------------------
# GAN losses (reference: models.py:420-451)
# ---------------------------------------------------------------------------


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1 - dr) ** 2)
        g_loss = torch.mean(dg**2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        g_loss = torch.mean((1 - dg) ** 2)
        gen_losses.append(g_loss)
        loss = loss + g_loss
    return loss, gen_losses
