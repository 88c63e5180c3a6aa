"""BigVGAN2 vocoder generator (port of indextts_tpu/models/bigvgan.py,
generator only).

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
