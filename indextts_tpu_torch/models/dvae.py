"""DiscreteVAE: the mel codebook that defines the GPT's 8192-entry speech
token vocabulary (port of indextts_tpu/models/dvae.py).

Behavioral reference: indextts/vqvae/xtts_dvae.py — a conv VQ-VAE over mel
frames (positional_dims=1, Conv1d) or images (positional_dims=2, Conv2d), a
stride-2 encoder and a nearest-upsample decoder (use_transposed_convs=False),
the EMA codebook `Quantize` with its straight-through estimator
(xtts_dvae.py:51-129), get_codebook_indices / decode / infer (:323-357) and
the training forward with reconstruction and commitment losses (:362-382).

Tensors are channels-last, as in the JAX package: mel [B, T, C], images
[B, H, W, C]. The codebook's embed [dim, n], cluster_size [n] and embed_avg
[dim, n] are buffers. The reference's one collective, the all_reduce of the
EMA statistics (xtts_dvae.py:107-109; jax.lax.psum in the JAX package), is
torch.distributed.all_reduce over a process group in quantize_ema_update.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn

from indextts_tpu_torch.config import DVAEConfig
from indextts_tpu_torch.ops.conv import conv1d, conv2d
from indextts_tpu_torch.weights import default_init_


def _arch(cfg: DVAEConfig) -> Tuple[List[int], List[int], int]:
    """(encoder channels, decoder channels, innermost width). num_layers == 0
    is the reference's layer-less branch (xtts_dvae.py:275-279): no strided
    stages, the innermost width is hidden_dim."""
    if cfg.num_layers == 0:
        return [], [], cfg.hidden_dim
    enc_chans = [cfg.hidden_dim * (2**i) for i in range(cfg.num_layers)]
    dec_chans = list(reversed(enc_chans))
    enc_chans = [cfg.channels] + enc_chans
    dec_init_chan = cfg.codebook_dim if cfg.num_resnet_blocks == 0 else dec_chans[0]
    dec_chans = [dec_init_chan] + dec_chans
    return enc_chans, dec_chans, dec_chans[0]


class ResBlock(nn.Module):
    """conv3 - act - conv3 - act - conv1, plus the input (xtts_dvae.py:171-183)."""

    def __init__(self, chan: int, conv):
        super().__init__()
        self.conv0 = conv(chan, chan, 3)
        self.conv1 = conv(chan, chan, 3)
        self.conv2 = conv(chan, chan, 1)


class Codebook(nn.Module):
    def __init__(self, dim: int, n: int):
        super().__init__()
        self.register_buffer("embed", torch.zeros(dim, n))
        self.register_buffer("cluster_size", torch.zeros(n))
        self.register_buffer("embed_avg", torch.zeros(dim, n))


class DiscreteVAE(nn.Module):
    def __init__(self, cfg: DVAEConfig):
        super().__init__()
        if cfg.use_transposed_convs:
            raise NotImplementedError("IndexTTS DVAE uses nearest-upsample convs")
        self.cfg = cfg
        conv = nn.Conv2d if cfg.positional_dims == 2 else nn.Conv1d
        enc_chans, dec_chans, innermost = _arch(cfg)
        if cfg.num_layers == 0:
            self.enc_in0 = conv(cfg.channels, cfg.hidden_dim, 1)
        self.enc_convs = nn.ModuleList(conv(ci, co, cfg.kernel_size) for ci, co in zip(enc_chans[:-1], enc_chans[1:]))
        self.enc_res = nn.ModuleList(ResBlock(innermost, conv) for _ in range(cfg.num_resnet_blocks))
        self.enc_out = conv(innermost, cfg.codebook_dim, 1)
        if cfg.num_resnet_blocks > 0:
            self.dec_in = conv(cfg.codebook_dim, innermost, 1)
        self.dec_res = nn.ModuleList(ResBlock(innermost, conv) for _ in range(cfg.num_resnet_blocks))
        self.dec_convs = nn.ModuleList(conv(ci, co, cfg.kernel_size) for ci, co in zip(dec_chans[:-1], dec_chans[1:]))
        self.dec_out = conv(dec_chans[-1] if dec_chans else innermost, cfg.channels, 1)
        self.codebook = Codebook(cfg.codebook_dim, cfg.num_tokens)

    def reset_parameters(self, g: torch.Generator) -> None:
        """init_dvae's distributions: convs U(+-1/sqrt(fan_in)), embed ~
        N(0, 1), embed_avg = embed (xtts_dvae.py:68), cluster_size 0."""
        default_init_(self, g)
        with torch.no_grad():
            self.codebook.embed.normal_(0.0, 1.0, generator=g)
            self.codebook.embed_avg.copy_(self.codebook.embed)
            self.codebook.cluster_size.zero_()


def _conv(cfg: DVAEConfig, x: torch.Tensor, m: nn.Module, stride: int = 1, padding: int = 0) -> torch.Tensor:
    fn = conv2d if cfg.positional_dims == 2 else conv1d
    return fn(x, m.weight, m.bias, stride=stride, padding=padding)


def _act(cfg: DVAEConfig, x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x) if cfg.activation == "silu" else torch.relu(x)


def _resblock(cfg: DVAEConfig, blk: ResBlock, x: torch.Tensor) -> torch.Tensor:
    h = _act(cfg, _conv(cfg, x, blk.conv0, padding=1))
    h = _act(cfg, _conv(cfg, h, blk.conv1, padding=1))
    return _conv(cfg, h, blk.conv2) + x


def dvae_encode(model: DiscreteVAE, cfg: DVAEConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, channels] -> pre-quantization logits [B, T/2^L,
    codebook_dim]; with positional_dims=2, [B, H, W, channels] -> [B, H/2^L,
    W/2^L, codebook_dim]."""
    pad = (cfg.kernel_size - 1) // 2
    h = mel
    if cfg.num_layers == 0:
        h = _act(cfg, _conv(cfg, h, model.enc_in0))
    for m in model.enc_convs:
        h = _act(cfg, _conv(cfg, h, m, stride=cfg.stride, padding=pad))
    for blk in model.enc_res:
        h = _resblock(cfg, blk, h)
    return _conv(cfg, h, model.enc_out)


def _nearest_up(x: torch.Tensor, factor: int) -> torch.Tensor:
    """nn.Upsample(scale_factor, mode='nearest') on channels-last data: the
    time axis of [B, T, C], both spatial axes of [B, H, W, C]."""
    x = x.repeat_interleave(factor, dim=1)
    return x.repeat_interleave(factor, dim=2) if x.dim() == 4 else x


def dvae_decode_embeds(model: DiscreteVAE, cfg: DVAEConfig, h: torch.Tensor) -> torch.Tensor:
    """Code embeddings [B, T', codebook_dim] -> mel [B, T'*2^L, channels].
    With positional_dims=2 a flat [B, N, codebook_dim] sequence is folded to
    the sqrt(N) x sqrt(N) square first (xtts_dvae.py:341-348)."""
    if cfg.positional_dims == 2 and h.dim() == 3:
        side = int(round(math.sqrt(h.shape[1])))
        h = h.reshape(h.shape[0], side, side, h.shape[2])
    pad = (cfg.kernel_size - 1) // 2
    if cfg.num_resnet_blocks > 0:
        h = _conv(cfg, h, model.dec_in)
        for blk in model.dec_res:
            h = _resblock(cfg, blk, h)
    for m in model.dec_convs:
        h = _act(cfg, _conv(cfg, _nearest_up(h, cfg.stride), m, padding=pad))
    return _conv(cfg, h, model.dec_out)


def quantize(codebook: Codebook, flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest codebook entry (xtts_dvae.py:86-92). flat: [..., dim].
    Returns (quantized [..., dim], codes [...])."""
    embed = codebook.embed.to(flat.dtype)  # [dim, n]
    dist = (flat**2).sum(-1, keepdim=True) - 2 * flat @ embed + (embed**2).sum(0, keepdim=True)
    codes = torch.argmin(dist, dim=-1)
    return embed.t()[codes], codes


def get_codebook_indices(model: DiscreteVAE, cfg: DVAEConfig, mel: torch.Tensor) -> torch.Tensor:
    """Tokenize: mel [B, T, C] -> codes [B, T/2^L] (xtts_dvae.py:323-330)."""
    return quantize(model.codebook, dvae_encode(model, cfg, mel))[1]


def decode(model: DiscreteVAE, cfg: DVAEConfig, codes: torch.Tensor) -> torch.Tensor:
    """Detokenize: codes [B, T'] -> mel [B, T, C] (xtts_dvae.py:332-351)."""
    return dvae_decode_embeds(model, cfg, model.codebook.embed.t()[codes])


def dvae_infer(model: DiscreteVAE, cfg: DVAEConfig, mel: torch.Tensor) -> torch.Tensor:
    """Round trip tokenize -> detokenize (xtts_dvae.py:353-357)."""
    return decode(model, cfg, get_codebook_indices(model, cfg, mel))


def dvae_forward(model: DiscreteVAE, cfg: DVAEConfig, mel: torch.Tensor):
    """Training forward: (recon_loss, commitment_loss, out) with the
    straight-through estimator logits + (quantized - logits).detach()
    (xtts_dvae.py:362-382). The output is cropped on the last positional dim
    (time for 1-D, width for 2-D), as the reference's out[..., :img.shape[-1]]
    in its channels-first layout."""
    logits = dvae_encode(model, cfg, mel)
    quantized, _ = quantize(model.codebook, logits)
    commitment = torch.mean((quantized.detach() - logits) ** 2)
    out = dvae_decode_embeds(model, cfg, logits + (quantized - logits).detach())
    out = out[:, :, : mel.shape[2]] if cfg.positional_dims == 2 else out[:, : mel.shape[1]]
    return torch.mean((mel - out) ** 2), commitment, out


def discretization_loss(soft_onehot: torch.Tensor, dim: int, expected_variance: float) -> torch.Tensor:
    """Fit the bins' utilization to a normal PDF (xtts_dvae.py:135-168
    without the store_past accumulator): the soft assignments averaged over
    every other dim, centred, and the negative normal log-likelihood summed."""
    other = tuple(i for i in range(soft_onehot.dim()) if i != dim)
    averaged = soft_onehot.sum(dim=other) / soft_onehot.sum()
    averaged = averaged - averaged.mean()
    scale = expected_variance
    log_prob = -0.5 * (averaged / scale) ** 2 - math.log(scale) - 0.5 * math.log(2 * math.pi)
    return torch.sum(-log_prob)


@torch.no_grad()
def quantize_ema_update(codebook: Codebook, flat: torch.Tensor, n_embed: int, decay: float = 0.99,
                        eps: float = 1e-5, group=None) -> Codebook:
    """EMA codebook update (xtts_dvae.py:103-116), in place on the
    codebook's buffers, which it returns. With a process `group`, each
    process's statistics (code counts and code sums of its own rows) are
    summed over the group by torch.distributed.all_reduce, so that every
    member computes the update of all the rows (torch.distributed.group.WORLD
    for every process)."""
    flat2 = flat.reshape(-1, flat.shape[-1])
    _, codes = quantize(codebook, flat2)
    onehot = torch.nn.functional.one_hot(codes, n_embed).to(flat2.dtype)
    onehot_sum = onehot.sum(0)  # [n]
    embed_sum = flat2.t() @ onehot  # [dim, n]
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(onehot_sum, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(embed_sum, op=dist.ReduceOp.SUM, group=group)
    codebook.cluster_size.mul_(decay).add_(onehot_sum * (1 - decay))
    codebook.embed_avg.mul_(decay).add_(embed_sum * (1 - decay))
    n = codebook.cluster_size.sum()
    cluster = (codebook.cluster_size + eps) / (n + n_embed * eps) * n
    codebook.embed.copy_(codebook.embed_avg / cluster[None, :])
    return codebook
