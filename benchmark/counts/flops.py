"""Frozen operation and byte counts that every architecture shares: the
card's peaks, a kernel's bound from its bytes and operations, and the
vocoder's model FLOPs and K1's operations and bytes. Each architecture's own
counts are in counts/models/<architecture>.py.

Model FLOPs count the matrix products and convolutions of the model's
definition at the sizes of the work (2 per multiply-add), whatever kernels
compute them; elementwise work (norms, activations, softmax) is left out.
They follow from the configuration's widths alone, so a step's share of the
peak reads the same work whichever implementation runs it.

K1 (the fused anti-aliased SnakeBeta, the vocoder's activation) is counted
per output element as chip_smoke.py counts it: 4 bytes (bf16 in and out)
and ACT_OPS float32 operations (two 2x-rate samples of 12 up taps and an
18-operation snake with the polynomial sin, then 24 down taps).
"""

from __future__ import annotations

from typing import Dict

# the card's peaks (NVIDIA H100 SXM data sheet): device memory bytes/s, dense
# bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12

ACT_OPS = 84
ACT_BYTES = 4
# K1 launches of one vocoder call on the default route: three resblocks of
# six activations at each upsampling stage, and activation_post
K1_PER_STAGE = 18
# K1's __global__ function, as the profiler names its launches
K1_KERNEL = "anti_alias_snake_kernel"


def bound_s(bytes: float = 0.0, f32: float = 0.0, bf16: float = 0.0) -> float:
    """The least time the card could take for a kernel's work: its bytes
    over the memory rate, or its float32 operations over the CUDA cores'
    rate, or its bf16 tensor-core operations over theirs, whichever is
    longest."""
    return max(bytes / PEAK_BYTES, f32 / PEAK_F32, bf16 / PEAK_BF16)


def _stages(h: Dict):
    """(channels in, channels out, kernel, samples per latent frame after the
    stage) of each upsampling stage."""
    c0, per = h["upsample_initial_channel"], 4
    out = []
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        per *= u
        out.append((c0 // 2**i, c0 // 2 ** (i + 1), k, per))
    return out


def resblock_convs(h: Dict, frames: int, stages=None) -> float:
    """The AMP blocks' convolutions of the given stages (default all) for
    `frames` latent frames: per stage and kernel k, the convs1 at each
    dilation and as many convs2, each 2 * k * C^2 per sample."""
    total = 0.0
    for i, (_cin, c, _k, per) in enumerate(_stages(h)):
        if stages is not None and i not in stages:
            continue
        taps = sum(2 * len(d) * k for k, d in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]))
        total += 2.0 * c * c * taps * per * frames
    return total


def vocoder(h: Dict, frames: int) -> float:
    """BigVGAN on `frames` latent frames: conv_pre at 4 samples a frame, the
    transposed upsampling convolutions, the AMP blocks and conv_post (the
    speaker projections and ECAPA are per call, and small)."""
    total = 2.0 * h["gpt_dim"] * h["upsample_initial_channel"] * 7 * 4 * frames
    prev = 4
    for cin, cout, k, per in _stages(h):
        total += 2.0 * cin * cout * k * prev * frames
        prev = per
    total += resblock_convs(h, frames)
    return total + 2.0 * (h["upsample_initial_channel"] // 2 ** len(h["upsample_rates"])) * 7 * prev * frames


def k1_elements(h: Dict, rows: int, frames: int) -> int:
    """Output elements of K1's launches in one vocoder call of `rows` rows and
    `frames` latent frames (as padded)."""
    st = _stages(h)
    per_frame = K1_PER_STAGE * sum(c * per for _cin, c, _k, per in st) + st[-1][1] * st[-1][3]
    return rows * frames * per_frame


def k1_launches(h: Dict) -> int:
    return K1_PER_STAGE * len(h["upsample_rates"]) + 1


def k1_bound_s(elements: int) -> float:
    """The least time the card could take for K1's work: bytes over the
    memory rate or float32 operations over the CUDA cores' rate."""
    return bound_s(bytes=elements * ACT_BYTES, f32=elements * ACT_OPS)
