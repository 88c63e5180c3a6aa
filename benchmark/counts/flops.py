"""Frozen operation and byte counts: the card's peaks, the model FLOPs of
each unit of IndexTTS-1.5's work, and K1's operations and bytes.

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


def gpt_token(g: Dict, ctx: int, head: bool) -> float:
    """One token through the GPT-2 stack attending to `ctx` positions (its
    own included), plus the mel head when `head`."""
    d, layers = g["model_dim"], g["layers"]
    return 2.0 * layers * 12 * d * d + 4.0 * layers * d * ctx + (2.0 * d * g["number_mel_codes"] if head else 0.0)


def prefill(g: Dict, p: int) -> float:
    """The causal prefill of p positions ([conds | text | start_mel]) and the
    mel head at its last position."""
    d, layers = g["model_dim"], g["layers"]
    return 2.0 * layers * 12 * d * d * p + 2.0 * layers * d * p * p + 2.0 * d * g["number_mel_codes"]


def decode_steps(g: Dict, p: int, first: int, steps: int) -> float:
    """`steps` decode steps of one row whose prefill held p positions,
    starting at step index `first` (step i attends to p + i + 1 positions)."""
    n = steps
    ctx_sum = n * (p + first + 1) + n * (n - 1) / 2.0
    d, layers = g["model_dim"], g["layers"]
    return n * (2.0 * layers * 12 * d * d + 2.0 * d * g["number_mel_codes"]) + 4.0 * layers * d * ctx_sum


def latent_pass(g: Dict, t: int) -> float:
    """The teacher-forced latent pass over t positions (no head)."""
    d, layers = g["model_dim"], g["layers"]
    return 2.0 * layers * 12 * d * d * t + 2.0 * layers * d * t * t


def conditioning(g: Dict, frames: int) -> float:
    """The conformer (conv2d2 input, rel_pos attention) and the perceiver on
    a prompt of `frames` mel frames (as padded)."""
    cm = g["condition_module"]
    c, units, d = cm["output_size"], cm["linear_units"], g["model_dim"]
    t = (frames - 3) // 2 + 1
    f = (100 - 3) // 2 + 1
    total = 2.0 * c * 9 * t * f + 2.0 * c * f * c * t
    per_layer = (5 * 2.0 * c * c * t + 6.0 * c * t * t + 2.0 * c * 2 * c * t + 2.0 * c * 15 * t
                 + 2.0 * c * c * t + 2 * 2.0 * c * units * t)
    total += cm["num_blocks"] * per_layer
    n = g["condition_num_latent"]
    inner = 64 * cm["attention_heads"]
    ff = int(d * cm["perceiver_mult"] * 2 / 3)
    total += 2.0 * c * d * t
    per_layer = (2.0 * d * inner * n + 2.0 * d * 2 * inner * (n + t) + 4.0 * inner * n * (n + t)
                 + 2.0 * inner * d * n + 2.0 * d * 2 * ff * n + 2.0 * ff * d * n)
    return total + 2 * per_layer


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
    return max(elements * ACT_BYTES / PEAK_BYTES, elements * ACT_OPS / PEAK_F32)
