"""Frozen counts of the `unifiedvoice-gpt2` architecture (IndexTTS-1.5's
GPT side): the model FLOPs of each unit of its work at the sizes of the
work, and the operations and bytes of each kernel of the program that the
counts name for a unit (`kernels`).

Model FLOPs count the matrix products of the model's definition (2 per
multiply-add), whatever kernels compute them; elementwise work (norms,
activations, softmax) is left out. `g` is a configuration's `gpt` section.
The units, each a function of `g` and the work's sizes:

  conditioning(g, frames)            the conformer and perceiver on a prompt
  prefill(g, p)                      the causal prefill of p positions
  decode_steps(g, p, first, steps)   a row's decode steps
  latent_pass(g, t)                  the teacher-forced latent pass

K6 (the decode step's attention over the KV cache, csrc/decode_attn.cu) is
counted per layer, row and step as chip_smoke.py's k6 phase counts it: the
valid columns' K and V (bf16, or int8 with their float32 scales), the bias,
q, k, v, the output and the written column. The bias is counted over the
columns up to the new one, not over the cache's unused tail (the bound is
then the lower); its operations are the two products with q and with the
weights, in float32.
"""

from __future__ import annotations

from typing import Dict

# K6's __global__ function, as the profiler names its launches
K6_KERNEL = "decode_attn_kernel"


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


def kernels(cfg: Dict, unit: str, **sizes) -> Dict[str, Dict[str, float]]:
    """The kernels the counts name for one unit of work (`unit` and its
    sizes, as for the unit's FLOPs), each with its bytes and operations
    (keywords of counts.flops.bound_s): K6 in every decode step."""
    if unit != "decode_steps":
        return {}
    return {K6_KERNEL: k6(cfg, **sizes)}


def k6(cfg: Dict, p: int, first: int, steps: int) -> Dict[str, float]:
    """K6's bytes and float32 operations over `steps` decode steps of one
    row (as decode_steps counts them: step i reads the p + i cached columns
    before its own), all layers."""
    g = cfg["gpt"]
    int8 = bool(cfg["engine"]["quant_kv"])
    h, layers = g["heads"], g["layers"]
    dh = g["model_dim"] // h
    n = steps
    cols = n * (p + first) + n * (n - 1) / 2.0  # cached columns read, over the steps
    per_col = 2 * dh * (1 if int8 else 2) + (4 if int8 else 0)  # K and V of a head (and its share of the scales)
    per_step = 4 * h * dh * 2 + h * 2 * dh * (1 if int8 else 2)  # q, k, v, the output; the written column
    nbytes = cols * h * per_col + (cols + n) * 4 + n * per_step
    ops = 4.0 * h * dh * (cols + n)
    return {"bytes": layers * nbytes, "f32": layers * ops}
