"""Frozen counts of the `unifiedvoice-granite-hybrid` architecture
(UnifiedVoice with granite-4.0-h's hybrid Mamba-2 / attention decoder): the
model FLOPs of each unit of its work at the sizes of the work, and the
operations and bytes of each kernel of the program that the counts name for
a unit (`kernels`).

Model FLOPs count the matrix products of the model's definition (2 per
multiply-add), whatever kernels compute them; elementwise work (norms,
activations, softmax, the gate) is left out. Per token and layer: the
projections (a Mamba layer's in_proj and out_proj, an attention layer's
q / k / v and output), the SwiGLU MLP's two products, a Mamba layer's
depthwise convolution (d_conv multiply-adds a channel) and its SSM in the
recurrent form (per head, the state's update dt x B^T and its read-out
through C: two multiply-adds a state element), and an attention layer's
scores and weighted values over the positions it attends (4 Hq Dh each);
the mel head where a unit computes it. The conditioning is UnifiedVoice's,
counted as `unifiedvoice-gpt2` counts it. `g` is a configuration's `gpt`
section. The units, each a function of `g` and the work's sizes:

  conditioning(g, frames)            the conformer and perceiver on a prompt
  prefill(g, p)                      the causal prefill of p positions
  decode_steps(g, p, first, steps)   a row's decode steps
  latent_pass(g, t)                  the teacher-forced latent pass

K6 (the decode step's attention over the KV cache, csrc/decode_attn.cu) is
counted per attention layer, row and step as `unifiedvoice-gpt2` counts it,
with grouped-query attention: the valid columns' K and V of each KV head
read once (bf16, or int8 with their float32 scales), the bias, q and the
output of every query head, the new k and v, and the written column; its
operations are the two products of every query head with the columns.
K7 (the Mamba-2 decode step, csrc/ssm_step.cu) is counted per Mamba layer,
row and step: the float32 SSM state read and written, the conv state read
and written and the token's z, x, B, C and dt in the model's dtype, and the
float32 gated output (the conv weights and the per-head parameters, shared
by a launch's rows, are left out); its operations, in float32: the update
(3), the read-out (2) of every state element, and the convolution.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict

# K6's and K7's __global__ functions, as the profiler names their launches
K6_KERNEL = "decode_attn_kernel"
K7_KERNEL = "ssm_step_kernel"


def _gpt2_counts():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "unifiedvoice-gpt2.py")
    spec = importlib.util.spec_from_file_location("counts_unifiedvoice_gpt2_shared", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


conditioning = _gpt2_counts().conditioning


def _sizes(g: Dict):
    d = g["model_dim"]
    h, p, n, k = g["mamba_heads"], g["mamba_head_dim"], g["mamba_d_state"], g["mamba_d_conv"]
    di = g["mamba_expand"] * d
    hq, hkv = g["heads"], g["kv_heads"]
    dh = d // hq
    la = sum(t == "attention" for t in g["layer_types"])
    lm = len(g["layer_types"]) - la
    return d, h, p, n, k, di, di + 2 * n, hq, hkv, dh, la, lm


def token_dense(g: Dict) -> float:
    """One token through every layer, without the attention's work over the
    positions it attends."""
    d, h, p, n, k, di, cd, hq, hkv, dh, la, lm = _sizes(g)
    mlp = 6.0 * d * g["intermediate_size"]
    mamba = 2.0 * d * (di + cd + h) + 2.0 * di * d + 2.0 * cd * k + 4.0 * h * p * n
    attn = 2.0 * d * (hq + 2 * hkv) * dh + 2.0 * hq * dh * d
    return lm * (mamba + mlp) + la * (attn + mlp)


def _attend(g: Dict) -> float:
    """The attention layers' work per (query, key) pair: scores and weighted values."""
    d, h, p, n, k, di, cd, hq, hkv, dh, la, lm = _sizes(g)
    return 4.0 * la * hq * dh


def prefill(g: Dict, p: int) -> float:
    """The causal prefill of p positions ([conds | text | start_mel]) and the
    mel head at its last position."""
    return token_dense(g) * p + _attend(g) * p * p / 2.0 + 2.0 * g["model_dim"] * g["number_mel_codes"]


def decode_steps(g: Dict, p: int, first: int, steps: int) -> float:
    """`steps` decode steps of one row whose prefill held p positions,
    starting at step index `first` (step i attends to p + i + 1 positions)."""
    n = steps
    ctx_sum = n * (p + first + 1) + n * (n - 1) / 2.0
    return n * (token_dense(g) + 2.0 * g["model_dim"] * g["number_mel_codes"]) + _attend(g) * ctx_sum


def latent_pass(g: Dict, t: int) -> float:
    """The teacher-forced latent pass over t positions (no head)."""
    return token_dense(g) * t + _attend(g) * t * t / 2.0


def kernels(cfg: Dict, unit: str, **sizes) -> Dict[str, Dict[str, float]]:
    """The kernels the counts name for one unit of work (`unit` and its
    sizes, as for the unit's FLOPs), each with its bytes and operations
    (keywords of counts.flops.bound_s): K6 and K7 in every decode step."""
    if unit != "decode_steps":
        return {}
    return {K6_KERNEL: k6(cfg, **sizes), K7_KERNEL: k7(cfg, **sizes)}


def k6(cfg: Dict, p: int, first: int, steps: int) -> Dict[str, float]:
    """K6's bytes and float32 operations over `steps` decode steps of one
    row (step i reads the p + i cached columns before its own), all
    attention layers."""
    g = cfg["gpt"]
    d, h, pp, n_, k, di, cd, hq, hkv, dh, la, lm = _sizes(g)
    int8 = bool(cfg["engine"]["quant_kv"])
    n = steps
    cols = n * (p + first) + n * (n - 1) / 2.0  # cached columns read, over the steps
    per_col = 2 * dh * (1 if int8 else 2) + (4 if int8 else 0)  # K and V of a KV head (and its share of the scales)
    per_step = 2 * (2 * hq + 2 * hkv) * dh + hkv * 2 * dh * (1 if int8 else 2)  # q, out, k, v; the written column
    nbytes = cols * hkv * per_col + (cols + n) * 4 + n * per_step
    ops = 4.0 * hq * dh * (cols + n)
    return {"bytes": la * nbytes, "f32": la * ops}


def k7(cfg: Dict, p: int, first: int, steps: int) -> Dict[str, float]:
    """K7's bytes and float32 operations over `steps` decode steps of one
    row, all Mamba layers."""
    g = cfg["gpt"]
    d, h, pp, n, k, di, cd, hq, hkv, dh, la, lm = _sizes(g)
    item = 2 if cfg["engine"]["dtype"] == "bfloat16" else 4
    per_step = 2 * 4 * h * pp * n + 2 * item * cd * (k - 1) + item * (di + cd + h) + 4 * di
    ops = 5.0 * h * pp * n + 2.0 * cd * k
    return {"bytes": lm * steps * per_step, "f32": lm * steps * ops}
