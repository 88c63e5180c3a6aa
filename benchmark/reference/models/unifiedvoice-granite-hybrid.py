"""Plain PyTorch reference of the `unifiedvoice-granite-hybrid` architecture:
UnifiedVoice (IndexTTS-1.5's conformer + perceiver conditioning, text and
mel embeddings with their learned position tables, final LayerNorm and
heads) with granite-4.0-h-micro's hybrid Mamba-2 / attention stack as its
speech decoder, in float32, with the tensors it reads (`weight_spec`).

Written from the published descriptions (HF transformers'
GraniteMoeHybrid and Mamba2 layers, the granite-4.0-h-micro config.json; the
IndexTTS reference for the rest), with no cache, no batching across
requests and no kernels: one request at a time, the whole sequence in one
causal pass. The Mamba-2 layers are written in the quadratic "dual" form
over the whole sequence, per head
    y = (L o (C B^T)) (dt x) + D x,   L[t, s] = exp(sum_{s < r <= t} dt_r A) for s <= t,
which is exact and independent of the program's chunked scan and its
recurrence. It imports nothing of the program under test; the conditioning
encoders are the `unifiedvoice-gpt2` reference's (loaded from its file).
TF32 is off.

Departures from the published model, each the configuration's:
  * the LLM's 100,352-piece vocabulary, its embedding table and tied head are
    UnifiedVoice's text (12,001) and mel (8,194) tables and untied heads,
    with their learned position tables (granite-4.0-h has no positions);
  * the input multiplier (12) applies to the whole embedded sequence, the
    conditioning latents included; granite's final RMSNorm is followed by
    UnifiedVoice's final LayerNorm, and the heads' logits are divided by
    logits_scaling (8) as granite's head's are;
  * under `quant_kv`, K / V of the attention layers are rounded to int8 per
    KV-head pair and position, as the int8 cache holds them.

`W` maps the checkpoint's tensor names to float32 tensors. `act` is applied
to the input of every matrix product (the identity for the reference; the
lower-precision control passes a rounding function there, and rounded
weights in `W`).
"""

from __future__ import annotations

import importlib.util
import math
import os
from typing import Tuple

import torch
import torch.nn.functional as F

from reference.gpt import Act, _same, layer_norm, linear
from reference.weights import Spec, default_std, lin

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _gpt2():
    """The `unifiedvoice-gpt2` reference, for the conditioning both share."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "unifiedvoice-gpt2.py")
    spec = importlib.util.spec_from_file_location("reference_unifiedvoice_gpt2_shared", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_GPT2 = _gpt2()
quantize_kv = _GPT2.quantize_kv
conditioning = _GPT2.conditioning

# the spread of the Mamba heads' draws (weights.py's "b": N(0, std)): A = -exp(A_log),
# dt = softplus(dt_raw + dt_bias); at dt_raw = 0 the heads' per-step decay exp(dt A) has
# 10th / 50th / 90th percentiles 0.05 / 0.52 / 0.93
A_LOG_STD = 0.5
DT_BIAS_STD = 2.0


def weight_spec(g: dict) -> Spec:
    """The model's tensors for the `gpt` section of a configuration: the
    conditioning encoders as `unifiedvoice-gpt2` has them, the tables and
    heads, and the hybrid stack."""
    d, layers = g["model_dim"], g["layers"]
    spec: Spec = [s for s in _GPT2.weight_spec(dict(g, layers=1)) if not s[0].startswith("gpt.")]
    proj = 0.02 / math.sqrt(2 * layers)
    h, n, k = g["mamba_heads"], g["mamba_d_state"], g["mamba_d_conv"]
    di = g["mamba_expand"] * d
    cd = di + 2 * n
    dh = d // g["heads"]
    kvh = g["kv_heads"]
    ff = g["intermediate_size"]
    for i, kind in enumerate(g["layer_types"]):
        p = f"gpt.blocks.{i}"
        spec.append((f"{p}.norm_1.weight", (d,), "g", 0.05))
        if kind == "mamba":
            lin(spec, f"{p}.in_proj", di + cd + h, d, 0.02, bias=False)
            spec.append((f"{p}.conv1d.weight", (cd, 1, k), "w", default_std(k)))
            spec.append((f"{p}.conv1d.bias", (cd,), "b", 0.01))
            spec.append((f"{p}.dt_bias", (h,), "b", DT_BIAS_STD))
            spec.append((f"{p}.A_log", (h,), "b", A_LOG_STD))
            spec.append((f"{p}.D", (h,), "g", 0.05))
            spec.append((f"{p}.norm.weight", (di,), "g", 0.05))
            lin(spec, f"{p}.out_proj", d, di, proj, bias=False)
        else:
            lin(spec, f"{p}.attn_qkv", (g["heads"] + 2 * kvh) * dh, d, 0.02, bias=False)
            lin(spec, f"{p}.attn_proj", d, g["heads"] * dh, proj, bias=False)
        spec.append((f"{p}.norm_2.weight", (d,), "g", 0.05))
        lin(spec, f"{p}.mlp_in", 2 * ff, d, 0.02, bias=False)
        lin(spec, f"{p}.mlp_out", d, ff, proj, bias=False)
    spec.append(("gpt.norm.weight", (d,), "g", 0.05))
    return spec


def stop_logit(g: dict) -> Tuple[str, int]:
    """The tensor and index of the stop code's logit bias, which the
    benchmark's weights set low so that every row runs to its budget."""
    return "mel_head.bias", g["stop_mel_token"]


def rms_norm(W, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * W[name]


def mamba(W, g: dict, p: str, x: torch.Tensor, act: Act = _same) -> torch.Tensor:
    """One Mamba-2 mixer over the whole sequence x [T, D] (already normed)."""
    t = x.shape[0]
    h, hp, n, k = g["mamba_heads"], g["mamba_head_dim"], g["mamba_d_state"], g["mamba_d_conv"]
    di = h * hp
    zxbcdt = F.linear(act(x), W[f"{p}.in_proj.weight"])
    z, xbc, dt = zxbcdt.split([di, di + 2 * n, h], dim=-1)
    # the depthwise causal convolution of width k, then SiLU
    xc = F.conv1d(F.pad(xbc.T[None], (k - 1, 0)), W[f"{p}.conv1d.weight"], W[f"{p}.conv1d.bias"],
                  groups=xbc.shape[1])[0].T
    xs, bm, cm = F.silu(xc).split([di, n, n], dim=-1)
    dt = F.softplus(dt + W[f"{p}.dt_bias"])  # [T, H]
    a = -torch.exp(W[f"{p}.A_log"])  # [H]
    cum = torch.cumsum(dt * a, dim=0)  # [T, H]
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((cum[:, None, :] - cum[None, :, :]).masked_fill(~causal[:, :, None], -math.inf))  # [t, s, H]
    cb = cm @ bm.T  # [t, s]
    xh = xs.view(t, h, hp)
    y = torch.einsum("tsh,shp->thp", cb[:, :, None] * decay, dt[:, :, None] * xh) + W[f"{p}.D"][:, None] * xh
    gated = y.reshape(t, di) * F.silu(z)
    return F.linear(act(rms_norm(W, f"{p}.norm.weight", gated, g["rms_norm_eps"])), W[f"{p}.out_proj.weight"])


def forward(W, cfg: dict, conds: torch.Tensor, text: torch.Tensor, codes: torch.Tensor, pos_off: int,
            quant_kv: bool = False, act: Act = _same) -> Tuple[torch.Tensor, torch.Tensor]:
    """One causal pass over [conds | start_text, text, stop_text | start_mel,
    codes[:-1]]: the text at text positions 0.., start_mel at mel position 0
    and code j at mel position j + pos_off (2 is the reference inference
    model's positions, 1 the teacher-forced pass's).

    Returns (logits [n, V], latents [n, D]) for the n codes: row j is what
    predicts code j, from the position of start_mel (j = 0) or of code j - 1.
    The latents are the final LayerNorm's hiddens there, the vocoder's input.

    `quant_kv`: decode through an int8 KV cache. The prefill ([conds | text |
    start_mel]) attends in full precision among itself; every later position
    attends to the int8-rounded keys and values of the positions before it
    and to its own exact key and value. The Mamba layers' states are exact."""
    g = cfg
    d, heads, kvh = g["model_dim"], g["heads"], g["kv_heads"]
    dh = d // heads
    grp = heads // kvh
    scale = g["attention_multiplier"]
    eps, r = g["rms_norm_eps"], g["residual_multiplier"]
    dev = conds.device
    n = codes.shape[0]
    full_text = torch.cat([torch.tensor([g["start_text_token"]], device=dev), text,
                           torch.tensor([g["stop_text_token"]], device=dev)])
    text_emb = W["text_embedding"][full_text] + W["text_pos_embedding"][: full_text.shape[0]]
    mel_in = torch.cat([torch.tensor([g["start_mel_token"]], device=dev), codes[:-1]])
    mel_pos = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                         torch.arange(n - 1, device=dev) + pos_off])
    mel_emb = W["mel_embedding"][mel_in] + W["mel_pos_embedding"][mel_pos]
    x = torch.cat([conds, text_emb, mel_emb]) * g["embedding_multiplier"]
    t = x.shape[0]
    p = t - n + 1  # the prefill's length: its last position is start_mel
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    if quant_kv:
        later = torch.arange(t, device=dev)[:, None] >= p
        rounded = causal & later & ~torch.eye(t, dtype=torch.bool, device=dev)
        exact = causal & ~rounded
    neg = torch.finfo(torch.float32).min
    for i, kind in enumerate(g["layer_types"]):
        b = f"gpt.blocks.{i}"
        hn = rms_norm(W, f"{b}.norm_1.weight", x, eps)
        if kind == "mamba":
            mix = mamba(W, g, b, hn, act)
        else:
            qkv = F.linear(act(hn), W[f"{b}.attn_qkv.weight"])
            q, k, v = qkv.split([heads * dh, kvh * dh, kvh * dh], dim=-1)
            q = q.view(t, heads, dh).transpose(0, 1)
            k, v = (y.view(t, kvh, dh).transpose(0, 1) for y in (k, v))
            rep = lambda y: y.repeat_interleave(grp, dim=0)  # query head h reads KV head h // grp
            if quant_kv:
                kq, vq = rep(quantize_kv(k)), rep(quantize_kv(v))
                k, v = rep(k), rep(v)
                s_exact = act(q) @ act(k).transpose(-1, -2)
                s_round = act(q) @ act(kq).transpose(-1, -2)
                scores = torch.where(rounded, s_round, s_exact) * scale
                a = torch.softmax(scores.masked_fill(~causal, neg), dim=-1)
                o = act(a * exact) @ act(v) + act(a * rounded) @ act(vq)
            else:
                k, v = rep(k), rep(v)
                scores = (act(q) @ act(k).transpose(-1, -2)) * scale
                a = torch.softmax(scores.masked_fill(~causal, neg), dim=-1)
                o = act(a) @ act(v)
            mix = F.linear(act(o.transpose(0, 1).reshape(t, heads * dh)), W[f"{b}.attn_proj.weight"])
        x = x + mix * r
        gate, up = F.linear(act(rms_norm(W, f"{b}.norm_2.weight", x, eps)), W[f"{b}.mlp_in.weight"]).chunk(2, dim=-1)
        x = x + F.linear(act(F.silu(gate) * up), W[f"{b}.mlp_out.weight"]) * r
    h = layer_norm(W, "final_norm", rms_norm(W, "gpt.norm.weight", x[p - 1:], eps))
    return linear(W, "mel_head", h, act) / g["logits_scaling"], h
