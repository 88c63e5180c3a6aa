"""Plain PyTorch reference of the `unifiedvoice-gpt2` architecture
(IndexTTS-1.5's GPT side): the conformer + perceiver conditioning encoder and
the UnifiedVoice GPT-2 over [conditioning latents | text | mel codes], in
float32, with the tensors it reads (`weight_spec`).

Written from the published model (indextts/gpt/model.py, conformer_encoder.py,
perceiver.py of the reference implementation), with no cache, no batching
across requests and no kernels: one request at a time, the whole sequence in
one causal pass. It imports nothing of the program under test.

`W` maps the checkpoint's tensor names to float32 tensors. `act` is applied
to the input of every matrix product (the identity for the reference; the
lower-precision control passes a rounding function there, and rounded
weights in `W`).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from reference.gpt import Act, _same, layer_norm, linear
from reference.weights import Spec, conv, default_std, lin, ln

# ---------------------------------------------------------------------------
# the tensors
# ---------------------------------------------------------------------------


def weight_spec(g: dict) -> Spec:
    """The GPT's tensors for the `gpt` section of a configuration."""
    d, layers = g["model_dim"], g["layers"]
    n_text = g["number_text_tokens"] * g.get("types", 1) + 1
    v = g["number_mel_codes"]
    spec: Spec = [
        ("text_embedding", (n_text, d), "w", 0.02),
        ("mel_embedding", (v, d), "w", 0.02),
        ("text_pos_embedding", (g["max_text_tokens"] + 2, d), "w", 0.02),
        ("mel_pos_embedding", (g["max_mel_tokens"] + 3, d), "w", 0.02),
    ]
    proj = 0.02 / math.sqrt(2 * layers)
    for i in range(layers):
        p = f"gpt.blocks.{i}"
        ln(spec, f"{p}.ln_1", d)
        lin(spec, f"{p}.attn_qkv", 3 * d, d, 0.02)
        lin(spec, f"{p}.attn_proj", d, d, proj)
        ln(spec, f"{p}.ln_2", d)
        lin(spec, f"{p}.mlp_fc", 4 * d, d, 0.02)
        lin(spec, f"{p}.mlp_proj", d, 4 * d, proj)
    ln(spec, "gpt.ln_f", d)
    ln(spec, "final_norm", d)
    lin(spec, "text_head", n_text, d, 0.02)
    lin(spec, "mel_head", v, d, 0.02)
    cm = g["condition_module"]
    c, units, heads = cm["output_size"], cm["linear_units"], cm["attention_heads"]
    if g["condition_type"] != "conformer_perceiver" or cm["input_layer"] != "conv2d2":
        raise ValueError("the reference implements the conformer_perceiver conditioning with a conv2d2 input layer")
    e = "conditioning_encoder"
    spec.append((f"{e}.pe", (5000, c), "pe", 0.0))
    spec.append((f"{e}.embed.conv0.weight", (c, 1, 3, 3), "w", default_std(9)))
    spec.append((f"{e}.embed.conv0.bias", (c,), "b", 0.01))
    f_out = (100 - 3) // 2 + 1
    lin(spec, f"{e}.embed.out", c, c * f_out, default_std(c * f_out))
    for i in range(cm["num_blocks"]):
        p = f"{e}.layers.{i}"
        spec.append((f"{p}.attn.pos_bias_u", (heads, c // heads), "b", 0.05))
        spec.append((f"{p}.attn.pos_bias_v", (heads, c // heads), "b", 0.05))
        for n in ("linear_q", "linear_k", "linear_v", "linear_out"):
            lin(spec, f"{p}.attn.{n}", c, c, default_std(c))
        lin(spec, f"{p}.attn.linear_pos", c, c, default_std(c), bias=False)
        lin(spec, f"{p}.ff.w1", units, c, default_std(c))
        lin(spec, f"{p}.ff.w2", c, units, default_std(units))
        conv(spec, f"{p}.conv.pw1", 2 * c, c, 1)
        conv(spec, f"{p}.conv.dw", c, 1, 15)
        ln(spec, f"{p}.conv.ln", c)
        conv(spec, f"{p}.conv.pw2", c, c, 1)
        for n in ("norm_mha", "norm_ff", "norm_conv", "norm_final"):
            ln(spec, f"{p}.{n}", c)
    ln(spec, f"{e}.after_norm", c)
    pr = "perceiver_encoder"
    n_lat = g["condition_num_latent"]
    inner = 64 * heads
    ff_inner = int(d * cm["perceiver_mult"] * 2 / 3)
    spec.append((f"{pr}.latents", (n_lat, d), "w", 0.02))
    spec.append((f"{pr}.norm_gamma", (d,), "g", 0.05))
    for i in range(2):
        p = f"{pr}.layers.{i}"
        lin(spec, f"{p}.to_q", inner, d, default_std(d), bias=False)
        lin(spec, f"{p}.to_kv", 2 * inner, d, default_std(d), bias=False)
        lin(spec, f"{p}.to_out", d, inner, default_std(inner), bias=False)
        lin(spec, f"{p}.ff_in", 2 * ff_inner, d, default_std(d))
        lin(spec, f"{p}.ff_out", d, ff_inner, default_std(ff_inner))
    lin(spec, f"{pr}.proj_context", d, c, default_std(c))
    return spec


# ---------------------------------------------------------------------------
# conditioning: conformer (conv2d2 input, rel_pos attention) + perceiver
# ---------------------------------------------------------------------------


def conformer(W, cfg: dict, mel: torch.Tensor, frames: int, act: Act = _same) -> Tuple[torch.Tensor, torch.Tensor]:
    """mel [T, 100] (zero-padded past `frames`) -> (encoded [T', 512], valid [T'] bool)."""
    cm = cfg["condition_module"]
    e = "conditioning_encoder"
    t = mel.shape[0]
    valid = torch.arange(t, device=mel.device) < frames
    h = F.conv2d(act(mel)[None, None], W[f"{e}.embed.conv0.weight"], W[f"{e}.embed.conv0.bias"], stride=2)
    h = torch.relu(h)[0]  # [C, T', F']
    c, t2, f2 = h.shape
    h = h.permute(1, 0, 2).reshape(t2, c * f2)
    x = linear(W, f"{e}.embed.out", h, act)
    valid = valid[2::2][:t2]
    d = cm["output_size"]
    heads = cm["attention_heads"]
    dk = d // heads
    x = x * math.sqrt(d)
    pos = W[f"{e}.pe"][:t2]
    for i in range(cm["num_blocks"]):
        p = f"{e}.layers.{i}"
        hn = layer_norm(W, f"{p}.norm_mha", x)
        q, k, v = (linear(W, f"{p}.attn.linear_{n}", hn, act).view(t2, heads, dk).transpose(0, 1) for n in "qkv")
        pm = F.linear(act(pos), W[f"{p}.attn.linear_pos.weight"]).view(t2, heads, dk).transpose(0, 1)
        qu = q + W[f"{p}.attn.pos_bias_u"][:, None, :]
        qv = q + W[f"{p}.attn.pos_bias_v"][:, None, :]
        scores = (act(qu) @ act(k).transpose(-1, -2) + act(qv) @ act(pm).transpose(-1, -2)) / math.sqrt(dk)
        scores = scores.masked_fill(~valid[None, None, :], float("-inf"))
        a = torch.softmax(scores, dim=-1).masked_fill(~valid[None, None, :], 0.0)
        o = (act(a) @ act(v)).transpose(0, 1).reshape(t2, d)
        x = x + linear(W, f"{p}.attn.linear_out", o, act)
        # convolution module: GLU pointwise, depthwise k=15, LayerNorm + SiLU, pointwise
        hc = layer_norm(W, f"{p}.norm_conv", x).masked_fill(~valid[:, None], 0.0)
        hc = F.glu(F.conv1d(act(hc.T[None]), W[f"{p}.conv.pw1.weight"], W[f"{p}.conv.pw1.bias"]), dim=1)
        hc = F.conv1d(act(hc), W[f"{p}.conv.dw.weight"], W[f"{p}.conv.dw.bias"], padding=7, groups=d)
        hc = F.silu(layer_norm(W, f"{p}.conv.ln", hc[0].T))
        hc = F.conv1d(act(hc.T[None]), W[f"{p}.conv.pw2.weight"], W[f"{p}.conv.pw2.bias"])[0].T
        x = x + hc.masked_fill(~valid[:, None], 0.0)
        hf = layer_norm(W, f"{p}.norm_ff", x)
        x = x + linear(W, f"{p}.ff.w2", F.silu(linear(W, f"{p}.ff.w1", hf, act)), act)
        x = layer_norm(W, f"{p}.norm_final", x)
    return layer_norm(W, f"{e}.after_norm", x), valid


def perceiver(W, cfg: dict, ctx: torch.Tensor, ctx_valid: torch.Tensor, act: Act = _same) -> torch.Tensor:
    """Encoded prompt [T', 512] -> conditioning latents [32, D]: learned
    latents cross-attend to the projected context with themselves included,
    GEGLU feed-forward, RMSNorm output."""
    pr = "perceiver_encoder"
    heads, dh = cfg["condition_module"]["attention_heads"], 64
    ctx = linear(W, f"{pr}.proj_context", ctx, act)
    lat = W[f"{pr}.latents"]
    n = lat.shape[0]
    keys_ok = torch.cat([torch.ones(n, dtype=torch.bool, device=ctx.device), ctx_valid])
    for i in range(2):
        p = f"{pr}.layers.{i}"
        q = F.linear(act(lat), W[f"{p}.to_q.weight"]).view(n, heads, dh).transpose(0, 1)
        kv = F.linear(act(torch.cat([lat, ctx])), W[f"{p}.to_kv.weight"])
        k, v = (t.reshape(-1, heads, dh).transpose(0, 1) for t in kv.chunk(2, dim=-1))
        sim = (act(q) @ act(k).transpose(-1, -2)) * dh**-0.5
        sim = sim.masked_fill(~keys_ok[None, None, :], torch.finfo(torch.float32).min)
        o = (act(torch.softmax(sim, dim=-1)) @ act(v)).transpose(0, 1).reshape(n, heads * dh)
        lat = F.linear(act(o), W[f"{p}.to_out.weight"]) + lat
        a, gate = linear(W, f"{p}.ff_in", lat, act).chunk(2, dim=-1)
        lat = linear(W, f"{p}.ff_out", F.gelu(gate) * a, act) + lat
    return F.normalize(lat, dim=-1) * math.sqrt(lat.shape[-1]) * W[f"{pr}.norm_gamma"]


def conditioning(W, cfg: dict, mel: torch.Tensor, frames: int, act: Act = _same) -> torch.Tensor:
    """The prompt's conditioning latents [32, D]. `mel` [T, 100] holds the
    prompt's `frames` frames, zero-padded to the frame bucket the serving
    engine pads to (the conformer's convolutions see the padding)."""
    enc, valid = conformer(W, cfg, mel, frames, act)
    return perceiver(W, cfg, enc, valid, act)


# ---------------------------------------------------------------------------
# the GPT over [conds | text | mel codes]
# ---------------------------------------------------------------------------


def quantize_kv(t: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 rounding of keys or values [H, T, Dh] with one scale per
    head pair and position (the amax over both heads of a pair and the head
    dimension), returned dequantized: the int8 KV cache's values."""
    h, n, dh = t.shape
    tp = t.reshape(h // 2, 2, n, dh)
    s = tp.abs().amax(dim=(1, 3), keepdim=True).clamp(min=1e-8) / 127.0
    return (torch.clamp(torch.round(tp / s), -127, 127) * s).reshape(h, n, dh)


def forward(W, cfg: dict, conds: torch.Tensor, text: torch.Tensor, codes: torch.Tensor, pos_off: int,
             quant_kv: bool = False, act: Act = _same) -> Tuple[torch.Tensor, torch.Tensor]:
    """One causal pass over [conds | start_text, text, stop_text | start_mel,
    codes[:-1]]: the text at text positions 0.., start_mel at mel position 0
    and code j at mel position j + pos_off (2 is the reference inference
    model's positions, 1 the teacher-forced pass's).

    Returns (logits [n, V], latents [n, D]) for the n codes: row j is what
    predicts code j, from the position of start_mel (j = 0) or of code j - 1.
    The latents are the final-norm hiddens there, the vocoder's input.

    `quant_kv`: decode through an int8 KV cache. The prefill ([conds | text |
    start_mel]) attends in full precision among itself; every later position
    attends to the int8-rounded keys and values of the positions before it
    and to its own exact key and value."""
    g = cfg
    d, heads = g["model_dim"], g["heads"]
    dh = d // heads
    dev = conds.device
    n = codes.shape[0]
    full_text = torch.cat([torch.tensor([g["start_text_token"]], device=dev), text,
                           torch.tensor([g["stop_text_token"]], device=dev)])
    text_emb = W["text_embedding"][full_text] + W["text_pos_embedding"][: full_text.shape[0]]
    mel_in = torch.cat([torch.tensor([g["start_mel_token"]], device=dev), codes[:-1]])
    mel_pos = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                         torch.arange(n - 1, device=dev) + pos_off])
    mel_emb = W["mel_embedding"][mel_in] + W["mel_pos_embedding"][mel_pos]
    x = torch.cat([conds, text_emb, mel_emb])
    t = x.shape[0]
    p = t - n + 1  # the prefill's length: its last position is start_mel
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    if quant_kv:
        later = torch.arange(t, device=dev)[:, None] >= p
        rounded = causal & later & ~torch.eye(t, dtype=torch.bool, device=dev)
        exact = causal & ~rounded
    neg = torch.finfo(torch.float32).min
    for i in range(g["layers"]):
        b = f"gpt.blocks.{i}"
        qkv = linear(W, f"{b}.attn_qkv", layer_norm(W, f"{b}.ln_1", x), act)
        q, k, v = (y.view(t, heads, dh).transpose(0, 1) for y in qkv.split(d, dim=-1))
        if quant_kv:
            kq, vq = quantize_kv(k), quantize_kv(v)
            s_exact = act(q) @ act(k).transpose(-1, -2)
            s_round = act(q) @ act(kq).transpose(-1, -2)
            scores = torch.where(rounded, s_round, s_exact) / math.sqrt(dh)
            a = torch.softmax(scores.masked_fill(~causal, neg), dim=-1)
            o = act(a * exact) @ act(v) + act(a * rounded) @ act(vq)
        else:
            scores = (act(q) @ act(k).transpose(-1, -2)) / math.sqrt(dh)
            a = torch.softmax(scores.masked_fill(~causal, neg), dim=-1)
            o = act(a) @ act(v)
        x = x + linear(W, f"{b}.attn_proj", o.transpose(0, 1).reshape(t, d), act)
        hmid = linear(W, f"{b}.mlp_fc", layer_norm(W, f"{b}.ln_2", x), act)
        gelu_new = 0.5 * hmid * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (hmid + 0.044715 * hmid**3)))
        x = x + linear(W, f"{b}.mlp_proj", gelu_new, act)
    h = layer_norm(W, "final_norm", layer_norm(W, "gpt.ln_f", x[p - 1:]))
    return linear(W, "mel_head", h, act), h


def stop_logit(g: dict) -> Tuple[str, int]:
    """The tensor and index of the stop code's logit bias, which the
    benchmark's weights set low so that every row runs to its budget."""
    return "mel_head.bias", g["stop_mel_token"]
