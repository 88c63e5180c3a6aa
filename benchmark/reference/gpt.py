"""Plain PyTorch reference of IndexTTS-1.5's GPT side: the conformer +
perceiver conditioning encoder and the UnifiedVoice GPT-2 over
[conditioning latents | text | mel codes], in float32.

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
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

Act = Callable[[torch.Tensor], torch.Tensor]


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def linear(W: Dict[str, torch.Tensor], name: str, x: torch.Tensor, act: Act = _same) -> torch.Tensor:
    b = W.get(f"{name}.bias")
    return F.linear(act(x), W[f"{name}.weight"], b)


def layer_norm(W: Dict[str, torch.Tensor], name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), W[f"{name}.weight"], W[f"{name}.bias"], 1e-5)


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


def gpt_pass(W, cfg: dict, conds: torch.Tensor, text: torch.Tensor, codes: torch.Tensor, pos_off: int,
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


# ---------------------------------------------------------------------------
# what a decode may pick: the sampling support at each step
# ---------------------------------------------------------------------------


def penalized(logits: torch.Tensor, seen: torch.Tensor, penalty: float) -> torch.Tensor:
    """HF's repetition penalty: seen tokens' positive scores divided by the
    penalty, the others multiplied."""
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, pen, logits)


def support_floor(scores: torch.Tensor, top_k: int, top_p: float, keep: int) -> torch.Tensor:
    """The least score a token may have and still be drawn, per row of
    scores [n, V] (temperature applied): inside the top_k, then the smallest
    set of the best whose probability reaches top_p; at least `keep` tokens."""
    k = min(top_k, scores.shape[-1]) if top_k else scores.shape[-1]
    vals = torch.topk(scores, k, dim=-1).values  # descending
    probs = torch.softmax(vals, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs  # mass strictly above each
    kept = (before < top_p).sum(dim=-1).clamp(min=keep, max=k)
    return vals.gather(-1, (kept - 1)[:, None])[:, 0]


def seen_before(codes: torch.Tensor, start_mel: int, vocab: int) -> torch.Tensor:
    """[n, V] bool: the tokens seen before step j (ids 1 and start_mel, which
    the reference's inference inputs hold, and codes 0..j-1)."""
    n = codes.shape[0]
    seen = torch.zeros(n, vocab, dtype=torch.bool, device=codes.device)
    seen[:, 1] = True
    seen[:, start_mel] = True
    onehot = torch.zeros(n, vocab, dtype=torch.bool, device=codes.device)
    onehot[torch.arange(n, device=codes.device), codes] = True
    return seen | (onehot.cumsum(dim=0) - onehot.long() > 0)


def step_scores(logits: torch.Tensor, codes: torch.Tensor, cfg: dict, penalty: float, beams: bool) -> torch.Tensor:
    """The scores a decode step ranks its candidates by, before the
    warpers: the repetition penalty on the logits, or with beams on their
    log-softmax (HF beam search)."""
    s = torch.log_softmax(logits, dim=-1) if beams else logits
    return penalized(s, seen_before(codes, cfg["start_mel_token"], cfg["number_mel_codes"]), penalty)


def support_gap(logits: torch.Tensor, codes: torch.Tensor, cfg: dict, knobs: dict, beams: bool) -> torch.Tensor:
    """Per step, how far the served code's score lies below the least score
    the step's sampling could have drawn (0 inside the support). Greedy
    (top_p = 0 or do_sample off) has the best alone as its support: the gap
    is then how far the served code lies below the best."""
    s = step_scores(logits, codes, cfg, knobs["repetition_penalty"], beams) / max(knobs["temperature"], 1e-6)
    keep = 2 if beams else 1
    if knobs["do_sample"]:
        floor = support_floor(s, knobs["top_k"], knobs["top_p"], keep)
    else:
        floor = s.max(dim=-1).values
    served = s.gather(-1, codes[:, None])[:, 0]
    return (floor - served).clamp(min=0.0)


def drawn_gap(logits: torch.Tensor, other: torch.Tensor, codes: torch.Tensor, cfg: dict, knobs: dict,
              beams: bool, generator: torch.Generator) -> torch.Tensor:
    """Per step (on the same served prefix), how far below the reference's
    support floor lies the code that a computation ranking by `other`'s
    logits draws in the served code's place: one draw from its own support,
    by its own probabilities, with uniforms from `generator` (for a greedy
    row, whose support is the best alone, the code it puts first)."""
    t = max(knobs["temperature"], 1e-6)
    s = step_scores(logits, codes, cfg, knobs["repetition_penalty"], beams) / t
    o = step_scores(other, codes, cfg, knobs["repetition_penalty"], beams) / t
    keep = 2 if beams else 1
    if knobs["do_sample"]:
        floor_s = support_floor(s, knobs["top_k"], knobs["top_p"], keep)
        floor_o = support_floor(o, knobs["top_k"], knobs["top_p"], keep)
    else:
        floor_s, floor_o = s.max(dim=-1).values, o.max(dim=-1).values
    masked = o.masked_fill(o < floor_o[:, None], float("-inf"))
    drawn = torch.multinomial(torch.softmax(masked, dim=-1), 1, generator=generator)
    return (floor_s - s.gather(-1, drawn)[:, 0]).clamp(min=0.0)
