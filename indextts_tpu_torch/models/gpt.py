"""UnifiedVoice: the autoregressive speech-token LM
(port of indextts_tpu/models/gpt.py).

Behavioral reference: indextts/gpt/model.py:300-589 — text/mel embeddings with
learned per-modality positional tables, a GPT-2 core whose own wte/wpe are
unused, the conditioning encoders of the four condition types
(conformer_perceiver, IndexTTS-1.5's; conformer_encoder; the legacy
AttentionBlock stack with a perceiver, "perceiver", or mean-pooled,
"default"), the MelEncoder input path, and the teacher-forced pass that
returns the vocoder latents or the text / mel losses. The GPT blocks are an
nn.ModuleList run by a Python loop (the JAX package stacks them for lax.scan;
the weight bridge unstacks them).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from indextts_tpu_torch.config import GPTConfig, is_hybrid
from indextts_tpu_torch.models.attention_block import ConditioningEncoder
from indextts_tpu_torch.models.conformer import ConformerEncoder
from indextts_tpu_torch.models.granite import GraniteHybrid
from indextts_tpu_torch.models.perceiver import PerceiverResampler
from indextts_tpu_torch.ops.conv import conv1d
from indextts_tpu_torch.ops.cuda.decode_attn import decode_attn
from indextts_tpu_torch.ops.cuda.gpt2_chains import add_layer_norm, gelu_new
from indextts_tpu_torch.ops.norms import group_norm, layer_norm
from indextts_tpu_torch.ops.quant import linear_no_bias
from indextts_tpu_torch.parallel.mesh import copy_to_region, gather_from_region, reduce_from_region
from indextts_tpu_torch.weights import default_init_, normal_, uniform_

NEG = torch.finfo(torch.float32).min


# The residual stream between GPT-2 blocks: a tensor x, or a pair (x, d) that
# stands for x + d, d being a block's MLP output not yet added to it; the next
# LayerNorm (the next block's ln_1, or ln_f) adds it in the same launch (K8,
# ops/cuda/gpt2_chains.py)
Stream = Union[torch.Tensor, Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _ln(m: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, m.weight, m.bias)


def _sum_ln(m: nn.LayerNorm, h: Stream) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, m(x)) of the stream h, x its sum."""
    x, d = (h, None) if isinstance(h, torch.Tensor) else h
    return add_layer_norm(x, d, m.weight, m.bias)


def final_ln(m: nn.LayerNorm, h: Stream) -> torch.Tensor:
    """ln_f of the stream after the last block."""
    return _sum_ln(m, h)[1]


def _attn(q, k, v, bias):
    """q: [B, H, Tq, Dh]; k/v: [B, H, Tk, Dh]; bias: additive f32, broadcast
    to [B, H, Tq, Tk]."""
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    attn = torch.softmax(scores.float() + bias, dim=-1).to(q.dtype)
    return attn @ v


def write_at(buf: torch.Tensor, dim: int, idx: Union[int, torch.Tensor], val: torch.Tensor) -> None:
    """buf.select(dim, idx) = val in place, by index_copy_: `idx` is a
    one-element long tensor on buf's device (a captured step reads no host
    value), or an int, moved there."""
    buf.index_copy_(dim, torch.as_tensor(idx, device=buf.device).reshape(1), val.unsqueeze(dim))


def _col(lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A column-parallel product (attn_qkv, mlp_fc): on a tensor-parallel
    shard the input's gradient is all-reduced over the model group."""
    comm = getattr(lin, "tp_comm", None)
    return lin(x if comm is None else copy_to_region(x, comm))


def _row(lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product (attn_proj, mlp_proj): on a shard, the partial
    sums are all-reduced over the model group and the bias added once."""
    comm = getattr(lin, "tp_comm", None)
    if comm is None:
        return lin(x)
    y = reduce_from_region(linear_no_bias(lin, x), comm)
    return y + lin.bias.to(y.dtype)


def head_logits(lin: nn.Module, h: torch.Tensor, scaling: float = 1.0) -> torch.Tensor:
    """The mel / text head; a vocabulary-split head's logits are gathered,
    so every rank holds the whole [..., V]. `scaling` divides them (a
    granite hybrid's logits_scaling)."""
    comm = getattr(lin, "tp_comm", None)
    out = lin(h) if comm is None else gather_from_region(lin(copy_to_region(h, comm)), comm)
    return out if scaling == 1.0 else out / scaling


class GPT2Block(nn.Module):
    """One GPT-2 block; weights as HF Conv1D, y = x @ W + b. The four
    linears may be ops/quant.QuantLinear (quantize_gpt_blocks). On a
    tensor-parallel shard (parallel/mesh.shard_gpt_params) attn_qkv holds
    this rank's heads of q, k and v, and the head count and widths below are
    the local ones; `heads` is always the model's.

    A block takes and returns the residual stream (`Stream`): its MLP output
    is handed on beside the sum instead of added to it, and each residual add
    runs in one launch with the LayerNorm after it (K8's add_layer_norm;
    plain on the CPU, where it is the add and then the LayerNorm)."""

    def __init__(self, d: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(d)
        self.attn_qkv = nn.Linear(d, 3 * d)
        self.attn_proj = nn.Linear(d, d)
        self.ln_2 = nn.LayerNorm(d)
        self.mlp_fc = nn.Linear(d, 4 * d)
        self.mlp_proj = nn.Linear(4 * d, d)

    def qkv(self, h: Stream, heads: int):
        """(x, q, k, v): x the stream h summed, and q, k, v of ln_1(x), each
        [..., local heads, Dh]."""
        x, y = _sum_ln(self.ln_1, h)
        y = _col(self.attn_qkv, y)
        dl, dh = y.shape[-1] // 3, x.shape[-1] // heads
        q, k, v = (t.reshape(*t.shape[:-1], dl // dh, dh) for t in y.split(dl, dim=-1))
        return x, q, k, v

    def proj(self, x: torch.Tensor, a: torch.Tensor) -> Stream:
        """The block's rest after attention: x + attn_proj(a) and ln_2, then
        the MLP. Returns the stream (x + attn_proj(a), the MLP's output)."""
        x, y = add_layer_norm(x, _row(self.attn_proj, a), self.ln_2.weight, self.ln_2.bias)
        return x, _row(self.mlp_proj, gelu_new(_col(self.mlp_fc, y)))

    def forward(self, h: Stream, bias: torch.Tensor, heads: int):
        """Full sequence: the stream h over [B, T, D] -> (the stream out,
        (k, v) each [B, H, T, Dh])."""
        x, *qkv = self.qkv(h, heads)
        b, t, _ = x.shape
        q, k, v = (y.transpose(1, 2) for y in qkv)
        a = _attn(q, k, v, bias).transpose(1, 2).reshape(b, t, -1)
        return self.proj(x, a), (k, v)

    def step(self, h: Stream, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: Union[int, torch.Tensor],
             bias: torch.Tensor, heads: int) -> Stream:
        """One new token, the stream h over [B, D], against the caches [B, H,
        S, Dh]; returns the stream out. `bias` [B, 1, S] masks slot `pos`:
        the token's own K/V enter the softmax as an extra logit, as in JAX
        _decode_block, and are then written into slot `pos` of the caches in
        place (K6, ops/cuda/decode_attn.py). `pos` is an int or a one-element
        long tensor on the device (a captured step reads no host value)."""
        x, q, k, v = self.qkv(h, heads)
        return self.proj(x, decode_attn(q, k, v, (k_cache, v_cache), pos, bias))


class GPT2(nn.Module):
    def __init__(self, layers: int, d: int):
        super().__init__()
        self.blocks = nn.ModuleList(GPT2Block(d) for _ in range(layers))
        self.ln_f = nn.LayerNorm(d)


def gpt2_apply(gpt: GPT2, emb: torch.Tensor, heads: int, attention_mask: Optional[torch.Tensor] = None,
               return_kv: bool = False):
    """GPT-2 stack over [B, T, D] embeddings. attention_mask: [B, T], 1 =
    attend. With return_kv also returns (k, v), each [L, B, H, T, Dh]."""
    t = emb.shape[1]
    causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=emb.device))
    zero = torch.zeros((), device=emb.device)
    bias = torch.where(causal, zero, NEG)[None, None]
    if attention_mask is not None:
        bias = bias + torch.where(attention_mask.bool(), zero, NEG)[:, None, None, :]
    h = emb
    ks, vs = [], []
    for block in gpt.blocks:
        h, (k, v) = block(h, bias, heads)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = final_ln(gpt.ln_f, h)
    return (x, (torch.stack(ks), torch.stack(vs))) if return_kv else x


class UnifiedVoice(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.model_dim
        n_text = cfg.number_text_tokens * cfg.types + 1
        self.text_embedding = nn.Parameter(torch.zeros(n_text, d))
        self.mel_embedding = nn.Parameter(torch.zeros(cfg.number_mel_codes, d))
        self.text_pos_embedding = nn.Parameter(torch.zeros(cfg.max_text_seq_len, d))
        self.mel_pos_embedding = nn.Parameter(torch.zeros(cfg.max_mel_seq_len, d))
        self.hybrid = is_hybrid(cfg)
        self.logits_scaling = float(getattr(cfg, "logits_scaling", 1.0))
        self.gpt = GraniteHybrid(cfg) if self.hybrid else GPT2(cfg.layers, d)
        self.final_norm = nn.LayerNorm(d)
        self.text_head = nn.Linear(d, n_text)
        self.mel_head = nn.Linear(d, cfg.number_mel_codes)
        cm = cfg.condition_module
        self.perceiver_encoder = None
        if cfg.condition_type in ("conformer_perceiver", "conformer_encoder"):
            if cfg.condition_type == "conformer_encoder" and cm.output_size != d:
                # without the perceiver the conformer's latents join the GPT's
                # embedding stream as they are (model.py conditioning)
                raise NotImplementedError(
                    f"condition_type='conformer_encoder' needs condition_module.output_size == model_dim "
                    f"({cm.output_size} != {d})"
                )
            self.conditioning_encoder = ConformerEncoder(cm, input_size=100)
            if cfg.condition_type == "conformer_perceiver":
                self.perceiver_encoder = PerceiverResampler(
                    dim=d, dim_context=cm.output_size, num_latents=cfg.condition_num_latent,
                    heads=cm.attention_heads, ff_mult=cm.perceiver_mult,
                )
        elif cfg.condition_type in ("perceiver", "default"):
            # the legacy AttentionBlock stack (model.py:344-346, 360); "perceiver"
            # resamples it with init_perceiver's default heads and ff_mult
            self.conditioning_encoder = ConditioningEncoder(100, d, attn_blocks=6, num_attn_heads=cfg.heads)
            if cfg.condition_type == "perceiver":
                self.perceiver_encoder = PerceiverResampler(dim=d, dim_context=d, num_latents=cfg.condition_num_latent)
        else:
            raise NotImplementedError(
                f"condition_type={cfg.condition_type!r}: the reference's 'gst' branch references an "
                "encoder it never constructs (model.py:503-506) and is unsupported there too"
            )

    def reset_parameters(self, g: torch.Generator) -> None:
        """init_unified_voice's distributions: GPT-2 normal(0.02) with the
        residual projections at 0.02/sqrt(2*layers), zero biases (a granite
        hybrid stack: GraniteHybrid.reset_parameters); torch
        default uniform for the conditioning encoders, xavier pos biases, and
        the legacy encoder's own init (ConditioningEncoder.reset_parameters)."""
        default_init_(self, g)
        for p in (self.text_embedding, self.mel_embedding, self.text_pos_embedding, self.mel_pos_embedding):
            normal_(p, 0.02, g)
        if self.hybrid:  # the granite stack's published init
            self.gpt.reset_parameters(g)
        else:
            proj_std = 0.02 / math.sqrt(2 * self.cfg.layers)
            for blk in self.gpt.blocks:
                for lin, std in ((blk.attn_qkv, 0.02), (blk.attn_proj, proj_std), (blk.mlp_fc, 0.02),
                                 (blk.mlp_proj, proj_std)):
                    normal_(lin.weight, std, g)
                    nn.init.zeros_(lin.bias)
        for head in (self.text_head, self.mel_head):
            normal_(head.weight, 0.02, g)
            nn.init.zeros_(head.bias)
        if isinstance(self.conditioning_encoder, ConditioningEncoder):
            self.conditioning_encoder.reset_parameters(g)
        else:
            for layer in self.conditioning_encoder.layers:
                if layer.rel_pos:
                    h, d_k = layer.attn.pos_bias_u.shape
                    for p in (layer.attn.pos_bias_u, layer.attn.pos_bias_v):
                        uniform_(p, math.sqrt(6.0 / (h + d_k)), g)
        if self.perceiver_encoder is not None:
            normal_(self.perceiver_encoder.latents, 0.02, g)
            nn.init.ones_(self.perceiver_encoder.norm_gamma)


def _gn(m: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return group_norm(x, m.weight, m.bias, m.num_groups)


class _MelResBlock(nn.Module):
    def __init__(self, chan: int):
        super().__init__()
        self.conv0 = nn.Conv1d(chan, chan, 3)
        self.conv1 = nn.Conv1d(chan, chan, 3)
        self.gn0 = nn.GroupNorm(chan // 8, chan)
        self.gn1 = nn.GroupNorm(chan // 8, chan)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _gn(self.gn0, conv1d(x, self.conv0.weight, self.conv0.bias, padding=1))
        h = _gn(self.gn1, conv1d(torch.relu(h), self.conv1.weight, self.conv1.bias, padding=1))
        return torch.relu(h + x)


class MelEncoder(nn.Module):
    """The use_mel_codes_as_input=False input path (model.py:21-37,
    277-297): conv and ResBlock stages with two stride-2 reductions, mel
    [B, T, mel_channels] -> [B, T/4, channels]. The reference's inference
    never takes it; it is here for parity with the JAX package's
    init_mel_encoder / mel_encoder_apply. The GroupNorms use chan // 8 groups
    in the resblocks, channels // 16 after down0 and channels // 8 after
    down1."""

    def __init__(self, channels: int, mel_channels: int = 80, resblocks_per_reduction: int = 1):
        super().__init__()
        c4, c2 = channels // 4, channels // 2
        self.conv_in = nn.Conv1d(mel_channels, c4, 3)
        self.res0 = nn.ModuleList(_MelResBlock(c4) for _ in range(resblocks_per_reduction))
        self.down0 = nn.Conv1d(c4, c2, 3)
        self.gn_a = nn.GroupNorm(channels // 16, c2)
        self.res1 = nn.ModuleList(_MelResBlock(c2) for _ in range(resblocks_per_reduction))
        self.down1 = nn.Conv1d(c2, channels, 3)
        self.gn_b = nn.GroupNorm(channels // 8, channels)
        self.res2 = nn.ModuleList(_MelResBlock(channels) for _ in range(resblocks_per_reduction))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel_encoder_apply."""
        h = conv1d(mel, self.conv_in.weight, self.conv_in.bias, padding=1)
        for blk in self.res0:
            h = blk(h)
        h = torch.relu(_gn(self.gn_a, conv1d(h, self.down0.weight, self.down0.bias, stride=2, padding=1)))
        for blk in self.res1:
            h = blk(h)
        h = torch.relu(_gn(self.gn_b, conv1d(h, self.down1.weight, self.down1.bias, stride=2, padding=1)))
        for blk in self.res2:
            h = blk(h)
        return h

    def reset_parameters(self, g: torch.Generator) -> None:
        """init_mel_encoder's distributions: convs U(+-1/sqrt(fan_in)), the
        GroupNorms the identity."""
        default_init_(self, g)


def get_conditioning(model: UnifiedVoice, cfg: GPTConfig, speech_conditioning_mel: torch.Tensor,
                     cond_mel_lengths: torch.Tensor) -> torch.Tensor:
    """Prompt mel [B, frames, 100] -> conditioning latents: [B, latents, D]
    (conformer_perceiver, perceiver), [B, frames', output_size]
    (conformer_encoder) or [B, 1, D] (default) (reference: model.py:490-519).
    The legacy encoders see every frame: cond_mel_lengths is not used there,
    as in the reference."""
    if cfg.condition_type == "conformer_perceiver":
        enc, mask = model.conditioning_encoder(speech_conditioning_mel, cond_mel_lengths)
        ones = torch.ones(enc.shape[0], cfg.condition_num_latent, dtype=torch.bool, device=enc.device)
        return model.perceiver_encoder(enc, torch.cat([ones, mask[:, 0, :]], dim=1))
    if cfg.condition_type == "conformer_encoder":
        return model.conditioning_encoder(speech_conditioning_mel, cond_mel_lengths)[0]
    if cfg.condition_type == "perceiver":
        return model.perceiver_encoder(model.conditioning_encoder(speech_conditioning_mel))
    if cfg.condition_type == "default":
        return model.conditioning_encoder(speech_conditioning_mel, mean=True)[:, None, :]
    raise NotImplementedError(cfg.condition_type)


def set_padding(tokens: torch.Tensor, lengths: torch.Tensor, pad_value: int) -> torch.Tensor:
    """Replace positions >= length with pad_value (reference: model.py:434-460)."""
    idx = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    return torch.where(idx >= lengths[:, None], torch.full_like(tokens, pad_value), tokens)


def _frame(tokens: torch.Tensor, start: int, stop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inputs, targets) of build_aligned_inputs_and_targets after the
    trailing stop pad (model.py:561-566): [start, tokens..., stop] and
    [tokens..., stop, stop]."""
    b = tokens.shape[0]
    start_col, stop_col = tokens.new_full((b, 1), start), tokens.new_full((b, 1), stop)
    return torch.cat([start_col, tokens, stop_col], dim=1), torch.cat([tokens, stop_col, stop_col], dim=1)


def _hybrid_apply(stack: GraniteHybrid, emb: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The hybrid stack over [B, T, D] with the key mask [B, T] (None: all
    real): each row's real positions are moved to its front in order, so that
    a Mamba layer's convolution and state run over the row's real tokens
    alone, as over the row's sequence without padding; the hiddens go back to
    their places (a padded position's is unused)."""
    if mask is None:
        return stack(emb)
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)  # real positions first, in order
    idx = order[..., None].expand(-1, -1, emb.shape[-1])
    hidden = stack(torch.gather(emb, 1, idx), torch.gather(mask, 1, order))
    return torch.empty_like(hidden).scatter_(1, idx, hidden)


def unified_voice_forward(
    model: UnifiedVoice,
    cfg: GPTConfig,
    speech_conditioning_mel: Optional[torch.Tensor],
    text_inputs: torch.Tensor,
    text_lengths: torch.Tensor,
    mel_codes: torch.Tensor,
    wav_lengths: torch.Tensor,
    cond_mel_lengths: Optional[torch.Tensor],
    return_latent: bool = True,
    text_first: bool = True,
    conds: Optional[torch.Tensor] = None,
    types: Optional[torch.Tensor] = None,
    mask_pad_keys: bool = False,
):
    """Teacher-forced pass (reference: model.py:521-589; JAX
    unified_voice_forward, with its argument order and defaults). Returns the
    vocoder latents [B, T_mel, D] (return_latent), else (loss_text, loss_mel,
    mel_logits [B, V, T_mel + 2]).

    `conds` are precomputed conditioning latents; when None they come from
    get_conditioning(speech_conditioning_mel, cond_mel_lengths), which may
    then be None. `types` [B] moves each row's text into its own embedding
    range (model.py:541-543). `text_first=False` puts the mel block before
    the text block. `mask_pad_keys` masks the keys that exist only because
    of shape bucketing: framed text positions >= text_len + 2 and mel
    positions >= mel_code_len + 1 (the engine's latent pass sets it). On a
    tensor-parallel model (parallel/mesh.shard_gpt_params) the vocabulary
    shards of the heads are gathered, so every rank returns the whole
    logits and losses."""
    if conds is None:
        conds = get_conditioning(model, cfg, speech_conditioning_mel, cond_mel_lengths)
    if types is not None:
        text_inputs = text_inputs * (1 + types)[:, None]
    mel_code_lengths = (wav_lengths + cfg.mel_length_compression - 1) // cfg.mel_length_compression + 1
    mel_codes = set_padding(mel_codes, mel_code_lengths, cfg.stop_mel_token)
    text_inputs = set_padding(text_inputs, text_lengths, cfg.stop_text_token)
    text_in, text_targets = _frame(text_inputs, cfg.start_text_token, cfg.stop_text_token)
    mel_in, mel_targets = _frame(mel_codes, cfg.start_mel_token, cfg.stop_mel_token)
    text_emb = model.text_embedding[text_in] + model.text_pos_embedding[: text_in.shape[1]][None]
    mel_emb = model.mel_embedding[mel_in] + model.mel_pos_embedding[: mel_in.shape[1]][None]
    first, second = (text_emb, mel_emb) if text_first else (mel_emb, text_emb)
    emb = torch.cat([conds.to(text_emb.dtype), first, second], dim=1)
    mask = None
    if mask_pad_keys:
        b, dev = emb.shape[0], emb.device
        # valid keys: all conds; text [start, t_0..t_{len-1}, stop] = len+2; mel
        # [start, c_0.., stop] = mel_code_len+1 — the rest is bucket padding
        text_ok = torch.arange(text_in.shape[1], device=dev)[None, :] < (text_lengths + 2)[:, None]
        mel_ok = torch.arange(mel_in.shape[1], device=dev)[None, :] < (mel_code_lengths + 1)[:, None]
        blocks = (text_ok, mel_ok) if text_first else (mel_ok, text_ok)
        mask = torch.cat([torch.ones(b, conds.shape[1], dtype=torch.bool, device=dev), *blocks], dim=1)
    if model.hybrid:
        hidden = _hybrid_apply(model.gpt, emb, mask)
    else:
        hidden = gpt2_apply(model.gpt, emb, cfg.heads, attention_mask=mask)
    enc = _ln(model.final_norm, hidden[:, conds.shape[1]:])
    first_out, second_out = enc[:, : first.shape[1]], enc[:, -second.shape[1]:]
    if return_latent:
        # the second block, without the two trailing frames this forward adds (model.py:576-578)
        return second_out[:, :-2]
    text_out, mel_out = (first_out, second_out) if text_first else (second_out, first_out)
    text_logits = head_logits(model.text_head, text_out, model.logits_scaling)
    mel_logits = head_logits(model.mel_head, mel_out, model.logits_scaling)

    def ce(logits, targets):
        return F.cross_entropy(logits.float().flatten(0, 1), targets.flatten())

    # the reference returns [B, V, T]-permuted logits (model.py:479-486)
    return ce(text_logits, text_targets), ce(mel_logits, mel_targets), mel_logits.transpose(1, 2)
