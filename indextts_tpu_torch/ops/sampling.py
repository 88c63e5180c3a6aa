"""Logits processors and token choice for the AR decode loop
(port of indextts_tpu/ops/sampling.py).

HF generate() order (model.py:698-703 of the reference): the processors
(repetition penalty, typical) first, then the warpers temperature, top-k,
top-p when sampling; with num_beams > 1 the warpers keep at least two tokens.
All compute in float32 over [B, V] logits. Sampling parameters are Python
scalars: one request per decode batch.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits / max(float(temperature), 1e-6)


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor, penalty: float) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor: for seen tokens, positive logits
    are divided by `penalty`, non-positive multiplied. seen_mask: [B, V] bool."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen_mask, penalized, logits)


def apply_top_p(logits: torch.Tensor, top_p: float, min_tokens_to_keep: int = 1) -> torch.Tensor:
    """HF TopPLogitsWarper: remove the tail whose cumulative probability
    (ascending order) stays within 1 - top_p; top_p >= 1 keeps everything."""
    sorted_logits = torch.sort(logits, dim=-1).values  # ascending
    cum = torch.cumsum(torch.softmax(sorted_logits.float(), dim=-1), dim=-1)
    keep_sorted = cum > (1.0 - float(top_p))
    keep_sorted[..., -min_tokens_to_keep:] = True
    # threshold = smallest kept logit
    inf = torch.full_like(sorted_logits, float("inf"))
    thresh = torch.where(keep_sorted, sorted_logits, inf).min(dim=-1, keepdim=True).values
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


def apply_top_k_top_p(logits: torch.Tensor, top_k: int, top_p: float, min_tokens_to_keep: int = 1) -> torch.Tensor:
    """Top-k (every logit >= the k-th largest, ties kept), then top-p,
    without the vocabulary sort, as JAX computes it: of the survivors a
    value level v stays iff the survivor mass at or below v exceeds 1 - top_p;
    the min_tokens_to_keep largest levels always stay."""
    if not top_k or top_k <= 0:
        return apply_top_p(logits, top_p, min_tokens_to_keep)
    k = min(int(top_k), logits.shape[-1])
    lf = logits.float()
    vals = torch.topk(lf, k, dim=-1).values  # [B, k] descending
    support = lf >= vals[..., -1:]
    ex = torch.where(support, torch.exp(lf - vals[..., :1]), torch.zeros((), device=lf.device))
    z = ex.sum(dim=-1, keepdim=True)
    at_or_below = lf[..., None, :] <= vals[..., :, None]  # [B, k, V]
    c = torch.where(at_or_below, ex[..., None, :], torch.zeros((), device=lf.device)).sum(dim=-1) / z
    keep = c > (1.0 - float(top_p))
    keep[..., :min_tokens_to_keep] = True
    thresh = torch.where(keep, vals, torch.full_like(vals, float("inf"))).min(dim=-1, keepdim=True).values
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


def apply_typical(logits: torch.Tensor, mass: float = 0.9, min_tokens_to_keep: int = 1) -> torch.Tensor:
    """Typical sampling (typical_sampling.py:4-30 of the reference): keep the
    tokens whose -log p is closest to the entropy until `mass` cumulative
    probability is covered; the min_tokens_to_keep closest always stay."""
    lf = logits.float()
    normalized = torch.log_softmax(lf, dim=-1)
    p = torch.exp(normalized)
    ent = -torch.where(p > 0, normalized * p, torch.zeros((), device=lf.device)).sum(dim=-1, keepdim=True)
    shifted = torch.abs(-normalized - ent)
    order = torch.argsort(shifted, dim=-1, stable=True)
    sorted_logits = torch.gather(lf, -1, order)
    sorted_shifted = torch.gather(shifted, -1, order)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    last_ind = (cum < float(mass)).sum(dim=-1, keepdim=True).clamp_(max=lf.shape[-1] - 1)
    cutoff = torch.gather(sorted_shifted, -1, last_ind)
    remove = shifted > cutoff
    if min_tokens_to_keep > 1:
        rank = torch.argsort(order, dim=-1)  # each id's place in the sort
        remove &= rank >= min_tokens_to_keep
    return torch.where(remove, torch.full_like(logits, NEG_INF), logits)


def apply_warpers(logits: torch.Tensor, temperature: float, top_k: int, top_p: float,
                  min_tokens_to_keep: int = 1) -> torch.Tensor:
    """HF's sampling warpers in order: temperature, top-k, top-p, each
    keeping at least min_tokens_to_keep tokens (2 under beam_sample)."""
    lf = apply_temperature(logits, temperature)
    k = max(int(top_k), min_tokens_to_keep) if top_k else 0
    return apply_top_k_top_p(lf, k, top_p, min_tokens_to_keep=min_tokens_to_keep)


def process_logits(
    logits: torch.Tensor,
    seen_mask: Optional[torch.Tensor] = None,
    repetition_penalty: float = 1.0,
    typical_sampling: bool = False,
    typical_mass: float = 0.9,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    do_sample: bool = True,
    num_beams: int = 1,
) -> torch.Tensor:
    """The processor stack in HF order: repetition penalty, typical, then
    (sampling only) temperature, top-k and top-p. With num_beams > 1 the
    typical processor and the warpers keep at least two tokens, as HF builds
    them for beam_sample. Returns float32 [B, V]."""
    lf = logits.float()
    mtk = 2 if num_beams > 1 else 1
    if seen_mask is not None:
        lf = apply_repetition_penalty(lf, seen_mask, repetition_penalty)
    if typical_sampling:
        lf = apply_typical(lf, typical_mass, min_tokens_to_keep=mtk)
    if do_sample:
        lf = apply_warpers(lf, temperature, top_k, top_p, min_tokens_to_keep=mtk)
    return lf


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def inverse_cdf_token(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Categorical draw over masked logits [B, V] from uniforms u [B] in
    [0, 1): the first id whose cumulative probability exceeds u."""
    cdf = torch.cumsum(torch.softmax(logits.float(), dim=-1), dim=-1)
    idx = torch.searchsorted(cdf, u.float().reshape(-1, 1).to(cdf.device), right=True)
    return idx.reshape(-1).clamp_(max=logits.shape[-1] - 1)


def sample_token(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Categorical sample over masked logits [B, V] -> [B], one uniform per
    row from `generator` (which lives on the logits' device)."""
    u = torch.rand(logits.shape[0], generator=generator, device=logits.device)
    return inverse_cdf_token(logits, u)
