"""Logits processors and token choice for the AR decode loop
(port of indextts_tpu/ops/sampling.py, the num_beams == 1 subset).

HF generate() order (model.py:698-703 of the reference): the repetition
penalty (a processor) first, then the warpers temperature, top-k, top-p when
sampling. All compute in float32 over [B, V] logits. Sampling parameters are
Python scalars: one request per decode batch.
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


def apply_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep every logit >= the k-th largest (ties at the k-th value stay)."""
    if not top_k or top_k <= 0:
        return logits
    k = min(int(top_k), logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


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


def process_logits(
    logits: torch.Tensor,
    seen_mask: Optional[torch.Tensor] = None,
    repetition_penalty: float = 1.0,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    do_sample: bool = True,
) -> torch.Tensor:
    """The processor stack in HF order: repetition penalty, then (sampling
    only) temperature, top-k, top-p. Returns float32 [B, V]."""
    lf = logits.float()
    if seen_mask is not None:
        lf = apply_repetition_penalty(lf, seen_mask, repetition_penalty)
    if do_sample:
        lf = apply_temperature(lf, temperature)
        lf = apply_top_k(lf, top_k)
        lf = apply_top_p(lf, top_p)
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
