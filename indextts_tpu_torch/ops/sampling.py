"""Logits processors and token choice for the AR decode loop
(port of indextts_tpu/ops/sampling.py).

HF generate() order (model.py:698-703 of the reference): the processors
(repetition penalty, typical) first, then the warpers temperature, top-k,
top-p when sampling; with num_beams > 1 the warpers keep at least two tokens.
All compute in float32 over [B, V] logits. Every dynamic knob (temperature,
top_p, repetition_penalty, typical_mass) is a Python float or a [B] tensor
with one value per row, so that requests with different knobs share a decode
batch (infer_batch's per_request_kwargs, the slot rows).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

NEG_INF = -1e30

Knob = Union[float, torch.Tensor]


def _colp(p: Knob, like: torch.Tensor) -> Knob:
    """A sampling knob as a float, or per row as a float32 column [B, 1] on
    `like`'s device, which broadcasts against [B, V] and [B, k]."""
    if isinstance(p, torch.Tensor) and p.dim() == 1:
        return p.to(device=like.device, dtype=torch.float32)[:, None]
    return float(p)


def row_knob(p: Knob, rows: int, device) -> torch.Tensor:
    """A dynamic knob as one float32 value per row [rows] on `device`: how a
    captured step takes it, from a static buffer (a float would be baked
    into the graph)."""
    if isinstance(p, torch.Tensor) and p.dim() == 1:
        return p.to(device=device, dtype=torch.float32)
    return torch.full((rows,), float(p), dtype=torch.float32, device=device)


def apply_temperature(logits: torch.Tensor, temperature: Knob) -> torch.Tensor:
    t = _colp(temperature, logits)
    return logits / (t.clamp(min=1e-6) if isinstance(t, torch.Tensor) else max(t, 1e-6))


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor, penalty: Knob) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor: for seen tokens, positive logits
    are divided by `penalty`, non-positive multiplied. seen_mask: [B, V] bool."""
    penalty = _colp(penalty, logits)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen_mask, penalized, logits)


def apply_top_p(logits: torch.Tensor, top_p: Knob, min_tokens_to_keep: int = 1) -> torch.Tensor:
    """HF TopPLogitsWarper: remove the tail whose cumulative probability
    (ascending order) stays within 1 - top_p; top_p >= 1 keeps everything."""
    sorted_logits = torch.sort(logits, dim=-1).values  # ascending
    cum = torch.cumsum(torch.softmax(sorted_logits.float(), dim=-1), dim=-1)
    keep_sorted = cum > (1.0 - _colp(top_p, logits))
    keep_sorted[..., -min_tokens_to_keep:].fill_(True)
    # threshold = smallest kept logit
    inf = torch.full_like(sorted_logits, float("inf"))
    thresh = torch.where(keep_sorted, sorted_logits, inf).min(dim=-1, keepdim=True).values
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


def apply_top_k_top_p(logits: torch.Tensor, top_k: int, top_p: Knob, min_tokens_to_keep: int = 1) -> torch.Tensor:
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
    keep = c > (1.0 - _colp(top_p, logits))
    keep[..., :min_tokens_to_keep].fill_(True)
    thresh = torch.where(keep, vals, torch.full_like(vals, float("inf"))).min(dim=-1, keepdim=True).values
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


def apply_typical(logits: torch.Tensor, mass: Knob = 0.9, min_tokens_to_keep: int = 1) -> torch.Tensor:
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
    last_ind = (cum < _colp(mass, logits)).sum(dim=-1, keepdim=True).clamp_(max=lf.shape[-1] - 1)
    cutoff = torch.gather(sorted_shifted, -1, last_ind)
    remove = shifted > cutoff
    if min_tokens_to_keep > 1:
        rank = torch.argsort(order, dim=-1)  # each id's place in the sort
        remove &= rank >= min_tokens_to_keep
    return torch.where(remove, torch.full_like(logits, NEG_INF), logits)


def apply_warpers(logits: torch.Tensor, temperature: Knob, top_k: int, top_p: Knob,
                  min_tokens_to_keep: int = 1) -> torch.Tensor:
    """HF's sampling warpers in order: temperature, top-k, top-p, each
    keeping at least min_tokens_to_keep tokens (2 under beam_sample)."""
    lf = apply_temperature(logits, temperature)
    k = max(int(top_k), min_tokens_to_keep) if top_k else 0
    return apply_top_k_top_p(lf, k, top_p, min_tokens_to_keep=min_tokens_to_keep)


def process_logits(
    logits: torch.Tensor,
    seen_mask: Optional[torch.Tensor] = None,
    repetition_penalty: Knob = 1.0,
    typical_sampling: bool = False,
    typical_mass: Knob = 0.9,
    temperature: Knob = 1.0,
    top_k: int = 0,
    top_p: Knob = 1.0,
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


@dataclass(frozen=True)
class RowDraw:
    """The generator of a data-parallel rank that decodes rows [start, start
    + B) of a batch of `total` rows: each draw takes the uniforms of the
    whole batch from `generator` (in the same state on every rank) and keeps
    this rank's rows, so sampled codes do not depend on the mesh, as with
    JAX's one key over the global array."""

    generator: torch.Generator
    start: int
    total: int


def uniforms(shape: Sequence[int], generator: Union[torch.Generator, RowDraw, torch.Tensor], device) -> torch.Tensor:
    """torch.rand(shape) from `generator`; from a RowDraw, the rows [start,
    start + shape[0]) of the whole batch's draw; a tensor is a draw already
    made (a captured step's uniforms, drawn before its replay) and is
    returned as it is."""
    if isinstance(generator, torch.Tensor):
        if tuple(generator.shape) != tuple(shape):
            raise ValueError(f"uniforms: a draw of shape {tuple(generator.shape)} where {tuple(shape)} is needed")
        return generator
    if isinstance(generator, RowDraw):
        u = torch.rand((generator.total, *shape[1:]), generator=generator.generator, device=device)
        return u[generator.start : generator.start + shape[0]]
    return torch.rand(tuple(shape), generator=generator, device=device)


def sample_token(logits: torch.Tensor, generator: Union[torch.Generator, RowDraw, torch.Tensor]) -> torch.Tensor:
    """Categorical sample over masked logits [B, V] -> [B], one uniform per
    row from `generator` (which lives on the logits' device), or from a [B]
    tensor of uniforms already drawn."""
    u = uniforms((logits.shape[0],), generator, logits.device)
    return inverse_cdf_token(logits, u)
