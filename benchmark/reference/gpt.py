"""The parts of the plain PyTorch reference that every architecture shares:
a linear layer and a layer norm over named float32 tensors, and what a
decode may pick at each step (the sampling support, and how far a served
code lies below it). Each architecture's own pass is in
reference/models/<architecture>.py. It imports nothing of the program
under test.

`W` maps the checkpoint's tensor names to float32 tensors. `act` is applied
to the input of every matrix product (the identity for the reference; the
lower-precision control passes a rounding function there, and rounded
weights in `W`).
"""

from __future__ import annotations

from typing import Callable, Dict

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
