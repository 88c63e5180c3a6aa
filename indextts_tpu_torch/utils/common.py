"""Shared host utilities: the string helpers and safe_log of
indextts_tpu/utils/common.py, copied so that the port never imports jax.

Behavioral reference: indextts/utils/common.py (CJK pre/de-tokenization,
safe_log).
"""

from __future__ import annotations

import re

import numpy as np
import torch

# CJK codepoint class (the nltk tokenize/util.py ranges the reference's BPE
# training pipeline assumed; behavioral reference: common.py:29-81)
_CJK_CLASS = (
    "ᄀ-ᇿ⺀-꓏ꡀ-힯豈-﫿"
    "︰-﹏･-ￜ\U00020000-\U0002FFFF"
)
# one CJK char, or a maximal run of anything else
_SEGMENT_RE = re.compile(f"[{_CJK_CLASS}]|[^{_CJK_CLASS}]+")
# a Latin word group: words joined by single spaces or dashes
_LATIN_RUN_RE = re.compile(r"[A-Z]+(?:[\s-][A-Z-]+)*", re.IGNORECASE)
_MARKER_RE = re.compile(r"<sent_(\d+)>")


def tokenize_by_CJK_char(line: str, do_upper_case: bool = True) -> str:
    """Space-separate every CJK char while leaving Latin runs whole; Latin is
    upper-cased so it matches the BPE vocab's casing.

    "你好世界是 hello world 的中文" -> "你 好 世 界 是 HELLO WORLD 的 中 文"
    """
    pieces = []
    for m in _SEGMENT_RE.finditer(line):
        seg = m.group().strip()
        if not seg:
            continue
        pieces.append(seg.upper() if do_upper_case else seg)
    return " ".join(pieces)


def de_tokenized_by_CJK_char(line: str, do_lower_case: bool = False) -> str:
    """Undo tokenize_by_CJK_char: drop the spaces between CJK chars but keep
    the spacing inside Latin word groups.

    Latin runs are stashed behind numbered markers first, every remaining
    space is removed, then the runs are swapped back in (lower-cased when
    requested).
    """
    # positional stash (re.sub replaces each MATCH in place): str.replace
    # would also rewrite the run's text wherever else it appears — inside an
    # already-inserted marker ("sent" itself) or inside a longer
    # not-yet-stashed run — corrupting the restoration map
    runs: list = []

    def _stash(m):
        runs.append(m.group())
        return f"<sent_{len(runs) - 1}>"

    masked = _LATIN_RUN_RE.sub(_stash, line)

    joined = []
    for chunk in masked.split():
        # restore EVERY marker in the chunk: two Latin runs joined by an
        # apostrophe ("DON'T" -> <sent_0>'<sent_1>) land in one whitespace
        # chunk, and restoring only the first would leak a literal <sent_1>
        # into the decoded text. (The reference's common.py has the
        # single-restore defect; fixed here deliberately — decode output
        # must never contain synthetic markers.)
        restored = _MARKER_RE.sub(lambda m: runs[int(m.group(1))], chunk)
        if restored != chunk and do_lower_case:
            restored = restored.lower()
        joined.append(restored)
    return "".join(joined)


def safe_log(x, clip_val: float = 1e-7):
    """log with clipping (reference behavior: common.py:110-121)."""
    if isinstance(x, np.ndarray):
        return np.log(np.clip(x, clip_val, None))
    return torch.log(torch.clamp(x, min=clip_val))
