"""The text front end of the benchmark's vocabulary, written from its
definition: the 28-piece random-init BPE (the letters A-Z, "." and the word
start "▁", after three special ids), one piece per character, and the
reference's sentence split (cut after "." once a sentence holds more than
two pieces, then merge neighbours while they fit the per-sentence budget).

The benchmark's texts are words of capital letters separated by single
spaces, each sentence ending in ".", so no normalization rule applies."""

from __future__ import annotations

from typing import List

SPECIALS = 3
PERIOD = SPECIALS + 26
WORD = SPECIALS + 27


def tokenize(text: str) -> List[int]:
    """Text -> piece ids: each word starts with "▁", then one id a letter;
    "." is its own piece."""
    ids: List[int] = []
    for word in text.split(" "):
        if not word:
            continue
        ids.append(WORD)
        for ch in word:
            if ch == ".":
                ids.append(PERIOD)
            elif "A" <= ch <= "Z":
                ids.append(SPECIALS + ord(ch) - ord("A"))
            else:
                raise ValueError(f"character {ch!r} is outside the benchmark's vocabulary")
    return ids


def split_rows(ids: List[int], max_len: int) -> List[List[int]]:
    """Sentence rows as the decode receives them."""
    sentences: List[List[int]] = []
    buf: List[int] = []
    for tok in ids:
        buf.append(tok)
        if len(buf) > max_len:
            raise ValueError("a sentence longer than the budget: the benchmark's traffic never makes one")
        if tok == PERIOD and len(buf) > 2:
            sentences.append(buf)
            buf = []
    if buf:
        sentences.append(buf)
    rows: List[List[int]] = []
    for s in sentences:
        if rows and len(rows[-1]) + len(s) <= max_len:
            rows[-1] = rows[-1] + s
        else:
            rows.append(s)
    return rows
