"""The port's copy of the text frontend against the JAX package's: identical
normalized text, tokens, token ids and sentence splits on the texts of
tests/cases.jsonl, with a vocabulary that covers their characters."""

import json
import os

import pytest

from indextts_tpu.utils import front as jfront
from indextts_tpu.utils import spm as jspm
from indextts_tpu_torch.utils import front as tfront
from indextts_tpu_torch.utils import spm as tspm

CASES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cases.jsonl")
with open(CASES, encoding="utf-8") as _f:
    TEXTS = [json.loads(line)["text"] for line in _f if line.strip()]


def _tokenizer(front, spm, pieces):
    normalizer = front.TextNormalizer()
    normalizer.load()
    sp = spm.SentencePieceProcessor(vocab=spm.build_vocab_from_pieces(pieces))
    return front.TextTokenizer(sp_model=sp, normalizer=normalizer)


@pytest.fixture(scope="module")
def tokenizers():
    # a BPE-style vocabulary: the random-init pieces, every character of the
    # normalized cases, and a few multi-character merges
    norm = jfront.TextNormalizer()
    norm.load()
    chars = sorted({ch for t in TEXTS for ch in norm.normalize(t).upper() if not ch.isspace()})
    pieces = [(chr(65 + i), -float(i)) for i in range(26)] + [(".", -30.0), ("▁", -31.0)]
    have = {p for p, _ in pieces}
    pieces += [(c, -40.0 - i) for i, c in enumerate(chars) if c not in have]
    pieces += [(m, -5.0) for m in ("▁THE", "TH", "ING", "▁A", "ER")]
    return _tokenizer(jfront, jspm, pieces), _tokenizer(tfront, tspm, pieces)


@pytest.mark.parametrize("text", TEXTS)
def test_frontend_matches_jax(tokenizers, text):
    jt, tt = tokenizers
    assert tt.normalizer.normalize(text) == jt.normalizer.normalize(text)
    tokens = tt.tokenize(text)
    assert tokens == jt.tokenize(text)
    assert tt.convert_tokens_to_ids(tokens) == jt.convert_tokens_to_ids(tokens)
    assert tt.split_sentences(tokens, 16) == jt.split_sentences(tokens, 16)
