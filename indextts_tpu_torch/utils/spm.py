"""Self-contained SentencePiece-compatible tokenizer.

The reference loads `bpe.model` with the sentencepiece C++ library
(indextts/utils/front.py:243). That library is not available in this image, so
this module implements (a) a minimal protobuf wire-format reader for
sentencepiece ModelProto files, and (b) BPE-merge and Unigram-Viterbi
encoders/decoders over the extracted (piece, score, type) table. It covers the
subset of sentencepiece behavior the IndexTTS frontend exercises: whitespace
escaping with ▁, dummy-prefix insertion, NFKC-style normalization, greedy
best-score BPE merging, piece<->id lookups, and detokenization.
"""

from __future__ import annotations

import struct
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

WS = "▁"  # ▁

# SentencePiece piece types (ModelProto.SentencePiece.Type)
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6


# ---------------------------------------------------------------------------
# protobuf wire-format reader (just enough for ModelProto)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message body."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


@dataclass
class SentencePieceVocab:
    pieces: List[str]
    scores: List[float]
    types: List[int]
    model_type: int = 2  # 1=unigram, 2=bpe
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    normalizer_name: str = "nmt_nfkc"
    byte_fallback: bool = False
    unk_id: int = 2  # sentencepiece TrainerSpec default unk/bos/eos = 0/1/2? (see below)

    piece_to_id_map: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.piece_to_id_map:
            self.piece_to_id_map = {p: i for i, p in enumerate(self.pieces)}
        # locate <unk> by piece type if present
        for i, t in enumerate(self.types):
            if t == UNKNOWN:
                self.unk_id = i
                break


def parse_model_proto(data: bytes) -> SentencePieceVocab:
    """Parse a serialized sentencepiece ModelProto."""
    pieces: List[str] = []
    scores: List[float] = []
    types: List[int] = []
    model_type = 2
    add_dummy_prefix = True
    remove_extra_ws = True
    escape_ws = True
    norm_name = "nmt_nfkc"
    byte_fallback = False

    for fnum, wtype, val in _iter_fields(data):
        if fnum == 1 and wtype == 2:  # repeated SentencePiece
            piece, score, ptype = "", 0.0, NORMAL
            for sfnum, swt, sval in _iter_fields(val):
                if sfnum == 1:
                    piece = sval.decode("utf-8")
                elif sfnum == 2:
                    score = struct.unpack("<f", sval)[0]
                elif sfnum == 3:
                    ptype = sval
            pieces.append(piece)
            scores.append(score)
            types.append(ptype)
        elif fnum == 2 and wtype == 2:  # TrainerSpec
            for sfnum, swt, sval in _iter_fields(val):
                if sfnum == 3:  # model_type enum
                    model_type = sval
                elif sfnum == 35:  # byte_fallback
                    byte_fallback = bool(sval)
        elif fnum == 3 and wtype == 2:  # NormalizerSpec
            for sfnum, swt, sval in _iter_fields(val):
                if sfnum == 1:
                    norm_name = sval.decode("utf-8")
                elif sfnum == 3:
                    add_dummy_prefix = bool(sval)
                elif sfnum == 4:
                    remove_extra_ws = bool(sval)
                elif sfnum == 5:
                    escape_ws = bool(sval)
    return SentencePieceVocab(
        pieces=pieces,
        scores=scores,
        types=types,
        model_type=model_type,
        add_dummy_prefix=add_dummy_prefix,
        remove_extra_whitespaces=remove_extra_ws,
        escape_whitespaces=escape_ws,
        normalizer_name=norm_name,
        byte_fallback=byte_fallback,
    )


def serialize_model_proto(vocab: SentencePieceVocab) -> bytes:
    """Write a minimal ModelProto (used by tests and by the tiny-model builder)."""

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                out += bytes([b7])
                return out

    def ld(fnum: int, payload: bytes) -> bytes:
        return varint((fnum << 3) | 2) + varint(len(payload)) + payload

    def vi(fnum: int, v: int) -> bytes:
        return varint(fnum << 3) + varint(v)

    out = b""
    for piece, score, ptype in zip(vocab.pieces, vocab.scores, vocab.types):
        body = ld(1, piece.encode("utf-8")) + varint((2 << 3) | 5) + struct.pack("<f", score) + vi(3, ptype)
        out += ld(1, body)
    trainer = vi(3, vocab.model_type) + vi(35, int(vocab.byte_fallback))
    out += ld(2, trainer)
    norm = (
        ld(1, vocab.normalizer_name.encode("utf-8"))
        + vi(3, int(vocab.add_dummy_prefix))
        + vi(4, int(vocab.remove_extra_whitespaces))
        + vi(5, int(vocab.escape_whitespaces))
    )
    out += ld(3, norm)
    return out


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------


class SentencePieceProcessor:
    """Drop-in subset of sentencepiece.SentencePieceProcessor."""

    def __init__(
        self,
        model_file: Optional[str] = None,
        vocab: Optional[SentencePieceVocab] = None,
        use_native: bool = True,
    ):
        if vocab is None:
            if model_file is None:
                raise ValueError("need model_file or vocab")
            with open(model_file, "rb") as f:
                vocab = parse_model_proto(f.read())
        self.v = vocab
        self._max_piece_len = max((len(p) for p in self.v.pieces), default=1)
        # user-defined pieces are matched as indivisible symbols before BPE/unigram
        self._user_defined = {
            p for p, t in zip(self.v.pieces, self.v.types) if t == USER_DEFINED
        }
        # the port carries no copy of the optional C++ merge engine, so
        # `use_native` is accepted and ignored: the pure-Python merges have the
        # same semantics
        self._native = None

    # -- vocab accessors -------------------------------------------------
    def GetPieceSize(self) -> int:
        return len(self.v.pieces)

    vocab_size = GetPieceSize
    __len__ = GetPieceSize

    def IdToPiece(self, ids):
        if isinstance(ids, int):
            return self.v.pieces[ids]
        return [self.v.pieces[i] for i in ids]

    def PieceToId(self, piece: str) -> int:
        return self.v.piece_to_id_map.get(piece, self.v.unk_id)

    def unk_id(self) -> int:
        return self.v.unk_id

    # -- normalization ---------------------------------------------------
    def _normalize(self, text: str) -> str:
        if "nfkc" in self.v.normalizer_name:
            text = unicodedata.normalize("NFKC", text)
        if self.v.remove_extra_whitespaces:
            text = " ".join(text.split())
        if self.v.add_dummy_prefix and text:
            text = " " + text
        if self.v.escape_whitespaces:
            text = text.replace(" ", WS)
        return text

    # -- symbol pre-split (user-defined pieces are atomic) ---------------
    def _pre_split(self, text: str) -> List[str]:
        if not self._user_defined:
            return list(text)
        symbols: List[str] = []
        i, n = 0, len(text)
        while i < n:
            matched = None
            for ln in range(min(self._max_piece_len, n - i), 0, -1):
                if text[i : i + ln] in self._user_defined:
                    matched = text[i : i + ln]
                    break
            if matched:
                symbols.append(matched)
                i += len(matched)
            else:
                symbols.append(text[i])
                i += 1
        return symbols

    # -- BPE -------------------------------------------------------------
    def _encode_bpe(self, text: str) -> List[str]:
        symbols = self._pre_split(text)
        if not symbols:
            return []
        get = self.v.piece_to_id_map.get
        scores = self.v.scores
        types = self.v.types
        while True:
            best_score = None
            best_i = -1
            best_piece = None
            for i in range(len(symbols) - 1):
                cand = symbols[i] + symbols[i + 1]
                idx = get(cand)
                if idx is None or types[idx] != NORMAL:
                    # real sentencepiece never merges INTO control/unknown/
                    # unused/byte pieces from raw text — literal "<s>" in
                    # input must not assemble into the bos id
                    continue
                s = scores[idx]
                if best_score is None or s > best_score:
                    best_score = s
                    best_i = i
                    best_piece = cand
            if best_piece is None:
                break
            symbols[best_i : best_i + 2] = [best_piece]
        return self._resolve_unknown(symbols)

    # -- Unigram Viterbi ---------------------------------------------------
    def _encode_unigram(self, text: str) -> List[str]:
        n = len(text)
        if n == 0:
            return []
        get = self.v.piece_to_id_map.get
        scores = self.v.scores
        min_score = min(scores) if scores else 0.0
        unk_score = min_score - 10.0
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, str]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            # unknown single char fallback
            cand = best[i] + unk_score
            if cand > best[i + 1]:
                best[i + 1] = cand
                back[i + 1] = (i, text[i])
            for ln in range(1, min(self._max_piece_len, n - i) + 1):
                piece = text[i : i + ln]
                idx = get(piece)
                if idx is None:
                    continue
                t = self.v.types[idx]
                if t not in (NORMAL, USER_DEFINED):
                    # BYTE pieces too: they are reachable only through
                    # byte_fallback, never by matching their surface in text
                    continue
                cand = best[i] + scores[idx]
                if cand > best[i + ln]:
                    best[i + ln] = cand
                    back[i + ln] = (i, piece)
        pieces: List[str] = []
        pos = n
        while pos > 0:
            prev, piece = back[pos]
            pieces.append(piece)
            pos = prev
        pieces.reverse()
        return self._resolve_unknown(pieces)

    def _resolve_unknown(self, symbols: List[str]) -> List[str]:
        """Map out-of-vocab (or non-encodable-typed) symbols to byte pieces
        (byte_fallback) or <unk>. Only NORMAL/USER_DEFINED pieces may be
        emitted from text — a raw char whose surface happens to equal a
        CONTROL piece maps to <unk>, matching real sentencepiece."""
        out: List[str] = []
        for s in symbols:
            idx = self.v.piece_to_id_map.get(s)
            if idx is not None and self.v.types[idx] in (NORMAL, USER_DEFINED):
                out.append(s)
            elif self.v.byte_fallback:
                for b in s.encode("utf-8"):
                    out.append(f"<0x{b:02X}>")
            else:
                out.append(self.v.pieces[self.v.unk_id])
        return out

    # -- public API --------------------------------------------------------
    @staticmethod
    def _reject_kwargs(kwargs, where: str):
        """This class is a drop-in SUBSET of sentencepiece: kwargs it does
        not implement (add_bos/add_eos/enable_sampling/...) must fail loudly
        rather than silently return unmodified output."""
        if kwargs:
            raise TypeError(f"{where}: unsupported sentencepiece kwargs {sorted(kwargs)}")

    def EncodeAsPieces(self, text: str) -> List[str]:
        text = self._normalize(text)
        if self._native is not None:
            # hot path for long-text synthesis: the C++ merge engine, mapped
            # back to piece surfaces (identical semantics, test-pinned)
            return [self.v.pieces[i] for i in self._native.encode(text)]
        if self.v.model_type == 1:
            return self._encode_unigram(text)
        return self._encode_bpe(text)

    def EncodeAsIds(self, text: str) -> List[int]:
        if self._native is not None:
            return self._native.encode(self._normalize(text))
        return [self.PieceToId(p) for p in self.EncodeAsPieces(text)]

    def Encode(self, text, out_type=int, **kwargs):
        self._reject_kwargs(kwargs, "Encode")
        if isinstance(text, (list, tuple)):
            return [self.Encode(t, out_type=out_type) for t in text]
        if out_type is str:
            return self.EncodeAsPieces(text)
        return self.EncodeAsIds(text)

    def DecodePieces(self, pieces: Sequence[str]) -> str:
        out: List[str] = []
        byte_buf: List[int] = []

        def flush_bytes():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for p in pieces:
            idx = self.v.piece_to_id_map.get(p)
            if idx is not None and self.v.types[idx] == BYTE:
                byte_buf.append(int(p[3:5], 16))
                continue
            flush_bytes()
            if idx is not None and self.v.types[idx] in (CONTROL, UNKNOWN):
                if self.v.types[idx] == UNKNOWN:
                    out.append(" ⁇ ")  # sentencepiece unk surface
                continue
            out.append(p)
        flush_bytes()
        text = "".join(out).replace(WS, " ")
        # strip exactly the ONE dummy-prefix space the encoder inserted —
        # lstrip would also eat spaces that belong to the token content
        if self.v.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text

    def Decode(self, ids, out_type=str, **kwargs):
        self._reject_kwargs(kwargs, "Decode")
        if hasattr(ids, "tolist"):  # numpy array (engine code_rows are np.int32)
            ids = ids.tolist()
        if len(ids) and isinstance(ids[0], (list, tuple)) or (
            len(ids) and hasattr(ids[0], "tolist") and getattr(ids[0], "ndim", 0)
        ):
            return [self.Decode(i) for i in ids]
        pieces = [i if isinstance(i, str) else self.v.pieces[int(i)] for i in ids]
        return self.DecodePieces(pieces)


def build_vocab_from_pieces(
    pieces: Iterable[Union[str, Tuple[str, float]]],
    model_type: int = 2,
    add_dummy_prefix: bool = True,
    specials: Sequence[str] = ("<s>", "</s>", "<unk>"),
) -> SentencePieceVocab:
    """Construct a vocab programmatically (tests / offline tools). Specials are
    inserted first in the IndexTTS convention: bos=0, eos=1, unk=2."""
    all_pieces: List[str] = []
    all_scores: List[float] = []
    all_types: List[int] = []
    for s in specials:
        all_pieces.append(s)
        all_scores.append(0.0)
        all_types.append(UNKNOWN if s == "<unk>" else CONTROL)
    for i, p in enumerate(pieces):
        if isinstance(p, tuple):
            piece, score = p
        else:
            piece, score = p, -float(i)
        all_pieces.append(piece)
        all_scores.append(score)
        all_types.append(NORMAL)
    return SentencePieceVocab(
        pieces=all_pieces,
        scores=all_scores,
        types=all_types,
        model_type=model_type,
        add_dummy_prefix=add_dummy_prefix,
    )
