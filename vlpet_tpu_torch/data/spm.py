"""Pure-Python sentencepiece: .model (ModelProto) reader + unigram encoder.

The image has no `sentencepiece` C++ lib, but a T5 `spiece.model` is just a
serialized protobuf whose unigram vocabulary (piece, log-prob score) drives
a Viterbi segmentation — both are implementable in plain Python. This makes
the real-tokenizer path (reference: src/tokenization.py:8-126 VLT5Tokenizer)
work offline with zero native deps.

Scope: the unigram model type (what T5/mT5 ship). Wire-format parsing is
hand-rolled (the ModelProto schema is stable): ModelProto.pieces = field 1
(repeated SentencePiece{piece=1: string, score=2: float, type=3: enum}),
trainer_spec = field 2, normalizer_spec = field 4
(add_dummy_prefix=field 3 bool, remove_extra_whitespaces=field 4,
escape_whitespaces=field 5).

Normalization: NFKC + whitespace collapse + ▁-escaping — the practical core
of the `nmt_nfkc` scheme (the precompiled charsmap adds only exotic-codepoint
rewrites that QA/caption text never contains).

The port's own copy of vlpet_tpu/data/spm.py.
"""

from __future__ import annotations

import struct
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

WS = "▁"  # ▁

# SentencePiece.Type enum
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


# ---------------------------------------------------------------------------
# protobuf wire-format primitives
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


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yields (field_number, wire_type, value) over a message's fields."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fieldno, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fieldno, wt, val


def _write_varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(fieldno: int, wt: int, payload: bytes) -> bytes:
    return _write_varint((fieldno << 3) | wt) + payload


# ---------------------------------------------------------------------------
# model proto
# ---------------------------------------------------------------------------


@dataclass
class SpmModel:
    pieces: List[str] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    types: List[int] = field(default_factory=list)
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    piece_to_id: Dict[str, int] = field(default_factory=dict)
    unk_id: int = 0

    def __post_init__(self):
        if self.pieces and not self.piece_to_id:
            self._index()

    def _index(self):
        self.piece_to_id = {p: i for i, p in enumerate(self.pieces)}
        for i, t in enumerate(self.types):
            if t == UNKNOWN:
                self.unk_id = i
                break


def read_model(path_or_bytes) -> SpmModel:
    """Parse a sentencepiece .model file without the sentencepiece lib."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    m = SpmModel()
    for fieldno, wt, val in _iter_fields(data):
        if fieldno == 1 and wt == 2:  # SentencePiece
            piece, score, typ = "", 0.0, NORMAL
            for f2, wt2, v2 in _iter_fields(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3:
                    typ = v2
            m.pieces.append(piece)
            m.scores.append(score)
            m.types.append(typ)
        elif fieldno == 4 and wt == 2:  # NormalizerSpec
            for f2, wt2, v2 in _iter_fields(val):
                if f2 == 3:
                    m.add_dummy_prefix = bool(v2)
                elif f2 == 4:
                    m.remove_extra_whitespaces = bool(v2)
                elif f2 == 5:
                    m.escape_whitespaces = bool(v2)
    m._index()
    return m


def write_model(m: SpmModel) -> bytes:
    """Serialize an SpmModel back to .model bytes (fixture building)."""
    out = bytearray()
    for piece, score, typ in zip(m.pieces, m.scores, m.types):
        body = _field(1, 2, _write_varint(len(piece.encode())) + piece.encode())
        body += _field(2, 5, struct.pack("<f", score))
        if typ != NORMAL:
            body += _field(3, 0, _write_varint(typ))
        out += _field(1, 2, _write_varint(len(body)) + bytes(body))
    norm = _field(1, 2, _write_varint(len(b"nmt_nfkc")) + b"nmt_nfkc")
    norm += _field(3, 0, _write_varint(1 if m.add_dummy_prefix else 0))
    norm += _field(4, 0, _write_varint(1 if m.remove_extra_whitespaces else 0))
    norm += _field(5, 0, _write_varint(1 if m.escape_whitespaces else 0))
    out += _field(4, 2, _write_varint(len(norm)) + bytes(norm))
    return bytes(out)


# ---------------------------------------------------------------------------
# unigram Viterbi encoder
# ---------------------------------------------------------------------------


class SpmEncoder:
    """Viterbi segmentation over the unigram vocabulary (the algorithm of
    sentencepiece's unigram_model.cc Encode). Unknown characters map to the
    <unk> piece with the standard min_score - 10 penalty."""

    def __init__(self, model: SpmModel):
        self.m = model
        # character-trie of normal/user-defined pieces
        self.trie: dict = {}
        for i, (p, t) in enumerate(zip(model.pieces, model.types)):
            if t in (NORMAL, USER_DEFINED):
                node = self.trie
                for ch in p:
                    node = node.setdefault(ch, {})
                node[""] = i  # terminal -> piece id
        self.unk_penalty = (min(model.scores) if model.scores else 0.0) - 10.0

    def normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        if self.m.remove_extra_whitespaces:
            text = " ".join(text.split())
        else:
            text = text.replace("\t", " ").replace("\n", " ")
        if self.m.add_dummy_prefix:
            text = " " + text
        if self.m.escape_whitespaces:
            text = text.replace(" ", WS)
        return text

    def encode_as_ids(self, text: str) -> List[int]:
        s = self.normalize(text)
        n = len(s)
        if n == 0:
            return []
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)  # (start, id)
        best[0] = 0.0
        scores = self.m.scores
        for i in range(n):
            if best[i] == NEG:
                continue
            node = self.trie
            j = i
            matched = False
            while j < n:
                node = node.get(s[j])
                if node is None:
                    break
                j += 1
                pid = node.get("")
                if pid is not None:
                    matched = True
                    sc = best[i] + scores[pid]
                    if sc > best[j]:
                        best[j] = sc
                        back[j] = (i, pid)
            # unknown single char fallback (always available, as in spm)
            sc = best[i] + self.unk_penalty
            if sc > best[i + 1]:
                best[i + 1] = sc
                back[i + 1] = (i, self.m.unk_id)
        # backtrack
        ids: List[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            ids.append(pid)
            pos = start
        ids.reverse()
        # merge consecutive unks (spm emits one unk per unknown char; HF's
        # slow tokenizer does too — keep per-char unks)
        return ids

    def decode_ids(self, ids: List[int]) -> str:
        parts = []
        for i in ids:
            if 0 <= i < len(self.m.pieces):
                t = self.m.types[i]
                if t in (CONTROL, UNUSED):
                    continue
                if t == UNKNOWN:
                    parts.append(" ⁇ ")  # spm's unk surface
                    continue
                parts.append(self.m.pieces[i])
        text = "".join(parts)
        if self.m.escape_whitespaces:
            text = text.replace(WS, " ")
        return text.lstrip(" ") if self.m.add_dummy_prefix else text
