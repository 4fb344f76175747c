"""CLIP text tokenizer: byte-level BPE with word-end markers, pure Python;
the port's copy of vlpet_tpu/vision/clip_tokenizer.py (the port imports
nothing of the JAX package).

Completes the CLIP port (reference: src/clip/simple_tokenizer.py + the
``tokenize`` entry in src/clip/clip.py:164-185 — note the reference deletes
the text tower from the vision encoder it actually uses, so this exists for
standalone CLIP parity, e.g. text-driven retrieval heads).

The merges table is loaded at runtime from a user-provided
``bpe_simple_vocab_16e6.txt.gz`` (or any plain/gzip merges file with a
header line) — the same offline-first pattern as the sentencepiece reader
(data/spm.py). The byte↔unicode table and the token-split regex are the
published spec; they must match exactly to reproduce ids.

ftfy is optional; when it is missing, the mojibake-fixing step
degrades to a no-op (affects only malformed input text).
"""

from __future__ import annotations

import gzip
import html
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

try:
    import regex as _re  # \p{L}/\p{N} unicode classes
except ImportError:  # pragma: no cover
    _re = None

try:
    import ftfy as _ftfy
except ImportError:
    _ftfy = None

SOT, EOT = "<|startoftext|>", "<|endoftext|>"

_WORD_PAT = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
             r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+")


@lru_cache()
def byte_unicode_table() -> Dict[int, str]:
    """GPT-2 style reversible byte→unicode mapping: printable ranges map to
    themselves, the rest to 256+n — BPE then operates on visible chars."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table = {}
    n = 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + n)
            n += 1
    return table


def _clean(text: str) -> str:
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip()


class ClipBPETokenizer:
    """Byte-level BPE with ``</w>`` word-end markers (CLIP vocabulary
    layout: 256 bytes + 256 byte+</w> + merges + 2 specials = 49408)."""

    def __init__(self, bpe_path: str):
        assert _re is not None, "the 'regex' package is required"
        self.byte_encoder = byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rb") as f:
            lines = f.read().decode("utf-8").split("\n")
        # line 0 is a version header; CLIP uses the first 49152-256-2 merges
        merges: List[Tuple[str, str]] = []
        for line in lines[1:49152 - 256 - 2 + 1]:
            parts = line.split()
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
        base = list(self.byte_encoder.values())
        vocab = base + [c + "</w>" for c in base] + \
            ["".join(m) for m in merges] + [SOT, EOT]
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.rank: Dict[Tuple[str, str], int] = {m: i for i, m in
                                                 enumerate(merges)}
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]
        self._pat = _re.compile(_WORD_PAT, _re.IGNORECASE)
        self._cache: Dict[str, List[str]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _merge_word(self, token: str) -> List[str]:
        """Greedy lowest-rank pair merging over one pre-token."""
        if token in self._cache:
            return self._cache[token]
        pieces: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(pieces) > 1:
            pairs = [(self.rank.get((a, b), None), i)
                     for i, (a, b) in enumerate(zip(pieces, pieces[1:]))]
            ranked = [(r, i) for r, i in pairs if r is not None]
            if not ranked:
                break
            best_rank = min(r for r, _ in ranked)
            out: List[str] = []
            i = 0
            while i < len(pieces):
                if (i + 1 < len(pieces)
                        and self.rank.get((pieces[i], pieces[i + 1]))
                        == best_rank):
                    out.append(pieces[i] + pieces[i + 1])
                    i += 2
                else:
                    out.append(pieces[i])
                    i += 1
            pieces = out
        self._cache[token] = pieces
        return pieces

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in self._pat.findall(_clean(text).lower()):
            if tok == SOT:
                ids.append(self.sot_id)
                continue
            if tok == EOT:
                ids.append(self.eot_id)
                continue
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._merge_word(mapped))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids
                       if int(i) not in (self.sot_id, self.eot_id))
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ") \
            .strip()

    def __call__(self, texts: Union[str, List[str]],
                 context_length: int = 77, truncate: bool = False
                 ) -> np.ndarray:
        """CLIP's ``tokenize``: (N, context_length) int32 with
        <|startoftext|> ... <|endoftext|> and zero padding
        (reference: clip/clip.py:164-185)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for r, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:
                if not truncate:
                    raise RuntimeError(
                        f"input too long for context {context_length}: "
                        f"{text!r}")
                ids = ids[:context_length - 1] + [self.eot_id]
            out[r, :len(ids)] = ids
        return out
