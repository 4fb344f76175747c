"""Tokenization.

Reference: src/tokenization.py (VLT5Tokenizer = T5 sentencepiece + 100
<vis_extra_id_*> tokens) and src/multitask.py:59-67 (BART gets the same
tokens via add_special_tokens at runtime + resize_token_embeddings).

Offline-first: tokenizers load from a LOCAL HF directory (no hub). When no
vocab files exist (e.g. CI), WhitespaceTokenizer provides the same interface
so the full pipeline stays testable.

The port's own copy of vlpet_tpu/data/tokenization.py.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

VIS_EXTRA_IDS = 100


def vis_extra_tokens(n: int = VIS_EXTRA_IDS) -> List[str]:
    return [f"<vis_extra_id_{i}>" for i in range(n)]


class WhitespaceTokenizer:
    """Minimal offline tokenizer with the HF call surface the pipeline uses:
    encode / __call__ / batch_decode / decode / pad_token_id / vocab_size.
    Deterministic hashing vocabulary — NOT for real training, only for
    plumbing tests and synthetic runs."""

    def __init__(self, vocab_size: int = 50265, pad_token_id: int = 1,
                 eos_token_id: int = 2, bos_token_id: int = 0):
        self.vocab_size = vocab_size
        self.pad_token_id = pad_token_id
        self.eos_token_id = eos_token_id
        self.bos_token_id = bos_token_id
        self._special = {pad_token_id, eos_token_id, bos_token_id}
        self._cache: dict[int, str] = {}

    def _tok2id(self, tok: str) -> int:
        h = 5 + (hash(tok) % (self.vocab_size - 10))
        while h in self._special:
            h += 1
        self._cache[h] = tok
        return h

    def encode(self, text: str, max_length: Optional[int] = None,
               truncation: bool = False, add_special_tokens: bool = True,
               **kw) -> List[int]:
        ids = [self._tok2id(t) for t in text.strip().split()]
        if add_special_tokens:
            ids = ids + [self.eos_token_id]
        if truncation and max_length is not None:
            ids = ids[:max_length]
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True, **kw):
        class R:
            pass

        r = R()
        r.input_ids = self.encode(text, add_special_tokens=add_special_tokens)
        return r

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self._special:
                continue
            toks.append(self._cache.get(i, f"<{i}>"))
        return " ".join(toks)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        return [self._tok2id(t) for t in tokens]


class VLT5Tokenizer:
    """T5 sentencepiece tokenizer + <extra_id_*> + <vis_extra_id_*>, running
    on the pure-Python SPM engine (data/spm.py) — no sentencepiece lib.

    Id layout mirrors the reference exactly (src/tokenization.py:60-97):
      vocab_size = sp_size + extra_ids + vis_extra_ids
      <extra_id_n>     -> vocab_size - n - 1 - vis_extra_ids
      <vis_extra_id_n> -> vocab_size - n - 1
    """

    SPECIAL_RE = re.compile(r"(<extra_id_\d+>|<vis_extra_id_\d+>)")

    def __init__(self, vocab_file, extra_ids: int = 100,
                 vis_extra_ids: int = VIS_EXTRA_IDS):
        from vlpet_tpu_torch.data.spm import SpmEncoder, read_model

        self.model = read_model(vocab_file)
        self.sp = SpmEncoder(self.model)
        self._extra_ids = extra_ids
        self._vis_extra_ids = vis_extra_ids
        ids = {p: i for i, p in enumerate(self.model.pieces)}
        self.pad_token_id = ids.get("<pad>", 0)
        self.eos_token_id = ids.get("</s>", 1)
        self.unk_token_id = ids.get("<unk>", self.model.unk_id)
        self.bos_token_id = self.pad_token_id  # T5 has no bos; start = pad
        self.pad_token, self.eos_token, self.unk_token = "<pad>", "</s>", "<unk>"
        self.sp_size = len(self.model.pieces)
        self._special_ids = {self.pad_token_id, self.eos_token_id}

    @property
    def vocab_size(self) -> int:
        return self.sp_size + self._extra_ids + self._vis_extra_ids

    def __len__(self) -> int:
        return self.vocab_size

    def _convert_token_to_id(self, token: str) -> int:
        m = re.match(r"<extra_id_(\d+)>", token)
        if m:
            return self.vocab_size - int(m.group(1)) - 1 - self._vis_extra_ids
        m = re.match(r"<vis_extra_id_(\d+)>", token)
        if m:
            return self.vocab_size - int(m.group(1)) - 1
        return self.model.piece_to_id.get(token, self.unk_token_id)

    def _convert_id_to_token(self, index: int) -> str:
        if index < self.sp_size:
            return self.model.pieces[index]
        if index > self.sp_size + self._extra_ids - 1:
            return f"<vis_extra_id_{self.vocab_size - 1 - index}>"
        return f"<extra_id_{self.vocab_size - self._vis_extra_ids - 1 - index}>"

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        if isinstance(tokens, str):
            return self._convert_token_to_id(tokens)
        return [self._convert_token_to_id(t) for t in tokens]

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for part in self.SPECIAL_RE.split(text):
            if not part:
                continue
            if self.SPECIAL_RE.fullmatch(part):
                out.append(part)
            else:
                out.extend(self.model.pieces[i]
                           for i in self.sp.encode_as_ids(part))
        return out

    def encode(self, text: str, max_length: Optional[int] = None,
               truncation: bool = False, add_special_tokens: bool = True,
               **kw) -> List[int]:
        ids: List[int] = []
        for part in self.SPECIAL_RE.split(text):
            if not part:
                continue
            if self.SPECIAL_RE.fullmatch(part):
                ids.append(self._convert_token_to_id(part))
            else:
                ids.extend(self.sp.encode_as_ids(part))
        if add_special_tokens:
            ids = ids + [self.eos_token_id]
        if truncation and max_length is not None:
            ids = ids[:max_length]
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True, **kw):
        class R:
            pass

        r = R()
        r.input_ids = self.encode(text, add_special_tokens=add_special_tokens,
                                  **kw)
        return r

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        parts: List[str] = []
        plain: List[int] = []

        def flush():
            if plain:
                parts.append(self.sp.decode_ids(plain))
                plain.clear()

        for i in ids:
            i = int(i)
            if i < 0:
                continue
            if i in self._special_ids:
                if not skip_special_tokens:
                    flush()
                    parts.append(self._convert_id_to_token(i))
                continue
            if i >= self.sp_size:
                flush()
                parts.append(self._convert_id_to_token(i))
            else:
                plain.append(i)
        flush()
        return " ".join(p for p in parts if p).strip()

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]


def get_tokenizer(backbone: str, local_path: Optional[str] = None,
                  do_lower_case: bool = False, use_vis_order_embedding: bool = True):
    """Build the task tokenizer.

    * t5 backbones → VLT5Tokenizer (pure-Python sentencepiece + 100
      <vis_extra_id_*>; reference: tokenization.py:8-97). local_path may be
      a spiece.model file or a directory containing one.
    * bart backbones → HF BART tokenizer (byte-level BPE via the tokenizers
      lib — no sentencepiece needed) + the same tokens added as specials
      (reference: multitask.py:59-67)
    * no local vocab available → WhitespaceTokenizer fallback.

    Returns (tokenizer, num_added_tokens).
    """
    if local_path is None:
        return WhitespaceTokenizer(), 0
    import os

    if "t5" in backbone:
        model_file = local_path
        if os.path.isdir(local_path):
            model_file = os.path.join(local_path, "spiece.model")
        if os.path.exists(model_file) and model_file.endswith(".model"):
            tok = VLT5Tokenizer(model_file)
            return tok, VIS_EXTRA_IDS
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(local_path, local_files_only=True)
        added = tok.add_special_tokens(
            {"additional_special_tokens": vis_extra_tokens()})
        return tok, added
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(local_path, local_files_only=True)
    added = 0
    if "bart" in backbone and use_vis_order_embedding:
        extra = [f"<extra_id_{i}>" for i in range(99, -1, -1)] + \
                [f"<vis_extra_id_{i}>" for i in range(99, -1, -1)]
        added = tok.add_special_tokens({"additional_special_tokens": extra})
    return tok, added


def effective_vocab_size(tok, added: int = 0) -> int:
    """Embedding rows the model needs for this tokenizer — the reference's
    resize_token_embeddings after add_special_tokens (multitask.py:59-67).
    ``len(tok)`` includes added specials for both HF tokenizers and
    VLT5Tokenizer; tokenizers without __len__ report vocab_size + added.
    The CLI entries MUST pass this to build_model_config: a backbone-default
    vocab smaller than the tokenizer's silently clamps out-of-range ids in
    the embedding gather and corrupts the CE loss (t5-base default 32100 vs
    the fallback tokenizer's 50265 produced nan train losses)."""
    try:
        return len(tok)
    except TypeError:
        return int(tok.vocab_size) + int(added)
