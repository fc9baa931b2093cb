"""Byte-level BPE tokenizer (the GPT-2 family's algorithm).

Counterpart of ``adaptive_classifier_tpu/models/bpe.py``: GPT-2's
reversible byte-to-unicode map, a scanner equal to the GPT-2
pre-tokenization regex, and greedy merges by rank over a
``tokenizer.json``'s vocabulary and merges, so a byte-level BPE checkpoint
(RoBERTa's, ModernBERT's) tokenizes without the Rust ``tokenizers``
runtime.  Batches pad as the WordPiece tokenizer's do.

One deliberate difference from the JAX package's: the ``added_tokens`` of
the file (``<s>``, ``</s>``, ``<mask>``, ...) are split out of the text
before pre-tokenization and map to their own ids, as the Rust runtime does
(leftmost, longest first; ``lstrip`` / ``rstrip`` take the whitespace
beside them, ``single_word`` matches whole words only).  The JAX package
byte-encodes such text piece by piece.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .tokenizer import pad_batch


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte → unicode character map."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def gpt2_pretokenize(text: str) -> List[str]:
    """Scanner equal to the GPT-2 regex
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "'":
            c = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
            if c is not None:
                out.append(c)
                i += len(c)
                continue
        # " ?\p{L}+" / " ?\p{N}+" / " ?[^\s\p{L}\p{N}]+"
        j, prefix = i, ""
        if ch == " " and i + 1 < n and not text[i + 1].isspace():
            prefix, j = " ", i + 1
            ch = text[j]
        if not ch.isspace():
            if ch.isalpha():
                same = str.isalpha
            elif ch.isnumeric():
                same = str.isnumeric
            else:
                def same(c):
                    return not (c.isspace() or c.isalpha() or c.isnumeric())
            k = j
            while k < n and same(text[k]):
                k += 1
            out.append(prefix + text[j:k])
            i = k
            continue
        # whitespace runs: "\s+(?!\S)" leaves the last space to prefix the
        # next token; "\s+" takes a run at the end of the text
        k = i
        while k < n and text[k].isspace():
            k += 1
        if k < n and k - i > 1:
            out.append(text[i:k - 1])
            i = k - 1
        else:
            out.append(text[i:k])
            i = k
    return out


def _is_word_char(ch: str) -> bool:
    return ch.isalnum() or ch == "_"


class ByteLevelBPE:
    """Byte-level BPE over a ``tokenizer.json``'s vocabulary and merges,
    with the file's added tokens split out first."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 unk_token: Optional[str] = None, add_prefix_space: bool = False,
                 specials: Optional[Dict[str, int]] = None,
                 added_tokens: Sequence[dict] = ()):
        self.vocab = vocab
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_map = bytes_to_unicode()
        self.unk_id = vocab.get(unk_token) if unk_token else None
        self.add_prefix_space = add_prefix_space
        self.specials = specials or {}
        self.cls_id = self.specials.get("cls", 0)
        self.sep_id = self.specials.get("sep", 0)
        self.pad_id = self.specials.get("pad", 0)
        #: ``tokenizer.json`` ``added_tokens`` entries (content, id, lstrip,
        #: rstrip, single_word), longest first for leftmost-longest matching
        self.added = sorted(added_tokens, key=lambda t: -len(t["content"]))
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_tokenizer_json(cls, path: str) -> "ByteLevelBPE":
        """From a ``tokenizer.json`` file, or a directory holding one."""
        p = Path(path)
        if p.is_dir():
            p = p / "tokenizer.json"
        data = json.loads(p.read_text())
        model = data["model"]
        if model["type"] != "BPE":
            raise ValueError(f"{path}: a {model['type']} model, not BPE")
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        specials = {}
        for tok in data.get("added_tokens", []):
            low = tok["content"].strip("[]<>|").lower()
            for key, names in (("cls", ("cls", "s")), ("sep", ("sep", "/s")),
                               ("pad", ("pad",)), ("unk", ("unk",))):
                if low in names:
                    specials[key] = tok["id"]
        pre = data.get("pre_tokenizer") or {}
        bpe = cls(model["vocab"], merges, unk_token=model.get("unk_token"),
                  add_prefix_space=bool(pre.get("add_prefix_space", False)),
                  specials=specials, added_tokens=data.get("added_tokens", []))
        #: the file read, copied into an int8 export
        bpe.source = p
        return bpe

    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = list(token)
        while len(word) > 1:
            best = None      # (rank, position) of the lowest-ranked pair, leftmost
            for i in range(len(word) - 1):
                r = self.ranks.get((word[i], word[i + 1]))
                if r is not None and (best is None or r < best[0]):
                    best = (r, i)
            if best is None:
                break
            i = best[1]
            word = word[:i] + [word[i] + word[i + 1]] + word[i + 2:]
        self._cache[token] = word
        return word

    def _match_added(self, text: str, start: int) -> Optional[Tuple[int, int, int]]:
        """The leftmost added token at or after ``start``, the longest
        there → ``(begin, end, id)`` with its stripped whitespace, or None."""
        best = None
        for tok in self.added:
            content = tok["content"]
            at = text.find(content, start)
            while at >= 0:
                end = at + len(content)
                if not tok.get("single_word") or (
                        (at == 0 or not _is_word_char(text[at - 1]))
                        and (end == len(text) or not _is_word_char(text[end]))):
                    break
                at = text.find(content, at + 1)
            if at >= 0 and (best is None or at < best[0]):
                best = (at, at + len(content), tok)
        if best is None:
            return None
        at, end, tok = best
        if tok.get("lstrip"):
            while at > start and text[at - 1].isspace():
                at -= 1
        if tok.get("rstrip"):
            while end < len(text) and text[end].isspace():
                end += 1
        return at, end, tok["id"]

    def _encode_piece(self, text: str) -> List[int]:
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        ids: List[int] = []
        for piece in gpt2_pretokenize(text):
            mapped = "".join(self.byte_map[b] for b in piece.encode("utf-8"))
            for sub in self._bpe(mapped):
                i = self.vocab.get(sub)
                if i is not None:
                    ids.append(i)
                elif self.unk_id is not None:
                    ids.append(self.unk_id)
        return ids

    def encode_text(self, text: str) -> List[int]:
        """The text's token ids, no ``cls`` / ``sep`` frame."""
        ids: List[int] = []
        start = 0
        while start < len(text):
            m = self._match_added(text, start) if self.added else None
            if m is None:
                ids += self._encode_piece(text[start:])
                break
            at, end, tid = m
            if at > start:
                ids += self._encode_piece(text[start:at])
            ids.append(tid)
            start = end
        return ids

    def encode(self, text: str, max_length: int = 512) -> List[int]:
        body = self.encode_text(text)[: max_length - 2]
        return [self.cls_id] + body + [self.sep_id]

    @property
    def vocab_size(self) -> int:
        return max(len(self.vocab), max(self.specials.values(), default=0) + 1)

    def __call__(self, texts: Sequence[str], max_length: int = 512,
                 pad_to_buckets: Optional[Sequence[int]] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch-encode to padded int32 ``(input_ids, attention_mask)``."""
        return pad_batch([self.encode(t, max_length=max_length) for t in texts],
                         self.pad_id, max_length, pad_to_buckets)
