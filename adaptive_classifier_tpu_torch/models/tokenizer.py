"""Host-side WordPiece tokenizer.

Counterpart of ``adaptive_classifier_tpu/models/tokenizer.py``: BERT's
basic + WordPiece algorithm over a local checkpoint's ``vocab.txt`` or the
built-in offline vocabulary (``hermetic``), padded to sequence-length
buckets.  A batch's ASCII texts go through the C++ library under
``native/`` (``native.NativeWordPiece``, built at first use), the others
through the Python code here; the ids are the same either way.  Without a
C++ compiler every text takes the Python path.
"""

from __future__ import annotations

import json
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F)
    )


class WordPieceTokenizer:
    """BERT-style basic + WordPiece tokenizer over a ``vocab.txt`` vocabulary."""

    def __init__(
        self,
        vocab: Dict[str, int],
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        #: the C++ path (built lazily); it knows only the default specials
        #: and word limit
        self._native = None
        self._native_tried = (unk_token, cls_token, sep_token, max_input_chars_per_word) \
            != ("[UNK]", "[CLS]", "[SEP]", 100)

    def _get_native(self):
        """The ``NativeWordPiece`` of this vocabulary, or None where the
        library cannot be built."""
        if not self._native_tried:
            self._native_tried = True
            from .. import native

            if native.native_available():
                self._native = native.NativeWordPiece(self.vocab, self.do_lower_case)
        return self._native

    @classmethod
    def from_pretrained(cls, path: str) -> "WordPieceTokenizer":
        """Load ``vocab.txt`` (and ``do_lower_case`` from
        ``tokenizer_config.json``) from a local checkpoint directory."""
        p = Path(path)
        do_lower = True
        cfg_file = p / "tokenizer_config.json"
        if cfg_file.exists():
            try:
                cfg = json.loads(cfg_file.read_text())
                do_lower = bool(cfg.get("do_lower_case", True))
            except (json.JSONDecodeError, AttributeError):
                pass
        vocab_file = p / "vocab.txt"
        if vocab_file.exists():
            vocab = {}
            with open(vocab_file, encoding="utf-8") as f:
                for i, line in enumerate(f):
                    vocab[line.rstrip("\n")] = i
            return cls(vocab, do_lower_case=do_lower)
        raise FileNotFoundError(f"No vocab.txt in {path}")

    @classmethod
    def hermetic(cls, vocab_size: int = 8192) -> "WordPieceTokenizer":
        """Deterministic built-in vocabulary for fully offline operation,
        the JAX package's token for token.

        Covers the specials, all single printable-ASCII characters and their
        '##' continuations, and common English subwords; everything else
        falls back to character-level pieces, so any ASCII text tokenizes
        without [UNK] and identically across runs.
        """
        tokens: List[str] = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        chars = [chr(c) for c in range(33, 127)]
        tokens += [c for c in chars]
        tokens += [f"##{c}" for c in chars if c.isalnum()]
        common = (
            "the of and to in is was it for on as with be by at this that from "
            "are an or have has had not but they you his her she he we their its "
            "which will would there been one all can more if no so what when who "
            "out up about into them then some could these two may other do over "
            "such our him time years only most also new after first than where "
            "many must through before should well people down just state year "
            "good very make world still own see men work long here get both "
            "between life being under never day same another know while last "
            "might us great old off come since go against came right used take "
            "three himself few house use during without again place around "
            "however home small found mrs thought went say part once general "
            "high upon school every don does got united left number course war "
            "until always away something fact though water less public put "
            "think almost hand enough far took head yet government system "
            "better set told nothing night end why called didn eyes find going "
            "look asked later knew point next city business case week company "
            "system group problem service price order great product quality "
            "love hate terrible awful amazing wonderful excellent poor bad best "
            "worst happy sad angry positive negative neutral movie film book "
            "music food restaurant hotel travel sports game team player win "
            "lose technical support billing account password email urgent "
            "refund payment card credit bank money insurance legal medical "
            "doctor health news politics science technology computer software "
            "hardware phone mobile internet web site data model machine "
            "learning language question answer help please thanks thank sorry "
            "yes maybe sure issue error bug fix update version release test"
        ).split()
        seen = set(tokens)
        for w in common:
            for t in (w, f"##{w}"):
                if t not in seen:
                    seen.add(t)
                    tokens.append(t)
        # pad out with numbered filler tokens to reach vocab_size
        i = 0
        while len(tokens) < vocab_size:
            t = f"[unused{i}]"
            if t not in seen:
                tokens.append(t)
            i += 1
        vocab = {t: i for i, t in enumerate(tokens[:vocab_size])}
        return cls(vocab, do_lower_case=True)

    # ------------------------------------------------------------------
    # tokenization
    # ------------------------------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _basic_tokenize(self, text: str) -> List[str]:
        text = "".join(f" {ch} " if _is_cjk(ord(ch)) else ch
                       for ch in self._clean(text))
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = "".join(
                    c for c in unicodedata.normalize("NFD", tok)
                    if unicodedata.category(c) != "Mn"
                )
            cur: List[str] = []
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    def _wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        n = len(token)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self._basic_tokenize(text):
            out.extend(self._wordpiece(tok))
        return out

    def encode(self, text: str, max_length: int = 512) -> List[int]:
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = ids[: max_length - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def __call__(
        self,
        texts: Sequence[str],
        max_length: int = 512,
        pad_to_buckets: Optional[Sequence[int]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch-encode to padded int32 ``(input_ids, attention_mask)``,
        padded to the batch's longest row rounded up into a bucket.  ASCII
        texts are encoded by the C++ library in one call, the others here."""
        encoded: List[Optional[List[int]]] = [None] * len(texts)
        native = self._get_native() if max_length >= 2 else None
        if native is not None:
            rows = [i for i, t in enumerate(texts) if t.isascii()]
            if rows:
                ids, lens = native.encode_batch([texts[i] for i in rows], max_length)
                for j, i in enumerate(rows):
                    encoded[i] = ids[j, :lens[j]].tolist()
        for i, e in enumerate(encoded):
            if e is None:
                encoded[i] = self.encode(texts[i], max_length=max_length)
        return pad_batch(encoded, self.pad_id, max_length, pad_to_buckets)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


def pad_batch(encoded: Sequence[Sequence[int]], pad_id: int, max_length: int,
              pad_to_buckets: Optional[Sequence[int]] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Rows of token ids → padded int32 ``(input_ids, attention_mask)``: the
    longest row rounded up into the first bucket that holds it, at least 8
    and at most ``max(max_length, 8)`` tokens, as the JAX package's
    tokenizers pad."""
    longest = max(len(e) for e in encoded)
    for b in sorted(pad_to_buckets or ()):
        if longest <= b:
            longest = b
            break
    longest = min(max(longest, 8), max(max_length, 8))
    ids = np.full((len(encoded), longest), pad_id, dtype=np.int32)
    mask = np.zeros((len(encoded), longest), dtype=np.int32)
    for i, e in enumerate(encoded):
        e = e[:longest]
        ids[i, : len(e)] = e
        mask[i, : len(e)] = 1
    return ids, mask
