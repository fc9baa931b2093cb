"""Hashed TF-IDF lexical feature channel.

Counterpart of ``adaptive_classifier_tpu/lexical.py``.  A second channel
concatenated to the encoder embedding:

    full = [enc_norm, w * lex_norm] / sqrt(1 + w**2)        (unit norm)

``lex`` is a feature-hashed (FNV-1a, signed) bag of grams with sublinear TF
and smoothed IDF, L2-normalized.  The IDF table is fitted once and frozen,
so a loaded checkpoint rebuilds exactly the feature space its prototypes
live in.  Host-side numpy; the device sees only the dense ``[N, dim]`` block.

This slice carries what loading and predicting need (``load``,
``transform``, ``weight``) plus ``fit``; the gram-kind and weight sweep
(``resolve_config``) arrives with ``add_examples`` in a later slice.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

_WORD = re.compile(r"[a-z0-9']+")
_WS = re.compile(r"\s+")

#: gram kinds: word uni+bigrams, char 3-5-grams, both, typo-invariant
#: skeleton uni+bigrams, char+skeleton, all three
GRAM_KINDS = ("word", "char", "wordchar", "skel", "charskel",
              "wordcharskel")


def _skeleton(word: str) -> str:
    """First char + sorted middle + last char: invariant to in-word
    adjacent-character swaps."""
    if len(word) < 4:
        return word
    return word[0] + "".join(sorted(word[1:-1])) + word[-1]


def _fnv1a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _grams(text: str, kind: str = "word") -> List[str]:
    """The grams of ``text`` for one of GRAM_KINDS.

    Char grams run over the whitespace-normalized lowercase text with a
    leading/trailing space, so word boundaries are part of the alphabet.
    Skeleton grams are prefixed ``#`` so they never collide with plain
    words in the shared hash space.
    """
    out: List[str] = []
    if kind in ("word", "wordchar", "wordcharskel"):
        toks = _WORD.findall(text.lower())
        out += toks + [a + " " + b for a, b in zip(toks, toks[1:])]
    if kind in ("char", "wordchar", "charskel", "wordcharskel"):
        s = " " + _WS.sub(" ", text.lower()).strip() + " "
        out += [s[i:i + n] for n in (3, 4, 5)
                for i in range(len(s) - n + 1)]
    if kind in ("skel", "charskel", "wordcharskel"):
        sk = ["#" + _skeleton(t) for t in _WORD.findall(text.lower())]
        out += sk + [a + " " + b for a, b in zip(sk, sk[1:])]
    return out


class HashedTfidf:
    """Feature-hashed TF-IDF vectorizer with a freezable IDF table."""

    def __init__(self, dim: int = 8192, weight="auto", grams: str = "word"):
        if dim % 128 != 0:
            raise ValueError(f"lexical_dim must be a multiple of 128, got {dim}")
        if grams != "auto" and grams not in GRAM_KINDS:
            raise ValueError(f"lexical_grams must be 'auto' or one of "
                             f"{GRAM_KINDS}, got {grams!r}")
        self.dim = int(dim)
        #: "auto" until resolved; then a float (0.0 = channel off)
        self.weight = weight
        #: "auto" until resolved; then a GRAM_KINDS member
        self.grams = grams
        self._df: Dict[str, int] = {}
        self._n_docs = 0
        self._idf: Optional[Dict[str, float]] = None
        self._default_idf = 1.0

    @property
    def fitted(self) -> bool:
        return self._idf is not None

    @property
    def ready(self) -> bool:
        """Fitted with both gram kind and weight resolved to concrete values."""
        return (self.fitted and self.grams in GRAM_KINDS
                and not isinstance(self.weight, str))

    def _set_idf(self, df: Dict[str, int], n_docs: int):
        self._df = df
        self._n_docs = n_docs
        self._idf = {g: math.log((1 + n_docs) / (1 + d)) + 1.0
                     for g, d in df.items()}
        self._default_idf = math.log(1 + n_docs) + 1.0

    def fit(self, texts: Sequence[str]) -> "HashedTfidf":
        """Fit (and freeze) the IDF table on ``texts``."""
        if self.grams not in GRAM_KINDS:
            raise RuntimeError("HashedTfidf.fit needs a resolved gram kind, "
                               f"got {self.grams!r}")
        df: Dict[str, int] = {}
        for t in texts:
            for g in set(_grams(t, self.grams)):
                df[g] = df.get(g, 0) + 1
        self._set_idf(df, len(texts))
        return self

    def transform(self, texts: Sequence[str]) -> np.ndarray:
        """→ [N, dim] float32, rows L2-normalized (zero rows stay zero)."""
        if not self.fitted:
            raise RuntimeError("HashedTfidf.transform before fit")
        out = np.zeros((len(texts), self.dim), np.float32)
        idf, didf, dim = self._idf, self._default_idf, self.dim
        for i, t in enumerate(texts):
            cnt: Dict[str, int] = {}
            for g in _grams(t, self.grams):
                cnt[g] = cnt.get(g, 0) + 1
            row = out[i]
            for g, c in cnt.items():
                w = (1.0 + math.log(c)) * idf.get(g, didf)
                h = _fnv1a(g.encode())
                row[h % dim] += w if (h >> 63) & 1 else -w
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        np.divide(out, norms, out=out, where=norms > 0)
        return out

    # -- persistence ---------------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "dim": self.dim,
            "weight": self.weight,
            "grams": self.grams,
            "n_docs": self._n_docs,
            "df": self._df,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "HashedTfidf":
        # checkpoints written before gram-kind selection are word-gram
        obj = cls(dim=d["dim"], weight=d["weight"],
                  grams=d.get("grams", "word"))
        df = {str(k): int(v) for k, v in d.get("df", {}).items()}
        n_docs = int(d.get("n_docs", 0))
        obj._df, obj._n_docs = df, n_docs
        if n_docs or df:
            obj._set_idf(df, n_docs)
        return obj

    def save(self, path: Path):
        Path(path).write_text(json.dumps(self.to_dict()))

    @classmethod
    def load(cls, path: Path) -> "HashedTfidf":
        return cls.from_dict(json.loads(Path(path).read_text()))
