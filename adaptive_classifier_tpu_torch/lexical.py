"""Hashed TF-IDF lexical feature channel.

Counterpart of ``adaptive_classifier_tpu/lexical.py``.  A second channel
concatenated to the encoder embedding:

    full = [enc_norm, w * lex_norm] / sqrt(1 + w**2)        (unit norm)

``lex`` is a feature-hashed (FNV-1a, signed) bag of grams with sublinear TF
and smoothed IDF, L2-normalized.  The IDF table is fitted once and frozen,
so a loaded checkpoint rebuilds exactly the feature space its prototypes
live in.  Host-side numpy; the device sees only the dense ``[N, dim]`` block.

The first ``add_examples`` batch resolves ``grams="auto"`` and
``weight="auto"`` by a 2-fold ridge-probe balanced accuracy on an
alternating per-class split of that batch (``resolve_config``), then fits
and freezes the IDF table.  The probe is closed-form numpy, the same
arithmetic as the JAX package's, so both packages resolve the same knobs.
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

#: default sweep grid for weight="auto" (0 = lexical off for this task)
AUTO_WEIGHT_GRID = (0.0, 0.5, 1.0, 2.0, 4.0)

#: gram kinds, cheapest transform first (the tie preference): word uni+bigrams, char 3-5-grams, both, typo-invariant
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


def _fold_machinery(labels: Sequence[int], seed: Optional[int] = None):
    """Per-class 2-fold split + ridge-probe fold scorer → (half_a, half_b,
    fold_acc).  ``seed=None`` is the deterministic alternating-occurrence
    split; an integer seed shuffles the within-class fold assignment."""
    y = np.asarray(labels)
    order = np.zeros(len(y), np.int64)
    seen: Dict[int, int] = {}
    for i, c in enumerate(y):
        order[i] = seen.get(int(c), 0)
        seen[int(c)] = int(order[i]) + 1
    if seed is not None:
        rng = np.random.default_rng(seed)
        for c in seen:
            idx = np.flatnonzero(y == c)
            order[idx] = rng.permutation(len(idx))
    counts = np.asarray([seen[int(c)] for c in y])
    half_b = (order % 2 == 1) | (counts <= 1)
    half_a = (order % 2 == 0)
    classes = np.asarray(sorted(set(int(c) for c in y)))

    # cap the kernel solve for very large first batches (a fold can exceed
    # the cap while the batch has < 4096 rows: half_b also holds every
    # singleton-class row)
    if (int(half_a.sum()) > 2048 or int(half_b.sum()) > 2048) and len(y) > 4096:
        keep = np.zeros(len(y), bool)
        rng = np.random.default_rng(0)
        keep[rng.choice(len(y), size=4096, replace=False)] = True
        half_a = half_a & keep
        half_b = half_b & keep

    cls_idx = np.searchsorted(classes, y)
    eye = np.eye(len(classes), dtype=np.float32)

    def fold_acc(f, fit, val):
        F = f[fit].astype(np.float32)
        if F.shape[0] == 0 or not val.any():
            return 0.0
        K = F @ F.T
        alpha = np.linalg.solve(
            K + np.eye(K.shape[0], dtype=np.float32), eye[cls_idx[fit]])
        pred = classes[((f[val].astype(np.float32) @ F.T) @ alpha).argmax(1)]
        accs = [float((pred[y[val] == c] == c).mean())
                for c in classes if (y[val] == c).any()]
        return float(np.mean(accs)) if accs else 0.0

    return half_a, half_b, fold_acc


#: fold-split seeds averaged by the probe (None = the alternating split)
PROBE_SPLITS = (None, 1, 2)


def _cv_acc(enc: np.ndarray, lex: np.ndarray, labels: Sequence[int],
            w: float) -> float:
    """2-fold ridge-probe balanced accuracy of the composed features,
    averaged over PROBE_SPLITS."""
    f = np.concatenate([enc, w * lex], axis=1) / math.sqrt(1 + w * w)
    scores = []
    for s in PROBE_SPLITS:
        half_a, half_b, fold_acc = _fold_machinery(labels, seed=s)
        scores.append(0.5 * (fold_acc(f, half_a, half_b)
                             + fold_acc(f, half_b, half_a)))
    return float(np.mean(scores))


def _sweep_weights(enc: np.ndarray, lex: np.ndarray, labels: Sequence[int],
                   grid: Sequence[float]) -> tuple:
    """Best (weight, cv_acc) over the grid; ties prefer the weight nearest
    1.0 (log distance)."""
    folds = [_fold_machinery(labels, seed=s) for s in PROBE_SPLITS]
    pref = sorted(grid, key=lambda w: abs(math.log((w or 1e-3) / 1.0)))
    best_w, best_acc = pref[0], -1.0
    for w in pref:
        f = np.concatenate([enc, w * lex], axis=1) / math.sqrt(1 + w * w)
        acc = float(np.mean([
            0.5 * (fold_acc(f, half_a, half_b) + fold_acc(f, half_b, half_a))
            for half_a, half_b, fold_acc in folds]))
        if acc > best_acc + 1e-9:
            best_w, best_acc = float(w), acc
    return best_w, best_acc


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

    # -- channel composition and the auto sweep ------------------------------
    def compose(self, enc: np.ndarray, lex: np.ndarray) -> np.ndarray:
        """``[enc, w*lex] / sqrt(1+w²)`` — unit-norm concatenation of
        L2-normalized rows; requires a resolved weight."""
        w = float(self.weight)
        scale = 1.0 / math.sqrt(1.0 + w * w)
        return np.concatenate(
            [enc * scale, lex * (w * scale)], axis=1).astype(np.float32)

    def resolve_weight(self, enc: np.ndarray, lex: np.ndarray,
                       labels: Sequence[int],
                       grid: Sequence[float] = AUTO_WEIGHT_GRID) -> float:
        """Resolve ``weight="auto"`` by the ridge-probe sweep over ``grid``
        (ties prefer the weight nearest 1.0); a fixed weight is returned."""
        if not isinstance(self.weight, str):
            return float(self.weight)
        best_w, _ = _sweep_weights(enc, lex, labels, grid)
        self.weight = best_w
        return best_w

    def resolve_config(self, enc: np.ndarray, texts: Sequence[str],
                       labels: Sequence[int],
                       grid: Sequence[float] = AUTO_WEIGHT_GRID,
                       typo_views=None) -> None:
        """Resolve ``grams="auto"`` and/or ``weight="auto"`` on the first
        batch, then fit (and freeze) the IDF table under the winning kind.

        Gram kind × weight by the 2-fold ridge-probe balanced accuracy; gram
        ties prefer the earlier GRAM_KINDS entry.  ``typo_views=(enc_typo,
        texts_typo)`` breaks ties among kinds within 0.3pp of the best by
        their accuracy with the val fold's features replaced by the typo'd
        views."""
        kinds = GRAM_KINDS if self.grams == "auto" else (self.grams,)
        scored = []  # (acc, order, kind, weight, probe, lex)
        for order, kind in enumerate(kinds):
            probe = HashedTfidf(self.dim, weight="auto", grams=kind)
            probe.fit(texts)
            lex = probe.transform(texts)
            if isinstance(self.weight, str):
                w, acc = _sweep_weights(enc, lex, labels, grid)
            else:
                w = float(self.weight)
                acc = _cv_acc(enc, lex, labels, w)
            scored.append((acc, order, kind, w, probe, lex))
        best_acc = max(s[0] for s in scored)
        cands = [s for s in scored if s[0] >= best_acc - 0.003]
        if typo_views is not None and len(cands) > 1:
            enc_t, texts_t = typo_views
            ranked = []
            for acc, order, kind, w, probe, lex in cands:
                lex_t = probe.transform(list(texts_t))
                sc = 1.0 / math.sqrt(1 + w * w)
                f_c = np.concatenate([enc * sc, (w * sc) * lex], axis=1)
                f_t = np.concatenate([enc_t * sc, (w * sc) * lex_t], axis=1)
                taccs = []
                for seed in PROBE_SPLITS:
                    half_a, half_b, fold_acc = _fold_machinery(labels, seed)
                    for fit_m, val_m in ((half_a, half_b), (half_b, half_a)):
                        mix = np.where(val_m[:, None], f_t, f_c)
                        taccs.append(fold_acc(mix, fit_m, val_m))
                ranked.append((float(np.mean(taccs)), -order, kind, w))
            _, _, best_kind, best_w = max(ranked)
            self.grams, self.weight = best_kind, best_w
        else:
            _, _, self.grams, self.weight = max(
                (acc, -order, kind, w) for acc, order, kind, w, _, _ in scored)
        if not self.fitted:  # never refit a frozen IDF table
            self.fit(texts)

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
