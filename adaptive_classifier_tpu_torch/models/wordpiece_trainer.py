"""WordPiece vocabulary trainer, standard library only.

A copy of ``adaptive_classifier_tpu/models/wordpiece_trainer.py`` (the
port imports nothing of the JAX package): it trains the ``vocab.txt``
that ``models/tokenizer.py`` runs, so building a new encoder
(``pretrain.py``) needs no third-party tokenizer.

Algorithm: the standard WordPiece objective — start from the character
alphabet (word-initial chars + "##"-continuations), repeatedly merge the
adjacent symbol pair maximizing the likelihood score
``count(ab) / (count(a) · count(b))`` until the vocab budget is reached.
(BPE merges the most *frequent* pair; WordPiece merges the pair whose merge
most increases corpus likelihood — that score is the only difference.)

Pair counts update incrementally via a pair → {word ids} index, so training
is O(merges × words-containing-pair), not O(merges × corpus).
"""

from __future__ import annotations

import re
import unicodedata
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]

_WORD = re.compile(r"[^\s]+")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_words(text: str, do_lower_case: bool = True) -> List[str]:
    """BERT basic tokenization: whitespace split, punctuation isolation,
    lowercase + accent stripping — mirrors models/tokenizer.py."""
    out: List[str] = []
    for tok in text.split():
        if do_lower_case:
            tok = tok.lower()
            tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                          if unicodedata.category(c) != "Mn")
        cur: List[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
    return out


def train_wordpiece_vocab(
    lines: Iterable[str],
    vocab_size: int,
    specials: Sequence[str] = tuple(SPECIALS),
    do_lower_case: bool = True,
    min_pair_count: int = 2,
    max_word_len: int = 32,
) -> List[str]:
    """→ ordered vocab list (specials first, then alphabet, then merges)."""
    # 1. word-type frequency table
    word_freq: Counter = Counter()
    for line in lines:
        for w in basic_words(line, do_lower_case):
            if len(w) <= max_word_len:
                word_freq[w] += 1

    # 2. each word type becomes a symbol sequence: first char, then ##chars
    words: List[Tuple[List[str], int]] = []
    sym_count: Counter = Counter()
    pair_count: Counter = Counter()
    pair_index: Dict[Tuple[str, str], set] = defaultdict(set)
    for w, f in word_freq.items():
        syms = [w[0]] + ["##" + c for c in w[1:]]
        wid = len(words)
        words.append((syms, f))
        for s in syms:
            sym_count[s] += f
        for a, b in zip(syms, syms[1:]):
            pair_count[(a, b)] += f
            pair_index[(a, b)].add(wid)

    vocab: List[str] = list(specials)
    seen = set(vocab)
    for s in sorted(sym_count):
        if s not in seen:
            vocab.append(s)
            seen.add(s)

    # symbol → pairs containing it (for score invalidation when a symbol's
    # count — a score denominator — changes)
    sym2pairs: Dict[str, set] = defaultdict(set)
    for p in pair_count:
        sym2pairs[p[0]].add(p)
        sym2pairs[p[1]].add(p)

    import heapq

    def score_of(p) -> float:
        c = pair_count.get(p, 0)
        if c < min_pair_count:
            return 0.0
        return c / (sym_count[p[0]] * sym_count[p[1]])

    # lazy max-heap: entries carry the score at push time; on pop, stale
    # entries (score changed since) are re-pushed with the fresh score
    heap = [(-score_of(p), p) for p in pair_count]
    heapq.heapify(heap)

    # 3. merge loop: maximize count(ab) / (count(a)*count(b))
    while len(vocab) < vocab_size and heap:
        neg, best = heapq.heappop(heap)
        cur = score_of(best)
        if cur <= 0.0:
            continue
        if -neg > cur + 1e-18:      # stale (score dropped) → re-queue
            heapq.heappush(heap, (-cur, best))
            continue
        a, b = best
        merged = a + b[2:] if b.startswith("##") else a + b
        if merged not in seen:
            vocab.append(merged)
            seen.add(merged)

        touched: set = set()

        # 4. rewrite every word containing the pair; update counts locally
        for wid in list(pair_index[best]):
            syms, f = words[wid]
            i = 0
            new_syms: List[str] = []
            while i < len(syms):
                if i + 1 < len(syms) and syms[i] == a and syms[i + 1] == b:
                    new_syms.append(merged)
                    i += 2
                else:
                    new_syms.append(syms[i])
                    i += 1
            if len(new_syms) == len(syms):
                continue
            for s in syms:
                sym_count[s] -= f
            for p in zip(syms, syms[1:]):
                pair_count[p] -= f
                if pair_count[p] <= 0:
                    pair_count.pop(p, None)
                pair_index[p].discard(wid)
                touched.add(p)
            words[wid] = (new_syms, f)
            for s in new_syms:
                sym_count[s] += f
            for p in zip(new_syms, new_syms[1:]):
                pair_count[p] += f
                pair_index[p].add(wid)
                sym2pairs[p[0]].add(p)
                sym2pairs[p[1]].add(p)
                touched.add(p)
        pair_count.pop(best, None)
        pair_index.pop(best, None)
        # denominators of every pair sharing a changed symbol moved too
        for s in (a, b, merged):
            touched |= sym2pairs.get(s, set())
        touched.discard(best)
        for p in touched:
            sc = score_of(p)
            if sc > 0.0:
                heapq.heappush(heap, (-sc, p))

    return vocab[:vocab_size]
