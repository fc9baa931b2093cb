"""Long-document classification: chunk-and-pool over the encoder window.

Counterpart of ``adaptive_classifier_tpu/document.py``.  The document is
tokenized once, un-truncated; its token stream is cut into overlapping
windows, each re-framed with ``[CLS]…[SEP]``, and all windows are embedded
in one padded encoder call (S the sequence bucket of ``chunk_tokens``, the
window count padded to 1, 8 or a multiple of 64).  Pools:

- ``mean``: token-count-weighted mean of the window embeddings,
  renormalized, then the classifier's fusion (``_predict_from_embedding``);
- ``max``: per-class max of the per-window fused distributions,
  renormalized;
- ``vote``: the per-window fused distributions averaged.

With the lexical channel on, the document's own lexical row is appended
to every window.  A window longer than the largest sequence bucket (512)
does not fit the encoder and raises ``ValueError``, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def window_ids(body: List[int], chunk_body: int, stride: int) -> List[List[int]]:
    """Windows of ``chunk_body`` ids advancing by ``stride``; the last
    window ends at the stream's end and keeps the full width."""
    if chunk_body <= 0 or stride <= 0:
        raise ValueError("chunk_body and stride must be positive")
    if len(body) <= chunk_body:
        return [list(body)]
    wins = []
    pos = 0
    while True:
        wins.append(list(body[pos:pos + chunk_body]))
        if pos + chunk_body >= len(body):
            break
        pos += stride
        if pos + chunk_body > len(body):
            pos = len(body) - chunk_body   # tail window, full width
    return wins


def _bucket_len(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def window_batch(clf, text: str, chunk_tokens: Optional[int] = None,
                 overlap: float = 0.25) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ ``(ids [Wp, S], mask [Wp, S], counts [W])`` host int32 / float32:
    the padded window batch of ``text`` and each window's token count."""
    tok = clf.encoder.tokenizer
    chunk_tokens = chunk_tokens or clf.config.max_length
    if not 0.0 <= overlap < 1.0:
        raise ValueError(f"overlap must be in [0, 1), got {overlap}")
    chunk_body = max(chunk_tokens - 2, 8)   # room for [CLS]/[SEP]
    stride = max(int(chunk_body * (1.0 - overlap)), 1)

    # encode once, un-truncated; strip the frame, re-frame per window
    body = tok.encode(text, max_length=1_000_000_000)[1:-1]
    wins = window_ids(body, chunk_body, stride)

    S = _bucket_len(chunk_body + 2, clf.encoder.SEQ_BUCKETS)
    W = len(wins)
    Wp = 1 if W == 1 else 8 if W <= 8 else ((W + 63) // 64) * 64
    ids = np.full((Wp, S), tok.pad_id, np.int32)
    mask = np.zeros((Wp, S), np.int32)
    for r, win in enumerate(wins):
        row = [tok.cls_id] + win + [tok.sep_id]
        if len(row) > S:
            raise ValueError(f"a window of {len(row)} tokens does not fit the largest "
                             f"sequence bucket ({S}): lower chunk_tokens")
        ids[r, :len(row)] = row
        mask[r, :len(row)] = 1
    counts = np.asarray([len(w) + 2 for w in wins], np.float32)
    return ids, mask, counts


def embed_document(clf, text: str, chunk_tokens: Optional[int] = None,
                   overlap: float = 0.25) -> Tuple[torch.Tensor, np.ndarray]:
    """→ (window embeddings ``[W, D]`` on the device, per-window token
    counts), from one encoder call."""
    ids, mask, counts = window_batch(clf, text, chunk_tokens, overlap)
    W = len(counts)
    with torch.inference_mode():
        emb = clf.encoder.embed_ids(ids, mask)[:W]
        if getattr(clf, "lexical", None) is not None:
            # the document's bag of n-grams is a whole-document feature:
            # every window carries the same lexical row
            lex = clf.lexical.transform([text])
            emb = clf._compose_channels(emb, np.repeat(lex, W, axis=0))
    return emb, counts


def predict_document(clf, text: str, k: int = 5, chunk_tokens: Optional[int] = None,
                     overlap: float = 0.25, pool: str = "mean") -> List[Tuple[str, float]]:
    """Classify a text longer than the encoder window (pools in the module
    docstring).  A document that fits one window is scored from that
    window's embedding."""
    if not text:
        raise ValueError("Empty document")
    if pool not in ("mean", "max", "vote"):
        raise ValueError(f"unknown pool {pool!r}")
    if len(clf.label_to_id) == 0:
        return []

    emb, counts = embed_document(clf, text, chunk_tokens, overlap)

    if pool in ("vote", "max"):
        probs_rows = _window_distributions(clf, emb)
        if pool == "vote":
            agg = probs_rows.mean(axis=0)
        else:
            agg = probs_rows.max(axis=0)
            total = agg.sum()
            if total > 0:
                agg = agg / total
        order = np.argsort(-agg)[:k]
        return [(clf.id_to_label[int(i)], float(agg[i]))
                for i in order if agg[i] > 0 and int(i) in clf.id_to_label]

    with torch.inference_mode():
        w = torch.from_numpy(counts).to(emb.device)[:, None]
        pooled = torch.sum(emb.float() * w, dim=0) / torch.sum(w)
        pooled = pooled / torch.clamp(torch.linalg.norm(pooled), min=1e-12)
    return clf._predict_from_embedding(pooled, k=k)


def _window_distributions(clf, emb: torch.Tensor) -> np.ndarray:
    """Full fused ``[W, C]`` distributions of the window embeddings with
    ``predict_proba``'s per-label weights.  As in the JAX package, no
    recalibration bias is applied here (the ``mean`` pool's fusion applies
    it)."""
    from .ops import fusion

    pw, hw = clf._history_weights()
    with torch.inference_mode():
        dist = fusion.fuse_dist_from_emb(
            emb, clf.memory.state.proto, clf.memory.state.valid,
            clf.head_params, clf._active_mask(), pw, hw,
            clf.head_params is not None,
            pallas_min_classes=clf.config.pallas_knn_min_classes)
        return dist.cpu().numpy()
