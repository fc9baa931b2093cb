"""The JAX package's figures for the long-document flow of
``chip_smoke.py`` (phase 12), on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_reference_document.py

``checkpoints/zoo/topic`` loaded; 20 documents of 10 test rows of one class
each, scored by ``predict_document(chunk_tokens=64)`` in the ``mean``,
``max`` and ``vote`` pools, and one long document (the 50 test rows of the
first class, then 10 of its train rows; more than 512 tokens) scored at the
default 512-token window in each pool.  Prints one JSON object of the
top-1 accuracy over the 21 documents per pool; the port's chip run holds
its own figures to these less 0.05.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
POOLS = ("mean", "max", "vote")


def topic_documents():
    """→ [(text, label, chunk_tokens)]: the 20 short documents at 64-token
    windows, then the long one at the default window (None)."""
    data = json.loads((REPO / "data" / "topic.json").read_text())
    docs = []
    for label, rows in data["test"].items():
        for s in range(0, len(rows), 10):
            docs.append((". ".join(rows[s:s + 10]), label, 64))
    first = next(iter(data["test"]))
    long_rows = data["test"][first] + data["train"][first][:10]
    docs.append((". ".join(long_rows), first, None))
    return docs


def main():
    from adaptive_classifier_tpu import AdaptiveClassifier

    clf = AdaptiveClassifier.load(str(REPO / "checkpoints" / "zoo" / "topic"))
    docs = topic_documents()
    out = {"documents": len(docs),
           "long_document_tokens": len(clf.encoder.tokenizer.encode(
               docs[-1][0], max_length=1_000_000_000))}
    for pool in POOLS:
        hits = [bool(p) and p[0][0] == label for p, label in (
            (clf.predict_document(text, k=1, chunk_tokens=ct, pool=pool), label)
            for text, label, ct in docs)]
        out[f"top1_{pool}"] = sum(hits) / len(hits)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
