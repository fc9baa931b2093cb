"""The JAX package's figures for the continual-learning flows of
``chip_smoke.py`` (phases 6m and 6l), on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_reference_continual.py

6m: ``AdaptiveClassifier("checkpoints/ac-base-v2", config={})`` (the
default configuration: MLP head, ``fusion_weights: history``, no lexical
channel) takes the intents train rows, answers ``predict_batch(k=1)`` on
the ten classes' test rows, takes the three new classes, and answers
again.  6l: ``checkpoints/zoo/banking-intents`` loaded, the same test rows
before and after adding the new classes (a lossy replay store: the frozen
probe).  Prints one JSON object of top-1 accuracies and drops; the
port's chip run holds its own figures to these by the bands in
``chip_smoke.py``.  Shuffles, dropout and head init draw from
``jax.random`` here and from ``torch.Generator`` in the port, so the
figures are compared in bands, not for equality.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def rows(block):
    intents = json.loads((REPO / "data" / "intents.json").read_text())
    if block in ("train", "new_classes"):
        r = [(t, lbl) for lbl, ts in intents[block].items() for t in ts]
    else:
        src = "train" if block == "test_base" else "new_classes"
        r = [(t, lbl) for lbl in intents[src] for t in intents["test"][lbl]]
    return [t for t, _ in r], [lbl for _, lbl in r]


def accuracy(clf, block):
    texts, labels = rows(block)
    preds = clf.predict_batch(texts, k=1)
    return float(np.mean([bool(p) and p[0][0] == lbl for p, lbl in zip(preds, labels)]))


def grow(clf):
    before = accuracy(clf, "test_base")
    t0 = time.perf_counter()
    clf.add_examples(*rows("new_classes"))
    add_s = time.perf_counter() - t0
    after = accuracy(clf, "test_base")
    return {"top1_before": before, "top1_after": after, "drop": before - after,
            "relative_drop": (before - after) / before if before else None,
            "new_class_top1": accuracy(clf, "test_new"), "add_new_classes_s": add_s}


def main():
    from adaptive_classifier_tpu import AdaptiveClassifier

    clf = AdaptiveClassifier(str(REPO / "checkpoints" / "ac-base-v2"), config={})
    clf.add_examples(*rows("train"))
    default = grow(clf)
    zoo = AdaptiveClassifier.load(str(REPO / "checkpoints" / "zoo" / "banking-intents"))
    lossy = grow(zoo)
    lossy["skip_probe"] = "skip" in zoo.head_params
    print(json.dumps({"6m_default_config": default, "6l_lossy_zoo": lossy}))


if __name__ == "__main__":
    main()
