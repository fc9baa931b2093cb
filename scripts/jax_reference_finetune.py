"""The JAX package's figures for the encoder fine-tuning flows of
``chip_smoke.py`` (phases 15f and 15m), on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_reference_finetune.py

15f: ``AdaptiveClassifier("checkpoints/ac-base-v2")`` on the production
config (ridge head, lexical channel 32,768, fusion and λ fitted) takes
``data/intents.json``'s 140 train rows in one ``add_examples`` (rows in
the order of ``scripts/build_classifier_zoo.py``), answers the 200 test
rows of those classes, runs ``finetune_encoder()`` with its defaults (200
steps, batch 32, chunks of 50, lr 3e-5) and answers them again.  15m:
phase 13's multi-label classifier (topic x emotion pairs, two adds) before
and after ``finetune_encoder(steps=20, chunk_steps=10, batch=8)``.
Prints one JSON object.  The two frameworks draw their batches and views
differently, so the port's chip run holds its top-1 after fine-tuning to
this one less 0.05.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

PRODUCTION = {"lexical_dim": 32768, "head_type": "ridge", "fusion_weights": "auto",
              "ridge_lambda": "auto"}


def intents_rows(block: str):
    """(texts, labels) of data/intents.json: the train rows, or the test
    rows of the train classes."""
    intents = json.loads((REPO / "data" / "intents.json").read_text())
    if block == "train":
        rows = [(t, lbl) for lbl, ts in intents["train"].items() for t in ts]
    else:
        rows = [(t, lbl) for lbl in intents["train"] for t in intents["test"][lbl]]
    return [t for t, _ in rows], [lbl for _, lbl in rows]


def accuracy(preds, labels) -> float:
    return sum(p[0][0] == l for p, l in zip(preds, labels)) / len(labels)


def single_label() -> dict:
    from adaptive_classifier_tpu import AdaptiveClassifier

    clf = AdaptiveClassifier(str(REPO / "checkpoints" / "ac-base-v2"), config=dict(PRODUCTION))
    texts, labels = intents_rows("train")
    clf.add_examples(texts, labels)
    test_t, test_l = intents_rows("test")
    before = accuracy(clf.predict_batch(test_t, k=1), test_l)
    t0 = time.perf_counter()
    report = clf.finetune_encoder()
    seconds = time.perf_counter() - t0
    after = accuracy(clf.predict_batch(test_t, k=1), test_l)
    return {"train_rows": len(texts), "test_rows": len(test_t), "top1_before": before,
            "top1_after": after, "report": report, "finetune_s": seconds}


def multi_label() -> dict:
    from adaptive_classifier_tpu import MultiLabelAdaptiveClassifier
    from jax_reference_multilabel import paired_rows, scores

    clf = MultiLabelAdaptiveClassifier(str(REPO / "checkpoints" / "ac-base-v2"), config={})
    texts, labels = paired_rows("train")
    for part in (slice(0, None, 2), slice(1, None, 2)):
        clf.add_examples(texts[part], labels[part])
    test_t, test_l = paired_rows("test")

    def f1():
        return scores([[l for l, _ in clf.predict_multilabel(t)] for t in test_t], test_l)[0]

    before = f1()
    report = clf.finetune_encoder(steps=20, chunk_steps=10, batch=8)
    return {"micro_f1_before": before, "micro_f1_after": f1(), "report": report}


def main():
    print(json.dumps({"15f": single_label(), "15m": multi_label()}))


if __name__ == "__main__":
    main()
