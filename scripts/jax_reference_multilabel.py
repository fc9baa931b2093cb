"""The JAX package's figures for the multi-label flow of ``chip_smoke.py``
(phase 13), on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_reference_multilabel.py

Each ``data/topic.json`` row is paired with the ``data/emotions.json`` row
of the same index and split (198 train pairs, 200 test pairs); a pair's
text is ``topic + " " + emotion`` and its labels ``{topic, emotion}``, 8
labels in all.  ``MultiLabelAdaptiveClassifier("checkpoints/ac-base-v2",
config={})`` takes the even train pairs, then the odd ones (each add refits
the multi-hot BCE head), and ``predict_multilabel`` answers every test
pair.  Prints one JSON object: micro-F1 and exact-set accuracy.  Head init,
shuffles and dropout draw differently in the two frameworks, so the port's
chip run holds its micro-F1 to this one less 0.05.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def paired_rows(split: str):
    """→ (texts, label lists) of the topic x emotion pairs of ``split``."""
    topic = json.loads((REPO / "data" / "topic.json").read_text())[split]
    emotions = json.loads((REPO / "data" / "emotions.json").read_text())[split]
    t_rows = [(t, lbl) for lbl, ts in topic.items() for t in ts]
    e_rows = [(t, lbl) for lbl, ts in emotions.items() for t in ts]
    pairs = list(zip(t_rows, e_rows))
    return ([f"{a} {b}" for (a, _), (b, _) in pairs],
            [[la, lb] for (_, la), (_, lb) in pairs])


def scores(predicted, truth):
    """→ (micro-F1, exact-set accuracy) of label sets."""
    tp = fp = fn = exact = 0
    for p, t in zip(predicted, truth):
        p, t = set(p), set(t)
        tp += len(p & t)
        fp += len(p - t)
        fn += len(t - p)
        exact += p == t
    return 2 * tp / max(2 * tp + fp + fn, 1), exact / len(truth)


def main():
    from adaptive_classifier_tpu import MultiLabelAdaptiveClassifier

    clf = MultiLabelAdaptiveClassifier(str(REPO / "checkpoints" / "ac-base-v2"), config={})
    texts, labels = paired_rows("train")
    add_s = []
    for part in (slice(0, None, 2), slice(1, None, 2)):
        t0 = time.perf_counter()
        clf.add_examples(texts[part], labels[part])
        add_s.append(time.perf_counter() - t0)
    test_t, test_l = paired_rows("test")
    predicted = [[l for l, _ in clf.predict_multilabel(t)] for t in test_t]
    f1, exact = scores(predicted, test_l)
    print(json.dumps({"train_pairs": len(texts), "test_pairs": len(test_t),
                      "labels": len(clf.label_to_id), "micro_f1": f1,
                      "exact_set_accuracy": exact, "add_examples_s": add_s}))


if __name__ == "__main__":
    main()
