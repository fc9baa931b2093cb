"""The JAX package's figures for the strategic-mode flow of
``chip_smoke.py`` (phase 6t), on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_reference_strategic.py

The setup of ``scripts/eval_strategic.py --head-type ridge
--fusion-weights auto --ridge-lambda auto --lexical-dim 32768`` on the
production config (``lexical_dim`` 32,768, ridge head, λ and the fusion
share fitted) with ``checkpoints/ac-base-v2`` as the encoder: a regular
classifier takes the 659 rows of ``data/sentiment.json``'s train split in
one ``add_examples``; a strategic one (``cost_function_type: "linear"``,
coefficients 0.15 for every embedding feature, the script's
``uniform_low``, ``strategic_training_frequency`` 2) resolves its lexical
knobs on the whole train split and then takes the rows in the script's
chunks of ``len(train) // 6`` (7 adds).  Both answer the 200 clean test
rows and the same rows under the script's seeded attack (typos on charged
words and a distractor clause): the regular classifier through
``_predict_regular_batch`` (``predict``), the strategic one through
``_predict_dual_batch`` (its ``predict``) and ``predict_robust_batch``.
Then the robustness evaluation at gaming levels 0.0, 0.5 and 1.0 for both
(the regular classifier's head under the strategic classifier's
evaluator).  Prints one JSON object; the port's chip run holds its
figures to these within the band in ``chip_smoke.py``.  Everything but
gaming level 0.5 is deterministic in the JAX package.
"""

from __future__ import annotations

import json
import random
import re
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
ENCODER = REPO / "checkpoints" / "ac-base-v2"
PRODUCTION = {"lexical_dim": 32768, "head_type": "ridge", "fusion_weights": "auto",
              "ridge_lambda": "auto"}
LEVELS = [0.0, 0.5, 1.0]

# scripts/eval_strategic.py's attack, copied
_CHARGED = re.compile(
    r"\b(delight|wonderful|warm|smart|funny|gorgeous|satisfying|remarkable|"
    r"beautifully|generous|irresistible|perfect|triumph|love|brilliant|"
    r"powerful|genuinely|breathtaking|charm|best|masterclass|exceeded|"
    r"flawlessly|fantastic|superb|excellent|great|amazing|joy|stunning|"
    r"reliable|inspiring|unforgettable|extraordinary|fresh|cozy|tedious|"
    r"bloated|wooden|thud|thin|rushed|incoherent|hollow|cynical|insulting|"
    r"clumsy|forced|predictable|disastrous|grating|muddled|lazy|misery|"
    r"broke|cheap|useless|scratched|crashes|false|waste|dead|loud|late|"
    r"rude|cold|bland|stale|disorganized|slog|cliches|flat|forgettable|"
    r"terrible|awful|horrible|worst|boring)\b")


def typo(word: str, rng: random.Random) -> str:
    if len(word) < 4:
        return word
    i = rng.randrange(1, len(word) - 2)
    return word[:i] + word[i + 1] + word[i] + word[i + 2:]


def attack(text: str, rng: random.Random) -> str:
    out = _CHARGED.sub(lambda m: typo(m.group(0), rng), text)
    distractors = ["for what it is worth", "according to some people",
                   "in my honest opinion", "believe it or not", "at the end of the day"]
    return out + " , " + rng.choice(distractors)


def sentiment_rows():
    """(train, clean, adversarial) rows of (text, label), as
    scripts/eval_strategic.py's ``load_real`` builds them."""
    blob = json.loads((REPO / "data" / "sentiment.json").read_text())
    rng = random.Random(42)
    train = [(t, lbl) for lbl in ("positive", "negative") for t in blob["train"][lbl]]
    clean = [(t, lbl) for lbl in ("positive", "negative") for t in blob["test"][lbl]]
    adv = [(attack(t, rng), lbl) for t, lbl in clean]
    return train, clean, adv


def accuracy(preds, rows) -> float:
    return float(np.mean([bool(p) and p[0][0] == lbl for p, (_, lbl) in zip(preds, rows)]))


def main():
    import jax.numpy as jnp

    from adaptive_classifier_tpu import AdaptiveClassifier

    train, clean, adv = sentiment_rows()
    texts, labels = [t for t, _ in train], [lbl for _, lbl in train]
    t0 = time.perf_counter()
    regular = AdaptiveClassifier(str(ENCODER), config=dict(PRODUCTION))
    regular.add_examples(texts, labels)
    regular_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    strategic = AdaptiveClassifier(str(ENCODER), config={
        **PRODUCTION, "enable_strategic_mode": True, "cost_function_type": "linear",
        "cost_coefficients": [0.15] * regular.embedding_dim,
        "strategic_training_frequency": 2})
    strategic._ensure_lexical_ready(texts, labels)
    chunk = max(len(train) // 6, 1)
    for s in range(0, len(train), chunk):
        strategic.add_examples(texts[s:s + chunk], labels[s:s + chunk])
    strategic_s = time.perf_counter() - t0

    clean_t, adv_t = [t for t, _ in clean], [t for t, _ in adv]
    out = {
        "train_rows": len(train), "test_rows": len(clean),
        "adds": -(-len(train) // chunk),
        "regular": {"clean_top1": accuracy(regular._predict_regular_batch(clean_t, 1), clean),
                    "adv_top1": accuracy(regular._predict_regular_batch(adv_t, 1), adv),
                    "add_examples_s": regular_s},
        "strategic": {
            "clean_top1_dual": accuracy(strategic._predict_dual_batch(clean_t, 1), clean),
            "clean_top1_robust": accuracy(strategic.predict_robust_batch(clean_t, 1), clean),
            "adv_top1_dual": accuracy(strategic._predict_dual_batch(adv_t, 1), adv),
            "adv_top1_robust": accuracy(strategic.predict_robust_batch(adv_t, 1), adv),
            "add_examples_s": strategic_s},
        "resolved": {"regular": [regular.lexical.grams, regular.lexical.weight,
                                 regular.config.ridge_lambda, regular._fusion_alpha],
                     "strategic": [strategic.lexical.grams, strategic.lexical.weight,
                                   strategic.config.ridge_lambda, strategic._fusion_alpha]},
    }
    y = jnp.asarray([regular.label_to_id[lbl] for _, lbl in clean])
    out["regular"]["gaming"] = strategic.strategic_evaluator.evaluate_robustness(
        regular._masked_logits_fn(), regular._embed_device(clean_t), y, LEVELS)
    out["strategic"]["gaming"] = strategic.evaluate_strategic_robustness(
        clean_t, [lbl for _, lbl in clean], LEVELS)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
