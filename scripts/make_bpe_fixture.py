"""Train the byte-level BPE tokenizer fixture on the repository's data.

    python scripts/make_bpe_fixture.py [--merges 4000]

Trains a byte-level BPE (GPT-2 pre-tokenization, no prefix space, RoBERTa's
special tokens ``<s> <pad> </s> <unk> <mask>`` as ids 0-4 and its
``<s> ... </s>`` post-processor) with the Rust ``tokenizers`` package on
every text of ``data/*.json``, and writes ``tests/fixtures/bpe/tokenizer.json``
and its ``tokenizer_config.json``.  The CPU tests and ``chip_smoke.py``'s
RoBERTa checkpoint read it; the port tokenizes it with its own
``ByteLevelBPE`` where the Rust runtime is not installed.  Deterministic:
the same data give the same file.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "fixtures" / "bpe"
SPECIALS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]


def texts(node):
    """Every string under a JSON value."""
    if isinstance(node, str):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from texts(v)
    elif isinstance(node, list):
        for v in node:
            yield from texts(v)


def corpus():
    rows = []
    for path in sorted((REPO / "data").glob("*.json")):
        data = json.loads(path.read_text())
        rows += list(texts({k: v for k, v in data.items() if k != "description"}))
    return rows


def main():
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, processors, trainers

    ap = argparse.ArgumentParser()
    ap.add_argument("--merges", type=int, default=4000)
    args = ap.parse_args()
    alphabet = pre_tokenizers.ByteLevel.alphabet()
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=len(SPECIALS) + len(alphabet) + args.merges,
        special_tokens=SPECIALS, initial_alphabet=alphabet, show_progress=False)
    tok.train_from_iterator(corpus(), trainer)
    tok.post_processor = processors.RobertaProcessing(
        sep=("</s>", tok.token_to_id("</s>")), cls=("<s>", tok.token_to_id("<s>")),
        trim_offsets=True, add_prefix_space=False)
    OUT.mkdir(parents=True, exist_ok=True)
    tok.save(str(OUT / "tokenizer.json"), pretty=False)
    (OUT / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": "<s>", "cls_token": "<s>", "eos_token": "</s>", "sep_token": "</s>",
        "pad_token": "<pad>", "unk_token": "<unk>", "mask_token": "<mask>",
        "model_max_length": 512}, indent=2) + "\n")
    print(json.dumps({"vocab_size": tok.get_vocab_size(), "texts": len(corpus()),
                      "bytes": (OUT / "tokenizer.json").stat().st_size}))


if __name__ == "__main__":
    main()
