"""A checkpoint's ``tokenizer.json`` when it is not WordPiece.

Counterpart of ``adaptive_classifier_tpu/models/hf_tokenizer_adapter.py``.
BERT-family checkpoints tokenize through the port's WordPiece
(``models/tokenizer.py``).  A ``tokenizer.json`` of another model (the
byte-level BPE of RoBERTa and ModernBERT, a Unigram model) runs on the Rust
``tokenizers`` runtime where that package is installed (``HFTokenizerAdapter``);
without it a BPE file runs on the port's own ``ByteLevelBPE``.  Both take
the WordPiece tokenizer's batch interface: ``__call__`` → padded int32
``(input_ids, attention_mask)``.  Host tokenization, not device code.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from .tokenizer import pad_batch

logger = logging.getLogger(__name__)


class HFTokenizerAdapter:
    """The Rust ``tokenizers`` runtime over a directory's ``tokenizer.json``;
    ``cls`` / ``sep`` / ``pad`` from its ``tokenizer_config.json``.  Raises
    ``ImportError`` where the runtime is not installed."""

    def __init__(self, path: str):
        # optional: the Rust runtime, where it is installed
        from tokenizers import Tokenizer

        p = Path(path)
        #: the file read, copied into an int8 export
        self.source = p / "tokenizer.json"
        self._tok = Tokenizer.from_file(str(p / "tokenizer.json"))
        self._tok.no_padding()
        self._tok.no_truncation()
        names = {"cls_token": "[CLS]", "sep_token": "[SEP]", "pad_token": "[PAD]"}
        cfg_file = p / "tokenizer_config.json"
        if cfg_file.exists():
            cfg = json.loads(cfg_file.read_text())
            for key in names:
                v = cfg.get(key) or names[key]
                names[key] = v.get("content") if isinstance(v, dict) else v
        ids = {k: self._tok.token_to_id(v) for k, v in names.items()}
        self.cls_id = ids["cls_token"] or 0
        self.sep_id = ids["sep_token"] or 0
        self.pad_id = ids["pad_token"] or 0
        # a post-processor frames the ids itself; otherwise cls/sep are added
        self._framed = json.loads((p / "tokenizer.json").read_text()).get(
            "post_processor") is not None

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def encode(self, text: str, max_length: int = 512):
        ids = list(self._tok.encode(text).ids)
        if self._framed:
            return ids[:max_length]
        return [self.cls_id] + ids[: max_length - 2] + [self.sep_id]

    def __call__(self, texts: Sequence[str], max_length: int = 512,
                 pad_to_buckets: Optional[Sequence[int]] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch-encode to padded int32 ``(input_ids, attention_mask)``."""
        return pad_batch([self.encode(t, max_length=max_length) for t in texts],
                         self.pad_id, max_length, pad_to_buckets)


def try_load_hf_tokenizer(path: str):
    """The tokenizer of a directory's ``tokenizer.json``, as the JAX package
    picks it: None without the file, for a WordPiece model (the port's
    WordPiece reads ``vocab.txt``) or an unreadable file; else the Rust
    runtime's ``HFTokenizerAdapter`` where it is installed, else the port's
    ``ByteLevelBPE`` for a BPE model, else None."""
    p = Path(path)
    if not (p / "tokenizer.json").exists():
        return None
    try:
        data = json.loads((p / "tokenizer.json").read_text())
    except (OSError, ValueError) as e:
        logger.debug(f"tokenizer.json unreadable for {path}: {e}")
        return None
    model_type = (data.get("model") or {}).get("type", "")
    if model_type == "WordPiece":
        return None
    try:
        return HFTokenizerAdapter(str(p))
    except ImportError as e:
        logger.debug(f"Rust tokenizers runtime unavailable ({e}); using the "
                     f"first-party byte-level BPE")
    if model_type == "BPE":
        from .bpe import ByteLevelBPE

        return ByteLevelBPE.from_tokenizer_json(str(p))
    return None
