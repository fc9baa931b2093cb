"""The port's byte-level BPE and tokenizer choice against the JAX package's
and the Rust ``tokenizers`` runtime (CPU), on the committed fixture
``tests/fixtures/bpe`` (``scripts/make_bpe_fixture.py``).

- ``ByteLevelBPE`` ids equal the JAX package's and the Rust runtime's on
  every text of ``data/*.json`` (id for id), and the Rust runtime's on text
  holding added-token strings, where the JAX package's differ (its BPE
  byte-encodes ``"[SEP]"`` where Rust gives the special id: ROADMAP §C);
- ``try_load_hf_tokenizer`` picks the JAX package's class with and without
  the Rust runtime importable;
- a classifier on a tiny RoBERTa checkpoint with the fixture's tokenizer
  against the JAX package's, through both tokenizers, saved and loaded.
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import transformers

from adaptive_classifier_tpu import AdaptiveClassifier as JaxClassifier
from adaptive_classifier_tpu.models import bpe as jbpe
from adaptive_classifier_tpu.models import hf_tokenizer_adapter as jada
from adaptive_classifier_tpu_torch import AdaptiveClassifier
from adaptive_classifier_tpu_torch.models import bpe as tbpe
from adaptive_classifier_tpu_torch.models import hf_tokenizer_adapter as tada
from adaptive_classifier_tpu_torch.models.tokenizer import WordPieceTokenizer

tokenizers = pytest.importorskip("tokenizers")

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "bpe"


def _data_texts():
    sys.path.insert(0, str(REPO / "scripts"))
    from make_bpe_fixture import corpus

    return corpus()


@pytest.fixture(scope="module")
def tokenizers_trio():
    rust = tokenizers.Tokenizer.from_file(str(FIXTURE / "tokenizer.json"))
    return (rust, jbpe.ByteLevelBPE.from_tokenizer_json(str(FIXTURE)),
            tbpe.ByteLevelBPE.from_tokenizer_json(str(FIXTURE)))


def test_fixture_is_small_and_roberta_shaped():
    assert (FIXTURE / "tokenizer.json").stat().st_size < 1_000_000
    bpe = tbpe.ByteLevelBPE.from_tokenizer_json(str(FIXTURE))
    assert (bpe.cls_id, bpe.pad_id, bpe.sep_id) == (0, 1, 2)
    assert bpe.vocab_size == len(bpe.vocab) > 4000


@pytest.mark.parametrize("part", range(4))
def test_ids_equal_jax_and_rust_on_the_data(tokenizers_trio, part):
    """Every text of data/*.json (a quarter per case): the port's ids equal
    the JAX package's and the Rust runtime's."""
    rust, jax_bpe, bpe = tokenizers_trio
    texts = _data_texts()[part::4]
    assert len(texts) > 1000
    for text in texts:
        got = bpe.encode_text(text)
        assert got == jax_bpe.encode_text(text), text
        assert got == rust.encode(text, add_special_tokens=False).ids, text


def test_pretokenizer_and_byte_map_equal_jax():
    assert tbpe.bytes_to_unicode() == jbpe.bytes_to_unicode()
    for text in _data_texts()[::7] + ["  runs   of\tspaces\n", "it's they'll", "日本語 café"]:
        assert tbpe.gpt2_pretokenize(text) == jbpe.gpt2_pretokenize(text)
        assert "".join(tbpe.gpt2_pretokenize(text)) == text


@pytest.mark.parametrize("text", ["hello </s> world", "<mask>", "a<s>b", "<pad><pad>",
                                  "[SEP]", "x </s></s> y", "<unk>?"])
def test_added_tokens_split_like_rust(tokenizers_trio, text):
    rust, _, bpe = tokenizers_trio
    assert bpe.encode_text(text) == rust.encode(text, add_special_tokens=False).ids


def test_sep_text_like_rust_where_jax_differs(tmp_path):
    """The ROADMAP §C case: a BPE trained with ``[SEP]`` as a special token
    (as ``tests/test_bpe.py`` trains it).  Rust and the port give the
    special id; the JAX package's BPE gives byte pieces."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    tok.train_from_iterator(_data_texts()[:500], trainers.BpeTrainer(
        vocab_size=400, special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False))
    tok.save(str(tmp_path / "tokenizer.json"))
    bpe = tbpe.ByteLevelBPE.from_tokenizer_json(str(tmp_path))
    jax_bpe = jbpe.ByteLevelBPE.from_tokenizer_json(str(tmp_path))
    for text in ("[SEP]", "a [SEP] b", "[CLS]x[SEP]"):
        want = tok.encode(text).ids
        assert bpe.encode_text(text) == want
    assert tok.encode("[SEP]").ids == [3]
    assert jax_bpe.encode_text("[SEP]") != [3]


def test_batch_interface_matches_jax(tokenizers_trio):
    _, jax_bpe, bpe = tokenizers_trio
    texts = _data_texts()[:64] + ["", "x"]
    for buckets in ((32, 64, 128, 256, 512), (8,)):
        for got, want in zip(bpe(texts, max_length=48, pad_to_buckets=buckets),
                             jax_bpe(texts, max_length=48, pad_to_buckets=buckets)):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)


def _block_rust(monkeypatch, module):
    class NoRuntime:
        def __init__(self, *a, **k):
            raise ImportError("no tokenizers")

    monkeypatch.setattr(module, "HFTokenizerAdapter", NoRuntime)


@pytest.mark.parametrize("rust", [True, False])
def test_tokenizer_choice_matches_jax(tmp_path, monkeypatch, rust):
    """The class each package picks for a BPE file, a WordPiece file and no
    file, with the Rust runtime importable or not (monkeypatched as in
    ``tests/test_bpe.py``)."""
    if not rust:
        _block_rust(monkeypatch, tada)
        _block_rust(monkeypatch, jada)
    bpe_dir = tmp_path / "bpe"
    shutil.copytree(FIXTURE, bpe_dir)
    wp_dir = tmp_path / "wp"
    wp_dir.mkdir()
    (wp_dir / "tokenizer.json").write_text(json.dumps({"model": {"type": "WordPiece"}}))
    for d in (bpe_dir, wp_dir, tmp_path / "none"):
        got, want = tada.try_load_hf_tokenizer(str(d)), jada.try_load_hf_tokenizer(str(d))
        assert type(got).__name__ == type(want).__name__
    assert type(tada.try_load_hf_tokenizer(str(bpe_dir))).__name__ == (
        "HFTokenizerAdapter" if rust else "ByteLevelBPE")


def test_adapter_ids_equal_jax_adapter():
    texts = _data_texts()[::50] + [""]
    ada, jax_ada = tada.HFTokenizerAdapter(str(FIXTURE)), jada.HFTokenizerAdapter(str(FIXTURE))
    assert (ada.cls_id, ada.sep_id, ada.pad_id) == (jax_ada.cls_id, jax_ada.sep_id,
                                                    jax_ada.pad_id) == (0, 2, 1)
    for got, want in zip(ada(texts, 64, pad_to_buckets=(32, 64)),
                         jax_ada(texts, 64, pad_to_buckets=(32, 64))):
        np.testing.assert_array_equal(got, want)
    # the first-party BPE frames short texts as the post-processor does
    bpe = tbpe.ByteLevelBPE.from_tokenizer_json(str(FIXTURE))
    for text in texts:
        assert bpe.encode(text, 64) == ada.encode(text, 64)


@pytest.fixture(scope="module")
def roberta_bpe(tmp_path_factory):
    """A tiny RoBERTa (pad 1) sized to the fixture's vocabulary, with its
    tokenizer files."""
    vocab = json.loads((FIXTURE / "tokenizer.json").read_text())["model"]["vocab"]
    cfg = transformers.RobertaConfig(vocab_size=len(vocab), hidden_size=64,
                                     num_hidden_layers=2, num_attention_heads=4,
                                     intermediate_size=128, max_position_embeddings=130,
                                     type_vocab_size=1, pad_token_id=1)
    torch.manual_seed(3)
    d = tmp_path_factory.mktemp("roberta_bpe")
    transformers.RobertaModel(cfg).save_pretrained(d)
    for f in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(FIXTURE / f, d / f)
    return d


def _intents(block):
    data = json.loads((REPO / "data" / "intents.json").read_text())
    if block == "train":
        rows = [(t, lbl) for lbl, ts in data["train"].items() for t in ts]
    else:
        rows = [(t, lbl) for lbl in data["train"] for t in data["test"][lbl]]
    return [t for t, _ in rows], [lbl for _, lbl in rows]


@pytest.mark.parametrize("rust", [True, False])
def test_roberta_bpe_classifier_matches_jax(roberta_bpe, tmp_path, monkeypatch, rust):
    """add_examples on intents' train rows and predict_batch on its test
    rows in both packages (float32, ridge head), through the Rust runtime or
    both first-party BPEs: every JAX top-1 score within 1e-4 in the port's
    answer, the same top-1 where the JAX package's first two scores are
    more than 1e-5 apart (random weights leave most rows on near-ties);
    then save → load answers the same."""
    if not rust:
        _block_rust(monkeypatch, tada)
        _block_rust(monkeypatch, jada)
    config = {"head_type": "ridge", "compute_dtype": "float32", "embedding_cache_size": 0}
    clf = AdaptiveClassifier(str(roberta_bpe), device="cpu", config=dict(config))
    jclf = JaxClassifier(str(roberta_bpe), config=dict(config))
    name = "HFTokenizerAdapter" if rust else "ByteLevelBPE"
    assert type(clf.encoder.tokenizer).__name__ == type(jclf.encoder.tokenizer).__name__ == name
    assert clf.encoder.config.arch == "roberta"
    texts, labels = _intents("train")
    ids, mask = clf.encoder.tokenizer(texts[:32], 512, pad_to_buckets=(32, 64))
    jids, jmask = jclf.encoder.tokenizer(texts[:32], 512, pad_to_buckets=(32, 64))
    np.testing.assert_array_equal(ids, jids)
    clf.add_examples(texts, labels)
    jclf.add_examples(texts, labels)
    test_t, _ = _intents("test")
    got, want = clf.predict_batch(test_t, k=3), jclf.predict_batch(test_t, k=3)
    for g, w in zip(got, want):
        assert abs(dict(g).get(w[0][0], 0.0) - w[0][1]) < 1e-4
        if w[0][1] - w[1][1] > 1e-5:
            assert g[0][0] == w[0][0]
    clf.save(tmp_path / "saved")
    back = AdaptiveClassifier.load(tmp_path / "saved", device="cpu")
    assert type(back.encoder.tokenizer).__name__ == name
    again = back.predict_batch(test_t, k=3)
    assert [a[0][0] for a in again] == [g[0][0] for g in got]


def test_int8_export_carries_the_bpe_tokenizer(roberta_bpe, tmp_path):
    """The int8 export of a BPE encoder holds its tokenizer.json (not a
    vocab.txt of BPE pieces), and an encoder built from the export alone
    tokenizes as the original."""
    from adaptive_classifier_tpu_torch import quantization
    from adaptive_classifier_tpu_torch.models.encoder import Encoder

    enc = Encoder(str(roberta_bpe), device="cpu", compute_dtype="float32",
                  quantization="int8")
    quantization.save_quantized_encoder(enc, tmp_path / "q")
    assert (tmp_path / "q" / "tokenizer.json").exists()
    assert not (tmp_path / "q" / "vocab.txt").exists()
    back = Encoder.from_quantized_export(tmp_path / "q", "gone/model", device="cpu",
                                         compute_dtype="float32", quantization="int8")
    texts = _intents("test")[0][:16]
    assert torch.equal(back.embed(texts), enc.embed(texts))
    assert not isinstance(back.tokenizer, WordPieceTokenizer)
