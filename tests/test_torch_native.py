"""The port's binding to the C++ tokenizer and flat index under ``native/``
(CPU).

- The library builds from ``native/*.cpp`` into the package's ``_build/``
  and writes nothing under ``native/``; without a compiler the tokenizer
  keeps its Python path.
- ``NativeWordPiece``: ids and masks equal to the JAX package's
  ``NativeWordPiece`` and to the port's Python WordPiece on every text of
  ``data/*.json``, over the vocabularies of ``ac-base-v2``, ``ac-tiny`` and
  the built-in one; the cases of the JAX package's ``tests/test_native.py``
  (seeded random strings in place of its unseeded ``hypothesis`` draws).
- The tokenizer sends a batch's ASCII texts through the library, in one
  call (counted by ``native.encode_counts``), and the others through Python.
- ``FlatIndexL2`` against numpy and against the port's prototype search.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from adaptive_classifier_tpu import native as jnative
from adaptive_classifier_tpu_torch import native
from adaptive_classifier_tpu_torch.models.tokenizer import WordPieceTokenizer
from adaptive_classifier_tpu_torch.ops import knn

REPO = Path(__file__).resolve().parent.parent
BUCKETS = (32, 64, 128, 256, 512)


def _texts(obj):
    if isinstance(obj, str):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _texts(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _texts(v)


DATA_TEXTS = [t for f in sorted((REPO / "data").glob("*.json"))
              for t in _texts(json.loads(f.read_text()))]

CORPUS = [
    "Hello, World!",
    "the quick brown fox jumps over the lazy dog",
    "refund my payment please -- URGENT!!!",
    "x" * 150,  # past max_input_chars_per_word: [UNK]
    "punctuation,everywhere.and;more:here",
    "numbers 123 456 and mixed a1b2c3",
    "",
    "   leading and trailing   ",
]

UNICODE = [
    "Café déjà-vu — naïve façade; Zürich coöperate",
    "ΑΣ ΟΔΥΣΣΕΥΣ σοφός",
    "Привет мир, это тест кириллицы",
    "日本語のテスト中文测试한국어",
    "emoji 😀 test 🎉 done",
    "ligature ﬁle straße İstanbul",
    "zero\x00width​space\xa0nbsp",
    "ｆｕｌｌｗｉｄｔｈ　ｔｅｘｔ",
]


def _tokenizer(vocab: str) -> WordPieceTokenizer:
    if vocab == "hermetic":
        return WordPieceTokenizer.hermetic(4096)
    return WordPieceTokenizer.from_pretrained(str(REPO / "checkpoints" / vocab))


def _python(tok: WordPieceTokenizer) -> WordPieceTokenizer:
    """The same tokenizer with the C++ path off."""
    py = WordPieceTokenizer(tok.vocab, do_lower_case=tok.do_lower_case)
    py._native_tried = True
    return py


def _random_strings(seed, n, alphabet, max_len):
    r = np.random.default_rng(seed)
    return ["".join(r.choice(alphabet, r.integers(0, max_len + 1))) for _ in range(n)]


def _fresh_state(monkeypatch):
    """``load_native`` as at its first call; everything restored after."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    for attr in ("path", "seconds", "compiled", "error"):
        monkeypatch.setattr(native.BuildInfo, attr, getattr(native.BuildInfo, attr))


def test_library_builds_into_the_package_and_not_under_native(monkeypatch, tmp_path):
    # the default build root is the package's git-ignored _build/
    assert native.BUILD_ROOT == Path(native.__file__).resolve().parent / "_build"
    assert "-march=native" not in native.CXX_FLAGS
    before = sorted((p.name, p.stat().st_mtime_ns) for p in native.NATIVE_SRC.iterdir())
    _fresh_state(monkeypatch)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    assert native.load_native() is not None
    assert native.BuildInfo.compiled and native.BuildInfo.error == ""
    built = list((tmp_path / "_build").glob("native-*/libacnative.so"))
    assert built == [native.BuildInfo.path]
    assert not list((tmp_path / "_build").glob("native-*/.*tmp"))
    assert sorted((p.name, p.stat().st_mtime_ns) for p in native.NATIVE_SRC.iterdir()) == before


def test_without_a_compiler_the_tokenizer_keeps_python(monkeypatch):
    _fresh_state(monkeypatch)
    monkeypatch.setattr(native, "find_compiler", lambda: None)
    monkeypatch.setattr(native, "BUILD_ROOT", Path("/nonexistent-build-root"))
    assert native.load_native() is None and "compiler" in native.BuildInfo.error
    tok = WordPieceTokenizer.hermetic(4096)
    native.reset_encode_counts()
    ids, mask = tok(CORPUS, max_length=64)
    assert tok._get_native() is None and native.encode_counts["rows"] == 0
    want = _python(tok)(CORPUS, max_length=64)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(mask, want[1])
    with pytest.raises(RuntimeError, match="unavailable"):
        native.NativeWordPiece(tok.vocab)


@pytest.mark.parametrize("vocab", ["ac-base-v2", "ac-tiny", "hermetic"])
def test_data_texts_match_jax_native_and_python(vocab):
    tok = _tokenizer(vocab)
    nat = native.NativeWordPiece(tok.vocab, tok.do_lower_case)
    jnat = jnative.NativeWordPiece(tok.vocab, tok.do_lower_case)
    ids, lens = nat.encode_batch(DATA_TEXTS, 512)
    jids, jlens = jnat.encode_batch(DATA_TEXTS, 512)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(lens, jlens)
    py = _python(tok)
    native.reset_encode_counts()
    n_ascii = 0
    for s in range(0, len(DATA_TEXTS), 256):
        part = DATA_TEXTS[s:s + 256]
        got = tok(part, max_length=512, pad_to_buckets=BUCKETS)
        want = py(part, max_length=512, pad_to_buckets=BUCKETS)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        n_ascii += sum(t.isascii() for t in part)
    assert native.encode_counts["rows"] == n_ascii > 0.99 * len(DATA_TEXTS)


def test_parity_with_python_and_batch_matches_single():
    tok = WordPieceTokenizer.hermetic(4096)
    nat = native.NativeWordPiece(tok.vocab, tok.do_lower_case)
    for text in CORPUS:
        assert nat.encode(text, max_length=64).tolist() == tok.encode(text, max_length=64)
    mat, lens = nat.encode_batch(CORPUS, 64)
    for i, text in enumerate(CORPUS):
        assert mat[i, :lens[i]].tolist() == nat.encode(text, 64).tolist()
    # truncation to max_length keeps [CLS] ... [SEP]
    long = " ".join(["word"] * 100)
    assert nat.encode(long, 16).tolist() == tok.encode(long, max_length=16)


def test_tokenizer_takes_the_native_path_for_ascii_rows():
    tok = WordPieceTokenizer.hermetic(4096)
    texts = ["hello world", "café déjà vu", "foo bar baz", "日本語テスト"]
    native.reset_encode_counts()
    ids, mask = tok(texts, max_length=32)
    assert tok._get_native() is not None
    assert native.encode_counts == {"rows": 2, "batches": 1}
    want = _python(tok)(texts, max_length=32)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(mask, want[1])
    # a tokenizer with other special tokens stays in Python
    vocab = dict(tok.vocab, **{"<unk>": len(tok.vocab)})
    other = WordPieceTokenizer(vocab, unk_token="<unk>")
    other(texts, max_length=32)
    assert other._get_native() is None


@pytest.mark.parametrize("seed,lo,hi", [(0, 32, 126), (1, 0, 127)])
def test_random_ascii_and_control_characters_match_python(seed, lo, hi):
    """Printable ASCII, and all of 0-127: control characters are deleted,
    joining their neighbours, as the Python ``_clean`` does."""
    tok = WordPieceTokenizer.hermetic(4096)
    nat = native.NativeWordPiece(tok.vocab, tok.do_lower_case)
    alphabet = [chr(c) for c in range(lo, hi + 1)]
    for text in _random_strings(seed, 300, alphabet, 80):
        assert nat.encode(text, 64).tolist() == tok.encode(text, max_length=64), repr(text)
    assert nat.encode("ab\x0bcd", 16).tolist() == tok.encode("abcd", max_length=16)
    assert nat.encode("ab\x7fcd", 16).tolist() == tok.encode("abcd", max_length=16)


def test_unicode_matches_python():
    tok = WordPieceTokenizer.hermetic(4096)
    nat = native.NativeWordPiece(tok.vocab, tok.do_lower_case)
    for text in UNICODE:
        assert nat.encode(text, 128).tolist() == tok.encode(text, max_length=128), text
    alphabet = ([chr(c) for c in range(32, 127)] + [chr(c) for c in range(0xC0, 0x180)]
                + [chr(c) for c in range(0x370, 0x400)] + [chr(c) for c in range(0x4E00, 0x4E40)]
                + list("😀🎉ßﬁİΣς​\xa0　"))
    for text in _random_strings(2, 200, alphabet, 60):
        assert nat.encode(text, 96).tolist() == tok.encode(text, max_length=96), repr(text)
    texts = [f"pooled row {i} café {i} 日本 {i}" for i in range(256)]
    mat, lens = nat.encode_batch(texts, 48)
    for i, text in enumerate(texts):
        assert mat[i, :lens[i]].tolist() == nat.encode(text, 48).tolist()


def test_max_length_below_two_is_refused():
    tok = WordPieceTokenizer.hermetic(4096)
    nat = native.NativeWordPiece(tok.vocab, tok.do_lower_case)
    with pytest.raises(ValueError):
        nat.encode("hello", 1)
    with pytest.raises(ValueError):
        nat.encode_batch(["hello"], 0)


def test_flat_index_matches_numpy():
    r = np.random.default_rng(0)
    d, n, nq, k = 32, 100, 8, 10
    data = r.standard_normal((n, d)).astype(np.float32)
    q = r.standard_normal((nq, d)).astype(np.float32)
    idx = native.FlatIndexL2(d)
    idx.add(data)
    assert idx.ntotal == n
    dist, ids = idx.search(q, k)
    d2 = ((q[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    for b in range(nq):
        expect = np.argsort(d2[b], kind="stable")[:k]
        np.testing.assert_array_equal(ids[b], expect)
        np.testing.assert_allclose(dist[b], d2[b][expect], rtol=1e-4, atol=1e-4)
    # k past ntotal pads with -1; remove and reset
    small = native.FlatIndexL2(8)
    small.add(np.ones((2, 8), np.float32))
    _, ids = small.search(np.zeros((1, 8), np.float32), 5)
    assert (ids[0, 2:] == -1).all()
    eye = native.FlatIndexL2(4)
    eye.add(np.eye(4, dtype=np.float32))
    eye.remove(0)
    assert eye.ntotal == 3
    eye.reset()
    assert eye.ntotal == 0


def test_flat_index_matches_the_prototype_search():
    r = np.random.default_rng(3)
    d, n, nq, k = 16, 24, 6, 5
    protos = r.standard_normal((n, d)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    q = r.standard_normal((nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    idx = native.FlatIndexL2(d)
    idx.add(protos)
    _, ids_native = idx.search(q, k)
    valid = torch.ones(n, dtype=torch.bool)
    sims = knn.masked_sims_ref(torch.from_numpy(q), torch.from_numpy(protos), valid)
    _, ids_port = knn.topk_scores(sims, valid, k)
    np.testing.assert_array_equal(np.sort(ids_native, axis=1),
                                  np.sort(ids_port.numpy(), axis=1))
