"""The port's host text path against the JAX package's, on the CPU.

``eeg_multimodal_torch/data/tokenizer.py`` (WordPiece, RecoveredWordPiece,
the synthetic and recovered vocabularies, ``recover_numeric_vocab``) and
``eeg_multimodal_torch/native/`` (the C++ engine) give ids and masks EQUAL
to the JAX package's on fuzzed numeric strings, truncation at
``max_length`` included; the port's copy of the recovered vocab is the JAX
package's byte for byte (this test reads both files; the port reads its
own)."""
import os

import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.data import tokenizer as JT
from eeg_multimodal_torch import native as TN
from eeg_multimodal_torch.data import tokenizer as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE = ["", "-", "- -", "  7   8  ", "0", "-0", "99999999999999999999", "1 " * 200,
        "-" * 5 + "3", "-2084 14 -2 2 -7"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fuzzed_texts(seed, n=120):
    """Space-joined integers of 1 to 9 digits, about half negative, 1 to 60
    a row (the long rows pass 128 tokens: truncation), then the edge cases."""
    rng = np.random.RandomState(seed)
    texts = []
    for _ in range(n):
        vals = [int(rng.randint(-10 ** rng.randint(1, 9), 10 ** rng.randint(1, 9)))
                for _ in range(rng.randint(1, 60))]
        texts.append(" ".join(str(v) for v in vals))
    return texts + EDGE


def ground_truth_vocab(pkg):
    """A BERT-like numeric vocab (tests/test_tokenizer.py's): digits, '-',
    whole numbers below 100 and some 3-digit ones, '##' continuations."""
    vocab = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102}
    nid = 1000
    vocab["-"] = nid
    nid += 1
    for n in range(100):
        vocab[str(n)] = nid
        nid += 1
    for n in range(0, 1000, 7):
        vocab.setdefault(str(n), nid)
        nid += 1
    for d in "0123456789":
        vocab["##" + d] = nid
        nid += 1
    for a in "0123456789":
        for b in "0123456789":
            vocab["##" + a + b] = nid
            nid += 1
    return pkg.WordPiece(vocab)


TOKENIZERS = {
    "synthetic": lambda pkg: pkg.synthetic_numeric_vocab(),
    "recovered_uncased": lambda pkg: pkg.default_tokenizer_for_coef("bert-base-uncased"),
    "cased_default": lambda pkg: pkg.default_tokenizer_for_coef("bert-base-cased"),
    "ground_truth": ground_truth_vocab,
}


def test_recovered_vocab_is_the_jax_packages_byte_for_byte():
    port = os.path.join(ROOT, "eeg_multimodal_torch", "data", "recovered_vocab_uncased.json")
    jax_copy = os.path.join(ROOT, "eeg_multimodal_tpu", "data", "recovered_vocab_uncased.json")
    with open(port, "rb") as a, open(jax_copy, "rb") as b:
        assert a.read() == b.read()
    tok = TT.default_tokenizer_for_coef("bert-base-uncased")
    assert isinstance(tok, TT.RecoveredWordPiece) and tok.word_memo


@pytest.mark.parametrize("name", list(TOKENIZERS))
def test_encode_equals_jax(name):
    """ids and masks equal to the JAX engine's, at 128 (long rows cut) and
    at 32 (most rows cut); one text and the batch."""
    port, ref = TOKENIZERS[name](TT), TOKENIZERS[name](JT)
    assert (port.cls_id, port.sep_id, port.pad_id, port.unk_id) == \
        (ref.cls_id, ref.sep_id, ref.pad_id, ref.unk_id)
    texts = fuzzed_texts(1)
    for max_length in (128, 32):
        ids, mask = port.encode_batch(texts, max_length)
        want_ids, want_mask = ref.encode_batch(texts, max_length)
        assert ids.dtype == mask.dtype == np.int32 and ids.shape == (len(texts), max_length)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(mask, want_mask)
        assert (mask.sum(1) == max_length).any()  # truncation was exercised
        one_ids, one_mask = port.encode(texts[0], max_length)
        np.testing.assert_array_equal(one_ids, want_ids[0])
        np.testing.assert_array_equal(one_mask, want_mask[0])


def test_serialize_and_vocab_files_round_trip_across_packages(tmp_path):
    assert TT.serialize_row([14, -2, 0]) == JT.serialize_row([14, -2, 0]) == "14 -2 0"
    truth = ground_truth_vocab(JT)
    txt = tmp_path / "vocab.txt"
    inv = {i: s for s, i in truth.vocab.items()}
    txt.write_text("".join(f"{inv.get(i, f'[unused{i}]')}\n" for i in range(max(inv) + 1)))
    texts = fuzzed_texts(2, 40)
    a, b = TT.WordPiece.from_vocab_txt(str(txt)), JT.WordPiece.from_vocab_txt(str(txt))
    np.testing.assert_array_equal(a.encode_batch(texts, 64)[0], b.encode_batch(texts, 64)[0])
    rec_port = TT.default_tokenizer_for_coef("bert-base-uncased")
    for saver, loader in ((rec_port, JT.RecoveredWordPiece), (rec_port, TT.RecoveredWordPiece),
                          (a, JT.WordPiece)):
        path = str(tmp_path / "saved.json")
        saver.save(path)
        back = loader.load(path)
        np.testing.assert_array_equal(back.encode_batch(texts, 64)[0],
                                      saver.encode_batch(texts, 64)[0])


def test_recover_numeric_vocab_equals_jax():
    """tests/test_tokenizer.py's round trip (300 rows of 20 values, a
    ground-truth vocab at 128 tokens): the same vocab, specials and word
    memo as the JAX package's, and the same ids on seen and unseen rows."""
    truth = ground_truth_vocab(JT)
    rng = np.random.RandomState(0)
    texts = [" ".join(str(v) for v in rng.randint(-3000, 3000, size=20)) for _ in range(300)]
    ids = [truth.encode(t, max_length=128)[0] for t in texts]
    port, ref = TT.recover_numeric_vocab(texts, ids), JT.recover_numeric_vocab(texts, ids)
    assert port.vocab == ref.vocab
    assert port.word_memo == ref.word_memo
    assert (port.cls_id, port.sep_id, port.pad_id, port.unk_id) == \
        (ref.cls_id, ref.sep_id, ref.pad_id, ref.unk_id)
    unseen = texts[:20] + ["2999 -1777", "123 -456"]
    np.testing.assert_array_equal(port.encode_batch(unseen, 128)[0],
                                  ref.encode_batch(unseen, 128)[0])


@pytest.fixture(scope="module")
def native_ok():
    if not TN.available():
        pytest.skip(f"the C++ WordPiece did not build here: {TN.build_error()}")


@pytest.mark.parametrize("name", list(TOKENIZERS))
def test_native_engine_equals_the_python_engines(name, native_ok):
    """The port's C++ engine against its Python engine and the JAX
    package's, row for row; a batch equal to single calls."""
    port, ref = TOKENIZERS[name](TT), TOKENIZERS[name](JT)
    nat = TN.NativeWordPiece.from_wordpiece(port)
    texts = fuzzed_texts(3)
    for max_length in (128, 32):
        ids, mask = nat.encode_batch(texts, max_length)
        want_ids, want_mask = ref.encode_batch(texts, max_length)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(mask, want_mask)
        np.testing.assert_array_equal(ids, port.encode_batch(texts, max_length)[0])
        for i in (0, len(texts) - 1):
            one_ids, one_mask = nat.encode(texts[i], max_length)
            np.testing.assert_array_equal(one_ids, ids[i])
            np.testing.assert_array_equal(one_mask, mask[i])


def test_native_library_is_cached_outside_the_sources(native_ok):
    """Built under .cache/native/<hash>/ at the checkout's root, nothing
    next to the sources; no texts gives no rows; a newline, which the C side
    reads as a row break, is refused."""
    lib = TN._build()[0]
    assert os.path.dirname(lib._name).startswith(os.path.join(ROOT, ".cache", "native"))
    assert not [f for f in os.listdir(os.path.dirname(TN.SRC)) if f.endswith(".so")]
    nat = TN.NativeWordPiece.from_wordpiece(TT.synthetic_numeric_vocab())
    ids, mask = nat.encode_batch([], 16)
    assert ids.shape == mask.shape == (0, 16)
    with pytest.raises(ValueError, match="newline"):
        nat.encode_batch(["1 2", "3\n4"], 16)
