"""Recover the numeric WordPiece vocab from the reference's committed
tokenized test pickle and CSV, and save it for the embedding path.

    python -m eeg_multimodal_torch.tools.recover_vocab [--reference <ref>] \\
        [--out recovered_vocab.json]

The port of the JAX package's ``tools/recover_vocab.py``: reads
``feature/test_EEG.csv`` and ``feature/EEG/test_bert.pickle`` under the
reference, runs ``data/tokenizer.py::recover_numeric_vocab`` (the exact HF
``bert-base-uncased`` ids of the dataset's numeric strings, with no
network), writes the vocab and prints how many rows it encodes byte-exact.
``--reference`` defaults to ``data/datasets.py::reference_dir()``
(``$REFERENCE_DIR``, else ``~/reference``: the JAX tool's default where
the home is that of the JAX package's machine).

Host-only: it reads and writes files on the CPU and takes no device. The
pickle must hold plain Python and numpy values (a list of
``{"input_ids", "attention_mask"}``, each a row of 512 ids); one that
holds objects of a package this interpreter lacks (``transformers``'
``BatchEncoding``) raises ``ModuleNotFoundError`` naming the class, with no
fallback.
"""
import argparse
import csv
import os
import pickle

from ..data.datasets import reference_dir
from ..data.tokenizer import recover_numeric_vocab


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except ModuleNotFoundError as e:
            raise ModuleNotFoundError(
                f"the token pickle holds a {module}.{name}, and {e.name!r} cannot be "
                f"imported here", name=e.name) from e


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", default=reference_dir())
    ap.add_argument("--out", default="recovered_vocab.json")
    return ap


def main(argv=None):
    """Recover and save; returns the tokenizer."""
    args = parser().parse_args(argv)
    with open(os.path.join(args.reference, "feature", "test_EEG.csv")) as f:
        texts = [r["EEG"] for r in csv.DictReader(f)]
    with open(os.path.join(args.reference, "feature", "EEG", "test_bert.pickle"), "rb") as f:
        enc = _Unpickler(f).load()
    ids = [list(e["input_ids"]) for e in enc]
    tok = recover_numeric_vocab(texts, ids)
    exact = sum(1 for t, ref in zip(texts, ids) if list(tok.encode(t)[0]) == ref)
    tok.save(args.out)
    print(
        f"wrote {args.out}: {len(tok.vocab)} pieces, {len(tok.word_memo)} "
        f"memoized words, {exact}/{len(texts)} rows byte-exact"
    )
    return tok


if __name__ == "__main__":
    main()
