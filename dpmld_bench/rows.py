"""The benchmark's rows: a seeded stand-in for the reference's split.

A frozen copy of the law of ``eeg_multimodal_torch/bench.py::write_stand_in``
(the port's seeded stand-in for the reference's committed test split), made
as arrays instead of files and drawn from the run's ``--seed``. Each EEG row
is the text encoder's opening id ([CLS] for BERT), word ids from a pool of
600 (the numeric rows' tokens come from about that many) drawn from the
encoder's word range, then its closing id ([SEP]) and padding to 512
positions: 20 to 65 valid tokens, and row 0 of each split holds 65, the
committed rows' longest, so that truncation gives S = 80 on every seed.
Each row has a 512-d act embedding (N(0, 1)) and a 0/1 label. The ids are
the encoder part's ``TOKENS`` (``reference/encoders/``).

Only numpy: the plain reference reads these rows too, and imports nothing
of the program.
"""
from __future__ import annotations

import numpy as np

POSITIONS = 512
ACT_DIM = 512


def _split(rng, n, pool, valid_min, valid_max, tokens):
    lengths = rng.integers(valid_min, valid_max + 1, n)
    lengths[0] = valid_max
    ids = np.zeros((n, POSITIONS), np.int64)
    first, last = [tokens["first"]], [tokens["last"]]
    for r, k in enumerate(lengths):
        ids[r, :k] = np.concatenate([first, rng.choice(pool, k - 2), last])
    mask = (np.arange(POSITIONS)[None, :] < lengths[:, None]).astype(np.int64)
    emb = rng.standard_normal((n, ACT_DIM)).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.int64)
    return {"input_ids": ids, "attention_mask": mask, "act": emb, "labels": labels}


def make_rows(seed: int, traffic: dict, tokens: dict):
    """(train, eval) rows of ``traffic`` for ``seed`` under the token law
    ``tokens`` (an encoder part's ``TOKENS``): dicts of numpy arrays
    ``input_ids`` and ``attention_mask`` (n, 512) int64 in the encoder's
    full vocabulary, ``act`` (n, 512) f32 and ``labels`` (n,) int64. Every
    seed gives the same sizes; only the ids, lengths, embeddings and labels
    move."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 601])
    pool = rng.choice(np.arange(*tokens["words"]), traffic["word_pool"], replace=False)
    lo, hi = traffic["valid_tokens"]
    return (_split(rng, traffic["n_train"], pool, lo, hi, tokens),
            _split(rng, traffic["n_eval"], pool, lo, hi, tokens))


def seq_len(train, test, truncate: bool, multiple: int = 16) -> int:
    """The sequence length a run computes at: with ``truncate`` the longest
    valid row of both splits rounded up to ``multiple`` (the port's
    ``truncate_pair``), else every position."""
    if not truncate:
        return POSITIONS
    top = max(int(train["attention_mask"].sum(1).max()), int(test["attention_mask"].sum(1).max()))
    return min(POSITIONS, -(-top // multiple) * multiple)
