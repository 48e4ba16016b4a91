"""Text-side pretexts of the MLM pretrainer: host-side numpy work.

The port's own copy of the JAX package's ``train/pretext.py`` (which
imports no JAX; the port imports nothing of that package), over the port's
tokenizer and C++ engine:

1. corpus augmentation (``augment_rows``, ``tokenize_rows``): jittered
   integer copies of the numeric rows, serialized and tokenized as the
   embedding path does (ref get_embedding.py:113-116);
2. whole-number corruption (``continuation_id_set``, ``word_start_index``):
   every wordpiece of a number points at the number's first piece, so that
   ``mlm.mask_tokens`` corrupts whole numbers;
3. cross-modal CLIP targets (``load_act_clip_targets``,
   ``stack_clip_targets``): each corpus row's act-CLIP embedding.

Outputs equal the JAX package's byte for byte: the same
``np.random.RandomState`` draws, the same tokenizer.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Sequence

import numpy as np

from .. import native
from ..data.tokenizer import MAX_LEN, default_tokenizer_for_coef, serialize_row


def augment_rows(rows: np.ndarray, factor: int, jitter_frac: float,
                 seed: int) -> np.ndarray:
    """``factor`` jittered integer copies of the rows, (factor N, C): per
    column Gaussian noise of ``jitter_frac`` times the column's std over
    ``rows``, rounded to int as the reference's processing rounds features
    (process.py:16-48). A constant column stays constant."""
    if factor <= 0:
        return np.zeros((0, rows.shape[1]), rows.dtype)
    rng = np.random.RandomState(seed)
    std = rows.std(axis=0)
    out = [np.rint(rows + rng.randn(*rows.shape) * (std * jitter_frac)) for _ in range(factor)]
    return np.concatenate(out).astype(rows.dtype)


def tokenize_rows(rows: np.ndarray, coef: str = "bert-base-uncased",
                  max_len: int = MAX_LEN) -> Dict[str, np.ndarray]:
    """The rows serialized (space-joined ints) and tokenized for ``coef``
    as ``GetEmbedding.text_encode`` does, by the C++ engine where it built,
    else the Python engine (the same ids): {input_ids, attention_mask},
    (N, max_len) int32, full-vocab ids."""
    texts = [serialize_row(int(v) for v in row) for row in rows]
    tok = default_tokenizer_for_coef(coef)
    if native.available():
        ids, mask = native.NativeWordPiece.from_wordpiece(tok).encode_batch(texts, max_len)
    else:
        ids, mask = tok.encode_batch(texts, max_len)
    return {"input_ids": np.asarray(ids, np.int32), "attention_mask": np.asarray(mask, np.int32)}


def continuation_id_set(coef: str = "bert-base-uncased") -> np.ndarray:
    """Boolean table over full-vocab ids: True where the token is a '##'
    continuation piece."""
    tok = default_tokenizer_for_coef(coef)
    cont = np.zeros((max(tok.vocab.values()) + 1,), bool)
    for s, i in tok.vocab.items():
        if s.startswith("##"):
            cont[i] = True
    return cont


def word_start_index(full_ids: np.ndarray, cont_table: np.ndarray) -> np.ndarray:
    """(N, S) int32: for every position the index of its word's first
    wordpiece (a continuation points back, starts and specials at
    themselves), from full-vocab ids before compaction."""
    n, s = full_ids.shape
    is_cont = cont_table[np.minimum(full_ids, len(cont_table) - 1)]
    start = np.where(is_cont, 0, np.arange(s)[None, :].repeat(n, 0))
    # a continuation takes the latest non-continuation index
    return np.maximum.accumulate(start, axis=1).astype(np.int32)


def load_act_clip_targets(data_root: str) -> np.ndarray:
    """The train split's act-CLIP embeddings of a (distilled) data tree,
    data/embedding/act/img/clip_ViT_B_32/train.pickle: (N, 512) f32."""
    path = os.path.join(data_root, "data", "embedding", "act", "img", "clip_ViT_B_32",
                        "train.pickle")
    with open(path, "rb") as f:
        arr = np.asarray(pickle.load(f), np.float32)
    return arr[:, 0] if arr.ndim == 3 else arr  # the (N, 1, 512) item layout


def stack_clip_targets(per_modal_counts: Sequence[int], clip_train: np.ndarray) -> np.ndarray:
    """Per-corpus-row CLIP targets: the corpus stacks each modality's rows
    in sample order (``mlm.build_corpus``), and both modalities' rows of
    sample i share clip_train[i] (tiled over augmented copies)."""
    outs = [np.tile(clip_train, (-(-n // len(clip_train)), 1))[:n] for n in per_modal_counts]
    return np.concatenate(outs).astype(np.float32)
