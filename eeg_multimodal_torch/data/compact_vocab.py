"""Compact vocabulary: remap HF token ids to the small set actually used.

The port's own copy of the JAX package's ``data/compact_vocab.py`` (numpy
only, as there). The reference tokenizes purely numeric strings
(space-joined ints, ref: python/src/data/get_embedding.py:113-116), so of
bert-base-uncased's 30522 ids only ~1-2k numeric surfaces (plus specials)
ever appear in the corpus, and the 30522 x 768 word table is mostly rows
the data never gathers: they get zero gradient, so Adam leaves them as they
are, yet every step reads and writes them and their moments.

This module builds a bijection between the used subset of the full vocab and
a dense compact id space. Gathering a compact table with remapped ids gives
the same vectors as gathering the full table with the original ids (a
gather of a gather), so the forward is unchanged; only the parameter count
shrinks. ``compact_embeddings`` slices a full-vocab word table (numpy or
torch) down to the compact rows, and ``expand_embeddings`` scatters a
compact table back into a full-size one for state-dict export.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

# HF bert-base-uncased special ids (vocab.txt rows 0/100/101/102/103).
PAD_ID, UNK_ID, CLS_ID, SEP_ID, MASK_ID = 0, 100, 101, 102, 103
DEFAULT_SPECIALS = (PAD_ID, UNK_ID, CLS_ID, SEP_ID, MASK_ID)


@dataclasses.dataclass(frozen=True)
class CompactVocab:
    """Bijection between used full-vocab ids and dense compact ids.

    new_to_old is sorted ascending, so PAD (full id 0) is always compact id 0
    and relative id order is preserved.
    """

    new_to_old: np.ndarray  # (size,) int32, sorted ascending
    old_to_new: np.ndarray  # (full_vocab,) int32, -1 where unused
    full_vocab: int

    @property
    def size(self) -> int:
        return int(len(self.new_to_old))

    def compact_id(self, old_id: int) -> int:
        new = int(self.old_to_new[old_id])
        if new < 0:
            raise KeyError(f"full-vocab id {old_id} not in compact vocab")
        return new

    @property
    def pad_id(self) -> int:
        return self.compact_id(PAD_ID)

    @property
    def cls_id(self) -> int:
        return self.compact_id(CLS_ID)

    @property
    def sep_id(self) -> int:
        return self.compact_id(SEP_ID)

    @property
    def mask_id(self) -> int:
        return self.compact_id(MASK_ID)

    # -- id remapping ---------------------------------------------------------
    def remap(self, ids: np.ndarray) -> np.ndarray:
        """Full-vocab ids -> compact ids. Unknown ids map to compact UNK;
        if the vocab carries no UNK row (tiny test vocabs, or built with
        add_specials=False), unknown ids are a hard error rather than a
        silent -1 that would index the embedding table from the end."""
        ids = np.asarray(ids)
        out = self.old_to_new[ids]
        if (out < 0).any():
            unk = (
                self.old_to_new[UNK_ID]
                if UNK_ID < self.full_vocab else np.int64(-1)
            )
            if unk < 0:
                bad = np.unique(ids[out < 0])
                raise ValueError(
                    f"ids {bad[:10].tolist()} are outside the compact vocab "
                    "and it has no [UNK] row to fall back to"
                )
            out = np.where(out < 0, unk, out)
        return out.astype(ids.dtype)

    def unmap(self, ids: np.ndarray) -> np.ndarray:
        """Compact ids -> full-vocab ids."""
        ids = np.asarray(ids)
        return self.new_to_old[ids].astype(ids.dtype)

    # -- embedding-table transforms -------------------------------------------
    def compact_embeddings(self, full_table):
        """Slice a (full_vocab, H) table down to (size, H) compact rows.
        Works on numpy arrays and torch tensors; exact (pure gather)."""
        return full_table[self.new_to_old]

    def expand_embeddings(self, compact_table, fill=0.0):
        """Scatter a (size, H) compact table into a (full_vocab, H) one.
        Unused rows get ``fill`` (they never receive gradient anyway)."""
        compact_table = np.asarray(compact_table)
        out = np.full(
            (self.full_vocab,) + compact_table.shape[1:], fill, compact_table.dtype
        )
        out[self.new_to_old] = compact_table
        return out

    # -- persistence ------------------------------------------------------------
    def save(self, path: str):
        np.savez(path, new_to_old=self.new_to_old, full_vocab=self.full_vocab)

    @staticmethod
    def load(path: str) -> "CompactVocab":
        z = np.load(path)
        return CompactVocab.from_ids(
            z["new_to_old"], full_vocab=int(z["full_vocab"]), add_specials=False
        )

    @staticmethod
    def from_ids(
        used_ids: np.ndarray,
        full_vocab: int = 30522,
        add_specials: bool = True,
        specials: Sequence[int] = DEFAULT_SPECIALS,
    ) -> "CompactVocab":
        used = np.unique(np.asarray(used_ids).reshape(-1))
        if add_specials:
            # drop specials outside the table (tiny test vocabs have no
            # room for the HF special ids at 100-103)
            sp = np.asarray([s for s in specials if s < full_vocab])
            used = np.union1d(used, sp)
        used = used.astype(np.int64)
        if used.size and (used.min() < 0 or used.max() >= full_vocab):
            raise ValueError(
                f"token id out of range [0, {full_vocab}): "
                f"[{used.min()}, {used.max()}]"
            )
        old_to_new = np.full((full_vocab,), -1, np.int32)
        old_to_new[used] = np.arange(used.size, dtype=np.int32)
        return CompactVocab(used.astype(np.int32), old_to_new, full_vocab)


def build_compact_vocab(
    id_arrays: Iterable[np.ndarray], full_vocab: int = 30522
) -> CompactVocab:
    """CompactVocab over every id occurring in the given token arrays, plus
    the BERT specials (PAD/UNK/CLS/SEP/MASK are always included so MLM
    masking and padding work even if a split lacks them)."""
    arrays = [np.asarray(a).reshape(-1) for a in id_arrays]
    used = np.unique(np.concatenate(arrays)) if arrays else np.empty(0, np.int32)
    return CompactVocab.from_ids(used, full_vocab=full_vocab)


def remap_pairing(arrays, vocab: CompactVocab):
    """Remap the token streams of a MultiModalArrays to compact ids.
    Image streams (float embeddings) pass through untouched."""
    import dataclasses as dc

    kw = {}
    if arrays.multimodal_type[0] == "t":
        kw["eeg_input"] = vocab.remap(arrays.eeg_input)
    if arrays.multimodal_type[1] == "t":
        kw["act_input"] = vocab.remap(arrays.act_input)
    return dc.replace(arrays, **kw) if kw else arrays
