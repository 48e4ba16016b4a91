"""Stacked multimodal datasets, pairing, token truncation and epoch batching.

Port of the JAX package's ``data/datasets.py``: the reference's file
loaders and the stacked arrays. The whole split lives on the device as a
dict of tensors; an epoch is a permutation cut into a padded (n_batches, B)
index matrix, and a batch is an ``index_select`` of every array.

Batch schema (the reference's 5-tuple, dataset.py:35-44), for ``ti``:
  eeg_input : (B, S) int64 tokens     eeg_mask : (B, S) int64
  act_input : (B, 1, 512) f32         act_mask : (B, 1) int64 (dummy [1])
  labels    : (B,) int64  (NaN -> 0, dataset.py:41-43)
"""
from __future__ import annotations

import dataclasses
import pickle
from typing import Dict, Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Loaders for the reference's on-disk artifact formats (datasets.py:33-61 of
# the JAX package)
# ---------------------------------------------------------------------------

def load_label_csv(path: str) -> np.ndarray:
    """Label CSV with header 'label'; NaN/empty -> 0 (dataset.py:41-43)."""
    labels = []
    with open(path) as f:
        next(f)  # header
        for line in f:
            s = line.strip()
            labels.append(0 if s in ("", "nan") else int(float(s)))
    return np.asarray(labels, np.int32)


def load_bert_pickle(path: str) -> Dict[str, np.ndarray]:
    """List of HF BatchEncoding dicts -> stacked {input_ids, attention_mask}
    (format produced by get_embedding.py:113-116, consumed dataset.py:36-37)."""
    with open(path, "rb") as f:
        items = pickle.load(f)
    ids = np.asarray([np.asarray(e["input_ids"]).reshape(-1) for e in items], np.int32)
    mask = np.asarray([np.asarray(e["attention_mask"]).reshape(-1) for e in items], np.int32)
    return {"input_ids": ids, "attention_mask": mask}


def load_embedding_pickle(path: str) -> np.ndarray:
    """(N, 512) float32 image-embedding array (e.g. CLIP)."""
    with open(path, "rb") as f:
        arr = pickle.load(f)
    return np.asarray(arr, np.float32)


def load_eeg_feature_csv(path: str):
    """Legacy feature/{train,test}_EEG.csv: columns 'EEG' (space-joined ints)
    and 'label' (ref: data.py:10-13). Returns (texts, labels)."""
    import csv

    texts, labels = [], []
    with open(path) as f:
        for row in csv.DictReader(f):
            texts.append(row["EEG"])
            lab = row.get("label", "")
            labels.append(0 if lab in ("", "nan") else int(float(lab)))
    return texts, np.asarray(labels, np.int32)


def load_feature_csv(path: str) -> np.ndarray:
    """Processed per-channel CSV (train_EEG.csv / train_act.csv with channel
    headers, ``data/process.py``'s output). Returns (N, C) float32; a
    one-row file gives (1, C)."""
    return np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float32, ndmin=2)


@dataclasses.dataclass
class MultiModalArrays:
    """Whole-split host arrays for one (eeg_repr, act_repr) pairing."""

    eeg_input: np.ndarray
    eeg_mask: np.ndarray
    act_input: np.ndarray
    act_mask: np.ndarray
    labels: np.ndarray
    multimodal_type: str  # "ti" | "tt" | "it" | "ii"

    def __len__(self):
        return len(self.labels)

    def to_device(self, device) -> Dict[str, torch.Tensor]:
        """The split as device tensors: integer arrays as int64 (the index
        type of torch's gathers), float arrays as f32."""

        def put(a):
            a = np.asarray(a)
            dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
            return torch.as_tensor(a, dtype=dtype, device=device)

        return {
            "eeg_input": put(self.eeg_input),
            "eeg_mask": put(self.eeg_mask),
            "act_input": put(self.act_input),
            "act_mask": put(self.act_mask),
            "labels": put(self.labels),
        }


def _txt_stream(tok: Dict[str, np.ndarray]):
    return tok["input_ids"], tok["attention_mask"]


def _img_stream(emb: np.ndarray):
    # dataset.py:38-39: unsqueeze(0) -> (1,512) per item, dummy mask [1]
    return emb[:, None, :].astype(np.float32), np.ones((len(emb), 1), np.int32)


def build_pairing(
    multimodal_type: str,
    labels: np.ndarray,
    eeg_txt: Optional[Dict[str, np.ndarray]] = None,
    eeg_img: Optional[np.ndarray] = None,
    act_txt: Optional[Dict[str, np.ndarray]] = None,
    act_img: Optional[np.ndarray] = None,
    faithful_tt_inputs: bool = True,
) -> MultiModalArrays:
    """Assemble a pairing exactly as the reference datasets do.

    ``faithful_tt_inputs`` reproduces dataset.py:63, where the ``tt`` act
    stream feeds ``attention_mask`` as input_ids. Labels: NaN -> 0.
    """
    if multimodal_type == "ti":
        ei, em = _txt_stream(eeg_txt)
        ai, am = _img_stream(act_img)
    elif multimodal_type == "tt":
        ei, em = _txt_stream(eeg_txt)
        if faithful_tt_inputs:
            ai = act_txt["attention_mask"]  # dataset.py:63 quirk
            am = act_txt["attention_mask"]
        else:
            ai, am = _txt_stream(act_txt)
    elif multimodal_type == "it":
        ei, em = _img_stream(eeg_img)
        ai, am = _txt_stream(act_txt)
    elif multimodal_type == "ii":
        ei, em = _img_stream(eeg_img)
        ai, am = _img_stream(act_img)
    else:
        raise ValueError(multimodal_type)
    labels = np.where(np.isnan(labels.astype(np.float64)), 0, labels).astype(np.int32)
    return MultiModalArrays(ei, em, ai, am, labels, multimodal_type)


def truncate_tokens(arrays: MultiModalArrays, multiple: int = 16,
                    max_len: Optional[int] = None) -> MultiModalArrays:
    """Drop all-padding token columns: slice txt streams to the longest
    valid mask length rounded up to ``multiple`` (or to ``max_len``).

    Exact: padded positions carry a masking attention bias, the pooler reads
    [CLS] only and cross-attention masks them out, so no logit changes. The
    committed rows hold at most 65 tokens of 512, so S becomes 80.
    """
    def cut(ids, mask):
        if ids.ndim != 2 or ids.shape[1] <= multiple:
            return ids, mask
        longest = int(np.max(mask.sum(axis=1)))
        target = max_len or -(-longest // multiple) * multiple
        target = min(target, ids.shape[1])
        return ids[:, :target], mask[:, :target]

    ei, em = arrays.eeg_input, arrays.eeg_mask
    ai, am = arrays.act_input, arrays.act_mask
    if arrays.multimodal_type[0] == "t":
        ei, em = cut(ei, em)
    if arrays.multimodal_type[1] == "t":
        ai, am = cut(ai, am)
    return MultiModalArrays(ei, em, ai, am, arrays.labels, arrays.multimodal_type)


def truncate_pair(train: MultiModalArrays, test: MultiModalArrays,
                  multiple: int = 16):
    """Truncate a train/test pair to one shared (rounded) max length."""
    def longest(a):
        out = 0
        if a.multimodal_type[0] == "t":
            out = max(out, int(np.max(a.eeg_mask.sum(axis=1))))
        if a.multimodal_type[1] == "t":
            out = max(out, int(np.max(a.act_mask.sum(axis=1))))
        return out

    top = max(longest(train), longest(test))
    if top == 0:
        return train, test
    target = -(-top // multiple) * multiple
    return (
        truncate_tokens(train, multiple, max_len=target),
        truncate_tokens(test, multiple, max_len=target),
    )


def epoch_indices(n: int, batch_size: int, shuffle: bool = True,
                  generator: Optional[torch.Generator] = None, device="cpu"):
    """Shuffled epoch as an index matrix plus a validity mask.

    Mirrors DataLoader(batch_size, shuffle=True, drop_last=False)
    (base_train.py:88-89): the last partial batch is padded with index 0
    and weighted out. ``generator`` is a CPU generator (the permutation is
    drawn on the host). Returns (idx (n_batches, B) int64, weight
    (n_batches, B) f32) on ``device``.
    """
    n_batches = -(-n // batch_size)
    perm = torch.randperm(n, generator=generator) if shuffle else torch.arange(n)
    pad = n_batches * batch_size - n
    idx = torch.cat([perm, torch.zeros(pad, dtype=perm.dtype)])
    weight = torch.cat([torch.ones(n), torch.zeros(pad)])
    return (
        idx.reshape(n_batches, batch_size).to(device),
        weight.reshape(n_batches, batch_size).to(device),
    )


def gather_batch(data: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Index every stacked array with a (B,) index vector."""
    return {k: v.index_select(0, idx) for k, v in data.items()}
