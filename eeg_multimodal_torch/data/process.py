"""Raw task txt -> processed CSVs (ref: python/src/data/process.py:16-48).

The port's own copy of the JAX package's ``data/process.py``: host code on
numpy and files, no tensor and so no device. It writes the same bytes as
the JAX package for the same raw txt.

The reference (whose logic is committed fully commented-out) reads the three
multimodal-Parkinson task txt files, rounds features to int, re-headers the
EEG block with 30 channel names, and writes an 80/20 train/test split
(seed 42) into data/processed/{train,test}_{EEG,act,label}.csv.

Raw row layout (per the dataset's documentation and the processed headers):
  col 0      : time index (dropped)
  cols 1-25  : wearable motion — 4 IMUs x (ACC xyz + GYRO xyz) + SC
  cols 26-55 : 30 EEG channels
  col 56     : label
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

EEG_CHANNELS = [
    "FP1", "FP2", "F3", "F4", "C3", "C4", "P3", "P4", "01", "02",
    "F7", "F8", "P7", "P8", "Fz", "Cz", "Pz", "FC1", "FC2", "CP1",
    "CP2", "FC5", "FC6", "CP5", "CP6", "EMG1", "EMG2", "IO", "EMG3", "EMG4",
]  # ref: process.py re-header (SURVEY §2.1 #1); header of processed train_EEG.csv

ACT_CHANNELS = [
    "LShankACCX", "LShankACCY", "LShankACCZ",
    "LShankGYROX", "LShankGYROY", "LShankGYROZ",
    "RShankACCX", "RShankACCY", "RShankACCZ",
    "RShankGYROX", "RShankGYROY", "RShankGYROZ",
    "WaistACCX", "WaistACCY", "WaistACCZ",
    "WaistGYROX", "WaistGYROY", "WaistGYROZ",
    "ArmACCX", "ArmACCY", "ArmACCZ",
    "ArmGYROX", "ArmGYROY", "ArmGYROZ",
    "SC",
]  # header of processed train_act.csv

SPLIT_SEED = 42  # ref: process.py train_test_split(random_state=42)
TEST_FRACTION = 0.2


def load_task_txt(path: str) -> np.ndarray:
    """One whitespace-separated task file -> (N, 57) float array."""
    return np.loadtxt(path, dtype=np.float64, ndmin=2)


def train_test_split(n: int, test_fraction: float = TEST_FRACTION,
                     seed: int = SPLIT_SEED):
    """sklearn-compatible shuffled split (the reference uses sklearn's
    train_test_split(random_state=42)): permutation by RandomState, test
    indices first ceil(n*frac)."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    n_test = int(np.ceil(n * test_fraction))
    return np.sort(perm[n_test:]), np.sort(perm[:n_test])


def _write_csv(path: str, header: Sequence[str], rows: np.ndarray):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for row in rows:
            f.write(",".join(str(int(v)) for v in row) + "\n")


def process(task_paths: List[str], out_dir: str) -> None:
    """Full raw->processed pipeline: concat tasks, round to int, split, write
    {train,test}_{EEG,act,label}.csv (ref: process.py:16-48; data.sh:4)."""
    data = np.concatenate([load_task_txt(p) for p in task_paths], axis=0)
    feats = np.rint(data[:, 1:56])
    labels = data[:, 56].astype(np.int64)
    act = feats[:, : len(ACT_CHANNELS)]
    eeg = feats[:, len(ACT_CHANNELS) : len(ACT_CHANNELS) + len(EEG_CHANNELS)]
    train_idx, test_idx = train_test_split(len(data))
    for split, idx in (("train", train_idx), ("test", test_idx)):
        _write_csv(os.path.join(out_dir, f"{split}_EEG.csv"), EEG_CHANNELS, eeg[idx])
        _write_csv(os.path.join(out_dir, f"{split}_act.csv"), ACT_CHANNELS, act[idx])
        with open(os.path.join(out_dir, f"{split}_label.csv"), "w") as f:
            f.write("label\n")
            for v in labels[idx]:
                f.write(f"{v}\n")
