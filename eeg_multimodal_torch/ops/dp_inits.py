"""The learnable DP logits' alternative initializations (ref: past_acc.py:94-103).

Port of the JAX package's ``ops/dp_inits.py``. The reference tries three:
  - zeros (the default, models.py:53 / past_acc.py:94);
  - per-modality constants cat(0.4 | 0.5 | 0.3) over the three 768-wide
    segments (past_acc.py:95, the 'newinit' runs);
  - 'feawei', from the extracted features' magnitudes: the per-feature mean
    of the fused features, standardized, w_init = 1 - sigmoid(k x), DP =
    modality_constants + w_init - 0.5 (past_acc.py:98-103; the features come
    from ``experiments/legacy_drivers.extract_feawei``).
Each returns a (1, F) f32 CPU tensor, to copy into a tree's ``DP`` leaf; the
numpy steps are the JAX package's, so the values are its values.
"""
from __future__ import annotations

import numpy as np
import torch

D = 768


def zeros(width: int = 3 * D):
    return torch.zeros((1, width), dtype=torch.float32)


def _constants(values, seg: int) -> np.ndarray:
    return np.concatenate([np.full((1, seg), v, np.float32) for v in values], axis=1)


def modality_constants(values=(0.4, 0.5, 0.3), seg: int = D):
    """cat(full(v0) | full(v1) | full(v2)) (past_acc.py:95)."""
    return torch.from_numpy(_constants(values, seg))


def feawei(feature_matrix, k: float = 1.0, base_values=(0.4, 0.5, 0.3)):
    """The feature-magnitude init (past_acc.py:98-103) of an (N, 3 D)
    feature matrix (feawei.pkl, past_acc_feawei.py:131-148)."""
    mean_values = np.mean(np.asarray(feature_matrix), axis=0)
    mean_values = (mean_values - np.mean(mean_values)) / np.std(mean_values)
    w_init = 1.0 - 1.0 / (1.0 + np.exp(-k * mean_values))  # 1 - sigmoid(k x)
    base = _constants(base_values, len(mean_values) // 3)
    return torch.from_numpy(np.asarray(base + w_init[None, :] - 0.5, np.float32))
