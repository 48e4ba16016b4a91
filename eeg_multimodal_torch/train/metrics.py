"""Loss and metrics matching the reference's numbers.

Port of the JAX package's ``train/metrics.py``: ``cal_loss`` mirrors
TrainAndTest.cal_loss (base_train.py:59-65), weight-aware so that a padded
final batch reproduces DataLoader's drop_last=False batch mean; ``f1_binary``
is sklearn's binary F1 (base_train.py:233) on the host, ``f1`` the same on
the device; ``accuracy``, ``auroc`` and the ``METRICS`` registry of the
legacy trainer (``train/legacy.py``), which mirrors its
``torchmetrics.__dict__[name]`` lookup (train.py:79-80), on the host.
"""
from __future__ import annotations

import numpy as np
import torch


def cross_entropy(logits, labels):
    """Per-sample CE, torch F.cross_entropy semantics (the caller reduces)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, labels[..., None])[..., 0]


def cal_loss(logits, labels, weight=None):
    """(loss, accuracy, pred_label_id, label) as base_train.py:59-65: the
    weighted means over the batch axis, the last of ``labels``. Leading axes
    (a stack of batches, the batched eval) give one mean per batch."""
    ce = cross_entropy(logits, labels)
    pred = logits.argmax(dim=-1)
    correct = (pred == labels).to(torch.float32)
    if weight is None:
        weight = torch.ones_like(ce)
    denom = weight.sum(-1).clamp_min(1.0)
    return (ce * weight).sum(-1) / denom, (correct * weight).sum(-1) / denom, pred, labels


def f1_binary(y_true, y_pred) -> float:
    """sklearn f1_score(y_true, y_pred) with binary average, pos_label=1."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    tp = float(np.sum((y_true == 1) & (y_pred == 1)))
    fp = float(np.sum((y_true == 0) & (y_pred == 1)))
    fn = float(np.sum((y_true == 1) & (y_pred == 0)))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0


def f1(y_true, y_pred, weight=None):
    """:func:`f1_binary` on the device, over the rows with weight > 0;
    returns a 0-d f32 tensor (no host sync). Predictions with leading axes
    (the sweep's (M, N)) give one F1 per row of them."""
    valid = torch.ones_like(y_true, dtype=torch.bool) if weight is None else weight > 0
    t1 = (y_true == 1) & valid
    p1 = (y_pred == 1) & valid
    tp = (t1 & p1).sum(-1).to(torch.float32)
    fp = (~t1 & p1).sum(-1).to(torch.float32)
    fn = (t1 & ~p1).sum(-1).to(torch.float32)
    denom = 2 * tp + fp + fn
    return torch.where(denom > 0, 2 * tp / denom.clamp_min(1.0), torch.zeros_like(denom))


def accuracy(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return float((y_true == y_pred).mean()) if len(y_true) else 0.0


def auroc(y_true, scores) -> float:
    """Binary AUROC by the rank statistic, tied scores taking their average
    rank (torchmetrics' 'AUROC'); 0.0 when a class is absent."""
    y_true = np.asarray(y_true)
    scores = np.asarray(scores, np.float64)
    pos = scores[y_true == 1]
    neg = scores[y_true == 0]
    if len(pos) == 0 or len(neg) == 0:
        return 0.0
    allv = np.concatenate([neg, pos])
    order = np.argsort(allv, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    sorted_v = allv[order]
    # every run of equal scores takes its mean rank
    starts = np.flatnonzero(np.r_[True, sorted_v[1:] != sorted_v[:-1]])
    ends = np.r_[starts[1:], len(sorted_v)]
    for i, j in zip(starts, ends):
        if j - i > 1:
            ranks[order[i:j]] = (i + j - 1) / 2.0 + 1.0
    r_pos = ranks[len(neg):].sum()
    n_pos, n_neg = len(pos), len(neg)
    return float((r_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


# the legacy trainer's metric registry, by torchmetrics' class names
METRICS = {
    "Accuracy": lambda labels, preds, scores=None: accuracy(labels, preds),
    "F1Score": lambda labels, preds, scores=None: f1_binary(labels, preds),
    "AUROC": lambda labels, preds, scores=None: auroc(
        labels, scores if scores is not None else preds
    ),
}
