"""Sensor rows -> 3x224x224 images on the device (ref: get_embedding.py:18-48).

Port of the JAX package's ``data/image_transform.py``, batched over rows
with no per-row loop:

- act rows (25 values): the last value appended twice -> (27,) ->
  reshape(3, 3, 3) -> permute(2, 0, 1) -> nearest-neighbour upsample x74 ->
  (3, 222, 222) -> zero-pad 1 -> (3, 224, 224) (TransferToImage,
  get_embedding.py:26-31). Exact: a copy of each value.
- EEG rows (C values): row min-max -> linear interpolation from C evenly
  spaced points to 224 * 224 -> reshape(224, 224) -> stacked x3
  (get_embedding.py:32-44), with ``jnp.interp``'s formula over
  ``jnp.linspace``'s grids. A constant row divides 0 by 0 and gives NaN, as
  in the JAX package: no epsilon is added.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IMG_SIZE = 224
UPSAMPLE = 74  # ref: get_embedding.py:22 nn.Upsample(scale_factor=74)


def act_to_images(rows: torch.Tensor) -> torch.Tensor:
    """(N, 25) -> (N, 3, 224, 224) f32, on ``rows``' device."""
    rows = rows.float()
    ext = torch.cat([rows, rows[:, -1:], rows[:, -1:]], dim=1)  # + last value x2
    t = ext.reshape(-1, 3, 3, 3).permute(0, 3, 1, 2)  # each row's permute(2, 0, 1)
    t = t.repeat_interleave(UPSAMPLE, dim=2).repeat_interleave(UPSAMPLE, dim=3)
    return F.pad(t, (1, 1, 1, 1))  # ZeroPad2d(1)


def linspace01(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0.0, 1.0, n)`` in f32 as the JAX package computes it:
    i times the f32 reciprocal of n - 1 (XLA's rewrite of i / (n - 1)), the
    endpoint exactly 1. ``torch.linspace`` steps from both ends and differs
    by an ulp at some points."""
    if n < 2:
        raise ValueError(f"an interpolation grid needs 2 points or more, got {n}")
    recip = float(np.float32(1.0) / np.float32(n - 1))  # exact in f32
    step = torch.arange(n - 1, dtype=torch.float32, device=device) * recip
    return torch.cat([step, torch.ones(1, dtype=torch.float32, device=device)])


def interp_rows(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for every row of ``fp`` (N, len(xp)) at the
    shared points ``x``: the bracketing index i from
    ``searchsorted(xp, x, side="right")`` clipped to [1, len(xp) - 1], then
    fp[i-1] + (x - xp[i-1]) / (xp[i] - xp[i-1]) * (fp[i] - fp[i-1]). The
    grids here are increasing, so JAX's guards for a zero step and for x
    outside xp change nothing and are left out."""
    i = torch.searchsorted(xp, x, right=True).clamp_(1, xp.shape[0] - 1)
    lo, hi = fp[:, i - 1], fp[:, i]
    return lo + ((x - xp[i - 1]) / (xp[i] - xp[i - 1])) * (hi - lo)


def eeg_to_images(rows: torch.Tensor) -> torch.Tensor:
    """(N, C) -> (N, 3, 224, 224) f32, on ``rows``' device."""
    rows = rows.float()
    lo = rows.amin(dim=1, keepdim=True)
    r = (rows - lo) / (rows.amax(dim=1, keepdim=True) - lo)
    dev = rows.device
    img = interp_rows(linspace01(IMG_SIZE * IMG_SIZE, dev), linspace01(rows.shape[1], dev), r)
    return img.reshape(-1, 1, IMG_SIZE, IMG_SIZE).expand(-1, 3, -1, -1).contiguous()
