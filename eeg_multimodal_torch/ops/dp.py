"""The DP mechanism's math: row min-max, the noise scale, the Laplace block.

Port of the JAX package's ``ops/dp.py`` (the part the flagship runs). The
reference's DP block (python/src/custom_models/models.py:70-79) is
min-max normalize, ``w = sigmoid(DP)``, Laplace noise scaled by
``eps_hat(w, eps)``, then a Gumbel mask whose two stacked halves sum to one,
so the mask is a value- and gradient-exact identity. ``lap_dropout_fast``
is that identity-reduced form. The noise is an argument: callers draw it
(``ops/dp_fused.py`` holds the sampler and the fused kernels).
"""
from __future__ import annotations

import math

import torch


def minmax_normalize(x):
    """Per-row min-max normalization onto [0, 1] (ref: models.py:70-72)."""
    x_min = x.amin(dim=-1, keepdim=True)
    x_max = x.amax(dim=-1, keepdim=True)
    return (x - x_min) / (x_max - x_min)


def eps_hat(w, epsilon: float):
    """Per-feature noise scale 1 / log((e^eps - w) / (1 - w)) (ref:
    models.py:75, the '# fix' form). ``w`` is sigmoid(DP) in (0, 1).

    Under the bf16 compute cast ``w`` is bf16, and the JAX package's dtype
    promotion (ops/dp.py:41-42 there) gives f32 for e^eps - w (its e^eps is
    an f32 array) but bf16 for 1 - w (a Python float against bf16); the
    quotient and the log are f32. The casts below say the same; for an f32
    ``w`` they do nothing."""
    return 1.0 / torch.log((math.exp(epsilon) - w.float()) / (1.0 - w).float())


def lap_dropout_fast(feature, dp_param, epsilon: float, noise):
    """The flagship DP block with the Gumbel identity removed:
    ``feature + noise * eps_hat(sigmoid(DP), eps)``.

    feature : (B, F) min-max-normalized features; dp_param : (1, F) logits;
    noise : (B, F) Laplace(0, 1) draw.
    """
    return feature + noise * eps_hat(torch.sigmoid(dp_param), epsilon)
