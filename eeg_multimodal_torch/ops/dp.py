"""The DP mechanism's math: row min-max, the noise scales, the Laplace and
Gumbel samplers, and every DP block of the model zoo.

Port of the JAX package's ``ops/dp.py``. The reference's DP block
(python/src/custom_models/models.py:70-79) is min-max normalize,
``w = sigmoid(DP)``, Laplace noise scaled by ``eps_hat(w, eps)``, then a
Gumbel mask whose two stacked halves sum to one, so the mask is a value- and
gradient-exact identity: ``lap_dropout`` keeps the Gumbel stage,
``lap_dropout_fast`` is the identity-reduced form the model runs. The legacy
variants: the equal-weight scheme (models.py:399-405), per-sample Laplace
(train_val.py:114-123), the scaled Gumbel dropout (train_val.py:95-101) and
the privacy-regularized loss (train_val.py:80-93).

Every function that draws takes an explicit ``torch.Generator`` and, as a
test hook, the draw itself (``noise``, ``gumbel``, ``keep``), so that tests
can hand the port the JAX reference's threefry draws. There is one Laplace
sampler (``laplace_from_bits`` over ``random_bits``), which the fused
kernels' plain twin (``ops/dp_fused.py``) uses too.

Sweep members. Where M members are stacked on a leading axis (the batched
sweep, ``train/sweep.py``), a (N, F) feature holds M groups of N / M rows,
member m's rows the m-th group. ``epsilon`` is then a per-member (M,) or
(M, 1) tensor instead of a float (float64 keeps the float's value), a
learned parameter carries the member axis first ((M, 1, F) ``DP``, (M, F)
``w``), and a draw takes a group of M generators, one per member
(``utils/seeding.grouped``). Each member's rows then get what a call over
its rows alone, with its float epsilon and its generator, would give.
"""
from __future__ import annotations

import math

import torch

from ..utils.seeding import grouped

_U23 = 1.0 / (1 << 23)


def random_bits(shape, generator, device="cpu"):
    """Uniform 32-bit draws, held in int64 (torch has no uint32 sampler);
    from a group of generators, one block of rows each."""
    return grouped(lambda s, g: torch.randint(0, 1 << 32, s, generator=g, dtype=torch.int64,
                                              device=device), shape, generator)


def per_member(epsilon) -> bool:
    """Whether ``epsilon`` is a per-member tensor (else a float)."""
    return isinstance(epsilon, torch.Tensor)


def _exp(e):
    return torch.exp(e) if per_member(e) else math.exp(e)


def _log(e):
    return torch.log(e) if per_member(e) else math.log(e)


def member_scalar(epsilon, fn):
    """``fn(epsilon)`` for a float; for a per-member tensor ``fn`` of its
    float64 values, rounded once to f32 as a Python float is where it meets
    an f32 tensor, shaped (M, 1, 1) to scale a (M, rows, F) group view."""
    if not per_member(epsilon):
        return fn(epsilon)
    return fn(epsilon.double()).float().reshape(-1, 1, 1)


def member_exp(epsilon):
    """e^eps, as :func:`member_scalar` gives it."""
    return member_scalar(epsilon, _exp)


def by_member(x, epsilon):
    """``x`` (N, ...) as the (M, N / M, ...) view of its member groups for
    a per-member ``epsilon``; ``x`` itself for a float."""
    if not per_member(epsilon):
        return x
    return x.reshape(epsilon.shape[0], -1, *x.shape[1:])


def _open_unit(bits):
    """U(0, 1) strictly inside the interval: the top 23 of 32 bits plus a
    half step (``k + 0.5`` is exact in f32 for ``k < 2**23``)."""
    return (torch.bitwise_right_shift(bits, 9).to(torch.float32) + 0.5) * _U23


def laplace_from_bits(bits):
    """Laplace(0, 1) by the inverse CDF of U(-1/2, 1/2): -sign(u) log1p(-2|u|).

    |u| <= 1/2 - 2**-24 (``_open_unit``), so the noise is bounded by
    ln(2**23) ~ 15.9. A uniform draw of exactly 0 would give log1p(-1) =
    -inf: the bug pinned by ``tools/repro_fused_dp_scan_nan.py`` of the JAX
    package.
    """
    u = _open_unit(bits) - 0.5
    return -torch.sign(u) * torch.log1p(-2.0 * u.abs())


def laplace_noise(shape, scale: float, gen, device="cpu"):
    """iid Laplace(0, scale) of ``shape`` drawn from ``gen`` (ref:
    torch.distributions.Laplace, models.py:54,74), or from a group of
    generators, one block of rows each."""
    return laplace_from_bits(random_bits(shape, gen, device)) * scale


def gumbel_noise(shape, gen, device="cpu"):
    """iid Gumbel(0, 1) of ``shape``: -log(-log u), u strictly inside (0, 1),
    so every draw is finite (|g| < 17); a group of generators draws one
    block of rows each."""
    return -torch.log(-torch.log(_open_unit(random_bits(shape, gen, device))))


def minmax_normalize(x):
    """Per-row min-max normalization onto [0, 1] (ref: models.py:70-72)."""
    x_min = x.amin(dim=-1, keepdim=True)
    x_max = x.amax(dim=-1, keepdim=True)
    return (x - x_min) / (x_max - x_min)


def eps_hat_prefix(w, epsilon):
    """The pre-fix noise scale log((e^eps - w) / (1 - w)), no reciprocal
    (ref: model.py:57): the ``model_dict/new_<eps>eps`` generation, whose
    noise grows with eps.

    Under the bf16 compute cast ``w`` is bf16, and the JAX package's dtype
    promotion (ops/dp.py:41-55 there) gives f32 for e^eps - w (its e^eps is
    an f32 array) but bf16 for 1 - w (a Python float against bf16); the
    quotient and the log are f32. The casts below say the same; for an f32
    ``w`` they do nothing. A per-member ``epsilon`` takes a (M, 1, F)
    ``w``."""
    return torch.log((member_exp(epsilon) - w.float()) / (1.0 - w).float())


def eps_hat(w, epsilon):
    """Per-feature noise scale 1 / log((e^eps - w) / (1 - w)) (ref:
    models.py:75, the '# fix' form). ``w`` is sigmoid(DP) in (0, 1)."""
    return 1.0 / eps_hat_prefix(w, epsilon)


def gumbel_softmax(logits, tau: float = 1.0, hard: bool = False, dim: int = -1,
                   gen=None, gumbel=None):
    """torch ``F.gumbel_softmax`` with an explicit draw: softmax((logits +
    g) / tau) with g ~ Gumbel(0, 1) from ``gen``, or ``gumbel`` as given.
    Hard: the one-hot of the argmax with the straight-through gradient,
    grouped ``y_hard + (y_soft - y_soft.detach())`` so that the forward is
    an exact one-hot (a - a == 0 in IEEE; dp.py:71-73 of the JAX package)."""
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, gen, logits.device).to(logits.dtype)
    y_soft = torch.softmax((logits + gumbel) / tau, dim=dim)
    if not hard:
        return y_soft
    index = y_soft.argmax(dim=dim, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(dim, index, 1.0)
    return y_hard + (y_soft - y_soft.detach())


def _member_w(dp_param, epsilon):
    """sigmoid(DP), as (M, 1, F) for a per-member ``epsilon``."""
    w = torch.sigmoid(dp_param)
    return w.reshape(epsilon.shape[0], 1, -1) if per_member(epsilon) else w


def lap_dropout(feature, dp_param, epsilon, hard: bool, gen=None, noise=None,
                gumbel=None, prefix_eps_hat: bool = False):
    """The flagship DP block with its Gumbel stage (ref: models.py:73-79):

      w = sigmoid(DP); feature += Laplace(0, 1) * eps_hat(w, eps)
      mask = gumbel_softmax(stack(w, 1 - w), tau=1, hard, dim=0)
      return (feature * mask).sum(0)

    feature (B, F) normalized; dp_param (1, F). The mask's halves sum to one,
    so this equals :func:`lap_dropout_fast` in value and gradient; the
    Laplace draw comes first from ``gen``, then the (2, B, F) Gumbel draw
    (per member (2, B / M, F) from its generator, for a group).
    """
    w = _member_w(dp_param, epsilon)
    if noise is None:
        noise = laplace_noise(feature.shape, 1.0, gen, feature.device)
    scale = (eps_hat_prefix if prefix_eps_hat else eps_hat)(w, epsilon)
    x = by_member(feature, epsilon) + by_member(noise, epsilon) * scale.to(feature.dtype)
    logits = torch.stack((w, 1.0 - w)).expand(2, *x.shape)
    if gumbel is None:  # the draw's rows are its second axis
        gumbel = grouped(lambda s, g: gumbel_noise((s[1], s[0], *s[2:]), g, feature.device)
                         .transpose(0, 1), (feature.shape[0], 2, *feature.shape[1:]), gen)
        gumbel = gumbel.transpose(0, 1).reshape(logits.shape).to(logits.dtype)
    mask = gumbel_softmax(logits, tau=1.0, hard=hard, dim=0, gumbel=gumbel.reshape(logits.shape))
    return (x[None] * mask).sum(dim=0).reshape(feature.shape)


def lap_dropout_fast(feature, dp_param, epsilon, noise, prefix_eps_hat: bool = False):
    """The flagship DP block with the Gumbel identity removed:
    ``feature + noise * eps_hat(sigmoid(DP), eps)`` (the pre-fix scale with
    ``prefix_eps_hat``).

    feature : (B, F) min-max-normalized features; dp_param : (1, F) logits
    ((M, 1, F) with a per-member ``epsilon``); noise : (B, F) Laplace(0, 1)
    draw.
    """
    scale = (eps_hat_prefix if prefix_eps_hat else eps_hat)(_member_w(dp_param, epsilon),
                                                           epsilon)
    out = by_member(feature, epsilon) + by_member(noise, epsilon) * scale
    return out.reshape(feature.shape)


def equal_weight_dp(feature, epsilon, dropout_rate: float, train: bool, gen=None,
                    noise=None, keep=None):
    """The equal-weight ablation (ref: models.py:399-405): ``nn.Dropout``
    at ``dropout_rate``, in training only, then one Laplace draw per sample,
    (B, 1), in eval too, at the scale lap_sigma = log((e^eps - r) / (1 - r))
    (the reciprocal of the scheme's scalar eps_hat). Draws the keep mask,
    then the noise, from ``gen``; ``keep`` (B, F) bool and ``noise`` (B, 1)
    Laplace(0, 1) hand them in."""
    if train and dropout_rate > 0.0:
        p_keep = 1.0 - dropout_rate
        if keep is None:
            keep = grouped(lambda s, g: torch.rand(s, generator=g, device=feature.device),
                           feature.shape, gen) < p_keep
        feature = torch.where(keep, feature / p_keep,
                              torch.zeros((), dtype=feature.dtype, device=feature.device))
    lap_sigma = member_scalar(
        epsilon, lambda e: _log((_exp(e) - dropout_rate) / (1.0 - dropout_rate)))
    if noise is None:
        noise = laplace_noise((feature.shape[0], 1), 1.0, gen, feature.device)
    out = by_member(feature, epsilon) + by_member(noise, epsilon) * lap_sigma
    return out.reshape(feature.shape)


def per_sample_laplace(feature, epsilon, gen=None, noise=None):
    """Min-max normalize, then one Laplace(0, 1/eps) draw per sample
    broadcast over the features (ref: train_val.py:114-123,
    main_0430.py:76-85). ``noise``: the (B, 1) Laplace(0, 1) draw."""
    feature = minmax_normalize(feature)
    if noise is None:
        noise = laplace_noise((feature.shape[0], 1), 1.0, gen, feature.device)
    out = by_member(feature, epsilon) + by_member(noise, epsilon) * member_scalar(
        epsilon, lambda e: 1.0 / e)
    return out.reshape(feature.shape)


def gumbel_dropout(x, w, tau: float = 0.1, hard: bool = True, gen=None, gumbel=None):
    """The legacy PriGumbel gate (ref: train_val.py:95-101): logits
    stack([w, 1 - w], dim=1) of shape (F, 2), the Gumbel-softmax over the
    pair, its second column (the 1 - w branch) the keep mask, kept features
    scaled by 1 / (1 - w). ``gumbel``: the (F, 2) Gumbel(0, 1) draw."""
    logits = torch.stack([w, 1.0 - w], dim=1)
    mask = gumbel_softmax(logits, tau=tau, hard=hard, dim=1, gen=gen, gumbel=gumbel)[:, 1]
    return x * mask / (1.0 - w)


def privacy_regularized_loss(ce_loss, w, alpha: float, epsilon):
    """alpha * CE + max((1 - w) e^eps + w) (ref: train_val.py:88-90); per
    member, the max over each member's (M, F) row of ``w``."""
    e = member_exp(epsilon)
    return alpha * ce_loss + ((1.0 - w) * (e.reshape(-1, 1) if per_member(epsilon) else e)
                              + w).amax(-1)
