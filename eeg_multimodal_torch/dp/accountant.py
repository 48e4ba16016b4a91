"""RDP accountant for the subsampled Gaussian mechanism (DP-SGD).

The port's own copy of the JAX package's ``dp/accountant.py`` (pure Python
floats, no JAX: the same operations in the same order, so the two give
equal values; the port imports nothing of that package).

Mirrors the privacy accounting behind Opacus's
``PrivacyEngine.make_private_with_epsilon`` (ref: base_train.py:337-348):
given a target (epsilon, delta), sample rate q and number of steps, find the
Gaussian noise multiplier sigma by bisection on the RDP bound.

The math is the standard Mironov/Abadi RDP analysis of the Poisson-subsampled
Gaussian mechanism (Mironov, "Renyi Differential Privacy", 2017; Mironov et
al., "RDP of the Sampled Gaussian Mechanism", 2019 — public literature, same
analysis Opacus implements):

  RDP of Gaussian with multiplier sigma at order a:  a / (2 sigma^2)
  Subsampled at rate q: computed via the log-binomial expansion for integer
  orders, with the standard stable log-sum-exp accumulation.
  Conversion to (eps, delta): eps = min_a [ rdp(a) + log1p(-1/a)
                                           - log(delta * a) / (a - 1) ]
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

DEFAULT_ORDERS = tuple([1 + x / 10.0 for x in range(1, 100)] + list(range(12, 64)))


def _log_comb(n: int, k: int) -> float:
    return (
        math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)
    )


def _rdp_subsampled_gaussian_int(q: float, sigma: float, alpha: int) -> float:
    """RDP at integer order alpha for the sampled Gaussian mechanism."""
    # log E[( (1-q) + q e^{(2j-1)/(2 sigma^2)} ) ] expansion:
    # A(alpha) = sum_j C(alpha, j) (1-q)^{alpha-j} q^j e^{j(j-1)/(2 sigma^2)}
    log_terms = []
    for j in range(alpha + 1):
        log_t = (
            _log_comb(alpha, j)
            + j * math.log(q)
            + (alpha - j) * math.log1p(-q)
            + (j * j - j) / (2.0 * sigma * sigma)
        )
        log_terms.append(log_t)
    m = max(log_terms)
    s = sum(math.exp(t - m) for t in log_terms)
    return (m + math.log(s)) / (alpha - 1)


def _log_add(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    m, n = max(a, b), min(a, b)
    return m + math.log1p(math.exp(n - m))


def _log_sub(a: float, b: float) -> float:
    """log(e^a - e^b), requires a >= b."""
    if b == -math.inf:
        return a
    if a == b:
        return -math.inf
    return a + math.log1p(-math.exp(b - a))


def _log_erfc(x: float) -> float:
    try:
        return math.log(math.erfc(x))
    except ValueError:  # erfc underflow for large x: asymptotic expansion
        return (
            -(x * x)
            - math.log(x)
            - 0.5 * math.log(math.pi)
            + math.log1p(-0.5 / (x * x))
        )


def _log_binom(alpha: float, i: int) -> float:
    """log |binom(alpha, i)| with the sign for non-integer alpha.
    Returns (log_abs, sign)."""
    log_abs = 0.0
    sign = 1.0
    for k in range(i):
        term = (alpha - k) / (k + 1)
        if term == 0.0:
            return -math.inf, 1.0
        if term < 0:
            sign = -sign
        log_abs += math.log(abs(term))
    return log_abs, sign


def _rdp_subsampled_gaussian_frac(q: float, sigma: float, alpha: float) -> float:
    """Exact RDP at fractional order via the two-sided series of Mironov,
    Talwar & Zhang, "RDP of the Sampled Gaussian Mechanism" (2019), sec. 3.3
    — the same computation Opacus/TF-Privacy run for non-integer orders.

    A(alpha) splits at z0 = sigma^2 log(1/q - 1) + 1/2 into two integrals,
    each expanded as a binomial series in (q, 1-q) with Gaussian-tail
    (erfc) weights; terms alternate in sign for non-integer alpha."""
    log_a0, log_a1 = -math.inf, -math.inf
    z0 = sigma * sigma * math.log(1.0 / q - 1.0) + 0.5
    i = 0
    while True:
        log_coef, sign = _log_binom(alpha, i)
        j = alpha - i
        log_t0 = log_coef + i * math.log(q) + j * math.log1p(-q)
        log_t1 = log_coef + j * math.log(q) + i * math.log1p(-q)
        log_e0 = math.log(0.5) + _log_erfc((i - z0) / (math.sqrt(2.0) * sigma))
        log_e1 = math.log(0.5) + _log_erfc((z0 - j) / (math.sqrt(2.0) * sigma))
        log_s0 = log_t0 + (i * i - i) / (2.0 * sigma * sigma) + log_e0
        log_s1 = log_t1 + (j * j - j) / (2.0 * sigma * sigma) + log_e1
        if sign > 0:
            log_a0 = _log_add(log_a0, log_s0)
            log_a1 = _log_add(log_a1, log_s1)
        else:
            log_a0 = _log_sub(log_a0, log_s0)
            log_a1 = _log_sub(log_a1, log_s1)
        i += 1
        if max(log_s0, log_s1) < -30 and i > alpha:
            break
    return _log_add(log_a0, log_a1) / (alpha - 1)


def compute_rdp(q: float, noise_multiplier: float, steps: int,
                orders: Sequence[float] = DEFAULT_ORDERS):
    """Total RDP over `steps` compositions at each order."""
    sigma = noise_multiplier
    if q == 0 or sigma == 0:
        return [float("inf")] * len(orders)
    out = []
    for a in orders:
        if q == 1.0:
            rdp = a / (2 * sigma * sigma)
        elif a <= 1:
            rdp = float("inf")
        elif float(a).is_integer():
            rdp = _rdp_subsampled_gaussian_int(q, sigma, int(a))
        else:
            rdp = _rdp_subsampled_gaussian_frac(q, sigma, a)
        out.append(rdp * steps)
    return out


def rdp_to_epsilon(rdp: Iterable[float], delta: float,
                   orders: Sequence[float] = DEFAULT_ORDERS) -> float:
    """Tightest (eps, delta) conversion over orders (Balle et al. 2020 form,
    as used by Opacus/TF-Privacy)."""
    best = float("inf")
    for a, r in zip(orders, rdp):
        if a <= 1 or math.isinf(r):
            continue
        eps = r + math.log1p(-1.0 / a) - (math.log(delta) + math.log(a)) / (a - 1)
        best = min(best, max(eps, 0.0))
    return best


def epsilon(q: float, noise_multiplier: float, steps: int, delta: float) -> float:
    return rdp_to_epsilon(compute_rdp(q, noise_multiplier, steps), delta)


def get_noise_multiplier(
    target_epsilon: float,
    target_delta: float,
    sample_rate: float,
    epochs: Optional[int] = None,
    steps: Optional[int] = None,
    precision: float = 0.01,
    max_sigma: float = 2000.0,
) -> float:
    """Bisection for sigma hitting target_epsilon — the Opacus
    ``get_noise_multiplier`` contract (ref usage: base_train.py:340-348 with
    delta = 1/len(train_dataloader), epochs=50)."""
    if steps is None:
        if epochs is None:
            raise ValueError("need epochs or steps")
        steps = int(math.ceil(epochs / sample_rate))
    lo, hi = 1e-3, 10.0
    while epsilon(sample_rate, hi, steps, target_delta) > target_epsilon:
        hi *= 2
        if hi > max_sigma:
            raise ValueError("cannot reach target epsilon")
    while hi - lo > precision:
        mid = (lo + hi) / 2
        if epsilon(sample_rate, mid, steps, target_delta) < target_epsilon:
            hi = mid
        else:
            lo = mid
    return hi
