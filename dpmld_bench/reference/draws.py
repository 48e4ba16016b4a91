"""The random draws a run makes, by the laws the program documents.

Frozen plain copies, so that the reference makes every draw again from the
run's seed and takes none from the program:

- sub-seeds: FNV-1a of each name folded into the seed (``utils/seeding``);
- the epoch: a ``torch.randperm`` of the rows from a CPU generator, the last
  batch padded with row 0 and weighted out (``data/datasets.epoch_indices``);
- dropout: ``torch.rand(shape) < 1 - p`` from the step's generator, the
  kept values scaled by 1 / (1 - p) (``models/layers.dropout``);
- an attention call's seed: ``torch.randint(0, 2**31 - 1, (1,))`` from the
  step's generator; its keep mask is Philox4x32-10 of (seed, b, h, i, j) on
  the card (``ops/attention.keep_mask_plain``) and, on the CPU,
  ``randint(0, 2**32)`` from a CPU generator seeded with the seed
  (``ops/attention.seeded_keep``), kept where ``(bits >> 8) < (1 - p) 2^24``;
- the composed DP block's Laplace(0, 1) noise: 32-bit draws from the step's
  generator through the inverse CDF (``ops/dp.laplace_noise``);
- the fused DP block's noise: a seed drawn as an attention call's, then
  element n takes word n & 3 of Philox4x32-10 at counter n & ~3
  (``ops/dp_fused.laplace_plain``).

Philox4x32-10 is Salmon et al., SC 2011 (Random123), 10 rounds.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF
_U23 = 1.0 / (1 << 23)


def _fnv(name: str) -> int:
    h = 2166136261
    for b in name.encode():
        h = ((h ^ b) * 16777619) & MASK32
    return h


def derive_seed(seed: int, *names) -> int:
    """The sub-seed of ``seed`` for a path of names."""
    h = seed & MASK64
    for name in names:
        h = (h * 1099511628211 ^ _fnv(str(name))) & 0x7FFFFFFFFFFFFFFF
    return h


def generator(seed: int, device="cpu") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def epoch_generator(seed: int, epoch: int, name: str, device="cpu") -> torch.Generator:
    return generator(derive_seed(seed, "epoch", epoch, name), device)


def epoch_order(n: int, batch: int, seed: int, epoch: int, shuffle: bool = True):
    """(idx (n_batches, batch), weight (n_batches, batch)) on the CPU."""
    n_batches = -(-n // batch)
    perm = (torch.randperm(n, generator=epoch_generator(seed, epoch, "shuffle"))
            if shuffle else torch.arange(n))
    pad = n_batches * batch - n
    idx = torch.cat([perm, torch.zeros(pad, dtype=perm.dtype)])
    weight = torch.cat([torch.ones(n), torch.zeros(pad)])
    return idx.reshape(n_batches, batch), weight.reshape(n_batches, batch)


# -- Philox4x32-10 ---------------------------------------------------------
_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a, m: int):
    x, y = a * (m & 0xFFFF), a * (m >> 16)
    return (y + (x >> 16)) >> 16, (x + ((y & 0xFFFF) << 16)) & MASK32


def philox_words(counter, seed: int):
    """The four 32-bit words (int64, last axis) of Philox4x32-10 at the
    64-bit counters ``counter`` (c0, c1 its halves, c2 = c3 = 0) keyed by
    the 64-bit ``seed``."""
    seed = int(seed) & MASK64
    c0, c1 = counter & MASK32, counter >> 32
    c2 = c3 = torch.zeros_like(counter)
    k0, k1 = seed & MASK32, seed >> 32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M[0])
        hi1, lo1 = _mulhilo(c2, _M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W[0]) & MASK32, (k1 + _W[1]) & MASK32
    return torch.stack((c0, c1, c2, c3), dim=-1)


# -- the samplers ----------------------------------------------------------
def laplace_from_bits(bits):
    """Laplace(0, 1) of uniform 32-bit draws: -sign(u) log1p(-2|u|), u the
    top 23 bits plus a half step, less 1/2."""
    u = (torch.bitwise_right_shift(bits, 9).to(torch.float32) + 0.5) * _U23 - 0.5
    return -torch.sign(u) * torch.log1p(-2.0 * u.abs())


def laplace_composed(shape, gen, device):
    bits = torch.randint(0, 1 << 32, shape, generator=gen, dtype=torch.int64, device=device)
    return laplace_from_bits(bits)


def laplace_philox(seed: int, shape, device):
    numel = math.prod(shape)
    counters = torch.arange(0, numel, 4, dtype=torch.int64, device=device)
    return laplace_from_bits(philox_words(counters, seed).reshape(-1)[:numel]).reshape(shape)


def draw_seed(gen, device):
    return torch.randint(0, 2**31 - 1, (1,), generator=gen, device=device)


def keep_threshold(rate: float) -> int:
    return int((1.0 - rate) * (1 << 24))


def attention_keep(seed: int, B: int, H: int, S: int, rate: float, device):
    """The (B, H, S, S) keep mask of an attention call with ``seed``, on
    ``device``'s law (module docstring)."""
    device = torch.device(device)
    if device.type == "cpu":
        bits = torch.randint(0, 1 << 32, (B, H, S, S), generator=generator(seed),
                             dtype=torch.int64)
        return torch.bitwise_right_shift(bits, 8) < keep_threshold(rate)
    # element (i, j) reads word 2 ((i >> 3) & 1) + (j & 1) of the call at
    # counter ((b H + h) S + i0) S + j0, i0 = (i & ~15) | (i & 7), j0 = j & ~1:
    # one call serves rows {i0, i0 + 8} x columns {j0, j0 + 1}
    i = torch.arange(S, dtype=torch.int64, device=device)
    rows = i[(i & 8) == 0]  # the distinct i0
    cols = torch.arange(0, S, 2, dtype=torch.int64, device=device)
    bh = torch.arange(B * H, dtype=torch.int64, device=device).reshape(B, H, 1, 1)
    counters = (bh * S + rows.reshape(1, 1, -1, 1)) * S + cols.reshape(1, 1, 1, -1)
    words = philox_words(counters, seed)  # (B, H, rows, cols, 4)
    pos = (i >> 4) * 8 + (i & 7)  # the row of i0 among ``rows``
    word = 2 * ((i >> 3) & 1).reshape(S, 1) + (i & 1).reshape(1, S)
    bits = words[:, :, pos.reshape(S, 1), (i >> 1).reshape(1, S), word]
    return torch.bitwise_right_shift(bits, 8) < keep_threshold(rate)


class Draws:
    """The draws of one forward from ``gen`` (None: no dropout, as in eval),
    in the program's order; ``fused_dp`` picks the fused block's noise law.
    ``dp_gen`` is the generator the DP block draws from (``gen`` in
    training, the eval generator in eval)."""

    def __init__(self, gen, dp_gen, device, fused_dp: bool, hidden_p=0.1, attn_p=0.1):
        self.gen, self.dp_gen, self.device = gen, dp_gen, torch.device(device)
        self.fused_dp = fused_dp
        self.hidden_p, self.attn_p = hidden_p, attn_p

    def dropout(self, x, p=None):
        p = self.hidden_p if p is None else p
        if self.gen is None or p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.gen, device=self.device) < 1.0 - p
        return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))

    def attention_keep(self, B, H, S):
        """The keep mask of a BERT attention call, None without dropout."""
        if self.gen is None or self.attn_p == 0.0:
            return None
        seed = int(draw_seed(self.gen, self.device).item())
        return attention_keep(seed, B, H, S, self.attn_p, self.device)

    def dp_noise(self, shape):
        if self.fused_dp:
            seed = int(draw_seed(self.dp_gen, self.device).item())
            return laplace_philox(seed, shape, self.device)
        return laplace_composed(shape, self.dp_gen, self.device)
