"""Philox4x32-10 on int64 tensors: the plain twin of ``csrc/philox.cuh``.

Salmon et al., SC 2011; Random123's philox4x32 with 10 rounds. The kernels
draw their random bits with the device function of ``csrc/philox.cuh``; the
plain versions of the attention mask (``ops/attention.py``) and of the DP
noise (``ops/dp_fused.py``) call this one, so that a seed gives the same
bits on the CPU and on the card.
"""
import torch

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF


def _mulhilo(a, m: int):
    """(high, low) 32-bit words of a * m, a an int64 tensor of 32-bit words:
    m is split in 16-bit halves so that no product passes 2^48."""
    x, y = a * (m & 0xFFFF), a * (m >> 16)
    return (y + (x >> 16)) >> 16, (x + ((y & 0xFFFF) << 16)) & MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 of ``counter`` = (c0, c1, c2, c3) and ``key`` = (k0, k1),
    each word an int64 tensor or int in [0, 2^32); returns the four output
    words as int64 tensors. The kernels' ``philox4x32_10`` with c2 = c3 = 0."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & MASK32, (k1 + _PHILOX_W[1]) & MASK32
    return c0, c1, c2, c3


def philox_words(counter, seed: int):
    """The four words of the kernels' call ``philox4x32_10(counter, seed)``
    for an int64 tensor of 64-bit counters, stacked on a last axis of 4: the
    counter's low and high halves are c0 and c1, the 64-bit seed's are the
    key."""
    seed = int(seed) & MASK64
    return torch.stack(philox4x32_10((counter & MASK32, counter >> 32, 0, 0),
                                     (seed & MASK32, seed >> 32)), dim=-1)
