"""Philox4x32-10 on Python ints, written from the paper's round function
(Salmon et al., SC'11): the independent yardstick of the port's Philox, for
the DP noise and the attention keep mask alike."""

MASK32 = 0xFFFFFFFF


def philox_py(counter, key):
    """The four 32-bit words of Philox4x32-10 at ``counter`` (four words)
    keyed by ``key`` (two words)."""
    c, (k0, k1) = list(counter), key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & MASK32, p1 & MASK32,
             ((p0 >> 32) ^ c[3] ^ k1) & MASK32, p0 & MASK32]
        k0, k1 = (k0 + 0x9E3779B9) & MASK32, (k1 + 0xBB67AE85) & MASK32
    return c
