// Philox4x32-10 (Salmon et al., SC 2011; Random123's philox4x32 with 10
// rounds), the one counter-based generator of the port's kernels: the
// attention mask (attention.cu) and the DP noise (dp_block.cu). The counter
// is (c0, c1) = the 64-bit `counter`, c2 = c3 = 0; the key is the 64-bit
// seed. ops/philox.py is its plain twin.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint4 philox4x32_10(uint64_t counter, uint64_t seed) {
  uint32_t c0 = (uint32_t)counter, c1 = (uint32_t)(counter >> 32), c2 = 0u, c3 = 0u;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}
