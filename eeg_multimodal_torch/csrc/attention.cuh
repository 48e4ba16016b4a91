// What the attention kernels share: the launch parameters, the dropout
// mask's Philox grouping, the SFU exponential, the scores' scaling, the
// backward's row statistics and softmax gradient, and the mask bytes that
// the dQ kernels leave for dK/dV. attention.cu holds the mask hook and the C
// interface, which calls the f32 kernels (attention_f32.cu) through
// fwd_f32 / bwd_f32 and the bf16 ones (attention_bf16.cu) through
// fwd_bf16 / bwd_bf16.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace eeg_attn {

struct Params {
  const void *q, *k, *v, *o, *dout;
  int64_t qs[3], ks[3], vs[3], ds[3];  // (b, h, s) strides in elements
  const float* bias;                   // (B, S)
  const int64_t* seed;                 // G elements, one per rows_per_seed batch rows
  void *out, *dq, *dk, *dv;            // (B, S, H, D)
  float* stats;                        // (2, B, H, S): row max m, row sum l
  float* delta;  // scratch: (B, H, S, 4) (m, 1 / l, delta, 0), then the mask bytes
  int B, H, S, rows_per_seed;  // rows_per_seed = B_all / G
  int b0, h0, H_all;           // the block's first global row and head, the global heads
  float scale, keep_prob, inv_keep;  // inv_keep = 1 / keep_prob
  uint32_t threshold;
  int dropout;
};

// exp(x) as 2^(x log2 e) on the SFU; exp(-inf) = 0
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The dropout mask: the one function every kernel and the test hook call,
// so they agree bit for bit. One Philox4x32-10 call serves the group of rows
// {i0, i0 + 8} x columns {j0, j0 + 1}, with i0 = (i & ~15) | (i & 7) and
// j0 = j & ~1: the four elements one thread holds of each 8-column group of
// an m16n8 (mma.sync) or m64nN (wgmma) accumulator whose rows start at a
// multiple of 16. The counter is ((b' H + h) S + i0) S + j0 (mask_base =
// (b' H + h) S, with b, h and H the global row, head and head count and
// b' = b mod rows_per_seed, the row within its seed's group); element
// (i, j) takes word 2 ((i >> 3) & 1) + (j & 1), its place c0..c3 in the
// fragment. So the mask depends on (seed, b, h, i, j) alone, never on the
// tiling. Bit e of the result is set when fragment element e is kept.
// The seed and mask_base of launch row b, head h: global row b0 + b, head
// h0 + h.
__device__ __forceinline__ uint64_t mask_seed(const int64_t* seed, int b0, int b,
                                              int rows_per_seed) {
  return (uint64_t)seed[(b0 + b) / rows_per_seed];
}
__device__ __forceinline__ uint64_t mask_base_of(int b0, int b, int rows_per_seed, int H_all,
                                                 int h0, int h, int S) {
  return (uint64_t)(((b0 + b) % rows_per_seed) * H_all + h0 + h) * S;
}

// The four words of the Philox call of group (i0, j0)
__device__ __forceinline__ uint4 mask_words(uint64_t mask_base, int S, int i0, int j0,
                                            uint64_t seed) {
  return philox4x32_10((mask_base + (uint64_t)i0) * (uint64_t)S + (uint64_t)j0, seed);
}

__device__ __forceinline__ bool kept(uint32_t word, uint32_t threshold) {
  return (word >> 8) < threshold;
}

__device__ __forceinline__ uint32_t keep_bits(uint64_t mask_base, int S, int i0, int j0,
                                              uint64_t seed, uint32_t threshold) {
  const uint4 w = mask_words(mask_base, S, i0, j0, seed);
  return (uint32_t)kept(w.x, threshold) | ((uint32_t)kept(w.y, threshold) << 1) |
         ((uint32_t)kept(w.z, threshold) << 2) | ((uint32_t)kept(w.w, threshold) << 3);
}

// The forward's row max m, 1 / row sum l and the pre-pass's delta of a
// query row, as the backward kernels use them
struct RowStats {
  float m, inv_l, delta;
};

// kept(word, threshold) as one compare: (word >> 8) < threshold is word <
// threshold * 256, which fits in 32 bits at any rate above 0 (the only
// rates that draw; without dropout the words are 0 and threshold8 all ones)
__device__ __forceinline__ bool kept8(uint32_t word, uint32_t threshold8) {
  return word < threshold8;
}

// word e (0..3) of a Philox call: the word of fragment element e
__device__ __forceinline__ uint32_t word(const uint4& w, int e) {
  return e == 0 ? w.x : e == 1 ? w.y : e == 2 ? w.z : w.w;
}

// s * scale + bias[key] of the thread's score elements of the tile at key
// k0, in place, and the row maxima of its two rows into mt; with EDGE the
// keys past S get -inf
template <int BK, bool EDGE>
__device__ __forceinline__ void scale_scores(float (&s)[BK / 2], const float* bias, int k0,
                                             int t, int S, float scale, float (&mt)[2]) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = k0 + n * 8 + 2 * t + c;
      const float bj = !EDGE || j < S ? __ldg(bias + j) : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = s[4 * n + 2 * r + c];
        x = EDGE && j >= S ? -INFINITY : x * scale + bj;
        mt[r] = fmaxf(mt[r], x);
      }
    }
}

// The dropout mask, from the dQ kernel to the dK/dV kernel: the scratch
// after the rows' statistics holds, for every pair of Philox groups of
// rows i0 and i0 + 1 (i0 even, bit 3 clear) and columns {j0, j0 + 1}, one
// byte: the keep bits of row i0's call in the low nibble, of row i0 + 1's
// in the high one (bit e of a nibble: word e kept). Bytes lie by (b, h),
// pair row (4 per 16 rows, 16 per 64), 64-key tile, then in a tile's 32
// bytes (t, n) at t * 8 + n for columns j0 = 8 n + 2 t of the tile: the
// bytes a dQ thread writes for a tile of 64 keys are one 8-byte word (for
// 32 keys one 4-byte word, for 16 one 2-byte word).
__device__ __forceinline__ uint8_t* mask_bytes(const Params& p) {
  return reinterpret_cast<uint8_t*>(p.delta) + (int64_t)p.B * p.H * p.S * 16;
}
__device__ __forceinline__ int64_t mask_byte(const Params& p, int bh, int i0, int j0) {
  const int tiles = (p.S + 63) / 64, jt = j0 & 63;
  const int64_t pair_row = (int64_t)bh * tiles * 16 + (i0 >> 4) * 4 + ((i0 & 7) >> 1);
  return (pair_row * tiles + (j0 >> 6)) * 32 + ((jt >> 1) & 3) * 8 + (jt >> 3);
}

// query row i's statistics from the pre-pass (placeholders past S, where
// nothing is used)
__device__ __forceinline__ RowStats stats_of(const Params& p, uint64_t head_base, int i) {
  if (i >= p.S) return {0.f, 0.f, 0.f};
  const float4 r = __ldg(reinterpret_cast<const float4*>(p.delta) + head_base + i);
  return {r.x, r.y, r.z};
}

// p, p_drop and dS of one score element from the score s, dP and the
// query row's statistics: returns p_drop and dS, 0 outside S x S (rounded
// to bf16 when packed)
__device__ __forceinline__ void softmax_grad(const Params& p, float s, float dp, float bias,
                                             const RowStats& r, bool keep, bool in, float& pd,
                                             float& ds) {
  pd = ds = 0.f;
  if (!in) return;
  const float pr = fast_exp(s * p.scale + bias - r.m) * r.inv_l;
  float dpm = dp, prd = pr;
  if (p.dropout) {
    prd = keep ? pr * p.inv_keep : 0.f;
    dpm = keep ? dpm * p.inv_keep : 0.f;
  }
  pd = prd;
  ds = pr * (dpm - r.delta);
}

// The keep bits of a thread's elements of the transposed score tile S^T
// (keys x queries) in one 16-query block, from the dQ kernel's bytes: key
// j and queries a, a + 1, a + 8, a + 9 (a = q16 + 2t), bit c for the c-th.
// Rows a and a + 1 are one byte's low and high nibbles; a + 8 is word 2 of
// row a's call. keep_of_byte takes the bits of key j from the byte.
__device__ __forceinline__ uint32_t keep_of_byte(uint32_t byte, int j) {
  byte >>= j & 1;
  return (byte & 1u) | ((byte >> 3) & 2u) | (byte & 4u) | ((byte >> 3) & 8u);
}
__device__ __forceinline__ uint32_t dkdv_keep(const Params& p, int bh, int a, int j) {
  return keep_of_byte(__ldg(mask_bytes(p) + mask_byte(p, bh, a, j & ~1)), j);
}


// The f32 kernels (attention_f32.cu) and the bf16 ones (attention_bf16.cu),
// for D = 64 or 128: the C interface hands them a call with the tensors'
// pointers and strides in p. The backward's scratch p.delta holds B H S
// float4 (m, 1 / l, delta, 0), then the mask bytes (mask_byte).
cudaError_t fwd_f32(const Params& p, int D, cudaStream_t stream);
cudaError_t bwd_f32(const Params& p, int D, cudaStream_t stream);
cudaError_t fwd_bf16(const Params& p, int D, cudaStream_t stream);
cudaError_t bwd_bf16(const Params& p, int D, cudaStream_t stream);

}  // namespace eeg_attn
