// What the attention kernels share: the launch parameters, the dropout
// mask's Philox grouping, the SFU exponential and the backward's row
// statistics' type. attention.cu holds the f32 kernels, the mask hook and the C
// interface; attention_bf16.cu the bf16 kernels, which the C interface calls
// through fwd_bf16 / bwd_bf16.
#pragma once

#include <cuda_runtime.h>
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
  float* delta;  // scratch: (B, H, S); bf16: (B, H, S, 4) (m, 1 / l, delta, 0), then the mask
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

// The bf16 kernels (attention_bf16.cu), for D = 64 or 128: the C interface
// hands them a bf16 call with the tensors' pointers and strides in p.
cudaError_t fwd_bf16(const Params& p, int D, cudaStream_t stream);
cudaError_t bwd_bf16(const Params& p, int D, cudaStream_t stream);

}  // namespace eeg_attn
