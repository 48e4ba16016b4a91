// Fused BERT self-attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in ops/attention.py:
// `_fwd_kernel` (forward) and `_bwd_kernel` (backward). They compute
//
//   s      = q k^T * scale + bias[key]          (f32 scores, bias 0 or finfo.min)
//   p      = exp(s - max_row s) / sum_row        (the stable softmax)
//   p_drop = keep ? p / (1 - rate) : 0,  keep = (bits >> 8) < (1 - rate) 2^24
//   out    = round_T(p_drop) v                   (f32 accumulation)
//
// and its gradient, regenerating the dropout mask from the seed instead of
// storing it. T is float or bf16; all arithmetic is f32, and with T = bf16
// the values are rounded where the JAX kernel casts to the input dtype
// (P before P.V; P_drop, dO and dS before their products).
//
// What bounds it on the H100: operations. At the 512-token path's
// (8, 12, 512, 64) f32 the forward needs 4 B H S^2 D = 6.44 GFLOP, 96 us at
// the 67 TFLOP/s f32 (non-tensor-core) peak, against 50 MB of q, k, v and
// out (15 us at 3.35 TB/s); the backward 10 B H S^2 D = 16.1 GFLOP, 240 us.
// f32 has no true-f32 tensor-core path (TF32 would break the reference's
// Precision.HIGHEST), so the f32 kernels run FMAs on the CUDA cores.
//
// Design (a simple kernel that is right; wgmma, TMA and warp
// specialisation are later work): the TPU kernel keeps one head's whole
// 512 x 512 score matrix in VMEM; a Hopper block has 227 KB of shared
// memory, so these kernels tile over queries and keys (64 x 64 tiles, 256
// threads as a 16 x 16 grid, each thread a 4 x 4 register tile of scores)
// and never write a score to device memory.
//  - forward: one block per (64-query tile, head, batch row), two passes
//    over the key tiles: (1) the row max and sum, (2) p = exp(s - m) / l,
//    dropout, P.V. Saves the row max m and sum l for the backward (not
//    lse = m + log l: in a row whose keys are all masked m is finfo.min,
//    which absorbs log l, and exp(s - lse) would give 1, not 1 / S).
//  - backward: a pre-pass computes delta = rowsum(dO * O), which equals
//    rowsum(dP * P_drop) with or without dropout; then `dkdv` (one block per
//    key tile, looping over the query tiles) and `dq` (one block per query
//    tile, looping over the key tiles) each recompute s and
//    p = exp(s - m) / l and regenerate the mask. Deterministic, no atomics.
//  - dropout bits: Philox4x32-10 of the element's flat index
//    ((b H + h) S + i) S + j as a 64-bit counter, keyed by the seed, a
//    one-element int64 device tensor read here (no host sync).
//  - q, k, v and dO come in as (B, H, S, D) views with any (b, h, s)
//    strides and a unit last stride, so the packed QKV projection needs no
//    copies; out, dq, dk and dv are written as (B, S, H, D), so the caller's
//    reshape to (B, S, H * D) is free.
//  - a row whose keys are all masked has scores that all round to
//    finfo.min, so its softmax is uniform, as the einsum gives; nothing
//    special-cases -inf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block, a 16 x 16 grid
constexpr int TR = BQ / 16;   // rows of a thread's register tile
constexpr int TC = BK / 16;   // columns of a thread's register tile
constexpr int LDP = BK + 1;   // padded row of a probability tile

struct Params {
  const void *q, *k, *v, *o, *dout;
  int64_t qs[3], ks[3], vs[3], ds[3];  // (b, h, s) strides in elements
  const float* bias;                   // (B, S)
  const int64_t* seed;                 // one element
  void *out, *dq, *dk, *dv;            // (B, S, H, D)
  float* stats;                        // (2, B, H, S): row max m, row sum l
  float* delta;                        // (B, H, S)
  int B, H, S;
  float scale, keep_prob;
  uint32_t threshold;
  int dropout;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the value of x once cast to T (the JAX kernel's `.astype(dt)`)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ uint32_t philox_bits(uint64_t counter, uint64_t seed) {
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
  return c0;
}

// The dropout mask: the one function the forward, both backward kernels and
// the test hook call, so they agree bit for bit.
__device__ __forceinline__ bool keep_elem(uint64_t idx, uint64_t seed, uint32_t threshold) {
  return (philox_bits(idx, seed) >> 8) < threshold;
}

// Copy a (64, D) tile of rows row0.. of a (S, D) matrix with row stride
// `ld` into shared memory as f32 with a padded row; rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t ld, int row0, int S) {
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, c = e % D, row = row0 + r;
    dst[r * (D + 1) + c] = row < S ? to_f32(src[(int64_t)row * ld + c]) : 0.f;
  }
}

// acc[r][c] = sum_d A[ty + 16 r][d] * B[tx + 16 c][d] over two (64, D) tiles
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm, int ty, int tx,
                                         float acc[TR][TC]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[TR], b[TC];
#pragma unroll
    for (int r = 0; r < TR; ++r) a[r] = A[(ty + 16 * r) * LD + d];
#pragma unroll
    for (int c = 0; c < TC; ++c) b[c] = Bm[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) attn_fwd_kernel(const Params p) {
  constexpr int LD = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, S = p.S, H = p.H;
  const T* q = (const T*)p.q + b * p.qs[0] + h * p.qs[1];
  const T* k = (const T*)p.k + b * p.ks[0] + h * p.ks[1];
  const T* v = (const T*)p.v + b * p.vs[0] + h * p.vs[1];
  const float* bias = p.bias + (int64_t)b * S;
  const uint64_t seed = (uint64_t)p.seed[0];
  const uint64_t head_base = (uint64_t)(b * H + h) * S;
  const int n_tiles = (S + BK - 1) / BK;

  load_tile<T, D>(sQ, q, p.qs[2], q0, S);
  float m[TR], l[TR], s[TR][TC];
#pragma unroll
  for (int r = 0; r < TR; ++r) m[r] = -INFINITY, l[r] = 0.f;

  // pass 1: row max and sum, online over the key tiles
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<T, D>(sK, k, p.ks[2], k0, S);
    __syncthreads();
    tile_dot<D>(sQ, sK, ty, tx, s);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int j = k0 + tx + 16 * c;
        s[r][c] = j < S ? s[r][c] * p.scale + bias[j] : -INFINITY;
        mt = fmaxf(mt, s[r][c]);
      }
      if (mt > m[r]) {
        l[r] = m[r] == -INFINITY ? 0.f : l[r] * expf(m[r] - mt);
        m[r] = mt;
      }
#pragma unroll
      for (int c = 0; c < TC; ++c)
        if (s[r][c] != -INFINITY) l[r] += expf(s[r][c] - m[r]);
    }
  }
  // combine the 16 threads of a row (16 neighbouring lanes of one warp)
#pragma unroll
  for (int r = 0; r < TR; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      l[r] = (m[r] == -INFINITY ? 0.f : l[r] * expf(m[r] - mn)) +
             (mo == -INFINITY ? 0.f : lo * expf(mo - mn));
      m[r] = mn;
    }
  }

  // pass 2: p = exp(s - m) / l, dropout, round to T, out += P V
  float o[TR][DC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) o[r][c] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<T, D>(sK, k, p.ks[2], k0, S);
    load_tile<T, D>(sV, v, p.vs[2], k0, S);
    __syncthreads();
    tile_dot<D>(sQ, sK, ty, tx, s);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int i = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int j = k0 + tx + 16 * c;
        float pr = 0.f;
        if (j < S && i < S) {
          pr = expf(s[r][c] * p.scale + bias[j] - m[r]) / l[r];
          if (p.dropout)
            pr = keep_elem((head_base + i) * S + j, seed, p.threshold) ? pr / p.keep_prob : 0.f;
        }
        sP[(ty + 16 * r) * LDP + tx + 16 * c] = round_to<T>(pr);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < BK; ++jj) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sV[jj * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float pr = sP[(ty + 16 * r) * LDP + jj];
#pragma unroll
        for (int c = 0; c < DC; ++c) o[r][c] = fmaf(pr, vv[c], o[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= S) continue;
    T* out = (T*)p.out + (((int64_t)b * S + i) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) out[tx + 16 * c] = from_f32<T>(o[r][c]);
    if (tx == 0) {
      p.stats[head_base + i] = m[r];
      p.stats[(int64_t)p.B * H * S + head_base + i] = l[r];
    }
  }
}

// delta[b, h, i] = sum_d dO[b, h, i, d] * O[b, h, i, d], one warp per row
template <typename T, int D>
__global__ void __launch_bounds__(NT) attn_delta_kernel(const Params p) {
  const int64_t row = (int64_t)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int S = p.S, H = p.H;
  if (row >= (int64_t)p.B * H * S) return;
  const int i = (int)(row % S), h = (int)((row / S) % H), b = (int)(row / ((int64_t)S * H));
  const T* dout = (const T*)p.dout + b * p.ds[0] + h * p.ds[1] + i * p.ds[2];
  const T* o = (const T*)p.o + (((int64_t)b * S + i) * H + h) * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(dout[d]), to_f32(o[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// the forward's row max and sum and the pre-pass's delta of query row i
// (placeholders past S, where nothing is written)
__device__ __forceinline__ void load_row_stats(const Params& p, uint64_t head_base, int i,
                                               float& rmax, float& rsum, float& delta) {
  const bool in = i < p.S;
  rmax = in ? p.stats[head_base + i] : 0.f;
  rsum = in ? p.stats[(int64_t)p.B * p.H * p.S + head_base + i] : 1.f;
  delta = in ? p.delta[head_base + i] : 0.f;
}

// p, p_drop and dS of one (query tile, key tile) pair, from the scores s
// and dP = dO V^T; writes round_T(p_drop) to sPd (when given) and round_T(dS)
// to sdS, both indexed [query][key].
template <typename T>
__device__ __forceinline__ void softmax_grad_tile(const Params& p, float s[TR][TC],
                                                  float dp[TR][TC], const float* rmax,
                                                  const float* rsum, const float* delta,
                                                  int q0, int k0,
                                                  uint64_t head_base, const float* bias,
                                                  uint64_t seed, float* sPd, float* sdS) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, S = p.S;
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int il = ty + 16 * r, i = q0 + il;
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int jl = tx + 16 * c, j = k0 + jl;
      float pd = 0.f, ds = 0.f;
      if (i < S && j < S) {
        const float pr = expf(s[r][c] * p.scale + bias[j] - rmax[r]) / rsum[r];
        float dpm = dp[r][c];
        pd = pr;
        if (p.dropout) {
          const bool keep = keep_elem((head_base + i) * S + j, seed, p.threshold);
          pd = keep ? pr / p.keep_prob : 0.f;
          dpm = keep ? dpm / p.keep_prob : 0.f;
        }
        ds = pr * (dpm - delta[r]);
      }
      if (sPd) sPd[il * LDP + jl] = round_to<T>(pd);
      sdS[il * LDP + jl] = round_to<T>(ds);
    }
  }
}

// dK and dV of one key tile: loops over the query tiles
template <typename T, int D>
__global__ void __launch_bounds__(NT) attn_dkdv_kernel(const Params p) {
  constexpr int LD = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sdO = sQ + BQ * LD;
  float* sPd = sdO + BQ * LD;
  float* sdS = sPd + BQ * LDP;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z, S = p.S, H = p.H;
  const T* q = (const T*)p.q + b * p.qs[0] + h * p.qs[1];
  const T* k = (const T*)p.k + b * p.ks[0] + h * p.ks[1];
  const T* v = (const T*)p.v + b * p.vs[0] + h * p.vs[1];
  const T* dout = (const T*)p.dout + b * p.ds[0] + h * p.ds[1];
  const float* bias = p.bias + (int64_t)b * S;
  const uint64_t seed = (uint64_t)p.seed[0];
  const uint64_t head_base = (uint64_t)(b * H + h) * S;

  load_tile<T, D>(sK, k, p.ks[2], k0, S);
  load_tile<T, D>(sV, v, p.vs[2], k0, S);
  float dk[TR][DC], dv[TR][DC], s[TR][TC], dp[TR][TC], rmax[TR], rsum[TR], delta[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[r][c] = 0.f, dv[r][c] = 0.f;

  for (int q0 = 0; q0 < S; q0 += BQ) {
    __syncthreads();
    load_tile<T, D>(sQ, q, p.qs[2], q0, S);
    load_tile<T, D>(sdO, dout, p.ds[2], q0, S);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int i = q0 + ty + 16 * r;
      load_row_stats(p, head_base, i, rmax[r], rsum[r], delta[r]);
    }
    tile_dot<D>(sQ, sK, ty, tx, s);
    tile_dot<D>(sdO, sV, ty, tx, dp);
    softmax_grad_tile<T>(p, s, dp, rmax, rsum, delta, q0, k0, head_base, bias, seed, sPd, sdS);
    __syncthreads();
    // dV[j] += sum_i P_drop[i][j] dO[i];  dK[j] += sum_i dS[i][j] Q[i]
#pragma unroll 4
    for (int ii = 0; ii < BQ; ++ii) {
      float dov[DC], qv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dov[c] = sdO[ii * LD + tx + 16 * c];
        qv[c] = sQ[ii * LD + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float pd = sPd[ii * LDP + ty + 16 * r];
        const float ds = sdS[ii * LDP + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv[r][c] = fmaf(pd, dov[c], dv[r][c]);
          dk[r][c] = fmaf(ds, qv[c], dk[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= S) continue;
    const int64_t at = (((int64_t)b * S + j) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      ((T*)p.dk)[at + tx + 16 * c] = from_f32<T>(dk[r][c] * p.scale);
      ((T*)p.dv)[at + tx + 16 * c] = from_f32<T>(dv[r][c]);
    }
  }
}

// dQ of one query tile: loops over the key tiles
template <typename T, int D>
__global__ void __launch_bounds__(NT) attn_dq_kernel(const Params p) {
  constexpr int LD = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sdS = sV + BK * LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, S = p.S, H = p.H;
  const T* q = (const T*)p.q + b * p.qs[0] + h * p.qs[1];
  const T* k = (const T*)p.k + b * p.ks[0] + h * p.ks[1];
  const T* v = (const T*)p.v + b * p.vs[0] + h * p.vs[1];
  const T* dout = (const T*)p.dout + b * p.ds[0] + h * p.ds[1];
  const float* bias = p.bias + (int64_t)b * S;
  const uint64_t seed = (uint64_t)p.seed[0];
  const uint64_t head_base = (uint64_t)(b * H + h) * S;

  load_tile<T, D>(sQ, q, p.qs[2], q0, S);
  load_tile<T, D>(sdO, dout, p.ds[2], q0, S);
  float dq[TR][DC], s[TR][TC], dp[TR][TC], rmax[TR], rsum[TR], delta[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int i = q0 + ty + 16 * r;
    load_row_stats(p, head_base, i, rmax[r], rsum[r], delta[r]);
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[r][c] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    load_tile<T, D>(sK, k, p.ks[2], k0, S);
    load_tile<T, D>(sV, v, p.vs[2], k0, S);
    __syncthreads();
    tile_dot<D>(sQ, sK, ty, tx, s);
    tile_dot<D>(sdO, sV, ty, tx, dp);
    softmax_grad_tile<T>(p, s, dp, rmax, rsum, delta, q0, k0, head_base, bias, seed, nullptr, sdS);
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < BK; ++jj) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = sK[jj * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float ds = sdS[(ty + 16 * r) * LDP + jj];
#pragma unroll
        for (int c = 0; c < DC; ++c) dq[r][c] = fmaf(ds, kv[c], dq[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= S) continue;
    const int64_t at = (((int64_t)b * S + i) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) ((T*)p.dq)[at + tx + 16 * c] = from_f32<T>(dq[r][c] * p.scale);
  }
}

__global__ void attn_dropout_mask_kernel(int64_t n, const int64_t* seed_ptr, uint32_t threshold,
                                         uint8_t* out) {
  const uint64_t seed = (uint64_t)seed_ptr[0];
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x)
    out[e] = keep_elem((uint64_t)e, seed, threshold) ? 1 : 0;
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t stream, const Params& p) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((BQ + 2 * BK) * (D + 1) + BQ * LDP);
  return launch(attn_fwd_kernel<T, D>, dim3((p.S + BQ - 1) / BQ, p.H, p.B), smem, stream, p);
}

template <typename T, int D>
cudaError_t bwd(const Params& p, cudaStream_t stream) {
  const int64_t rows = (int64_t)p.B * p.H * p.S;
  cudaError_t err = launch(attn_delta_kernel<T, D>, dim3((unsigned)((rows + 7) / 8)), 0,
                           stream, p);
  if (err != cudaSuccess) return err;
  const size_t smem_kv = sizeof(float) * (4 * 64 * (D + 1) + 2 * BQ * LDP);
  err = launch(attn_dkdv_kernel<T, D>, dim3((p.S + BK - 1) / BK, p.H, p.B), smem_kv, stream, p);
  if (err != cudaSuccess) return err;
  const size_t smem_q = sizeof(float) * (4 * 64 * (D + 1) + BQ * LDP);
  return launch(attn_dq_kernel<T, D>, dim3((p.S + BQ - 1) / BQ, p.H, p.B), smem_q, stream, p);
}

Params make_params(int B, int H, int S, const void* q, const int64_t* qs, const void* k,
                   const int64_t* ks, const void* v, const int64_t* vs, const float* bias,
                   const int64_t* seed, float scale, int threshold, float keep_prob,
                   int dropout) {
  Params p = {};
  p.q = q, p.k = k, p.v = v, p.bias = bias, p.seed = seed;
  for (int i = 0; i < 3; ++i) p.qs[i] = qs[i], p.ks[i] = ks[i], p.vs[i] = vs[i];
  p.B = B, p.H = H, p.S = S;
  p.scale = scale, p.keep_prob = keep_prob, p.threshold = (uint32_t)threshold;
  p.dropout = dropout;
  return p;
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16;
// D: 64 or 128. Each returns cudaGetLastError() after its launches (or the
// error that refused one); cudaErrorInvalidValue for a dtype or D it lacks.
extern "C" {

int eeg_attn_fwd(int dtype, int D, int B, int H, int S, const void* q, int64_t qsb,
                 int64_t qsh, int64_t qss, const void* k, int64_t ksb, int64_t ksh,
                 int64_t kss, const void* v, int64_t vsb, int64_t vsh, int64_t vss,
                 const float* bias, const int64_t* seed, float scale, int threshold,
                 float keep_prob, int dropout, void* out, float* stats, void* stream) {
  const int64_t qs[3] = {qsb, qsh, qss}, ks[3] = {ksb, ksh, kss}, vs[3] = {vsb, vsh, vss};
  Params p = make_params(B, H, S, q, qs, k, ks, v, vs, bias, seed, scale, threshold,
                         keep_prob, dropout);
  p.out = out, p.stats = stats;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && D == 64) return fwd<float, 64>(p, st);
  if (dtype == 0 && D == 128) return fwd<float, 128>(p, st);
  if (dtype == 1 && D == 64) return fwd<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && D == 128) return fwd<__nv_bfloat16, 128>(p, st);
  return cudaErrorInvalidValue;
}

int eeg_attn_bwd(int dtype, int D, int B, int H, int S, const void* q, int64_t qsb,
                 int64_t qsh, int64_t qss, const void* k, int64_t ksb, int64_t ksh,
                 int64_t kss, const void* v, int64_t vsb, int64_t vsh, int64_t vss,
                 const float* bias, const int64_t* seed, float scale, int threshold,
                 float keep_prob, int dropout, const void* out, const float* stats,
                 const void* dout, int64_t dsb, int64_t dsh, int64_t dss, float* delta,
                 void* dq, void* dk, void* dv, void* stream) {
  const int64_t qs[3] = {qsb, qsh, qss}, ks[3] = {ksb, ksh, kss}, vs[3] = {vsb, vsh, vss};
  Params p = make_params(B, H, S, q, qs, k, ks, v, vs, bias, seed, scale, threshold,
                         keep_prob, dropout);
  p.o = out, p.stats = (float*)stats, p.dout = dout, p.delta = delta;
  p.ds[0] = dsb, p.ds[1] = dsh, p.ds[2] = dss;
  p.dq = dq, p.dk = dk, p.dv = dv;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && D == 64) return bwd<float, 64>(p, st);
  if (dtype == 0 && D == 128) return bwd<float, 128>(p, st);
  if (dtype == 1 && D == 64) return bwd<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && D == 128) return bwd<__nv_bfloat16, 128>(p, st);
  return cudaErrorInvalidValue;
}

// The kernels' keep mask for (B, H, S, S), as uint8: a test hook that calls
// the same keep_elem as the kernels; nothing on the training path calls it.
int eeg_attn_dropout_mask(int B, int H, int S, const int64_t* seed, int threshold,
                          uint8_t* out, void* stream) {
  const int64_t n = (int64_t)B * H * S * S;
  const int64_t blocks = (n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535;
  attn_dropout_mask_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      n, seed, (uint32_t)threshold, out);
  return cudaGetLastError();
}

const char* eeg_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
