// bf16 fused BERT self-attention for Hopper (sm_90a): wgmma products on
// tiles that TMA loads, forward and backward.
//
// Replaces, at bf16, the JAX package's Pallas TPU kernels in
// ops/attention.py: `_fwd_kernel` (attn_fwd_bf16_kernel here) and
// `_bwd_kernel` (attn_delta_bf16_kernel + attn_dkdv_bf16_kernel +
// attn_dq_bf16_kernel). attention.cu holds the mask hook and the C
// interface, which sends every bf16 call here (no other bf16 kernel
// exists). The function is the f32 kernels' (attention_f32.cu) at bf16
// (attention.cu's header): f32 scores and softmax, e = exp(s - m_run) rounded to bf16 before
// P.V (the online form of the JAX kernel's rounded p_drop), dO, P_drop and
// dS rounded to bf16 before their products, f32 accumulation; the same
// dropout mask, bit for bit (mask_words, attention.cuh).
//
// What bounds it on the H100: the matrix products, at the bf16 tensor-core
// rate. At (8, 12, 512, 64) the forward needs 4 B H S^2 D = 6.44 GFLOP (6.5
// us at 989 TFLOP/s) and the backward 10 B H S^2 D (16.3 us), against 25 MB
// and 50 MB of operands (7.5 and 15 us at 3.35 TB/s). The earlier bf16
// instantiation of the f32 design ran bf16 through TF32 mma.sync (half the
// bf16 rate, twice the instructions of a k16 product), widened each operand
// to f32 in registers and staged P through shared memory; this design does
// none of that:
//  - loads: a block is one warpgroup (128 threads, 64 rows of the output)
//    whose thread 0 issues TMA copies of 64-column panels (128 bytes a row,
//    with the 128-byte swizzle that wgmma reads without bank conflicts): the
//    block's fixed tiles once, the loop's tiles into a ring of two
//    shared-memory stages, each completing on an mbarrier; a stage is
//    refilled as soon as every warp is done with it. q, k, v and dO are
//    described as 4-D tensor maps (D, S, H, B) over their strided views,
//    encoded on the host inside the C call (cuTensorMapEncodeTiled reached
//    through cudaGetDriverEntryPoint, so nothing links against libcuda).
//    The wrapper's 16-byte rule on the base and the strides is TMA's own, so
//    no view is copied; rows past S come back as zeros from the map's
//    bounds. No producer warp: at 128 threads and at most 168 registers
//    three or four blocks share an SM, and one block's softmax overlaps
//    another's products (a warp of its own for the copies cost a block per
//    SM and was slower at every shape timed, PERF.md).
//  - products: wgmma.m64nNk16.f32.bf16.bf16 from shared-memory descriptors
//    (Q K^T, dO V^T, K Q^T, V dO^T: both operands K-major). The m64nN
//    accumulator holds, in each warp, rows 16 w + lane / 4 and + 8 and, in
//    each 8-column group, columns 2 (lane % 4) and + 1: the m16n8 C fragment
//    of mma.sync. So the query-major score tiles (forward, dQ)
//    draw one Philox call (mask_words) per thread and 8-column group, word e
//    for register e, and once rounded to bf16 an accumulator is the A
//    register fragment of the next wgmma: P (forward), dS (dQ), P_drop^T and
//    dS^T (dK/dV) never touch shared memory. The second operand of those
//    products (V, K, dO, Q) is read MN-major (transposed by the descriptor),
//    so no tile is ever transposed.
//  - dK/dV holds the transposed tile S^T = K Q^T (keys x queries), so that
//    P_drop^T and dS^T are A fragments. A thread then holds keys {j, j + 8}
//    x queries {i, i + 1} of each 8-query group, across two Philox groups.
//    It draws none: the dQ kernel, launched first, draws the mask
//    query-major and leaves it in the backward's scratch, one byte per two
//    groups (B H S^2 / 8 bytes, 3 MB at (8, 12, 512)), and a dK/dV thread
//    reads the bits of its 16-query block in one byte per key (dkdv_keep).
//    Each Philox call is made once a backward, not twice.
//  - the backward keeps its deterministic three-kernel shape, no atomics:
//    a pre-pass delta = rowsum(dO * O); dQ per block of queries, looping
//    over key tiles; dK and dV per block of keys, looping over query tiles.
// Each wgmma batch is issued, committed and waited for before its
// accumulator is read.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "attention.cuh"
#include "hopper.cuh"

namespace eeg_attn {
namespace {

constexpr int WG = 128;     // threads of a warpgroup
constexpr int STAGES = 2;   // the ring of K / V (forward, dQ) or Q / dO (dK/dV) tiles
constexpr int BK_FWD = 64;  // keys per tile of the forward and of dQ
constexpr int NT_DELTA = 256;

// a bf16 pair (lo in the low half), rounded to nearest: the A fragment's
// element order
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m64nN accumulator as A fragments of a k16 product along its columns:
// columns 16 kk .. 16 kk + 15 are 8-column groups 2 kk and 2 kk + 1, whose
// elements (rows g, g + 8; columns 2t, 2t + 1) are the A registers a0..a3.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], int n, const float (&v)[4]) {
  a[(n & 1) * 2] = pack(v[0], v[1]);
  a[(n & 1) * 2 + 1] = pack(v[2], v[3]);
}

// ---------------------------------------------------------------------------
// The ring of tiles
// ---------------------------------------------------------------------------

// A block is one warpgroup. Thread 0 issues every copy: the block's fixed
// tiles once (on `once`), then the loop's tile `it` into stage it % STAGES
// (on full[stage]), tile it + STAGES as soon as every warp is done with tile
// it. The loop's tiles are two tiles of R rows of the maps m0 and m1.
template <int R, int D>
struct Ring {
  static constexpr int TILE = tile_bytes<R, D>();
  uint64_t* full;
  uint8_t* s0;  // STAGES tiles of m0's rows, then STAGES of m1's
  const CUtensorMap *m0, *m1;
  int h, b;
  __device__ __forceinline__ uint8_t* tile0(int st) const { return s0 + st * TILE; }
  __device__ __forceinline__ uint8_t* tile1(int st) const { return s0 + (STAGES + st) * TILE; }
  __device__ __forceinline__ void load(int it) const {
    const int st = it % STAGES;
    bar_expect(&full[st], 2 * TILE);
    tma_tile<R, D>(tile0(st), m0, &full[st], it * R, h, b);
    tma_tile<R, D>(tile1(st), m1, &full[st], it * R, h, b);
  }
  __device__ __forceinline__ void wait(int it) const {
    bar_wait(&full[it % STAGES], (it / STAGES) & 1);
  }
  // after tile `it`'s products: refill its stage with tile it + STAGES
  __device__ __forceinline__ void release(int it, int n_tiles) const {
    __syncthreads();
    if (threadIdx.x == 0 && it + STAGES < n_tiles) load(it + STAGES);
  }
};

// Start a block: barriers set up, the fixed tiles (two of F rows of the maps
// f0, f1 at row r0, or only f0's when f1 is null) and the ring's first
// STAGES tiles on their way.
template <int F, int R, int D>
__device__ __forceinline__ void start(const Ring<R, D>& ring, uint64_t* once, uint8_t* fixed,
                                      const CUtensorMap* f0, const CUtensorMap* f1, int r0,
                                      int n_tiles) {
  if (threadIdx.x == 0) {
    bar_init(once, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) bar_init(&ring.full[s], 1);
    bar_init_fence();
    constexpr int T = tile_bytes<F, D>();
    bar_expect(once, f1 == nullptr ? T : 2 * T);
    tma_tile<F, D>(fixed, f0, once, r0, ring.h, ring.b);
    if (f1 != nullptr) tma_tile<F, D>(fixed + T, f1, once, r0, ring.h, ring.b);
    for (int it = 0; it < STAGES && it < n_tiles; ++it) ring.load(it);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int D>
struct FwdCfg {
  static constexpr int BK = BK_FWD;
  static constexpr int SMEM = tile_bytes<64, D>() + STAGES * 2 * tile_bytes<BK, D>() + 1024;
};

// One block per (64 queries, head, batch row): Q once, the key tiles' K and
// V through the ring, the online softmax over the block's rows (a running
// row max m and sum l, the output rescaled by exp(m_old - m_new) each tile).
template <int D>
__global__ void __launch_bounds__(WG, D == 64 ? 4 : 2)
    attn_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int BK = FwdCfg<D>::BK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], qbar;
  uint8_t* sQ = align1024(smem_raw);
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z, S = p.S;
  const int n_tiles = (S + BK - 1) / BK;
  const Ring<BK, D> ring{full, sQ + tile_bytes<64, D>(), &tk, &tv, h, b};
  start<64>(ring, &qbar, sQ, &tq, nullptr, q0, n_tiles);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int i0 = q0 + warp * 16 + g;  // the thread's rows i0 and i0 + 8
  const float* bias = p.bias + (int64_t)b * S;
  const uint64_t seed = mask_seed(p.seed, p.b0, b, p.rows_per_seed);
  const uint64_t mask_base = mask_base_of(p.b0, b, p.rows_per_seed, p.H_all, p.h0, h, S);
  const uint32_t thr8 = p.dropout ? p.threshold << 8 : 0xffffffffu;  // words 0 when off
  float o[D / 2];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // this thread's part of l
  bar_wait(&qbar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    ring.wait(it);
    float s[BK / 2];  // S = Q K^T
    zero(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(s, kmajor<64>(sQ, 0, 16 * kk),
                   kmajor<BK>(ring.tile0(it % STAGES), 0, 16 * kk));
    wg_commit();
    wg_wait();
    hold(s);

    float mt[2] = {-INFINITY, -INFINITY};
    if (k0 + BK <= S) {  // every key of the tile inside S: no test an element
      scale_scores<BK, false>(s, bias, k0, t, S, p.scale, mt);
    } else {
      scale_scores<BK, true>(s, bias, k0, t, S, p.scale, mt);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the four threads of a row are lanes 4g..4g+3
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float mn = fmaxf(m[r], mt[r]);  // finite: key k0 < S is in the tile
      alpha[r] = fast_exp(m[r] - mn);       // 0 at the first tile
      m[r] = mn;
      l[r] *= alpha[r];
    }
    uint32_t pa[BK / 16][4];  // P, rounded to bf16 with the mask applied
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      // all words 0 without dropout: every element kept
      const uint4 w = p.dropout ? mask_words(mask_base, S, i0, k0 + n * 8 + 2 * t, seed)
                                : make_uint4(0u, 0u, 0u, 0u);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = fast_exp(s[4 * n + e] - m[e >> 1]);
        l[e >> 1] += pe;
        v[e] = kept8(word(w, e), thr8) ? pe : 0.f;
      }
      to_a(pa[n / 2], n, v);
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      o[4 * d] *= alpha[0];
      o[4 * d + 1] *= alpha[0];
      o[4 * d + 2] *= alpha[1];
      o[4 * d + 3] *= alpha[1];
    }
    wg_fence();  // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], mnmajor<BK>(ring.tile1(it % STAGES), 16 * kk));
    wg_commit();
    wg_wait();
    hold(o);
    hold(pa);
    ring.release(it, n_tiles);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const uint64_t head_base = (uint64_t)(b * p.H + h) * S;  // the stats rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i >= S) continue;
    const float inv = 1.f / (l[r] * (p.dropout ? p.keep_prob : 1.f));
    uint32_t* out =
        reinterpret_cast<uint32_t*>((__nv_bfloat16*)p.out + (((int64_t)b * S + i) * p.H + h) * D);
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      out[d * 4 + t] = pack(o[4 * d + 2 * r] * inv, o[4 * d + 2 * r + 1] * inv);
    if (t == 0) {
      p.stats[head_base + i] = m[r];
      p.stats[(int64_t)p.B * p.H * S + head_base + i] = l[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// The pre-pass: each query row's (m, 1 / l, delta, 0) as one float4 of the
// scratch p.delta ((B, H, S, 4) here), delta = sum_d dO * O, D / 8 threads a
// row, 16 bytes each; the two kernels after it read a row's three numbers in
// one load.
template <int D>
__global__ void __launch_bounds__(NT_DELTA) attn_delta_bf16_kernel(const Params p) {
  constexpr int TPR = D / 8;  // threads a row
  const int64_t row = (int64_t)blockIdx.x * (NT_DELTA / TPR) + threadIdx.x / TPR;
  const int c = (threadIdx.x % TPR) * 8;
  const int S = p.S, H = p.H;
  const int64_t rows = (int64_t)p.B * H * S;
  const bool in = row < rows;
  float acc = 0.f;
  if (in) {
    const int i = (int)(row % S), h = (int)((row / S) % H), b = (int)(row / ((int64_t)S * H));
    const uint4 x = *reinterpret_cast<const uint4*>(
        (const __nv_bfloat16*)p.dout + b * p.ds[0] + h * p.ds[1] + i * p.ds[2] + c);
    const uint4 y = *reinterpret_cast<const uint4*>(
        (const __nv_bfloat16*)p.o + (((int64_t)b * S + i) * H + h) * D + c);
    const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(xs[e]), o = __bfloat1622float2(ys[e]);
      acc = fmaf(a.x, o.x, acc);
      acc = fmaf(a.y, o.y, acc);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && threadIdx.x % TPR == 0)
    reinterpret_cast<float4*>(p.delta)[row] =
        make_float4(p.stats[row], 1.f / p.stats[rows + row], acc, 0.f);
}

template <int D>
struct DqCfg {
  static constexpr int BK = BK_FWD;
  static constexpr int SMEM = 2 * tile_bytes<64, D>() + STAGES * 2 * tile_bytes<BK, D>() + 1024;
};

// dQ of one block of 64 queries: Q and dO once, the key tiles' K and V
// through the ring; S = Q K^T and dP = dO V^T recomputed, dS formed in
// registers, dQ += dS K (K read MN-major).
template <int D>
__global__ void __launch_bounds__(WG, 3)
    attn_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int BK = DqCfg<D>::BK, QT = tile_bytes<64, D>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], qbar;
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sdO = sQ + QT;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z, S = p.S;
  const int n_tiles = (S + BK - 1) / BK;
  const Ring<BK, D> ring{full, sdO + QT, &tk, &tv, h, b};
  start<64>(ring, &qbar, sQ, &tq, &tdo, q0, n_tiles);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int i0 = q0 + warp * 16 + g;
  const float* bias = p.bias + (int64_t)b * S;
  const uint64_t seed = mask_seed(p.seed, p.b0, b, p.rows_per_seed);
  const uint64_t head_base = (uint64_t)(b * p.H + h) * S;  // the stats rows
  const uint64_t mask_base = mask_base_of(p.b0, b, p.rows_per_seed, p.H_all, p.h0, h, S);
  const uint32_t thr8 = p.dropout ? p.threshold << 8 : 0xffffffffu;  // words 0 when off
  const RowStats rs[2] = {stats_of(p, head_base, i0), stats_of(p, head_base, i0 + 8)};
  float dq[D / 2];
  zero(dq);
  bar_wait(&qbar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES, k0 = it * BK;
    const uint8_t* sKs = ring.tile0(st);
    ring.wait(it);
    float s[BK / 2], dp[BK / 2];  // S = Q K^T, dP = dO V^T
    zero(s);
    zero(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(s, kmajor<64>(sQ, 0, 16 * kk), kmajor<BK>(sKs, 0, 16 * kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(dp, kmajor<64>(sdO, 0, 16 * kk), kmajor<BK>(ring.tile1(st), 0, 16 * kk));
    wg_commit();
    wg_wait();
    hold(s);
    hold(dp);

    uint32_t da[BK / 16][4];  // dS, rounded to bf16
    uint64_t bytes = 0;         // this thread's keep bits of the tile, for dK/dV
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const int j0 = k0 + n * 8 + 2 * t;
      const float bj[2] = {j0 < S ? __ldg(bias + j0) : 0.f,
                           j0 + 1 < S ? __ldg(bias + j0 + 1) : 0.f};
      const uint4 w = p.dropout ? mask_words(mask_base, S, i0, j0, seed)
                                : make_uint4(0u, 0u, 0u, 0u);
      float pd[4], ds[4];
      uint32_t nibble = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool keep = kept8(word(w, e), thr8);
        nibble |= (uint32_t)keep << e;
        softmax_grad(p, s[4 * n + e], dp[4 * n + e], bj[e & 1], rs[e >> 1], keep,
                     i0 + 8 * (e >> 1) < S && j0 + (e & 1) < S, pd[e], ds[e]);
      }
      bytes |= (uint64_t)nibble << (8 * n);
      to_a(da[n / 2], n, ds);
    }
    if (p.dropout) {  // rows i0 (g even) and i0 + 1 (lane ^ 4) share a byte
      const uint64_t odd = __shfl_xor_sync(0xffffffffu, bytes, 4);
      if ((g & 1) == 0)
        *reinterpret_cast<uint64_t*>(mask_bytes(p) + mask_byte(p, b * p.H + h, i0, k0 + 2 * t)) =
            bytes | (odd << 4);
    }
    wg_fence();  // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(dq, da[kk], mnmajor<BK>(sKs, 16 * kk));
    wg_commit();
    wg_wait();
    hold(dq);
    hold(da);
    ring.release(it, n_tiles);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i >= S) continue;
    uint32_t* dst =
        reinterpret_cast<uint32_t*>((__nv_bfloat16*)p.dq + (((int64_t)b * S + i) * p.H + h) * D);
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      dst[d * 4 + t] = pack(dq[4 * d + 2 * r] * p.scale, dq[4 * d + 2 * r + 1] * p.scale);
  }
}

template <int D>
struct KvCfg {
  static constexpr int BQ = 32;  // query rows per tile
  static constexpr int SMEM = 2 * tile_bytes<64, D>() + STAGES * 2 * tile_bytes<BQ, D>() + 1024;
};

// dK and dV of one block of 64 keys: K and V once, the query tiles' Q and
// dO through the ring; S^T = K Q^T and dP^T = V dO^T recomputed, P_drop^T
// and dS^T formed in registers, dV += P_drop^T dO and dK += dS^T Q (dO, Q
// read MN-major).
template <int D>
__global__ void __launch_bounds__(WG, D == 64 ? 3 : 2)
    attn_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo, const Params p) {
  constexpr int BQ = KvCfg<D>::BQ, KT = tile_bytes<64, D>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], kvbar;
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + KT;
  const int k0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z, S = p.S;
  const int n_tiles = (S + BQ - 1) / BQ;
  const Ring<BQ, D> ring{full, sV + KT, &tq, &tdo, h, b};
  start<64>(ring, &kvbar, sK, &tk, &tv, k0, n_tiles);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int j0 = k0 + warp * 16 + g;  // the thread's keys j0 and j0 + 8
  const uint64_t head_base = (uint64_t)(b * p.H + h) * S;  // the stats rows
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    bias[r] = j0 + 8 * r < S ? __ldg(p.bias + (int64_t)b * S + j0 + 8 * r) : 0.f;
  float dk[D / 2], dv[D / 2];
  zero(dk);
  zero(dv);
  bar_wait(&kvbar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES, q0 = it * BQ;
    const uint8_t* sQs = ring.tile0(st);
    const uint8_t* sdOs = ring.tile1(st);
    ring.wait(it);
    float s[BQ / 2], dp[BQ / 2];  // S^T = K Q^T, dP^T = V dO^T
    zero(s);
    zero(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ>(s, kmajor<64>(sK, 0, 16 * kk), kmajor<BQ>(sQs, 0, 16 * kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ>(dp, kmajor<64>(sV, 0, 16 * kk), kmajor<BQ>(sdOs, 0, 16 * kk));
    wg_commit();
    wg_wait();
    hold(s);
    hold(dp);

    uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // P_drop^T and dS^T, rounded to bf16
#pragma unroll
    for (int u = 0; u < BQ / 16; ++u) {
      const int a = q0 + 16 * u + 2 * t;  // queries a, a + 1 (group 2u), a + 8, a + 9 (2u + 1)
      uint32_t keep[2] = {15u, 15u};
      if (p.dropout) {
#pragma unroll
        for (int r = 0; r < 2; ++r) keep[r] = dkdv_keep(p, b * p.H + h, a, j0 + 8 * r);
      }
      float pd[2][4], ds[2][4];  // [group 2u + c / 2][element 2r + c % 2]
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = a + (c & 1) + 8 * (c >> 1);
        const RowStats rs = stats_of(p, head_base, i);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * (2 * u + (c >> 1)) + 2 * r + (c & 1);
          softmax_grad(p, s[x], dp[x], bias[r], rs, (keep[r] >> c) & 1u,
                       i < S && j0 + 8 * r < S, pd[c >> 1][2 * r + (c & 1)],
                       ds[c >> 1][2 * r + (c & 1)]);
        }
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        to_a(pa[u], c, pd[c]);
        to_a(da[u], c, ds[c]);
      }
    }
    wg_fence();  // dV += P_drop^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D>(dv, pa[kk], mnmajor<BQ>(sdOs, 16 * kk));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D>(dk, da[kk], mnmajor<BQ>(sQs, 16 * kk));
    wg_commit();
    wg_wait();
    hold(dv);
    hold(dk);
    hold(pa);
    hold(da);
    ring.release(it, n_tiles);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + 8 * r;
    if (j >= S) continue;
    const int64_t at = (((int64_t)b * S + j) * p.H + h) * D;
    uint32_t* dkp = reinterpret_cast<uint32_t*>((__nv_bfloat16*)p.dk + at);
    uint32_t* dvp = reinterpret_cast<uint32_t*>((__nv_bfloat16*)p.dv + at);
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      dkp[d * 4 + t] = pack(dk[4 * d + 2 * r] * p.scale, dk[4 * d + 2 * r + 1] * p.scale);
      dvp[d * 4 + t] = pack(dv[4 * d + 2 * r], dv[4 * d + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches
// ---------------------------------------------------------------------------

// The map of a (B, H, S, D) bf16 view with (b, h, s) strides `st` (elements,
// multiples of 8 where the axis is longer than 1: the wrapper's check),
// read in boxes of 64 columns x `rows` rows of one head and batch row
bool tensor_map(CUtensorMap* map, const void* ptr, const int64_t* st, const Params& p, int D,
                int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)p.S, (cuuint64_t)p.H, (cuuint64_t)p.B};
  // an axis of length 1 is never stepped along: any multiple of 16 serves
  const int64_t any = ((int64_t)p.B * p.H * p.S * D * 2 + 15) / 16 * 16;
  const int n[3] = {p.S, p.H, p.B};
  const int64_t el[3] = {st[2], st[1], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)(n[i] == 1 ? any : el[i] * 2);
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1}, unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t run_fwd(const Params& p, cudaStream_t stream) {
  using C = FwdCfg<D>;
  static std::atomic<uint32_t> ready{0};
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, p.q, p.qs, p, D, 64) || !tensor_map(&tk, p.k, p.ks, p, D, C::BK) ||
      !tensor_map(&tv, p.v, p.vs, p, D, C::BK))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(attn_fwd_bf16_kernel<D>, C::SMEM, ready);
  if (err != cudaSuccess) return err;
  attn_fwd_bf16_kernel<D><<<dim3((p.S + 63) / 64, p.H, p.B), WG, C::SMEM, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_bwd(const Params& p, cudaStream_t stream) {
  static std::atomic<uint32_t> ready_kv{0}, ready_dq{0};
  const int64_t rows = (int64_t)p.B * p.H * p.S, per_block = NT_DELTA / (D / 8);
  attn_delta_bf16_kernel<D>
      <<<(unsigned)((rows + per_block - 1) / per_block), NT_DELTA, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + 63) / 64, p.H, p.B);
  {  // dQ first: it draws the mask and leaves it for dK/dV
    using C = DqCfg<D>;
    CUtensorMap tq, tdo, tk, tv;
    if (!tensor_map(&tq, p.q, p.qs, p, D, 64) || !tensor_map(&tdo, p.dout, p.ds, p, D, 64) ||
        !tensor_map(&tk, p.k, p.ks, p, D, C::BK) || !tensor_map(&tv, p.v, p.vs, p, D, C::BK))
      return cudaErrorInvalidValue;
    if ((err = allow_smem(attn_dq_bf16_kernel<D>, C::SMEM, ready_dq)) != cudaSuccess) return err;
    attn_dq_bf16_kernel<D><<<grid, WG, C::SMEM, stream>>>(tq, tdo, tk, tv, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  using C = KvCfg<D>;
  CUtensorMap tk, tv, tq, tdo;
  if (!tensor_map(&tk, p.k, p.ks, p, D, 64) || !tensor_map(&tv, p.v, p.vs, p, D, 64) ||
      !tensor_map(&tq, p.q, p.qs, p, D, C::BQ) || !tensor_map(&tdo, p.dout, p.ds, p, D, C::BQ))
    return cudaErrorInvalidValue;
  if ((err = allow_smem(attn_dkdv_bf16_kernel<D>, C::SMEM, ready_kv)) != cudaSuccess) return err;
  attn_dkdv_bf16_kernel<D><<<grid, WG, C::SMEM, stream>>>(tk, tv, tq, tdo, p);
  return cudaGetLastError();
}

}  // namespace

cudaError_t fwd_bf16(const Params& p, int D, cudaStream_t stream) {
  if (D == 64) return run_fwd<64>(p, stream);
  if (D == 128) return run_fwd<128>(p, stream);
  return cudaErrorInvalidValue;
}

cudaError_t bwd_bf16(const Params& p, int D, cudaStream_t stream) {
  if (D == 64) return run_bwd<64>(p, stream);
  if (D == 128) return run_bwd<128>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace eeg_attn
