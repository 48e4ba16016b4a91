// Fused BERT self-attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in ops/attention.py:
// `_fwd_kernel` (forward; attn_fwd_kernel here) and `_bwd_kernel`
// (backward; attn_delta_kernel + attn_dkdv_kernel + attn_dq_kernel). They
// compute
//
//   s      = q k^T * scale + bias[key]          (f32 scores, bias 0 or finfo.min)
//   p      = exp(s - max_row s) / sum_row        (the stable softmax)
//   p_drop = keep ? p / (1 - rate) : 0,  keep = (bits >> 8) < (1 - rate) 2^24
//   out    = round_T(p_drop) v                   (f32 accumulation)
//
// and its gradient, regenerating the dropout mask from the seed instead of
// storing it. T is float or bf16; the accumulation is f32, and with T = bf16
// values are rounded where the JAX kernel casts to the input dtype (P_drop,
// dO and dS before their products).
//
// What bounds it on the H100: the matrix products. At the 512-token path's
// (8, 12, 512, 64) the forward needs 4 B H S^2 D = 6.44 GFLOP and the
// backward 10 B H S^2 D = 16.1 GFLOP, against 50 MB and 100 MB of operands
// (15 and 30 us at 3.35 TB/s). The products run on the tensor cores:
// mma.sync.m16n8k8 in TF32 with f32 accumulation.
//  - f32 keeps the accuracy of the reference's Precision.HIGHEST within the
//    JAX tests' tolerances by the error-compensated 3xTF32 split: x = hi +
//    lo with hi = tf32(x) and lo = tf32(x - hi), split when a fragment is
//    loaded (shared memory holds f32 only), and a b = hi.hi + hi.lo + lo.hi;
//    the dropped lo.lo is ~2^-22 relative. The tensor core's accumulation
//    truncates, so the sums over the sequence add each tile's products
//    outside it (warp_mma_add). At 495 / 3 = 165 TFLOP/s the f32 bound is
//    39.0 us forward and 97.6 us backward.
//  - the exponentials run on the SFU, as ex2.approx of x log2 e (fast_exp):
//    about 2^-22 relative, plus the rounding of x log2 e, which grows with
//    |x| only where exp(x) is far below the row's largest term; denormal
//    results flush to 0. That is of the order of expf's 2 ulp: on the card
//    expf gave the same f32 errors against the plain version and cost up
//    to 4 % of the backward (PERF.md).
//  - bf16 is exact in TF32 (lo = 0): one pass, bf16 products with f32
//    accumulation, as the JAX kernel computes them.
// The kernels stay well above that bound (PERF.md has the times): they are
// held back by instruction throughput and latency, not by the tensor cores.
// Every warp splits each operand element it reads (four instructions), and
// an SM holds 12 to 16 warps, too few to hide the mma.sync and shared-memory
// latencies. mma.sync and not wgmma: TF32 wgmma takes K-major operands only,
// so P.V would need V^T in shared memory; mma.sync reaches the tensor cores
// with a simple register fragment layout. wgmma (operands split once per
// block, not per warp) and TMA are the next levers.
//
// Design (tiles chosen by timing, see the constants below):
//  - forward (attn_fwd_kernel): one block per (8 warps x 16 queries, head,
//    batch row); a single pass over key tiles of 32 with the online
//    softmax: a running row max m and sum l, the output accumulator
//    rescaled by exp(m_old - m_new) at each tile, and
//    out = sum keep e v / (l (1 - rate)) at the end: the JAX p = e / sum e
//    in exact arithmetic. With T = bf16, P cannot be rounded after
//    normalisation, since l is known only at the end: the staged
//    e = exp(s - m_run) is rounded instead. Saves m and l separately (not
//    lse = m + log l: in a row whose keys are all masked m is finfo.min,
//    which absorbs log l, and exp(s - lse) would give 1, not 1 / S).
//  - loads: 16-byte cp.async with zero-fill for rows past S, into double
//    buffers, so that one tile's load overlaps the last tile's products.
//    Shared rows are padded so that the fragment loads of each operand fall
//    in distinct banks (see ld_contig), and a thread's two k-values of a
//    fragment row are neighbours (see warp_mma). The C fragment of an m16n8
//    product is not an A fragment, so P (forward) and P_drop, dS
//    (backward) are staged through shared memory for the next product.
//  - backward: a pre-pass computes delta = rowsum(dO * O), which equals
//    rowsum(dP * P_drop) with or without dropout; then attn_dkdv_kernel
//    (one block per 64 keys, looping over query tiles of 16, 3 blocks per
//    SM; the score tile is held query-major, Q K^T, so that a Philox group
//    falls inside one thread, and the transposed products read P_drop and
//    dS from shared memory) and attn_dq_kernel (one block per 64 queries,
//    looping over key tiles of 16). Both recompute s and p = exp(s - m) / l
//    and regenerate the mask. Deterministic: no atomics.
//  - dropout bits: Philox4x32-10 (philox.cuh) keyed by a seed read here from
//    an int64 device tensor (no host sync). One call gives four words and
//    serves the four elements one thread holds in a C fragment (keep_bits).
//    The seed tensor holds G seeds, G dividing B: batch row b takes seed
//    b / (B / G), and its mask counter counts b mod (B / G) in place of b,
//    so one call over G stacked batches of B / G rows draws exactly the
//    masks of G calls over one batch each (the paired phase encode's two
//    phases in one 2B forward). G = 1 is the plain single-seed call.
//  - a call may hold one block of a larger one (a rank's shard under a
//    (data, model) mesh): rows b0 .. b0 + B - 1 of B_all and heads
//    h0 .. h0 + H - 1 of H_all. The mask then takes the global row and
//    head: seed (b0 + b) / (B_all / G), counter
//    ((((b0 + b) mod (B_all / G)) H_all + h0 + h) S + i0) S + j0. So each
//    block draws exactly its slice of the global call's mask. Zero offsets
//    with B_all = B and H_all = H are the call of its own.
//  - q, k, v and dO come in as (B, H, S, D) views with (b, h, s) strides
//    and data pointers that are multiples of 16 bytes and a unit last
//    stride (the wrapper checks), so the packed QKV projection needs no
//    copies; out, dq, dk and dv are written as (B, S, H, D), so the
//    caller's reshape to (B, S, H * D) is free.
//  - a row whose keys are all masked has scores that all round to
//    finfo.min, so its softmax is uniform, as the einsum gives; nothing
//    special-cases -inf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

namespace {

// Tiles, chosen by timing alternatives at (8, 12, 512, 64) on the H100: the
// fastest or level choices that keep 3 dK/dV blocks per SM.
constexpr int NW_FWD = 8;    // warps of a forward block, 16 query rows each
constexpr int BK_FWD = 32;   // keys per tile of the forward
constexpr int BKV = 64;      // keys per dK/dV block, 16 per warp
constexpr int BQ_KV = 16;    // query rows per step of the dK/dV block
constexpr int BQ_DQ = 64;    // query rows per dQ block
constexpr int BK_DQ = 16;    // keys per tile of the dQ block
constexpr int NT_BWD = 128;  // threads of a dK/dV or dQ block (4 warps)
constexpr int NT_DELTA = 256;

// Blocks per SM that a block's f32 shared memory allows (228 KB, 1 KB of it
// reserved per block), at most 3: each kernel's registers are held to that
// many blocks (__launch_bounds__), so that they never limit occupancy below
// what shared memory allows.
constexpr int smem_blocks(size_t smem) {
  return 233472 / (smem + 1024) < 3 ? (int)(233472 / (smem + 1024)) : 3;
}

struct Params {
  const void *q, *k, *v, *o, *dout;
  int64_t qs[3], ks[3], vs[3], ds[3];  // (b, h, s) strides in elements
  const float* bias;                   // (B, S)
  const int64_t* seed;                 // G elements, one per rows_per_seed batch rows
  void *out, *dq, *dk, *dv;            // (B, S, H, D)
  float* stats;                        // (2, B, H, S): row max m, row sum l
  float* delta;                        // (B, H, S)
  int B, H, S, rows_per_seed;  // rows_per_seed = B_all / G
  int b0, h0, H_all;           // the block's first global row and head, the global heads
  float scale, keep_prob, inv_keep;  // inv_keep = 1 / keep_prob
  uint32_t threshold;
  int dropout;
};

// Row strides of shared tiles, in elements of T, padded by 16 or 32 bytes
// so that a warp's fragment loads (see warp_mma) fall in distinct banks. An
// operand read along its rows (KContig: 8-byte loads of rows g, columns
// 2t, 2t + 1; g = lane / 4, t = lane % 4) needs an f32 stride of 8 mod 32
// words; one read down its columns (KStrided: rows 2t and 2t + 1, column g)
// needs 4 mod 32. bf16 rows of cols + 8 serve both.
template <typename T> constexpr int ld_contig(int cols) { return cols + 8; }
template <typename T> constexpr int ld_strided(int cols) {
  return cols + (sizeof(T) == 4 ? 4 : 8);
}

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

// exp(x) as 2^(x log2 e) on the SFU; exp(-inf) = 0
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// store a pair of neighbouring row elements
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// Tensor-core products
// ---------------------------------------------------------------------------

// x = hi + lo, both TF32 (hi keeps 10 mantissa bits, lo the next 11); with
// EXACT (a bf16 value, exact in TF32) hi = x and lo is not used.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    hi &= 0xffffe000u;
    const float r = x - __uint_as_float(hi);  // exact
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int N> __device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Operands of warp_mma in shared memory: element (x, k), x the row of A or
// the column of B and k the reduction index, is at base[x * ld + k]
// (KContig) or base[k * ld + x] (KStrided). pair(x, k) reads (x, k) and
// (x, k + 1): one 8-byte load (4 for bf16) from a KContig operand.
template <typename T> struct KContig {
  const T* base;
  int ld;
  __device__ __forceinline__ float2 pair(int x, int k) const { return load2(base + x * ld + k); }
};
template <typename T> struct KStrided {
  const T* base;
  int ld;
  __device__ __forceinline__ float2 pair(int x, int k) const {
    return make_float2(to_f32(base[k * ld + x]), to_f32(base[(k + 1) * ld + x]));
  }
};
template <typename T> __device__ __forceinline__ KContig<T> k_contig(const T* base, int ld) {
  return {base, ld};
}
template <typename T> __device__ __forceinline__ KStrided<T> k_strided(const T* base, int ld) {
  return {base, ld};
}

// acc[n] += A B over one warp, acc[n] the m16n8 C fragment of columns
// 8n..8n+7: A is 16 x 8 KS and B is 8 KS x 8 N, operands as above. Fragment
// layouts (PTX ISA, mma.m16n8k8 .tf32), g = lane / 4, t = lane % 4: A rows
// g, g + 8 and k-slots t, t + 4; B k-slots t, t + 4 and column g; C rows g,
// g + 8 and columns 2t, 2t + 1. Within a k-step of 8, slot t holds index
// 2t and slot t + 4 index 2t + 1: the same permutation in A and B, so the
// sum is the same, and a thread's two values of a row are neighbours.
// With SPLIT (f32), hi.hi, hi.lo and lo.hi go into three accumulators,
// summed into acc[n] at the end in round-to-nearest f32: three chains of KS
// dependent mma in place of one of 3 KS, and the tensor core's truncating
// accumulation rounds the large sum 8 times over D = 64, not 24 (the
// largest error left in the scores). For the score products, whose few
// n-tiles give a warp little else to overlap.
template <bool EXACT, int KS, int N, bool SPLIT = false, typename OA, typename OB>
__device__ __forceinline__ void warp_mma(float (&acc)[N][4], OA a, OB b) {
  constexpr bool SPLIT3 = SPLIT && !EXACT;
  float hl[SPLIT3 ? N : 1][4], lh[SPLIT3 ? N : 1][4];
  if (SPLIT3) {
    zero(hl);
    zero(lh);
  }
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k = ks * 8 + 2 * t;
    uint32_t ah[4], al[4];
    const float2 a0 = a.pair(g, k), a1 = a.pair(g + 8, k);
    split<EXACT>(a0.x, ah[0], al[0]);
    split<EXACT>(a1.x, ah[1], al[1]);
    split<EXACT>(a0.y, ah[2], al[2]);
    split<EXACT>(a1.y, ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      const float2 b01 = b.pair(n * 8 + g, k);
      split<EXACT>(b01.x, bh0, bl0);
      split<EXACT>(b01.y, bh1, bl1);
      if (SPLIT3) {
        mma_tf32(lh[n], al, bh0, bh1);
        mma_tf32(hl[n], ah, bl0, bl1);
        mma_tf32(acc[n], ah, bh0, bh1);
        continue;
      }
      if (!EXACT) {  // the small terms first
        mma_tf32(acc[n], al, bh0, bh1);
        mma_tf32(acc[n], ah, bl0, bl1);
      }
      mma_tf32(acc[n], ah, bh0, bh1);
    }
  }
  if (SPLIT3) {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += hl[n][e] + lh[n][e];
  }
}

// acc += A B (as warp_mma) where acc sums over many tiles. The tensor core's
// own accumulation truncates, and over the 3 x 64 products of a 512-long
// f32 sum that bias dominated the gradients' error: so in f32 each tile's
// products go into a fresh fragment, added to acc here in round-to-nearest
// f32. bf16 (one pass, 2e-2 tolerance) accumulates in place.
template <bool EXACT, int KS, int N, typename OA, typename OB>
__device__ __forceinline__ void warp_mma_add(float (&acc)[N][4], OA a, OB b) {
  if (EXACT) {
    warp_mma<EXACT, KS, N>(acc, a, b);
    return;
  }
  float part[N][4];
  zero(part);
  warp_mma<EXACT, KS, N>(part, a, b);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// ---------------------------------------------------------------------------
// Asynchronous tile loads
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying rows row0..row0 + R - 1 of a (S, D) matrix with row stride
// `ld` (elements) into a shared tile with row stride LD; rows past S are
// zero-filled. Source rows and strides are 16-byte aligned.
template <typename T, int R, int D, int LD, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t ld, int row0, int S) {
  constexpr int V = 16 / sizeof(T), CH = D / V;  // elements per chunk, chunks per row
#pragma unroll
  for (int e = threadIdx.x; e < R * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * V, row = row0 + r;
    const bool in = row < S;
    cp_async16(dst + r * LD + c, src + (int64_t)(in ? row : 0) * ld + c, in);
  }
}

// ---------------------------------------------------------------------------
// The dropout mask
// ---------------------------------------------------------------------------

// The dropout mask: the one function the forward, both backward kernels and
// the test hook call, so they agree bit for bit. One Philox4x32-10 call
// serves the group of rows {i0, i0 + 8} x columns {j0, j0 + 1}, with
// i0 = (i & ~15) | (i & 7) and j0 = j & ~1: the four elements one thread
// holds in an m16n8 C fragment whose rows start at a multiple of 16. The
// counter is ((b' H + h) S + i0) S + j0 (mask_base = (b' H + h) S, with
// b, h and H the global row, head and head count (mask_base below) and
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

__device__ __forceinline__ uint32_t keep_bits(uint64_t mask_base, int S, int i0, int j0,
                                              uint64_t seed, uint32_t threshold) {
  const uint4 w = philox4x32_10((mask_base + (uint64_t)i0) * (uint64_t)S + (uint64_t)j0, seed);
  return (uint32_t)((w.x >> 8) < threshold) | ((uint32_t)((w.y >> 8) < threshold) << 1) |
         ((uint32_t)((w.z >> 8) < threshold) << 2) | ((uint32_t)((w.w >> 8) < threshold) << 3);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T, int D, int NW, int BK>
struct FwdTiles {
  static constexpr int BQ = 16 * NW, LQ = ld_contig<T>(D), LK = ld_contig<T>(D),
                       LV = ld_strided<T>(D), LP = ld_contig<float>(BK);
  static constexpr size_t smem =
      sizeof(T) * (BQ * LQ + 2 * BK * LK + 2 * BK * LV) + sizeof(float) * NW * 16 * LP;
};

template <typename T, int D, int NW, int BK>
__global__ void __launch_bounds__(NW * 32, smem_blocks(FwdTiles<float, D, NW, BK>::smem))
    attn_fwd_kernel(const Params p) {
  using Tl = FwdTiles<T, D, NW, BK>;
  constexpr int NT = NW * 32, BQ = Tl::BQ, LQ = Tl::LQ, LK = Tl::LK, LV = Tl::LV, LP = Tl::LP;
  constexpr int NK = BK / 8, ND = D / 8;
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BQ * LQ;      // two buffers
  T* sV = sK + 2 * BK * LK;  // two buffers
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float* sP = reinterpret_cast<float*>(sV + 2 * BK * LV) + warp * 16 * LP;  // this warp's
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, S = p.S, H = p.H;
  const int r0 = warp * 16;  // the warp's rows in the block
  const T* q = (const T*)p.q + b * p.qs[0] + h * p.qs[1];
  const T* k = (const T*)p.k + b * p.ks[0] + h * p.ks[1];
  const T* v = (const T*)p.v + b * p.vs[0] + h * p.vs[1];
  const float* bias = p.bias + (int64_t)b * S;
  const uint64_t seed = mask_seed(p.seed, p.b0, b, p.rows_per_seed);
  const uint64_t head_base = (uint64_t)(b * H + h) * S;  // the stats and delta rows
  const uint64_t mask_base = mask_base_of(p.b0, b, p.rows_per_seed, p.H_all, p.h0, h, S);
  const int n_tiles = (S + BK - 1) / BK;

  load_tile<T, BQ, D, LQ, NT>(sQ, q, p.qs[2], q0, S);
  load_tile<T, BK, D, LK, NT>(sK, k, p.ks[2], 0, S);
  load_tile<T, BK, D, LV, NT>(sV, v, p.vs[2], 0, S);
  cp_async_commit();

  float o[ND][4];
  zero(o);
  // rows g and g + 8 of the warp: running max, this thread's part of the sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK, buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile `it` landed; every warp is done with tile it - 1
    if (it + 1 < n_tiles) {
      load_tile<T, BK, D, LK, NT>(sK + (buf ^ 1) * BK * LK, k, p.ks[2], k0 + BK, S);
      load_tile<T, BK, D, LV, NT>(sV + (buf ^ 1) * BK * LV, v, p.vs[2], k0 + BK, S);
      cp_async_commit();
    }
    const T* sKb = sK + buf * BK * LK;
    const T* sVb = sV + buf * BK * LV;

    float s[NK][4];
    zero(s);
    warp_mma<EXACT, ND, NK, true>(s, k_contig(sQ + r0 * LQ, LQ), k_contig(sKb, LK));

    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = j < S ? s[n][e] * p.scale + __ldg(bias + j) : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
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
    const int i0 = q0 + r0 + g;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const uint32_t keep =
          p.dropout ? keep_bits(mask_base, S, i0, k0 + n * 8 + 2 * t, seed, p.threshold) : 15u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = fast_exp(s[n][e] - m[e >> 1]);
        l[e >> 1] += pe;
        s[n][e] = (keep >> e) & 1u ? round_to<T>(pe) : 0.f;
      }
      store2(sP + g * LP + n * 8 + 2 * t, s[n][0], s[n][1]);
      store2(sP + (g + 8) * LP + n * 8 + 2 * t, s[n][2], s[n][3]);
    }
    __syncwarp();
    float pv[ND][4];  // this tile's P V, added to the rescaled o below
    zero(pv);
    warp_mma<EXACT, NK, ND>(pv, k_contig<float>(sP, LP), k_strided(sVb, LV));
#pragma unroll
    for (int d = 0; d < ND; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = fmaf(o[d][e], alpha[e >> 1], pv[d][e]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + r0 + g + 8 * r;
    if (i >= S) continue;
    const float inv = 1.f / (l[r] * (p.dropout ? p.keep_prob : 1.f));
    T* out = (T*)p.out + (((int64_t)b * S + i) * H + h) * D;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      store2(out + d * 8 + 2 * t, o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
    if (t == 0) {
      p.stats[head_base + i] = m[r];
      p.stats[(int64_t)p.B * H * S + head_base + i] = l[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// delta[b, h, i] = sum_d dO[b, h, i, d] * O[b, h, i, d], one warp per row
template <typename T, int D>
__global__ void __launch_bounds__(NT_DELTA) attn_delta_kernel(const Params p) {
  const int64_t row = (int64_t)blockIdx.x * (NT_DELTA / 32) + threadIdx.x / 32;
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

// The forward's row max m, 1 / row sum l and the pre-pass's delta of query
// row i (placeholders past S, where nothing is used)
struct RowStats {
  float m, inv_l, delta;
};
__device__ __forceinline__ RowStats row_stats(const Params& p, uint64_t head_base, int i) {
  if (i >= p.S) return {0.f, 0.f, 0.f};
  return {__ldg(p.stats + head_base + i),
          1.f / __ldg(p.stats + (int64_t)p.B * p.H * p.S + head_base + i),
          __ldg(p.delta + head_base + i)};
}

// p, p_drop and dS of the four elements e of one C fragment (rows i0,
// i0 + 8; columns j0, j0 + 1) from the scores s and dP = dO V^T; returns
// them rounded to T in pd[e] and ds[e] (0 outside S x S).
template <typename T>
__device__ __forceinline__ void softmax_grad4(const Params& p, const float (&s)[4],
                                              const float (&dp)[4], const RowStats (&rs)[2],
                                              const float (&bias)[2], uint32_t keep, int i0,
                                              int j0, float (&pd)[4], float (&ds)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const RowStats& r = rs[e >> 1];
    pd[e] = ds[e] = 0.f;
    if (i0 + 8 * (e >> 1) < p.S && j0 + (e & 1) < p.S) {
      const float pr = fast_exp(s[e] * p.scale + bias[e & 1] - r.m) * r.inv_l;
      float dpm = dp[e], prd = pr;
      if (p.dropout) {
        const bool kept = (keep >> e) & 1u;
        prd = kept ? pr * p.inv_keep : 0.f;
        dpm = kept ? dpm * p.inv_keep : 0.f;
      }
      pd[e] = round_to<T>(prd);
      ds[e] = round_to<T>(pr * (dpm - r.delta));
    }
  }
}

template <typename T, int D>
struct DkdvTiles {
  static constexpr int LK = ld_contig<T>(D), LV = ld_contig<T>(D), LQ = ld_contig<T>(D),
                       LP = ld_strided<float>(BKV);
  static constexpr size_t smem =
      sizeof(T) * (BKV * (LK + LV) + 4 * BQ_KV * LQ) + sizeof(float) * 2 * BQ_KV * LP;
};

// dK and dV of one tile of 64 keys: loops over the query tiles of 16 (Q
// and dO double-buffered). Step A: warp w computes the (16 queries, 16
// keys 16 w..) tile of the scores, query-major so that a Philox group is
// one thread's, and stages P_drop and dS as [query][key]. Step B: warp w
// accumulates dV and dK of the same keys, reading P_drop^T and dS^T.
template <typename T, int D>
__global__ void __launch_bounds__(NT_BWD, smem_blocks(DkdvTiles<float, D>::smem))
    attn_dkdv_kernel(const Params p) {
  using Tl = DkdvTiles<T, D>;
  constexpr int LK = Tl::LK, LV = Tl::LV, LQ = Tl::LQ, LP = Tl::LP, ND = D / 8;
  constexpr int NKA = BKV / 4 / 8;  // a warp's keys in 8-key n-tiles
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + BKV * LK;
  T* sQ = sV + BKV * LV;      // two buffers
  T* sdO = sQ + 2 * BQ_KV * LQ;  // two buffers
  float* sPd = reinterpret_cast<float*>(sdO + 2 * BQ_KV * LQ);
  float* sdS = sPd + BQ_KV * LP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z, S = p.S, H = p.H;
  const T* q = (const T*)p.q + b * p.qs[0] + h * p.qs[1];
  const T* k = (const T*)p.k + b * p.ks[0] + h * p.ks[1];
  const T* v = (const T*)p.v + b * p.vs[0] + h * p.vs[1];
  const T* dout = (const T*)p.dout + b * p.ds[0] + h * p.ds[1];
  const uint64_t seed = mask_seed(p.seed, p.b0, b, p.rows_per_seed);
  const uint64_t head_base = (uint64_t)(b * H + h) * S;  // the stats and delta rows
  const uint64_t mask_base = mask_base_of(p.b0, b, p.rows_per_seed, p.H_all, p.h0, h, S);
  const int ka = 16 * warp;  // the warp's keys in the block

  const int n_tiles = (S + BQ_KV - 1) / BQ_KV;
  load_tile<T, BKV, D, LK, NT_BWD>(sK, k, p.ks[2], k0, S);
  load_tile<T, BKV, D, LV, NT_BWD>(sV, v, p.vs[2], k0, S);
  load_tile<T, BQ_KV, D, LQ, NT_BWD>(sQ, q, p.qs[2], 0, S);
  load_tile<T, BQ_KV, D, LQ, NT_BWD>(sdO, dout, p.ds[2], 0, S);
  cp_async_commit();
  // the bias of step A's key columns, fixed for the block
  float bias[NKA][2];
#pragma unroll
  for (int n = 0; n < NKA; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = k0 + ka + n * 8 + 2 * t + c;
      bias[n][c] = j < S ? __ldg(p.bias + (int64_t)b * S + j) : 0.f;
    }
  float dk[ND][4], dv[ND][4];
  zero(dk);
  zero(dv);

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = it * BQ_KV, buf = it & 1;
    const int i0 = q0 + g;
    const RowStats rs[2] = {row_stats(p, head_base, i0), row_stats(p, head_base, i0 + 8)};
    cp_async_wait_all();
    __syncthreads();  // tile `it` landed; step B of tile it - 1 is done
    if (it + 1 < n_tiles) {
      load_tile<T, BQ_KV, D, LQ, NT_BWD>(sQ + (buf ^ 1) * BQ_KV * LQ, q, p.qs[2], q0 + BQ_KV, S);
      load_tile<T, BQ_KV, D, LQ, NT_BWD>(sdO + (buf ^ 1) * BQ_KV * LQ, dout, p.ds[2],
                                         q0 + BQ_KV, S);
      cp_async_commit();
    }
    const T* sQb = sQ + buf * BQ_KV * LQ;
    const T* sdOb = sdO + buf * BQ_KV * LQ;

    // step A: s = Q K^T and dP = dO V^T of the warp's 16 keys
    float s[NKA][4], dp[NKA][4];
    zero(s);
    zero(dp);
    warp_mma<EXACT, ND, NKA, true>(s, k_contig(sQb, LQ), k_contig(sK + ka * LK, LK));
    warp_mma<EXACT, ND, NKA, true>(dp, k_contig(sdOb, LQ), k_contig(sV + ka * LV, LV));
#pragma unroll
    for (int n = 0; n < NKA; ++n) {
      const int jl = ka + n * 8 + 2 * t, j0 = k0 + jl;
      const uint32_t keep = p.dropout ? keep_bits(mask_base, S, i0, j0, seed, p.threshold) : 15u;
      float pd[4], ds[4];
      softmax_grad4<T>(p, s[n], dp[n], rs, bias[n], keep, i0, j0, pd, ds);
      store2(sPd + g * LP + jl, pd[0], pd[1]);
      store2(sPd + (g + 8) * LP + jl, pd[2], pd[3]);
      store2(sdS + g * LP + jl, ds[0], ds[1]);
      store2(sdS + (g + 8) * LP + jl, ds[2], ds[3]);
    }
    __syncthreads();

    // step B: dV += P_drop^T dO and dK += dS^T Q over the warp's 16 keys
    warp_mma_add<EXACT, BQ_KV / 8, ND>(dv, k_strided<float>(sPd + ka, LP), k_strided(sdOb, LQ));
    warp_mma_add<EXACT, BQ_KV / 8, ND>(dk, k_strided<float>(sdS + ka, LP), k_strided(sQb, LQ));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + ka + g + 8 * r;
    if (j >= S) continue;
    const int64_t at = (((int64_t)b * S + j) * H + h) * D;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      store2((T*)p.dk + at + d * 8 + 2 * t, dk[d][2 * r] * p.scale, dk[d][2 * r + 1] * p.scale);
      store2((T*)p.dv + at + d * 8 + 2 * t, dv[d][2 * r], dv[d][2 * r + 1]);
    }
  }
}

template <typename T, int D>
struct DqTiles {
  static constexpr int LQ = ld_contig<T>(D), LK = ld_contig<T>(D),
                       LS = ld_contig<float>(BK_DQ);
  static constexpr size_t smem =
      sizeof(T) * (2 * BQ_DQ * LQ + 4 * BK_DQ * LK) + sizeof(float) * 4 * 16 * LS;
};

// dQ of one tile of 64 queries, 16 rows per warp: loops over the key tiles
// of BK_DQ (K and V double-buffered); dS goes through a warp-private stage.
template <typename T, int D>
__global__ void __launch_bounds__(NT_BWD, smem_blocks(DqTiles<float, D>::smem))
    attn_dq_kernel(const Params p) {
  using Tl = DqTiles<T, D>;
  constexpr int LQ = Tl::LQ, LK = Tl::LK, LS = Tl::LS, ND = D / 8, NK = BK_DQ / 8;
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + BQ_DQ * LQ;
  T* sK = sdO + BQ_DQ * LQ;     // two buffers
  T* sV = sK + 2 * BK_DQ * LK;  // two buffers
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float* sdS = reinterpret_cast<float*>(sV + 2 * BK_DQ * LK) + warp * 16 * LS;
  const int q0 = blockIdx.x * BQ_DQ, h = blockIdx.y, b = blockIdx.z, S = p.S, H = p.H;
  const int r0 = 16 * warp;
  const T* q = (const T*)p.q + b * p.qs[0] + h * p.qs[1];
  const T* k = (const T*)p.k + b * p.ks[0] + h * p.ks[1];
  const T* v = (const T*)p.v + b * p.vs[0] + h * p.vs[1];
  const T* dout = (const T*)p.dout + b * p.ds[0] + h * p.ds[1];
  const float* bias = p.bias + (int64_t)b * S;
  const uint64_t seed = mask_seed(p.seed, p.b0, b, p.rows_per_seed);
  const uint64_t head_base = (uint64_t)(b * H + h) * S;  // the stats and delta rows
  const uint64_t mask_base = mask_base_of(p.b0, b, p.rows_per_seed, p.H_all, p.h0, h, S);
  const int n_tiles = (S + BK_DQ - 1) / BK_DQ;

  load_tile<T, BQ_DQ, D, LQ, NT_BWD>(sQ, q, p.qs[2], q0, S);
  load_tile<T, BQ_DQ, D, LQ, NT_BWD>(sdO, dout, p.ds[2], q0, S);
  load_tile<T, BK_DQ, D, LK, NT_BWD>(sK, k, p.ks[2], 0, S);
  load_tile<T, BK_DQ, D, LK, NT_BWD>(sV, v, p.vs[2], 0, S);
  cp_async_commit();
  const int i0 = q0 + r0 + g;
  const RowStats rs[2] = {row_stats(p, head_base, i0), row_stats(p, head_base, i0 + 8)};
  float dq[ND][4];
  zero(dq);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK_DQ, buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile `it` landed; every warp is done with tile it - 1
    if (it + 1 < n_tiles) {
      load_tile<T, BK_DQ, D, LK, NT_BWD>(sK + (buf ^ 1) * BK_DQ * LK, k, p.ks[2], k0 + BK_DQ, S);
      load_tile<T, BK_DQ, D, LK, NT_BWD>(sV + (buf ^ 1) * BK_DQ * LK, v, p.vs[2], k0 + BK_DQ, S);
      cp_async_commit();
    }
    const T* sKb = sK + buf * BK_DQ * LK;
    const T* sVb = sV + buf * BK_DQ * LK;

    float s[NK][4], dp[NK][4];
    zero(s);
    zero(dp);
    warp_mma<EXACT, ND, NK, true>(s, k_contig(sQ + r0 * LQ, LQ), k_contig(sKb, LK));
    warp_mma<EXACT, ND, NK, true>(dp, k_contig(sdO + r0 * LQ, LQ), k_contig(sVb, LK));
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int j0 = k0 + n * 8 + 2 * t;
      const float bj[2] = {j0 < S ? __ldg(bias + j0) : 0.f,
                           j0 + 1 < S ? __ldg(bias + j0 + 1) : 0.f};
      const uint32_t keep = p.dropout ? keep_bits(mask_base, S, i0, j0, seed, p.threshold) : 15u;
      float pd[4], ds[4];
      softmax_grad4<T>(p, s[n], dp[n], rs, bj, keep, i0, j0, pd, ds);
      store2(sdS + g * LS + n * 8 + 2 * t, ds[0], ds[1]);
      store2(sdS + (g + 8) * LS + n * 8 + 2 * t, ds[2], ds[3]);
    }
    __syncwarp();
    // dQ += dS K
    warp_mma_add<EXACT, NK, ND>(dq, k_contig<float>(sdS, LS), k_strided(sKb, LK));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i >= S) continue;
    T* dst = (T*)p.dq + (((int64_t)b * S + i) * H + h) * D;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      store2(dst + d * 8 + 2 * t, dq[d][2 * r] * p.scale, dq[d][2 * r + 1] * p.scale);
  }
}

// The keep mask of (B, H, S, S) as uint8, one thread per Philox group
// (rows i0 with bit 3 clear, even columns j0)
__global__ void attn_dropout_mask_kernel(int B, int H, int S, int rows_per_seed, int b0,
                                         int h0, int H_all, const int64_t* seed_ptr,
                                         uint32_t threshold, uint8_t* out) {
  const int half = (S + 1) / 2;
  const int64_t n = (int64_t)B * H * S * half;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int j0 = 2 * (int)(e % half), i0 = (int)((e / half) % S);
    const int64_t bh = e / ((int64_t)half * S);
    if (i0 & 8) continue;
    const int b = (int)(bh / H), h = (int)(bh % H);
    const uint64_t mask_base = mask_base_of(b0, b, rows_per_seed, H_all, h0, h, S);
    const uint32_t keep =
        keep_bits(mask_base, S, i0, j0, mask_seed(seed_ptr, b0, b, rows_per_seed), threshold);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int i = i0 + 8 * (w >> 1), j = j0 + (w & 1);
      if (i < S && j < S) out[(bh * S + i) * S + j] = (keep >> w) & 1u;
    }
  }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const Params& p) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const Params& p, cudaStream_t stream) {
  using Tl = FwdTiles<T, D, NW_FWD, BK_FWD>;
  return launch(attn_fwd_kernel<T, D, NW_FWD, BK_FWD>,
                dim3((p.S + Tl::BQ - 1) / Tl::BQ, p.H, p.B), NW_FWD * 32, Tl::smem, stream, p);
}

template <typename T, int D>
cudaError_t bwd(const Params& p, cudaStream_t stream) {
  const int64_t rows = (int64_t)p.B * p.H * p.S;
  cudaError_t err = launch(attn_delta_kernel<T, D>,
                           dim3((unsigned)((rows + NT_DELTA / 32 - 1) / (NT_DELTA / 32))),
                           NT_DELTA, 0, stream, p);
  if (err != cudaSuccess) return err;
  err = launch(attn_dkdv_kernel<T, D>, dim3((p.S + BKV - 1) / BKV, p.H, p.B), NT_BWD,
               DkdvTiles<T, D>::smem, stream, p);
  if (err != cudaSuccess) return err;
  return launch(attn_dq_kernel<T, D>, dim3((p.S + BQ_DQ - 1) / BQ_DQ, p.H, p.B), NT_BWD,
                DqTiles<T, D>::smem, stream, p);
}

// Whether the block (b0, B of B_all; h0, H of H_all) and the n_seeds seeds fit.
bool block_fits(int B, int H, int n_seeds, int b0, int B_all, int h0, int H_all) {
  return n_seeds >= 1 && B_all % n_seeds == 0 && b0 >= 0 && b0 + B <= B_all && h0 >= 0 &&
         h0 + H <= H_all;
}

Params make_params(int B, int H, int S, const void* q, const int64_t* qs, const void* k,
                   const int64_t* ks, const void* v, const int64_t* vs, const float* bias,
                   const int64_t* seed, int n_seeds, int b0, int B_all, int h0, int H_all,
                   float scale, int threshold, float keep_prob, int dropout) {
  Params p = {};
  p.q = q, p.k = k, p.v = v, p.bias = bias, p.seed = seed;
  for (int i = 0; i < 3; ++i) p.qs[i] = qs[i], p.ks[i] = ks[i], p.vs[i] = vs[i];
  p.B = B, p.H = H, p.S = S, p.rows_per_seed = B_all / n_seeds;
  p.b0 = b0, p.h0 = h0, p.H_all = H_all;
  p.scale = scale, p.keep_prob = keep_prob, p.inv_keep = 1.f / keep_prob;
  p.threshold = (uint32_t)threshold;
  p.dropout = dropout;
  return p;
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16;
// D: 64 or 128; seed: n_seeds int64 elements on the device, n_seeds dividing
// B_all; the call is rows b0 .. b0 + B - 1 of B_all and heads h0 .. h0 + H - 1
// of H_all (0, B, 0, H for a call of its own). Each returns cudaGetLastError()
// after its launches (or the error that refused one); cudaErrorInvalidValue
// for a dtype, D, n_seeds or block it lacks.
extern "C" {

int eeg_attn_fwd(int dtype, int D, int B, int H, int S, const void* q, int64_t qsb,
                 int64_t qsh, int64_t qss, const void* k, int64_t ksb, int64_t ksh,
                 int64_t kss, const void* v, int64_t vsb, int64_t vsh, int64_t vss,
                 const float* bias, const int64_t* seed, int n_seeds, int b0, int B_all,
                 int h0, int H_all, float scale, int threshold, float keep_prob, int dropout,
                 void* out, float* stats, void* stream) {
  const int64_t qs[3] = {qsb, qsh, qss}, ks[3] = {ksb, ksh, kss}, vs[3] = {vsb, vsh, vss};
  if (!block_fits(B, H, n_seeds, b0, B_all, h0, H_all)) return cudaErrorInvalidValue;
  Params p = make_params(B, H, S, q, qs, k, ks, v, vs, bias, seed, n_seeds, b0, B_all, h0,
                         H_all, scale, threshold, keep_prob, dropout);
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
                 const float* bias, const int64_t* seed, int n_seeds, int b0, int B_all,
                 int h0, int H_all, float scale, int threshold, float keep_prob, int dropout,
                 const void* out, const float* stats, const void* dout, int64_t dsb,
                 int64_t dsh, int64_t dss, float* delta, void* dq, void* dk, void* dv,
                 void* stream) {
  const int64_t qs[3] = {qsb, qsh, qss}, ks[3] = {ksb, ksh, kss}, vs[3] = {vsb, vsh, vss};
  if (!block_fits(B, H, n_seeds, b0, B_all, h0, H_all)) return cudaErrorInvalidValue;
  Params p = make_params(B, H, S, q, qs, k, ks, v, vs, bias, seed, n_seeds, b0, B_all, h0,
                         H_all, scale, threshold, keep_prob, dropout);
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
// the same keep_bits as the kernels; nothing on the training path calls it.
int eeg_attn_dropout_mask(int B, int H, int S, const int64_t* seed, int n_seeds, int b0,
                          int B_all, int h0, int H_all, int threshold, uint8_t* out,
                          void* stream) {
  if (!block_fits(B, H, n_seeds, b0, B_all, h0, H_all)) return cudaErrorInvalidValue;
  const int64_t n = (int64_t)B * H * S * ((S + 1) / 2);
  const int64_t blocks = (n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535;
  attn_dropout_mask_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      B, H, S, B_all / n_seeds, b0, h0, H_all, seed, (uint32_t)threshold, out);
  return cudaGetLastError();
}

const char* eeg_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
