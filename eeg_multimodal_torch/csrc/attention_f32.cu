// f32 fused BERT self-attention for Hopper (sm_90a): error-compensated
// 3xTF32 products on wgmma, over operand tiles split once a block, forward
// and backward.
//
// Replaces, at f32, the JAX package's Pallas TPU kernels in ops/attention.py:
// `_fwd_kernel` (attn_fwd_f32_kernel here) and `_bwd_kernel`
// (attn_delta_f32_kernel + attn_dq_f32_kernel + attn_dkdv_f32_kernel).
// attention.cu holds the mask hook and the C interface, which sends every
// f32 call here. The function is the bf16 kernels' (attention_bf16.cu) in
// f32 throughout: scores q k^T * scale + bias[key] and the stable softmax in
// f32, p_drop = keep ? p / (1 - rate) : 0, f32 accumulation; the same
// dropout mask, bit for bit (mask_words, attention.cuh), the same online
// softmax and the same separate m and l in `stats`.
//
// What bounds it on the H100: the matrix products. At (8, 12, 512, 64) the
// forward needs 4 B H S^2 D = 6.44 GFLOP and the backward 10 B H S^2 D =
// 16.1 GFLOP; as three TF32 passes at 495 TFLOP/s that is 39.0 and 97.6 us,
// against 50 MB and 100 MB of operands (15 and 30 us at 3.35 TB/s).
//  - accuracy: the reference runs Precision.HIGHEST. Every operand element
//    is split x = hi + lo (tf32_hi, tf32_lo: hi truncated to TF32, lo the
//    rest rounded to TF32, both with clear low bits) and a b = hi.hi +
//    hi.lo + lo.hi. wgmma's f32 accumulation truncates at each k8 step, so
//    each product chain issues the two small terms first (while the
//    accumulator is small) and hi.hi last, and the sums over the sequence
//    (O, dQ, dK, dV) take each tile's products in a fresh accumulator,
//    added to the running sum in round-to-nearest f32.
//  - TF32 wgmma reads shared-memory operands K-major only (no transpose as
//    for 16-bit types). Q K^T, dO V^T, K Q^T and V dO^T read their tiles as
//    they lie; P V, dS K, P_drop^T dO and dS^T Q need V, K, dO and Q
//    transposed. Each element passes through a thread once anyway, to be
//    split: so a block loads each tile once (16-byte loads, rows past S
//    read as zeros) and writes hi and lo in the layout wgmma reads (KTile,
//    hopper.cuh, no swizzle), as it lies (Rows) and, where a product needs
//    it, transposed (Cols, which also writes the tile as it lies where both
//    are needed). Each element is split once a block, not once a warp and
//    n-tile as with mma.sync, and in dQ and dK/dV two warpgroups share each
//    tile's split.
//  - the A operand of P V, dS K, P_drop^T dO and dS^T Q is the score
//    accumulator itself, split in registers. An m64nN accumulator gives a
//    thread columns 2t, 2t + 1 of each 8-column group; the k8 TF32 A
//    fragment wants k-slots t and t + 4. Cols stores the rows of each group
//    of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7, so that slot t is row 2t and
//    slot t + 4 row 2t + 1: the accumulator is then the A fragment with no
//    shuffle (a0..a3 = registers 0, 2, 1, 3 of a group). P, dS, P_drop^T
//    and dS^T never touch shared memory. At D = 64 the forward holds Q as
//    split A fragments too, so Q K^T reads only K from shared memory.
//  - shared memory is the scarce resource (a 64 x 64 f32 tile is 16 KB, hi
//    and lo 32 KB; the tiles are in F32Cfg): 3 forward blocks an SM at D =
//    64, one dQ block of two warpgroups (128 queries), one dK/dV block of
//    two (128 keys). The products that read
//    both operands from shared memory (the scores) read A again at every k8
//    step, so shared-memory bandwidth, not the tensor cores, sets the pace
//    of those products (PERF.md).
//  - latency: each loop loads its next tile into registers (and the bias,
//    or in dK/dV the query rows' statistics and mask bytes) while it
//    computes on this one, and stores it after the tile's last product;
//    the forward and dQ draw the tile's Philox words while its score
//    products run.
//  - dK/dV holds the transposed tile S^T = K Q^T (keys x queries), so that
//    P_drop^T and dS^T are A fragments; a thread there holds no whole
//    Philox group. As at bf16, the dQ kernel, launched first, draws the
//    mask query-major and leaves its bits in the backward's scratch in the
//    bf16 kernels' geometry (mask_byte), which dK/dV reads: each Philox
//    call is made once a backward.
//  - the backward keeps its deterministic three-kernel shape, no atomics:
//    a pre-pass writes each query row's (m, 1 / l, delta = rowsum(dO O)),
//    then dQ per block of queries, looping over key tiles, then dK and dV
//    per block of keys, looping over query tiles.
//  - loads: plain 16-byte loads through the read-only path: the split needs
//    every element in a register, so TMA would only add a staging tile and,
//    per call, the tensor maps' host time.
// Each wgmma batch is issued, committed and waited for before its
// accumulator is read.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "attention.cuh"
#include "hopper.cuh"

namespace eeg_attn {
namespace {

constexpr int WG = 128;  // threads of a warpgroup
constexpr int NT_DELTA = 256;

// Tiles per head width, chosen by timing on the H100 (PERF.md): whether the
// forward and dQ hold Q in registers (as split A fragments) or in shared
// memory, keys per tile of the forward and of dQ, the warpgroups (64 query
// rows each) of a dQ block, query rows per tile of dK/dV and its
// warpgroups (64 keys each). Every forward block is one warpgroup of 64
// query rows. D = 128 takes what fits in registers and shared memory.
template <int D>
struct F32Cfg;
template <>
struct F32Cfg<64> {
  static constexpr bool FWD_QREG = true, DQ_QREG = true;
  static constexpr int FWD_BK = 32, DQ_BK = 32, DQ_WG = 2, KV_BQ = 32, KV_WG = 2;
};
template <>
struct F32Cfg<128> {
  static constexpr bool FWD_QREG = false, DQ_QREG = false;
  static constexpr int FWD_BK = 32, DQ_BK = 16, DQ_WG = 1, KV_BQ = 16, KV_WG = 1;
};

// Blocks an SM holds at `smem` bytes of dynamic shared memory (228 KB, 1 KB
// of it reserved per block), at most `cap`: the kernels' registers are
// held to that many blocks (__launch_bounds__)
constexpr int blocks_per_sm(int smem, int cap) {
  return 233472 / (smem + 1024) < cap ? 233472 / (smem + 1024) : cap;
}

// the 4 floats at column 4c of row `row` of a (S, D) matrix with row
// stride ld, zeros past S
__device__ __forceinline__ float4 load4(const float* src, int64_t ld, int row, int c, int S) {
  return row < S ? __ldg(reinterpret_cast<const float4*>(src + (int64_t)row * ld) + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Rows row0 .. row0 + R - 1 of a (S, D) f32 matrix (row stride ld), to be
// split into two KTile<R, D, 0> (hi at t, lo after it) as they lie: the
// product's k is the column. load() brings a thread's part into registers
// and store() splits and writes it, so that a loop loads its next tile while
// it computes on this one. A warp takes 8 rows x 4 chunks at a time: lane l
// loads 16 bytes of row l % 8, chunk l / 8, and 8 lanes store one core
// matrix.
template <int R, int D, int NT>
struct Rows {
  using T = KTile<R, D, 0>;
  static constexpr int NW = NT / 32, UNITS = R / 8 * (D / 16), PER = (UNITS + NW - 1) / NW;
  float4 x[PER];
  static __device__ __forceinline__ int unit(int i) { return threadIdx.x / 32 + i * NW; }
  static __device__ __forceinline__ int row(int u) { return 8 * (u % (R / 8)) + threadIdx.x % 8; }
  static __device__ __forceinline__ int chunk(int u) {
    return 4 * (u / (R / 8)) + (threadIdx.x % 32) / 8;
  }
  __device__ __forceinline__ void load(const float* src, int64_t ld, int row0, int S) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = unit(i);
      x[i] = u < UNITS ? load4(src, ld, row0 + row(u), chunk(u), S)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(uint8_t* t) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = unit(i);
      if (u >= UNITS) break;
      const int at = T::at(row(u), chunk(u));
      store_split(t + at, t + T::BYTES + at, x[i]);
    }
  }
};

// The same rows transposed into two KTile<D, R, 16>: tile row d, k the
// source row, and within each group of 8 source rows the order 0, 2, 4, 6,
// 1, 3, 5, 7 (k-slot s holds row 2s, slot s + 4 row 2s + 1), the order in
// which a split m64nN accumulator is the TF32 A fragment. Lane l of a unit
// (d-chunk c = l % 8 of 8, parity p = (l / 8) & 1, group m = l / 16 of 2)
// loads rows 8m + p + 2i (i = 0..3) of chunk c, a 4 x 4 block, and stores
// it transposed: four 16-byte chunks, slots 4p .. 4p + 3 of group m in tile
// rows 4c .. 4c + 3. The tile's PAD puts the 8 lanes of one (m, p), which
// store together, in 8 distinct banks.
template <int R, int D, int NT>
struct Cols {
  using T = KTile<D, R, 16>;
  static constexpr int NW = NT / 32, UNITS = R / 16 * (D / 32), PER = (UNITS + NW - 1) / NW;
  float4 x[PER][4];
  static __device__ __forceinline__ int unit(int i) { return threadIdx.x / 32 + i * NW; }
  static __device__ __forceinline__ int parity() { return (threadIdx.x >> 3) & 1; }
  static __device__ __forceinline__ int chunk(int u) {
    return 8 * (u / (R / 16)) + threadIdx.x % 8;
  }
  static __device__ __forceinline__ int group(int u) {
    return 2 * (u % (R / 16)) + (threadIdx.x % 32) / 16;
  }
  __device__ __forceinline__ void load(const float* src, int64_t ld, int row0, int S) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = unit(i);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        x[i][r] = u < UNITS ? load4(src, ld, row0 + 8 * group(u) + parity() + 2 * r, chunk(u), S)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // the same rows as they lie into two KTile<R, D, 0, 144> (AsLies), from
  // the same registers: 8 lanes store 8 chunks of one row, 144 bytes apart
  using AsLies = KTile<R, D, 0, 144>;
  __device__ __forceinline__ void store_rows(uint8_t* t) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = unit(i);
      if (u >= UNITS) break;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int at = AsLies::at(8 * group(u) + parity() + 2 * r, chunk(u));
        store_split(t + at, t + AsLies::BYTES + at, x[i][r]);
      }
    }
  }
  __device__ __forceinline__ void store(uint8_t* t) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = unit(i);
      if (u >= UNITS) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = T::at(4 * chunk(u) + e, 2 * group(u) + parity());
        store_split(t + at, t + T::BYTES + at,
                    make_float4(comp(x[i][0], e), comp(x[i][1], e), comp(x[i][2], e),
                                comp(x[i][3], e)));
      }
    }
  }
};

// a block's fixed tile, loaded and split at once
template <int R, int D, int NT>
__device__ __forceinline__ void split_rows(uint8_t* t, const float* src, int64_t ld, int row0,
                                           int S) {
  Rows<R, D, NT> x;
  x.load(src, ld, row0, S);
  x.store(t);
}

// Rows i0 and i0 + 8 of a (S, D) f32 matrix (row stride ld, rows past S
// read as zeros) as the split TF32 A fragments of its D / 8 k8 steps:
// register r of step ks holds row i0 + 8 (r & 1), column 8 ks + t + 4 (r >> 1)
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&hi)[D / 8][4], uint32_t (&lo)[D / 8][4],
                                       const float* src, int64_t ld, int i0, int t, int S) {
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = i0 + 8 * (r & 1);
      const float x = row < S ? __ldg(src + (int64_t)row * ld + 8 * ks + t + 4 * (r >> 1)) : 0.f;
      hi[ks][r] = tf32_hi(x);
      lo[ks][r] = tf32_lo(x, hi[ks][r]);
    }
}

// The score accumulator of a k8 step kk (its 8-column group kk), split in
// place into the TF32 A fragments hi and lo: a0..a3 are registers 0, 2, 1,
// 3 of the group (rows g, g + 8 of k-slot t = column 2t; then of slot t + 4
// = column 2t + 1), against tiles whose k order Cols wrote
template <int N>
__device__ __forceinline__ void split_a(const float (&s)[N / 2], uint32_t (&hi)[N / 8][4],
                                        uint32_t (&lo)[N / 8][4]) {
  constexpr int E[4] = {0, 2, 1, 3};
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = s[4 * kk + E[r]];
      hi[kk][r] = tf32_hi(x);
      lo[kk][r] = tf32_lo(x, hi[kk][r]);
    }
}

// d (fresh) = A B as 3xTF32 over `steps` k8 steps, both operands tiles (hi
// at a / b, lo BYTES after): hi.lo and lo.hi first, hi.hi last
template <int N, int STEPS, typename TA, typename TB>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], const uint8_t* a, int arow,
                                        const uint8_t* b) {
#pragma unroll
  for (int ks = 0; ks < STEPS; ++ks)
    wgmma_tf32_ss<N>(d, TA::desc(a, arow, ks), TB::desc(b + TB::BYTES, 0, ks), ks > 0);
#pragma unroll
  for (int ks = 0; ks < STEPS; ++ks)
    wgmma_tf32_ss<N>(d, TA::desc(a + TA::BYTES, arow, ks), TB::desc(b, 0, ks), 1);
#pragma unroll
  for (int ks = 0; ks < STEPS; ++ks)
    wgmma_tf32_ss<N>(d, TA::desc(a, arow, ks), TB::desc(b, 0, ks), 1);
}

// d (fresh) = A B as 3xTF32, A the split accumulator (hi, lo), B a tile
template <int N, int STEPS, typename TB>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2], const uint32_t (&hi)[STEPS][4],
                                        const uint32_t (&lo)[STEPS][4], const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) wgmma_tf32_rs<N>(d, lo[kk], TB::desc(b, 0, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) wgmma_tf32_rs<N>(d, hi[kk], TB::desc(b + TB::BYTES, 0, kk), 1);
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) wgmma_tf32_rs<N>(d, hi[kk], TB::desc(b, 0, kk), 1);
}

template <int N>
__device__ __forceinline__ void add(float (&acc)[N], const float (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += part[i];
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int D, int BK>
struct FwdF32 {
  using TQ = KTile<64, D, 0>;  // Q
  using TK = KTile<BK, D, 0>;  // K
  using TV = KTile<D, BK, 16>;  // V^T
  static constexpr bool QREG = F32Cfg<D>::FWD_QREG;
  static constexpr int SMEM = 2 * ((QREG ? 0 : TQ::BYTES) + TK::BYTES + TV::BYTES);
};

// One block per (64 queries, head, batch row): Q split once (registers or
// a tile); for each key tile, K and V^T split into shared memory, S = Q K^T,
// the online softmax (a running row max m and sum l, the output rescaled
// by exp(m_old - m_new) each tile), then O += P V with P split in
// registers.
template <int D, int BK>
__global__ void __launch_bounds__(WG,
                                  blocks_per_sm(FwdF32<D, BK>::SMEM, FwdF32<D, BK>::QREG ? 2 : 3))
    attn_fwd_f32_kernel(const Params p) {
  using C = FwdF32<D, BK>;
  using TQ = typename C::TQ;
  using TK = typename C::TK;
  using TV = typename C::TV;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float sBias[BK];  // the key tile's bias
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + (C::QREG ? 0 : 2 * TQ::BYTES);
  uint8_t* sV = sK + 2 * TK::BYTES;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z, S = p.S;
  const float* q = (const float*)p.q + b * p.qs[0] + h * p.qs[1];
  const float* k = (const float*)p.k + b * p.ks[0] + h * p.ks[1];
  const float* v = (const float*)p.v + b * p.vs[0] + h * p.vs[1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int i0 = q0 + warp * 16 + g;  // the thread's rows i0 and i0 + 8
  const float* bias = p.bias + (int64_t)b * S;
  const uint64_t seed = mask_seed(p.seed, p.b0, b, p.rows_per_seed);
  const uint64_t mask_base = mask_base_of(p.b0, b, p.rows_per_seed, p.H_all, p.h0, h, S);
  const uint32_t thr8 = p.dropout ? p.threshold << 8 : 0xffffffffu;  // words 0 when off
  uint32_t qh[C::QREG ? D / 8 : 1][4], ql[C::QREG ? D / 8 : 1][4];  // Q, or a tile
  if constexpr (C::QREG) {
    load_a<D>(qh, ql, q, p.qs[2], i0, t, S);
  } else {
    split_rows<64, D, WG>(sQ, q, p.qs[2], q0, S);
  }
  float o[D / 2];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // this thread's part of l
  const int n_tiles = (S + BK - 1) / BK;
  // the next key tile, in registers: K, V and the bias (-inf past S)
  Rows<BK, D, WG> kx;
  Cols<BK, D, WG> vx;
  kx.load(k, p.ks[2], 0, S);
  vx.load(v, p.vs[2], 0, S);
  float bx = threadIdx.x < BK && (int)threadIdx.x < S ? __ldg(bias + threadIdx.x) : -INFINITY;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    if (it > 0) __syncthreads();  // every warp is done with the last tile
    {
      kx.store(sK);
      vx.store(sV);
    }
    if (threadIdx.x < BK) sBias[threadIdx.x] = bx;
    fence_async_smem();
    __syncthreads();
    if (it + 1 < n_tiles) {  // in flight while this tile computes
      kx.load(k, p.ks[2], k0 + BK, S);
      vx.load(v, p.vs[2], k0 + BK, S);
      const int j = k0 + BK + threadIdx.x;
      bx = threadIdx.x < BK && j < S ? __ldg(bias + j) : -INFINITY;
    }
    float s[BK / 2];  // S = Q K^T
    wg_fence();
    if constexpr (C::QREG) {
      mma3_rs<BK, D / 8, TK>(s, qh, ql, sK);
    } else {
      mma3_ss<BK, D / 8, TQ, TK>(s, sQ, 0, sK);
    }
    wg_commit();
    // while the products run: the tile's keep bits, bit 4n + e for register
    // 4n + e (one Philox call a thread and 8-column group)
    uint32_t keep = 0xffffffffu;
    if (p.dropout) {
      keep = 0u;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const uint4 w = mask_words(mask_base, S, i0, k0 + n * 8 + 2 * t, seed);
#pragma unroll
        for (int e = 0; e < 4; ++e) keep |= (uint32_t)kept8(word(w, e), thr8) << (4 * n + e);
      }
    }
    wg_wait();
    hold(s);

    // s * scale + bias[key] (-inf past S, where K's rows are zeros), the
    // row maxima of the thread's two rows
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float bj = sBias[n * 8 + 2 * t + c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = s[4 * n + 2 * r + c];
          x = fmaf(x, p.scale, bj);
          mt[r] = fmaxf(mt[r], x);
        }
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
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      const float pe = fast_exp(s[x] - m[(x >> 1) & 1]);
      l[(x >> 1) & 1] += pe;
      s[x] = (keep >> x) & 1u ? pe : 0.f;
    }
    uint32_t ph[BK / 8][4], pl[BK / 8][4];  // P with the mask applied, split
    split_a<BK>(s, ph, pl);
    float pv[D / 2];  // this tile's P V, added to the rescaled O below
    wg_fence();
    mma3_rs<D, BK / 8, TV>(pv, ph, pl, sV);
    wg_commit();
    wg_wait();
    hold(pv);
    hold(ph);
    hold(pl);
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * d + e] = fmaf(o[4 * d + e], alpha[e >> 1], pv[4 * d + e]);
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
    float2* out = reinterpret_cast<float2*>((float*)p.out + (((int64_t)b * S + i) * p.H + h) * D);
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      out[d * 4 + t] = make_float2(o[4 * d + 2 * r] * inv, o[4 * d + 2 * r + 1] * inv);
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
// scratch, delta = sum_d dO * O, D / 4 threads a row, 16 bytes each
template <int D>
__global__ void __launch_bounds__(NT_DELTA) attn_delta_f32_kernel(const Params p) {
  constexpr int TPR = D / 4;  // threads a row
  const int64_t row = (int64_t)blockIdx.x * (NT_DELTA / TPR) + threadIdx.x / TPR;
  const int c = (threadIdx.x % TPR) * 4;
  const int S = p.S, H = p.H;
  const int64_t rows = (int64_t)p.B * H * S;
  const bool in = row < rows;
  float acc = 0.f;
  if (in) {
    const int i = (int)(row % S), h = (int)((row / S) % H), b = (int)(row / ((int64_t)S * H));
    const float4 x = __ldg(reinterpret_cast<const float4*>(
        (const float*)p.dout + b * p.ds[0] + h * p.ds[1] + i * p.ds[2] + c));
    const float4 y = __ldg(reinterpret_cast<const float4*>(
        (const float*)p.o + (((int64_t)b * S + i) * H + h) * D + c));
    acc = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, x.w * y.w)));
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && threadIdx.x % TPR == 0)
    reinterpret_cast<float4*>(p.delta)[row] =
        make_float4(p.stats[row], 1.f / p.stats[rows + row], acc, 0.f);
}

// a dQ thread's keep bits of one key tile, BK / 8 bytes (mask_byte)
template <int BK>
__device__ __forceinline__ void store_mask_bytes(uint8_t* at, uint64_t bytes) {
  if (BK == 64) {
    *reinterpret_cast<uint64_t*>(at) = bytes;
  } else if (BK == 32) {
    *reinterpret_cast<uint32_t*>(at) = (uint32_t)bytes;
  } else {
    *reinterpret_cast<uint16_t*>(at) = (uint16_t)bytes;
  }
}

template <int D, int BK, int NWG>
struct DqF32 {
  static constexpr bool QREG = F32Cfg<D>::DQ_QREG;  // Q as split A fragments
  using TQ = KTile<64 * NWG, D, 0>;  // Q and dO
  using TK = KTile<BK, D, 0, 144>;    // K (written by Cols, with K^T)
  using TV = KTile<BK, D, 0>;        // V
  using TT = KTile<D, BK, 16>;       // K^T
  static constexpr int SMEM =
      2 * ((QREG ? 1 : 2) * TQ::BYTES + TK::BYTES + TV::BYTES + TT::BYTES);
};

// dQ of one block of 64 NWG queries, 64 a warpgroup: Q (registers or a
// tile) and dO split once;
// for each key tile K, V and K^T split into shared memory, shared by the
// warpgroups, S = Q K^T and dP = dO V^T recomputed, dS formed in registers
// (and the tile's mask bits left for dK/dV), dQ += dS K.
template <int D, int BK, int NWG>
__global__ void __launch_bounds__(WG* NWG, blocks_per_sm(DqF32<D, BK, NWG>::SMEM, 3))
    attn_dq_f32_kernel(const Params p) {
  using C = DqF32<D, BK, NWG>;
  constexpr int NT = WG * NWG;
  using TQ = typename C::TQ;
  using TK = typename C::TK;
  using TV = typename C::TV;
  using TT = typename C::TT;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float sBias[BK];  // the key tile's bias
  uint8_t* sQ = smem;
  uint8_t* sdO = sQ + (C::QREG ? 0 : 2 * TQ::BYTES);
  uint8_t* sK = sdO + 2 * TQ::BYTES;
  uint8_t* sV = sK + 2 * TK::BYTES;
  uint8_t* sKt = sV + 2 * TV::BYTES;
  const int q0 = blockIdx.x * 64 * NWG, h = blockIdx.y, b = blockIdx.z, S = p.S;
  const float* q = (const float*)p.q + b * p.qs[0] + h * p.qs[1];
  const float* k = (const float*)p.k + b * p.ks[0] + h * p.ks[1];
  const float* v = (const float*)p.v + b * p.vs[0] + h * p.vs[1];
  const float* dout = (const float*)p.dout + b * p.ds[0] + h * p.ds[1];
  const int wg = threadIdx.x / WG, warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int i0 = q0 + 64 * wg + warp * 16 + g;
  const float* bias = p.bias + (int64_t)b * S;
  const uint64_t seed = mask_seed(p.seed, p.b0, b, p.rows_per_seed);
  const uint64_t head_base = (uint64_t)(b * p.H + h) * S;  // the stats rows
  const uint64_t mask_base = mask_base_of(p.b0, b, p.rows_per_seed, p.H_all, p.h0, h, S);
  const uint32_t thr8 = p.dropout ? p.threshold << 8 : 0xffffffffu;  // words 0 when off
  uint32_t qh[C::QREG ? D / 8 : 1][4], ql[C::QREG ? D / 8 : 1][4];  // Q, or a tile
  if constexpr (C::QREG) {
    load_a<D>(qh, ql, q, p.qs[2], i0, t, S);
  } else {
    split_rows<64 * NWG, D, NT>(sQ, q, p.qs[2], q0, S);
  }
  split_rows<64 * NWG, D, NT>(sdO, dout, p.ds[2], q0, S);
  const RowStats rs[2] = {stats_of(p, head_base, i0), stats_of(p, head_base, i0 + 8)};
  float dq[D / 2];
  zero(dq);
  const int n_tiles = (S + BK - 1) / BK;
  // the next key tile, in registers: K (for K as it lies and K^T), V and
  // the bias
  Rows<BK, D, NT> vx;
  Cols<BK, D, NT> ktx;
  vx.load(v, p.vs[2], 0, S);
  ktx.load(k, p.ks[2], 0, S);
  float bx = threadIdx.x < BK && (int)threadIdx.x < S ? __ldg(bias + threadIdx.x) : 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    if (it > 0) __syncthreads();  // every warp is done with the last tile
    {
      ktx.store_rows(sK);
      vx.store(sV);
      ktx.store(sKt);
    }
    if (threadIdx.x < BK) sBias[threadIdx.x] = bx;
    fence_async_smem();
    __syncthreads();
    if (it + 1 < n_tiles) {  // in flight while this tile computes
      vx.load(v, p.vs[2], k0 + BK, S);
      ktx.load(k, p.ks[2], k0 + BK, S);
      const int j = k0 + BK + threadIdx.x;
      bx = threadIdx.x < BK && j < S ? __ldg(bias + j) : 0.f;
    }
    float s[BK / 2], dp[BK / 2];  // S = Q K^T, dP = dO V^T
    wg_fence();
    if constexpr (C::QREG) {
      mma3_rs<BK, D / 8, TK>(s, qh, ql, sK);
    } else {
      mma3_ss<BK, D / 8, TQ, TK>(s, sQ, 64 * wg, sK);
    }
    mma3_ss<BK, D / 8, TQ, TV>(dp, sdO, 64 * wg, sV);
    wg_commit();
    // while the products run: the tile's keep bits, also for dK/dV, a
    // nibble (bit e for register 4n + e) at bit 8n
    uint64_t bytes = 0;
    if (p.dropout) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const uint4 w = mask_words(mask_base, S, i0, k0 + n * 8 + 2 * t, seed);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bytes |= (uint64_t)kept8(word(w, e), thr8) << (8 * n + e);
      }
    }
    wg_wait();
    hold(s);
    hold(dp);

#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const int j0 = k0 + n * 8 + 2 * t;
      const float bj[2] = {sBias[n * 8 + 2 * t], sBias[n * 8 + 2 * t + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pd;
        softmax_grad(p, s[4 * n + e], dp[4 * n + e], bj[e & 1], rs[e >> 1],
                     (bytes >> (8 * n + e)) & 1u, i0 + 8 * (e >> 1) < S && j0 + (e & 1) < S, pd,
                     s[4 * n + e]);
      }
    }
    // rows i0 (g even) and i0 + 1 (lane ^ 4) share a byte; the scratch holds
    // the rows of S rounded up to 64, all that dK/dV reads, and a block of
    // two warpgroups may reach 64 rows past them
    if (p.dropout) {
      const uint64_t odd = __shfl_xor_sync(0xffffffffu, bytes, 4);
      if ((g & 1) == 0 && i0 < (S + 63) / 64 * 64)
        store_mask_bytes<BK>(mask_bytes(p) + mask_byte(p, b * p.H + h, i0, k0 + 2 * t),
                             bytes | (odd << 4));
    }
    uint32_t dh[BK / 8][4], dl[BK / 8][4];  // dS, split
    split_a<BK>(s, dh, dl);
    float part[D / 2];  // this tile's dS K
    wg_fence();
    mma3_rs<D, BK / 8, TT>(part, dh, dl, sKt);
    wg_commit();
    wg_wait();
    hold(part);
    hold(dh);
    hold(dl);
    add(dq, part);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i >= S) continue;
    float2* dst = reinterpret_cast<float2*>((float*)p.dq + (((int64_t)b * S + i) * p.H + h) * D);
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      dst[d * 4 + t] = make_float2(dq[4 * d + 2 * r] * p.scale, dq[4 * d + 2 * r + 1] * p.scale);
  }
}

template <int D, int BQ, int NWG>
struct KvF32 {
  static constexpr int BK = 64 * NWG;  // keys a block
  using TK = KTile<BK, D, 0>;    // K and V
  using TQ = KTile<BQ, D, 0, 144>;  // Q and dO (written by Cols, with Q^T, dO^T)
  using TT = KTile<D, BQ, 16>;   // Q^T and dO^T
  static constexpr int SMEM = 2 * (2 * TK::BYTES + 2 * TQ::BYTES + 2 * TT::BYTES);
};

// dK and dV of one block of 64 NWG keys, 64 a warpgroup: K and V split
// once; for each query tile Q, dO (as they lie) and Q^T, dO^T split into
// shared memory, shared by the warpgroups; S^T = K Q^T and dP^T = V dO^T
// recomputed, P_drop^T and dS^T formed in registers (the mask from the dQ
// kernel's bytes), dV += P_drop^T dO and dK += dS^T Q.
template <int D, int BQ, int NWG>
__global__ void __launch_bounds__(WG* NWG, blocks_per_sm(KvF32<D, BQ, NWG>::SMEM, 3))
    attn_dkdv_f32_kernel(const Params p) {
  using C = KvF32<D, BQ, NWG>;
  using TK = typename C::TK;
  using TQ = typename C::TQ;
  using TT = typename C::TT;
  constexpr int NT = WG * NWG;
  extern __shared__ __align__(16) uint8_t smem[];
  // the query tile's row statistics, and the mask bytes of its pair rows
  // (BQ / 4) and the block's 64-key tiles (NWG), 32 bytes each (mask_byte)
  __shared__ float4 sStats[BQ];
  __shared__ uint32_t sMask[BQ / 4 * NWG * 8];
  uint8_t* sK = smem;
  uint8_t* sV = sK + 2 * TK::BYTES;
  uint8_t* sQ = sV + 2 * TK::BYTES;
  uint8_t* sdO = sQ + 2 * TQ::BYTES;
  uint8_t* sQt = sdO + 2 * TQ::BYTES;
  uint8_t* sdOt = sQt + 2 * TT::BYTES;
  const int k0 = blockIdx.x * C::BK, h = blockIdx.y, b = blockIdx.z, S = p.S;
  const float* q = (const float*)p.q + b * p.qs[0] + h * p.qs[1];
  const float* k = (const float*)p.k + b * p.ks[0] + h * p.ks[1];
  const float* v = (const float*)p.v + b * p.vs[0] + h * p.vs[1];
  const float* dout = (const float*)p.dout + b * p.ds[0] + h * p.ds[1];
  const int wg = threadIdx.x / WG, warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int j0 = k0 + 64 * wg + warp * 16 + g;  // the thread's keys j0 and j0 + 8
  const uint64_t head_base = (uint64_t)(b * p.H + h) * S;  // the stats rows
  split_rows<C::BK, D, NT>(sK, k, p.ks[2], k0, S);
  split_rows<C::BK, D, NT>(sV, v, p.vs[2], k0, S);
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    bias[r] = j0 + 8 * r < S ? __ldg(p.bias + (int64_t)b * S + j0 + 8 * r) : 0.f;
  float dk[D / 2], dv[D / 2];
  zero(dk);
  zero(dv);
  const int n_tiles = (S + BQ - 1) / BQ;
  // the next query tile, in registers: Q and dO (for them as they lie and
  // transposed)
  Cols<BQ, D, NT> qtx, otx;
  // and its row statistics (thread x < BQ: row x) and mask bytes (thread x
  // < BQ NWG 2: 4 bytes of pair row x / (8 NWG), key tile x / 8 % NWG)
  float4 stx;
  uint32_t mkx;
  const auto load_small = [&](int q0) {
    const int x = threadIdx.x;
    stx = x < BQ && q0 + x < S
              ? __ldg(reinterpret_cast<const float4*>(p.delta) + head_base + q0 + x)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    const int pr = x / (8 * NWG), kt = x / 8 % NWG;
    const int i0 = q0 + 16 * (pr / 4) + 2 * (pr % 4);
    mkx = p.dropout && x < BQ * NWG * 2 && k0 + 64 * kt < S
              ? __ldg(reinterpret_cast<const uint32_t*>(
                    mask_bytes(p) + mask_byte(p, b * p.H + h, i0, k0 + 64 * kt)) + x % 8)
              : 0u;
  };
  qtx.load(q, p.qs[2], 0, S);
  otx.load(dout, p.ds[2], 0, S);
  load_small(0);

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = it * BQ;
    if (it > 0) __syncthreads();  // every warp is done with the last query tile
    {
      qtx.store_rows(sQ);
      otx.store_rows(sdO);
      qtx.store(sQt);
      otx.store(sdOt);
    }
    if (threadIdx.x < BQ) sStats[threadIdx.x] = stx;
    if (threadIdx.x < BQ * NWG * 2) sMask[threadIdx.x] = mkx;
    fence_async_smem();
    __syncthreads();
    if (it + 1 < n_tiles) {  // in flight while this tile computes
      qtx.load(q, p.qs[2], q0 + BQ, S);
      otx.load(dout, p.ds[2], q0 + BQ, S);
      load_small(q0 + BQ);
    }
    float s[BQ / 2], dp[BQ / 2];  // S^T = K Q^T, dP^T = V dO^T
    wg_fence();
    mma3_ss<BQ, D / 8, TK, TQ>(s, sK, 64 * wg, sQ);
    mma3_ss<BQ, D / 8, TK, TQ>(dp, sV, 64 * wg, sdO);
    wg_commit();
    wg_wait();
    hold(s);
    hold(dp);

    // P_drop^T into s, dS^T into dp
#pragma unroll
    for (int u = 0; u < BQ / 16; ++u) {
      const int a = q0 + 16 * u + 2 * t;  // queries a, a + 1 (group 2u), a + 8, a + 9 (2u + 1)
      uint32_t keep[2] = {15u, 15u};
      if (p.dropout) {
        const uint8_t* bytes = reinterpret_cast<const uint8_t*>(sMask) + (4 * u + t) * NWG * 32;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = j0 + 8 * r - k0;  // the key in the block
          keep[r] = keep_of_byte(bytes[(j >> 6) * 32 + ((j >> 1) & 3) * 8 + ((j & 63) >> 3)], j);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = a + (c & 1) + 8 * (c >> 1);
        const float4 st = sStats[i - q0];
        const RowStats rs = {st.x, st.y, st.z};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * (2 * u + (c >> 1)) + 2 * r + (c & 1);
          softmax_grad(p, s[x], dp[x], bias[r], rs, (keep[r] >> c) & 1u,
                       i < S && j0 + 8 * r < S, s[x], dp[x]);
        }
      }
    }
    uint32_t ph[BQ / 8][4], pl[BQ / 8][4], dh[BQ / 8][4], dl[BQ / 8][4];
    split_a<BQ>(s, ph, pl);
    split_a<BQ>(dp, dh, dl);
    // this tile's P_drop^T dO, then its dS^T Q, in one partial (the
    // registers hold dK, dV and one partial, not two)
    float part[D / 2];
    wg_fence();
    mma3_rs<D, BQ / 8, TT>(part, ph, pl, sdOt);
    wg_commit();
    wg_wait();
    hold(part);
    add(dv, part);
    wg_fence();
    mma3_rs<D, BQ / 8, TT>(part, dh, dl, sQt);
    wg_commit();
    wg_wait();
    hold(part);
    add(dk, part);
    hold(ph);
    hold(pl);
    hold(dh);
    hold(dl);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + 8 * r;
    if (j >= S) continue;
    const int64_t at = (((int64_t)b * S + j) * p.H + h) * D;
    float2* dkp = reinterpret_cast<float2*>((float*)p.dk + at);
    float2* dvp = reinterpret_cast<float2*>((float*)p.dv + at);
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      dkp[d * 4 + t] = make_float2(dk[4 * d + 2 * r] * p.scale, dk[4 * d + 2 * r + 1] * p.scale);
      dvp[d * 4 + t] = make_float2(dv[4 * d + 2 * r], dv[4 * d + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, int smem, std::atomic<uint32_t>& ready,
                   cudaStream_t stream, const Params& p) {
  const cudaError_t err = allow_smem(kernel, smem, ready);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_fwd(const Params& p, cudaStream_t stream) {
  constexpr int BK = F32Cfg<D>::FWD_BK;
  static std::atomic<uint32_t> ready{0};
  return launch(attn_fwd_f32_kernel<D, BK>, dim3((p.S + 63) / 64, p.H, p.B), WG,
                FwdF32<D, BK>::SMEM, ready, stream, p);
}

template <int D>
cudaError_t run_bwd(const Params& p, cudaStream_t stream) {
  using Cfg = F32Cfg<D>;
  using Kv = KvF32<D, Cfg::KV_BQ, Cfg::KV_WG>;
  static std::atomic<uint32_t> ready_dq{0}, ready_kv{0};
  const int64_t rows = (int64_t)p.B * p.H * p.S, per_block = NT_DELTA / (D / 4);
  attn_delta_f32_kernel<D>
      <<<(unsigned)((rows + per_block - 1) / per_block), NT_DELTA, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dQ first: it draws the mask and leaves it for dK/dV
  using Dq = DqF32<D, Cfg::DQ_BK, Cfg::DQ_WG>;
  err = launch(attn_dq_f32_kernel<D, Cfg::DQ_BK, Cfg::DQ_WG>,
               dim3((p.S + 64 * Cfg::DQ_WG - 1) / (64 * Cfg::DQ_WG), p.H, p.B), WG * Cfg::DQ_WG,
               Dq::SMEM, ready_dq, stream, p);
  if (err != cudaSuccess) return err;
  return launch(attn_dkdv_f32_kernel<D, Cfg::KV_BQ, Cfg::KV_WG>,
                dim3((p.S + Kv::BK - 1) / Kv::BK, p.H, p.B), WG * Cfg::KV_WG, Kv::SMEM, ready_kv,
                stream, p);
}

}  // namespace

cudaError_t fwd_f32(const Params& p, int D, cudaStream_t stream) {
  if (D == 64) return run_fwd<64>(p, stream);
  if (D == 128) return run_fwd<128>(p, stream);
  return cudaErrorInvalidValue;
}

cudaError_t bwd_f32(const Params& p, int D, cudaStream_t stream) {
  if (D == 64) return run_bwd<64>(p, stream);
  if (D == 128) return run_bwd<128>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace eeg_attn
