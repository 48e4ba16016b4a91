// f32 matrix products for Hopper (sm_90a): C = A B (+ bias) with f32
// accuracy on the tensor cores, as error-compensated 3xTF32 on wgmma. The
// linear layers' forward and both of their gradients (ops/gemm.py routes
// models/layers.py::linear's large f32 products here).
//
// Replaces no TPU kernel: the JAX package leaves its products to XLA at
// Precision.HIGHEST. It was added because cuBLAS computes an f32 product
// with TF32 off on the CUDA cores (its SIMT sgemm, about 45 TFLOP/s at
// BERT-base's shapes), and those products were most of the f32 train
// step's device time (PERF.md). The arithmetic is attention_f32.cu's:
//  - accuracy: every operand element is split x = hi + lo (tf32_hi,
//    tf32_lo, hopper.cuh: hi truncated to TF32, lo the rest rounded to
//    TF32) and a b = hi.hi + hi.lo + lo.hi, which keeps about 21 bits.
//    wgmma's f32 accumulation truncates at each k8 step, so the products
//    of every FLUSH stages of BK = 32 reduction indices go to a fresh
//    partial sum, the two small terms of each stage first and hi.hi last,
//    which is added to the running sum in round-to-nearest f32.
//  - what bounds it on the H100: the products. 2 M N K operations as three
//    TF32 passes at 495 TFLOP/s (165 TFLOP/s of f32 products); BERT-base's
//    (4096 x 768) @ (768 x 3072) is 19.3 GFLOP, 117 us at that rate,
//    against 72 MB of operands and output (21 us at 3.35 TB/s). In practice
//    shared memory and the per-stage wait set the pace (PERF.md): the split
//    operands of a wgmma that reads both from shared memory cost more than
//    the tensor cores' time, so A never goes there.
//  - A from registers (wgmma's A in registers, B from shared memory): each
//    thread loads its own rows of A, split in registers into the TF32 A
//    fragments; a stage's indices are dealt to the k8 steps in the order
//    that makes a thread's fragment values 8 consecutive indices (two
//    16-byte loads a row), and a thread's two fragment rows neighbouring
//    rows of C (one 8-byte load an index where A is stored transposed).
//  - B through shared memory, split once a block: TF32 wgmma reads it
//    K-major only, so each thread loads 4 x 4 blocks and stores them
//    transposed where B lies N-major, in the same index order (KTile,
//    hopper.cuh, no swizzle), a double-buffered ring of two stages (65 KB).
//  - latency: the same threads load, split and compute. While stage s's
//    products run, they split stage s + 1's B (loaded into registers a
//    stage earlier) into the other half of the ring and load stage s + 2's;
//    after them, stage s + 1's A. A block computes a 128 x 128 tile of C
//    with two warpgroups (64 rows each, m64n128k8), one block an SM
//    (registers).
//  - layouts: the forward's x (M x K) as it lies, its kernel (K x N) stored
//    K x N; the input gradient's dY (M x N) as it lies and the kernel read
//    as the product's B of N' = K rows; the weight gradient's x^T and dY
//    both stored transposed. Every element of B passes through a thread
//    once a block anyway, to be split, so a transpose costs no extra pass.
//  - too few tiles to fill the card (the weight gradient of a 768 x 768
//    kernel is 36 tiles; the decoder's 640-row products 30): split-K over
//    the reduction (grid.z), each split's tile written to a workspace and
//    the last block of a tile to arrive (a counter a tile, which that block
//    resets to 0) summing the splits in their order and storing C: one
//    launch, the same sums whichever block comes last.
// Rows of C past M, columns past N and reduction indices past K are zeros
// in the tiles and never stored: any M; N and the contiguous dimension of
// each operand a multiple of 4 (16-byte loads), checked by the C interface
// and, with the strides and alignment, by the wrapper.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace eeg_gemm {
namespace {

using namespace eeg_attn;

constexpr int WG = 128;       // threads of a warpgroup
constexpr int NWG = 2;        // warpgroups a block, 64 rows of C each
constexpr int NT = WG * NWG;  // threads a block
constexpr int BM = 64 * NWG;  // rows of C a block
constexpr int BN = 128;       // columns of C a block
constexpr int BK = 32;        // reduction indices a stage
constexpr int PAD = 16;       // KTile's row-group padding: transposed stores hit distinct banks

struct GemmParams {
  const float* a;
  const float* b;
  const float* bias;  // N elements, or null
  float* c;
  float* ws;       // split-K: splits x tiles x BM x BN floats
  int* counters;   // split-K: one a tile, 0 on entry, left at 0
  int64_t lda, ldb, ldc;
  int M, N, K;
  int chunks;  // BK-stages a split
};

// The reduction order of a stage. A k8 step's TF32 A fragment gives thread
// t (lane 4 g + t) the k-slots t and t + 4; slot s of step ks holds the
// stage's index 8 s + 2 ks (s < 4) or 8 (s - 4) + 2 ks + 1, so that thread
// t's slots over the stage's 4 steps are its 8 indices 8 t .. 8 t + 7, two
// 16-byte loads a row. B's tile is laid out in the same order: its 16-byte
// chunk c (slots 4 (c % 2) .. + 3 of step c / 2) holds the indices c, c + 8,
// c + 16, c + 24.

// A, the warpgroup's 64 rows, held in registers as the split TF32 fragments
// of the stage's 4 k8 steps. A thread's fragment rows g and g + 8 of its
// warp's 16 are the rows R = 16 warp + 2 g and R + 1 of the warpgroup's
// (the epilogue stores them there), its indices 8 t .. 8 t + 7. load()
// brings the next stage's raw values into registers, split() turns them
// into the fragments (register r of step ks: row R + (r & 1), index 8 t +
// 2 ks + (r >> 1)). T = false: A as it lies (row m, index k at src[m ld +
// k]), two 16-byte loads a row; T = true: A stored transposed (at src[k ld
// + m]), the two rows' neighbouring values an 8-byte load at each index, 8
// lanes a warp's 64 bytes.
template <bool T>
struct AFrag {
  float v[2][8];  // rows R, R + 1
  __device__ __forceinline__ void load(const float* src, int64_t ld, int R, int rows, int k0,
                                       int K) {
    const int k = k0 + 8 * (threadIdx.x % 4);
    if constexpr (!T) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 x = R + r < rows && k + 4 * h < K
                               ? __ldg(reinterpret_cast<const float4*>(src + (int64_t)(R + r) * ld + k) + h)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          v[r][4 * h] = x.x, v[r][4 * h + 1] = x.y, v[r][4 * h + 2] = x.z, v[r][4 * h + 3] = x.w;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // rows is even: R + 1 < rows with R
        const float2 x = R < rows && k + j < K
                             ? __ldg(reinterpret_cast<const float2*>(src + (int64_t)(k + j) * ld + R))
                             : make_float2(0.f, 0.f);
        v[0][j] = x.x, v[1][j] = x.y;
      }
    }
  }
  __device__ __forceinline__ void split(uint32_t (&hi)[BK / 8][4], uint32_t (&lo)[BK / 8][4]) const {
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = v[r & 1][2 * ks + (r >> 1)];
        hi[ks][r] = tf32_hi(x);
        lo[ks][r] = tf32_lo(x, hi[ks][r]);
      }
  }
};

// B's part of a stage, tile rows n0 .. n0 + BN - 1 (columns of C) x the
// stage's BK indices, as two KTile<BN, BK, PAD> (hi, then lo BYTES after
// it), in the stage's reduction order. Each thread loads a 4 x 4 block and
// stores it transposed, four 16-byte chunks. T = true: B stored K x N (at
// src[k ld + n]); the thread loads tile rows r .. r + 3 (16 bytes) of the
// indices c, c + 8, c + 16, c + 24 and stores chunk c of each of the 4
// rows, lane l rows 4 (l % 8) .., chunk l / 8 of its warp's four: the 8
// lanes that store together write rows 4 apart, which PAD spreads over
// distinct banks. T = false: B stored N x K (at src[n ld + k]); the thread
// loads row r's indices 8 j + 4 q .. + 3 (j = 0 .. 3) and stores chunks 4 q
// .. 4 q + 3 of row r, lane l row l of its warp's 32: 8 lanes, 8
// consecutive rows, one core matrix.
template <bool T>
struct BTile {
  using Tile = KTile<BN, BK, PAD>;
  float4 x[4];
  static __device__ __forceinline__ int warp() { return threadIdx.x / 32; }
  static __device__ __forceinline__ int lane() { return threadIdx.x % 32; }
  __device__ __forceinline__ void load(const float* src, int64_t ld, int n0, int cols, int k0,
                                       int K) {
    if constexpr (T) {
      const int r = n0 + 32 * (warp() % 4) + 4 * (lane() % 8), c = 4 * (warp() / 4) + lane() / 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + c + 8 * j;
        x[j] = r < cols && k < K ? __ldg(reinterpret_cast<const float4*>(src + (int64_t)k * ld + r))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      const int r = n0 + 32 * (warp() % 4) + lane(), q = warp() / 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 8 * j + 4 * q;
        x[j] = r < cols && k < K
                   ? __ldg(reinterpret_cast<const float4*>(src + (int64_t)r * ld + k))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  __device__ __forceinline__ void store(uint8_t* t) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = T ? Tile::at(32 * (warp() % 4) + 4 * (lane() % 8) + e,
                                  4 * (warp() / 4) + lane() / 8)
                       : Tile::at(32 * (warp() % 4) + lane(), 4 * (warp() / 4) + e);
      store_split(t + at, t + Tile::BYTES + at,
                  make_float4(comp(x[0], e), comp(x[1], e), comp(x[2], e), comp(x[3], e)));
    }
  }
};

using TB = KTile<BN, BK, PAD>;
constexpr int STAGE = 2 * TB::BYTES;  // B hi, B lo
constexpr int SMEM = 2 * STAGE;       // the ring of two stages
constexpr int FLUSH = 2;  // stages a partial sum takes before it is added to the running sum

// d += A B over one stage as 3xTF32 (d's old value dropped where fresh), A
// the split fragments: hi.lo and lo.hi first, hi.hi last
__device__ __forceinline__ void mma3(float (&d)[BN / 2], const uint32_t (&ah)[BK / 8][4],
                                     const uint32_t (&al)[BK / 8][4], const uint8_t* b,
                                     bool fresh) {
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks)
    wgmma_tf32_rs<BN>(d, ah[ks], TB::desc(b + TB::BYTES, 0, ks), ks > 0 || !fresh);
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) wgmma_tf32_rs<BN>(d, al[ks], TB::desc(b, 0, ks), 1);
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) wgmma_tf32_rs<BN>(d, ah[ks], TB::desc(b, 0, ks), 1);
}

template <int N>
__device__ __forceinline__ void add(float (&acc)[N], const float (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += part[i];
}

// One block per (128 columns, 128 rows, split) of C. AT: A is stored
// transposed (the weight gradient's x^T); BT: B is stored transposed (K x N:
// the forward's kernel, the weight gradient's dY). Each stage's products are
// one wgmma group, added to a partial sum that starts fresh every FLUSH
// stages and is then added to the running sum in round-to-nearest f32.
// While stage s's group runs, the threads split stage s + 1's B (loaded
// into registers a stage earlier) into the other half of the ring and load
// stage s + 2's; after it, they split stage s + 1's A in registers:
//   products of s | store B s + 1, load B s + 2 | wait s, (flush) | split A
//   s + 1, load A s + 2 | barrier
template <bool AT, bool BT>
__global__ void __launch_bounds__(NT, 1) gemm_f32_kernel(const GemmParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;  // split-K: this block is its tile's last
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int c0 = blockIdx.z * p.chunks;
  const int nk = min(p.chunks, (p.K + BK - 1) / BK - c0);  // >= 1 by the host's splits
  const int wg = threadIdx.x / WG, warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const int R = m0 + 64 * wg + 16 * warp + 2 * (lane / 4);  // the thread's rows R, R + 1
  AFrag<AT> av;
  BTile<BT> bv;
  const auto load = [&](int s) {
    const int k0 = (c0 + s) * BK;
    av.load(p.a, p.lda, R, p.M, k0, p.K);
    bv.load(p.b, p.ldb, n0, p.N, k0, p.K);
  };
  uint32_t ah[BK / 8][4], al[BK / 8][4];
  float acc[BN / 2], part[BN / 2];
  zero(acc);
  load(0);
  bv.store(smem);
  av.split(ah, al);
  if (nk > 1) load(1);
  fence_async_smem();
  __syncthreads();
  for (int s = 0; s < nk; ++s) {
    wg_fence();
    mma3(part, ah, al, smem + (s & 1) * STAGE, s % FLUSH == 0);
    wg_commit();
    const bool next = s + 1 < nk, after = s + 2 < nk;
    if (next) {  // stage s - 1's half of the ring is free since the last barrier
      bv.store(smem + ((s + 1) & 1) * STAGE);
      if (after) bv.load(p.b, p.ldb, n0, p.N, (c0 + s + 2) * BK, p.K);
      fence_async_smem();
    }
    wg_wait();
    hold(ah);
    hold(al);
    if ((s + 1) % FLUSH == 0 || !next) {
      hold(part);
      add(acc, part);
    }
    if (next) {
      av.split(ah, al);
      if (after) av.load(p.a, p.lda, R, p.M, (c0 + s + 2) * BK, p.K);
    }
    __syncthreads();  // stage s + 1 is written; both warpgroups are done with stage s
  }

  if (gridDim.z > 1) {
    // this split's tile, in the threads' register order (float4 i of thread
    // x at (i NT + x) 16 bytes: coalesced), then the count of the tile's
    // splits that are in
    const int tiles = gridDim.x * gridDim.y, tile = blockIdx.y * gridDim.x + blockIdx.x;
    float4* ws = reinterpret_cast<float4*>(p.ws);
    const auto part_of = [&](int z) {
      return ws + (int64_t)(z * tiles + tile) * (BM * BN / 4) + threadIdx.x;
    };
    float4* mine = part_of(blockIdx.z);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
      __stcg(mine + i * NT, make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]));
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(p.counters + tile, 1) == (int)gridDim.z - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    float sum[BN / 2];
    zero(sum);
    for (int z = 0; z < (int)gridDim.z; ++z) {  // in split order, whichever block is last
      if (z == (int)blockIdx.z) {
        add(sum, acc);
      } else {
        const float4* other = part_of(z);
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const float4 v = __ldcg(other + i * NT);
          sum[4 * i] += v.x, sum[4 * i + 1] += v.y, sum[4 * i + 2] += v.z, sum[4 * i + 3] += v.w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i];
    if (threadIdx.x == 0) p.counters[tile] = 0;  // for the next launch
  }

  // register 4j + 2r + e: fragment row g + 8 r, the row R + r of C, column
  // 8j + 2t + e
  const int t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = R + r;
    if (row >= p.M) continue;
    float* crow = p.c + (int64_t)row * p.ldc;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= p.N) continue;  // N is even: col + 1 < N with col
      float2 v = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      if (p.bias) {
        const float2 bb = *reinterpret_cast<const float2*>(p.bias + col);
        v.x += bb.x;
        v.y += bb.y;
      }
      *reinterpret_cast<float2*>(crow + col) = v;
    }
  }
}

template <bool AT, bool BT>
cudaError_t run(const GemmParams& p, int splits, cudaStream_t stream) {
  static std::atomic<uint32_t> ready{0};
  const cudaError_t err = allow_smem(gemm_f32_kernel<AT, BT>, SMEM, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  gemm_f32_kernel<AT, BT><<<grid, NT, SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace eeg_gemm

// Plain C interface, loaded with ctypes. C (M x N, row stride ldc) = A B +
// bias, the reduction K long, in one of three layouts of the operands (row
// strides lda, ldb; unit column strides; 16-byte aligned):
//   0, the forward:          A (M x K) as it lies, B stored K x N;
//   1, the input gradient:   A (M x K) as it lies, B stored N x K (B^T as it lies);
//   2, the weight gradient:  A stored K x M, B stored K x N.
// bias: N floats or null. splits: split-K's share of the reduction (1: none);
// the stages are dealt out evenly, and the call uses ceil(stages / ceil(stages
// / splits)) splits, which eeg_gemm_f32_splits returns. With more than one, ws
// holds splits x ceil(M / 128) x ceil(N / 128) x 128 x 128 floats and counters
// one int a tile, all 0 (each launch leaves them 0). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape or
// layout the kernel does not take.
extern "C" {

int eeg_gemm_f32_splits(int K, int splits) {
  const int stages = (K + eeg_gemm::BK - 1) / eeg_gemm::BK;
  splits = splits < 1 ? 1 : splits > stages ? stages : splits;
  const int chunks = (stages + splits - 1) / splits;
  return (stages + chunks - 1) / chunks;
}

int eeg_gemm_f32(int layout, int M, int N, int K, const float* a, int64_t lda, const float* b,
                 int64_t ldb, const float* bias, float* c, int64_t ldc, int splits, float* ws,
                 int* counters, void* stream) {
  using namespace eeg_gemm;
  // the contiguous dimension of each operand: K for an A or B as it lies, M
  // or N for one stored transposed
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 != 0 || (layout != 2 && K % 4 != 0) ||
      (layout == 2 && M % 4 != 0) || layout < 0 || layout > 2)
    return cudaErrorInvalidValue;
  splits = eeg_gemm_f32_splits(K, splits);
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
  const int stages = (K + BK - 1) / BK;
  const GemmParams p = {a,   b,   bias, c, ws, counters, lda, ldb, ldc,
                        M,   N,   K,    (stages + splits - 1) / splits};
  const cudaStream_t st = (cudaStream_t)stream;
  if (layout == 0) return run<false, true>(p, splits, st);
  if (layout == 1) return run<false, false>(p, splits, st);
  return run<true, true>(p, splits, st);
}

}  // extern "C"
