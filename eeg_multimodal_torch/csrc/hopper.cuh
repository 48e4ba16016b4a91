// The Hopper (sm_90a) machinery that the attention sources and the f32 GEMM
// build on: shared-memory addresses, mbarriers, TMA copies, wgmma's matrix
// descriptors, fences and products. attention_bf16.cu reads bf16 tiles that
// TMA lays out with the 128-byte swizzle; attention_f32.cu and gemm_f32.cu
// write their TF32 tiles themselves, without swizzle (KTile), after
// splitting each element into the two halves of the 3xTF32 product.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace eeg_attn {
namespace {

// ---------------------------------------------------------------------------
// Shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the dynamic shared memory rounded up to 1024 bytes: the 128-byte swizzle
// repeats every 8 rows of 128 bytes, and the descriptors assume its phase
// starts at each tile
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed. A wait of ~17 s
// (2^35 cycles) traps: a fault of the pipeline becomes a launch error, not
// a hung card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 35)) {
      asm volatile("trap;");
    }
  }
}

// One TMA copy of a box (64 columns x the map's rows, at column `col`, row
// `row` of head h, batch row b) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(h),
      "r"(b)
      : "memory");
}

// A tile of R rows x D columns: D / 64 panels of R rows of 128 bytes
template <int R, int D> __host__ __device__ constexpr int tile_bytes() { return R * D * 2; }
template <int R, int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int h, int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_load(dst + c * R * 128, map, bar, 64 * c, row, h, b);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from touching registers a wgmma still reads or writes
// before its wait: each is "rewritten" here, after the wait
template <int N> __device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K> __device__ __forceinline__ void hold(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}
template <int N> __device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (PTX ISA, wgmma matrix
// descriptor), each in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand: rows row0 .. of a tile of R rows, reduction columns
// k .. k + 15 (k a multiple of 16). Within a 128-byte row, 16 columns are 32
// bytes on: the swizzle is applied to the whole address, so the start moves
// by 32; 8-row groups are 1024 bytes apart.
template <int R>
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int row0, int k) {
  return smem_desc(tile + (k / 64) * R * 128 + row0 * 128 + (k % 64) * 2, 16, 1024);
}
// MN-major B operand whose reduction index is the tile's row: rows k ..
// k + 15 of a tile of R rows, its N the tile's D columns, 64-column panels
// R * 128 bytes apart (the leading offset), 8 rows 1024 bytes (the stride)
template <int R> __device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int k) {
  return smem_desc(tile + k * 128, R * 128, 1024);
}

// d (m64nN f32) += A B, k16, bf16. wgmma_ss: A and B K-major descriptors;
// wgmma_rs: A four registers of bf16 pairs, B an MN-major descriptor.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// ---------------------------------------------------------------------------
// TF32 operands (the f32 kernels)
// ---------------------------------------------------------------------------

// Threads' shared-memory writes become visible to wgmma, which reads through
// the async proxy, once each writer has fenced and the block has synchronised
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 3xTF32 split x = hi + lo: hi is x with its 13 low mantissa bits
// cleared (TF32 by truncation), lo = x - hi (exact in f32) rounded to TF32
// (rna) with its low bits cleared too. Neither carries low bits, so the
// product does not depend on how the tensor core reads an f32 bit pattern.
// |x - hi - lo| <= 2^-21 |x|, and the product hi.hi + hi.lo + lo.hi drops
// lo.lo, below 2^-20 |a b|.
__device__ __forceinline__ uint32_t tf32_hi(float x) { return __float_as_uint(x) & 0xffffe000u; }
__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  uint32_t lo;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
  return lo & 0xffffe000u;
}

// component i of v
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// x split, its hi and lo stored as 16 bytes each
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo, float4 x) {
  const uint4 h = make_uint4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) =
      make_uint4(tf32_lo(x.x, h.x), tf32_lo(x.y, h.y), tf32_lo(x.z, h.z), tf32_lo(x.w, h.w));
}

// A K-major TF32 operand tile of R rows x K columns without swizzle, as
// wgmma reads it: a core matrix (8 rows of 4 columns, 16 bytes a row) is
// 128 contiguous bytes; the K / 4 core matrices of an 8-row group lie LBO
// bytes apart (the descriptor's leading offset) and 8-row groups SBO = K / 4
// * LBO + PAD bytes apart (its stride offset). wgmma reads a core matrix
// from any 16-byte aligned start without bank conflicts. The padding serves
// the writers (Cols in attention_f32.cu): PAD = 16 spreads over the banks
// the 16-byte stores of 8 lanes to 8 rows 4 apart, LBO = 144 those to 8
// core matrices of one row.
template <int R, int K, int PAD, int LBO = 128>
struct KTile {
  static constexpr int SBO = K / 4 * LBO + PAD;
  static constexpr int BYTES = R / 8 * SBO;
  // the byte offset of row r, 4-column chunk c
  static __device__ __forceinline__ int at(int r, int c) {
    return (r >> 3) * SBO + c * LBO + (r & 7) * 16;
  }
  // the descriptor of rows row0 .. row0 + 63 or the tile's N rows (row0 a
  // multiple of 8) and reduction columns 8 ks .. 8 ks + 7: two core
  // matrices along K
  static __device__ __forceinline__ uint64_t desc(const uint8_t* t, int row0, int ks) {
    return (uint64_t)((smem_addr(t + (row0 >> 3) * SBO + ks * 2 * LBO) & 0x3FFFF) >> 4) |
           ((uint64_t)(LBO >> 4) << 16) | ((uint64_t)(SBO >> 4) << 32);
  }
};

// d (m64nN f32) += A B, k8, TF32, both operands K-major. wgmma_tf32_ss: A
// and B descriptors; wgmma_tf32_rs: A four registers, (row, k) = (16 w + g,
// t), (+ 8, t), (g, t + 4), (+ 8, t + 4) for warp w, lane 4 g + t. acc = 0
// ignores d's old value.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                              int acc);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<16>(float (&d)[8], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16],
                                                  const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32],
                                                  const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64],
                                                  const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), found once through the runtime's entry-point query
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// Allow `smem` bytes of dynamic shared memory to `kernel`, once per device
// (bit d of `done`): the attribute call stays off the per-launch path
template <typename K>
cudaError_t allow_smem(K kernel, int smem, std::atomic<uint32_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = 1u << (dev & 31);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace
}  // namespace eeg_attn
