// The fused DP block, forward and backward, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in ops/dp_pallas.py:
// `_dp_fwd_kernel` (forward; dp_fwd_kernel here) and `_dp_bwd_kernel`
// (backward; dp_bwd_kernel). Over the raw fused concat f (B, F) f32 and the
// learned logits DP (1, F) they compute
//
//   norm    = (f - min_row f) / (max_row f - min_row f)
//   w       = sigmoid(DP);  eps_hat = 1 / log((e^eps - w) / (1 - w))
//   out     = norm + noise * eps_hat,  noise ~ Laplace(0, 1)
//
// and its gradient: df through the row min-max (the min and max gradients
// split evenly among tied elements, as XLA's autodiff of min/max does) and
// dDP = sum_B(g noise) d eps_hat / dw w (1 - w), the noise regenerated from
// the seed instead of stored.
//
// Sweep members: the batched sweep stacks M members' rows, (M B, F) with
// member m's B rows the m-th block, and gives each member its own DP row
// (dp (M, F)), e^eps (a device vector of M) and seed (M int64). Every index
// below is then the row's within its member: row r of the launch is row
// r mod B of member r / B, whose pointers are offset to that member's block.
// So member m's rows compute exactly what a call of their own would, bit
// for bit, and dDP is each member's own sum over its rows. M = 1 with a host
// e^eps is the single model's call; e^eps is read from device memory where
// it differs per member, so a sweep step needs neither a sync nor M launches.
//
// The noise is a function of (seed, flat index n = r F + c) alone: element n
// takes word n & 3 of philox4x32_10(n & ~3, seed) (philox.cuh). So one call
// serves four neighbouring elements, the forward and both halves of the
// backward draw the same noise whatever their thread layout, and any F
// works (a group crosses a row boundary where F % 4 != 0). The word's top
// 23 bits plus a half step give u strictly inside (-1/2, 1/2), and
// noise = -sign(u) log1p(-2|u|) stays within ln 2^23: a draw of exactly 0
// would give log1p(-1) = -inf (the JAX package's
// tools/repro_fused_dp_scan_nan.py). ops/dp_fused.py::laplace_plain is the
// plain twin of this noise.
//
// What bounds it on the H100: bytes, and in practice latency. At the
// flagship's (8, 2304) the forward moves 2 B F 4 + F 4 = 157 KB and the
// backward 3 B F 4 + 2 F 4 = 230 KB: 0.05 and 0.07 us at 3.35 TB/s, against
// about 0.9 us for an empty launch. There is no matrix product, so wgmma and
// TMA have nothing to do. What the time goes to (PERF.md has the numbers) is
// each thread's chain of dependent steps: L2 round trips, the block
// reductions, and IEEE divisions and transcendentals, which branch and so
// run one after another. The design keeps those chains short and spreads
// them over many SMs, where one block per row would leave the work to 8:
//  - every block reads its whole row for the min and max (9 KB at F = 2304,
//    from L2), up to TILE groups per thread in one round of 16-byte loads,
//    and reduces it with warp shuffles and one exchange through shared
//    memory. A cluster of blocks per row sharing one reduction through
//    distributed shared memory was slower: its barriers cost more than the
//    reads they save.
//  - forward: blocks of NT_FWD = 256 threads, one element each, a row in
//    ceil(F / 256) blocks (72 at (8, 2304)). The four lanes of a quad share
//    a group of four: its first lane makes the Philox call and hands the
//    words on by shuffles. An element's noise and eps_hat come before the
//    row's reduction, so that their latencies overlap. The arithmetic keeps
//    the plain version's order and rounds each step (__fmul_rn and friends,
//    IEEE division: no fused multiply-add), so that on the card the output
//    equals dp_block_plain with laplace_plain's noise bit for bit.
//  - backward, one launch of NT = 128-thread blocks of two kinds. df blocks
//    (B ceil(F / 512), one group per thread; none where df is not needed)
//    take the row's min, max, tie counts, sum g and sum g (x - ref) in one
//    pass and one reduction, which give the min's and max's gradients with
//    one reciprocal and no division per element. dDP blocks (none where dDP
//    is not needed) take 32 groups of four columns, one per lane; warp k
//    takes rows k, k + 4, ... with one Philox call per row and group (two
//    where the group crosses a row boundary), and the warps' partial sums
//    are added in warp order through shared memory: deterministic for any
//    B, no atomics. The DP factor d eps_hat / dw w (1 - w) comes before the
//    row loop, one column per warp.
//  - 16-byte loads and stores for the backward's groups inside a row;
//    scalar ones for the groups a row boundary cuts and for arrays not
//    16-byte aligned. The forward's own elements are one float per lane: a
//    warp still reads and writes 128 contiguous bytes.
//  - the seed is an int64 device tensor read in the kernel (no host sync),
//    and the launch goes through ctypes, with no JIT on the way.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int NT = 128;      // threads of a backward block: one group of four elements each
constexpr int NT_FWD = 256;  // threads of a forward block: one element each
constexpr int TILE = 5;      // groups of a row a thread loads at once: 576 at F = 2304 in one round

__device__ __forceinline__ float get(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set(float4& v, int k, float x) {
  if (k == 0) v.x = x;
  else if (k == 1) v.y = x;
  else if (k == 2) v.z = x;
  else v.w = x;
}

__device__ __forceinline__ uint32_t word(const uint4& a, int k) {
  return k == 0 ? a.x : k == 1 ? a.y : k == 2 ? a.z : a.w;
}

__device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Elements i .. i + 3 of x, `fill` for those outside [lo, hi); one 16-byte
// load where all four are inside and `vec` says x + i is 16-byte aligned.
__device__ __forceinline__ float4 load4(const float* __restrict__ x, int64_t i, int64_t lo,
                                        int64_t hi, bool vec, float fill) {
  if (vec && i >= lo && i + 4 <= hi) return *reinterpret_cast<const float4*>(x + i);
  float4 v;
#pragma unroll
  for (int k = 0; k < 4; ++k) set(v, k, i + k >= lo && i + k < hi ? x[i + k] : fill);
  return v;
}

__device__ __forceinline__ void store4(float* __restrict__ x, int64_t i, int64_t lo, int64_t hi,
                                       bool vec, const float4& v) {
  if (vec && i >= lo && i + 4 <= hi) {
    *reinterpret_cast<float4*>(x + i) = v;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (i + k >= lo && i + k < hi) x[i + k] = get(v, k);
}

// Laplace(0, 1) of one 32-bit word (every step is exact but the log).
__device__ __forceinline__ float laplace(uint32_t bits) {
  const float u = ((float)(bits >> 9) + 0.5f) * (1.0f / 8388608.0f) - 0.5f;
  const float m = log1pf(-2.0f * fabsf(u));
  return u > 0.0f ? -m : m;
}

// The noise of flat elements n .. n + 3: one Philox call where n % 4 == 0,
// else the two calls whose groups they fall in.
__device__ __forceinline__ float4 noise4(int64_t n, uint64_t seed) {
  const int s = (int)(n & 3);
  const uint4 a = philox4x32_10((uint64_t)(n - s), seed);
  if (s == 0) return make_float4(laplace(a.x), laplace(a.y), laplace(a.z), laplace(a.w));
  const uint4 b = philox4x32_10((uint64_t)(n - s + 4), seed);
  float4 z;
#pragma unroll
  for (int k = 0; k < 4; ++k) set(z, k, laplace(s + k < 4 ? word(a, s + k) : word(b, s + k - 4)));
  return z;
}

__device__ __forceinline__ float sigmoid(float d) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-d)));
}

// eps_hat = 1 / log((e^eps - w) / (1 - w)), in the plain version's order
__device__ __forceinline__ float eps_hat(float d, float exp_eps) {
  const float w = sigmoid(d);
  return __fdiv_rn(1.0f, logf(__fdiv_rn(__fsub_rn(exp_eps, w), __fsub_rn(1.0f, w))));
}

// The flat elements [lo, hi) of one row and the groups of four they touch:
// q_lo .. q_lo + n - 1. Only the first group may start before the row (its
// elements k < head do) and only the last may end after it (k > last).
struct Row {
  int64_t lo, hi, q_lo;
  int n, head, last;
};

__device__ __forceinline__ Row row_of(int r, int F) {
  Row row;
  row.lo = (int64_t)r * F;
  row.hi = row.lo + F;
  row.q_lo = row.lo >> 2;
  row.n = (int)(((row.hi - 1) >> 2) - row.q_lo + 1);
  row.head = (int)(row.lo & 3);
  row.last = (int)((row.hi - 1) & 3);
  return row;
}

// One member's block of a launch: its rows' offset into the (M B, F)
// arrays, and its DP row, seed and e^eps.
struct Member {
  int64_t off;
  const float* dp;
  uint64_t seed;
  float exp_eps;
};

__device__ __forceinline__ Member member_of(int m, int B, int F, const float* __restrict__ dp,
                                            const int64_t* __restrict__ seed_p,
                                            const float* __restrict__ exp_eps_p, float exp_eps) {
  return Member{(int64_t)m * B * F, dp + (int64_t)m * F, (uint64_t)seed_p[m],
                exp_eps_p ? exp_eps_p[m] : exp_eps};
}

// Whether element k of the row's group j lies in the row.
__device__ __forceinline__ bool inside(const Row& row, int j, int k) {
  return j >= 0 && j < row.n && (j > 0 || k >= row.head) && (j < row.n - 1 || k <= row.last);
}

// Min and max of the elements of the row's group j.
__device__ __forceinline__ void min_max4(const float4& x, int j, const Row& row, float& mn,
                                         float& mx) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (inside(row, j, k)) mn = fminf(mn, get(x, k)), mx = fmaxf(mx, get(x, k));
}

// The block's min and max, returned to every thread: lanes by butterfly,
// then the warps through `red` ([2][NT_FWD / 32] floats of shared memory).
__device__ __forceinline__ void block_min_max(float& mn, float& mx, float (*red)[NT_FWD / 32]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if ((threadIdx.x & 31) == 0) red[0][threadIdx.x >> 5] = mn, red[1][threadIdx.x >> 5] = mx;
  __syncthreads();
  mn = red[0][0], mx = red[1][0];
#pragma unroll
  for (int w = 1; w < NT_FWD / 32; ++w) mn = fminf(mn, red[0][w]), mx = fmaxf(mx, red[1][w]);
}

// The min and max of a whole row, each thread of a forward block taking
// every NT_FWD-th group. A thread's loads for up to TILE groups are issued
// together before any is used.
__device__ __forceinline__ void row_min_max(const float* __restrict__ f, const Row& row, bool vec,
                                            float& mn, float& mx) {
  mn = INFINITY, mx = -INFINITY;
  for (int jb = threadIdx.x; jb < row.n; jb += NT_FWD * TILE) {
    float4 xs[TILE];
#pragma unroll
    for (int u = 0; u < TILE; ++u) {
      const int64_t i = (row.q_lo + jb + u * NT_FWD) * 4;
      if (jb + u * NT_FWD < row.n) xs[u] = load4(f, i, row.lo, row.hi, vec, 0.f);
    }
#pragma unroll
    for (int u = 0; u < TILE; ++u)
      if (jb + u * NT_FWD < row.n) min_max4(xs[u], jb + u * NT_FWD, row, mn, mx);
  }
}

// Block (r, s) writes groups s NT_FWD / 4 .. (s + 1) NT_FWD / 4 - 1 of row
// r, one element per thread: the four lanes of a quad share a group, whose
// Philox call the quad's first lane makes and hands on by shuffles.
__global__ void __launch_bounds__(NT_FWD)
    dp_fwd_kernel(const float* __restrict__ f, const float* __restrict__ dp_all,
                  const int64_t* __restrict__ seed_p, const float* __restrict__ exp_eps_p,
                  float* __restrict__ out, int B, int F, float exp_eps_host) {
  __shared__ float red[2][NT_FWD / 32];
  const Member mem = member_of(blockIdx.x / B, B, F, dp_all, seed_p, exp_eps_p, exp_eps_host);
  f += mem.off, out += mem.off;
  const float* __restrict__ dp = mem.dp;
  const float exp_eps = mem.exp_eps;
  const Row row = row_of(blockIdx.x % B, F);
  const int k = threadIdx.x & 3, j = blockIdx.y * (NT_FWD / 4) + (threadIdx.x >> 2);
  const int64_t n = (row.q_lo + j) * 4 + k;  // the thread's flat element
  const bool mine = inside(row, j, k);
  // the element's noise and eps_hat come before the row's reduction, so
  // that their latencies overlap the row's loads
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (k == 0 && j < row.n) w = philox4x32_10((uint64_t)n, mem.seed);
  const int lead = threadIdx.x & 28;  // the quad's first lane
  const uint32_t w0 = __shfl_sync(0xffffffffu, w.x, lead), w1 = __shfl_sync(0xffffffffu, w.y, lead);
  const uint32_t w2 = __shfl_sync(0xffffffffu, w.z, lead), w3 = __shfl_sync(0xffffffffu, w.w, lead);
  float x = 0.f, ze = 0.f;
  if (mine) {
    x = f[n];
    const uint32_t bits = k == 0 ? w0 : k == 1 ? w1 : k == 2 ? w2 : w3;
    ze = __fmul_rn(laplace(bits), eps_hat(dp[n - row.lo], exp_eps));
  }
  float mn, mx;
  row_min_max(f, row, aligned16(f), mn, mx);
  block_min_max(mn, mx, red);
  if (mine) out[n] = __fadd_rn(__fdiv_rn(__fsub_rn(x, mn), __fsub_rn(mx, mn)), ze);
}

// A row's statistics for df, over some of its elements: min and max with
// their tie counts, sum g and sum g (x - ref), ref the row's first element
// (so that sum g (x - min) = sum g (x - ref) - (min - ref) sum g cancels no
// more than the row's spread). Every field combines in any order to the
// same value but for the sums, which the reduction takes in a fixed order.
struct RowStats {
  float mn, n_mn, mx, n_mx, sg, sgx;
};

__device__ __forceinline__ RowStats combine(const RowStats& a, const RowStats& b) {
  RowStats c;
  c.mn = fminf(a.mn, b.mn);
  c.n_mn = (a.mn == c.mn ? a.n_mn : 0.f) + (b.mn == c.mn ? b.n_mn : 0.f);
  c.mx = fmaxf(a.mx, b.mx);
  c.n_mx = (a.mx == c.mx ? a.n_mx : 0.f) + (b.mx == c.mx ? b.n_mx : 0.f);
  c.sg = a.sg + b.sg;
  c.sgx = a.sgx + b.sgx;
  return c;
}

// The row's statistics over the groups this thread takes (every NT-th), a
// tile of up to TILE groups per round of loads: min, max and sums first,
// then the ties, so that no element waits on another's combine.
__device__ __forceinline__ RowStats thread_stats(const float* __restrict__ f,
                                                 const float* __restrict__ g, const Row& row,
                                                 bool vec, float ref) {
  RowStats st{INFINITY, 0.f, -INFINITY, 0.f, 0.f, 0.f};
  for (int jb = threadIdx.x; jb < row.n; jb += NT * TILE) {
    float4 xs[TILE], gs[TILE];
#pragma unroll
    for (int u = 0; u < TILE; ++u) {
      const int64_t i = (row.q_lo + jb + u * NT) * 4;
      xs[u] = gs[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (jb + u * NT < row.n) {
        xs[u] = load4(f, i, row.lo, row.hi, vec, 0.f);
        gs[u] = load4(g, i, row.lo, row.hi, vec, 0.f);
      }
    }
    RowStats t{INFINITY, 0.f, -INFINITY, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < TILE; ++u) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (inside(row, jb + u * NT, k)) {
          t.mn = fminf(t.mn, get(xs[u], k)), t.mx = fmaxf(t.mx, get(xs[u], k));
          t.sg += get(gs[u], k), t.sgx += get(gs[u], k) * (get(xs[u], k) - ref);
        }
    }
#pragma unroll
    for (int u = 0; u < TILE; ++u) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (inside(row, jb + u * NT, k)) {
          t.n_mn += get(xs[u], k) == t.mn ? 1.f : 0.f;
          t.n_mx += get(xs[u], k) == t.mx ? 1.f : 0.f;
        }
    }
    st = combine(st, t);
  }
  return st;
}

// The row's statistics over the block, returned to every thread: lanes by
// butterfly, then warps in order through shared memory.
__device__ __forceinline__ RowStats block_stats(RowStats st, RowStats* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    RowStats other;
    other.mn = __shfl_xor_sync(0xffffffffu, st.mn, o);
    other.n_mn = __shfl_xor_sync(0xffffffffu, st.n_mn, o);
    other.mx = __shfl_xor_sync(0xffffffffu, st.mx, o);
    other.n_mx = __shfl_xor_sync(0xffffffffu, st.n_mx, o);
    other.sg = __shfl_xor_sync(0xffffffffu, st.sg, o);
    other.sgx = __shfl_xor_sync(0xffffffffu, st.sgx, o);
    st = combine(st, other);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = st;
  __syncthreads();
  st = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) st = combine(st, red[w]);
  return st;
}

// df of groups s NT .. s NT + NT - 1 of row r through the row's min-max, in
// one pass and one reduction: the row's min, max, ties, sum g and sum
// g (x - ref) give the gradients of the min and max,
//   sum g (norm - 1) / span = (sum g (x - min) - span sum g) / span^2,
//   sum -g norm / span      = -sum g (x - min) / span^2,
// each split evenly among its ties.
__device__ __forceinline__ void df_slice(const float* __restrict__ f,
                                         const float* __restrict__ g, float* __restrict__ df,
                                         int r, int s, int F) {
  __shared__ RowStats red[NT / 32];
  const Row row = row_of(r, F);
  const bool vec = aligned16(f) && aligned16(g) && aligned16(df);
  const int jt = s * NT + threadIdx.x;
  const int64_t it = (row.q_lo + jt) * 4;
  float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), g0 = x0;
  if (jt < row.n) {
    x0 = load4(f, it, row.lo, row.hi, vec, 0.f);
    g0 = load4(g, it, row.lo, row.hi, vec, 0.f);
  }
  const float ref = f[row.lo];
  const RowStats st = block_stats(thread_stats(f, g, row, vec, ref), red);
  if (jt >= row.n) return;
  const float span = st.mx - st.mn, inv_span = 1.0f / span;
  const float gx = st.sgx - (st.mn - ref) * st.sg;  // sum g (x - min)
  const float to_min = (gx - span * st.sg) * inv_span * inv_span / st.n_mn;
  const float to_max = -gx * inv_span * inv_span / st.n_mx;
  float4 o;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    set(o, k, get(g0, k) * inv_span + (get(x0, k) == st.mn ? to_min : 0.0f) +
                  (get(x0, k) == st.mx ? to_max : 0.0f));
  store4(df, it, row.lo, row.hi, vec, o);
}

// dDP of column block cb: 32 groups of four columns, one per lane; warp k
// takes rows k, k + 4, ..., and the warps' partial sums are added in warp
// order.
__device__ __forceinline__ void ddp_cols(const float* __restrict__ g,
                                         const float* __restrict__ dp, uint64_t seed,
                                         float* __restrict__ ddp, int B, int F, float exp_eps,
                                         int cb) {
  __shared__ float4 part[NT / 32][32];  // [warp][lane]
  __shared__ float scale_k[4][32];    // [column c + k][lane]
  static_assert(NT / 32 == 4, "warp k computes the DP factor of column c + k");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = (cb * 32 + lane) * 4;  // the lane's first column
  const bool vec = aligned16(g) && (F & 3) == 0;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < F) {
    // d eps_hat / dw w (1 - w) of column c + warp, which needs DP only:
    // its divisions and transcendentals overlap the row loop instead of
    // following the sum, one column per thread
    if (c + warp < F) {
      const float w = sigmoid(dp[c + warp]);
      const float ew = exp_eps - w, one_w = 1.0f - w;
      const float log_term = logf(ew / one_w);
      scale_k[warp][lane] = -(-1.0f / ew + 1.0f / one_w) / (log_term * log_term) * w * one_w;
    }
#pragma unroll 4
    for (int r = warp; r < B; r += NT / 32) {
      const int64_t n = (int64_t)r * F + c;
      const float4 gg = load4(g, n, n - c, n - c + F, vec, 0.f);  // columns past F read 0
      const float4 z = noise4(n, seed);
      acc.x += gg.x * z.x;
      acc.y += gg.y * z.y;
      acc.z += gg.z * z.z;
      acc.w += gg.w * z.w;
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || c >= F) return;
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) {
    const float4 p = part[w][lane];
    acc.x += p.x, acc.y += p.y, acc.z += p.z, acc.w += p.w;
  }
  float4 o;
#pragma unroll
  for (int k = 0; k < 4; ++k) set(o, k, get(acc, k) * scale_k[k][lane]);
  store4(ddp, c, 0, F, aligned16(ddp), o);
}

// Blocks b < df_blocks take df of slice b % slices of launch row b /
// slices; the rest take dDP, col_blocks column blocks per member, member
// after member. B is the rows of one member.
__global__ void __launch_bounds__(NT)
    dp_bwd_kernel(const float* __restrict__ f, const float* __restrict__ g,
                  const float* __restrict__ dp, const int64_t* __restrict__ seed_p,
                  const float* __restrict__ exp_eps_p, float* __restrict__ df,
                  float* __restrict__ ddp, int B, int F, float exp_eps, int slices,
                  int df_blocks, int col_blocks) {
  const int b = blockIdx.x;
  if (b < df_blocks) {
    // df needs no DP, seed or eps: only the member's row offset
    const int r = b / slices;
    const int64_t off = (int64_t)(r / B) * B * F;
    df_slice(f + off, g + off, df + off, r % B, b % slices, F);
  } else {
    const int m = (b - df_blocks) / col_blocks;
    const Member mem = member_of(m, B, F, dp, seed_p, exp_eps_p, exp_eps);
    ddp_cols(g + mem.off, mem.dp, mem.seed, ddp + (int64_t)m * F, B, F, mem.exp_eps,
             (b - df_blocks) % col_blocks);
  }
}

// An empty kernel: the launch floor the timing phase sets beside the others.
__global__ void empty_kernel() {}

// Slices of `groups` groups of four elements per row (a row touches at most
// (F + 6) / 4 groups).
int slices_for(int F, int groups) {
  return ((F % 4 == 0 ? F / 4 : (F + 6) / 4) + groups - 1) / groups;
}

}  // namespace

// Plain C interface, loaded with ctypes. M members of B rows each: f, g,
// out, df: (M B, F) contiguous f32; dp, ddp: (M, F) f32; seed: M int64;
// exp_eps: M f32 values of e^eps on the device, or null for the host's
// exp_eps_host (e^eps rounded to f32) for every member. Each returns
// cudaGetLastError() after its launch.
extern "C" {

int eeg_dp_fwd(const float* f, const float* dp, const int64_t* seed, const float* exp_eps,
               float* out, int M, int B, int F, float exp_eps_host, void* stream) {
  dp_fwd_kernel<<<dim3(M * B, slices_for(F, NT_FWD / 4)), NT_FWD, 0, (cudaStream_t)stream>>>(
      f, dp, seed, exp_eps, out, B, F, exp_eps_host);
  return cudaGetLastError();
}

// df or ddp null leaves that half out of the grid (not both).
int eeg_dp_bwd(const float* f, const float* g, const float* dp, const int64_t* seed,
               const float* exp_eps, float* df, float* ddp, int M, int B, int F,
               float exp_eps_host, void* stream) {
  const int slices = slices_for(F, NT);
  const int df_blocks = df ? M * B * slices : 0;
  const int col_blocks = ((F + 3) / 4 + 31) / 32;
  const int ddp_blocks = ddp ? M * col_blocks : 0;
  dp_bwd_kernel<<<df_blocks + ddp_blocks, NT, 0, (cudaStream_t)stream>>>(
      f, g, dp, seed, exp_eps, df, ddp, B, F, exp_eps_host, slices, df_blocks, col_blocks);
  return cudaGetLastError();
}

int eeg_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return cudaGetLastError();
}

}  // extern "C"
