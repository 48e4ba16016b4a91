// The DP forward in the layout first named for it, one block per row, built
// beside the shipped dp_fwd_kernel by tools/dp_fwd_layouts.py to measure the
// two on the card. Not part of the port's library.
//
// Block r takes row r with ceil(F / 4) threads rounded up to whole warps (576
// at F = 2304, at most 1024; beyond that a thread takes every blockDim-th
// group): each holds a group of four in registers, 16-byte loads and stores
// where the row and the arrays allow, a scalar tail elsewhere. The row's min
// and max by warp shuffles and one exchange through shared memory, then one
// Philox call per group. The arithmetic is dp_fwd_kernel's, step for step,
// so the two outputs are equal bit for bit.
#include "dp_block.cu"

namespace {

constexpr int MAX_NT = 1024;

__global__ void __launch_bounds__(MAX_NT)
    dp_fwd_row_kernel(const float* __restrict__ f, const float* __restrict__ dp,
                      const int64_t* __restrict__ seed_p, float* __restrict__ out, int F,
                      float exp_eps) {
  __shared__ float red[2][MAX_NT / 32];
  const Row row = row_of(blockIdx.x, F);
  const bool vec = aligned16(f) && aligned16(out);
  const int j0 = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 x0 = j0 < row.n ? load4(f, (row.q_lo + j0) * 4, row.lo, row.hi, vec, 0.f) : zero;
  float mn = INFINITY, mx = -INFINITY;
  if (j0 < row.n) min_max4(x0, j0, row, mn, mx);
  for (int j = j0 + blockDim.x; j < row.n; j += blockDim.x)
    min_max4(load4(f, (row.q_lo + j) * 4, row.lo, row.hi, vec, 0.f), j, row, mn, mx);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if ((threadIdx.x & 31) == 0) red[0][threadIdx.x >> 5] = mn, red[1][threadIdx.x >> 5] = mx;
  __syncthreads();
  mn = red[0][0], mx = red[1][0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    mn = fminf(mn, red[0][w]), mx = fmaxf(mx, red[1][w]);
  const float span = __fsub_rn(mx, mn);
  const uint64_t seed = (uint64_t)*seed_p;
  for (int j = j0; j < row.n; j += blockDim.x) {
    const int64_t i = (row.q_lo + j) * 4;
    const float4 x = j == j0 ? x0 : load4(f, i, row.lo, row.hi, vec, 0.f);
    const uint4 w = philox4x32_10((uint64_t)i, seed);
    float4 o = zero;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (inside(row, j, k))
        set(o, k, __fadd_rn(__fdiv_rn(__fsub_rn(get(x, k), mn), span),
                            __fmul_rn(laplace(word(w, k)), eps_hat(dp[i + k - row.lo], exp_eps))));
    store4(out, i, row.lo, row.hi, vec, o);
  }
}

}  // namespace

extern "C" {

// As eeg_dp_fwd, in the one-block-per-row layout.
int probe_dp_fwd_row(const float* f, const float* dp, const int64_t* seed, float* out, int B,
                     int F, float exp_eps, void* stream) {
  const int groups = slices_for(F, 1);
  const int nt = groups >= MAX_NT ? MAX_NT : (groups + 31) / 32 * 32;
  dp_fwd_row_kernel<<<B, nt, 0, (cudaStream_t)stream>>>(f, dp, seed, out, F, exp_eps);
  return cudaGetLastError();
}

const char* probe_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
