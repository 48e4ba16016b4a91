// Fused BERT self-attention, forward and backward, for Hopper (sm_90a): the
// mask hook and the C interface.
//
// The kernels replace the JAX package's Pallas TPU kernels in
// ops/attention.py: `_fwd_kernel` (forward) and `_bwd_kernel` (backward).
// They compute
//
//   s      = q k^T * scale + bias[key]          (f32 scores, bias 0 or finfo.min)
//   p      = exp(s - max_row s) / sum_row        (the stable softmax)
//   p_drop = keep ? p / (1 - rate) : 0,  keep = (bits >> 8) < (1 - rate) 2^24
//   out    = round_T(p_drop) v                   (f32 accumulation)
//
// and its gradient, regenerating the dropout mask from the seed instead of
// storing it. Both dtypes run on wgmma, each in a source of its own, to
// which the C interface below sends every call:
//  - f32 (attention_f32.cu): the error-compensated 3xTF32 split (x = hi +
//    lo, a b = hi.hi + hi.lo + lo.hi) keeps the accuracy of the reference's
//    Precision.HIGHEST. TF32 wgmma reads shared-memory operands K-major
//    only, and the split has to be made on every operand element: so each
//    block loads a tile once and writes its hi and lo halves in the layout
//    wgmma reads, as the tile lies or transposed where a product needs V^T,
//    K^T, Q^T or dO^T, split once a block and not once a warp; the score
//    accumulator, split in registers, is the A operand of the next product,
//    its k order matched by the transposed tiles' row order. The f32
//    kernels of the first design, on mma.sync.m16n8k8, split every operand
//    element in every warp that read it and staged P, P_drop and dS through
//    shared memory; they are gone (PERF.md has their times).
//  - bf16 (attention_bf16.cu): TMA loads, bf16 wgmma, P and dS kept in
//    registers; values rounded where the JAX kernel casts to the input dtype
//    (P_drop, dO and dS before their products).
// What the kernels share (the parameters, the mask's grouping, the softmax
// gradient, the mask bytes that the dQ kernels leave for dK/dV) is in
// attention.cuh; the Hopper machinery in hopper.cuh.
//  - exponentials run on the SFU, as ex2.approx of x log2 e (fast_exp):
//    about 2^-22 relative, plus the rounding of x log2 e, which grows with
//    |x| only where exp(x) is far below the row's largest term; denormal
//    results flush to 0. That is of the order of expf's 2 ulp: on the card
//    expf gave the same f32 errors against the plain version and cost up
//    to 4 % of the backward (PERF.md).
//  - dropout bits: Philox4x32-10 (philox.cuh) keyed by a seed read from an
//    int64 device tensor (no host sync). One call gives four words and
//    serves the four elements one thread holds of an 8-column group of a
//    score accumulator (mask_words). The seed tensor holds G seeds, G
//    dividing B: batch row b takes seed b / (B / G), and its mask counter
//    counts b mod (B / G) in place of b, so one call over G stacked batches
//    of B / G rows draws exactly the masks of G calls over one batch each
//    (the paired phase encode's two phases in one 2B forward).
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
//    caller's reshape to (B, S, H * D) is free. `stats` keeps each row's m
//    and l apart (not lse = m + log l: in a row whose keys are all masked m
//    is finfo.min, which absorbs log l, and exp(s - lse) would give 1, not
//    1 / S).
//  - a row whose keys are all masked has scores that all round to
//    finfo.min, so its softmax is uniform, as the einsum gives; nothing
//    special-cases -inf.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention.cuh"

using namespace eeg_attn;

namespace {

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
  if (dtype == 0) return fwd_f32(p, D, st);
  if (dtype == 1) return fwd_bf16(p, D, st);
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
  if (dtype == 0) return bwd_f32(p, D, st);
  if (dtype == 1) return bwd_bf16(p, D, st);
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
