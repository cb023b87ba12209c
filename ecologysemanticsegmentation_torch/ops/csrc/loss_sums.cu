// The eight masked per-channel loss sums of the full-resolution losses, and
// their gradient in both inputs, for Hopper (sm_90a).
//
// Replaces the TPU kernel pair of
// ecologysemanticsegmentation_tpu/ops/pallas/loss_sums.py: _fwd_kernel
// (called from _fwd) and _bwd_kernel (called from _bwd_vjp).
//
// Rows, per channel c, over the pixels whose label g is not negative (the
// -1 ignore sentinel drops out of every row, the count included):
//   Σg, Σp, Σp², Σgp, Σ(1−p)^1.5·log(p+ε), Σp^1.5·log(1−p+ε),
//   Σ max(p,0)+log1p(e^−|p|), count.
// The same forms as the Pallas kernels: x^1.5 as x·√x, the mask applied as a
// factor (so a NaN term at a masked pixel stays NaN, as in the JAX package),
// sign(p)/(1+e^|p|) and 1/(p+ε) in the backward.
//
// What bounds it on this card: bytes.  The forward reads p and g once
// (201 MB at batch 128, 256 px, C = 3) for about 34 f32 operations per
// element; the backward reads them again and writes dp and, where autograd
// needs it, dg.  The design reads the NHWC tensors in place: each thread
// takes whole pixels (all C channels of one pixel, one pixel stride apart),
// so the channel-major transpose the TPU layout needed (a copy as large as
// the inputs) never happens, and a channel slice x[..., i:i+1] of a wider
// tensor is read through its pixel stride.  The Pallas version pads N to a
// 2048-lane tile and subtracts the padding's analytic contribution; here
// the loops stop at N.
//
// Forward: one block per run of pixels; the 8*C sums stay in registers, are
// reduced through warp shuffles and shared memory in a fixed order, and each
// block writes its own partial (no float atomics); the host sums the
// partials in a fixed order, so the result is deterministic.
// Backward: one elementwise pass over the (N, C) elements; dp and dg are
// written contiguous, each only when its pointer is not null.
//
// The C interface takes raw pointers and the stream; each function returns
// cudaGetLastError() after its launch.  Indexing is 64-bit throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-7f;
constexpr float kGamma = 1.5f;
constexpr int kSums = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBwdBlocks = 1 << 20;

template <int C>
__global__ void __launch_bounds__(kThreads)
    loss_sums_fwd_kernel(const float* __restrict__ p, const float* __restrict__ g, int64_t sp,
                         int64_t sg, int64_t n, int64_t pix_per_block,
                         float* __restrict__ partials) {
  const int64_t i0 = (int64_t)blockIdx.x * pix_per_block;
  const int64_t i1 = i0 + pix_per_block < n ? i0 + pix_per_block : n;

  float acc[kSums][C];
#pragma unroll
  for (int k = 0; k < kSums; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] = 0.f;

  for (int64_t i = i0 + threadIdx.x; i < i1; i += kThreads) {
    const float* pr = p + i * sp;
    const float* gr = g + i * sg;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float pv = __ldg(pr + c);
      const float graw = __ldg(gr + c);
      const float w = graw >= 0.f ? 1.f : 0.f;
      const float gv = graw * w;
      const float omp = 1.f - pv;
      acc[0][c] += gv;
      acc[1][c] += w * pv;
      acc[2][c] += w * pv * pv;
      acc[3][c] += gv * pv;
      acc[4][c] += w * (omp * sqrtf(omp)) * logf(pv + kEps);
      acc[5][c] += w * (pv * sqrtf(pv)) * logf(omp + kEps);
      // softplus of the probability (the reference applies a with-logits
      // BCE formula to sigmoided outputs)
      acc[6][c] += w * (fmaxf(pv, 0.f) + log1pf(expf(-fabsf(pv))));
      acc[7][c] += w;
    }
  }

  __shared__ float red[kWarps][kSums * C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float v = acc[k][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][k * C + c] = v;
    }
  __syncthreads();
  float* out = partials + (size_t)blockIdx.x * kSums * C;
  for (int k = threadIdx.x; k < kSums * C; k += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += red[i][k];
    out[k] = s;
  }
}

// dp = mask · Σ_k w_k ∂s_k/∂p and dg = (w_0 + w_3·p) · mask, with the (8, C)
// cotangent w; the count row carries no gradient.
template <int C>
__global__ void __launch_bounds__(kThreads)
    loss_sums_bwd_kernel(const float* __restrict__ p, const float* __restrict__ g, int64_t sp,
                         int64_t sg, int64_t n, const float* __restrict__ cot,
                         float* __restrict__ dp, float* __restrict__ dg) {
  __shared__ float wk[kSums * C];
  for (int k = threadIdx.x; k < kSums * C; k += kThreads) wk[k] = cot[k];
  __syncthreads();

  const int64_t total = n * C;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x; idx < total; idx += stride) {
    const int64_t i = idx / C;
    const int c = (int)(idx - i * C);
    const float pv = __ldg(p + i * sp + c);
    const float graw = __ldg(g + i * sg + c);
    const float msk = graw >= 0.f ? 1.f : 0.f;
    if (dp != nullptr) {
      const float gv = graw * msk;
      const float omp = 1.f - pv;
      const float spv = sqrtf(pv), somp = sqrtf(omp);
      const float sgn = pv > 0.f ? 1.f : (pv < 0.f ? -1.f : 0.f);
      const float* w = wk + c;  // w[k * C]: the cotangent of sum k for this channel
      const float d = w[1 * C] + w[2 * C] * 2.f * pv + w[3 * C] * gv +
                      w[4 * C] * (omp * somp / (pv + kEps) - kGamma * somp * logf(pv + kEps)) +
                      w[5 * C] * (kGamma * spv * logf(omp + kEps) - pv * spv / (omp + kEps)) +
                      w[6 * C] * ((pv > 0.f ? 1.f : 0.f) - sgn / (1.f + expf(fabsf(pv))));
      dp[idx] = msk * d;
    }
    if (dg != nullptr) dg[idx] = (wk[0 * C + c] + wk[3 * C + c] * pv) * msk;
  }
}

#define LOSS_SUMS_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

}  // namespace

// p, g: element (i, c) at p[i * sp + c], g[i * sg + c], 0 <= i < n.
// partials: (ceil(n / pix_per_block), 8, C) f32, one (8, C) block per launch block.
extern "C" int loss_sums_fwd(const void* p, const void* g, long long sp, long long sg,
                             long long n, int C, long long pix_per_block, void* partials,
                             void* stream) {
  if (n < 0 || pix_per_block <= 0) return (int)cudaErrorInvalidValue;
  const long long nblk = n > 0 ? (n + pix_per_block - 1) / pix_per_block : 1;
  if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
#define LAUNCH(CC)                                                                    \
  case CC:                                                                            \
    loss_sums_fwd_kernel<CC><<<(unsigned)nblk, kThreads, 0, s>>>(                     \
        (const float*)p, (const float*)g, sp, sg, n, pix_per_block, (float*)partials); \
    break;
    LOSS_SUMS_CASES(LAUNCH)
#undef LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dp, dg: (n, C) contiguous f32, or null when autograd does not need them.
extern "C" int loss_sums_bwd(const void* p, const void* g, long long sp, long long sg,
                             long long n, int C, const void* cot, void* dp, void* dg,
                             void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const long long total = n * (long long)C;
  if (total == 0 || (dp == nullptr && dg == nullptr)) return (int)cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBwdBlocks) blocks = kMaxBwdBlocks;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
#define LAUNCH(CC)                                                                        \
  case CC:                                                                                \
    loss_sums_bwd_kernel<CC><<<(unsigned)blocks, kThreads, 0, s>>>(                       \
        (const float*)p, (const float*)g, sp, sg, n, (const float*)cot, (float*)dp,       \
        (float*)dg);                                                                      \
    break;
    LOSS_SUMS_CASES(LAUNCH)
#undef LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
