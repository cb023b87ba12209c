// Fused head loss for Hopper (sm_90a): x4 bilinear upsample of the
// 1/4-resolution logits, sigmoid, and the eight masked per-channel loss sums,
// with a recompute-in-backward gradient back to the low-resolution logits.
//
// Replaces the TPU kernel pair of
// ecologysemanticsegmentation_tpu/ops/pallas/head_loss.py::_make_fused
// (_fwd_kernel and _bwd_kernel), the row-blocked variant _make_fused_rows,
// which the JAX package selects at 512 px and above, and the per-shard
// _make_fused_spatial of --spatial_partition training: one kernel here
// covers any h -> H, both align_corners modes and 1 <= C <= 16, and a row
// block of the output.  The row taps come from tables: given the taps of
// output rows [row0, row0 + H_l) and the backward's row runs built for that
// block, the kernels compute the block's partial sums and a gradient for all
// h rows, exactly 0 on the rows the block's taps never read.
//
// What bounds it on this card: bytes.  The forward reads the (B, H, W, C)
// bf16 labels once (50.3 MB at batch 128, 256 px, C = 3) and the f32 logits
// (6.3 MB); the few transcendentals per element (exp, 2 sqrt, 2 log, log1p)
// are far below the f32 rate.  The design keeps the full-resolution logits
// and probabilities out of device memory: each thread recomputes the
// upsampled logit of its pixel from four low-resolution taps, read through
// the read-only cache (the logits fit in L2).  The Pallas kernel's
// kron(Mw^T, I_C) lane-layout operand and its VMEM batch tiles are TPU
// choices and are not carried over; the separable two-tap tables below are
// the same weights as the JAX interpolation matrices, bitwise.
//
// Forward: one block per (image, run of pixels); the 8*C sums stay in
// registers, are reduced through warp shuffles and shared memory in a fixed
// order, and each block writes its own partial (no float atomics); the host
// sums the partials in a fixed order, so the result is deterministic.
// Backward: two launches, no atomics.  (1) one block per output row (b, y):
// du for the row into shared memory, then contracted over x with the column
// taps into z (B, H, w, C).  (2) dlogits[b, i, j, c] gathers z over the
// contiguous run of rows y whose taps reach i.
//
// The C interface takes raw pointers and the stream; each function returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-7f;
constexpr float kGamma = 1.5f;
constexpr int kSums = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may opt into

// Two-tap interpolation tables, one per axis, for output size n:
// idx[0:n] = lo, idx[n:2n] = hi; wt[0:n] = w_lo, wt[n:2n] = w_hi.
struct Taps {
  const int* idx;
  const float* wt;
  int n;
};

__device__ __forceinline__ float sigmoid(float u) { return 1.f / (1.f + expf(-u)); }

// Upsampled logits of output pixel (y, x) for all C channels: rows first,
// then columns, the order of Mh @ X @ Mw.
template <int C>
__device__ __forceinline__ void upsample_pixel(const float* __restrict__ xb, int w, Taps ty,
                                               Taps tx, int y, int x, float (&u)[C]) {
  const int ylo = __ldg(ty.idx + y), yhi = __ldg(ty.idx + ty.n + y);
  const float wylo = __ldg(ty.wt + y), wyhi = __ldg(ty.wt + ty.n + y);
  const int xlo = __ldg(tx.idx + x), xhi = __ldg(tx.idx + tx.n + x);
  const float wxlo = __ldg(tx.wt + x), wxhi = __ldg(tx.wt + tx.n + x);
  const float* r0 = xb + (size_t)ylo * w * C;
  const float* r1 = xb + (size_t)yhi * w * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float a = wylo * __ldg(r0 + xlo * C + c) + wyhi * __ldg(r1 + xlo * C + c);
    const float b = wylo * __ldg(r0 + xhi * C + c) + wyhi * __ldg(r1 + xhi * C + c);
    u[c] = wxlo * a + wxhi * b;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ g, Taps ty,
               Taps tx, float* __restrict__ partials, int h, int w, int H, int W,
               int pix_per_block) {
  const int b = blockIdx.y;
  const int64_t npix = (int64_t)H * W;
  const int64_t p0 = (int64_t)blockIdx.x * pix_per_block;
  const int64_t p1 = p0 + pix_per_block < npix ? p0 + pix_per_block : npix;
  const float* xb = x + (size_t)b * h * w * C;
  const __nv_bfloat16* gb = g + (size_t)b * npix * C;

  float acc[kSums][C];
#pragma unroll
  for (int k = 0; k < kSums; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] = 0.f;

  for (int64_t p = p0 + threadIdx.x; p < p1; p += kThreads) {
    const int y = (int)(p / W);
    const int xx = (int)(p - (int64_t)y * W);
    float u[C];
    upsample_pixel<C>(xb, w, ty, tx, y, xx, u);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float gv = __bfloat162float(gb[p * C + c]);
      if (gv < 0.f) continue;  // -1 ignore sentinel: drops out of every row
      const float pv = sigmoid(u[c]);
      const float omp = 1.f - pv;
      acc[0][c] += gv;
      acc[1][c] += pv;
      acc[2][c] += pv * pv;
      acc[3][c] += gv * pv;
      acc[4][c] += omp * sqrtf(omp) * logf(pv + kEps);
      acc[5][c] += pv * sqrtf(pv) * logf(omp + kEps);
      // softplus of the probability, not of the logit (the reference's BCE
      // applies a with-logits formula to sigmoided outputs)
      acc[6][c] += fmaxf(pv, 0.f) + log1pf(expf(-fabsf(pv)));
      acc[7][c] += 1.f;
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
  float* out = partials + ((size_t)b * gridDim.x + blockIdx.x) * kSums * C;
  for (int k = threadIdx.x; k < kSums * C; k += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += red[i][k];
    out[k] = s;
  }
}

// d(sums)/dp with the (8, C) cotangent applied, times sigmoid'; the same
// formula as the Pallas _bwd_kernel.
__device__ __forceinline__ float du_of(float u, float gv, const float* wk, int C) {
  const float p = sigmoid(u);
  const float omp = 1.f - p;
  const float sp = sqrtf(p), somp = sqrtf(omp);
  const float sgn = p > 0.f ? 1.f : (p < 0.f ? -1.f : 0.f);
  const float dp = wk[1 * C] + wk[2 * C] * 2.f * p + wk[3 * C] * gv +
                   wk[4 * C] * (omp * somp / (p + kEps) - kGamma * somp * logf(p + kEps)) +
                   wk[5 * C] * (kGamma * sp * logf(omp + kEps) - p * sp / (omp + kEps)) +
                   wk[6 * C] * ((p > 0.f ? 1.f : 0.f) - sgn / (1.f + expf(fabsf(p))));
  return dp * p * omp;
}

// Stage 1: one block per output row (y, b).  z[b, y, j, c] =
// sum over x of Mw[x, j] * du[b, y, x, c], as a gather over the contiguous
// runs xrng[0:w]..xrng[w:2w] (lo taps) and xrng[2w:3w]..xrng[3w:4w] (hi taps).
template <int C>
__global__ void __launch_bounds__(kThreads)
    bwd_rows_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                    const float* __restrict__ cot, Taps ty, Taps tx,
                    const int* __restrict__ xrng, float* __restrict__ z, int h, int w, int H,
                    int W) {
  extern __shared__ float du_s[];  // (W, C)
  __shared__ float wk[kSums * C];
  const int y = blockIdx.x, b = blockIdx.y;
  for (int k = threadIdx.x; k < kSums * C; k += kThreads) wk[k] = cot[k];
  __syncthreads();

  const float* xb = x + (size_t)b * h * w * C;
  const __nv_bfloat16* grow = g + ((size_t)b * H + y) * W * C;
  for (int xx = threadIdx.x; xx < W; xx += kThreads) {
    float u[C];
    upsample_pixel<C>(xb, w, ty, tx, y, xx, u);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float gv = __bfloat162float(grow[(size_t)xx * C + c]);
      du_s[xx * C + c] = gv < 0.f ? 0.f : du_of(u[c], gv, wk + c, C);
    }
  }
  __syncthreads();

  float* zrow = z + ((size_t)b * H + y) * w * C;
  for (int k = threadIdx.x; k < w * C; k += kThreads) {
    const int j = k / C, c = k - j * C;
    float s = 0.f;
    for (int xx = xrng[j]; xx < xrng[w + j]; ++xx) s += tx.wt[xx] * du_s[xx * C + c];
    for (int xx = xrng[2 * w + j]; xx < xrng[3 * w + j]; ++xx)
      s += tx.wt[W + xx] * du_s[xx * C + c];
    zrow[k] = s;
  }
}

// Stage 2: dx[b, i, j, c] = sum over y of Mh[y, i] * z[b, y, j, c], over the
// contiguous runs of rows whose lo / hi tap is i.
__global__ void __launch_bounds__(kThreads)
    bwd_gather_kernel(const float* __restrict__ z, Taps ty, const int* __restrict__ yrng,
                      float* __restrict__ dx, int B, int h, int wc, int H) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (int64_t)B * h * wc) return;
  const int jc = (int)(idx % wc);
  const int64_t bi = idx / wc;
  const int i = (int)(bi % h);
  const int b = (int)(bi / h);
  const float* zb = z + (size_t)b * H * wc + jc;
  float s = 0.f;
  for (int y = yrng[i]; y < yrng[h + i]; ++y) s += ty.wt[y] * zb[(size_t)y * wc];
  for (int y = yrng[2 * h + i]; y < yrng[3 * h + i]; ++y)
    s += ty.wt[H + y] * zb[(size_t)y * wc];
  dx[idx] = s;
}

#define HEAD_LOSS_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

}  // namespace

extern "C" int head_loss_fwd(const void* x, const void* g, const void* ytab_idx,
                             const void* ytab_wt, const void* xtab_idx, const void* xtab_wt,
                             void* partials, int B, int h, int w, int H, int W, int C,
                             int pix_per_block, void* stream) {
  const Taps ty{(const int*)ytab_idx, (const float*)ytab_wt, H};
  const Taps tx{(const int*)xtab_idx, (const float*)xtab_wt, W};
  const int64_t npix = (int64_t)H * W;
  const dim3 grid((unsigned)((npix + pix_per_block - 1) / pix_per_block), (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
#define LAUNCH(CC)                                                                        \
  case CC:                                                                                \
    fwd_kernel<CC><<<grid, kThreads, 0, s>>>((const float*)x, (const __nv_bfloat16*)g, ty, \
                                             tx, (float*)partials, h, w, H, W,            \
                                             pix_per_block);                              \
    break;
    HEAD_LOSS_CASES(LAUNCH)
#undef LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int head_loss_bwd(const void* x, const void* g, const void* cot, const void* ytab_idx,
                             const void* ytab_wt, const void* yrng, const void* xtab_idx,
                             const void* xtab_wt, const void* xrng, void* z, void* dx, int B,
                             int h, int w, int H, int W, int C, void* stream) {
  const Taps ty{(const int*)ytab_idx, (const float*)ytab_wt, H};
  const Taps tx{(const int*)xtab_idx, (const float*)xtab_wt, W};
  const size_t smem = (size_t)W * C * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid1((unsigned)H, (unsigned)B);
  switch (C) {
#define LAUNCH(CC)                                                                          \
  case CC:                                                                                  \
    if (smem > 48 * 1024) {                                                                 \
      const cudaError_t e = cudaFuncSetAttribute(                                           \
          bwd_rows_kernel<CC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);     \
      if (e != cudaSuccess) return (int)e;                                                  \
    }                                                                                       \
    bwd_rows_kernel<CC><<<grid1, kThreads, smem, s>>>(                                      \
        (const float*)x, (const __nv_bfloat16*)g, (const float*)cot, ty, tx,                \
        (const int*)xrng, (float*)z, h, w, H, W);                                           \
    break;
    HEAD_LOSS_CASES(LAUNCH)
#undef LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int wc = w * C;
  const int64_t total = (int64_t)B * h * wc;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  bwd_gather_kernel<<<blocks, kThreads, 0, s>>>((const float*)z, ty, (const int*)yrng,
                                                (float*)dx, B, h, wc, H);
  return (int)cudaGetLastError();
}
