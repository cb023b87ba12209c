// Tile-interpolated CLAHE apply for Hopper (sm_90a):
//
//   out[b,y,x] = sum_{k<K} 1{floor(l[b,y,x]*(K-1)) >= k} * sum_t Wy[y,t] * Gx[b,k,t,x]
//
// with l the (B, H, W) f32 luminance in [0, 1], Gx the (B, K, T, W) f32
// per-tile CDF steps already interpolated along x, and Wy the (H, T) tile
// weights, which have at most two non-zero taps per row.  Forward only.
//
// Replaces the TPU kernel
// ecologysemanticsegmentation_tpu/ops/pallas/clahe_tiled.py::_kernel (the
// pallas_call of tiled_clahe_new_luma), which runs one image per grid step
// and does K dense (H, T) @ (T, W) MXU dots into a gated accumulator.
//
// What bounds it on this card: bytes.  At batch 128, 256 px, K = 64 it must
// read l (33.5 MB) and Gx (67.1 MB) and write out (33.5 MB); the two-tap
// form needs about 2*2*K + 2 flops a pixel, under the byte time at the f32
// rate.  The design reads each Gx element from device memory about once per
// block row band and does O(1) work per pixel:
//
// - one block per (image, run of R rows, 32 columns); the rows' two tile
//   taps (lo, hi) come from a two-tap table built on the host from the same
//   float64 -> float32 tile weights as the JAX package, and the block stages
//   Gx[b, :, tlo..thi, x0:x0+32] in shared memory (threads along x, so the
//   loads coalesce);
// - in shared memory, a sequential prefix sum over k turns the gated sum
//   into one lookup per tap: out = w_lo * P[j][t_lo] + w_hi * P[j][t_hi]
//   with j = min(floor(l*(K-1)), K-1) and P[j] = Gx[0] + ... + Gx[j]
//   (out = 0 where floor(l*(K-1)) < 0).
//
// Rounding against the plain version (which sums the per-bin planes
// Wy @ Gx[k] over k): the same terms summed in another order, sums over k
// first and the two y taps last; both are f32 sums of at most K + 2 terms
// of magnitude <= 1, so they differ by a few f32 ulps of 1.
//
// The C interface takes raw pointers and the stream and returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;                  // columns per block, one warp wide
constexpr int kRowThreads = 8;             // threads along y per block
constexpr int kThreads = kCols * kRowThreads;
constexpr int kMaxSmem = 232448;           // dynamic shared memory a block may opt into

__global__ void __launch_bounds__(kThreads)
    clahe_apply_kernel(const float* __restrict__ luma, const float* __restrict__ gx,
                       const int* __restrict__ ytap, const float* __restrict__ ywt,
                       float* __restrict__ out, int H, int W, int T, int K,
                       int rows_per_block, int span) {
  extern __shared__ float ps[];  // (K, span, kCols): prefix sums over k
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * rows_per_block;
  const int y1 = min(y0 + rows_per_block, H);
  const int x0 = blockIdx.x * kCols;
  // The taps are non-decreasing in y: the block's tiles are [tlo, thi].
  const int tlo = __ldg(ytap + y0);
  const int nt = __ldg(ytap + H + y1 - 1) - tlo + 1;  // <= span, checked by the host

  const float* g = gx + (size_t)b * K * T * W;
  for (int i = threadIdx.x; i < K * nt * kCols; i += kThreads) {
    const int c = i % kCols;
    const int r = i / kCols;
    const int t = r % nt, k = r / nt;
    const int x = x0 + c;
    ps[(k * span + t) * kCols + c] =
        x < W ? __ldg(g + ((size_t)k * T + tlo + t) * W + x) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nt * kCols; i += kThreads) {
    const int c = i % kCols, t = i / kCols;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      float* p = ps + (k * span + t) * kCols + c;
      acc += *p;
      *p = acc;
    }
  }
  __syncthreads();

  const int c = threadIdx.x % kCols;
  const int x = x0 + c;
  if (x >= W) return;
  const float top = (float)(K - 1);
  for (int y = y0 + threadIdx.x / kCols; y < y1; y += kRowThreads) {
    const size_t o = ((size_t)b * H + y) * W + x;
    const float idx = floorf(__ldg(luma + o) * top);
    float v = 0.f;
    if (idx >= 0.f) {  // false for NaN too: no bin's gate opens
      const int j = idx >= top ? K - 1 : (int)idx;
      const int t0 = __ldg(ytap + y) - tlo, t1 = __ldg(ytap + H + y) - tlo;
      v = __ldg(ywt + y) * ps[(j * span + t0) * kCols + c] +
          __ldg(ywt + H + y) * ps[(j * span + t1) * kCols + c];
    }
    out[o] = v;
  }
}

}  // namespace

// luma (B, H, W) f32, gx (B, K, T, W) f32, ytap (2, H) int32 [lo; hi],
// ywt (2, H) f32 [w_lo; w_hi], out (B, H, W) f32.  Every block of
// rows_per_block rows must touch at most `span` tiles.
extern "C" int clahe_tiled_apply(const void* luma, const void* gx, const void* ytap,
                                 const void* ywt, void* out, int B, int H, int W, int T,
                                 int K, int rows_per_block, int span, void* stream) {
  if (B < 1 || H < 1 || W < 1 || T < 1 || K < 1 || rows_per_block < 1 || span < 1 ||
      span > T || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * span * kCols * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        clahe_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((W + kCols - 1) / kCols),
                  (unsigned)((H + rows_per_block - 1) / rows_per_block), (unsigned)B);
  clahe_apply_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)luma, (const float*)gx, (const int*)ytap, (const float*)ywt,
      (float*)out, H, W, T, K, rows_per_block, span);
  return (int)cudaGetLastError();
}
