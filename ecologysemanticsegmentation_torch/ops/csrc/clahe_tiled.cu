// Tile-interpolated CLAHE apply for Hopper (sm_90a), from the tile deltas:
//
//   out[b,y,x] = sum_{a,c in {lo,hi}} wy_a(y) * wx_c(x) * P[b, ty_a(y), tx_c(x), j]
//
// with l the (B, H, W) f32 luminance, d the (B, T, T, K) f32 per-tile CDF
// steps, P[b,t,s,j] = d[b,t,s,0] + ... + d[b,t,s,j] each tile's LUT,
// j = min(floor(l*(K-1)), K-1), and (ty_lo, ty_hi, wy_lo, wy_hi) /
// (tx_lo, tx_hi, wx_lo, wx_hi) the two-tap rows of the (H, T) / (W, T)
// tile weights (clamped rows: lo == hi, w_hi = 0).  out = 0 where
// floor(l*(K-1)) < 0 or l is NaN, as the reference's gate
// 1{floor(l*(K-1)) >= k} gives for every l.  Forward only.
//
// Replaces the TPU kernel
// ecologysemanticsegmentation_tpu/ops/pallas/clahe_tiled.py::_kernel (the
// pallas_call of tiled_clahe_new_luma), which takes Gx, the deltas already
// interpolated along x (B, K, T, W), because the TPU's matrix unit wants
// dense (H, T) @ (T, W) dots.  Here no Gx exists: the kernel reads the
// deltas themselves.
//
// What bounds it on this card: bytes, those of the whole function.  At
// batch 128, 256 px, K = 64 it reads l (33.5 MB) and the deltas (2.1 MB)
// and writes out (33.5 MB); its ~11 flops a pixel lie far below the f32
// rate.  The design:
//
// - one block per (image, band of rows); the band's rows touch tile rows
//   [tlo, thi] (the taps never decrease in y), T x K contiguous floats of
//   the deltas each, which the block copies into shared memory with 16-byte
//   loads (8 KB at the main shape's 64-row bands; 25 KB in all);
// - each warp takes the inclusive prefix over K of whole tiles, 32 bins at
//   a time with a shuffle scan (log depth), into the LUT, which holds at
//   (j, tile) the pair (P[tile][j], P[tile + 1][j]): one 8-byte lookup
//   serves both x taps of a tile row.  Layout [j][tile row][tile] with an
//   odd stride per j; on random luminance the [tile][j] layout measured the
//   same (PERF.md), as random bins spread over the banks either way;
// - each warp then streams rows of the band: luma in and out as float4
//   (16-byte) loads and stores, the lo x taps and their w_hi for four
//   pixels as two 16-byte loads from the cached tables (w_lo = 1 - w_hi,
//   bitwise), and two pair lookups a pixel.  A W
//   that is not a multiple of 4, or an unaligned pointer, takes the scalar
//   path.
//
// Measured (PERF.md): the stream alone, its lookups replaced by a copy,
// takes about as long as the kernel, and a plain copy of the same bytes
// less: the stream's structure (two float4 a lane in flight, at the
// occupancy 48 registers allow), not the LUT work, holds it above the
// byte bound.
//
// Rounding against the plain version (which sums x in the einsum, then the
// y taps, then the gated bins): the same terms summed in another order, k
// first, then the x taps, then the y taps; both are f32 sums of at most
// K + 4 terms of magnitude <= 1, so they differ by a few f32 ulps of 1.
//
// The C interface takes raw pointers and the stream and returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kSmem = 48 * 1024;           // shared memory a block takes without opting in

// The LUT's index of the pair (P[ts][j], P[ts + 1][j]) of tile ts (tile row
// within the band times T, plus the tile's column); sj, the stride of j in
// pairs, is odd and >= the band's tile count.
__device__ __forceinline__ int lut_at(int j, int ts, int K, int sj) {
  return j * sj + ts;
}

// The x interpolation of one tile row at bin j: the pair at the lo tap
// holds both taps (hi = lo + 1, or lo with w_hi = 0 where the column is
// clamped, the pair's second value then that of the clamped tile itself).
__device__ __forceinline__ float taps_x(const float2* lut, int j, int row, int s_lo,
                                        float wx_lo, float wx_hi, int K, int sj) {
  const float2 p = lut[lut_at(j, row + s_lo, K, sj)];
  return wx_lo * p.x + wx_hi * p.y;
}

// One pixel's equalized luminance.  j is clamped to [0, K-1] (NaN -> 0) so
// the lookups stay inside the LUT; the gate then zeroes l < 0 and NaN.
__device__ __forceinline__ float pixel(const float2* lut, float l, float top, int K, int sj,
                                       int row_lo, int row_hi, float wy_lo, float wy_hi,
                                       int s_lo, float wx_hi) {
  const float idx = floorf(l * top);
  const int j = (int)fminf(fmaxf(idx, 0.f), top);
  const float wx_lo = 1.f - wx_hi;  // bitwise the table's w_lo (tested on the CPU)
  const float v = wy_lo * taps_x(lut, j, row_lo, s_lo, wx_lo, wx_hi, K, sj) +
                  wy_hi * taps_x(lut, j, row_hi, s_lo, wx_lo, wx_hi, K, sj);
  return idx >= 0.f ? v : 0.f;  // false for NaN too: no bin's gate opens
}

__global__ void __launch_bounds__(kThreads)
    clahe_apply_kernel(const float* __restrict__ luma, const float* __restrict__ deltas,
                       const int* __restrict__ ytap, const float* __restrict__ ywt,
                       const int* __restrict__ xtap, const float* __restrict__ xwt,
                       float* __restrict__ out, int H, int W, int T, int K,
                       int rows_per_block, int span) {
  extern __shared__ __align__(16) float smem[];
  const int sj = (span * T) | 1;
  float2* lut = reinterpret_cast<float2*>(smem);  // (K, sj) pairs: the band's tile LUTs
  float* raw = smem + 2 * ((K * sj + 1) & ~1);     // (nt * T, K): the band's deltas, 16-byte aligned
  const int b = blockIdx.y;
  const int y0 = blockIdx.x * rows_per_block;
  const int y1 = min(y0 + rows_per_block, H);
  const int tlo = __ldg(ytap + y0);
  const int nt = __ldg(ytap + H + y1 - 1) - tlo + 1;  // <= span, checked by the host
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Stage tile rows [tlo, tlo + nt): one contiguous run of nt * T * K floats.
  const float* src = deltas + ((size_t)b * T + tlo) * T * K;
  const int n = nt * T * K;
  if ((((uintptr_t)src) & 15) == 0 && (n & 3) == 0) {
    for (int i = threadIdx.x; i < (n >> 2); i += kThreads)
      reinterpret_cast<float4*>(raw)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) raw[i] = __ldg(src + i);
  }
  __syncthreads();

  // Inclusive prefix over K of every tile, a warp per tile, 32 bins a step;
  // each value goes to its tile's pair and to the pair of the tile before
  // (the last tile of a row pairs with itself).
  for (int ts = warp; ts < nt * T; ts += kWarps) {
    const int s = ts % T;
    float carry = 0.f;
    for (int j0 = 0; j0 < K; j0 += 32) {
      const int j = j0 + lane;
      const float own = j < K ? raw[ts * K + j] : 0.f;
      float v = own;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      if (j < K) {
        lut[lut_at(j, ts, K, sj)].x = v;
        if (s > 0) lut[lut_at(j, ts - 1, K, sj)].y = v;
        if (s == T - 1) lut[lut_at(j, ts, K, sj)].y = v;
      }
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();

  // Stream the band: a warp per row, its y taps uniform across the warp.
  const float top = (float)(K - 1);
  const bool vec = (W & 3) == 0 && ((((uintptr_t)luma) | ((uintptr_t)out)) & 15) == 0;
  for (int y = y0 + warp; y < y1; y += kWarps) {
    const int row_lo = (__ldg(ytap + y) - tlo) * T, row_hi = (__ldg(ytap + H + y) - tlo) * T;
    const float wy_lo = __ldg(ywt + y), wy_hi = __ldg(ywt + H + y);
    const size_t o = ((size_t)b * H + y) * W;
    if (vec) {
      const float4* lrow = reinterpret_cast<const float4*>(luma + o);
      float4* orow = reinterpret_cast<float4*>(out + o);
      const int4* xlo = reinterpret_cast<const int4*>(xtap);         // lo taps
      const float4* whi = reinterpret_cast<const float4*>(xwt + W);  // w_hi
      const int W4 = W >> 2;
      auto quad = [&](int c, float4 l) {
        const int4 sl = __ldg(xlo + c);
        const float4 wh = __ldg(whi + c);
        float4 r;
        r.x = pixel(lut, l.x, top, K, sj, row_lo, row_hi, wy_lo, wy_hi, sl.x, wh.x);
        r.y = pixel(lut, l.y, top, K, sj, row_lo, row_hi, wy_lo, wy_hi, sl.y, wh.y);
        r.z = pixel(lut, l.z, top, K, sj, row_lo, row_hi, wy_lo, wy_hi, sl.z, wh.z);
        r.w = pixel(lut, l.w, top, K, sj, row_lo, row_hi, wy_lo, wy_hi, sl.w, wh.w);
        orow[c] = r;
      };
      // two float4 a lane in flight before either is used
      for (int x4 = lane; x4 < W4; x4 += 64) {
        const bool second = x4 + 32 < W4;
        const float4 la = __ldg(lrow + x4);
        const float4 lb = second ? __ldg(lrow + x4 + 32) : la;
        quad(x4, la);
        if (second) quad(x4 + 32, lb);
      }
    } else {
      for (int x = lane; x < W; x += 32)
        out[o + x] = pixel(lut, __ldg(luma + o + x), top, K, sj, row_lo, row_hi, wy_lo, wy_hi,
                           __ldg(xtap + x), __ldg(xwt + W + x));
    }
  }
}

// Shared memory of a block: the (K, sj) LUT of float2 pairs, padded to 16
// bytes, and the (span * T, K) staged deltas.
size_t smem_bytes(int T, int K, int span) {
  const size_t sj = (size_t)(span * T) | 1;
  return ((K * sj + 1) & ~(size_t)1) * 2 * sizeof(float) + (size_t)span * T * K * sizeof(float);
}

}  // namespace

// luma (B, H, W) f32, deltas (B, T, T, K) f32, ytap/xtap (2, H)/(2, W)
// int32 [lo; hi], ywt/xwt (2, H)/(2, W) f32 [w_lo; w_hi], out (B, H, W)
// f32.  Every band of rows_per_block rows must touch at most `span` tile
// rows, and the block's shared memory (smem_bytes) fit in 48 KB.
extern "C" int clahe_tiled_apply(const void* luma, const void* deltas, const void* ytap,
                                 const void* ywt, const void* xtap, const void* xwt, void* out,
                                 int B, int H, int W, int T, int K, int rows_per_block, int span,
                                 void* stream) {
  if (B < 1 || H < 1 || W < 1 || T < 1 || K < 1 || rows_per_block < 1 || span < 1 ||
      span > T || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T, K, span);
  if (smem > (size_t)kSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((H + rows_per_block - 1) / rows_per_block), (unsigned)B);
  clahe_apply_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)luma, (const float*)deltas, (const int*)ytap, (const float*)ywt,
      (const int*)xtap, (const float*)xwt, (float*)out, H, W, T, K, rows_per_block, span);
  return (int)cudaGetLastError();
}
