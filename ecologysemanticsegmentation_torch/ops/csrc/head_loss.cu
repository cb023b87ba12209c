// Fused head loss for Hopper (sm_90a): x4 bilinear upsample of the
// 1/4-resolution logits, sigmoid, and the eight masked per-channel loss sums,
// with a recompute-in-backward gradient back to the low-resolution logits.
//
// Replaces the TPU kernel pair of
// ecologysemanticsegmentation_tpu/ops/pallas/head_loss.py::_make_fused
// (_fwd_kernel and _bwd_kernel), the row-blocked pair of _make_fused_rows
// (_fwd_kernel_rows, _bwd_kernel_rows), which the JAX package selects at
// 512 px and above, and the per-shard _make_fused_spatial of
// --spatial_partition training: one kernel pair covers any h -> H and
// w -> W, both align_corners modes, 1 <= C <= 16, and a row block
// [row0, row0 + H_l) of the output (the wrapper passes that block's row
// taps and band tables; rows no output row of the block reaches get 0).
//
// What bounds it on this card: issued instructions, not bytes.  At the
// main shape (batch 128, 64^2 -> 256^2, C = 3) the byte bounds are 0.0169
// ms forward and 0.0188 ms backward; the element math costs more.  The
// first design of this file (accurate expf, logf, log1pf, sqrtf and IEEE
// divides, a 64-bit division and eight table loads per pixel, a backward of
// two launches through a (B, H, w, C) intermediate) issued 216 SASS
// instructions per element in the forward's inner loop and 245 in the
// backward's (cuobjdump -sass: ops/sass_loops.py, C = 3); this one issues
// 53 and 55, two rows of 3 elements an iteration (PERF.md).  What the
// design does about it:
//  - p and 1 - p and both square roots come from one exp(-|u|/2) and one
//    rsqrt(1 + exp(-|u|)) without cancellation (the larger is 1/d, the
//    smaller e/d); the logs are lg2.approx, the one reciprocal left
//    rcp.approx, and the softplus and sigmoid of the probability (which
//    lies in [0, 1]) degree-6 polynomials within 6e-8: 4 MUFU operations
//    an element forward, 5 backward.  Only this file uses approximations:
//    the shared NVCC_FLAGS keep IEEE math for the other kernels.
//  - the upsample is separable on chip: a tile's few low-resolution logit
//    rows come into shared memory with its labels, each output row is
//    interpolated once per low-resolution column, and a thread keeps its
//    output columns for the tile, so its two column taps stay in registers;
//    it takes two rows at a time, for more independent work in flight.
//  - labels and logit rows stream in by cp.async.bulk into a two-stage ring
//    of shared memory, completing on mbarriers, two tiles ahead.  Where a
//    tile is not one run of 16-byte rows (ragged W * C, a column band), the
//    block loads it itself, in the same kernel.
//  - forward: per-block (8, C) partials; the last block to finish adds them
//    in block order (an integer ticket, no float atomics): deterministic.
//  - backward, one launch, no (B, H, w, C) intermediate: a block owns a band
//    of low-resolution rows (and columns), recomputes du only for the output
//    rows whose taps reach the band (the run of about H/h rows between two
//    bands is recomputed by both), contracts columns then rows into the
//    band's dlogits in shared memory, each dlogit a fixed-order sum only one
//    thread touches, and writes it once.
//  - no tensor cores: each axis has two taps, so a dense Mh or Mw product at
//    x4 is about 97% zeros, and TF32 would break the f32 upsample that the
//    reference keeps from the resize through the sigmoid.
//
// The C interface takes raw pointers, the wrapper's plan
// (ops/head_loss.py::_fwd_plan, _bwd_plan) and the stream; each function
// returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-7f;
constexpr float kGamma = 1.5f;
constexpr float kLn2 = 0.693147180559945309f;
constexpr float kHalfLog2e = 0.721347520444481703f;  // log2(e) / 2
constexpr float kGammaLn2 = 1.5f * 0.693147180559945309f;
constexpr int kSums = 8;
constexpr int kThreads = 256;
constexpr int kMaxRows = 8;  // the most output rows one tile holds
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // shared memory a block may opt into
constexpr int kMaxDynSmem = kMaxSmem - kWarps * kSums * 16 * 4;  // less the reduction buffer

// Two-tap interpolation tables, one per axis, for output size n:
// idx[0:n] = lo, idx[n:2n] = hi; wt[0:n] = w_lo, wt[n:2n] = w_hi.
struct Taps {
  const int* idx;
  const float* wt;
  int n;
};

// One launch's tiling, chosen by the wrapper (ops/head_loss.py::_fwd_plan,
// _bwd_plan), which sizes it with the same shared-memory layout as layout().
struct Plan {
  int rs;   // output rows per tile: one stage of the ring
  int tpb;  // forward: tiles per block
  int tw;   // output columns per column band (the widest band)
  int nj;   // low-resolution columns one column band reads (the most)
  int nl;   // low-resolution rows one tile reads (the most)
  int nb;   // backward: low-resolution rows per row band
  int jw;   // backward: low-resolution columns per column band
  int tma;  // 1: tiles by bulk copy (full-width tiles, rows of 16-byte multiples)
};

struct Layout {
  size_t xrows, stage, du, row, dx, wx, run, tap, total;
};

__host__ __device__ inline size_t align_up(size_t v, size_t a) { return (v + a - 1) / a * a; }

// Dynamic shared memory: two mbarriers; two ring stages, each a tile's
// labels then the low-resolution logit rows it reads; the tile's
// row-interpolated logits; and in the backward the tile's du, the band's
// dlogits, the band's column weights and column runs, and two stages of the
// tile's row taps.
__host__ __device__ inline Layout layout(const Plan& p, int C, bool bwd) {
  Layout l;
  l.xrows = align_up((size_t)p.rs * p.tw * C * 2, 128);
  l.stage = l.xrows + align_up((size_t)p.nl * p.nj * C * 4, 128);
  size_t off = 128 + 2 * l.stage;
  l.row = off;
  off += (size_t)p.rs * p.nj * C * 4;
  l.du = l.dx = l.wx = l.run = l.tap = off;
  if (bwd) {
    l.du = off;
    off += (size_t)p.rs * p.tw * C * 4;
    l.dx = off;
    off += (size_t)p.nb * p.jw * C * 4;
    l.wx = off;
    off += (size_t)2 * p.tw * 4;
    l.run = off;
    off += (size_t)4 * p.jw * 4;
    l.tap = off;
    off += (size_t)2 * 4 * kMaxRows * 4;
  }
  l.total = off;
  return l;
}

// ---- approximate transcendentals (one MUFU instruction each) ----------------
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rsq(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p = sigmoid(u) and q = 1 - p from one exp(-|u|/2) and one
// 1/sqrt(1 + exp(-|u|)): with e = exp(-|u|) and d = 1 + e, the larger of p
// and q is big = 1/d and the smaller small = e/d, so neither is formed by
// cancellation, and their square roots come with them.  The formulas below
// are written in big and small; pos says which of them is p.
struct Sig {
  float p, big, small, sbig, ssmall, d;
  bool pos;
};
__device__ __forceinline__ Sig sigmoid_parts(float u) {
  const float hh = ex2(fabsf(u) * -kHalfLog2e);  // exp(-|u|/2)
  const float e = hh * hh;
  const float d = 1.f + e;
  const float s = rsq(d);  // sqrt(big)
  const float big = s * s;
  const float small = e * big;
  const bool pos = u >= 0.f;
  return Sig{pos ? big : small, big, small, s, hh * s, d, pos};
}

// log(1 + exp(-p)) and 1 / (1 + exp(-p)) on p in [0, 1]: degree-6 Chebyshev
// fits, within 6e-8 in f32 (the argument is a probability, so no range
// reduction is needed).
__device__ __forceinline__ float softplus_neg01(float p) {
  float r = 1.85196390e-4f;
  r = fmaf(r, p, 2.84376205e-4f);
  r = fmaf(r, p, -5.41989645e-3f);
  r = fmaf(r, p, 7.71541818e-5f);
  r = fmaf(r, p, 1.24986865e-1f);
  r = fmaf(r, p, -4.99999166e-1f);
  return fmaf(r, p, 6.93147182e-1f);
}
__device__ __forceinline__ float sigmoid01(float p) {
  float r = -5.16951957e-4f;
  r = fmaf(r, p, 2.65570730e-3f);
  r = fmaf(r, p, -3.38983256e-4f);
  r = fmaf(r, p, -2.07252167e-2f);
  r = fmaf(r, p, -1.69915747e-5f);
  r = fmaf(r, p, 2.50001043e-1f);
  return fmaf(r, p, 0.5f);
}

// d(sums)/dp with the (8, C) cotangent k1..k6 applied, times sigmoid' =
// p q: the formula of the Pallas _bwd_kernel (eps inside the logs and the
// reciprocals, the softplus of the probability).  Its focal rows,
//   k4 sqrt(q) (q/(p+eps) - gamma log(p+eps))
//   + k5 sqrt(p) (gamma log(q+eps) - p/(q+eps)),
// are k4 sqrt(small) a - k5 sqrt(big) b where p is big, and
// k4 sqrt(big) b - k5 sqrt(small) a where it is small, with
// a = small/(big+eps) - gamma log(big+eps), b = big/(small+eps) - gamma log(small+eps).
// k2x2 = 2 k2.  Labels are 0 or 1 here (the caller masks -1).
__device__ __forceinline__ float du_of(float u, float gv, float k1, float k2x2, float k3, float k4,
                                      float k5, float k6) {
  const Sig sg = sigmoid_parts(u);
  const float inv_big = sg.d * fmaf(-kEps, sg.d, 1.f);  // 1 / (1/d + eps)
  const float a = fmaf(-kGammaLn2, lg2(sg.big + kEps), sg.small * inv_big);
  const float b = fmaf(-kGammaLn2, lg2(sg.small + kEps), sg.big * rcp(sg.small + kEps));
  const float ca = sg.pos ? k4 : -k5, cb = sg.pos ? -k5 : k4;
  const float soft = sg.p > 0.f ? sigmoid01(sg.p) : 0.f;  // (p > 0) - sign(p) / (1 + e^|p|)
  float dp = fmaf(k2x2, sg.p, k1);
  dp = fmaf(k3, gv, dp);
  dp = fmaf(k6, soft, dp);
  dp = fmaf(ca, sg.ssmall * a, dp);
  dp = fmaf(cb, sg.sbig * b, dp);
  return dp * (sg.big * sg.small);
}

// The forward's eight rows for one element of channel c (u the upsampled
// logit, gv its label); nothing where !valid or the label is the -1 ignore
// sentinel, which drops out of every row.
template <int C>
__device__ __forceinline__ void add_sums(float (&acc)[kSums][C], int c, float u, float gv,
                                         bool valid) {
  const bool keep = valid && gv >= 0.f;
  const Sig sg = sigmoid_parts(u);
  const float pm = keep ? sg.p : 0.f, gm = keep ? gv : 0.f;
  // q^1.5 log2(p+eps) and p^1.5 log2(q+eps) (x ln 2 when the block sums):
  // one is small^1.5 log2(big+eps), the other big^1.5 log2(small+eps)
  const float sb = sg.small * sg.ssmall * lg2(sg.big + kEps);
  const float bs = sg.big * sg.sbig * lg2(sg.small + kEps);
  acc[0][c] += gm;
  acc[1][c] += pm;
  acc[2][c] = fmaf(pm, sg.p, acc[2][c]);
  acc[3][c] = fmaf(gm, sg.p, acc[3][c]);
  acc[4][c] += keep ? (sg.pos ? sb : bs) : 0.f;
  acc[5][c] += keep ? (sg.pos ? bs : sb) : 0.f;
  // softplus of the probability, not of the logit (the reference's BCE
  // applies a with-logits formula to sigmoided outputs)
  acc[6][c] += keep ? sg.p + softplus_neg01(sg.p) : 0.f;
  acc[7][c] += keep ? 1.f : 0.f;
}

// The block's sum of every thread's acc, in a fixed order (a shuffle tree
// in each warp, then the warps in order), into out[0 : 8 C]; each writing
// thread then fences its write, so that it is visible to the whole device
// before the block takes its ticket.
template <int C>
__device__ __forceinline__ void block_sum(float (&acc)[kSums][C], float (&red)[kWarps][kSums * C],
                                          float* out) {
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
  for (int k = threadIdx.x; k < kSums * C; k += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += red[i][k];
    out[k] = s;
    __threadfence();
  }
  __syncthreads();
}

// ---- the label ring: bulk copies into two shared stages -----------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n\t"
      "@!P bra WAIT;\n}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One tile: label rows [ys, ys + nr) of the image (full width, nr * W * C
// bf16) and the logit rows [l0, l0 + nl) they read (nl * w * C f32), both
// contiguous runs of 16-byte multiples (the plan's tma), into one stage,
// completing on its mbarrier.
template <int C>
__device__ __forceinline__ void tile_issue(uint64_t* bar, unsigned char* stage, size_t xrows,
                                           const __nv_bfloat16* gim, const float* xim, int W,
                                           int w, int ys, int nr, int l0, int nl) {
  const uint32_t lb = (uint32_t)nr * W * C * 2, xbytes = (uint32_t)nl * w * C * 4;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(lb + xbytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(stage)),
      "l"(gim + (size_t)ys * W * C), "r"(lb), "r"(smem_u32(bar))
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(stage + xrows)),
      "l"(xim + (size_t)l0 * w * C), "r"(xbytes), "r"(smem_u32(bar))
      : "memory");
}

// The same tile, columns [xa, xa + tw) and low-resolution columns
// [ja, ja + nj), by the block's own loads (ragged rows or a column band).
template <int C>
__device__ __forceinline__ void tile_fill(unsigned char* stage, size_t xrows,
                                          const __nv_bfloat16* gim, const float* xim, int W,
                                          int w, int xa, int tw, int ys, int nr, int ja, int nj,
                                          int l0, int nl) {
  __nv_bfloat16* lab = reinterpret_cast<__nv_bfloat16*>(stage);
  float* xs = reinterpret_cast<float*>(stage + xrows);
  const int n = tw * C, k = nj * C;
  for (int r = 0; r < nr; ++r) {
    const __nv_bfloat16* src = gim + ((size_t)(ys + r) * W + xa) * C;
    for (int q = threadIdx.x; q < n; q += kThreads) lab[r * n + q] = src[q];
  }
  for (int r = 0; r < nl; ++r) {
    const float* src = xim + ((size_t)(l0 + r) * w + ja) * C;
    for (int q = threadIdx.x; q < k; q += kThreads) xs[r * k + q] = src[q];
  }
}

// Rows first: rowS[r][j, c] = w_lo(y) x[lo(y), ja + j, c] + w_hi(y) x[hi(y), ja + j, c]
// for the tile's output rows y = ys + r, from the staged logit rows
// [l0, l0 + nl) (xs, nj * C floats each).
template <int C>
__device__ __forceinline__ void row_interp(float* rowS, const float* xs, Taps ty, int ys,
                                           int nr, int l0, int nj) {
  const int n = nj * C;
  for (int r = 0; r < nr; ++r) {
    const int y = ys + r;
    const float* r0 = xs + (__ldg(ty.idx + y) - l0) * n;
    const float* r1 = xs + (__ldg(ty.idx + ty.n + y) - l0) * n;
    const float wl = __ldg(ty.wt + y), wh = __ldg(ty.wt + ty.n + y);
    for (int q = threadIdx.x; q < n; q += kThreads) rowS[r * n + q] = wl * r0[q] + wh * r1[q];
  }
}

// Ring set-up: both mbarriers, and the first two tiles in flight.
template <int C>
__device__ __forceinline__ void ring_start(uint64_t* bar, unsigned char* smem, const Layout& L,
                                           Taps ty, const __nv_bfloat16* gim, const float* xim,
                                           int W, int w, int y0, int y1, int rs, int ntiles,
                                           bool tma) {
  if (tma && threadIdx.x == 0) {
    bar_init(bar);
    bar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tma && threadIdx.x == 0)
    for (int t = 0; t < 2 && t < ntiles; ++t) {
      const int ys = y0 + t * rs, ye = min(y1, ys + rs), l0 = __ldg(ty.idx + ys);
      tile_issue<C>(bar + t, smem + 128 + t * L.stage, L.xrows, gim, xim, W, w, ys, ye - ys, l0,
                    __ldg(ty.idx + ty.n + ye - 1) - l0 + 1);
    }
}

// Tile t's stage, ready: waited for (bulk copy) or loaded by the block and
// synchronised.
template <int C>
__device__ __forceinline__ void ring_acquire(uint64_t* bar, unsigned char* stage,
                                             const Layout& L, const __nv_bfloat16* gim,
                                             const float* xim, int W, int w, int xa, int tw,
                                             int ys, int nr, int ja, int nj, int l0, int nl,
                                             int t, bool tma) {
  if (tma) {
    bar_wait(bar + (t & 1), (t >> 1) & 1);
  } else {
    tile_fill<C>(stage, L.xrows, gim, xim, W, w, xa, tw, ys, nr, ja, nj, l0, nl);
    __syncthreads();
  }
}

// Once the block is done with tile t's stage: tile t + 2 into it.
template <int C>
__device__ __forceinline__ void ring_release(uint64_t* bar, unsigned char* smem, const Layout& L,
                                             Taps ty, const __nv_bfloat16* gim,
                                             const float* xim, int W, int w, int y0, int y1,
                                             int rs, int t, int ntiles, bool tma) {
  if (tma && threadIdx.x == 0 && t + 2 < ntiles) {
    const int ys = y0 + (t + 2) * rs, ye = min(y1, ys + rs), l0 = __ldg(ty.idx + ys);
    tile_issue<C>(bar + (t & 1), smem + 128 + (t & 1) * L.stage, L.xrows, gim, xim, W, w, ys,
                  ye - ys, l0, __ldg(ty.idx + ty.n + ye - 1) - l0 + 1);
  }
}

// Forward: one block per (image, run of tpb tiles of rs output rows, column
// band).  A thread keeps its output columns (and so its two column taps)
// for the whole tile and walks the tile's rows; the 8*C sums stay in
// registers and each block writes its own partial.  The last block to
// finish (an integer ticket; no float atomics) adds the partials in block
// order into the (8, C) sums and sets the ticket back to 0 for the next
// launch on the stream.
template <int C>
__global__ void __launch_bounds__(kThreads, C <= 4 ? 4 : 1)
    head_fwd_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ g, Taps ty,
                    Taps tx, float* __restrict__ partials, unsigned* __restrict__ done,
                    float* __restrict__ sums, int h, int w, int H, int W, Plan pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(pl, C, false);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* rowS = reinterpret_cast<float*>(smem + L.row);
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * pl.rs * pl.tpb;
  const int y1 = min(H, y0 + pl.rs * pl.tpb);
  const int xa = blockIdx.x * pl.tw, xb = min(W, xa + pl.tw), tw = xb - xa;
  const int ja = __ldg(tx.idx + xa), nj = __ldg(tx.idx + W + xb - 1) - ja + 1;
  const int ntiles = (y1 - y0 + pl.rs - 1) / pl.rs;
  const float* xim = x + (size_t)b * h * w * C;
  const __nv_bfloat16* gim = g + (size_t)b * H * W * C;
  ring_start<C>(bar, smem, L, ty, gim, xim, W, w, y0, y1, pl.rs, ntiles, pl.tma);

  float acc[kSums][C];
#pragma unroll
  for (int k = 0; k < kSums; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] = 0.f;

  const int cl = min(tw, kThreads), rg = kThreads / cl;
  const int xt = threadIdx.x % cl, rt = threadIdx.x / cl;
  const int n = nj * C;
  for (int t = 0; t < ntiles; ++t) {
    const int ys = y0 + t * pl.rs, nr = min(pl.rs, y1 - ys), l0 = __ldg(ty.idx + ys);
    unsigned char* st = smem + 128 + (t & 1) * L.stage;
    const __nv_bfloat16* lab = reinterpret_cast<const __nv_bfloat16*>(st);
    ring_acquire<C>(bar, st, L, gim, xim, W, w, xa, tw, ys, nr, ja, nj, l0,
                    __ldg(ty.idx + H + ys + nr - 1) - l0 + 1, t, pl.tma);
    row_interp<C>(rowS, reinterpret_cast<const float*>(st + L.xrows), ty, ys, nr, l0, nj);
    __syncthreads();
    if (rt < rg)
      for (int xx = xt; xx < tw; xx += cl) {
        const int gx = xa + xx;
        const int olo = (__ldg(tx.idx + gx) - ja) * C, ohi = (__ldg(tx.idx + W + gx) - ja) * C;
        const float wl = __ldg(tx.wt + gx), wh = __ldg(tx.wt + W + gx);
        // two rows at a time, for more independent work in flight
        for (int r = rt; r < nr; r += 2 * rg) {
          const int r2 = min(r + rg, nr - 1);  // row r again where the tile has an odd row out
          const float* rr = rowS + r * n;
          const float* rr2 = rowS + r2 * n;
          const __nv_bfloat16* gg = lab + ((size_t)r * tw + xx) * C;
          const __nv_bfloat16* gg2 = lab + ((size_t)r2 * tw + xx) * C;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            add_sums<C>(acc, c, wl * rr[olo + c] + wh * rr[ohi + c], __bfloat162float(gg[c]),
                        true);
            add_sums<C>(acc, c, wl * rr2[olo + c] + wh * rr2[ohi + c], __bfloat162float(gg2[c]),
                        r + rg < nr);
          }
        }
      }
    __syncthreads();  // the stage and rowS are free again
    ring_release<C>(bar, smem, L, ty, gim, xim, W, w, y0, y1, pl.rs, t, ntiles, pl.tma);
  }

  __shared__ float red[kWarps][kSums * C];
  __shared__ unsigned ticket;
  const unsigned nblk = gridDim.x * gridDim.y * gridDim.z;
  const size_t blk = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
#pragma unroll
  for (int k = 4; k < 6; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] *= kLn2;
  block_sum<C>(acc, red, partials + blk * kSums * C);
  if (threadIdx.x == 0) ticket = atomicAdd(done, 1u);
  __syncthreads();
  if (ticket != nblk - 1) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < kSums; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] = 0.f;
  for (size_t i = threadIdx.x; i < nblk; i += kThreads)
#pragma unroll
    for (int k = 0; k < kSums; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[k][c] += __ldcg(partials + (i * kSums + k) * C + c);
  block_sum<C>(acc, red, sums);
  if (threadIdx.x == 0) *done = 0u;
}

// Backward: one block per (image, band of nb low-resolution rows [i0, i1),
// band of jw low-resolution columns [j0, j1)).  It recomputes du for exactly
// the output rows [ya, yb) and columns [xa, xb) whose taps reach the band
// (the wrapper's band tables), tile by tile into shared memory; then each
// thread, for the (j, c) it owns, contracts the columns (two taps: the run
// of output columns whose lo tap is j, then those whose hi tap is j) for
// every row of the tile and adds the rows into the band's dlogits, kept in
// shared memory and written once.  Every dlogit is a fixed-order sum that
// only its owner thread touches: no float atomics, no (B, H, w, C)
// intermediate.  A band no output row reaches is written 0.
template <int C>
__global__ void __launch_bounds__(kThreads, C <= 4 ? 3 : 1)
    head_bwd_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                    const float* __restrict__ cot, Taps ty, Taps tx, const int* __restrict__ xrng,
                    const int* __restrict__ rband, const int* __restrict__ cband,
                    float* __restrict__ dx, int h, int w, int H, int W, Plan pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(pl, C, true);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* rowS = reinterpret_cast<float*>(smem + L.row);
  float* duS = reinterpret_cast<float*>(smem + L.du);
  float* dxS = reinterpret_cast<float*>(smem + L.dx);
  float* wxS = reinterpret_cast<float*>(smem + L.wx);  // [w_lo; w_hi] of the band's columns
  int* runS = reinterpret_cast<int*>(smem + L.run);    // the column runs, band-local
  int* tapS = reinterpret_cast<int*>(smem + L.tap);    // per stage: lo, hi, w_lo, w_hi
  const int b = blockIdx.z, rb = blockIdx.y, cb = blockIdx.x;
  const int i0 = rb * pl.nb, i1 = min(h, i0 + pl.nb), j0 = cb * pl.jw, j1 = min(w, j0 + pl.jw);
  const int nbr = i1 - i0, njw = j1 - j0, m = njw * C;
  const int ya = __ldg(rband + rb), yb = __ldg(rband + gridDim.y + rb);
  const int xa = __ldg(cband + cb), xb = __ldg(cband + gridDim.x + cb), tw = xb - xa;
  const float* xim = x + (size_t)b * h * w * C;
  const __nv_bfloat16* gim = g + (size_t)b * H * W * C;
  for (int k = threadIdx.x; k < nbr * m; k += kThreads) dxS[k] = 0.f;

  if (ya < yb && xa < xb) {
    float kk[6][C];
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c) kk[j][c] = __ldg(cot + (j + 1) * C + c) * (j == 1 ? 2.f : 1.f);
    const int ja = __ldg(tx.idx + xa), nj = __ldg(tx.idx + W + xb - 1) - ja + 1;
    const int ntiles = (yb - ya + pl.rs - 1) / pl.rs;
    for (int k = threadIdx.x; k < tw; k += kThreads) {
      wxS[k] = __ldg(tx.wt + xa + k);
      wxS[tw + k] = __ldg(tx.wt + W + xa + k);
    }
    for (int k = threadIdx.x; k < njw; k += kThreads)
#pragma unroll
      for (int e = 0; e < 4; ++e) runS[e * njw + k] = __ldg(xrng + e * w + j0 + k) - xa;
    ring_start<C>(bar, smem, L, ty, gim, xim, W, w, ya, yb, pl.rs, ntiles, pl.tma);

    const int cl = min(tw, kThreads), rg = kThreads / cl;
    const int xt = threadIdx.x % cl, rt = threadIdx.x / cl;
    const int n = nj * C;
    for (int t = 0; t < ntiles; ++t) {
      const int ys = ya + t * pl.rs, nr = min(pl.rs, yb - ys), l0 = __ldg(ty.idx + ys);
      unsigned char* st = smem + 128 + (t & 1) * L.stage;
      const __nv_bfloat16* lab = reinterpret_cast<const __nv_bfloat16*>(st);
      int* tap = tapS + (t & 1) * 4 * kMaxRows;
      if (threadIdx.x < nr) {
        const int y = ys + threadIdx.x;
        tap[threadIdx.x] = __ldg(ty.idx + y) - i0;
        tap[kMaxRows + threadIdx.x] = __ldg(ty.idx + H + y) - i0;
        reinterpret_cast<float*>(tap)[2 * kMaxRows + threadIdx.x] = __ldg(ty.wt + y);
        reinterpret_cast<float*>(tap)[3 * kMaxRows + threadIdx.x] = __ldg(ty.wt + H + y);
      }
      ring_acquire<C>(bar, st, L, gim, xim, W, w, xa, tw, ys, nr, ja, nj, l0,
                      __ldg(ty.idx + H + ys + nr - 1) - l0 + 1, t, pl.tma);
      row_interp<C>(rowS, reinterpret_cast<const float*>(st + L.xrows), ty, ys, nr, l0, nj);
      __syncthreads();
      // du of the tile
      if (rt < rg)
        for (int xx = xt; xx < tw; xx += cl) {
          const int gx = xa + xx;
          const int olo = (__ldg(tx.idx + gx) - ja) * C, ohi = (__ldg(tx.idx + W + gx) - ja) * C;
          const float wl = __ldg(tx.wt + gx), wh = __ldg(tx.wt + W + gx);
          // two rows at a time, for more independent work in flight (where
          // the tile has an odd row out, the second is the first again and
          // stores the same du)
          for (int r = rt; r < nr; r += 2 * rg) {
            const int r2 = min(r + rg, nr - 1);
            const float* rr = rowS + r * n;
            const float* rr2 = rowS + r2 * n;
            const __nv_bfloat16* gg = lab + ((size_t)r * tw + xx) * C;
            const __nv_bfloat16* gg2 = lab + ((size_t)r2 * tw + xx) * C;
            float* dd = duS + ((size_t)r * tw + xx) * C;
            float* dd2 = duS + ((size_t)r2 * tw + xx) * C;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const float u = wl * rr[olo + c] + wh * rr[ohi + c];
              const float u2 = wl * rr2[olo + c] + wh * rr2[ohi + c];
              const float gv = __bfloat162float(gg[c]);
              const float gv2 = __bfloat162float(gg2[c]);
              const float du = du_of(u, fmaxf(gv, 0.f), kk[0][c], kk[1][c], kk[2][c],
                                     kk[3][c], kk[4][c], kk[5][c]);
              const float du2 = du_of(u2, fmaxf(gv2, 0.f), kk[0][c], kk[1][c], kk[2][c],
                                      kk[3][c], kk[4][c], kk[5][c]);
              dd[c] = gv >= 0.f ? du : 0.f;
              dd2[c] = gv2 >= 0.f ? du2 : 0.f;
            }
          }
        }
      __syncthreads();  // the stage and rowS are free again
      ring_release<C>(bar, smem, L, ty, gim, xim, W, w, ya, yb, pl.rs, t, ntiles, pl.tma);
      // For the (j, c) this thread owns: columns, z[r] = sum over x of
      // Mw[x, j] du[r][x, c], the lo run of j then its hi run; then rows,
      // dlogits[lo(y)] += w_lo(y) z[r] and dlogits[hi(y)] += w_hi(y) z[r]
      // for the tile's rows y whose taps are in the band.
      const float* twl = reinterpret_cast<const float*>(tap) + 2 * kMaxRows;
      for (int q = threadIdx.x; q < m; q += kThreads) {
        const int jl = q / C, c = q % C;
        const int a0 = runS[jl], a1 = runS[njw + jl], b0 = runS[2 * njw + jl],
                  b1 = runS[3 * njw + jl];
        const float* dd = duS + c;  // row r, band column xl at (r * tw + xl) * C
        for (int r0 = 0; r0 < nr; r0 += 4) {
          float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
          for (int xl = a0; xl < a1; ++xl) {
            const float wt = wxS[xl];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              if (r0 + r < nr) z[r] += wt * dd[((r0 + r) * tw + xl) * C];
          }
#pragma unroll 4
          for (int xl = b0; xl < b1; ++xl) {
            const float wt = wxS[tw + xl];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              if (r0 + r < nr) z[r] += wt * dd[((r0 + r) * tw + xl) * C];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (r0 + r < nr) {
              const int lo = tap[r0 + r], hi = tap[kMaxRows + r0 + r];
              if (lo >= 0 && lo < nbr) dxS[lo * m + q] += twl[r0 + r] * z[r];
              if (hi >= 0 && hi < nbr) dxS[hi * m + q] += twl[kMaxRows + r0 + r] * z[r];
            }
        }
      }
    }
  }
  __syncthreads();
  for (int r = 0; r < nbr; ++r) {
    float* dst = dx + (((size_t)b * h + i0 + r) * w + j0) * C;
    for (int q = threadIdx.x; q < m; q += kThreads) dst[q] = dxS[r * m + q];
  }
}

#define HEAD_LOSS_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

// A plan the kernels can run: tiles of 1..kMaxRows rows that fit shared
// memory, and bulk copies only of whole, 16-byte aligned rows.
bool plan_ok(const Plan& p, int C, bool bwd, int W, int w, const void* x, const void* g) {
  return p.rs >= 1 && p.rs <= kMaxRows && p.tw >= 1 && p.tw <= W && p.nj >= 1 && p.nj <= w &&
         p.nl >= 1 && layout(p, C, bwd).total <= (size_t)kMaxDynSmem &&
         (!p.tma || (p.tw == W && p.nj == w && (W * C) % 8 == 0 && (w * C) % 4 == 0 &&
                     ((uintptr_t)g & 15) == 0 && ((uintptr_t)x & 15) == 0));
}

}  // namespace

extern "C" int head_loss_fwd(const void* x, const void* g, const void* ytab_idx,
                             const void* ytab_wt, const void* xtab_idx, const void* xtab_wt,
                             void* partials, void* done, void* sums, int B, int h, int w, int H, int W, int C, int rs,
                             int tpb, int tw, int nj, int nl, int tma, void* stream) {
  const Taps ty{(const int*)ytab_idx, (const float*)ytab_wt, H};
  const Taps tx{(const int*)xtab_idx, (const float*)xtab_wt, W};
  const Plan pl{rs, tpb, tw, nj, nl, 0, 0, tma};
  if (!plan_ok(pl, C, false, W, w, x, g) || tpb < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = layout(pl, C, false).total;
  const dim3 grid((unsigned)((W + tw - 1) / tw), (unsigned)((H + rs * tpb - 1) / (rs * tpb)),
                  (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
#define LAUNCH(CC)                                                                              \
  case CC:                                                                                      \
    if (smem > 48 * 1024) {                                                                     \
      const cudaError_t e = cudaFuncSetAttribute(                                               \
          head_fwd_kernel<CC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);         \
      if (e != cudaSuccess) return (int)e;                                                      \
    }                                                                                           \
    head_fwd_kernel<CC><<<grid, kThreads, smem, s>>>((const float*)x, (const __nv_bfloat16*)g, \
                                                     ty, tx, (float*)partials,          \
                                                     (unsigned*)done, (float*)sums, h, w, H, \
                                                     W, pl);                                \
    break;
    HEAD_LOSS_CASES(LAUNCH)
#undef LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int head_loss_bwd(const void* x, const void* g, const void* cot, const void* ytab_idx,
                             const void* ytab_wt, const void* xtab_idx, const void* xtab_wt,
                             const void* xrng, const void* rband, const void* cband, void* dx,
                             int B, int h, int w, int H, int W, int C, int rs, int tw, int nj,
                             int nl, int nb, int jw, int tma, void* stream) {
  const Taps ty{(const int*)ytab_idx, (const float*)ytab_wt, H};
  const Taps tx{(const int*)xtab_idx, (const float*)xtab_wt, W};
  const Plan pl{rs, 1, tw, nj, nl, nb, jw, tma};
  if (!plan_ok(pl, C, true, W, w, x, g) || nb < 1 || jw < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = layout(pl, C, true).total;
  const dim3 grid((unsigned)((w + jw - 1) / jw), (unsigned)((h + nb - 1) / nb), (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
#define LAUNCH(CC)                                                                              \
  case CC:                                                                                      \
    if (smem > 48 * 1024) {                                                                     \
      const cudaError_t e = cudaFuncSetAttribute(                                               \
          head_bwd_kernel<CC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);         \
      if (e != cudaSuccess) return (int)e;                                                      \
    }                                                                                           \
    head_bwd_kernel<CC><<<grid, kThreads, smem, s>>>(                                           \
        (const float*)x, (const __nv_bfloat16*)g, (const float*)cot, ty, tx, (const int*)xrng,  \
        (const int*)rband, (const int*)cband, (float*)dx, h, w, H, W, pl);                      \
    break;
    HEAD_LOSS_CASES(LAUNCH)
#undef LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
