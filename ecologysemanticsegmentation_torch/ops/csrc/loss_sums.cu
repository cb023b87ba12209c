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
// The same function as the Pallas kernels: x^1.5 as x·√x, the mask applied
// as a factor (so a NaN term at a masked pixel stays NaN, as in the JAX
// package), (p > 0) − sign(p)/(1+e^|p|) and 1/(p+ε) in the backward.
//
// What bounds it on this card: bytes, once the element math is cheap
// enough.  The forward reads p and g once (201 MB at batch 128, 256 px,
// C = 3: 0.060 ms at 3.35 TB/s); the backward reads them again and writes
// dp and, where autograd needs it, dg.  The first design of this file took
// accurate logf, log1pf, expf, sqrtf and IEEE divides, a 64-bit division
// per element and one 4-byte load per element, and issued more instructions
// than the bytes allow (PERF.md).  This one:
//  - reads contiguous inputs (pixel stride C, 16-byte aligned; the wrapper
//    decides) as one flat stream of float4 loads.  A warp takes a chunk of
//    32 * V float4 of each input, lane l the float4 l, l + 32, ...;
//    V = C / gcd(C, 4), so a chunk holds whole pixels and element j of the
//    lane's v-th float4 has channel (s + r) mod C, with the slot
//    s = (128 v + j) mod C known at compile time and r = 4 l mod C fixed
//    for the lane.  The (8, C) sums (forward) and the cotangent weights
//    (backward, C <= 4) stay in registers by slot; the forward turns slots
//    back into channels once, after the stream.  Every load instruction of
//    a warp reads 512 contiguous bytes; a thread issues the loads of U
//    chunks before their math (U = 4, 2, 1 for V = 1, 2-3, more).
//  - reads any other input (a channel slice of a wider tensor, an odd
//    storage offset), and the ragged tail of a contiguous one, pixel by
//    pixel through the pixel stride, in the same kernel.
//  - takes lg2.approx for the logs (ln 2 folded into the finished focal
//    sums, or into the backward's cotangent weights), sqrt.approx for the
//    two roots (0 at 0 and NaN below it, as sqrtf), one rcp.approx for
//    both reciprocals of dp, ex2.approx and lg2.approx for the softplus,
//    and for the backward's sigmoid (needed only where p lies in [0, 1]:
//    elsewhere one of the roots makes dp NaN) a degree-6 polynomial.  6
//    MUFU operations an element forward, 5 backward; only this file and
//    head_loss.cu take approximations.
//  - runs one wave of blocks (SMs x resident blocks) over the stream.  The
//    forward's last block to finish (an integer ticket; no float atomics)
//    adds the per-block partials in a fixed order into the (8, C) sums and
//    sets the ticket back to 0: deterministic, one launch.
//
// The C interface takes raw pointers and the stream; each launching function
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-7f;
constexpr float kLn2 = 0.693147180559945309f;
constexpr float kLog2e = 1.44269504088896341f;
constexpr float kGammaLn2 = 1.5f * 0.693147180559945309f;
constexpr int kSums = 8;
constexpr int kCoefs = 9;  // the backward's per-channel weights (bwd_coef)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 16;
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int gcd4(int c) { return c % 4 == 0 ? 4 : c % 2 == 0 ? 2 : 1; }
// float4 of each input a lane takes per chunk (a chunk holds whole pixels)
template <int C>
constexpr int kVec = C / gcd4(C);
// chunks a thread loads before their math
template <int C>
constexpr int kUnroll = kVec<C> == 1 ? 4 : kVec<C> <= 3 ? 2 : 1;

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
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 / (1 + exp(-p)) on p in [0, 1]: a degree-6 Chebyshev fit, within 6e-8.
__device__ __forceinline__ float sigmoid01(float p) {
  float r = -5.16951957e-4f;
  r = fmaf(r, p, 2.65570730e-3f);
  r = fmaf(r, p, -3.38983256e-4f);
  r = fmaf(r, p, -2.07252167e-2f);
  r = fmaf(r, p, -1.69915747e-5f);
  r = fmaf(r, p, 2.50001043e-1f);
  return fmaf(r, p, 0.5f);
}

// The forward's eight rows for one element into slot s; the focal rows 4-5
// in log2 (x ln 2 once the thread's stream ends).
template <int C>
__device__ __forceinline__ void add_elem(float (&acc)[kSums][C], int s, float p, float graw) {
  const float w = graw >= 0.f ? 1.f : 0.f;
  const float gv = graw * w, wp = w * p, omp = 1.f - p;
  acc[0][s] += gv;
  acc[1][s] += wp;
  acc[2][s] = fmaf(wp, p, acc[2][s]);
  acc[3][s] = fmaf(gv, p, acc[3][s]);
  acc[4][s] = fmaf(w * omp * sqrt_approx(omp), lg2(p + kEps), acc[4][s]);
  acc[5][s] = fmaf(wp * sqrt_approx(p), lg2(omp + kEps), acc[5][s]);
  // softplus of the probability (the reference applies a with-logits BCE
  // formula to sigmoided outputs): max(p, 0) + ln 2 log2(1 + 2^(-|p| log2 e))
  const float soft = fmaf(kLn2, lg2(1.f + ex2(fabsf(p) * -kLog2e)), fmaxf(p, 0.f));
  acc[6][s] = fmaf(w, soft, acc[6][s]);
  acc[7][s] += w;
}

// The backward's weights of channel c from the (8, C) cotangent k: dg's
// k0, k3 and dp's k1, 2 k2, k3, k4, −1.5 ln2 k4, 1.5 ln2 k5, −k5, k6.
__device__ __forceinline__ float bwd_coef(const float* __restrict__ k, int row, int c, int C) {
  switch (row) {
    case 0: return k[0 * C + c];
    case 1: return k[1 * C + c];
    case 2: return 2.f * k[2 * C + c];
    case 3: return k[3 * C + c];
    case 4: return k[4 * C + c];
    case 5: return -kGammaLn2 * k[4 * C + c];
    case 6: return kGammaLn2 * k[5 * C + c];
    case 7: return -k[5 * C + c];
    default: return k[6 * C + c];
  }
}

// The backward's weights by slot: cf(row, s) = w[row * 2C + s] of a table
// whose rows hold each channel's weight twice (w + r is slot s's channel
// (s + r) mod C); in registers for C <= 4, else read from shared memory.
template <int C, bool kRegs = (C <= 4)>
struct Coefs {
  float v[kCoefs][C];
  __device__ __forceinline__ explicit Coefs(const float* w) {
#pragma unroll
    for (int k = 0; k < kCoefs; ++k)
#pragma unroll
      for (int s = 0; s < C; ++s) v[k][s] = w[k * 2 * C + s];
  }
  __device__ __forceinline__ float operator()(int k, int s) const { return v[k][s]; }
};
template <int C>
struct Coefs<C, false> {
  const float* w;
  __device__ __forceinline__ explicit Coefs(const float* w_) : w(w_) {}
  __device__ __forceinline__ float operator()(int k, int s) const { return w[k * 2 * C + s]; }
};

// dp of one element: mask x Σ_k w_k ∂s_k/∂p, with its slot's weights.
// Rows 4-5 are √(1−p)(k4 (1−p)/(p+ε) − 1.5 k4 log(p+ε)) and
// √p(1.5 k5 log(1−p+ε) − k5 p/(1−p+ε)); both reciprocals from one
// rcp.approx of (p+ε)(1−p+ε).  Row 6's (p > 0) − sign(p)/(1+e^|p|) is the
// sigmoid of p for p > 0 and 0 at p = 0; for p outside [0, 1] a root is
// NaN and so is dp, in the plain version as here.
template <class Cf>
__device__ __forceinline__ float dp_elem(float p, float graw, const Cf& cf, int s) {
  const float msk = graw >= 0.f ? 1.f : 0.f;
  const float omp = 1.f - p, pe = p + kEps, qe = omp + kEps;
  const float r = rcp(pe * qe);
  const float t4 = fmaf(cf(4, s) * omp, qe * r, cf(5, s) * lg2(pe));
  const float t5 = fmaf(cf(7, s) * p, pe * r, cf(6, s) * lg2(qe));
  float d = fmaf(cf(2, s), p, cf(1, s));
  d = fmaf(cf(3, s), graw * msk, d);
  d = fmaf(sqrt_approx(omp), t4, d);
  d = fmaf(sqrt_approx(p), t5, d);
  d = fmaf(cf(8, s), p > 0.f ? sigmoid01(p) : 0.f, d);
  return msk * d;
}

// dg of one element: (k0 + k3 p) x mask.
template <class Cf>
__device__ __forceinline__ float dg_elem(float p, float graw, const Cf& cf, int s) {
  return fmaf(cf(3, s), p, cf(0, s)) * (graw >= 0.f ? 1.f : 0.f);
}

// a[k][s] holds channel (s + r) mod C; afterwards a[k][c] holds channel c.
// r is a multiple of gcd(C, 4) (r = 4 lane mod C).
template <int C>
__device__ __forceinline__ void unrotate(float (&a)[kSums][C], int r) {
#pragma unroll
  for (int q = gcd4(C); q < C; q += gcd4(C)) {
    if (r == q) {
      float t[kSums][C];
#pragma unroll
      for (int k = 0; k < kSums; ++k)
#pragma unroll
        for (int c = 0; c < C; ++c) t[k][c] = a[k][c];
#pragma unroll
      for (int k = 0; k < kSums; ++k)
#pragma unroll
        for (int c = 0; c < C; ++c) a[k][(c + q) % C] = t[k][c];
    }
  }
}

// The block's sum of every thread's acc, in a fixed order (a shuffle tree
// in each warp, then the warps in order), into out[0 : 8 C]; each writing
// thread fences its write before the block takes its ticket.
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

// Forward: one wave of blocks; each warp walks chunks of the flat stream
// (vec), then every thread the remaining pixels through the pixel stride.
// The 8*C sums stay in registers; each block writes its partial, and the
// last block to finish adds the partials into sums.
template <int C>
__global__ void __launch_bounds__(kThreads, C <= 4 ? 2 : 1)
    loss_sums_fwd_kernel(const float* __restrict__ p, const float* __restrict__ g, int64_t sp,
                         int64_t sg, int64_t n, int vec, float* __restrict__ partials,
                         unsigned* __restrict__ done, float* __restrict__ sums) {
  constexpr int V = kVec<C>, U = kUnroll<C>;
  float acc[kSums][C];
#pragma unroll
  for (int k = 0; k < kSums; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] = 0.f;

  const int lane = threadIdx.x & 31;
  const int64_t nthreads = (int64_t)gridDim.x * kThreads;
  const int64_t gtid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t pix0 = 0;
  if (vec) {
    const int64_t nchunks = n * C / (128 * V), nwarps = nthreads / 32;
    const float4* p4 = reinterpret_cast<const float4*>(p) + lane;
    const float4* g4 = reinterpret_cast<const float4*>(g) + lane;
    for (int64_t q = gtid / 32; q < nchunks; q += U * nwarps) {
      float4 pv[U][V], gv[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t qu = q + u * nwarps;
        const bool ok = qu < nchunks;  // else p = 1/2 under an ignore label: adds 0
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int64_t at = qu * (32 * V) + 32 * v;
          pv[u][v] = ok ? __ldg(p4 + at) : make_float4(.5f, .5f, .5f, .5f);
          gv[u][v] = ok ? __ldg(g4 + at) : make_float4(-1.f, -1.f, -1.f, -1.f);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          add_elem<C>(acc, (128 * v + 0) % C, pv[u][v].x, gv[u][v].x);
          add_elem<C>(acc, (128 * v + 1) % C, pv[u][v].y, gv[u][v].y);
          add_elem<C>(acc, (128 * v + 2) % C, pv[u][v].z, gv[u][v].z);
          add_elem<C>(acc, (128 * v + 3) % C, pv[u][v].w, gv[u][v].w);
        }
    }
    unrotate<C>(acc, (4 * lane) % C);
    pix0 = nchunks * (128 * V / C);
  }
  for (int64_t i = pix0 + gtid; i < n; i += nthreads)
#pragma unroll
    for (int c = 0; c < C; ++c) add_elem<C>(acc, c, __ldg(p + i * sp + c), __ldg(g + i * sg + c));

  __shared__ float red[kWarps][kSums * C];
  __shared__ unsigned ticket;
  const unsigned nblk = gridDim.x;
#pragma unroll
  for (int k = 4; k < 6; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] *= kLn2;
  block_sum<C>(acc, red, partials + (size_t)blockIdx.x * kSums * C);
  if (threadIdx.x == 0) ticket = atomicAdd(done, 1u);
  __syncthreads();
  if (ticket != nblk - 1) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < kSums; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] = 0.f;
  for (unsigned i = threadIdx.x; i < nblk; i += kThreads)
#pragma unroll
    for (int k = 0; k < kSums; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[k][c] += __ldcg(partials + ((size_t)i * kSums + k) * C + c);
  block_sum<C>(acc, red, sums);
  if (threadIdx.x == 0) *done = 0u;
}

// Backward: dp = mask · Σ_k w_k ∂s_k/∂p and dg = (w_0 + w_3·p) · mask with
// the (8, C) cotangent w (the count row carries no gradient), each written
// contiguous (n, C) only when its pointer is not null; the same walk as the
// forward, float4 stores on the flat stream.
template <int C>
__global__ void __launch_bounds__(kThreads, C <= 4 ? 2 : 1)
    loss_sums_bwd_kernel(const float* __restrict__ p, const float* __restrict__ g, int64_t sp,
                         int64_t sg, int64_t n, int vec, const float* __restrict__ cot,
                         float* __restrict__ dp, float* __restrict__ dg) {
  constexpr int V = kVec<C>, U = kUnroll<C>;
  __shared__ float wt[kCoefs * 2 * C];
  for (int i = threadIdx.x; i < kCoefs * 2 * C; i += kThreads)
    wt[i] = bwd_coef(cot, i / (2 * C), i % (2 * C) % C, C);
  __syncthreads();

  const bool want_dp = dp != nullptr, want_dg = dg != nullptr;
  const int64_t nthreads = (int64_t)gridDim.x * kThreads;
  const int64_t gtid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t pix0 = 0;
  if (vec) {
    const int lane = threadIdx.x & 31;
    const Coefs<C> cf(wt + (4 * lane) % C);
    const int64_t nchunks = n * C / (128 * V), nwarps = nthreads / 32;
    const float4* p4 = reinterpret_cast<const float4*>(p) + lane;
    const float4* g4 = reinterpret_cast<const float4*>(g) + lane;
    float4* dp4 = reinterpret_cast<float4*>(dp) + lane;
    float4* dg4 = reinterpret_cast<float4*>(dg) + lane;
    for (int64_t q = gtid / 32; q < nchunks; q += U * nwarps) {
      float4 pv[U][V], gv[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t qu = q + u * nwarps;
        const bool ok = qu < nchunks;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int64_t at = qu * (32 * V) + 32 * v;
          pv[u][v] = ok ? __ldg(p4 + at) : make_float4(0.f, 0.f, 0.f, 0.f);
          gv[u][v] = ok ? __ldg(g4 + at) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t qu = q + u * nwarps;
        if (qu >= nchunks) break;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int64_t at = qu * (32 * V) + 32 * v;
          const float4 a = pv[u][v], b = gv[u][v];
          const int s = (128 * v) % C;
          if (want_dp)
            dp4[at] = make_float4(dp_elem(a.x, b.x, cf, s), dp_elem(a.y, b.y, cf, (s + 1) % C),
                                  dp_elem(a.z, b.z, cf, (s + 2) % C),
                                  dp_elem(a.w, b.w, cf, (s + 3) % C));
          if (want_dg)
            dg4[at] = make_float4(dg_elem(a.x, b.x, cf, s), dg_elem(a.y, b.y, cf, (s + 1) % C),
                                  dg_elem(a.z, b.z, cf, (s + 2) % C),
                                  dg_elem(a.w, b.w, cf, (s + 3) % C));
        }
      }
    }
    pix0 = nchunks * (128 * V / C);
  }
  const Coefs<C, false> cw(wt);  // by channel
  for (int64_t i = pix0 + gtid; i < n; i += nthreads)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float pv = __ldg(p + i * sp + c), graw = __ldg(g + i * sg + c);
      if (want_dp) dp[i * C + c] = dp_elem(pv, graw, cw, c);
      if (want_dg) dg[i * C + c] = dg_elem(pv, graw, cw, c);
    }
}

#define LOSS_SUMS_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

// Blocks of one wave of kernel<C> on the current device: resident blocks
// per SM x SMs, cached per device.
int wave(int C, int bwd) {
  static int cache[kMaxDevices][2][kMaxC + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  int& w = cache[dev][bwd][C];
  if (w > 0) return w;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (C) {
#define OCC(CC)                                                                               \
  case CC:                                                                                    \
    err = bwd ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, loss_sums_bwd_kernel<CC>, \
                                                              kThreads, 0)                    \
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, loss_sums_fwd_kernel<CC>, \
                                                              kThreads, 0);                   \
    break;
    LOSS_SUMS_CASES(OCC)
#undef OCC
    default:
      break;
  }
  if (err != cudaSuccess || per_sm <= 0) return 0;
  w = sms * per_sm;
  return w;
}

// Blocks a launch takes: one wave at most, and no more than the work fills
// (a warp per chunk of the flat stream, else a thread per pixel).
long long blocks_for(long long n, int C, int vec, int full) {
  const long long v = C / gcd4(C);
  const long long threads = vec ? (n * C / (128 * v)) * 32 : n;
  long long b = (threads + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return b < full ? b : full;
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15u) == 0; }

}  // namespace

// Blocks in one wave of the forward (bwd = 0) or backward (bwd = 1) kernel
// at C channels on the current device; 0 on error.  The forward's partials
// buffer holds this many (8, C) blocks.
extern "C" int loss_sums_wave(int C, int bwd) {
  if (C < 1 || C > kMaxC) return 0;
  return wave(C, bwd ? 1 : 0);
}

// p, g: element (i, c) at p[i * sp + c], g[i * sg + c], 0 <= i < n; vec: read
// them as one flat stream (sp = sg = C, both 16-byte aligned).  partials:
// room for max_blocks (8, C) blocks; done: the ticket, 0 between launches;
// sums: the (8, C) result.
extern "C" int loss_sums_fwd(const void* p, const void* g, long long sp, long long sg,
                             long long n, int C, int vec, void* partials, long long max_blocks,
                             void* done, void* sums, void* stream) {
  if (n < 1 || C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  if (vec && !(sp == C && sg == C && aligned16(p) && aligned16(g)))
    return (int)cudaErrorInvalidValue;
  const int full = wave(C, 0);
  if (full <= 0) return (int)cudaErrorInvalidConfiguration;
  long long nblk = blocks_for(n, C, vec, full);
  if (nblk > max_blocks) nblk = max_blocks;
  if (nblk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
#define LAUNCH(CC)                                                                         \
  case CC:                                                                                 \
    loss_sums_fwd_kernel<CC><<<(unsigned)nblk, kThreads, 0, s>>>(                          \
        (const float*)p, (const float*)g, sp, sg, n, vec, (float*)partials, (unsigned*)done, \
        (float*)sums);                                                                     \
    break;
    LOSS_SUMS_CASES(LAUNCH)
#undef LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dp, dg: (n, C) contiguous f32 (16-byte aligned where vec), or null when
// autograd does not need them.
extern "C" int loss_sums_bwd(const void* p, const void* g, long long sp, long long sg,
                             long long n, int C, int vec, const void* cot, void* dp, void* dg,
                             void* stream) {
  if (n < 1 || C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  if (dp == nullptr && dg == nullptr) return (int)cudaSuccess;
  if (vec && !(sp == C && sg == C && aligned16(p) && aligned16(g) && aligned16(dp) &&
               aligned16(dg)))
    return (int)cudaErrorInvalidValue;
  const int full = wave(C, 1);
  if (full <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long nblk = blocks_for(n, C, vec, full);
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
#define LAUNCH(CC)                                                                              \
  case CC:                                                                                      \
    loss_sums_bwd_kernel<CC><<<(unsigned)nblk, kThreads, 0, s>>>(                               \
        (const float*)p, (const float*)g, sp, sg, n, vec, (const float*)cot, (float*)dp,       \
        (float*)dg);                                                                            \
    break;
    LOSS_SUMS_CASES(LAUNCH)
#undef LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
