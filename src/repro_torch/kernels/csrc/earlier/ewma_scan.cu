// The first design of csrc/ewma_scan.cu, kept unchanged so that
// kernels/ablate_ewma.py can time it against the current source on one card:
// a CTA a window reading it from L2 in every radix pass, a 256-thread CTA of
// step threads. Not built by _build and not used by the port.
// The winsorized EWMA baseline update of C4D, scanned over W windows, for
// sm_90a (H100).
//
// Replaces the XLA jit kernel of the JAX package
// src/repro/core/jaxsim/kernels.py::ewma_scan_kernel: values (W, E), one
// column a tracked cell, NaN where a cell was not seen; a carry of mean, dev
// (float64) and count (int64) a cell. Each window, a cell's first finite
// observation seeds its mean with the value and its dev with the window's
// mean absolute deviation about the median of its finite values; later
// ones are clipped at clip_sigma * (MEANAD_TO_SIGMA * dev + 1e-12 *
// max(|mean|, 1e-12) + 1e-30), and dev and mean move by alpha
// (AdaptiveBaseline.update). The JAX package pins this kernel by a
// tolerance (1e-9), not by bits, so mul-add contraction is allowed here and
// the deviation is summed as a tree.
//
// Two launches on the stream:
//  - ewma_pool_kernel, a CTA a window: the window's median over its finite
//    values as 0.5 * (lo + hi) of the two middle order statistics, each
//    found by a radix select over an order-preserving 64-bit key (eight
//    passes of 8 bits: a shared histogram, then one warp finds the digit);
//    then the mean absolute deviation about it. A window needs all E cells
//    before any cell steps, and a select over E values is a CTA's work; a
//    window's values stay in L2 across the passes;
//  - ewma_step_kernel, a thread a cell: the W steps in registers, reading
//    window after window, coalesced across cells.
// What bounds it on the H100: bytes would (the values read once), but the
// pool kernel reads each window's values 2 x 8 + 2 times, through L2, on W
// CTAs; that is this design's cost.
#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int POOL_THREADS = 1024;
constexpr int STEP_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr double MEANAD_TO_SIGMA = 1.2533;   // core/c4d/baseline.py

typedef unsigned long long u64;
constexpr u64 SIGN = 0x8000000000000000ULL;

// float64 -> u64 in numeric order (finite values: -0.0 just below +0.0), and back
__device__ __forceinline__ u64 order_key(double x) {
  const u64 b = (u64)__double_as_longlong(x);
  return (b & SIGN) ? ~b : (b | SIGN);
}
__device__ __forceinline__ double from_order_key(u64 u) {
  return __longlong_as_double((long long)((u & SIGN) ? (u ^ SIGN) : ~u));
}

struct Shared {
  unsigned hist[256];
  unsigned digit, rank;      // the digit found and the rank left within it
  unsigned nf;
  double red[32];
};

// the k-th smallest (from 0) of the finite values of v[0..E), by the CTA
__device__ double select_kth(const double* __restrict__ v, long long E, unsigned k, Shared& sh) {
  u64 prefix = 0, mask = 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) sh.hist[i] = 0;
    __syncthreads();
    for (long long e = threadIdx.x; e < E; e += blockDim.x) {
      const double x = v[e];
      if (!isfinite(x)) continue;
      const u64 u = order_key(x);
      if ((u & mask) == prefix) atomicAdd(&sh.hist[(u >> shift) & 255], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      unsigned loc[8], s = 0;
      for (int i = 0; i < 8; ++i) {
        loc[i] = sh.hist[lane * 8 + i];
        s += loc[i];
      }
      unsigned incl = s;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      unsigned c = incl - s;
      if (c <= k && k < incl) {
        for (int i = 0; i < 8; ++i) {
          if (k < c + loc[i]) {
            sh.digit = lane * 8 + i;
            sh.rank = k - c;
            break;
          }
          c += loc[i];
        }
      }
    }
    __syncthreads();
    prefix |= (u64)sh.digit << shift;
    mask |= (u64)0xFF << shift;
    k = sh.rank;
    __syncthreads();
  }
  return from_order_key(prefix);
}

__device__ double cta_sum(double x, Shared& sh) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sh.red[warp] = x;
  __syncthreads();
  x = 0.0;
  if (warp == 0) {
    x = lane < (int)(blockDim.x >> 5) ? sh.red[lane] : 0.0;
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  }
  return x;   // in thread 0
}

// a CTA a window: pool[w] = (median of the finite values, mean |x - median|)
__global__ void __launch_bounds__(POOL_THREADS)
    ewma_pool_kernel(const double* __restrict__ values, long long E, double* __restrict__ pool) {
  __shared__ Shared sh;
  const double* v = values + (long long)blockIdx.x * E;
  if (threadIdx.x == 0) sh.nf = 0;
  __syncthreads();
  unsigned nf = 0;
  for (long long e = threadIdx.x; e < E; e += blockDim.x) nf += isfinite(v[e]) ? 1u : 0u;
  atomicAdd(&sh.nf, nf);
  __syncthreads();
  nf = sh.nf;
  if (nf == 0) {   // no cell seeds from this window
    if (threadIdx.x == 0) {
      pool[2 * blockIdx.x] = CUDART_INF;
      pool[2 * blockIdx.x + 1] = 0.0;
    }
    return;
  }
  const double lo = select_kth(v, E, (nf - 1) / 2, sh);
  const double hi = nf % 2 ? lo : select_kth(v, E, nf / 2, sh);
  const double med = 0.5 * (lo + hi);
  double s = 0.0;
  for (long long e = threadIdx.x; e < E; e += blockDim.x) {
    const double x = v[e];
    if (isfinite(x)) s += fabs(x - med);
  }
  s = cta_sum(s, sh);
  if (threadIdx.x == 0) {
    pool[2 * blockIdx.x] = med;
    pool[2 * blockIdx.x + 1] = s / (double)nf;
  }
}

// a thread a cell: the W steps
__global__ void __launch_bounds__(STEP_THREADS)
    ewma_step_kernel(const double* __restrict__ values, long long W, long long E,
                     const double* __restrict__ pool, const double* __restrict__ mean0,
                     const double* __restrict__ dev0, const long long* __restrict__ count0,
                     double alpha, double clip_sigma, double* __restrict__ mean_out,
                     double* __restrict__ dev_out, long long* __restrict__ count_out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  double mean = mean0[e], dev = dev0[e];
  long long count = count0[e];
  for (long long w = 0; w < W; ++w) {
    const double x = values[w * E + e];
    if (!isfinite(x)) continue;
    if (count == 0) {
      mean = x;
      dev = pool[2 * w + 1];
    } else {
      const double lim = clip_sigma * (MEANAD_TO_SIGMA * dev +
                                       1e-12 * fmax(fabs(mean), 1e-12) + 1e-30);
      const double delta = fmin(fmax(x - mean, -lim), lim);
      dev = (1.0 - alpha) * dev + alpha * fabs(delta);
      mean = mean + alpha * delta;
    }
    ++count;
  }
  mean_out[e] = mean;
  dev_out[e] = dev;
  count_out[e] = count;
}

}  // namespace

// values (W, E) float64; mean0, dev0 (E) float64, count0 (E) int64.
// Outputs mean, dev (E) float64 and count (E) int64; pool: 2 W float64 of
// scratch (each window's median and seed deviation). E < 2^32. Returns the
// CUDA error of the launches.
extern "C" int ewma_scan(const void* values, long long W, long long E, const void* mean0,
                         const void* dev0, const void* count0, double alpha, double clip_sigma,
                         void* mean, void* dev, void* count, void* pool, void* stream) {
  if (W < 0 || E < 0 || E >= (1LL << 32)) return (int)cudaErrorInvalidValue;
  if (E == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* v = static_cast<const double*>(values);
  double* p = static_cast<double*>(pool);
  if (W > 0) {
    ewma_pool_kernel<<<(unsigned)W, POOL_THREADS, 0, st>>>(v, E, p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ewma_step_kernel<<<(unsigned)((E + STEP_THREADS - 1) / STEP_THREADS), STEP_THREADS, 0, st>>>(
      v, W, E, p, static_cast<const double*>(mean0), static_cast<const double*>(dev0),
      static_cast<const long long*>(count0), alpha, clip_sigma, static_cast<double*>(mean),
      static_cast<double*>(dev), static_cast<long long*>(count));
  return (int)cudaGetLastError();
}
