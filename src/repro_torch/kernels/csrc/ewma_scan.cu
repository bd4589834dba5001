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
//  - the pool: each window's median over its finite values as
//    0.5 * (lo + hi) of the two middle order statistics, each found by a
//    radix select over an order-preserving 64-bit key (eight passes of 8
//    bits), then the mean absolute deviation about it. A window needs all E
//    cells before any cell steps;
//  - ewma_step_kernel, a thread a cell: the W steps in registers, reading
//    window after window, coalesced across cells.
// What bounds it on the H100: bytes (the values read once, 8.4 MB at 64 x
// 16,384: 2.5 us). The first design's pool kernel (csrc/earlier/ewma_scan.cu, kept
// here as ewma_pool_l2_kernel) read each window from L2 18 times (a count,
// 2 x 8 radix passes, the deviation sum), one CTA a window: 64 CTAs on 132
// SMs, 0.065 of its 0.084 ms. This design:
//  - ewma_pool_kernel: a cluster of CLUSTER CTAs a window (128 CTAs at 64
//    windows, so that most SMs work), each holding its part of the window
//    in shared memory, read from device memory once (128 KB of a
//    16,384-cell window, 64 KB a CTA; one bulk asynchronous copy in its
//    place measured the same, kernels/ablate_ewma.py). The count, the radix passes and
//    the deviation sum run over shared memory; a pass selects both middle
//    statistics at once (one histogram while their prefixes agree, two
//    when they part), each CTA's histogram read by the others through
//    distributed shared memory after one cluster barrier (two buffers, so
//    a pass needs one cluster barrier and one CTA barrier). Once each
//    statistic's bin holds a single candidate, one more look over the
//    parts finds both and the passes end (4 passes and the look, for the
//    bench input, instead of 8 passes). A lane adds its candidate to the
//    histogram with its own shared atomic (one atomic per distinct digit
//    of a warp, by __match_any_sync, took 2.7x longer:
//    kernels/ablate_ewma.py);
//  - windows whose part does not fit in shared memory take the L2 path,
//    ewma_pool_l2_kernel (the first design's: a CTA a window, reading it from L2 in
//    every pass); the launcher picks the path by E, never by failure;
//  - ewma_step_kernel: 64-thread CTAs (256 at 16,384 cells, every SM), each
//    thread keeping the next STEP_AHEAD windows' loads in flight while it
//    steps through the current ones (the loads do not depend on the carry).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int POOL_THREADS = 1024;
constexpr int CLUSTER = 2;           // CTAs a window on the shared-memory path
constexpr int STEP_THREADS = 64;
constexpr int STEP_AHEAD = 8;        // windows whose loads a step thread keeps in flight
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

// the digit of the k-th smallest (from 0) in a 256-bin histogram, by one
// warp (lane j holds bins 8j..8j+7): pick = (digit, rank of the k-th within
// the digit's bin, the bin's count)
__device__ __forceinline__ void find_digit(const unsigned* loc8, unsigned k, unsigned* pick) {
  const int lane = threadIdx.x & 31;
  unsigned loc[8], s = 0;
  for (int i = 0; i < 8; ++i) {
    loc[i] = loc8[i];
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
        pick[0] = lane * 8 + i;
        pick[1] = k - c;
        pick[2] = loc[i];
        break;
      }
      c += loc[i];
    }
  }
}

struct Shared {
  unsigned hist[256];
  unsigned pick[3];          // the digit found, the rank left within it, its count
  unsigned nf;
  double red[32];
};

// the k-th smallest (from 0) of the finite values of v[0..E), by the CTA,
// reading v (device memory, through L2) once a pass
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
      unsigned loc[8];
      for (int i = 0; i < 8; ++i) loc[i] = sh.hist[lane * 8 + i];
      find_digit(loc, k, sh.pick);
    }
    __syncthreads();
    prefix |= (u64)sh.pick[0] << shift;
    mask |= (u64)0xFF << shift;
    k = sh.pick[1];
    __syncthreads();
  }
  return from_order_key(prefix);
}

// the sum of x over the CTA, in thread 0
__device__ double cta_sum(double x, double* red) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = 0.0;
  if (warp == 0) {
    x = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0;
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  }
  return x;
}

// the L2 path, a CTA a window: pool[w] = (median of the finite values,
// mean |x - median|)
__global__ void __launch_bounds__(POOL_THREADS)
    ewma_pool_l2_kernel(const double* __restrict__ values, long long E, double* __restrict__ pool) {
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
  s = cta_sum(s, sh.red);
  if (threadIdx.x == 0) {
    pool[2 * blockIdx.x] = med;
    pool[2 * blockIdx.x + 1] = s / (double)nf;
  }
}

// the shared-memory path's static shared memory, a CTA
struct ClusterShared {
  unsigned hist[2][2][256];  // [buffer: pass parity][statistic: lower, upper middle][digit]
  unsigned pick[2][3];       // [statistic]: the digit found, the rank left within it, its count
  u64 key[2];                // [statistic]: its key, where this CTA holds it (else 0)
  unsigned count;            // this CTA's finite values
  double sum;                // this CTA's deviation sum
  double red[32];
};

// the part of a window of E cells that CTA q of the cluster holds
__host__ __device__ __forceinline__ void part_of(long long E, int q, long long* e0,
                                                 long long* n) {
  const long long per = E / CLUSTER;
  *e0 = q * per;
  *n = q + 1 == CLUSTER ? E - *e0 : per;
}

// the shared-memory path, a cluster of CLUSTER CTAs a window: pool[w] as
// ewma_pool_l2_kernel gives it
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(POOL_THREADS)
    ewma_pool_kernel(const double* __restrict__ values, long long E, double* __restrict__ pool) {
  extern __shared__ double v[];   // this CTA's part of the window
  __shared__ ClusterShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const long long w = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  long long e0, n;
  part_of(E, q, &e0, &n);
  const double* src = values + w * E + e0;

  for (int i = tid; i < 2 * 2 * 256; i += blockDim.x) (&sh.hist[0][0][0])[i] = 0;
  if (tid == 0) {
    sh.count = 0;
    sh.key[0] = sh.key[1] = 0;
  }
  for (long long i = tid; i < n; i += blockDim.x) v[i] = src[i];
  __syncthreads();

  unsigned nf = 0;
  for (long long i = tid; i < n; i += blockDim.x) nf += isfinite(v[i]) ? 1u : 0u;
  nf = __reduce_add_sync(FULL, nf);
  if (lane == 0) atomicAdd(&sh.count, nf);
  cluster.sync();   // every CTA of the cluster runs, has counted and zeroed its histograms
  unsigned total = 0;
  for (int r = 0; r < CLUSTER; ++r) total += *cluster.map_shared_rank(&sh.count, r);

  if (total > 0) {
    u64 prefix[2] = {0, 0}, mask = 0;
    unsigned k[2] = {(total - 1) / 2, total / 2};
    bool whole = false;   // both keys known in full
    for (int pass = 0, shift = 56; shift >= 0 && !whole; ++pass, shift -= 8) {
      const int b = pass & 1;
      const bool same = prefix[0] == prefix[1];   // then one histogram serves both
      for (long long i = tid; i < n; i += blockDim.x) {
        const double x = v[i];
        if (!isfinite(x)) continue;
        const u64 u = order_key(x);
        const unsigned d = (unsigned)(u >> shift) & 255u;
        for (int s = 0; s < (same ? 1 : 2); ++s)
          if ((u & mask) == prefix[s]) atomicAdd(&sh.hist[b][s][d], 1u);
      }
      cluster.sync();   // every CTA's histograms of this pass are whole
      if (warp < 2) {   // warp s finds the digit of statistic s over the cluster's counts
        const int h = same ? 0 : warp;
        unsigned loc[8];
        for (int i = 0; i < 8; ++i) {
          unsigned c = 0;
          for (int r = 0; r < CLUSTER; ++r)
            c += cluster.map_shared_rank(&sh.hist[b][h][0], r)[lane * 8 + i];
          loc[i] = c;
        }
        find_digit(loc, warp ? k[1] : k[0], sh.pick[warp]);
      }
      // every CTA read the other buffer before this pass's cluster barrier
      for (int i = tid; i < 2 * 256; i += blockDim.x) (&sh.hist[b ^ 1][0][0])[i] = 0;
      __syncthreads();
      for (int s = 0; s < 2; ++s) {
        prefix[s] |= (u64)sh.pick[s][0] << shift;
        k[s] = sh.pick[s][1];
      }
      mask |= (u64)0xFF << shift;
      // both statistics' bins hold one candidate each: the candidates are
      // the statistics, found by one more look over the parts
      if (shift > 0 && sh.pick[0][2] == 1 && sh.pick[1][2] == 1) {
        for (long long i = tid; i < n; i += blockDim.x) {
          const double x = v[i];
          if (!isfinite(x)) continue;
          const u64 u = order_key(x);
          for (int s = 0; s < 2; ++s)
            if ((u & mask) == prefix[s]) sh.key[s] = u;
        }
        cluster.sync();
        for (int s = 0; s < 2; ++s) {   // a finite value's key is never 0
          u64 key = 0;
          for (int r = 0; r < CLUSTER; ++r) key |= *cluster.map_shared_rank(&sh.key[s], r);
          prefix[s] = key;
        }
        whole = true;
      }
    }
    const double med = 0.5 * (from_order_key(prefix[0]) + from_order_key(prefix[1]));
    double s = 0.0;
    for (long long i = tid; i < n; i += blockDim.x) {
      const double x = v[i];
      if (isfinite(x)) s += fabs(x - med);
    }
    s = cta_sum(s, sh.red);
    if (tid == 0) sh.sum = s;
    cluster.sync();
    if (q == 0 && tid == 0) {
      double all = 0.0;
      for (int r = 0; r < CLUSTER; ++r) all += *cluster.map_shared_rank(&sh.sum, r);
      pool[2 * w] = med;
      pool[2 * w + 1] = all / (double)total;
    }
  } else if (q == 0 && tid == 0) {   // no cell seeds from this window
    pool[2 * w] = CUDART_INF;
    pool[2 * w + 1] = 0.0;
  }
  cluster.sync();   // no CTA leaves while another may read its shared memory
}

// a thread a cell: the W steps, the next STEP_AHEAD windows' loads in flight
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
  double next[STEP_AHEAD];
#pragma unroll
  for (int j = 0; j < STEP_AHEAD; ++j) next[j] = j < W ? values[j * E + e] : 0.0;
  for (long long w0 = 0; w0 < W; w0 += STEP_AHEAD) {
    double x[STEP_AHEAD];
#pragma unroll
    for (int j = 0; j < STEP_AHEAD; ++j) {
      x[j] = next[j];
      const long long w = w0 + STEP_AHEAD + j;
      next[j] = w < W ? values[w * E + e] : 0.0;
    }
#pragma unroll
    for (int j = 0; j < STEP_AHEAD; ++j) {
      const long long w = w0 + j;
      if (w >= W || !isfinite(x[j])) continue;
      if (count == 0) {
        mean = x[j];
        dev = pool[2 * w + 1];
      } else {
        const double lim = clip_sigma * (MEANAD_TO_SIGMA * dev +
                                         1e-12 * fmax(fabs(mean), 1e-12) + 1e-30);
        const double delta = fmin(fmax(x[j] - mean, -lim), lim);
        dev = (1.0 - alpha) * dev + alpha * fabs(delta);
        mean = mean + alpha * delta;
      }
      ++count;
    }
  }
  mean_out[e] = mean;
  dev_out[e] = dev;
  count_out[e] = count;
}

// the dynamic shared memory of the shared-memory path for E cells, or 0
// where a CTA's part does not fit beside the static shared memory under
// the card's opt-in limit (-error if the card cannot be asked)
long long pool_smem_bytes(long long E) {
  static int optin[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(long long)err;
  if (dev < 0 || dev >= 64) return -(long long)cudaErrorInvalidDevice;
  if (optin[dev] == 0) {
    err = cudaDeviceGetAttribute(&optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return -(long long)err;
  }
  long long e0, n;
  part_of(E, CLUSTER - 1, &e0, &n);     // the last part is the largest
  const long long bytes = 8 * n;
  return bytes + (long long)sizeof(ClusterShared) <= optin[dev] ? bytes : 0;
}

}  // namespace

// The pool path ewma_scan takes for E cells on the current device: 1 the
// shared-memory path, 2 the L2 path; a negative CUDA error if the card
// cannot be asked.
extern "C" int ewma_scan_path(long long E) {
  const long long bytes = pool_smem_bytes(E);
  if (bytes < 0) return (int)bytes;
  return bytes > 0 ? 1 : 2;
}

// values (W, E) float64; mean0, dev0 (E) float64, count0 (E) int64.
// Outputs mean, dev (E) float64 and count (E) int64; pool: 2 W float64 of
// scratch (each window's median and seed deviation). path: 0 by E
// (ewma_scan_path), 1 the shared-memory path, 2 the L2 path. E < 2^32.
// Returns the CUDA error of the launches; the shared-memory path asked for
// where a window does not fit is an error, never replaced by the L2 path.
extern "C" int ewma_scan(const void* values, long long W, long long E, const void* mean0,
                         const void* dev0, const void* count0, double alpha, double clip_sigma,
                         void* mean, void* dev, void* count, void* pool, int path,
                         void* stream) {
  if (W < 0 || E < 0 || E >= (1LL << 32) || path < 0 || path > 2)
    return (int)cudaErrorInvalidValue;
  if (E == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* v = static_cast<const double*>(values);
  double* p = static_cast<double*>(pool);
  if (W > 0) {
    const long long bytes = pool_smem_bytes(E);
    if (bytes < 0) return (int)(-bytes);
    if (path == 0) path = bytes > 0 ? 1 : 2;
    cudaError_t err;
    if (path == 1) {
      if (bytes == 0 || W * CLUSTER > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      err = cudaFuncSetAttribute(ewma_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return (int)err;
      ewma_pool_kernel<<<(unsigned)(W * CLUSTER), POOL_THREADS, (size_t)bytes, st>>>(v, E, p);
    } else {
      ewma_pool_l2_kernel<<<(unsigned)W, POOL_THREADS, 0, st>>>(v, E, p);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ewma_step_kernel<<<(unsigned)((E + STEP_THREADS - 1) / STEP_THREADS), STEP_THREADS, 0, st>>>(
      v, W, E, p, static_cast<const double*>(mean0), static_cast<const double*>(dev0),
      static_cast<const long long*>(count0), alpha, clip_sigma, static_cast<double*>(mean),
      static_cast<double*>(dev), static_cast<long long*>(count));
  return (int)cudaGetLastError();
}
