// The first design of csrc/slow_fold.cu, kept unchanged so that
// kernels/ablate_slow_fold.py can time it against the current source on one
// card: four launches, int64 atomics for every group. Not built by _build
// and not used by the port.
// The slow-path z fold of C4D for sm_90a (H100): per-group z-scores, the
// delay matrix's row and column folds, point links and the ring-wait fold,
// over one or a batch of windows.
//
// Replaces the XLA jit kernel of the JAX package
// src/repro/core/jaxsim/kernels.py::slow_fold_kernel (and its vmapped
// batch). Same function, bit for bit: zd = (dmed - center_d) / scale_d and
// zw likewise (the centers and scales come from NumPy on the host, where
// the only a*b + c of the path is computed); per rank, hot and valid counts
// of its row and column (int64 atomics: exact in any order) and the row and
// column max of zd (atomicMax on an order-preserving int64 key of the
// float64, started at the key of -inf, the max's identity, so a rank with
// no cells reads -inf as the reference does); row_sel/col_sel
// (obs >= min_observations, hot >= max(1, row_col_fraction * obs),
// hot >= 2); point = hot & ~row_sel[src] & ~col_sel[dst]; and the ring-wait
// mask (zw hot over a healthy transfer), its max and whether any per source.
// No float sum anywhere, and a max does not depend on order, so every
// output is deterministic. Built with --fmad=false; division is IEEE.
//
// What bounds it on the H100: bytes (the key and 6 float64 arrays in and 3
// arrays out a group, 10 arrays out a rank), then the atomics' latency. Four launches: init of the
// rank arrays, a thread a group, a thread a rank, a thread a group.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr long long FLIP = 0x7fffffffffffffffLL;
constexpr long long NEG_INF_BITS = (long long)0xfff0000000000000ULL;

// float64 -> int64 with the same order (negative floats: all bits but the
// sign flipped), and back; an involution
__device__ __forceinline__ long long order_key(double x) {
  const long long b = __double_as_longlong(x);
  return b >= 0 ? b : (b ^ FLIP);
}
__device__ __forceinline__ double from_key(long long k) {
  return __longlong_as_double(k >= 0 ? k : (k ^ FLIP));
}

#define GRID_LOOP(i, total)                                                       \
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < (total); \
       i += (long long)gridDim.x * blockDim.x)

__global__ void fold_init(long long total, long long* row_key, long long* col_key,
                          long long* wait_key, unsigned long long* row_hot,
                          unsigned long long* row_obs, unsigned long long* col_hot,
                          unsigned long long* col_obs, unsigned char* wait_sel) {
  const long long neg = order_key(__longlong_as_double(NEG_INF_BITS));
  GRID_LOOP(i, total) {
    row_key[i] = neg;
    col_key[i] = neg;
    wait_key[i] = neg;
    row_hot[i] = 0ULL;
    row_obs[i] = 0ULL;
    col_hot[i] = 0ULL;
    col_obs[i] = 0ULL;
    wait_sel[i] = 0;
  }
}

__global__ void fold_groups(const long long* __restrict__ gkey, long long group_bs,
                            const double* __restrict__ dmed, const double* __restrict__ wmed,
                            const double* __restrict__ cd, const double* __restrict__ sd,
                            const double* __restrict__ cw, const double* __restrict__ sw,
                            long long B, long long G, double thr, long long n,
                            double* __restrict__ zd, double* __restrict__ zw,
                            long long* row_key, long long* col_key, long long* wait_key,
                            unsigned long long* row_hot, unsigned long long* row_obs,
                            unsigned long long* col_hot, unsigned long long* col_obs,
                            unsigned char* wait_sel) {
  GRID_LOOP(i, B * G) {
    const double z_d = (dmed[i] - cd[i]) / sd[i];
    const double z_w = (wmed[i] - cw[i]) / sw[i];
    zd[i] = z_d;
    zw[i] = z_w;
    const long long b = i / G;
    const long long at = b * group_bs + (i - b * G);
    const long long key = gkey[at];
    const long long rs = b * n + key / n;
    const long long cs = b * n + key % n;
    const bool hot = z_d > thr;
    atomicAdd(&row_obs[rs], 1ULL);
    atomicAdd(&col_obs[cs], 1ULL);
    if (hot) {
      atomicAdd(&row_hot[rs], 1ULL);
      atomicAdd(&col_hot[cs], 1ULL);
    }
    const long long kd = order_key(z_d);
    atomicMax(&row_key[rs], kd);
    atomicMax(&col_key[cs], kd);
    if (z_w > thr && !hot) {  // ring wait: hot receiver wait, healthy transfer
      wait_sel[rs] = 1;
      atomicMax(&wait_key[rs], order_key(z_w));
    }
  }
}

// The keys are decoded in place: row_key, col_key and wait_key are the
// memory of the float64 score outputs.
__global__ void fold_ranks(long long total, long long min_obs, double rcf,
                           const unsigned long long* __restrict__ row_hot,
                           const unsigned long long* __restrict__ row_obs,
                           const unsigned long long* __restrict__ col_hot,
                           const unsigned long long* __restrict__ col_obs, long long* row_key,
                           long long* col_key, long long* wait_key,
                           unsigned char* __restrict__ row_sel,
                           unsigned char* __restrict__ col_sel) {
  GRID_LOOP(i, total) {
    const long long ro = (long long)row_obs[i], rh = (long long)row_hot[i];
    const long long co = (long long)col_obs[i], ch = (long long)col_hot[i];
    row_sel[i] = (ro >= min_obs && (double)rh >= fmax(1.0, rcf * (double)ro) && rh >= 2) ? 1 : 0;
    col_sel[i] = (co >= min_obs && (double)ch >= fmax(1.0, rcf * (double)co) && ch >= 2) ? 1 : 0;
    reinterpret_cast<double*>(row_key)[i] = from_key(row_key[i]);
    reinterpret_cast<double*>(col_key)[i] = from_key(col_key[i]);
    reinterpret_cast<double*>(wait_key)[i] = from_key(wait_key[i]);
  }
}

__global__ void fold_points(const long long* __restrict__ gkey, long long group_bs,
                            const double* __restrict__ zd, long long B, long long G, double thr,
                            long long n, const unsigned char* __restrict__ row_sel,
                            const unsigned char* __restrict__ col_sel,
                            unsigned char* __restrict__ point) {
  GRID_LOOP(i, B * G) {
    const long long b = i / G;
    const long long at = b * group_bs + (i - b * G);
    unsigned char p = 0;
    if (zd[i] > thr) {
      const long long key = gkey[at];
      p = (!row_sel[b * n + key / n] && !col_sel[b * n + key % n]) ? 1 : 0;
    }
    point[i] = p;
  }
}

int grid_for(long long total) {
  long long g = (total + THREADS - 1) / THREADS;
  if (g < 1) g = 1;
  if (g > 132LL * 64) g = 132LL * 64;
  return (int)g;
}

}  // namespace

// gkey (int64): (B or 1, G) at batch stride group_bs, each src * n + dst
// with src and dst in [0, n); dmed, wmed, cd, sd, cw, sw: (B, G) float64.
// Outputs: zd, zw (B, G) float64, point (B, G) bool; per rank (B, n): row_sel, col_sel,
// wait_sel bool, row_score, col_score, wait_score float64, row_hot, row_obs,
// col_hot, col_obs int64. Returns the CUDA error of the launches.
extern "C" int slow_fold(const void* gkey, long long group_bs,
                         const void* dmed, const void* wmed, const void* cd, const void* sd,
                         const void* cw, const void* sw, long long B, long long G,
                         double mad_threshold, double row_col_fraction,
                         long long min_observations, long long n, void* zd,
                         void* zw, void* point, void* row_sel, void* row_score, void* row_hot,
                         void* row_obs, void* col_sel, void* col_score, void* col_hot,
                         void* col_obs, void* wait_sel, void* wait_score, void* stream) {
  if (B <= 0 || G < 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* row_key = static_cast<long long*>(row_score);
  auto* col_key = static_cast<long long*>(col_score);
  auto* wait_key = static_cast<long long*>(wait_score);
  auto* rh = static_cast<unsigned long long*>(row_hot);
  auto* ro = static_cast<unsigned long long*>(row_obs);
  auto* ch = static_cast<unsigned long long*>(col_hot);
  auto* co = static_cast<unsigned long long*>(col_obs);
  auto* ws = static_cast<unsigned char*>(wait_sel);
  const long long ranks = B * n;
  fold_init<<<grid_for(ranks), THREADS, 0, st>>>(ranks, row_key, col_key, wait_key, rh, ro, ch,
                                                 co, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto* gk = static_cast<const long long*>(gkey);
  if (G > 0) {
    fold_groups<<<grid_for(B * G), THREADS, 0, st>>>(
        gk, group_bs, static_cast<const double*>(dmed), static_cast<const double*>(wmed),
        static_cast<const double*>(cd), static_cast<const double*>(sd),
        static_cast<const double*>(cw), static_cast<const double*>(sw), B, G, mad_threshold, n,
        static_cast<double*>(zd), static_cast<double*>(zw), row_key, col_key, wait_key, rh,
        ro, ch, co, ws);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  auto* rsel = static_cast<unsigned char*>(row_sel);
  auto* csel = static_cast<unsigned char*>(col_sel);
  fold_ranks<<<grid_for(ranks), THREADS, 0, st>>>(ranks, min_observations, row_col_fraction, rh,
                                                  ro, ch, co, row_key, col_key, wait_key, rsel,
                                                  csel);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (G > 0) {
    fold_points<<<grid_for(B * G), THREADS, 0, st>>>(gk, group_bs,
                                                     static_cast<const double*>(zd), B, G,
                                                     mad_threshold, n, rsel, csel,
                                                     static_cast<unsigned char*>(point));
    err = cudaGetLastError();
  }
  return (int)err;
}
