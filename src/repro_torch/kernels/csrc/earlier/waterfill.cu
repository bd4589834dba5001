// The first design of csrc/waterfill.cu, kept unchanged so that
// kernels/ablate_waterfill.py can time it against the current source on one
// card: every link's pairs rescanned twice a round through L2, one CTA or a
// cooperative grid. Not built by _build and not used by the port.
// Weighted max-min water-filling (C4P's flow model) for sm_90a (H100): the
// whole progressive-filling loop of FlowSet.max_min in one launch.
//
// Replaces the XLA jit kernel of the JAX package
// src/repro/core/jaxsim/kernels.py::waterfill_kernel (with
// core/jaxsim/waterfill.py::waterfill_rates). The JAX kernel is held to
// NumPy by a tolerance; this one gives the NumPy loop's bits
// (src/repro_torch/core/flowset.py, FlowSet.max_min), for three reasons:
//  - np.bincount adds each bin's weights in input order, so a link's
//    unfrozen weight and its returned capacity are summed here serially, by
//    the one thread that owns the link, over the link's pairs in pair order
//    (the CSR layout: a stable sort of the pairs by link, made once per
//    incidence on the host). A frozen pair adds 0.0 in NumPy, which leaves
//    a sum of positive weights as it is, so it is skipped;
//  - every other step is one IEEE operation or an exact min or compare:
//    share = remaining / load where load > 0, else inf; m = min(share);
//    stop if m is not finite; every unfrozen flow with a pair on a link of
//    share == m freezes (ties together) at rate = m * w;
//    remaining = max(remaining - dec, 0). Built with --fmad=false;
//    double division is IEEE;
//  - the steps run in NumPy's order, round after round.
//
// State: stamp[f] is -1 for an unfrozen flow, -2 for a dead one (a link of
// its path is down; it never freezes and keeps rate 0), else the round it
// froze in, so a round's dec sums the pairs of the flows stamped with the
// previous round, and that sum is folded into the next round's pass over
// the links: a round is two passes (links: dec, remaining, load, share and
// the least share; then links at the least share: freeze) and two barriers.
// A link's remaining and share are touched only by the thread that owns the
// link, so they need no barrier; stamps and rates cross threads and are read
// and written through L2 (__ldcg/__stcg), never from a stale L1 line.
//
// What bounds it on the H100: not bytes (the incidence of the 10,240-GPU
// fabric is ~1.3 MB and stays in L2), but the rounds: each costs two
// barriers and a chain of dependent loads (a link's pair -> its flow's
// stamp -> weight). Two variants, picked by the caller:
//  - one CTA of 1,024 threads loops over the rounds with __syncthreads
//    (no grid barrier, but one SM's loads);
//  - a cooperative grid sized to the links (every CTA resident) with
//    grid.sync(), the least share combined through one slot per CTA.
// Both give the same bits: the owner of a link and the order of its pairs
// do not change with the variant. waterfill_sync_probe times the barriers
// alone, the floor of a round.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CTA_THREADS = 1024;   // the one-CTA variant
constexpr int GRID_THREADS = 256;   // a CTA of the grid variant
constexpr int MAX_BLOCKS = 1024;    // the grid's CTAs at most (kernels/waterfill.py: MAX_BLOCKS)
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

struct Args {
  const long long* link_ptr;    // (L + 1) CSR offsets into link_flow
  const long long* link_flow;   // (P) the flow of each pair, a link's pairs in pair order
  const double* w;              // (F) weights, floored at 1e-9
  const bool* alive;            // (F)
  const double* cap;            // (L) capacity after jitter
  double* rate;                 // (F) out
  double* remaining;            // (L) out
  long long* rounds;            // (1) out: rounds that froze a flow
  double* share;                // (L) scratch
  double* block_min;            // (MAX_BLOCKS) scratch, the grid variant's
  int* stamp;                   // (F) scratch
  long long F, L;
};

// the least of v over the CTA, in every thread; red holds 33 doubles
__device__ __forceinline__ double cta_min(double v, double* red) {
  for (int o = 16; o; o >>= 1) {
    const double u = __shfl_xor_sync(FULL, v, o);
    v = u < v ? u : v;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : CUDART_INF;
    for (int o = 16; o; o >>= 1) {
      const double u = __shfl_xor_sync(FULL, v, o);
      v = u < v ? u : v;
    }
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

template <bool GRID>
__device__ __forceinline__ void barrier() {
  if (GRID) cg::this_grid().sync();
  else __syncthreads();
}

template <bool GRID>
__device__ void fill(const Args& a) {
  __shared__ double red[33];
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long f = tid; f < a.F; f += nthreads) {
    __stcg(&a.stamp[f], a.alive[f] ? -1 : -2);
    __stcg(&a.rate[f], 0.0);
  }
  barrier<GRID>();
  int r = 0;
  for (;; ++r) {
    // dec of the flows frozen last round, remaining, load, share
    double least = CUDART_INF;
    for (long long l = tid; l < a.L; l += nthreads) {
      const long long p0 = __ldg(&a.link_ptr[l]), p1 = __ldg(&a.link_ptr[l + 1]);
      double rem = r == 0 ? __ldg(&a.cap[l]) : a.remaining[l];
      if (r > 0) {
        double dec = 0.0;
        for (long long p = p0; p < p1; ++p) {
          const long long f = __ldg(&a.link_flow[p]);
          if (__ldcg(&a.stamp[f]) == r - 1) dec += __ldcg(&a.rate[f]);
        }
        rem = rem - dec;
        rem = rem > 0.0 ? rem : 0.0;
      }
      a.remaining[l] = rem;
      double load = 0.0;
      for (long long p = p0; p < p1; ++p) {
        const long long f = __ldg(&a.link_flow[p]);
        if (__ldcg(&a.stamp[f]) == -1) load += __ldg(&a.w[f]);
      }
      const double s = load > 0.0 ? rem / load : CUDART_INF;
      a.share[l] = s;
      least = s < least ? s : least;
    }
    double m = cta_min(least, red);
    if (GRID) {
      if (threadIdx.x == 0) __stcg(&a.block_min[blockIdx.x], m);
      cg::this_grid().sync();
      double v = CUDART_INF;
      for (unsigned i = threadIdx.x; i < gridDim.x; i += blockDim.x) {
        const double u = __ldcg(&a.block_min[i]);
        v = u < v ? u : v;
      }
      m = cta_min(v, red);
    }
    if (!isfinite(m) || r > a.F) break;
    // freeze every unfrozen flow on a link at the least share; a flow on two
    // such links is written twice with the same values
    for (long long l = tid; l < a.L; l += nthreads) {
      if (a.share[l] != m) continue;
      const long long p0 = __ldg(&a.link_ptr[l]), p1 = __ldg(&a.link_ptr[l + 1]);
      for (long long p = p0; p < p1; ++p) {
        const long long f = __ldg(&a.link_flow[p]);
        const int s = __ldcg(&a.stamp[f]);
        if (s == -1 || s == r) {
          __stcg(&a.stamp[f], r);
          __stcg(&a.rate[f], m * __ldg(&a.w[f]));
        }
      }
    }
    barrier<GRID>();
  }
  if (tid == 0) *a.rounds = r;
}

__global__ void __launch_bounds__(CTA_THREADS) waterfill_cta_kernel(Args a) { fill<false>(a); }

__global__ void __launch_bounds__(GRID_THREADS) waterfill_grid_kernel(Args a) { fill<true>(a); }

// the barriers of `rounds` rounds and nothing else: two a round, and the
// grid variant's CTA-wide min between them
template <bool GRID>
__global__ void __launch_bounds__(GRID ? GRID_THREADS : CTA_THREADS)
    sync_probe_kernel(long long rounds, double* sink) {
  __shared__ double red[33];
  double m = 0.0;
  for (long long r = 0; r < rounds; ++r) {
    m = cta_min(m + 1.0, red);
    if (GRID) {
      cg::this_grid().sync();
      m = cta_min(m, red);
    }
    barrier<GRID>();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *sink = m;
}

struct DeviceInfo {
  int sms = 0, resident = 0, cooperative = 0;
};

cudaError_t device_info(DeviceInfo** out) {
  static DeviceInfo info[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  DeviceInfo& d = info[dev];
  if (d.sms == 0) {
    int sms = 0, coop = 0, resident = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, waterfill_grid_kernel,
                                                             GRID_THREADS, 0)))
      return err;
    d.resident = resident;
    d.cooperative = coop;
    d.sms = sms;
  }
  *out = &d;
  return cudaSuccess;
}

// the grid variant's CTAs for L links: a thread a link, as far as the card
// holds every CTA at once
cudaError_t grid_blocks(long long L, long long* blocks) {
  DeviceInfo* info = nullptr;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  if (!info->cooperative) return cudaErrorCooperativeLaunchTooLarge;
  long long g = (L + GRID_THREADS - 1) / GRID_THREADS;
  const long long cap = (long long)info->resident * info->sms;
  if (g > cap) g = cap;
  if (g > MAX_BLOCKS) g = MAX_BLOCKS;
  *blocks = g < 1 ? 1 : g;
  return cudaSuccess;
}

}  // namespace

// link_ptr (L + 1) and link_flow (P) int64: the incidence by link, each
// link's pairs in pair order; w (F) float64, alive (F) bool, cap (L)
// float64. Outputs rate (F) and remaining (L) float64, rounds (1) int64;
// scratch: L + MAX_BLOCKS + ceil(F / 2) float64 words. grid: 0 for one CTA,
// 1 for the cooperative grid. F, L < 2^31. Returns the CUDA error of the
// launch; a cooperative launch the card refuses is returned as it is, never
// replaced by the other variant.
extern "C" int waterfill(const void* link_ptr, const void* link_flow, const void* w,
                         const void* alive, const void* cap, long long F, long long L,
                         void* rate, void* remaining, void* rounds, void* scratch, int grid,
                         void* stream) {
  if (F < 0 || L < 0 || F >= (1LL << 31) || L >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Args a;
  a.link_ptr = static_cast<const long long*>(link_ptr);
  a.link_flow = static_cast<const long long*>(link_flow);
  a.w = static_cast<const double*>(w);
  a.alive = static_cast<const bool*>(alive);
  a.cap = static_cast<const double*>(cap);
  a.rate = static_cast<double*>(rate);
  a.remaining = static_cast<double*>(remaining);
  a.rounds = static_cast<long long*>(rounds);
  a.share = static_cast<double*>(scratch);
  a.block_min = a.share + L;
  a.stamp = reinterpret_cast<int*>(a.block_min + MAX_BLOCKS);
  a.F = F;
  a.L = L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!grid) {
    waterfill_cta_kernel<<<1, CTA_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  long long blocks = 0;
  cudaError_t err = grid_blocks(L, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)waterfill_grid_kernel, dim3((unsigned)blocks),
                                    dim3(GRID_THREADS), params, 0, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

// The barriers of `rounds` rounds of the given variant for L links, with no
// work between them (sink: one float64). Returns the CUDA error of the
// launch.
extern "C" int waterfill_sync_probe(long long L, long long rounds, int grid, void* sink,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* out = static_cast<double*>(sink);
  if (!grid) {
    sync_probe_kernel<false><<<1, CTA_THREADS, 0, st>>>(rounds, out);
    return (int)cudaGetLastError();
  }
  long long blocks = 0;
  cudaError_t err = grid_blocks(L, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&rounds, &out};
  err = cudaLaunchCooperativeKernel((const void*)sync_probe_kernel<true>, dim3((unsigned)blocks),
                                    dim3(GRID_THREADS), params, 0, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
