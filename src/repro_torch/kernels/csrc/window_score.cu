// Window scoring for sm_90a (H100): per-group median row select and the
// heartbeat (hang) fold of one or a batch of C4D telemetry windows.
//
// Replaces the XLA jit kernels of the JAX package
// src/repro/core/jaxsim/kernels.py::fused_window_kernel (entry ws_window)
// and ::grouped_median_kernel (entry ws_row_select, the prefilter's
// medians). Same function, bit for bit (the exact path of that module):
//  * per (src, dst) pair group, the lo = max((c-1)//2, 0) and
//    hi = c//2 order statistics of its samples, ordered by
//    their int64 bit patterns (values are non-negative, which the wrapper
//    checks), and 0.5 * (lo + hi); an empty group reads +inf;
//  * per rank, the last heartbeat seq (segment max, int64-min where absent),
//    presence, is_src from the group keys (gkey / n);
//  * the mean of the two middle present seqs (hmed; +inf with none
//    present), deficit = hmed - seq, hung = present & (deficit - offset >=
//    hang_grace).
// float64 throughout, no a*b + c (built with --fmad=false besides), IEEE
// division: nothing here can round differently from NumPy.
//
// What bounds it on the H100: bytes. At 100,000 ranks one window is 3M
// transports (48 MB of delay and wait values, 24 MB of sort order) and 1M
// heartbeats (16 MB); the work is a few compares a sample.
//
// Design. The host groups the transport keys once (a layout cached across
// windows with equal keys) and keeps its sort order and group starts on the
// card, so a window sends only its values: the kernel gathers each group's
// samples through the order, where the JAX path scattered them on the host
// into a (2, g_pad, m_pad) matrix (134 MB a window at 100k ranks). Groups of
// up to 32 samples (the telemetry's pairs have 10) take one warp: a lane a
// sample, each lane's rank counted over 32 shuffles, the lanes of rank lo and
// hi found by ballot. Larger groups (the prefilter's per-node groups, ~320)
// take one CTA each, from a host-made list, the samples in shared memory
// (MAX_GROUP of them) and ranks counted against all of them. The hang median
// is one CTA a window: a radix select of the lo-th present seq from the
// highest 8-bit digit where the least and the largest differ
// (one pass for the telemetry's seqs), and one more pass for the hi-th; the
// count, least and largest present seq, and the deficits, are folded over
// all ranks by many CTAs, so the one CTA is short when all seqs are equal.
// Every shape is the window's own (G groups, H heartbeats, n ranks): no
// padding slot is read, written or skipped.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_GROUP = 32;      // groups up to this many samples: one warp
constexpr int MAX_GROUP = 4096;     // the largest group a CTA takes (32 KB of keys)
constexpr int THREADS = 256;
constexpr int CTA_THREADS = 256;
constexpr int MEDIAN_THREADS = 1024;
constexpr long long I64_MIN = (-0x7fffffffffffffffLL - 1);
constexpr long long I64_MAX = 0x7fffffffffffffffLL;
constexpr unsigned long long SIGN = 0x8000000000000000ULL;
constexpr long long NAN_BITS = 0x7ff8000000000000LL;
constexpr long long INF_BITS = 0x7ff0000000000000LL;

__device__ __forceinline__ long long bits_of(double x) { return __double_as_longlong(x); }
__device__ __forceinline__ double from_bits(long long b) { return __longlong_as_double(b); }
// int64 -> unsigned with the same order
__device__ __forceinline__ unsigned long long ukey(long long x) {
  return static_cast<unsigned long long>(x) ^ SIGN;
}

// values (B, V, T); out (V, B, G). One warp per (window b, group g).
__global__ void row_select_warp(const double* __restrict__ values, long long B, int V, long long T,
                                const long long* __restrict__ order, long long order_bs,
                                const long long* __restrict__ starts,
                                const long long* __restrict__ counts, long long group_bs,
                                long long G, double* __restrict__ out) {
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= B * G) return;  // the whole warp leaves together
  const long long b = warp / G;
  const long long g = warp - b * G;
  const long long c = counts[b * group_bs + g];
  const long long s = starts[b * group_bs + g];
  for (int v = 0; v < V; ++v) {
    double* o = out + ((long long)v * B + b) * G + g;
    if (c > WARP_GROUP) {  // a CTA's group: NaN until row_select_cta writes it
      if (lane == 0) *o = from_bits(NAN_BITS);
      continue;
    }
    if (c <= 0) {  // empty group: +inf, as an all-+inf row reads
      if (lane == 0) *o = from_bits(INF_BITS);
      continue;
    }
    double val = 0.0;
    long long key = I64_MAX;
    if (lane < c) {
      const long long idx = order[b * order_bs + s + lane];
      val = values[((long long)b * V + v) * T + idx];
      key = bits_of(val);
    }
    int rank = 0;
    for (int i = 0; i < (int)c; ++i) {
      const long long ki = __shfl_sync(FULL, key, i);
      rank += (ki < key) || (ki == key && i < lane);
    }
    const int lo = (int)((c - 1) / 2);
    const int hi = (int)(c / 2);
    const unsigned lo_lanes = __ballot_sync(FULL, lane < c && rank == lo);
    const unsigned hi_lanes = __ballot_sync(FULL, lane < c && rank == hi);
    const double lo_v = __shfl_sync(FULL, val, __ffs(lo_lanes) - 1);
    const double hi_v = __shfl_sync(FULL, val, __ffs(hi_lanes) - 1);
    if (lane == 0) *o = 0.5 * (lo_v + hi_v);
  }
}

// One CTA per (listed group, window): groups of more than WARP_GROUP samples.
__global__ void __launch_bounds__(CTA_THREADS)
row_select_cta(const double* __restrict__ values, long long B, int V, long long T,
               const long long* __restrict__ order, long long order_bs,
               const long long* __restrict__ starts, const long long* __restrict__ counts,
               long long group_bs, long long G, const long long* __restrict__ large,
               double* __restrict__ out) {
  __shared__ long long keys[MAX_GROUP];
  __shared__ long long picked[2];
  const long long b = blockIdx.y;
  const long long g = large[blockIdx.x];
  const long long c = counts[b * group_bs + g];
  if (c <= WARP_GROUP) return;  // the warp kernel's (uniform over the CTA)
  const long long s = starts[b * group_bs + g];
  const int lo = (int)((c - 1) / 2);
  const int hi = (int)(c / 2);
  for (int v = 0; v < V; ++v) {
    double* o = out + ((long long)v * B + b) * G + g;
    if (c > MAX_GROUP) {  // refused by the wrapper; never read as a median
      if (threadIdx.x == 0) *o = from_bits(NAN_BITS);
      continue;
    }
    const double* vals = values + ((long long)b * V + v) * T;
    for (int i = threadIdx.x; i < (int)c; i += blockDim.x)
      keys[i] = bits_of(vals[order[b * order_bs + s + i]]);
    __syncthreads();
    for (int i = threadIdx.x; i < (int)c; i += blockDim.x) {
      const long long k = keys[i];
      int rank = 0;
      for (int j = 0; j < (int)c; ++j) {
        const long long kj = keys[j];
        rank += (kj < k) || (kj == k && j < i);
      }
      if (rank == lo) picked[0] = k;
      if (rank == hi) picked[1] = k;
    }
    __syncthreads();
    if (threadIdx.x == 0) *o = 0.5 * (from_bits(picked[0]) + from_bits(picked[1]));
    __syncthreads();
  }
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ unsigned long long warp_max(unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__global__ void rank_init(long long total, long long B, long long* __restrict__ seqs,
                          unsigned char* __restrict__ present, unsigned char* __restrict__ is_src,
                          unsigned long long* __restrict__ stats) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    seqs[i] = I64_MIN;
    present[i] = 0;
    is_src[i] = 0;
    if (i < B) {  // the identities of min, max and count
      stats[3 * i] = ~0ULL;
      stats[3 * i + 1] = 0ULL;
      stats[3 * i + 2] = 0ULL;
    }
  }
}

// hb_* (B, H): last seq by int64 atomicMax, presence by a store of 1.
__global__ void hb_fold(const long long* __restrict__ hb_rank, const long long* __restrict__ hb_seq,
                        long long B, long long H, long long n, long long* __restrict__ seqs,
                        unsigned char* __restrict__ present) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < B * H;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = hb_rank[i];
    if (r < 0 || r >= n) continue;
    const long long at = (i / H) * n + r;
    atomicMax(&seqs[at], hb_seq[i]);
    present[at] = 1;
  }
}

// is_src: a rank is the source of some group (gkey / n).
__global__ void group_src(const long long* __restrict__ gkey, long long group_bs, long long B,
                          long long G, long long n, unsigned char* __restrict__ is_src) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < B * G;
       i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / G;
    const long long src = gkey[b * group_bs + (i - b * G)] / n;
    if (src >= 0 && src < n) is_src[b * n + src] = 1;
  }
}

// stats (B, 3): per window the least and the largest present key (ukey) and
// the count of present ranks. grid (x, B); every block belongs to one window.
__global__ void rank_stats(const long long* __restrict__ seqs,
                           const unsigned char* __restrict__ present, long long n,
                           unsigned long long* __restrict__ stats) {
  const long long b = blockIdx.y;
  const long long* sq = seqs + b * n;
  const unsigned char* pr = present + b * n;
  unsigned long long mn = ~0ULL, mx = 0ULL, cnt = 0ULL;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (pr[i]) {
      const unsigned long long u = ukey(sq[i]);
      mn = min(mn, u);
      mx = max(mx, u);
      ++cnt;
    }
  }
  mn = warp_min(mn);
  mx = warp_max(mx);
  cnt = warp_sum(cnt);
  if ((threadIdx.x & 31) == 0 && cnt > 0ULL) {
    atomicMin(&stats[3 * b], mn);
    atomicMax(&stats[3 * b + 1], mx);
    atomicAdd(&stats[3 * b + 2], cnt);
  }
}

// One CTA per window: hmed, the mean of the lo-th and hi-th present seqs.
// When every present seq is equal (the telemetry of a healthy step: all
// ranks at the same seq) that is the least one, read from stats; otherwise
// a radix select of the lo-th from the highest 8-bit digit where the least
// and the largest differ, and one more pass for the hi-th.
__global__ void __launch_bounds__(MEDIAN_THREADS)
hang_median(const long long* __restrict__ seqs, const unsigned char* __restrict__ present,
            const unsigned long long* __restrict__ stats, long long n,
            double* __restrict__ med) {
  __shared__ unsigned long long s_le, s_above, s_prefix;
  __shared__ long long s_k;
  __shared__ unsigned int hist[256];
  const long long b = blockIdx.x;
  const long long* sq = seqs + b * n;
  const unsigned char* pr = present + b * n;
  const int lane = threadIdx.x & 31;
  const unsigned long long u_min = stats[3 * b], u_max = stats[3 * b + 1];
  const long long c = (long long)stats[3 * b + 2];
  if (c == 0) {  // no heartbeat: +inf, and no rank is hung
    if (threadIdx.x == 0) med[b] = from_bits(INF_BITS);
    return;
  }
  const long long lo = (c - 1) / 2;
  const long long hi = c / 2;
  unsigned long long vlo = u_min, vhi = u_min;
  const unsigned long long diff = u_min ^ u_max;
  if (diff != 0ULL) {
    if (threadIdx.x == 0) {
      s_le = 0ULL;
      s_above = ~0ULL;
    }
    const int top = 63 - __clzll((long long)diff);
    int shift = (top / 8) * 8;
    // every present key agrees with u_min above bit shift + 8
    unsigned long long mask = (shift + 8 >= 64) ? 0ULL : (~0ULL << (shift + 8));
    unsigned long long prefix = u_min & mask;
    long long k = lo;
    for (; shift >= 0; shift -= 8) {
      for (int d = threadIdx.x; d < 256; d += blockDim.x) hist[d] = 0u;
      __syncthreads();
      for (long long base = 0; base < n; base += blockDim.x) {
        const long long i = base + threadIdx.x;
        bool take = false;
        unsigned digit = 0u;
        if (i < n && pr[i]) {
          const unsigned long long u = ukey(sq[i]);
          if ((u & mask) == prefix) {
            take = true;
            digit = (unsigned)((u >> shift) & 255ULL);
          }
        }
        const unsigned active = __ballot_sync(FULL, take);
        if (take) {
          const unsigned peers = __match_any_sync(active, digit);
          if (lane == __ffs(peers) - 1) atomicAdd(&hist[digit], (unsigned)__popc(peers));
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        long long cum = 0;
        int sel = 255;
        for (int d = 0; d < 256; ++d) {
          if (cum + (long long)hist[d] > k) {
            sel = d;
            break;
          }
          cum += hist[d];
        }
        s_k = k - cum;
        s_prefix = prefix | ((unsigned long long)sel << shift);
      }
      __syncthreads();
      k = s_k;
      prefix = s_prefix;
      mask |= (255ULL << shift);
      __syncthreads();
    }
    vlo = prefix;
    vhi = vlo;
    if (hi != lo) {  // the next order statistic: vlo again, or the least key above it
      unsigned long long le = 0ULL, above = ~0ULL;
      for (long long i = threadIdx.x; i < n; i += blockDim.x) {
        if (pr[i]) {
          const unsigned long long u = ukey(sq[i]);
          if (u <= vlo) ++le;
          else above = min(above, u);
        }
      }
      le = warp_sum(le);
      above = warp_min(above);
      if (lane == 0) {
        atomicAdd(&s_le, le);
        atomicMin(&s_above, above);
      }
      __syncthreads();
      vhi = ((long long)s_le > hi) ? vlo : s_above;
    }
  }
  if (threadIdx.x == 0) {
    const double dlo = (double)(long long)(vlo ^ SIGN);
    const double dhi = (double)(long long)(vhi ^ SIGN);
    med[b] = 0.5 * (dlo + dhi);
  }
}

// deficit = hmed - seq and hung = present & (deficit - offset >= hang_grace)
// for every rank. grid (x, B).
__global__ void rank_deficit(const long long* __restrict__ seqs,
                             const unsigned char* __restrict__ present,
                             const double* __restrict__ offsets, const double* __restrict__ med,
                             double hang_grace, long long n, double* __restrict__ deficit,
                             unsigned char* __restrict__ hung) {
  const long long b = blockIdx.y;
  const double hmed = med[b];
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long at = b * n + i;
    const double d = hmed - (double)seqs[at];
    deficit[at] = d;
    hung[at] = (present[at] && (d - offsets[at]) >= hang_grace) ? 1 : 0;
  }
}

int grid_for(long long total) {
  long long g = (total + THREADS - 1) / THREADS;
  if (g < 1) g = 1;
  if (g > 132LL * 64) g = 132LL * 64;
  return (int)g;
}

cudaError_t launch_row_select(const double* values, long long B, int V, long long T,
                              const long long* order, long long order_bs,
                              const long long* starts, const long long* counts,
                              long long group_bs, long long G, const long long* large,
                              long long n_large, double* out, cudaStream_t st) {
  const long long warps = B * G;
  if (warps > 0) {
    const long long blocks = (warps * 32 + THREADS - 1) / THREADS;
    row_select_warp<<<(unsigned)blocks, THREADS, 0, st>>>(values, B, V, T, order, order_bs,
                                                          starts, counts, group_bs, G, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_large > 0 && B > 0) {
    const dim3 grid((unsigned)n_large, (unsigned)B);
    row_select_cta<<<grid, CTA_THREADS, 0, st>>>(values, B, V, T, order, order_bs, starts,
                                                 counts, group_bs, G, large, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int ws_max_group() { return MAX_GROUP; }
extern "C" int ws_warp_group() { return WARP_GROUP; }

// Per-group medians of V value arrays. values (B, V, T) float64; order
// (B or 1, T), starts and counts (B or 1, G) int64, with batch strides
// order_bs and group_bs (0: one layout for all windows); large: the groups
// of more than ws_warp_group() samples (in any window), n_large of them;
// out (V, B, G) float64. Returns the CUDA error of the launches.
extern "C" int ws_row_select(const void* values, long long B, long long V, long long T,
                             const void* order, long long order_bs, const void* starts,
                             const void* counts, long long group_bs, long long G,
                             const void* large, long long n_large, void* out, void* stream) {
  if (B < 0 || V <= 0 || T < 0 || G < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  return (int)launch_row_select(
      static_cast<const double*>(values), B, (int)V, T, static_cast<const long long*>(order),
      order_bs, static_cast<const long long*>(starts), static_cast<const long long*>(counts),
      group_bs, G, static_cast<const long long*>(large), n_large, static_cast<double*>(out),
      static_cast<cudaStream_t>(stream));
}

// One batch of windows. values (B, 2, T): delay and wait; the layout as for
// ws_row_select, plus gkey (int64, src * n + dst) at the group stride;
// hb_rank, hb_seq (int64) (B, H); offsets (B, n) float64. Outputs: medians
// (2, B, G); present, hung, is_src (B, n) bool; seqs (B, n) int64; med (B,),
// deficit (B, n) float64. stats: (B, 3) 8-byte scratch.
extern "C" int ws_window(const void* values, long long B, long long T, const void* order,
                         long long order_bs, const void* starts, const void* counts,
                         const void* gkey, long long group_bs, long long G,
                         const void* large, long long n_large, const void* hb_rank,
                         const void* hb_seq, long long H, const void* offsets,
                         double hang_grace, long long n, void* medians, void* present, void* seqs, void* med, void* deficit,
                         void* hung, void* is_src, void* stats, void* stream) {
  if (B <= 0 || T < 0 || G < 0 || H < 0 || n <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* seqs_p = static_cast<long long*>(seqs);
  auto* present_p = static_cast<unsigned char*>(present);
  auto* is_src_p = static_cast<unsigned char*>(is_src);
  auto* stats_p = static_cast<unsigned long long*>(stats);
  rank_init<<<grid_for(B * n), THREADS, 0, st>>>(B * n, B, seqs_p, present_p, is_src_p, stats_p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (H > 0) {
    hb_fold<<<grid_for(B * H), THREADS, 0, st>>>(
        static_cast<const long long*>(hb_rank), static_cast<const long long*>(hb_seq), B, H, n,
        seqs_p, present_p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (G > 0) {
    group_src<<<grid_for(B * G), THREADS, 0, st>>>(
        static_cast<const long long*>(gkey), group_bs, B, G, n, is_src_p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = launch_row_select(static_cast<const double*>(values), B, 2, T,
                          static_cast<const long long*>(order), order_bs,
                          static_cast<const long long*>(starts),
                          static_cast<const long long*>(counts), group_bs, G,
                          static_cast<const long long*>(large), n_large,
                          static_cast<double*>(medians), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 rank_grid((unsigned)grid_for(n), (unsigned)B);
  rank_stats<<<rank_grid, THREADS, 0, st>>>(seqs_p, present_p, n, stats_p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hang_median<<<(unsigned)B, MEDIAN_THREADS, 0, st>>>(seqs_p, present_p, stats_p, n,
                                                      static_cast<double*>(med));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rank_deficit<<<rank_grid, THREADS, 0, st>>>(
      seqs_p, present_p, static_cast<const double*>(offsets), static_cast<const double*>(med),
      hang_grace, n, static_cast<double*>(deficit), static_cast<unsigned char*>(hung));
  return (int)cudaGetLastError();
}
