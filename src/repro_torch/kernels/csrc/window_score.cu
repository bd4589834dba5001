// Window scoring for sm_90a (H100): per-group median row select and the
// heartbeat (hang) fold of one or a batch of C4D telemetry windows.
//
// Replaces the XLA jit kernels of the JAX package
// src/repro/core/jaxsim/kernels.py::fused_window_kernel (entry ws_window)
// and ::grouped_median_kernel (entry ws_row_select, the prefilter's
// medians). Same function, bit for bit (the exact path of that module):
//  * per (src, dst) pair group, the lo = max((c-1)//2, 0) and
//    hi = c//2 order statistics of its samples in the order of NumPy's
//    stable lexsort: any float64, ordered by order_key (-0.0 ties +0.0,
//    every NaN ties every other above +inf, negatives below), ties by
//    position in the layout's order (the input order); each statistic is
//    the sample's own bits, and the median 0.5 * (lo + hi); an empty group
//    reads +inf;
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
// heartbeats (16 MB); the prefilter's node groups are 24 MB of values and
// 24 MB of order. The work is a few compares a sample, but the samples are
// gathered through the order, so what the design fights is latency: loads
// that wait on loads, lanes with nothing to do, passes that wait on barriers.
//
// Design. The host groups the transport keys once (a layout cached across
// windows with equal keys) and keeps its sort order and group starts on the
// card, so a window sends only its values: the kernel gathers each group's
// samples through the order. Group sizes are known on the host (the
// layout's counts, its list of groups above SMALL_GROUP, its largest
// count), so the host picks the tiers, with no device reduction:
//  * groups of up to SMALL_GROUP samples (the telemetry's pairs have 10)
//    take a thread each, adjacent threads on adjacent groups, so that the
//    i-th samples of neighbouring groups share sectors. A thread reads its
//    order entries once for all value arrays and issues every value load
//    of an array before its first compare; ranks are counted in registers,
//    unrolled over the call's largest small count: no shuffle, no idle lane.
//    (Copying a warp's run of the order into shared memory first, taking two
//    arrays at a time, and CTAs of 256 threads each measured slower.)
//  * groups of up to WARP_GROUP (the prefilter's node groups, ~240) take a
//    warp each, a lane holding the samples at positions e * 32 + lane in
//    registers (coalesced loads): a radix select on the key, 8-bit digits
//    from the highest bit where the least and largest key differ, a digit's
//    histogram in shared memory, until at most 32 candidates share the
//    prefix, which are then ranked against each other; the next statistic
//    is the least (key, position) above the first. No barrier but the
//    warp's. (A bitonic sort of the group in shared memory by a CTA, a
//    histogram aggregated by __match_any_sync, and one-bit splits counted
//    by ballots each measured slower.)
//  * larger groups take a CTA each and the same radix select block-wide, in
//    device memory, the samples read through the order at each pass (the
//    select of the hang median below), the statistics' own bits found by
//    their rank among equal keys where a key stands for several bit
//    patterns (+-0.0, NaN).
// The hang median is one CTA a window: the radix select of the lo-th
// present seq, and one more pass for the hi-th; the count, least and
// largest present seq, and the deficits, are folded over all ranks by many
// CTAs, so the one CTA is short when all seqs are equal. Windows are
// indexed in x or looped over, so a call takes any batch. Every shape is
// the window's own (G groups, H heartbeats, n ranks): no padding slot is
// read, written or skipped.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMALL_GROUP = 16;      // groups up to this many samples: a thread each
constexpr int WARP_GROUP = 512;      // up to this many: a warp each, keys in registers
constexpr int WARPS = 4;             // warps of a CTA of the warp tier
constexpr int THREADS = 256;
constexpr int SMALL_THREADS = 128;   // a CTA of the thread tier
constexpr int MEDIAN_THREADS = 1024;
constexpr long long MAX_CTAS = 1LL << 24;  // CTAs of one launch; more jobs loop
constexpr long long I64_MIN = (-0x7fffffffffffffffLL - 1);
constexpr long long I64_MAX = 0x7fffffffffffffffLL;
constexpr unsigned long long SIGN = 0x8000000000000000ULL;
constexpr long long FLIP = 0x7fffffffffffffffLL;
constexpr long long INF_BITS = 0x7ff0000000000000LL;
constexpr long long NAN_KEY = 0x7ff8000000000000LL;  // every NaN's key: above +inf's
constexpr long long PAD_KEY = I64_MAX;               // above every sample's key

__device__ __forceinline__ double from_bits(long long b) { return __longlong_as_double(b); }
// int64 -> unsigned with the same order
__device__ __forceinline__ unsigned long long ukey(long long x) {
  return static_cast<unsigned long long>(x) ^ SIGN;
}

// NumPy's sort order of float64 as an int64 key: -0.0 as +0.0, every NaN
// (any sign or payload) as one key above +inf, and the sign-aware flip of
// slow_fold.cu's order_key (negatives: all bits but the sign flipped).
__device__ __forceinline__ long long order_key(double x) {
  const long long b = __double_as_longlong(x);
  if ((b & FLIP) > INF_BITS) return NAN_KEY;
  if (b == I64_MIN) return 0;
  return b >= 0 ? b : (b ^ FLIP);
}
// A key of several bit patterns (0: +-0.0; NAN_KEY: every NaN): the
// statistic is read back from its own sample. Any other key is its value.
__device__ __forceinline__ bool many_bits(long long k) { return k == 0 || k == NAN_KEY; }
__device__ __forceinline__ double key_value(long long k) {
  return from_bits(k >= 0 ? k : (k ^ FLIP));
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

// ---------------------------------------------------------------------------
// small groups: a thread each
// ---------------------------------------------------------------------------

// The median of one group from its keys in registers: each slot's rank by
// (key, position), unrolled over MAXC slots (slots past the count hold
// PAD_KEY and rank above every sample).
template <int MAXC>
__device__ __forceinline__ double small_median(const long long (&k)[MAXC],
                                               const long long (&idx)[MAXC],
                                               const double* __restrict__ x, int lo, int hi) {
  long long klo = 0, khi = 0, ilo = 0, ihi = 0;
#pragma unroll
  for (int a = 0; a < MAXC; ++a) {
    int r = 0;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      if (j < a) r += k[j] <= k[a];
      else if (j > a) r += k[j] < k[a];
    }
    if (r == lo) {
      klo = k[a];
      ilo = idx[a];
    }
    if (r == hi) {
      khi = k[a];
      ihi = idx[a];
    }
  }
  const double vlo = many_bits(klo) ? x[ilo] : key_value(klo);
  const double vhi = many_bits(khi) ? x[ihi] : key_value(khi);
  return 0.5 * (vlo + vhi);
}

// values (B, V, T); out (V, B, G). A thread a (window b, group g) of at most
// MAXC samples; larger groups are another tier's. The thread reads its
// order entries once for all arrays and, per array, every value before the
// first compare.
template <int MAXC>
__global__ void __launch_bounds__(SMALL_THREADS, 6)
row_select_small(const double* __restrict__ values, long long B, int V, long long T,
                 const long long* __restrict__ order, long long order_bs,
                 const long long* __restrict__ starts, const long long* __restrict__ counts,
                 long long group_bs, long long G, double* __restrict__ out) {
  const long long plane = B * G;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= plane) return;
  const long long b = i / G;
  const long long gi = b * group_bs + (i - b * G);
  const long long c = counts[gi];
  if (c > MAXC) return;
  if (c <= 0) {  // empty group: +inf, as an all-+inf row reads
    for (int v = 0; v < V; ++v) out[v * plane + i] = from_bits(INF_BITS);
    return;
  }
  const long long* ord = order + b * order_bs + starts[gi];
  long long idx[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) idx[j] = j < c ? ord[j] : 0;
  const int lo = (int)((c - 1) / 2);
  const int hi = (int)(c / 2);
  for (int v = 0; v < V; ++v) {
    const double* x = values + (b * V + v) * T;
    double a[MAXC];
#pragma unroll
    for (int j = 0; j < MAXC; ++j) a[j] = j < c ? x[idx[j]] : 0.0;
    long long k[MAXC];
#pragma unroll
    for (int j = 0; j < MAXC; ++j) k[j] = j < c ? order_key(a[j]) : PAD_KEY;
    out[v * plane + i] = small_median(k, idx, x, lo, hi);
  }
}

// ---------------------------------------------------------------------------
// medium groups: a warp each, a radix select on keys in registers
// ---------------------------------------------------------------------------

struct WarpSmem {
  unsigned int hist[256];
  unsigned long long cand_u[32];
  int cand_p[32];
};

// (key, position) order: the stable sort's
__device__ __forceinline__ bool before(unsigned long long ua, int pa, unsigned long long ub,
                                       int pb) {
  return ua < ub || (ua == ub && pa < pb);
}

// Of the warp's c samples (lane l holds those at positions e * 32 + l, e <
// E; u their unsigned keys), the r-th by (key, position): 8-bit digits of
// the key from the highest bit where the least and largest differ, each
// digit's histogram in shared memory (a lane reads 8 bins, a warp scan finds
// the digit), until at most 32 candidates share the prefix; those are
// ranked against each other in one pass. Keys all equal to the last bit:
// the r-th by position.
template <int E>
__device__ __forceinline__ void warp_select(const unsigned long long (&u)[E], int c, int r,
                                            WarpSmem& sm, unsigned long long& u_out,
                                            int& p_out) {
  const int lane = threadIdx.x & 31;
  unsigned long long mn = ~0ULL, mx = 0ULL;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e * 32 + lane < c) {
      mn = min(mn, u[e]);
      mx = max(mx, u[e]);
    }
  }
  mn = warp_min(mn);
  mx = warp_max(mx);
  int top = mn == mx ? -1 : 63 - __clzll((long long)(mn ^ mx));  // bits top .. 0 still open
  unsigned long long mask = top == 63 ? 0ULL : (~0ULL << (top + 1));
  unsigned long long prefix = mn & mask;
  int m = c;  // candidates: samples whose key agrees with prefix on mask
  while (m > 32 && top >= 0) {
    const int low = top >= 7 ? top - 7 : 0;
    const unsigned dmask = (1u << (top - low + 1)) - 1u;
    for (int d = lane; d < 256; d += 32) sm.hist[d] = 0u;
    __syncwarp();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e * 32 + lane < c && (u[e] & mask) == prefix)
        atomicAdd(&sm.hist[(unsigned)(u[e] >> low) & dmask], 1u);
    }
    __syncwarp();
    unsigned h[8], tot = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      h[q] = sm.hist[lane * 8 + q];
      tot += h[q];
    }
    unsigned incl = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    unsigned run = incl - tot, cum = 0, cnt = 0;
    int sel = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (run <= (unsigned)r && (unsigned)r < run + h[q]) {
        sel = lane * 8 + q;
        cum = run;
        cnt = h[q];
      }
      run += h[q];
    }
    const int src = __ffs(__ballot_sync(FULL, cnt > 0)) - 1;
    sel = __shfl_sync(FULL, sel, src);
    r -= (int)__shfl_sync(FULL, cum, src);
    m = (int)__shfl_sync(FULL, cnt, src);
    prefix |= (unsigned long long)sel << low;
    mask |= (unsigned long long)dmask << low;
    top = low - 1;
    __syncwarp();  // the bins are read before the next pass clears them
  }
  if (m > 32) {  // every candidate has the key prefix: the r-th by position
    int seen = 0;
    p_out = -1;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const unsigned hit = __ballot_sync(FULL, e * 32 + lane < c && u[e] == prefix);
      const int cnt = __popc(hit);
      if (p_out < 0 && r < seen + cnt) p_out = e * 32 + (int)__fns(hit, 0, r - seen + 1);
      seen += cnt;
    }
    u_out = prefix;
    return;
  }
  int slots = 0;  // the candidates into shared memory, in position order
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool take = e * 32 + lane < c && (u[e] & mask) == prefix;
    const unsigned hit = __ballot_sync(FULL, take);
    if (take) {
      const int slot = slots + __popc(hit & ((1u << lane) - 1u));
      sm.cand_u[slot] = u[e];
      sm.cand_p[slot] = e * 32 + lane;
    }
    slots += __popc(hit);
  }
  __syncwarp();
  const unsigned long long uj = lane < m ? sm.cand_u[lane] : ~0ULL;
  const int pj = lane < m ? sm.cand_p[lane] : 0x7fffffff;
  int rank = 0;
  for (int i = 0; i < m; ++i) rank += before(sm.cand_u[i], sm.cand_p[i], uj, pj);
  const int src = __ffs(__ballot_sync(FULL, lane < m && rank == r)) - 1;
  u_out = __shfl_sync(FULL, uj, src);
  p_out = __shfl_sync(FULL, pj, src);
  __syncwarp();  // the candidates are read before a next select writes them
}

// The least (key, position) after (ua, pa) among the warp's samples.
template <int E>
__device__ __forceinline__ void warp_next(const unsigned long long (&u)[E], int c, unsigned long long ua, int pa,
                          unsigned long long& u_out, int& p_out) {
  const int lane = threadIdx.x & 31;
  unsigned long long bu = ~0ULL;
  int bp = 0x7fffffff;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = e * 32 + lane;
    if (p < c && before(ua, pa, u[e], p) && before(u[e], p, bu, bp)) {
      bu = u[e];
      bp = p;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long ou = __shfl_xor_sync(FULL, bu, o);
    const int op = __shfl_xor_sync(FULL, bp, o);
    if (before(ou, op, bu, bp)) {
      bu = ou;
      bp = op;
    }
  }
  u_out = bu;
  p_out = bp;
}

// WARPS warps a CTA, each a (window, listed group) job of SMALL_GROUP < c
// <= 32 * E samples; lane l holds the samples at positions e * 32 + l, so
// each load of the order and of the values is one coalesced warp access.
template <int E>
__global__ void __launch_bounds__(32 * WARPS)
row_select_warp(const double* __restrict__ values, long long B, int V, long long T,
                const long long* __restrict__ order, long long order_bs,
                const long long* __restrict__ starts, const long long* __restrict__ counts,
                long long group_bs, long long G, const long long* __restrict__ large,
                long long n_large, double* __restrict__ out) {
  __shared__ WarpSmem smem[WARPS];
  WarpSmem& sm = smem[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  for (long long job = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); job < n_large * B;
       job += (long long)gridDim.x * WARPS) {
    const long long b = job / n_large;
    const long long g = large[job - b * n_large];
    const int c = (int)min(counts[b * group_bs + g], (long long)WARP_GROUP + 1);
    if (c <= SMALL_GROUP || c > 32 * E) continue;  // another tier's (uniform over the warp)
    const long long* ord = order + b * order_bs + starts[b * group_bs + g];
    long long idx[E];
#pragma unroll
    for (int e = 0; e < E; ++e) idx[e] = e * 32 + lane < c ? ord[e * 32 + lane] : 0;
    const int lo = (c - 1) / 2, hi = c / 2;
    for (int v = 0; v < V; ++v) {
      const double* x = values + (b * V + v) * T;
      double a[E];
#pragma unroll
      for (int e = 0; e < E; ++e) a[e] = e * 32 + lane < c ? x[idx[e]] : 0.0;
      unsigned long long u[E];
#pragma unroll
      for (int e = 0; e < E; ++e) u[e] = ukey(order_key(a[e]));
      unsigned long long u_lo, u_hi;
      int p_lo, p_hi;
      warp_select(u, c, lo, sm, u_lo, p_lo);
      u_hi = u_lo;
      p_hi = p_lo;
      if (hi != lo) warp_next(u, c, u_lo, p_lo, u_hi, p_hi);
      if (lane == 0) {
        const long long k_lo = (long long)(u_lo ^ SIGN), k_hi = (long long)(u_hi ^ SIGN);
        const double v_lo = many_bits(k_lo) ? x[ord[p_lo]] : key_value(k_lo);
        const double v_hi = many_bits(k_hi) ? x[ord[p_hi]] : key_value(k_hi);
        out[((long long)v * B + b) * G + g] = 0.5 * (v_lo + v_hi);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// radix select, block-wide (large groups and the hang median)
// ---------------------------------------------------------------------------

struct RadixSmem {
  unsigned int hist[256];
  unsigned int warp_count[32];
  unsigned long long le, above, prefix, umin, umax;
  long long k, found;
};

// Of the n keys get(i, u) (the i for which it returns true; u the unsigned
// key), the k-th smallest, 0-based, given their least and largest: 8-bit
// digits from the highest where those two differ. On return k is that key's
// rank among the keys equal to it. Every thread of the block calls it.
template <class Get>
__device__ unsigned long long radix_select(Get get, long long n, long long& k,
                                           unsigned long long u_min, unsigned long long u_max,
                                           RadixSmem& s) {
  const unsigned long long diff = u_min ^ u_max;
  if (diff == 0ULL) return u_min;
  const int lane = threadIdx.x & 31;
  const int top = 63 - __clzll((long long)diff);
  int shift = (top / 8) * 8;
  // every key agrees with u_min above bit shift + 8
  unsigned long long mask = (shift + 8 >= 64) ? 0ULL : (~0ULL << (shift + 8));
  unsigned long long prefix = u_min & mask;
  for (; shift >= 0; shift -= 8) {
    for (int d = threadIdx.x; d < 256; d += blockDim.x) s.hist[d] = 0u;
    __syncthreads();
    for (long long base = 0; base < n; base += blockDim.x) {
      const long long i = base + threadIdx.x;
      unsigned long long u = 0ULL;
      const bool take = i < n && get(i, u) && (u & mask) == prefix;
      const unsigned digit = take ? (unsigned)((u >> shift) & 255ULL) : 0u;
      const unsigned active = __ballot_sync(FULL, take);
      if (take) {
        const unsigned peers = __match_any_sync(active, digit);
        if (lane == __ffs(peers) - 1) atomicAdd(&s.hist[digit], (unsigned)__popc(peers));
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      long long cum = 0;
      int sel = 255;
      for (int d = 0; d < 256; ++d) {
        if (cum + (long long)s.hist[d] > k) {
          sel = d;
          break;
        }
        cum += s.hist[d];
      }
      s.k = k - cum;
      s.prefix = prefix | ((unsigned long long)sel << shift);
    }
    __syncthreads();
    k = s.k;
    prefix = s.prefix;
    mask |= (255ULL << shift);
    __syncthreads();
  }
  return prefix;
}

// How many of the keys are <= v, and the least key above v (~0 if none).
template <class Get>
__device__ void le_and_above(Get get, long long n, unsigned long long v, RadixSmem& s,
                             unsigned long long& le_out, unsigned long long& above_out) {
  if (threadIdx.x == 0) {
    s.le = 0ULL;
    s.above = ~0ULL;
  }
  __syncthreads();
  unsigned long long le = 0ULL, above = ~0ULL;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    unsigned long long u;
    if (get(i, u)) {
      if (u <= v) ++le;
      else above = min(above, u);
    }
  }
  le = warp_sum(le);
  above = warp_min(above);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&s.le, le);
    atomicMin(&s.above, above);
  }
  __syncthreads();
  le_out = s.le;
  above_out = s.above;
  __syncthreads();
}

// The position i < n of the r-th (0-based, in position order) key equal to
// kk: a scan of the block, a chunk of blockDim positions at a time.
template <class Get>
__device__ long long nth_equal(Get get, long long n, unsigned long long kk, long long r,
                               RadixSmem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  long long seen = 0;
  if (threadIdx.x == 0) s.found = -1;
  for (long long base = 0; base < n; base += blockDim.x) {
    const long long i = base + threadIdx.x;
    unsigned long long u = 0ULL;
    const bool hit = i < n && get(i, u) && u == kk;
    const unsigned m = __ballot_sync(FULL, hit);
    if (lane == 0) s.warp_count[warp] = (unsigned)__popc(m);
    __syncthreads();
    long long before = __popc(m & ((1u << lane) - 1u)), total = 0;
    for (int w = 0; w < warps; ++w) {
      if (w < warp) before += s.warp_count[w];
      total += s.warp_count[w];
    }
    if (hit && seen + before == r) s.found = i;
    seen += total;
    __syncthreads();
    if (seen > r) break;  // uniform: every thread has the same seen
  }
  const long long found = s.found;
  __syncthreads();  // read by all before a next call resets it
  return found;
}

// One CTA per (window, listed group) job: groups of more than WARP_GROUP
// samples, each array's two statistics by radix select over the group in
// device memory (the samples read through the order at each pass).
__global__ void __launch_bounds__(MEDIAN_THREADS)
row_select_radix(const double* __restrict__ values, long long B, int V, long long T,
                 const long long* __restrict__ order, long long order_bs,
                 const long long* __restrict__ starts, const long long* __restrict__ counts,
                 long long group_bs, long long G, const long long* __restrict__ large,
                 long long n_large, double* __restrict__ out) {
  __shared__ RadixSmem s;
  for (long long job = blockIdx.x; job < n_large * B; job += gridDim.x) {
    const long long b = job / n_large;
    const long long g = large[job - b * n_large];
    const long long c = counts[b * group_bs + g];
    if (c <= WARP_GROUP) continue;  // another tier's (uniform over the CTA)
    const long long* ord = order + b * order_bs + starts[b * group_bs + g];
    const long long lo = (c - 1) / 2;
    const long long hi = c / 2;
    for (int v = 0; v < V; ++v) {
      const double* x = values + (b * V + v) * T;
      auto get = [&](long long i, unsigned long long& u) {
        u = ukey(order_key(x[ord[i]]));
        return true;
      };
      __syncthreads();  // the previous statistics are read
      if (threadIdx.x == 0) {
        s.umin = ~0ULL;
        s.umax = 0ULL;
      }
      unsigned long long mn = ~0ULL, mx = 0ULL;
      for (long long i = threadIdx.x; i < c; i += blockDim.x) {
        unsigned long long u;
        get(i, u);
        mn = min(mn, u);
        mx = max(mx, u);
      }
      mn = warp_min(mn);
      mx = warp_max(mx);
      __syncthreads();
      if ((threadIdx.x & 31) == 0) {
        atomicMin(&s.umin, mn);
        atomicMax(&s.umax, mx);
      }
      __syncthreads();
      const unsigned long long u_min = s.umin, u_max = s.umax;
      __syncthreads();
      long long r_lo = lo;
      const unsigned long long u_lo = radix_select(get, c, r_lo, u_min, u_max, s);
      unsigned long long u_hi = u_lo;
      long long r_hi = r_lo;
      if (hi != lo) {  // the next statistic: the same key again, or the least above it
        unsigned long long le, above;
        le_and_above(get, c, u_lo, s, le, above);
        if ((long long)le > hi) {
          r_hi = r_lo + 1;
        } else {
          u_hi = above;
          r_hi = 0;
        }
      }
      const long long k_lo = (long long)(u_lo ^ SIGN), k_hi = (long long)(u_hi ^ SIGN);
      double v_lo = key_value(k_lo), v_hi = key_value(k_hi);
      if (many_bits(k_lo)) v_lo = x[ord[nth_equal(get, c, u_lo, r_lo, s)]];
      if (many_bits(k_hi)) v_hi = x[ord[nth_equal(get, c, u_hi, r_hi, s)]];
      if (threadIdx.x == 0) out[((long long)v * B + b) * G + g] = 0.5 * (v_lo + v_hi);
    }
  }
}

// ---------------------------------------------------------------------------
// the heartbeat (hang) fold
// ---------------------------------------------------------------------------

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
// the count of present ranks, a block's warps folded before one atomic of
// each. grid (x, y); windows y, y + gridDim.y, ...
__global__ void rank_stats(const long long* __restrict__ seqs,
                           const unsigned char* __restrict__ present, long long B, long long n,
                           unsigned long long* __restrict__ stats) {
  __shared__ unsigned long long part[3][32];
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
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
    const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      part[0][warp] = mn;
      part[1][warp] = mx;
      part[2][warp] = cnt;
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // one atomic of each a block
      const int w = threadIdx.x;
      mn = warp_min(w < warps ? part[0][w] : ~0ULL);
      mx = warp_max(w < warps ? part[1][w] : 0ULL);
      cnt = warp_sum(w < warps ? part[2][w] : 0ULL);
      if (w == 0 && cnt > 0ULL) {
        atomicMin(&stats[3 * b], mn);
        atomicMax(&stats[3 * b + 1], mx);
        atomicAdd(&stats[3 * b + 2], cnt);
      }
    }
    __syncthreads();
  }
}

// One CTA per window: hmed, the mean of the lo-th and hi-th present seqs.
// When every present seq is equal (the telemetry of a healthy step: all
// ranks at the same seq) that is the least one, read from stats; otherwise
// the radix select of the lo-th, and one more pass for the hi-th.
__global__ void __launch_bounds__(MEDIAN_THREADS)
hang_median(const long long* __restrict__ seqs, const unsigned char* __restrict__ present,
            const unsigned long long* __restrict__ stats, long long n,
            double* __restrict__ med) {
  __shared__ RadixSmem s;
  const long long b = blockIdx.x;
  const long long* sq = seqs + b * n;
  const unsigned char* pr = present + b * n;
  const unsigned long long u_min = stats[3 * b], u_max = stats[3 * b + 1];
  const long long c = (long long)stats[3 * b + 2];
  if (c == 0) {  // no heartbeat: +inf, and no rank is hung
    if (threadIdx.x == 0) med[b] = from_bits(INF_BITS);
    return;
  }
  auto get = [&](long long i, unsigned long long& u) {
    if (!pr[i]) return false;
    u = ukey(sq[i]);
    return true;
  };
  const long long lo = (c - 1) / 2;
  const long long hi = c / 2;
  long long k = lo;
  const unsigned long long vlo = radix_select(get, n, k, u_min, u_max, s);
  unsigned long long vhi = vlo;
  if (hi != lo && u_min != u_max) {  // the next: vlo again, or the least key above it
    unsigned long long le, above;
    le_and_above(get, n, vlo, s, le, above);
    vhi = ((long long)le > hi) ? vlo : above;
  }
  if (threadIdx.x == 0) {
    const double dlo = (double)(long long)(vlo ^ SIGN);
    const double dhi = (double)(long long)(vhi ^ SIGN);
    med[b] = 0.5 * (dlo + dhi);
  }
}

// deficit = hmed - seq and hung = present & (deficit - offset >= hang_grace)
// for every rank. grid (x, y); windows y, y + gridDim.y, ...
__global__ void rank_deficit(const long long* __restrict__ seqs,
                             const unsigned char* __restrict__ present,
                             const double* __restrict__ offsets, const double* __restrict__ med,
                             double hang_grace, long long B, long long n,
                             double* __restrict__ deficit, unsigned char* __restrict__ hung) {
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const double hmed = med[b];
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
      const long long at = b * n + i;
      const double d = hmed - (double)seqs[at];
      deficit[at] = d;
      hung[at] = (present[at] && (d - offsets[at]) >= hang_grace) ? 1 : 0;
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int grid_for(long long total) {
  long long g = (total + THREADS - 1) / THREADS;
  if (g < 1) g = 1;
  if (g > 132LL * 64) g = 132LL * 64;
  return (int)g;
}

// a grid over (ranks, windows): windows past 65,535 loop
dim3 rank_grid(long long n, long long B) {
  return dim3((unsigned)grid_for(n), (unsigned)(B < 65535 ? B : 65535));
}

template <int MAXC>
void launch_small(long long blocks, cudaStream_t st, const double* values, long long B, int V,
                  long long T, const long long* order, long long order_bs,
                  const long long* starts, const long long* counts, long long group_bs,
                  long long G, double* out) {
  row_select_small<MAXC><<<(unsigned)blocks, SMALL_THREADS, 0, st>>>(
      values, B, V, T, order, order_bs, starts, counts, group_bs, G, out);
}

using SmallLaunch = void (*)(long long, cudaStream_t, const double*, long long, int, long long,
                             const long long*, long long, const long long*, const long long*,
                             long long, long long, double*);
// row_select_small<MAXC> for MAXC = 1 .. SMALL_GROUP: the call's largest
// small count, so that a thread compares no slot past it
constexpr SmallLaunch SMALL_LAUNCH[SMALL_GROUP] = {
    launch_small<1>,  launch_small<2>,  launch_small<3>,  launch_small<4>,
    launch_small<5>,  launch_small<6>,  launch_small<7>,  launch_small<8>,
    launch_small<9>,  launch_small<10>, launch_small<11>, launch_small<12>,
    launch_small<13>, launch_small<14>, launch_small<15>, launch_small<16>};

#define WARP_LAUNCH(E)                                                                \
  row_select_warp<E><<<grid, 32 * WARPS, 0, st>>>(values, B, V, T, order, order_bs, starts, \
                                                 counts, group_bs, G, large, n_large, out)

cudaError_t launch_row_select(const double* values, long long B, int V, long long T,
                              const long long* order, long long order_bs,
                              const long long* starts, const long long* counts,
                              long long group_bs, long long G, const long long* large,
                              long long n_large, long long max_count, double* out,
                              cudaStream_t st) {
  const long long groups = B * G;
  if (groups > 0 && !(group_bs == 0 && n_large == G)) {  // else no group of a thread's
    const long long blocks = (groups + SMALL_THREADS - 1) / SMALL_THREADS;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const long long maxc = max_count < 1 ? 1 : (max_count > SMALL_GROUP ? SMALL_GROUP : max_count);
    SMALL_LAUNCH[maxc - 1](blocks, st, values, B, V, T, order, order_bs, starts, counts,
                           group_bs, G, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long jobs = n_large * B;
  if (jobs <= 0 || max_count <= SMALL_GROUP) return cudaSuccess;
  int e = 1;  // samples a lane holds: the largest warp-tier group's, a power of two
  while (32 * e < max_count && 32 * e < WARP_GROUP) e <<= 1;
  const long long warp_ctas = (jobs + WARPS - 1) / WARPS;
  const unsigned grid = (unsigned)(warp_ctas < MAX_CTAS ? warp_ctas : MAX_CTAS);
  switch (e) {
    case 1: WARP_LAUNCH(1); break;
    case 2: WARP_LAUNCH(2); break;
    case 4: WARP_LAUNCH(4); break;
    case 8: WARP_LAUNCH(8); break;
    default: WARP_LAUNCH(16); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || max_count <= WARP_GROUP) return err;
  row_select_radix<<<(unsigned)(jobs < MAX_CTAS ? jobs : MAX_CTAS), MEDIAN_THREADS, 0, st>>>(
      values, B, V, T, order, order_bs, starts, counts, group_bs, G, large, n_large, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ws_small_group() { return SMALL_GROUP; }
extern "C" int ws_warp_group() { return WARP_GROUP; }

// Per-group medians of V value arrays. values (B, V, T) float64; order
// (B or 1, T), starts and counts (B or 1, G) int64, with batch strides
// order_bs and group_bs (0: one layout for all windows); large: the groups
// of more than ws_small_group() samples (in any window), n_large of them;
// max_count: the largest group (it picks the tiers); out (V, B, G) float64.
// Returns the CUDA error of the launches.
extern "C" int ws_row_select(const void* values, long long B, long long V, long long T,
                             const void* order, long long order_bs, const void* starts,
                             const void* counts, long long group_bs, long long G,
                             const void* large, long long n_large, long long max_count,
                             void* out, void* stream) {
  if (B < 0 || V <= 0 || T < 0 || G < 0) return (int)cudaErrorInvalidValue;
  return (int)launch_row_select(
      static_cast<const double*>(values), B, (int)V, T, static_cast<const long long*>(order),
      order_bs, static_cast<const long long*>(starts), static_cast<const long long*>(counts),
      group_bs, G, static_cast<const long long*>(large), n_large, max_count,
      static_cast<double*>(out), static_cast<cudaStream_t>(stream));
}

// One batch of windows. values (B, 2, T): delay and wait; the layout as for
// ws_row_select, plus gkey (int64, src * n + dst) at the group stride;
// hb_rank, hb_seq (int64) (B, H); offsets (B, n) float64. Outputs: medians
// (2, B, G); present, hung, is_src (B, n) bool; seqs (B, n) int64; med (B,),
// deficit (B, n) float64. stats: (B, 3) 8-byte scratch.
extern "C" int ws_window(const void* values, long long B, long long T, const void* order,
                         long long order_bs, const void* starts, const void* counts,
                         const void* gkey, long long group_bs, long long G,
                         const void* large, long long n_large, long long max_count,
                         const void* hb_rank, const void* hb_seq, long long H,
                         const void* offsets, double hang_grace, long long n, void* medians,
                         void* present, void* seqs, void* med, void* deficit, void* hung,
                         void* is_src, void* stats, void* stream) {
  if (B <= 0 || T < 0 || G < 0 || H < 0 || n <= 0 || B > 0x7fffffffLL)
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
                          static_cast<const long long*>(large), n_large, max_count,
                          static_cast<double*>(medians), st);
  if (err != cudaSuccess) return (int)err;
  rank_stats<<<rank_grid(n, B), THREADS, 0, st>>>(seqs_p, present_p, B, n, stats_p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hang_median<<<(unsigned)B, MEDIAN_THREADS, 0, st>>>(seqs_p, present_p, stats_p, n,
                                                      static_cast<double*>(med));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rank_deficit<<<rank_grid(n, B), THREADS, 0, st>>>(
      seqs_p, present_p, static_cast<const double*>(offsets), static_cast<const double*>(med),
      hang_grace, B, n, static_cast<double*>(deficit), static_cast<unsigned char*>(hung));
  return (int)cudaGetLastError();
}
