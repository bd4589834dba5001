// The slow-path z fold of C4D for sm_90a (H100): per-group z-scores, the
// delay matrix's row and column folds, point links and the ring-wait fold,
// over one or a batch of windows.
//
// Replaces the XLA jit kernel of the JAX package
// src/repro/core/jaxsim/kernels.py::slow_fold_kernel (and its vmapped
// batch). Same function, bit for bit: zd = (dmed - center_d) / scale_d and
// zw likewise (the centers and scales come from NumPy on the host, where
// the only a*b + c of the path is computed); per rank, hot and valid counts
// of its row and column (exact integers in any order) and the row and
// column max of zd, taken on an order-preserving 64-bit key of the float64
// (fold_key below: -inf is key 0, the max's identity, so a rank with no
// cells reads -inf as the reference does; -0.0 below +0.0; every NaN above
// +inf, so a NaN of either sign wins the max as it does in the reference);
// row_sel/col_sel (obs >= min_observations, hot >= max(1, row_col_fraction
// * obs), hot >= 2); point = hot & ~row_sel[src] & ~col_sel[dst]; and the
// ring-wait mask (zw hot over a healthy transfer), its max and whether any
// per source. No float sum anywhere, and a max does not depend on order, so
// every output is deterministic. Built with --fmad=false; division is IEEE.
//
// What bounds it on the H100: bytes (the key and 6 float64 arrays in and 3
// arrays out a group, 10 arrays out a rank), then the latency of its
// atomics and of its launches. Design:
//  - one cooperative launch on a grid sized to the card (every CTA
//    resident), its four phases (rank identities, groups, ranks, points)
//    split by grid-wide barriers. A thread keeps its first KEEP groups' rank
//    indices and hot bit in registers from the groups phase to the points
//    phase, which then reads neither the key nor zd again;
//  - on the row side, neighbouring lanes of a warp that fold into the same
//    rank combine first (a shuffle of the neighbour's rank and a ballot
//    find the runs; popc of ballots gives the counts, a segmented shuffle
//    max the key), and the run's first lane does the atomics. A window's
//    keys come sorted (src * n + dst ascending), so a rank's row groups are
//    neighbours (~3 a rank at 100,000 ranks) and cost one set of atomics;
//    nothing assumes the order: any key order gives the same result, only
//    with more atomics. The column side keeps an atomic a group: its ranks
//    are scattered, and in sorted keys neighbours never share one. (Measured
//    on an H100 80GB HBM3 at 700 W: aggregating by __match_any_sync over
//    the whole warp cost more than the atomics it saved; aggregating the
//    column side too, 2 % more.);
//  - a rank's hot and valid counts travel as one 64-bit add (valid in the
//    high half, hot in the low), and the rank identities are zeros (key 0 is
//    -inf), so the identities phase writes 5 words a rank and nothing else.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int KEEP = 4;             // groups a thread keeps in registers across the barriers
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

typedef unsigned long long u64;

constexpr u64 SIGN = 0x8000000000000000ULL;
constexpr u64 NEG_INF_U = 0x000FFFFFFFFFFFFFULL;  // the standard key of -inf

// float64 -> u64 in the fold's order, and back (a bijection). The standard
// key u (sign set: all bits flipped; else the sign bit set) orders every
// number and puts NaNs of the sign bit below -inf and the others above
// +inf; subtracting the key of -inf makes -inf 0 and rotates the NaNs of
// the sign bit to the top.
__device__ __forceinline__ u64 fold_key(double x) {
  const u64 b = (u64)__double_as_longlong(x);
  const u64 u = (b & SIGN) ? ~b : (b | SIGN);
  return u - NEG_INF_U;
}
__device__ __forceinline__ double from_fold_key(u64 k) {
  const u64 u = k + NEG_INF_U;
  return __longlong_as_double((long long)((u & SIGN) ? (u ^ SIGN) : ~u));
}

struct Args {
  const long long* gkey;
  long long group_bs;
  const double *dmed, *wmed, *cd, *sd, *cw, *sw;
  long long B, G, n, min_obs;
  double thr, rcf;
  double *zd, *zw;
  u64 *row_key, *col_key, *wait_key;   // the score arrays, decoded in place
  u64 *row_cnt, *col_cnt;              // row_hot / col_hot: (valid << 32) | hot until split
  long long *row_obs, *col_obs;
  unsigned char *point, *row_sel, *col_sel, *wait_sel;
};

// what the points phase needs of a group
struct Kept {
  long long rs, cs;
  bool hot;
};

// A lane's run: the lanes next to it that fold into the same rank r, from
// the run's head (its first lane) to end (one past its last). `lanes`, the
// warp's lanes that hold a group (a prefix of the warp), all call it.
struct Run {
  bool head;
  int end;
};

__device__ __forceinline__ Run run_of(long long r, unsigned lanes) {
  const int lane = threadIdx.x & 31;
  const long long prev = __shfl_up_sync(lanes, r, 1);
  const unsigned heads = __ballot_sync(lanes, lane == 0 || prev != r) | ~lanes;
  const unsigned later = lane == 31 ? 0u : heads & (~0u << (lane + 1));
  return {lane == 0 || prev != r, later ? __ffs(later) - 1 : 32};
}

// max of v over the lanes [lane, end) of this lane's run, by shuffles
// (the head's is the run's)
__device__ __forceinline__ u64 run_max(u64 v, int end, unsigned lanes) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const u64 o = __shfl_down_sync(lanes, v, off);
    if (lane + off < end && o > v) v = o;
  }
  return v;
}

// Adds a group's counts (one valid, hot or not) and key k to rank r. With
// `aggregate`, the head of each run of lanes on one rank adds the run's;
// without, every lane is a run of its own. Every lane of `lanes` calls it.
// Returns the lane's run.
__device__ __forceinline__ Run fold_into(u64* cnt, u64* key, long long r, bool hot, u64 k,
                                         unsigned lanes, bool aggregate) {
  if (!aggregate) {
    atomicAdd(&cnt[r], (1ULL << 32) | (hot ? 1ULL : 0ULL));
    if (k) atomicMax(&key[r], k);
    return {true, (int)(threadIdx.x & 31) + 1};
  }
  const Run run = run_of(r, lanes);
  const unsigned hots = __ballot_sync(lanes, hot);
  const u64 m = run_max(k, run.end, lanes);
  if (run.head) {
    const int lane = threadIdx.x & 31;
    const unsigned mine = (run.end == 32 ? ~0u : (1u << run.end) - 1) & (~0u << lane);
    atomicAdd(&cnt[r], ((u64)__popc(mine) << 32) | (u64)__popc(mine & hots));
    if (m) atomicMax(&key[r], m);
  }
  return run;
}

// The wait max of a group (k 0 where the group has no ring wait) into its
// source rank r, over the run fold_into returned for r.
__device__ __forceinline__ void wait_into(u64* key, long long r, u64 k, unsigned lanes,
                                          const Run& run) {
  if (!__ballot_sync(lanes, k != 0)) return;
  const u64 m = run_max(k, run.end, lanes);
  if (run.head && m) atomicMax(&key[r], m);
}

// The groups phase for group i (active: i < B * G); every lane of the warp calls it.
__device__ __forceinline__ Kept fold_group(const Args& a, long long i, bool active) {
  Kept kept{0, 0, false};
  u64 kd = 0, kw = 0;
  if (active) {
    const double z_d = (a.dmed[i] - a.cd[i]) / a.sd[i];
    const double z_w = (a.wmed[i] - a.cw[i]) / a.sw[i];
    a.zd[i] = z_d;
    a.zw[i] = z_w;
    const long long b = i / a.G;
    const long long key = a.gkey[b * a.group_bs + (i - b * a.G)];
    kept.rs = b * a.n + key / a.n;
    kept.cs = b * a.n + key % a.n;
    kept.hot = z_d > a.thr;
    kd = fold_key(z_d);
    if (z_w > a.thr && !kept.hot) kw = fold_key(z_w);  // ring wait over a healthy transfer
  }
  const unsigned lanes = __ballot_sync(FULL, active);
  if (active) {
    const Run row = fold_into(a.row_cnt, a.row_key, kept.rs, kept.hot, kd, lanes, true);
    fold_into(a.col_cnt, a.col_key, kept.cs, kept.hot, kd, lanes, false);
    wait_into(a.wait_key, kept.rs, kw, lanes, row);
  }
  return kept;
}

__device__ __forceinline__ unsigned char is_point(const Args& a, const Kept& k) {
  return (k.hot && !a.row_sel[k.rs] && !a.col_sel[k.cs]) ? 1 : 0;
}

// Phase 0: every rank's identities. Zeros: key 0 is -inf, counts 0.
__device__ __forceinline__ void fold_identities(const Args& a, long long tid,
                                                long long nthreads) {
  for (long long i = tid; i < a.B * a.n; i += nthreads) {
    a.row_key[i] = 0; a.col_key[i] = 0; a.wait_key[i] = 0;
    a.row_cnt[i] = 0; a.col_cnt[i] = 0;
  }
}

// Phase 1: every group's z and its folds into its ranks, a warp's lanes on
// consecutive groups; the thread's first KEEP groups are kept for phase 3.
__device__ __forceinline__ void fold_groups(const Args& a, long long tid, long long nthreads,
                                            Kept (&kept)[KEEP]) {
  const long long warp0 = tid - (threadIdx.x & 31);  // the first group of this warp's lanes
  const long long groups = a.B * a.G;
#pragma unroll
  for (int j = 0; j < KEEP; ++j) {
    const long long i = tid + j * nthreads;
    kept[j] = warp0 + j * nthreads < groups ? fold_group(a, i, i < groups) : Kept{0, 0, false};
  }
  for (long long w = warp0 + KEEP * nthreads; w < groups; w += nthreads)
    fold_group(a, w + (threadIdx.x & 31), w + (threadIdx.x & 31) < groups);
}

// Phase 2: every rank's counts split, its selections, its maxima decoded.
__device__ __forceinline__ void fold_ranks(const Args& a, long long tid, long long nthreads) {
  for (long long i = tid; i < a.B * a.n; i += nthreads) {
    const u64 rc = a.row_cnt[i], cc = a.col_cnt[i];
    const long long ro = (long long)(rc >> 32), rh = (long long)(rc & 0xffffffffULL);
    const long long co = (long long)(cc >> 32), ch = (long long)(cc & 0xffffffffULL);
    a.row_obs[i] = ro;
    a.col_obs[i] = co;
    reinterpret_cast<long long*>(a.row_cnt)[i] = rh;
    reinterpret_cast<long long*>(a.col_cnt)[i] = ch;
    a.row_sel[i] = (ro >= a.min_obs && (double)rh >= fmax(1.0, a.rcf * (double)ro) && rh >= 2);
    a.col_sel[i] = (co >= a.min_obs && (double)ch >= fmax(1.0, a.rcf * (double)co) && ch >= 2);
    const u64 wk = a.wait_key[i];
    a.wait_sel[i] = wk != 0;
    reinterpret_cast<double*>(a.row_key)[i] = from_fold_key(a.row_key[i]);
    reinterpret_cast<double*>(a.col_key)[i] = from_fold_key(a.col_key[i]);
    reinterpret_cast<double*>(a.wait_key)[i] = from_fold_key(wk);
  }
}

// Phase 3: every group's point. The thread's first `nkept` groups (at most
// KEEP) come from `kept`, in registers; the others read the key and zd again.
__device__ __forceinline__ void fold_points(const Args& a, long long tid, long long nthreads,
                                            const Kept (&kept)[KEEP], int nkept) {
  const long long groups = a.B * a.G;
#pragma unroll
  for (int j = 0; j < KEEP; ++j) {
    const long long i = tid + j * nthreads;
    if (j < nkept && i < groups) a.point[i] = is_point(a, kept[j]);
  }
  for (long long i = tid + nkept * nthreads; i < groups; i += nthreads) {
    const long long b = i / a.G;
    const long long key = a.gkey[b * a.group_bs + (i - b * a.G)];
    a.point[i] = is_point(a, Kept{b * a.n + key / a.n, b * a.n + key % a.n, a.zd[i] > a.thr});
  }
}

// The four phases in one cooperative launch, grid barriers between them
// (this_grid() at each: a grid_group held across the phases made ptxas
// spill the kept groups).
__global__ void __launch_bounds__(THREADS) fold_kernel(Args a) {
  const long long nthreads = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  fold_identities(a, tid, nthreads);
  cg::this_grid().sync();
  Kept kept[KEEP];
  fold_groups(a, tid, nthreads, kept);
  cg::this_grid().sync();
  fold_ranks(a, tid, nthreads);
  cg::this_grid().sync();
  fold_points(a, tid, nthreads, kept, KEEP);
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
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fold_kernel, THREADS, 0)))
      return err;
    d.resident = resident;
    d.cooperative = coop;
    d.sms = sms;
  }
  *out = &d;
  return cudaSuccess;
}

}  // namespace

// gkey (int64): (B or 1, G) at batch stride group_bs, each src * n + dst
// with src and dst in [0, n); dmed, wmed, cd, sd, cw, sw: (B, G) float64.
// Outputs, each a buffer of arrays one after another: z (zd, zw: 2 x (B, G)
// float64), scores (row_score, col_score, wait_score: 3 x (B, n) float64),
// counts (row_hot, row_obs, col_hot, col_obs: 4 x (B, n) int64), point
// ((B, G) bool) and sels (row_sel, col_sel, wait_sel: 3 x (B, n) bool).
// G < 2^32 (a rank's counts share a 64-bit word). Returns the CUDA error of
// the launch; a cooperative launch the card refuses is returned as it is,
// never replaced by another path.
extern "C" int slow_fold(const void* gkey, long long group_bs, const void* dmed,
                         const void* wmed, const void* cd, const void* sd, const void* cw,
                         const void* sw, long long B, long long G, double mad_threshold,
                         double row_col_fraction, long long min_observations, long long n,
                         void* z, void* scores, void* counts, void* point, void* sels,
                         void* stream) {
  if (B <= 0 || G < 0 || G >= (1LL << 32) || n <= 0) return (int)cudaErrorInvalidValue;
  DeviceInfo* info = nullptr;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return (int)err;
  const long long groups = B * G, ranks = B * n;
  Args a;
  a.gkey = static_cast<const long long*>(gkey);
  a.group_bs = group_bs;
  a.dmed = static_cast<const double*>(dmed);
  a.wmed = static_cast<const double*>(wmed);
  a.cd = static_cast<const double*>(cd);
  a.sd = static_cast<const double*>(sd);
  a.cw = static_cast<const double*>(cw);
  a.sw = static_cast<const double*>(sw);
  a.B = B; a.G = G; a.n = n; a.min_obs = min_observations;
  a.thr = mad_threshold; a.rcf = row_col_fraction;
  a.zd = static_cast<double*>(z);
  a.zw = a.zd + groups;
  a.row_key = static_cast<u64*>(scores);
  a.col_key = a.row_key + ranks;
  a.wait_key = a.row_key + 2 * ranks;
  a.row_cnt = static_cast<u64*>(counts);
  a.row_obs = reinterpret_cast<long long*>(a.row_cnt + ranks);
  a.col_cnt = a.row_cnt + 2 * ranks;
  a.col_obs = reinterpret_cast<long long*>(a.row_cnt + 3 * ranks);
  a.point = static_cast<unsigned char*>(point);
  a.row_sel = static_cast<unsigned char*>(sels);
  a.col_sel = a.row_sel + ranks;
  a.wait_sel = a.row_sel + 2 * ranks;

  // a thread a group or a rank, as far as the card holds every CTA at once
  const long long need = groups > ranks ? groups : ranks;
  long long grid = (need + THREADS - 1) / THREADS;
  const long long cap = (long long)info->resident * info->sms;
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!info->cooperative) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)fold_kernel, dim3((unsigned)grid),
                                    dim3(THREADS), params, 0, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
