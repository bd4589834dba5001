// Weighted max-min water-filling (C4P's flow model) for sm_90a (H100): the
// whole progressive-filling loop of FlowSet.max_min in one launch, each
// round touching only the links it changed.
//
// Replaces the XLA jit kernel of the JAX package
// src/repro/core/jaxsim/kernels.py::waterfill_kernel (with
// core/jaxsim/waterfill.py::waterfill_rates). The JAX kernel is held to
// NumPy by a tolerance; this one gives the NumPy loop's bits
// (src/repro_torch/core/flowset.py, FlowSet.max_min), for three reasons:
//  - np.bincount adds each bin's weights in input order, so a link's
//    unfrozen weight and its returned capacity are summed here serially, by
//    the one lane that owns the link, over the link's pairs in pair order
//    (the incidence by link: a stable sort of the pairs by link, made once
//    per incidence on the host). A frozen pair adds 0.0 in NumPy, which
//    leaves a sum of positive weights as it is, so it is skipped;
//  - every other step is one IEEE operation or an exact min or compare:
//    share = remaining / load where load > 0, else inf; m = min(share);
//    stop if m is not finite; every unfrozen flow with a pair on a link of
//    share == m freezes (ties together) at rate = m * w;
//    remaining = max(remaining - dec, 0). Built with --fmad=false;
//    double division is IEEE;
//  - the steps run in NumPy's order, round after round.
//
// What bounds it on the H100: not bytes (the incidence of the 10,240-GPU
// fabric is ~1.3 MB), but the rounds, one after another: a round needs the
// least share of the last. The first design (csrc/earlier/waterfill.cu)
// rescanned every link's pairs twice a round, each pair a chain of
// dependent L2 loads (pair -> flow stamp -> weight), so a round cost 8-26 us
// where its barriers cost 0.3. This design lets a round touch only what it
// changed, and keeps the state next to the SM:
//  - The rule. If no flow of a link froze in the last round, the link's
//    unfrozen terms are the same terms in the same order, so its load has
//    the same bits; its dec is 0.0, remaining - 0.0 is remaining and
//    max(remaining, 0.0) is remaining (never -0.0 or negative), so its share
//    is unchanged bit for bit. Only the links of the flows frozen in a round
//    are dirty.
//  - A round: (1) m, the least share: links are cut into chunks of 32, one
//    a lane of the warp that owns the chunk; each chunk keeps its least
//    share, each warp the least over its chunks, and m is the least over
//    the warps (over the CTAs' slots, in the grid). (2) The freeze: only
//    chunks whose minimum is m are looked at, and in them every link whose
//    share is m (a link that did not change can tie with m); each unfrozen
//    flow of such a link is frozen at m * w, stamp r, by an atomicCAS on its
//    stamp, and the thread that froze it marks the flow's links (the
//    incidence by flow: flow_ptr, flow_link) and their chunks dirty.
//    (3) The refresh: each dirty link alone recomputes dec, remaining, load
//    and share, in one pass over its pairs in pair order; each dirty chunk
//    its minimum, each warp that holds one its own. Two barriers a round.
//  - A round's dec needs the rates of the flows frozen in it: m * w, the
//    same product the freeze stored, so no rate is read back.
//
// Two variants, picked by the caller by size (kernels/waterfill.py), never
// by a failed launch; both give the same bits, since the owner of a link
// and the order of its pairs do not change with the variant:
//  - SMEM: one CTA of 512 threads, the whole state in shared memory:
//    share and remaining (16 B a link), weight and stamp (12 B a flow), both
//    incidences as int32, the dirty marks (8 B a link), the chunk minimums:
//    173,448 bytes at the C4P main path's balancer call (3,072 links, 2,560
//    flows, 7,168 pairs), 192,280 at the Fig. 2 fabric, up to the card's
//    opt-in limit a block (232,448 bytes on an H100; the launcher raises the
//    kernel's limit once a device and checks the call);
//  - GRID: the same loop over the state in device memory, for every
//    fabric whose state does not fit: a cooperative grid of a warp a chunk
//    (every CTA resident), with grid.sync() for the barriers and one slot a
//    CTA for the least share; its state is read and written through L2
//    (__ldcg/__stcg).
// waterfill_sync_probe times the barriers of the rounds alone, the floor of
// a round.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int SMEM_THREADS = 512;   // the SMEM variant
constexpr int GRID_THREADS = 256;   // a CTA of the grid variant
constexpr int MAX_BLOCKS = 1024;    // the grid's CTAs at most (kernels/waterfill.py: MAX_BLOCKS)
constexpr int CHUNK = 32;           // links a chunk, one a lane
constexpr int MAX_WARPS = 1024 / 32;   // a CTA's warps at most
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

enum Variant { GRID = 0, SMEM = 1 };

// The inputs as the caller gives them, both incidences int64
struct Args {
  const long long* link_ptr;    // (L + 1) offsets into link_flow
  const long long* link_flow;   // (P) the flow of each pair, a link's pairs in pair order
  const long long* flow_ptr;    // (F + 1) offsets into flow_link
  const long long* flow_link;   // (P) the link of each pair, by flow
  const double* w;              // (F) weights, floored at 1e-9
  const bool* alive;            // (F)
  const double* cap;            // (L) capacity after jitter
  double* rate;                 // (F) out
  double* remaining;            // (L) out
  long long* rounds;            // (1) out: rounds that froze a flow
  void* scratch;                // the GRID variant's state (scratch_bytes)
  long long F, L, P;
};

// The loop's state; I is the incidences' index type (int in shared memory,
// long long in device memory)
template <typename I>
struct State {
  const I* link_ptr;
  const I* link_flow;
  const I* flow_ptr;
  const I* flow_link;
  const double* w;
  double* rate;
  double* share;        // (L) remaining / load, inf where load is 0
  double* rem;          // (L) remaining capacity
  double* cmin;         // (chunks) the least share of each chunk
  double* wmin;         // (warps of the CTA, shared memory) the least over each warp's chunks
  double* block_min;    // (CTAs) GRID: the least over each CTA's warps
  int* stamp;           // (F) -1 unfrozen, -2 dead, else the round it froze in
  int* dirty_chunk;     // (chunks)
  int* dirty_link;      // (L)
  long long F, L, chunks;
};

// loads and stores of the state: through L2 in the grid (other CTAs write
// it), plain in one CTA (__syncthreads orders them)
template <bool G, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (G) return __ldcg(p);
  else return *p;
}
template <bool G, typename T>
__device__ __forceinline__ void st(T* p, T v) {
  if constexpr (G) __stcg(p, v);
  else *p = v;
}

__device__ __forceinline__ double dmin(double a, double b) { return b < a ? b : a; }

// The least share over the warp, in every lane. A share is +0.0 to +inf
// (remaining >= +0.0 over a positive load), never -0.0 or NaN, and such
// doubles order as their bits do as unsigned integers: two redux.sync
// minimums (the high words, then the low words of the lanes that hold the
// least high word) in place of five double shuffles.
__device__ __forceinline__ double warp_min(double v) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(v);
  const unsigned hi = __reduce_min_sync(FULL, (unsigned)(b >> 32));
  const unsigned lo = __reduce_min_sync(FULL, (unsigned)(b >> 32) == hi ? (unsigned)b : ~0u);
  return __longlong_as_double((long long)(((unsigned long long)hi << 32) | lo));
}

// the least of the shares v[0..n), in every lane of the warp
template <bool G>
__device__ __forceinline__ double least_of(const double* v, long long n) {
  double m = CUDART_INF;
#pragma unroll 4
  for (long long i = threadIdx.x & 31; i < n; i += 32) m = dmin(m, ld<G>(v + i));
  return warp_min(m);
}

template <bool G>
__device__ __forceinline__ void barrier() {
  if constexpr (G) cg::this_grid().sync();
  else __syncthreads();
}

// Link l after round r froze flows at m * w (stamp r): remaining less what
// they held, then the share over the flows still unfrozen, both sums taken
// serially in pair order from 0.0 in one pass. first: round 0's pass
// (remaining = capacity, r matches no stamp). Returns the share.
template <bool G, typename I>
__device__ __forceinline__ double refresh_link(const State<I>& s, long long l, int r, double m,
                                               const double* cap, bool first) {
  double dec = 0.0, load = 0.0;
  for (long long p = s.link_ptr[l], p1 = s.link_ptr[l + 1]; p < p1; ++p) {
    const long long f = s.link_flow[p];
    const int stamp = ld<G>(&s.stamp[f]);
    const double wf = s.w[f];
    if (stamp == r) dec += m * wf;
    else if (stamp == -1) load += wf;
  }
  double rem;
  if (first) {
    rem = cap[l];
  } else {
    rem = ld<G>(&s.rem[l]) - dec;
    rem = rem > 0.0 ? rem : 0.0;
  }
  st<G>(&s.rem[l], rem);
  const double share = load > 0.0 ? rem / load : CUDART_INF;
  st<G>(&s.share[l], share);
  return share;
}

// The refresh of this warp's chunks (c = gw, gw + nw, ...): each dirty link
// (every link on the first pass) by its lane, then each such chunk's least
// share; then, if a chunk changed, the warp's least over its chunks.
template <bool G, typename I>
__device__ __forceinline__ void refresh(const State<I>& s, int r, double m, const double* cap,
                                        bool first, long long gw, long long nw) {
  const int lane = threadIdx.x & 31;
  bool changed = first;
  for (long long base = gw; base < s.chunks; base += 32 * nw) {
    const long long mine = base + lane * nw;
    unsigned todo = __ballot_sync(
        FULL, mine < s.chunks && (first || ld<G>(&s.dirty_chunk[mine]) != 0));
    changed |= todo != 0;
    while (todo) {
      const long long c = base + (long long)(__ffs(todo) - 1) * nw;
      todo &= todo - 1;
      const long long l = c * CHUNK + lane;
      double sh = CUDART_INF;
      if (l < s.L) {
        if (first || ld<G>(&s.dirty_link[l]) != 0) {
          sh = refresh_link<G>(s, l, r, m, cap, first);
          st<G>(&s.dirty_link[l], 0);
        } else {
          sh = ld<G>(&s.share[l]);
        }
      }
      sh = warp_min(sh);
      if (lane == 0) {
        st<G>(&s.cmin[c], sh);
        st<G>(&s.dirty_chunk[c], 0);
      }
    }
  }
  if (changed) {   // the same in the whole warp
    __syncwarp();
    double v = CUDART_INF;
    for (long long c = gw + lane * nw; c < s.chunks; c += 32 * nw) v = dmin(v, ld<G>(&s.cmin[c]));
    v = warp_min(v);
    if (lane == 0) s.wmin[threadIdx.x >> 5] = v;
  }
}

// The freeze of round r at the least share m: on every link of share m (in
// the chunks of minimum m) each unfrozen flow gets rate m * w and stamp r;
// the thread whose atomicCAS froze a flow marks the flow's links and their
// chunks dirty. A flow on two tied links is frozen once.
template <bool G, typename I>
__device__ __forceinline__ void freeze(const State<I>& s, int r, double m, long long gw,
                                       long long nw) {
  const int lane = threadIdx.x & 31;
  for (long long base = gw; base < s.chunks; base += 32 * nw) {
    const long long mine = base + lane * nw;
    unsigned tied = __ballot_sync(FULL, mine < s.chunks && ld<G>(&s.cmin[mine]) == m);
    while (tied) {
      const long long c = base + (long long)(__ffs(tied) - 1) * nw;
      tied &= tied - 1;
      const long long l = c * CHUNK + lane;
      if (l >= s.L || ld<G>(&s.share[l]) != m) continue;
      for (long long p = s.link_ptr[l], p1 = s.link_ptr[l + 1]; p < p1; ++p) {
        const long long f = s.link_flow[p];
        if (atomicCAS(&s.stamp[f], -1, r) != -1) continue;
        s.rate[f] = m * s.w[f];
        for (long long q = s.flow_ptr[f], q1 = s.flow_ptr[f + 1]; q < q1; ++q) {
          const long long k = s.flow_link[q];
          st<G>(&s.dirty_link[k], 1);
          st<G>(&s.dirty_chunk[k / CHUNK], 1);
        }
      }
    }
  }
}

// The loop, rounds until the least share is not finite (or more rounds
// than flows, which a finite share never needs), on the cooperative grid
// (G) or one CTA. Returns the rounds.
template <bool G, typename I>
__device__ __forceinline__ int fill(const State<I>& s, const Args& a) {
  const long long wpb = blockDim.x >> 5;
  const long long nw = (long long)gridDim.x * wpb;
  const long long gw = (long long)blockIdx.x * wpb + (threadIdx.x >> 5);
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long f = tid; f < s.F; f += nthreads) {
    st<G>(&s.stamp[f], a.alive[f] ? -1 : -2);
    s.rate[f] = 0.0;
  }
  for (long long l = tid; l < s.L; l += nthreads) st<G>(&s.dirty_link[l], 0);
  for (long long c = tid; c < s.chunks; c += nthreads) st<G>(&s.dirty_chunk[c], 0);
  barrier<G>();
  refresh<G>(s, -3, 0.0, a.cap, true, gw, nw);
  int r = 0;
  for (;; ++r) {
    __syncthreads();
    double m;
    if constexpr (G) {
      if (threadIdx.x < 32) {
        const double v = least_of<false>(s.wmin, wpb);
        if (threadIdx.x == 0) __stcg(&s.block_min[blockIdx.x], v);
      }
      cg::this_grid().sync();
      m = least_of<true>(s.block_min, gridDim.x);
    } else {
      m = least_of<false>(s.wmin, wpb);
    }
    if (!isfinite(m) || r > s.F) break;
    freeze<G>(s, r, m, gw, nw);
    barrier<G>();
    refresh<G>(s, r, m, a.cap, false, gw, nw);
  }
  return r;
}

__host__ __device__ __forceinline__ long long chunks_of(long long L) {
  return (L + CHUNK - 1) / CHUNK;
}

// the SMEM variant's shared memory: doubles (warp minimums, share,
// remaining, weight, chunk minimums), then ints (stamp, both incidences,
// dirty chunks, dirty links)
long long smem_bytes(long long F, long long L, long long P) {
  const long long chunks = chunks_of(L);
  return 8 * (MAX_WARPS + 2 * L + F + chunks) +
         4 * (F + (L + 1) + P + (F + 1) + P + chunks + L);
}

// the GRID variant's device memory: share, chunk minimums, CTA slots, then
// stamp, dirty chunks, dirty links (remaining is the output)
long long scratch_bytes(long long F, long long L) {
  const long long chunks = chunks_of(L);
  return 8 * (L + chunks + MAX_BLOCKS) + 4 * (F + chunks + L);
}

__global__ void __launch_bounds__(SMEM_THREADS) waterfill_smem_kernel(Args a) {
  extern __shared__ double smem[];
  const long long F = a.F, L = a.L, P = a.P;
  State<int> s;
  s.F = F;
  s.L = L;
  s.chunks = chunks_of(L);
  s.wmin = smem;
  s.share = s.wmin + MAX_WARPS;
  s.rem = s.share + L;
  double* w = s.rem + L;
  s.cmin = w + F;
  int* ip = reinterpret_cast<int*>(s.cmin + s.chunks);
  s.stamp = ip;
  int* link_ptr = s.stamp + F;
  int* link_flow = link_ptr + L + 1;
  int* flow_ptr = link_flow + P;
  int* flow_link = flow_ptr + F + 1;
  s.dirty_chunk = flow_link + P;
  s.dirty_link = s.dirty_chunk + s.chunks;
  s.link_ptr = link_ptr;
  s.link_flow = link_flow;
  s.flow_ptr = flow_ptr;
  s.flow_link = flow_link;
  s.w = w;
  s.rate = a.rate;
  s.block_min = nullptr;
  for (long long i = threadIdx.x; i <= L; i += blockDim.x) link_ptr[i] = (int)a.link_ptr[i];
  for (long long i = threadIdx.x; i <= F; i += blockDim.x) flow_ptr[i] = (int)a.flow_ptr[i];
  for (long long i = threadIdx.x; i < P; i += blockDim.x) {
    link_flow[i] = (int)a.link_flow[i];
    flow_link[i] = (int)a.flow_link[i];
  }
  for (long long i = threadIdx.x; i < F; i += blockDim.x) w[i] = a.w[i];
  const int r = fill<false>(s, a);   // its first barrier orders the copies above
  // the loop ends right after a barrier, so every remaining is final
  for (long long l = threadIdx.x; l < L; l += blockDim.x) a.remaining[l] = s.rem[l];
  if (threadIdx.x == 0) *a.rounds = r;
}

template <bool G>
__device__ __forceinline__ void fill_in_device_memory(const Args& a) {
  __shared__ double wmin[MAX_WARPS];
  State<long long> s;
  s.F = a.F;
  s.L = a.L;
  s.chunks = chunks_of(a.L);
  s.link_ptr = a.link_ptr;
  s.link_flow = a.link_flow;
  s.flow_ptr = a.flow_ptr;
  s.flow_link = a.flow_link;
  s.w = a.w;
  s.rate = a.rate;
  s.rem = a.remaining;
  s.wmin = wmin;
  s.share = static_cast<double*>(a.scratch);
  s.cmin = s.share + a.L;
  s.block_min = s.cmin + s.chunks;
  s.stamp = reinterpret_cast<int*>(s.block_min + MAX_BLOCKS);
  s.dirty_chunk = s.stamp + a.F;
  s.dirty_link = s.dirty_chunk + s.chunks;
  const int r = fill<G>(s, a);
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.rounds = r;
}

__global__ void __launch_bounds__(GRID_THREADS) waterfill_grid_kernel(Args a) {
  fill_in_device_memory<true>(a);
}

// the barriers of `rounds` rounds and nothing else: a round's two, with the
// least over the warps' slots between them (and, in the grid, over the
// CTAs' slots); slots: MAX_BLOCKS + 1 float64
template <bool G>
__global__ void __launch_bounds__(G ? GRID_THREADS : SMEM_THREADS)
    sync_probe_kernel(long long rounds, double* slots) {
  __shared__ double wmin[MAX_WARPS];
  const long long wpb = blockDim.x >> 5;
  double m = 0.0;
  for (long long r = 0; r < rounds; ++r) {
    if ((threadIdx.x & 31) == 0) wmin[threadIdx.x >> 5] = m + 1.0;
    __syncthreads();
    if constexpr (G) {
      if (threadIdx.x < 32) {
        const double v = least_of<false>(wmin, wpb);
        if (threadIdx.x == 0) __stcg(&slots[blockIdx.x], v);
      }
      cg::this_grid().sync();
      m = least_of<true>(slots, gridDim.x);
    } else {
      m = least_of<false>(wmin, wpb);
    }
    barrier<G>();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) slots[MAX_BLOCKS] = m;
}

struct DeviceInfo {
  int sms = 0, resident = 0, cooperative = 0, smem_optin = 0;
  bool smem_set = false;
};

cudaError_t device_info(DeviceInfo** out) {
  static DeviceInfo info[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  DeviceInfo& d = info[dev];
  if (d.sms == 0) {
    int sms = 0, coop = 0, resident = 0, optin = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) ||
        (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, waterfill_grid_kernel,
                                                             GRID_THREADS, 0)))
      return err;
    d.resident = resident;
    d.cooperative = coop;
    d.smem_optin = optin;
    d.sms = sms;
  }
  *out = &d;
  return cudaSuccess;
}

// the grid variant's CTAs for L links: a warp a chunk, as far as the card
// holds every CTA at once
cudaError_t grid_blocks(long long L, long long* blocks) {
  DeviceInfo* info = nullptr;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  if (!info->cooperative) return cudaErrorCooperativeLaunchTooLarge;
  const long long warps = GRID_THREADS / 32;
  long long g = (chunks_of(L) + warps - 1) / warps;
  const long long cap = (long long)info->resident * info->sms;
  if (g > cap) g = cap;
  if (g > MAX_BLOCKS) g = MAX_BLOCKS;
  *blocks = g < 1 ? 1 : g;
  return cudaSuccess;
}

}  // namespace

// The shared memory the SMEM variant needs for F flows, L links and P
// pairs on the current device: its bytes, or 0 where that is above the
// card's opt-in limit a block; a negative CUDA error if the card cannot be
// asked.
extern "C" long long waterfill_smem_bytes(long long F, long long L, long long P) {
  DeviceInfo* info = nullptr;
  const cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return -(long long)err;
  const long long bytes = smem_bytes(F, L, P);
  return bytes <= info->smem_optin ? bytes : 0;
}

// The device-memory scratch the GRID variant needs, in bytes.
extern "C" long long waterfill_scratch_bytes(long long F, long long L) {
  return scratch_bytes(F, L);
}

// link_ptr (L + 1) and link_flow (P) int64: the incidence by link, each
// link's pairs in pair order; flow_ptr (F + 1) and flow_link (P) int64: the
// incidence by flow; w (F) float64, alive (F) bool, cap (L) float64.
// Outputs rate (F) and remaining (L) float64, rounds (1) int64; scratch of
// scratch_size bytes (waterfill_scratch_bytes; unused by SMEM). variant: 0
// GRID, 1 SMEM. F, L, P < 2^31. Returns the CUDA error of the launch;
// a variant the card cannot hold (SMEM above its shared memory, a
// cooperative grid it refuses) is returned as an error, never replaced by
// another variant.
extern "C" int waterfill(const void* link_ptr, const void* link_flow, const void* flow_ptr,
                         const void* flow_link, const void* w, const void* alive, const void* cap,
                         long long F, long long L, long long P, void* rate, void* remaining,
                         void* rounds, void* scratch, long long scratch_size, int variant,
                         void* stream) {
  const long long lim = 1LL << 31;
  if (F < 0 || L < 0 || P < 0 || F >= lim || L >= lim || P >= lim) return (int)cudaErrorInvalidValue;
  Args a;
  a.link_ptr = static_cast<const long long*>(link_ptr);
  a.link_flow = static_cast<const long long*>(link_flow);
  a.flow_ptr = static_cast<const long long*>(flow_ptr);
  a.flow_link = static_cast<const long long*>(flow_link);
  a.w = static_cast<const double*>(w);
  a.alive = static_cast<const bool*>(alive);
  a.cap = static_cast<const double*>(cap);
  a.rate = static_cast<double*>(rate);
  a.remaining = static_cast<double*>(remaining);
  a.rounds = static_cast<long long*>(rounds);
  a.scratch = scratch;
  a.F = F;
  a.L = L;
  a.P = P;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DeviceInfo* info = nullptr;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return (int)err;
  if (variant == SMEM) {
    const long long bytes = smem_bytes(F, L, P);
    if (bytes > info->smem_optin) return (int)cudaErrorInvalidValue;
    if (!info->smem_set) {
      err = cudaFuncSetAttribute(waterfill_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 info->smem_optin);
      if (err != cudaSuccess) return (int)err;
      info->smem_set = true;
    }
    waterfill_smem_kernel<<<1, SMEM_THREADS, (size_t)bytes, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (variant != GRID) return (int)cudaErrorInvalidValue;
  if (scratch_size < scratch_bytes(F, L)) return (int)cudaErrorInvalidValue;
  long long blocks = 0;
  err = grid_blocks(L, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)waterfill_grid_kernel, dim3((unsigned)blocks),
                                    dim3(GRID_THREADS), params, 0, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

// The barriers of `rounds` rounds of a variant (0 GRID, 1 SMEM) for L links,
// with no work between them (slots: MAX_BLOCKS + 1 float64).
// Returns the CUDA error of the launch.
extern "C" int waterfill_sync_probe(long long L, long long rounds, int variant, void* slots,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* out = static_cast<double*>(slots);
  if (variant != GRID) {
    sync_probe_kernel<false><<<1, SMEM_THREADS, 0, st>>>(rounds, out);
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
