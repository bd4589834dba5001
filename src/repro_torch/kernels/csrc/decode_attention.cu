// One-token GQA decode attention against a KV cache, for sm_90a (H100).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention_fwd (body _decode_kernel). Same function: the query of the
// token at position `pos` attends to cache keys k with k <= pos and, when
// window > 0, k > pos - window; optional tanh logit soft-cap; fp32 online
// softmax; bf16 or fp32 in and out.
//
// What bounds it on the H100: bytes. Every key in range is read once from K and
// once from V and used for a handful of FLOPs per byte. At gemma2-2b's decode
// (B=2, Hkv=4, D=256, ~4.4k keys, bf16) that is ~36 MB a launch (18 MB each of
// K and V): 10.4 us at 3.35 TB/s. What matters is keeping enough bytes in
// flight on every SM (Little's law: ~25 KB an SM at ~1 us of latency) and
// spending nothing around them. The TPU kernel walks the kv axis inside one
// grid cell per (batch, kv head): 8 cells for 132 SMs here.
//
// bf16 with head_dim 64, 112, 128, 160 or 256 and a group of up to 8 query
// heads a kv head (gemma2-2b: D=256, group 2; stablelm-12b: D=160, group 4;
// smollm-135m: D=64, group 3; zamba2-7b: D=112): decode_tma_kernel, one launch.
//  * A grid sized to the card. The key range [lo, pos] of each (batch, kv
//    head) is cut into nsplit runs of whole 64-key tiles, nsplit = min(tiles,
//    ceil(SPLITS_PER_SM * n_SM / (B * Hkv))); split i takes tiles
//    [i * n / nsplit, (i + 1) * n / nsplit), never none. At the serve shape
//    that is 8 x 33 CTAs of 1-3 tiles, two CTAs an SM, one wave (16 x 17 of
//    4-5 tiles at stablelm-12b's). Two CTAs share an SM where a warp keeps
//    state for at most 4 query heads (the instances G = 2 and 4); a group of
//    5 to 8 (G = 8) holds an SM alone. n_SM is read once with
//    cudaDeviceGetAttribute. kernels/ref.py::plan_splits mirrors
//    the plan, and the CPU tests hold its merge to the plain version.
//  * A TMA-fed ring. One producer thread keeps a ring of K and V tiles (64
//    keys x ceil(D / 64) boxes of 64 columns, 32 KB at D=256 and 24 KB at
//    160; 64 KB of ring: 2 slots at D=256 and 160, 4 at 128 and 112, 8 at
//    64) in flight under full and empty mbarriers. The tensor maps cover the
//    caches in place, (D, Hkv, S, B), so rows past S arrive as zeros and never
//    cross into the next batch, and a last box's columns past D (160..191,
//    112..127) arrive as zeros that cost no HBM bytes. Boxes of 64 columns
//    land in the 128-byte swizzle, so both read patterns below are free of
//    bank conflicts (at D=160, one score step in 5 reads two ways). Two CTAs share an
//    SM: ~128 KB in flight an SM, five times what Little's law asks. A ring
//    of 96 KB (3 slots at D=256) measured slower (kernels/ablate_decode.py).
//  * Consumers: 8 warps, each owning 8 keys of every tile and its own fp32
//    online softmax (max, sum, output) for every query head of the group,
//    so no warp waits on another inside the loop. All 8 take the tiles in
//    ring order: an mbarrier phase is only waited for by a warp that has
//    seen the phase before it. (Two warpgroups taking tiles in turn would
//    wait out of order, up to two phases ahead of a slot, where the parity
//    wait no longer tells phases apart.) Scores: four lanes a key, each
//    dotting a quarter of the K row, in 16-byte units rotated so that a
//    quarter-warp hits 8 bank groups, with the group's query rows, held in
//    shared memory as fp32 (each quarter shifted by 4 floats, for the same
//    reason); at D=112 the 14 units of a row are read as 16, the last two
//    zero in K and in q. PV: a lane owns a 16-byte unit of the V row (a
//    unit for 8 / KPI of the warp's keys, KPI = 32 / units of a row: 28 of
//    32 lanes at D=112) and the keys' weights come by __shfl_sync; CUDA
//    cores suffice at ~2 FLOP a byte. At D=160 a row is 20 units, which
//    would keep 12 lanes idle: there a lane owns 5 aligned 4-byte words (10
//    columns) for 4 of the warp's keys, the two halves of the warp on rows
//    4 apart, so every load of the warp hits 32 banks. The
//    loads of the next tiles are in flight under the work on this one, and
//    an SM's two CTAs overlap each other's scores and PV. Only the ragged
//    tiles at lo and pos are masked.
//  * The combine in the same launch. A CTA merges its 8 warps' states in
//    shared memory and writes its partial (max, sum, unnormalised output of
//    each query head) to scratch, then __threadfence and an atomicAdd on the
//    (batch, kv head)'s counter. The CTA that arrives last merges all splits
//    in split order (the maxima and sums staged in shared memory in one
//    round of loads, the outputs as float4 columns with the splits cut
//    into parts whose loads are issued together), writes O in bf16
//    and resets the counter to 0. The merge order is fixed, so two calls on
//    the same inputs are bit-equal. With one split the CTA writes O itself.
//    The wrapper keeps the scratch and counters per (device, stream).
//  * Exact tanhf for the cap and exp2f in log2 units: a tile has 64 scores
//    a query head, so neither is on the critical path of a bytes-bound kernel.
//
// Any other case (fp32 at any head dim; bf16 at a head dim not listed above,
// 320 and 576 among them): decode_partial_kernel, split-K over
// 128-key chunks on the CUDA cores (a lane a key in the score step, lanes
// across the head dim in the PV step), then decode_combine_kernel: two
// launches. Any cache length is taken; the ragged last chunk is masked. The
// head dim must be a multiple of 16 bytes' worth of elements (8 bf16, 4 fp32).
// Neither registers nor shared memory grow with the head dim: the scores
// are summed over Q 256 columns at a time (staged in shared memory), and the
// grid's z axis runs the PV product in passes of 256 output columns, each
// pass recomputing the scores over the whole head dim in the same order (so
// every pass finds the same max and sum; the first writes them).
// A group above 8 query heads a kv head is launched by the wrapper in passes
// of at most 8 (kernels/flash_attention.py::group_passes).
//
// Masked scores take the finite NEG_INF of the TPU kernel, not -inf, so that
// exp(NEG_INF - NEG_INF) = 1 and a later exp(NEG_INF - m) = 0 stay finite.
//
// Shard mode (decode_attention_shard_fwd): the cache holds the S keys at
// global positions k0 .. k0 + S - 1 of a longer cache cut over ranks, and the
// masks are those of the global positions: key j is valid where
// lo <= k0 + j <= pos. Both paths then run over the shard's valid range in
// local positions, [max(lo - k0, 0), min(pos - k0, S - 1)], so the split plan
// counts only the shard's valid tiles; with lse given, each query head's
// log-sum-exp of its valid (scaled, capped) scores and its output are written
// in float32, so that the shards' outputs are merged
// (kernels/ref.py::merge_shards) before they are rounded to the cache's
// dtype, once. A shard with no valid key (all past pos, or all before lo)
// launches decode_empty_kernel: O = 0 and lse = NEG_INF. k0 = 0 without lse
// is the whole-cache call, decode_attention_fwd.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"  // tensor maps, TMA loads and mbarriers

namespace {

constexpr float NEG_INF = -2.3819763e38f;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = WARPS * 32;             // keys per block in pass 1
constexpr int MAXG = 8;                       // query heads per kv head
constexpr int MAXD = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes at p (16-byte aligned) as floats: 4 for fp32, 8 for bf16
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// NV: 16-byte loads a lane makes per V row (1, or 2 for fp32 with D > 128).
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, float* __restrict__ part_m,
                      float* __restrict__ part_l, float* __restrict__ part_acc, int S,
                      int H, int Hkv, int D, int pos, int lo, int split0, int nsplit,
                      float scale, float cap) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ __align__(16) float Qs[MAXG * MAXD];
  __shared__ float w_m[WARPS][MAXG];
  __shared__ float w_l[WARPS][MAXG];
  __shared__ float w_acc[WARPS][MAXG][MAXD];

  const int group = H / Hkv;
  const int split = split0 + blockIdx.x;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int c0 = blockIdx.z * MAXD;              // this pass's output columns
  const int Dv = min(MAXD, D - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  float m[MAXG], l[MAXG], s[MAXG], acc[MAXG][NV * VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
    s[g] = 0.f;
#pragma unroll
    for (int e = 0; e < NV * VEC; ++e) acc[g][e] = 0.f;
  }

  const long long hs = (long long)Hkv * D;   // elements between cache positions
  const T* kbase = kc + ((long long)b * S * Hkv + kvh) * D;
  const T* vbase = vc + ((long long)b * S * Hkv + kvh) * D + c0;
  const int t0 = split * CHUNK + warp * 32;
  const bool active = t0 <= pos && t0 + 31 >= lo;   // the same in the whole warp
  const int key = t0 + lane;
  const bool ok = active && key >= lo && key <= pos;   // pos < S: a valid key is in the cache

  // scores over the head dim, Q staged 256 columns at a time (the group's
  // query rows are contiguous in q (B,1,H,D))
  const T* qg = q + ((long long)b * H + kvh * group) * D;
  for (int d0 = 0; d0 < D; d0 += MAXD) {
    const int dw = min(MAXD, D - d0);
    if (d0 > 0) __syncthreads();               // the previous columns are consumed
    for (int idx = tid; idx < group * dw; idx += THREADS)
      Qs[idx] = to_f32(qg[(idx / dw) * D + d0 + idx % dw]);
    __syncthreads();
    if (ok) {
      const T* krow = kbase + key * hs + d0;
      for (int c = 0; c < dw; c += VEC) {
        float kx[VEC];
        load16(krow + c, kx);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= group) break;
          const float4* qv = reinterpret_cast<const float4*>(Qs + g * dw + c);
#pragma unroll
          for (int e4 = 0; e4 < VEC / 4; ++e4) {
            const float4 qx = qv[e4];
            s[g] += qx.x * kx[4 * e4] + qx.y * kx[4 * e4 + 1] +
                    qx.z * kx[4 * e4 + 2] + qx.w * kx[4 * e4 + 3];
          }
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= group) break;
      float x = s[g] * scale;
      if (cap > 0.f) x = tanhf(x / cap) * cap;
      x = ok ? x : NEG_INF;
      m[g] = warp_max(x);
      s[g] = expf(x - m[g]);
      l[g] = warp_sum(s[g]);
    }

    const int k_lo = max(t0, lo) - t0, k_hi = min(t0 + 31, pos) - t0;
    for (int kk = k_lo; kk <= k_hi; ++kk) {
      const T* vrow = vbase + (t0 + kk) * hs;
      float vx[NV * VEC];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = (j * 32 + lane) * VEC;
        if (c < Dv) {
          load16(vrow + c, vx + j * VEC);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) vx[j * VEC + e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= group) break;
        const float pk = __shfl_sync(FULL, s[g], kk);
#pragma unroll
        for (int e = 0; e < NV * VEC; ++e) acc[g][e] += pk * vx[e];
      }
    }
  }

  // merge the 4 warps: a warp that took no keys has (NEG_INF, 0, 0)
  for (int g = 0; g < group; ++g) {
    if (lane == 0) { w_m[warp][g] = m[g]; w_l[warp][g] = l[g]; }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * 32 + lane) * VEC;
      if (c < Dv) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) w_acc[warp][g][c + e] = acc[g][j * VEC + e];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < group * Dv; idx += THREADS) {
    const int g = idx / Dv, d = idx % Dv;
    float mb = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, w_m[w][g]);
    float a = 0.f, lb = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(w_m[w][g] - mb);
      a += w_acc[w][g][d] * f;
      lb += w_l[w][g] * f;
    }
    const long long slot = ((long long)b * H + kvh * group + g) * nsplit + (split - split0);
    part_acc[slot * D + c0 + d] = a;
    if (c0 + d == 0) { part_m[slot] = mb; part_l[slot] = lb; }
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ o, float* __restrict__ lse, int D,
                                      int nsplit) {
  const long long row = blockIdx.x;            // b * H + h
  const float* pm = part_m + row * nsplit;
  const float* pl = part_l + row * nsplit;
  float mx = NEG_INF;
  for (int i = 0; i < nsplit; ++i) mx = fmaxf(mx, pm[i]);
  float lsum = 0.f;
  for (int i = 0; i < nsplit; ++i) lsum += pl[i] * expf(pm[i] - mx);
  if (lse != nullptr && threadIdx.x == 0) lse[row] = mx + logf(lsum);
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < nsplit; ++i) a += part_acc[(row * nsplit + i) * D + d] * expf(pm[i] - mx);
    store(o + row * D + d, a * inv);
  }
}

// a shard with no valid key: O = 0 and lse = NEG_INF (float32, shard mode)
__global__ void decode_empty_kernel(float* __restrict__ o, float* __restrict__ lse, long long n,
                                    int rows) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    o[i] = 0.f;
    if (i < rows) lse[i] = NEG_INF;
  }
}

// ---------------------------------------------------------------------------
// bf16, head_dim 64/112/128/160/256: TMA ring, split sized to the card, fused combine
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int TK = 64;                        // keys of a tile
constexpr int SPLITS_PER_SM = 2;              // CTAs of each (batch, kv head) per SM / (B * Hkv)
constexpr int RING_BYTES = 64 * 1024;         // K and V tiles in flight, a CTA
constexpr bool FUSED_COMBINE = true;          // the last CTA of a (batch, kv head) merges
constexpr int CWARPS = 8;                     // consumer warps, each on every tile
constexpr int CTHREADS = CWARPS * 32;
constexpr int TMA_THREADS = CTHREADS + 32;    // and a producer warp

// Shared memory of one CTA, in bytes from a 1024-aligned base. A tile slot is
// ceil(D / 64) boxes of 64 rows x 128 bytes, the last zero past D. After the
// last tile the ring holds the warps' outputs for the CTA's merge, then the
// last CTA's merge of the splits.
template <int D, int G>
struct DSmem {
  static_assert(D % 16 == 0 && D >= 64 && D <= 256, "head_dim: a multiple of 16 in 64..256");
  static constexpr int NCH = (D + TMA_BOX_COLS - 1) / TMA_BOX_COLS;   // boxes of a row
  static constexpr int TILE = NCH * TK * 128;
  static constexpr int NS = RING_BYTES / TILE < 8 ? RING_BYTES / TILE : 8;  // ring slots
  static constexpr int UPR = D / 8;           // 16-byte units of a row
  static constexpr int SU = (UPR + 3) / 4 * 4;   // units the score step reads: 4 equal quarters
  static constexpr int QSTR = SU * 8 + 16;    // floats of a query row
  static constexpr int Q = NS * TILE;
  static constexpr int WM = Q + G * QSTR * 4; // each warp's max of each head, then its factor
  static constexpr int WL = WM + CWARPS * G * 4;
  static constexpr int CM = WL + CWARPS * G * 4;   // the CTA's max and sum of each head
  static constexpr int CL = CM + G * 4;
  static constexpr int FLAG = CL + G * 4;
  static constexpr int BAR = (FLAG + 4 + 7) / 8 * 8;  // full, then empty, of each slot
  static constexpr int BYTES = BAR + 16 * NS + 1024;
  static_assert(CWARPS * G * D * 4 <= NS * TILE, "the warps' outputs must fit in the ring");
};

// the 256 consumer threads only (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CTHREADS) : "memory");
}

// 8 bf16 (16 bytes) as floats: a bf16 is the high half of its float
__device__ __forceinline__ void unpack8(const uint4 u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Shared memory merge_splits needs: the splits' (max, sum) pairs, a factor
// a split and a sum a head, and the parts' output sums
__host__ __device__ constexpr int merge_red_offset(int n) { return (8 * n + 4 * MAXG + 15) / 16 * 16; }
__host__ __device__ constexpr int merge_smem_bytes(int nsplit, int group, int D) {
  return merge_red_offset(nsplit * group) + (group * D / 4 > CTHREADS ? 0 : 16 * CTHREADS);
}

// four output columns from their sums a and 1 / (sum of weights): bf16, or
// float32 in shard mode (lse given)
__device__ __forceinline__ void store4(void* o, long long at, float4 a, float inv, bool f32) {
  if (f32) {
    *reinterpret_cast<float4*>(static_cast<float*>(o) + at) =
        make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
  } else {
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(o) + at);
    dst[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
    dst[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
  }
}

// Merge the partials of every split of (batch, kv head) bkv in split order,
// by the 256 threads of a block. The splits' (max, sum) pairs go to shared
// memory in one round of loads; a warp a head then takes the largest max,
// each split's factor and the sum of the head, lane by split and in a fixed
// butterfly. The outputs are read as float4 columns, the splits cut into as
// many parts as the threads allow, each part's loads issued together, and
// the parts summed in order. Every step runs in one order whatever CTA
// merges, so repeats are bit-equal. Partials are read through L2 (__ldcg):
// other CTAs wrote them in this launch.
template <int D>
__device__ void merge_splits(const float* __restrict__ part_acc,
                             const float* __restrict__ part_ml, void* __restrict__ o,
                             float* __restrict__ lse, uint8_t* smem, int bkv, int nsplit,
                             int group, int H, int Hkv, int tid) {
  const int n = nsplit * group;                     // partial rows: split-major
  float2* sml = reinterpret_cast<float2*>(smem);    // (max, sum), then (factor, sum)
  float* sl = reinterpret_cast<float*>(smem + 8 * n);
  float4* red = reinterpret_cast<float4*>(smem + merge_red_offset(n));
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + (long long)bkv * n;
  for (int i = tid; i < n; i += CTHREADS) sml[i] = __ldcg(ml + i);
  consumer_sync();
  const int warp = tid / 32, lane = tid % 32;
  if (warp < group) {
    float mx = NEG_INF;
    for (int s = lane; s < nsplit; s += 32) mx = fmaxf(mx, sml[s * group + warp].x);
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = lane; s < nsplit; s += 32) {
      float2& e = sml[s * group + warp];
      e.x = exp2f(e.x - mx);
      l += e.y * e.x;
    }
    l = warp_sum(l);
    if (lane == 0) sl[warp] = l;
    if (lse != nullptr && lane == 0)   // natural log: the scores are in log2 units
      lse[(long long)(bkv / Hkv) * H + (bkv % Hkv) * group + warp] = (mx + log2f(l)) * LN2;
  }
  consumer_sync();
  const int cols = group * D / 4;                   // float4 columns of the output rows
  const int parts = cols >= CTHREADS ? 1 : CTHREADS / cols;
  const float4* pa = reinterpret_cast<const float4*>(part_acc + (long long)bkv * n * D);
  const long long ob = ((long long)(bkv / Hkv) * H + (bkv % Hkv) * group) * D;
  const int part = tid / cols;
  for (int col = tid % cols; part < parts && col < cols; col += CTHREADS) {
    const int g = col * 4 / D;
    const int s0 = part * nsplit / parts, s1 = (part + 1) * nsplit / parts;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = s0; s < s1; ++s) {
      const float4 x = __ldcg(pa + (long long)s * cols + col);
      const float f = sml[s * group + g].x;
      a.x += x.x * f; a.y += x.y * f; a.z += x.z * f; a.w += x.w * f;
    }
    if (parts == 1)
      store4(o, ob + col * 4, a, 1.f / sl[g], lse != nullptr);
    else
      red[part * cols + col] = a;
  }
  if (parts == 1) return;
  consumer_sync();
  for (int col = tid; col < cols; col += CTHREADS) {
    float4 a = red[col];
    for (int p = 1; p < parts; ++p) {
      const float4 x = red[p * cols + col];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    }
    store4(o, ob + col * 4, a, 1.f / sl[col * 4 / D], lse != nullptr);
  }
}

// G: query heads a warp keeps state for (2, 4 for a group of 3 or 4, 8 for
// 5 to 8); up to 4, two CTAs an SM
template <int D, int G>
__global__ void __launch_bounds__(TMA_THREADS, G <= 4 ? 2 : 1)
decode_tma_kernel(const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ q,
                  void* __restrict__ o, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int* __restrict__ counters,
                  float* __restrict__ lse, int H, int Hkv,
                  int pos, int lo, int t_begin, int n_tiles, int nsplit, float pre,
                  float post, int capped) {
  using L = DSmem<D, G>;
  constexpr int NS = L::NS;
  constexpr int NCH = L::NCH;                // boxes of a row
  constexpr int BOX = TK * 128;              // bytes of a box
  constexpr int UPR = L::UPR;                // 16-byte units of a row
  constexpr int QU = L::SU / 4;              // units of a quarter in the score step
  constexpr int SD = L::SU * 8;              // columns the score step reads (zero past D)
  // PV by 16-byte units: KPI rows a warp reads at once (the warp's 8 keys in
  // 8 / KPI steps), UPR * KPI lanes busy. Where that leaves a fifth of the
  // lanes idle and a row is whole 4-byte words for 16 lanes (D=160), PV by
  // words: a lane WPL words of 4 of the warp's keys.
  constexpr int KPI = 32 / UPR == 3 ? 2 : 32 / UPR;
  constexpr bool WORDS = 5 * UPR * KPI < 4 * 32 && D % 32 == 0;
  constexpr int WPL = D / 32;                // words of a lane (WORDS)
  constexpr int ACC = WORDS ? 2 * WPL : 8;   // output columns of a lane
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw));
  const uint32_t base = smem_u32(sm);
  const uint32_t full = base + L::BAR, empty = full + 8 * NS;
  float* qs = reinterpret_cast<float*>(sm + L::Q);
  float* wm = reinterpret_cast<float*>(sm + L::WM);
  float* wl = reinterpret_cast<float*>(sm + L::WL);
  float* cm = reinterpret_cast<float*>(sm + L::CM);
  float* cl = reinterpret_cast<float*>(sm + L::CL);
  int* flag = reinterpret_cast<int*>(sm + L::FLAG);

  const int group = H / Hkv;
  const int bkv = blockIdx.y, b = bkv / Hkv, kvh = bkv % Hkv;
  const int split = blockIdx.x;
  const int i0 = (int)((long long)split * n_tiles / nsplit);   // this split's tiles
  const int n_local = (int)((long long)(split + 1) * n_tiles / nsplit) - i0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == CTHREADS) {   // the producer: fetch both tensor maps early
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&kmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&vmap)) : "memory");
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CWARPS);      // every consumer warp reads every tile
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CWARPS) {
    // producer: K and V of each tile in turn; ring item n is tile n / 2
    if (lane == 0) {
      for (int n = 0; n < 2 * n_local; ++n) {
        const int slot = n % NS;
        mbar_wait(empty + 8 * slot, ((n / NS) & 1) ^ 1);
        mbar_expect_tx(full + 8 * slot, L::TILE);
        const CUtensorMap* map = (n & 1) ? &vmap : &kmap;
        const int t0 = (t_begin + i0 + n / 2) * TK;   // keys past S arrive as zeros
        for (int c = 0; c < NCH; ++c)
          tma_load(base + slot * L::TILE + c * BOX, map, full + 8 * slot, c * TMA_BOX_COLS,
                   kvh, t0, b);
      }
    }
    return;
  }

  // the group's query rows in fp32; each quarter of a row 4 floats after
  // the one before, so that the 4 quarters a quarter-warp reads lie in
  // other banks
  const int tid = threadIdx.x;
  const bf16* qg = q + ((long long)b * H + kvh * group) * D;
  for (int idx = tid; idx < G * SD; idx += CTHREADS) {
    const int g = idx / SD, d = idx % SD;
    qs[g * L::QSTR + d + 4 * (d / (SD / 4))] =
        g < group && d < D ? __bfloat162float(qg[g * D + d]) : 0.f;
  }
  consumer_sync();

  // scores: 4 lanes a key, each a quarter of the row, rotated so that a
  // quarter-warp (2 keys x 4 quarters) reads 8 distinct 16-byte bank groups
  // of K and of q (QU = 5: 6 reads where 5 would do, the fewest any order
  // gets); PV: a lane a 16-byte unit of the V row, or WPL words of it
  const int r = warp * 8 + lane / 4, qq = lane & 3;
  const int unit = lane % UPR, sub = lane / UPR;
  const int wsub = lane / 16, wbyte = 4 * WPL * (lane % 16);   // WORDS: keys, first byte
  const int rot = QU % 2 ? (QU - 1) * (qq & 1) : 2 * (qq / (8 / QU));
  float m[G], l[G], acc[G][ACC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < ACC; ++e) acc[g][e] = 0.f;
  }

  for (int j = 0; j < n_local; ++j) {
    const int t0 = (t_begin + i0 + j) * TK;
    const int sk = (2 * j) % NS, sv = (2 * j + 1) % NS;
    mbar_wait(full + 8 * sk, ((2 * j) / NS) & 1);
    const uint8_t* kt = sm + sk * L::TILE + r * 128;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll
    for (int u = 0; u < QU; ++u) {
      const int jj = qq * QU + (u + rot) % QU;              // unit of the row
      float kx[8];
      unpack8(*reinterpret_cast<const uint4*>(kt + (jj / 8) * BOX + ((jj % 8) ^ (r % 8)) * 16), kx);
      const float* qrow = qs + jj * 8 + 4 * qq;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < group) {
          const float4 a = *reinterpret_cast<const float4*>(qrow + g * L::QSTR);
          const float4 c = *reinterpret_cast<const float4*>(qrow + g * L::QSTR + 4);
          s[g] += a.x * kx[0] + a.y * kx[1] + a.z * kx[2] + a.w * kx[3] +
                  c.x * kx[4] + c.y * kx[5] + c.z * kx[6] + c.w * kx[7];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * sk);

    // online softmax over the warp's 8 keys, in log2 units; lanes 4k..4k+3
    // hold key k, so the reductions over keys skip xor 1 and 2
    const int key = t0 + r;
    const bool edge = t0 < lo || t0 + TK - 1 > pos;
    float p[G], corr[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      p[g] = 0.f;
      corr[g] = 1.f;
      if (g < group) {
        float x = s[g] + __shfl_xor_sync(FULL, s[g], 1);
        x += __shfl_xor_sync(FULL, x, 2);
        x = capped ? tanhf(x * pre) * post : x * pre;
        if (edge && (key < lo || key > pos)) x = NEG_INF;
        float mx = x;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float m_new = fmaxf(m[g], mx);
        corr[g] = exp2f(m[g] - m_new);
        p[g] = exp2f(x - m_new);
        float sum = p[g];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(FULL, sum, off);
        l[g] = l[g] * corr[g] + sum;
        m[g] = m_new;
      }
    }

    mbar_wait(full + 8 * sv, ((2 * j + 1) / NS) & 1);
    const uint8_t* vt = sm + sv * L::TILE;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < ACC; ++e) acc[g][e] *= corr[g];
    if constexpr (WORDS) {
      // the halves of the warp on rows 4 apart: their swizzles differ by 4
      // groups, so that the 16 lanes' words of each half fill the other 16 banks
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int rl = 4 * wsub + kk, rr = warp * 8 + rl;
        float vx[ACC];
#pragma unroll
        for (int w = 0; w < WPL; ++w) {
          const int byte = wbyte + 4 * w;
          const uint32_t x = *reinterpret_cast<const uint32_t*>(
              vt + (byte / 128) * BOX + rr * 128 + (((byte / 16) % 8) ^ (rr % 8)) * 16 + byte % 16);
          vx[2 * w] = __uint_as_float(x << 16);
          vx[2 * w + 1] = __uint_as_float(x & 0xffff0000u);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < group) {
            const float pk = __shfl_sync(FULL, p[g], 4 * rl);
#pragma unroll
            for (int e = 0; e < ACC; ++e) acc[g][e] += pk * vx[e];
          }
        }
      }
    } else {
      const bool busy = UPR * KPI == 32 || sub < KPI;   // D=112: lanes 28..31 idle
#pragma unroll
      for (int kk = 0; kk < 8 / KPI; ++kk) {
        const int rl = kk * KPI + sub, rr = warp * 8 + rl;
        float vx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (busy)
          unpack8(*reinterpret_cast<const uint4*>(vt + (unit / 8) * BOX + rr * 128 +
                                                  ((unit % 8) ^ (rr % 8)) * 16), vx);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < group) {
            const float pk = __shfl_sync(FULL, p[g], 4 * rl);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] += pk * vx[e];
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * sv);
  }

  // merge the 8 warps: lanes sharing columns first (lane + UPR, + 2 UPR ...
  // into the lanes of sub 0, in a fixed order; WORDS: lane + 16), then
  // through shared memory over the idle ring (every load issued has been
  // waited for)
#pragma unroll
  for (int off = WORDS ? 16 : UPR; off < (WORDS ? 32 : UPR * KPI); off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < ACC; ++e) acc[g][e] += __shfl_down_sync(FULL, acc[g][e], off);
  float* macc = reinterpret_cast<float*>(sm);              // [warp][G][D]
  consumer_sync();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= group) break;
    if (WORDS && wsub == 0) {
      float2* dst = reinterpret_cast<float2*>(macc + (warp * G + g) * D + wbyte / 2);
#pragma unroll
      for (int w = 0; w < WPL; ++w) dst[w] = make_float2(acc[g][2 * w], acc[g][2 * w + 1]);
    } else if (!WORDS && sub == 0) {
      float4* dst = reinterpret_cast<float4*>(macc + (warp * G + g) * D + unit * 8);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l[g];
    }
  }
  consumer_sync();
  if (tid < group) {
    float mx = NEG_INF, sum = 0.f;
    for (int w = 0; w < CWARPS; ++w) mx = fmaxf(mx, wm[w * G + tid]);
    for (int w = 0; w < CWARPS; ++w) {
      const float f = exp2f(wm[w * G + tid] - mx);
      wm[w * G + tid] = f;
      sum += wl[w * G + tid] * f;
    }
    cm[tid] = mx;
    cl[tid] = sum;
  }
  consumer_sync();
  const long long row0 = ((long long)bkv * nsplit + split) * group;   // this partial's rows
  for (int idx = tid; idx < group * D; idx += CTHREADS) {
    const int g = idx / D, d = idx % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) a += macc[(w * G + g) * D + d] * wm[w * G + g];
    const long long at = ((long long)b * H + kvh * group) * D + idx;
    if (nsplit == 1 && lse != nullptr)
      static_cast<float*>(o)[at] = a / cl[g];
    else if (nsplit == 1)
      static_cast<bf16*>(o)[at] = __float2bfloat16(a / cl[g]);
    else
      part_acc[row0 * D + idx] = a;
  }
  if (nsplit == 1) {
    if (lse != nullptr && tid < group)
      lse[(long long)b * H + kvh * group + tid] = (cm[tid] + log2f(cl[tid])) * LN2;
    return;
  }
  if (tid < group) {
    part_ml[(row0 + tid) * 2] = cm[tid];
    part_ml[(row0 + tid) * 2 + 1] = cl[tid];
  }
  if (!FUSED_COMBINE) return;
  __threadfence();                                          // partial visible, then count it
  consumer_sync();
  if (tid == 0) *flag = atomicAdd(counters + bkv, 1) == nsplit - 1;
  consumer_sync();
  if (!*flag) return;
  __threadfence();
  merge_splits<D>(part_acc, part_ml, o, lse, sm, bkv, nsplit, group, H, Hkv, tid);   // over the ring
  if (tid == 0) counters[bkv] = 0;                          // ready for the next launch
}

// the combine as a second launch (FUSED_COMBINE false; kernels/ablate_decode.py)
template <int D>
__global__ void __launch_bounds__(CTHREADS)
decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                    void* __restrict__ o, float* __restrict__ lse, int nsplit, int H, int Hkv) {
  extern __shared__ uint8_t msm[];
  merge_splits<D>(part_acc, part_ml, o, lse, msm, blockIdx.x, nsplit, H / Hkv, H, Hkv,
                  threadIdx.x);
}

template <typename T, int NV>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* o, float* lse, float* pm,
                   float* pl, float* pa, int B, int S, int H, int Hkv, int D, int lo, int pos,
                   float scale, float cap, cudaStream_t stream) {
  const int split0 = lo / CHUNK;
  const int nsplit = pos / CHUNK - split0 + 1;
  const unsigned passes = (unsigned)((D + MAXD - 1) / MAXD);
  decode_partial_kernel<T, NV><<<dim3(nsplit, B * Hkv, passes), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), pm, pl,
      pa, S, H, Hkv, D, pos, lo, split0, nsplit, scale, cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (lse != nullptr)   // shard mode: the output in float32
    decode_combine_kernel<float><<<B * H, 128, 0, stream>>>(pm, pl, pa, static_cast<float*>(o),
                                                            lse, D, nsplit);
  else
    decode_combine_kernel<T><<<B * H, 128, 0, stream>>>(pm, pl, pa, static_cast<T*>(o), nullptr,
                                                        D, nsplit);
  return cudaGetLastError();
}

// SMs of the current device, read once per device
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 0;
  return counts[dev];
}

// splits of each (batch, kv head) over n_tiles 64-key tiles (ref.plan_splits)
int plan_nsplit(int n_tiles, int B, int Hkv, int n_sm) {
  const int want = (SPLITS_PER_SM * n_sm + B * Hkv - 1) / (B * Hkv);
  return max(1, min(n_tiles, want));
}

bool tma_path(int dtype, int D, int group) {
  return dtype == 1 && (D == 64 || D == 112 || D == 128 || D == 160 || D == 256) &&
         group <= MAXG;
}

template <int D, int G>
cudaError_t launch_tma(const void* q, const void* kc, const void* vc, void* o, float* scratch,
                       int* counters, float* lse, int B, int S, int H, int Hkv, int lo, int pos,
                       float scale, float cap, cudaStream_t stream) {
  using L = DSmem<D, G>;
  const int t_begin = lo / TK, n_tiles = pos / TK - t_begin + 1;
  const int n_sm = sm_count();
  if (n_sm <= 0) return cudaErrorNoDevice;
  const int nsplit = plan_nsplit(n_tiles, B, Hkv, n_sm);
  const int merge_bytes = merge_smem_bytes(nsplit, H / Hkv, D);
  if (merge_bytes > L::NS * L::TILE) return cudaErrorInvalidValue;   // the last CTA's, in the ring
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap km, vm;
  if (!make_map(enc, &km, kc, B, S, Hkv, D, 1, TK) || !make_map(enc, &vm, vc, B, S, Hkv, D, 1, TK))
    return cudaErrorInvalidValue;
  auto kern = decode_tma_kernel<D, G>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::BYTES);
  if (err == cudaSuccess)   // all of L1 that can be shared memory: two CTAs an SM
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  float* part_acc = scratch;
  float* part_ml = scratch + (long long)B * H * nsplit * D;
  const bool capped = cap > 0.f;
  const float LOG2E = 1.4426950408889634f;
  kern<<<dim3(nsplit, B * Hkv), TMA_THREADS, L::BYTES, stream>>>(
      km, vm, static_cast<const bf16*>(q), o, part_acc, part_ml, counters, lse,
      H, Hkv, pos, lo, t_begin, n_tiles, nsplit, capped ? scale / cap : scale * LOG2E,
      capped ? cap * LOG2E : 1.f, capped ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess || FUSED_COMBINE || nsplit == 1) return err;
  decode_merge_kernel<D><<<B * Hkv, CTHREADS, merge_bytes, stream>>>(
      part_acc, part_ml, o, lse, nsplit, H, Hkv);
  return cudaGetLastError();
}

// the instance that keeps state for the fewest heads the group needs: a
// group of 3 or 4 (stablelm-12b's, smollm-135m's) on the 4-head one, two
// CTAs an SM, not the 8-head one, which holds an SM alone
template <int D>
cudaError_t launch_tma_g(const void* q, const void* kc, const void* vc, void* o, float* scratch,
                         int* counters, float* lse, int B, int S, int H, int Hkv, int lo,
                         int pos, float scale, float cap, cudaStream_t stream) {
  const int group = H / Hkv;
  if (group <= 2)
    return launch_tma<D, 2>(q, kc, vc, o, scratch, counters, lse, B, S, H, Hkv, lo, pos, scale,
                            cap, stream);
  if (group <= 4)
    return launch_tma<D, 4>(q, kc, vc, o, scratch, counters, lse, B, S, H, Hkv, lo, pos, scale,
                            cap, stream);
  return launch_tma<D, MAXG>(q, kc, vc, o, scratch, counters, lse, B, S, H, Hkv, lo, pos, scale,
                             cap, stream);
}

}  // namespace

// float32 scratch that decode_attention_fwd needs for these shapes: the
// partials of the largest split either kernel may make
extern "C" long long decode_attention_scratch_floats(int B, int S, int H, int Hkv, int D,
                                                     int dtype) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0) return -1;
  long long nsplit = (S + CHUNK - 1) / CHUNK;
  if (tma_path(dtype, D, H / Hkv)) {
    const int n_sm = sm_count();
    if (n_sm <= 0) return -1;
    nsplit = plan_nsplit((S - 1) / TK + 1, B, Hkv, n_sm);
  }
  return (long long)B * H * nsplit * (D + 2);
}

// q: (B,1,H,D); k_cache, v_cache: (B,S,Hkv,D), the keys at global positions
// k0 .. k0 + S - 1; o: (B,1,H,D); one dtype (0 = float32, 1 = bfloat16),
// contiguous, D a multiple of 8 (bf16) or 4 (fp32). lse: float32 (B,H) or
// null; with lse, o is float32 whatever the inputs' dtype. scratch: float32, decode_attention_scratch_floats(...) of them;
// counters: int32 (B*Hkv), zero before the first call and left zero by every
// call. pos >= 0, k0 >= 0; window <= 0 = no window; cap <= 0 = no cap.
// Returns the CUDA error code of the launches.
extern "C" int decode_attention_shard_fwd(const void* q, const void* kc, const void* vc, void* o,
                                          void* lse, void* scratch, void* counters, int B,
                                          int S, int H, int Hkv, int D, int pos, int k0,
                                          int window, float scale, float cap, int dtype,
                                          void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAXG || D <= 0 ||
      D > MAXD * 65535 || D % vec != 0 || pos < 0 || k0 < 0 || B * Hkv > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  // the shard's valid keys in local positions
  const int lo = max((window > 0 ? max(0, pos - window + 1) : 0) - k0, 0);
  const int hi = (long long)pos - k0 < S - 1 ? pos - k0 : S - 1;
  if (hi < lo) {
    if (ls == nullptr) return (int)cudaErrorInvalidValue;   // only a shard can be empty
    const long long n = (long long)B * H * D;
    const int blocks = n > 1024 * 256 ? 1024 : (int)((n + 255) / 256);
    decode_empty_kernel<<<blocks, 256, 0, st>>>(static_cast<float*>(o), ls, n, B * H);
    return (int)cudaGetLastError();
  }
  float* sc = static_cast<float*>(scratch);
  int* cnt = static_cast<int*>(counters);
  if (tma_path(dtype, D, H / Hkv)) {
    if (D == 256)
      return (int)launch_tma_g<256>(q, kc, vc, o, sc, cnt, ls, B, S, H, Hkv, lo, hi, scale, cap, st);
    if (D == 160)
      return (int)launch_tma_g<160>(q, kc, vc, o, sc, cnt, ls, B, S, H, Hkv, lo, hi, scale, cap, st);
    if (D == 128)
      return (int)launch_tma_g<128>(q, kc, vc, o, sc, cnt, ls, B, S, H, Hkv, lo, hi, scale, cap, st);
    if (D == 112)
      return (int)launch_tma_g<112>(q, kc, vc, o, sc, cnt, ls, B, S, H, Hkv, lo, hi, scale, cap, st);
    return (int)launch_tma_g<64>(q, kc, vc, o, sc, cnt, ls, B, S, H, Hkv, lo, hi, scale, cap, st);
  }
  const long long rows = (long long)B * H * ((S + CHUNK - 1) / CHUNK);
  float* pm = sc;
  float* pl = pm + rows;
  float* pa = pl + rows;
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, 1>(q, kc, vc, o, ls, pm, pl, pa, B, S, H, Hkv, D, lo, hi,
                                         scale, cap, st);
  return (int)(D > 128 ? launch<float, 2>(q, kc, vc, o, ls, pm, pl, pa, B, S, H, Hkv, D, lo, hi,
                                          scale, cap, st)
                       : launch<float, 1>(q, kc, vc, o, ls, pm, pl, pa, B, S, H, Hkv, D, lo, hi,
                                          scale, cap, st));
}

// The whole cache: decode_attention_shard_fwd at k0 = 0 without lse; 0 <= pos < S.
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc, void* o,
                                    void* scratch, void* counters, int B, int S, int H, int Hkv,
                                    int D, int pos, int window, float scale, float cap,
                                    int dtype, void* stream) {
  if (pos >= S) return (int)cudaErrorInvalidValue;
  return decode_attention_shard_fwd(q, kc, vc, o, nullptr, scratch, counters, B, S, H, Hkv, D,
                                    pos, 0, window, scale, cap, dtype, stream);
}
