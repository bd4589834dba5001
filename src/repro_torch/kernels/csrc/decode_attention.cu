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
// K and V): ~11 us at 3.35 TB/s.
//
// Design: the TPU kernel walks the kv axis sequentially inside one grid cell
// per (batch, kv head); on the H100 that is 8 blocks for 132 SMs. Here the kv
// axis is split instead (split-K), so that enough loads are in flight:
//  * pass 1 (decode_partial_kernel): grid (128-key chunks that meet [lo, pos],
//    batch * kv heads). Each of a block's 4 warps takes 32 keys, one per lane.
//    Score step: a lane reads its key's K row with 16-byte loads and dots it
//    with the group's query rows, which sit in shared memory (fp32, read as
//    broadcasts). Softmax across the warp with __shfl_xor_sync. PV step: lanes
//    split the head dim (16 bytes of a V row each, so a row is one coalesced
//    512-byte read at D=256 bf16) and each key's weight is broadcast with
//    __shfl_sync. The 4 warps merge through shared memory and the block writes
//    an fp32 partial (max, sum, unnormalised output) for every query head of
//    its group. Warps whose 32 keys lie wholly outside [lo, pos] skip them,
//    which gives the same result as masking them.
//  * pass 2 (decode_combine_kernel): one block per (batch, head) rescales and
//    sums the partials of the chunks that ran.
// Masked scores take the finite NEG_INF of the TPU kernel, not -inf, so that
// exp(NEG_INF - NEG_INF) = 1 and a later exp(NEG_INF - m) = 0 stay finite.
// Any cache length is taken; the ragged last chunk is masked here. The head
// dim must be a multiple of 16 bytes' worth of elements (8 bf16, 4 fp32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the group's query rows are contiguous in q (B,1,H,D)
  const T* qg = q + ((long long)b * H + kvh * group) * D;
  for (int idx = tid; idx < group * D; idx += THREADS) Qs[idx] = to_f32(qg[idx]);
  __syncthreads();

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
  const T* vbase = vc + ((long long)b * S * Hkv + kvh) * D;
  const int t0 = split * CHUNK + warp * 32;

  if (t0 <= pos && t0 + 31 >= lo) {
    const int key = t0 + lane;
    const bool ok = key >= lo && key <= pos;   // pos < S, so a valid key is in the cache
    if (ok) {
      const T* krow = kbase + key * hs;
      for (int c = 0; c < D; c += VEC) {
        float kx[VEC];
        load16(krow + c, kx);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= group) break;
          const float4* qv = reinterpret_cast<const float4*>(Qs + g * D + c);
#pragma unroll
          for (int e4 = 0; e4 < VEC / 4; ++e4) {
            const float4 qx = qv[e4];
            s[g] += qx.x * kx[4 * e4] + qx.y * kx[4 * e4 + 1] +
                    qx.z * kx[4 * e4 + 2] + qx.w * kx[4 * e4 + 3];
          }
        }
      }
    }
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
        if (c < D) {
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
      if (c < D) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) w_acc[warp][g][c + e] = acc[g][j * VEC + e];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < group * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float mb = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, w_m[w][g]);
    float a = 0.f, lb = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(w_m[w][g] - mb);
      a += w_acc[w][g][d] * f;
      lb += w_l[w][g] * f;
    }
    const long long slot = ((long long)b * H + kvh * group + g) * nsplit + (split - split0);
    part_acc[slot * D + d] = a;
    if (d == 0) { part_m[slot] = mb; part_l[slot] = lb; }
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ o, int D, int nsplit) {
  const long long row = blockIdx.x;            // b * H + h
  const float* pm = part_m + row * nsplit;
  const float* pl = part_l + row * nsplit;
  float mx = NEG_INF;
  for (int i = 0; i < nsplit; ++i) mx = fmaxf(mx, pm[i]);
  float lsum = 0.f;
  for (int i = 0; i < nsplit; ++i) lsum += pl[i] * expf(pm[i] - mx);
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < nsplit; ++i) a += part_acc[(row * nsplit + i) * D + d] * expf(pm[i] - mx);
    store(o + row * D + d, a * inv);
  }
}

template <typename T, int NV>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* o, float* pm,
                   float* pl, float* pa, int B, int S, int H, int Hkv, int D, int pos,
                   int window, float scale, float cap, cudaStream_t stream) {
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int split0 = lo / CHUNK;
  const int nsplit = pos / CHUNK - split0 + 1;
  decode_partial_kernel<T, NV><<<dim3(nsplit, B * Hkv), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), pm, pl,
      pa, S, H, Hkv, D, pos, lo, split0, nsplit, scale, cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<B * H, 128, 0, stream>>>(pm, pl, pa, static_cast<T*>(o), D,
                                                      nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_chunk() { return CHUNK; }

// q: (B,1,H,D); k_cache, v_cache: (B,S,Hkv,D); o: (B,1,H,D); one dtype (0 =
// float32, 1 = bfloat16), contiguous, D a multiple of 8 (bf16) or 4 (fp32).
// part_m, part_l: float32 (B*H, nsplit_max); part_acc: float32 (B*H,
// nsplit_max, D), nsplit_max = ceil(S / CHUNK). 0 <= pos < S; window <= 0 = no
// window; cap <= 0 = no cap. Returns the CUDA error code of the launches.
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc, void* o,
                                    void* part_m, void* part_l, void* part_acc, int B, int S,
                                    int H, int Hkv, int D, int pos, int window, float scale,
                                    float cap, int dtype, void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAXG || D <= 0 || D > MAXD ||
      D % vec != 0 || pos < 0 || pos >= S || B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, 1>(q, kc, vc, o, pm, pl, pa, B, S, H, Hkv, D, pos,
                                         window, scale, cap, st);
  if (dtype == 0)
    return (int)(D > 128 ? launch<float, 2>(q, kc, vc, o, pm, pl, pa, B, S, H, Hkv, D, pos,
                                            window, scale, cap, st)
                         : launch<float, 1>(q, kc, vc, o, pm, pl, pa, B, S, H, Hkv, D, pos,
                                            window, scale, cap, st));
  return (int)cudaErrorInvalidValue;
}
