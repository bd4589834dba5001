// Row RMSNorm, gemma-style (1 + scale), for sm_90a (H100).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_fwd
// (body _rmsnorm_kernel). Same function, per row of x (..., D): the fp32 mean
// of x^2, then (x * rsqrt(mean + eps)) * (1 + scale) in fp32, rounded to
// x's dtype. x and out are bf16 or fp32; scale (D,) is bf16 or fp32 on its
// own, read as it is, so the caller needs no conversion launch.
//
// What bounds it on the H100: bytes where there are many rows (a row is read
// once and written once for ~4 flops an element: gemma2-2b's training
// microbatch, 4096 rows of 2304 bf16, is 37.7 MB, ~11.3 us at 3.35 TB/s),
// and the latency of one launch where there are few (a decode step's 2 rows
// are 18 KB: the bytes bound is 0.007 us, the launch itself ~1-2 us).
//
// The TPU kernel tiles 256 rows into VMEM per grid step and pads the row
// count to the tile; here each row is one CTA, so any number of rows is
// taken and nothing is padded. The CTA's threads hold the row in registers,
// one 16-byte piece a thread where D and the pointers allow it (one element
// otherwise; up to 8 pieces a thread for the widest rows), so the row
// leaves device memory once. Each thread issues its loads of x and of the
// scale beside it (16-byte vectors) before any arithmetic, so the launch
// waits on one memory latency; the sum of squares folds by shuffles within
// each warp, and after one barrier every warp folds the warps' partials
// itself. Measured on the H100 (kernels/ablate_rmsnorm.py), this beat a
// warp a row (csrc/earlier/rmsnorm_warp_rows.cu) at a decode step's 2 rows,
// where a lane's 9 pieces of loads, conversions and stores in a row are the
// critical path, and matched or beat it at 4096 and 8704 rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_NP = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// VEC elements at p as floats: one element, or 16 bytes (4 fp32, 8 bf16)
template <typename T, int VEC>
__device__ __forceinline__ void load_piece(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_f32(*p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_piece(T* p, const float* v) {
  if constexpr (VEC == 1) {
    store1(p, v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// The raw bytes of N elements of T (the scale beside a piece of x: 8, 16 or
// 32 bytes), loaded in one or two vector loads and turned into floats.
template <typename T, int N>
struct Raw {
  static constexpr int WORDS = N * (int)sizeof(T) / 4;
  uint32_t w[WORDS];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (WORDS == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x; w[1] = v.y;
    } else {
#pragma unroll
      for (int q = 0; q < WORDS / 4; ++q) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[q];
        w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
      }
    }
  }
  __device__ __forceinline__ void to_f32(float* out) const {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = __uint_as_float(w[i]);
    } else {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
      }
    }
  }
};

// The scale beside a piece of VEC elements of x, as floats: one element, or
// VEC elements in one or two vector loads.
template <typename TS, int VEC>
__device__ __forceinline__ void load_scale(const TS* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_f32(*p);
  } else {
    Raw<TS, VEC> r;
    r.load(p);
    r.to_f32(out);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// A CTA a row; blockDim.x a multiple of 32. Piece j of thread t is piece
// j * blockDim.x + t of the row.
template <typename TX, typename TS, int VEC, int NP>
__global__ void rmsnorm_block_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                                     TX* __restrict__ out, int D, float eps) {
  __shared__ float warp_sums[MAX_THREADS / 32];
  const long long base = (long long)blockIdx.x * D;
  const int npieces = D / VEC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  float v[NP][VEC], s[NP][VEC];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int piece = j * blockDim.x + tid;
    if (piece < npieces) {
      load_piece<TX, VEC>(x + base + (long long)piece * VEC, v[j]);
      load_scale<TS, VEC>(scale + piece * VEC, s[j]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (j * (int)blockDim.x + tid < npieces) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss += v[j][e] * v[j][e];
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  // every warp folds the partials itself: no second barrier
  const float total = warp_sum(lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.f);
  const float r = rsqrtf(total / (float)D + eps);

#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int piece = j * blockDim.x + tid;
    if (piece < npieces) {
      float y[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) y[e] = (v[j][e] * r) * (1.f + s[j][e]);
      store_piece<TX, VEC>(out + base + (long long)piece * VEC, y);
    }
  }
}

template <typename TX, typename TS, int VEC>
cudaError_t launch_block(const TX* x, const TS* scale, TX* out, int rows, int D, float eps,
                         cudaStream_t stream) {
  const int npieces = D / VEC;
  int np = 1;
  while (np < MAX_NP && npieces > np * MAX_THREADS) np *= 2;
  if (npieces > np * MAX_THREADS) return cudaErrorInvalidValue;
  int threads = (npieces + np - 1) / np;
  threads = ((threads + 31) / 32) * 32;
  switch (np) {
    case 1: rmsnorm_block_kernel<TX, TS, VEC, 1><<<rows, threads, 0, stream>>>(x, scale, out, D, eps); break;
    case 2: rmsnorm_block_kernel<TX, TS, VEC, 2><<<rows, threads, 0, stream>>>(x, scale, out, D, eps); break;
    case 4: rmsnorm_block_kernel<TX, TS, VEC, 4><<<rows, threads, 0, stream>>>(x, scale, out, D, eps); break;
    default: rmsnorm_block_kernel<TX, TS, VEC, 8><<<rows, threads, 0, stream>>>(x, scale, out, D, eps);
  }
  return cudaGetLastError();
}

template <typename TX, typename TS>
cudaError_t dispatch(const void* xp, const void* sp, void* op, int rows, int D, float eps,
                     cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(TX);
  constexpr int SBYTES = VEC * sizeof(TS);  // scale bytes beside a piece of x
  const TX* x = static_cast<const TX*>(xp);
  const TS* scale = static_cast<const TS*>(sp);
  TX* out = static_cast<TX*>(op);
  const bool aligned = reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<std::uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<std::uintptr_t>(scale) % (SBYTES < 16 ? SBYTES : 16) == 0 &&
                       D % VEC == 0;
  if (aligned) return launch_block<TX, TS, VEC>(x, scale, out, rows, D, eps, stream);
  return launch_block<TX, TS, 1>(x, scale, out, rows, D, eps, stream);
}

// The split mode, for a row whose columns are spread over several ranks (a
// norm over every head of a cell computed on a rank's heads): one launch
// writes each row's float32 sum of squares over the rank's columns, the
// caller sums the rows' sums over the ranks (one all-reduce of (rows,)
// float32), and a second launch scales the rank's columns by
// rsqrt(sum / width + eps) * (1 + scale), width the whole row's.
//
// A rank's share of a row is narrow (xlstm-125m's 48 and 96 columns at
// model 16, 6 and 12 16-byte pieces of bf16; zamba2-7b's 896 at model 8, 112
// pieces) and there are many rows (8,704 at a prefill of 4,352 tokens), so
// both launches pack rows into warps, in CTAs of 256 threads with no shared
// memory and no barrier, one CTA for each 256 threads' share of the work
// (the block scheduler fills an SM's slots as CTAs end; a grid capped at the
// SMs' resident CTAs, each warp walking several rows, measured slower at
// zamba2's shape while this was designed). The sum of squares takes LANES
// consecutive lanes a row, LANES the power of two at or above the row's
// pieces, up to 32, so a warp holds 32 / LANES rows; a row wider than 32
// pieces is a warp's, each lane loading its pieces 4 at a time before it
// sums them. A row's lanes fold their partial sums by xor shuffles among
// themselves, always in the same order. The scale is elementwise given the
// row's sum: a thread a 16-byte piece, the pieces of consecutive rows laid
// end to end over the lanes, so no lane idles at any width. (One CTA a row,
// with D / VEC threads, left most lanes of a 32-thread CTA idle at 48 and 96
// columns and took ~6.8 us a launch; lanes of a row in the scale too left a
// quarter of them idle at 48 and 96 columns.)
constexpr int SPLIT_THREADS = 256;

template <int LANES>
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <typename TX, int VEC, int LANES>
__global__ void __launch_bounds__(SPLIT_THREADS)
rmsnorm_sumsq_kernel(const TX* __restrict__ x, float* __restrict__ sumsq, long long rows,
                     int D) {
  constexpr int NP = LANES == 32 ? 4 : 1;   // a lane's pieces a pass, loaded first
  const int lane = (int)(threadIdx.x & 31);
  const long long first =
      ((long long)blockIdx.x * (SPLIT_THREADS / 32) + (threadIdx.x >> 5)) * (32 / LANES);
  if (first >= rows) return;   // the whole warp: its shuffles need every lane
  const long long row = first + lane / LANES;
  const int sub = lane % LANES, npieces = D / VEC;
  float ss = 0.f;
  if (row < rows) {
    const TX* p = x + row * D;
    for (int p0 = sub; p0 < npieces; p0 += NP * LANES) {
      float v[NP][VEC];
#pragma unroll
      for (int j = 0; j < NP; ++j)
        if (p0 + j * LANES < npieces)
          load_piece<TX, VEC>(p + (long long)(p0 + j * LANES) * VEC, v[j]);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        if (p0 + j * LANES < npieces) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) ss += v[j][e] * v[j][e];
        }
      }
    }
  }
  ss = lanes_sum<LANES>(ss);
  if (row < rows && sub == 0) sumsq[row] = ss;
}

// Piece i of the (rows, D / VEC) pieces: row i / (D / VEC). Index: unsigned
// where the pieces number under 2^32 (a 32-bit division), else 64-bit.
template <typename TX, typename TS, int VEC, typename Index>
__global__ void __launch_bounds__(SPLIT_THREADS)
rmsnorm_scale_kernel(const TX* __restrict__ x, const float* __restrict__ sumsq,
                     const TS* __restrict__ scale, TX* __restrict__ out, Index total, int D,
                     float width, float eps) {
  const Index i = (Index)blockIdx.x * SPLIT_THREADS + threadIdx.x;
  if (i >= total) return;
  const Index npieces = (Index)(D / VEC);
  const Index row = i / npieces;
  const int piece = (int)(i - row * npieces);
  float v[VEC], s[VEC];
  load_piece<TX, VEC>(x + (long long)i * VEC, v);
  load_scale<TS, VEC>(scale + piece * VEC, s);
  const float r = rsqrtf(sumsq[row] / width + eps);
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = (v[e] * r) * (1.f + s[e]);
  store_piece<TX, VEC>(out + (long long)i * VEC, v);
}

// The lanes a row takes: the power of two at or above its pieces, at most 32.
inline int split_lanes(int npieces) {
  int lanes = 1;
  while (lanes < 32 && lanes < npieces) lanes *= 2;
  return lanes;
}

template <typename TX, int VEC>
cudaError_t launch_sumsq(const TX* x, float* sumsq, long long rows, int D, cudaStream_t stream) {
  const int lanes = split_lanes(D / VEC);
  const long long per_cta = (long long)(SPLIT_THREADS / 32) * (32 / lanes);
  const int grid = (int)((rows + per_cta - 1) / per_cta);
  switch (lanes) {
    case 1: rmsnorm_sumsq_kernel<TX, VEC, 1><<<grid, SPLIT_THREADS, 0, stream>>>(x, sumsq, rows, D); break;
    case 2: rmsnorm_sumsq_kernel<TX, VEC, 2><<<grid, SPLIT_THREADS, 0, stream>>>(x, sumsq, rows, D); break;
    case 4: rmsnorm_sumsq_kernel<TX, VEC, 4><<<grid, SPLIT_THREADS, 0, stream>>>(x, sumsq, rows, D); break;
    case 8: rmsnorm_sumsq_kernel<TX, VEC, 8><<<grid, SPLIT_THREADS, 0, stream>>>(x, sumsq, rows, D); break;
    case 16: rmsnorm_sumsq_kernel<TX, VEC, 16><<<grid, SPLIT_THREADS, 0, stream>>>(x, sumsq, rows, D); break;
    default: rmsnorm_sumsq_kernel<TX, VEC, 32><<<grid, SPLIT_THREADS, 0, stream>>>(x, sumsq, rows, D);
  }
  return cudaGetLastError();
}

template <typename TX, typename TS, int VEC>
cudaError_t launch_scale(const TX* x, const float* sumsq, const TS* scale, TX* out,
                         long long rows, int D, float width, float eps, cudaStream_t stream) {
  const unsigned long long total = (unsigned long long)rows * (unsigned long long)(D / VEC);
  const unsigned long long grid = (total + SPLIT_THREADS - 1) / SPLIT_THREADS;
  if (grid > 0x7fffffffull) return cudaErrorInvalidValue;
  if (total <= 0xffffffffull)
    rmsnorm_scale_kernel<TX, TS, VEC, unsigned><<<(int)grid, SPLIT_THREADS, 0, stream>>>(
        x, sumsq, scale, out, (unsigned)total, D, width, eps);
  else
    rmsnorm_scale_kernel<TX, TS, VEC, unsigned long long><<<(int)grid, SPLIT_THREADS, 0, stream>>>(
        x, sumsq, scale, out, total, D, width, eps);
  return cudaGetLastError();
}

// 16-byte pieces where D and the pointers allow them, one element a piece
// otherwise.
template <typename TX, typename TS>
cudaError_t dispatch_split(const void* xp, const void* sp, const float* sumsq, void* op,
                           int rows, int D, float width, float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(TX);
  constexpr int SBYTES = VEC * sizeof(TS);
  const TX* x = static_cast<const TX*>(xp);
  const TS* scale = static_cast<const TS*>(sp);
  TX* out = static_cast<TX*>(op);
  const bool aligned = reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<std::uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<std::uintptr_t>(scale) % (SBYTES < 16 ? SBYTES : 16) == 0 &&
                       D % VEC == 0;
  if (aligned) return launch_scale<TX, TS, VEC>(x, sumsq, scale, out, rows, D, width, eps, stream);
  return launch_scale<TX, TS, 1>(x, sumsq, scale, out, rows, D, width, eps, stream);
}

template <typename TX>
cudaError_t dispatch_sumsq(const void* xp, float* sumsq, int rows, int D, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(TX);
  const TX* x = static_cast<const TX*>(xp);
  if (reinterpret_cast<std::uintptr_t>(x) % 16 == 0 && D % VEC == 0)
    return launch_sumsq<TX, VEC>(x, sumsq, rows, D, stream);
  return launch_sumsq<TX, 1>(x, sumsq, rows, D, stream);
}

// A launch that does nothing: its device time is the floor under a launch
// of a few rows (chip_smoke.py prints the two side by side).
__global__ void rmsnorm_empty_kernel() {}

}  // namespace

// One launch of the empty kernel on the stream; returns its CUDA error.
extern "C" int rmsnorm_empty(void* stream) {
  rmsnorm_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" int rmsnorm_max_width() { return MAX_NP * MAX_THREADS; }

// x, out: (rows, D) contiguous, one dtype; scale: (D,) contiguous. Dtype
// codes 0 = float32, 1 = bfloat16. 1 <= rows <= 2^31 - 1, 1 <= D <=
// rmsnorm_max_width() always (wider rows are taken when they load in 16-byte
// pieces). Returns the CUDA error code of the launch.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, int rows, int D,
                           float eps, int x_dtype, int scale_dtype, void* stream) {
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && scale_dtype == 1)
    return (int)dispatch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, D, eps, st);
  if (x_dtype == 1 && scale_dtype == 0)
    return (int)dispatch<__nv_bfloat16, float>(x, scale, out, rows, D, eps, st);
  if (x_dtype == 0 && scale_dtype == 1)
    return (int)dispatch<float, __nv_bfloat16>(x, scale, out, rows, D, eps, st);
  if (x_dtype == 0 && scale_dtype == 0)
    return (int)dispatch<float, float>(x, scale, out, rows, D, eps, st);
  return (int)cudaErrorInvalidValue;
}

// The split mode's first launch. x: (rows, D) contiguous, this rank's
// columns of each row; sumsq: (rows,) float32, written with each row's sum
// of x^2 in float32. Returns the CUDA error code of the launch.
extern "C" int rmsnorm_sumsq(const void* x, void* sumsq, int rows, int D, int x_dtype,
                             void* stream) {
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(sumsq);
  if (x_dtype == 1) return (int)dispatch_sumsq<__nv_bfloat16>(x, out, rows, D, st);
  if (x_dtype == 0) return (int)dispatch_sumsq<float>(x, out, rows, D, st);
  return (int)cudaErrorInvalidValue;
}

// The split mode's second launch. x, out: (rows, D) contiguous, one dtype;
// sumsq: (rows,) float32, each row's sum of squares over all its columns
// (every rank's); scale: (D,), the scale of this rank's columns; width: the
// whole row's number of columns. Returns the CUDA error code of the launch.
extern "C" int rmsnorm_scale(const void* x, const void* sumsq, const void* scale, void* out,
                             int rows, int D, int width, float eps, int x_dtype,
                             int scale_dtype, void* stream) {
  if (rows <= 0 || D <= 0 || width < D) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ss = static_cast<const float*>(sumsq);
  const float w = (float)width;
  if (x_dtype == 1 && scale_dtype == 1)
    return (int)dispatch_split<__nv_bfloat16, __nv_bfloat16>(x, scale, ss, out, rows, D, w, eps, st);
  if (x_dtype == 1 && scale_dtype == 0)
    return (int)dispatch_split<__nv_bfloat16, float>(x, scale, ss, out, rows, D, w, eps, st);
  if (x_dtype == 0 && scale_dtype == 1)
    return (int)dispatch_split<float, __nv_bfloat16>(x, scale, ss, out, rows, D, w, eps, st);
  if (x_dtype == 0 && scale_dtype == 0)
    return (int)dispatch_split<float, float>(x, scale, ss, out, rows, D, w, eps, st);
  return (int)cudaErrorInvalidValue;
}
