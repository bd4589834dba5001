// A warp a row: the design that csrc/rmsnorm.cu (a CTA a row) was measured
// against and chosen over, kept so that kernels/ablate_rmsnorm.py can time
// it beside the current source on one card. A lane holds up to 16 16-byte
// pieces of x and the scale beside them in registers, folded by shuffles
// alone (no shared memory, no barrier); a warp takes ROWS_PER_WARP
// consecutive rows, the next row's loads issued before this row's fold.
// Takes only rows that load in 16-byte pieces and fit a warp (an error
// otherwise). Not built by _build and not used by the port.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS_PER_WARP = 1;     // consecutive rows a warp takes
constexpr int WARPS = 4;             // warps a CTA
constexpr int LANE_BYTES = 512;      // registers of x and scale pieces a lane may hold

// 16 bytes of T (4 fp32, 8 bf16) from VEC floats
template <typename T, int VEC>
__device__ __forceinline__ void store_piece(T* p, const float* v) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// The raw bytes of N elements of T, loaded in one or two vector loads and
// turned into floats later: a piece of x (16 bytes) or the scale beside it
// (8, 16 or 32 bytes).
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Sum of squares of a lane's pieces of x (absent pieces are zeros).
template <typename TX, int VEC, int NPM>
__device__ __forceinline__ float lane_squares(const Raw<TX, VEC> (&xv)[NPM], int lane,
                                              int npieces) {
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NPM; ++j) {
    if (j * 32 + lane < npieces) {
      float v[VEC];
      xv[j].to_f32(v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss += v[e] * v[e];
    }
  }
  return ss;
}

template <typename TX, int VEC, int NPM>
__device__ __forceinline__ void load_row(const TX* row, Raw<TX, VEC> (&xv)[NPM], int lane,
                                         int npieces) {
#pragma unroll
  for (int j = 0; j < NPM; ++j) {
    const int p = j * 32 + lane;
    if (p < npieces) xv[j].load(row + (long long)p * VEC);
  }
}

// A warp a row, up to NPM 16-byte pieces of x a lane (piece j * 32 + lane
// of the row), the scale pieces beside them, loaded with the first row's;
// a warp takes ROWS_PER_WARP consecutive rows, loading scale once.
template <typename TX, typename TS, int NPM>
__global__ void __launch_bounds__(32 * WARPS)
rmsnorm_warp_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                    TX* __restrict__ out, int rows, int D, float eps) {
  constexpr int VEC = 16 / sizeof(TX);
  const long long first =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * ROWS_PER_WARP;
  const int lane = threadIdx.x & 31;
  if (first >= rows) return;
  const int npieces = D / VEC;
  Raw<TX, VEC> xv[NPM];
  Raw<TS, VEC> sv[NPM];
  load_row<TX, VEC, NPM>(x + first * D, xv, lane, npieces);
  load_row<TS, VEC, NPM>(scale, sv, lane, npieces);
#pragma unroll 1
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const long long row = first + k;
    const bool more = k + 1 < ROWS_PER_WARP && row + 1 < rows;
    Raw<TX, VEC> xn[NPM];
    if (more) load_row<TX, VEC, NPM>(x + (row + 1) * D, xn, lane, npieces);
    const float r =
        rsqrtf(warp_sum(lane_squares<TX, VEC, NPM>(xv, lane, npieces)) / (float)D + eps);
#pragma unroll
    for (int j = 0; j < NPM; ++j) {
      const int p = j * 32 + lane;
      if (p < npieces) {
        float v[VEC], s[VEC], y[VEC];
        xv[j].to_f32(v);
        sv[j].to_f32(s);
#pragma unroll
        for (int e = 0; e < VEC; ++e) y[e] = (v[e] * r) * (1.f + s[e]);
        store_piece<TX, VEC>(out + row * D + (long long)p * VEC, y);
      }
    }
    if (!more) break;
#pragma unroll
    for (int j = 0; j < NPM; ++j) xv[j] = xn[j];
  }
}

template <typename TX, typename TS, int NPM>
cudaError_t launch_warps(const TX* x, const TS* scale, TX* out, int rows, int D, float eps,
                         cudaStream_t stream) {
  constexpr long long ROWS_A_CTA = (long long)WARPS * ROWS_PER_WARP;
  const int grid = (int)(((long long)rows + ROWS_A_CTA - 1) / ROWS_A_CTA);
  rmsnorm_warp_kernel<TX, TS, NPM><<<grid, 32 * WARPS, 0, stream>>>(x, scale, out, rows, D, eps);
  return cudaGetLastError();
}

template <typename TX, typename TS>
cudaError_t dispatch(const void* xp, const void* sp, void* op, int rows, int D, float eps,
                     cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(TX);
  constexpr int SBYTES = VEC * sizeof(TS);        // scale bytes beside a piece of x
  constexpr int SALIGN = SBYTES < 16 ? SBYTES : 16;
  constexpr int CAP = LANE_BYTES / (16 + SBYTES);  // pieces of x a lane may hold
  // the widest instance within CAP (instances: 2, 4, 9, 16)
  constexpr int WIDEST = CAP >= 16 ? 16 : CAP >= 9 ? 9 : CAP >= 4 ? 4 : 2;
  const TX* x = static_cast<const TX*>(xp);
  const TS* scale = static_cast<const TS*>(sp);
  TX* out = static_cast<TX*>(op);
  const bool aligned = reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<std::uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<std::uintptr_t>(scale) % SALIGN == 0 && D % VEC == 0;
  const int per_lane = (D / VEC + 31) / 32;
  if (!aligned || per_lane > WIDEST) return cudaErrorInvalidValue;
  if (per_lane <= 2) return launch_warps<TX, TS, 2>(x, scale, out, rows, D, eps, stream);
  if (per_lane <= 4) return launch_warps<TX, TS, 4>(x, scale, out, rows, D, eps, stream);
  if (per_lane <= 9) return launch_warps<TX, TS, 9>(x, scale, out, rows, D, eps, stream);
  if constexpr (WIDEST == 16)
    return launch_warps<TX, TS, 16>(x, scale, out, rows, D, eps, stream);
  return cudaErrorInvalidValue;  // not reached: per_lane <= WIDEST
}

}  // namespace

// As csrc/rmsnorm.cu's rmsnorm_fwd, for the rows described above.
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
