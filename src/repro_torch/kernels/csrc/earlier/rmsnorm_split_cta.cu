// The split mode's first design, a CTA a row, its threads striding over the
// row's 16-byte pieces (one element a piece where D or the pointers do not
// allow it). Not a source of its own: kernels/ablate_rmsnorm.py's
// "split_cta" puts it into csrc/rmsnorm.cu in place of the split mode's
// kernels and dispatch, to time the current pair against it. Not built by
// _build and not used by the port.
template <typename TX, int VEC>
__global__ void rmsnorm_sumsq_kernel(const TX* __restrict__ x, float* __restrict__ sumsq,
                                     int D) {
  __shared__ float warp_sums[MAX_THREADS / 32];
  const TX* row = x + (long long)blockIdx.x * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float ss = 0.f;
  for (int piece = tid; piece < D / VEC; piece += blockDim.x) {
    float v[VEC];
    load_piece<TX, VEC>(row + (long long)piece * VEC, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += v[e] * v[e];
  }
  ss = warp_sum(ss);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const float row_sum = warp_sum(lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.f);
    if (lane == 0) sumsq[blockIdx.x] = row_sum;
  }
}

template <typename TX, typename TS, int VEC>
__global__ void rmsnorm_scale_kernel(const TX* __restrict__ x, const float* __restrict__ sumsq,
                                     const TS* __restrict__ scale, TX* __restrict__ out, int D,
                                     float width, float eps) {
  const long long base = (long long)blockIdx.x * D;
  const float r = rsqrtf(sumsq[blockIdx.x] / width + eps);
  for (int piece = threadIdx.x; piece < D / VEC; piece += blockDim.x) {
    float v[VEC], s[VEC];
    load_piece<TX, VEC>(x + base + (long long)piece * VEC, v);
    load_scale<TS, VEC>(scale + piece * VEC, s);
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = (v[e] * r) * (1.f + s[e]);
    store_piece<TX, VEC>(out + base + (long long)piece * VEC, v);
  }
}

inline int split_threads(int npieces) {
  const int t = ((npieces + 31) / 32) * 32;
  return t < MAX_THREADS ? t : MAX_THREADS;
}

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
  if (aligned)
    rmsnorm_scale_kernel<TX, TS, VEC><<<rows, split_threads(D / VEC), 0, stream>>>(
        x, sumsq, scale, out, D, width, eps);
  else
    rmsnorm_scale_kernel<TX, TS, 1><<<rows, split_threads(D), 0, stream>>>(
        x, sumsq, scale, out, D, width, eps);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_sumsq(const void* xp, float* sumsq, int rows, int D, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(TX);
  const TX* x = static_cast<const TX*>(xp);
  if (reinterpret_cast<std::uintptr_t>(x) % 16 == 0 && D % VEC == 0)
    rmsnorm_sumsq_kernel<TX, VEC><<<rows, split_threads(D / VEC), 0, stream>>>(x, sumsq, D);
  else
    rmsnorm_sumsq_kernel<TX, 1><<<rows, split_threads(D), 0, stream>>>(x, sumsq, D);
  return cudaGetLastError();
}

