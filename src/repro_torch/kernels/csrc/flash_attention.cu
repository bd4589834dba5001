// Causal GQA flash attention, forward, for sm_90a (H100).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_fwd (body _flash_kernel). Same function: causal attention with
// all H/Hkv query heads of one kv head sharing K/V, an optional sliding window
// given at run time (0 = full), an optional tanh logit soft-cap, an fp32 online
// softmax, bf16 or fp32 in and out.
//
// What bounds it on the H100: the two products (QK^T and PV) are compute; at
// gemma2-2b's prefill (B=2, S=4352, H=8, D=256) one launch is ~1.55e11 FLOPs,
// 0.16 ms at the 989 TFLOP/s bf16 tensor-core peak, against ~107 MB of q, k, v
// and o (32 us at 3.35 TB/s). So the products belong on the tensor cores.
//
// Both paths share the work split: a block owns consecutive "flat rows" of one
// (batch, kv head), where a flat row is (query position, head within the
// group). The group's heads share every K/V tile the block loads, as in the
// TPU kernel, and a group that is not a power of two (3 for smollm) needs no
// special case.
//
// bf16 with head_dim 64, 128 or 256 (gemma2-2b's path): flash_mma_kernel.
//  * 4 warps x 16 flat rows; K/V tiles of 32 keys, double-buffered: cp.async
//    fetches the next tile while the tensor cores work on this one. QK^T and
//    PV run as mma.sync.m16n8k16 (bf16 in, fp32 accumulate: the scores are
//    exact fp32 sums of exact products). Q and K fragments are 32-bit loads
//    from shared memory; V's come from ldmatrix.trans of the row-major tile.
//    Row strides are padded by 8 elements so that the lanes of a fragment load
//    or of an ldmatrix hit distinct banks.
//  * The TPU kernel keeps p in fp32 for PV. A bf16 mma cannot take fp32, so p
//    is split as p = hi + lo with hi = bf16(p), lo = bf16(p - hi) and PV is two
//    mma's: p is then carried to ~16 bits instead of bf16's 8, and PV costs
//    twice the mma work of QK^T.
//  * The fp32 output accumulator of a warp's 16 rows lives in registers (128 a
//    thread at D=256); shared memory is ~101 KB at D=256.
//
// Any other case (fp32, or another head_dim): flash_fwd_kernel, on the fp32
// CUDA cores, which keeps the fp32 inputs exact.
//  * 4 warps x 8 rows. K/V tiles of 32 keys go through shared memory in fp32;
//    in the score step lane j owns key j of the tile (dot over D with float4
//    loads; the K tile's row stride is D+4 floats so the 8 lanes of a quarter
//    warp hit distinct banks); in the PV step lane j owns output columns
//    4j..4j+3 (+128), and each key's weight is broadcast with __shfl_sync.
//  * head_dim up to 256: the fp32 accumulator of a row is spread over the
//    warp's 32 lanes (8 floats a lane at D=256), so 8 rows cost 64 registers.
//    Shared memory at D=256 is 97 KB.
//
// Common to both:
//  * Above 48 KB of shared memory, the launcher raises the kernel's dynamic
//    shared-memory limit first and checks that call.
//  * Masking uses the finite NEG_INF of the TPU kernel, never -inf: a row whose
//    keys in a tile are all masked gets p = exp(NEG_INF - NEG_INF) = 1, and the
//    correction exp(NEG_INF - m) of the next tile with a real key wipes those
//    weights. With -inf that step would be exp(-inf + inf) = NaN.
//  * Only tiles that meet the block's causal/window key range are visited:
//    skipping a tile that lies wholly outside gives the same result as masking
//    it. Keys past S (ragged S) are loaded as zeros and masked; rows past S are
//    computed and not stored. Any S is taken, no block has to divide it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -2.3819763e38f;
constexpr int WARPS = 4;
constexpr int ROWS = 8;                      // flat query rows per warp
constexpr int BLOCK_ROWS = WARPS * ROWS;     // flat query rows per block
constexpr int BK = 32;                       // keys per tile: one per lane
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

// NCH: 128-column chunks of the head dim a lane covers in the PV step
// (1 for D <= 128, 2 for D <= 256).
template <typename T, int NCH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int H, int Hkv, int D, int Dp, int window,
                 float scale, float cap) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kstr = Dp + 4;
  float* Qs = smem;                          // BLOCK_ROWS x Dp
  float* Ks = Qs + BLOCK_ROWS * Dp;          // BK x kstr
  float* Vs = Ks + BK * kstr;                // BK x Dp

  const int group = H / Hkv;
  const int b = blockIdx.y / Hkv;
  const int kvh = blockIdx.y % Hkv;
  const long long n_rows = (long long)S * group;
  const long long row0 = (long long)blockIdx.x * BLOCK_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Q tile: flat row r -> position r / group, head kvh * group + r % group.
  for (int idx = tid; idx < BLOCK_ROWS * Dp; idx += THREADS) {
    const int r = idx / Dp, d = idx % Dp;
    const long long fr = row0 + r;
    float x = 0.f;
    if (fr < n_rows && d < D) {
      const long long qp = fr / group;
      const int h = kvh * group + (int)(fr % group);
      x = to_f32(q[((b * (long long)S + qp) * H + h) * D + d]);
    }
    Qs[idx] = x;
  }

  int qpos[ROWS];
  float m[ROWS], l[ROWS], s[ROWS];
  float4 acc[ROWS][NCH];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    qpos[i] = (int)((row0 + warp * ROWS + i) / group);
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int qpos_min = (int)(row0 / group);
  const int qpos_max = (int)min((row0 + BLOCK_ROWS - 1) / group, (long long)S - 1);
  const int k_begin = window > 0 ? max(0, qpos_min - window + 1) : 0;
  const int k_end = qpos_max + 1;

  for (int t0 = (k_begin / BK) * BK; t0 < k_end; t0 += BK) {
    __syncthreads();  // the previous tile is consumed (and, first time, Qs is written)
    for (int idx = tid; idx < BK * Dp; idx += THREADS) {
      const int kk = idx / Dp, d = idx % Dp;
      const int key = t0 + kk;
      float kx = 0.f, vx = 0.f;
      if (key < S && d < D) {
        const long long off = ((b * (long long)S + key) * Hkv + kvh) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[kk * kstr + d] = kx;
      Vs[kk * Dp + d] = vx;
    }
    __syncthreads();

    // scores: lane owns key t0 + lane
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
    const float* krow = Ks + lane * kstr;
    const float* qrow = Qs + warp * ROWS * Dp;
#pragma unroll 2
    for (int d = 0; d < Dp; d += 4) {
      const float4 kx = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 qx = *reinterpret_cast<const float4*>(qrow + i * Dp + d);
        s[i] += qx.x * kx.x + qx.y * kx.y + qx.z * kx.z + qx.w * kx.w;
      }
    }

    // online softmax, one row at a time; all lanes hold the row's m and l
    const int key = t0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float x = s[i] * scale;
      if (cap > 0.f) x = tanhf(x / cap) * cap;
      const bool ok = key < S && key <= qpos[i] && (window <= 0 || key > qpos[i] - window);
      x = ok ? x : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float p = expf(x - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
      s[i] = p;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        acc[i][c].x *= corr; acc[i][c].y *= corr;
        acc[i][c].z *= corr; acc[i][c].w *= corr;
      }
    }

    // PV: lane owns columns c * 128 + 4 * lane .. +3
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float4 vv[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int d0 = c * 128 + 4 * lane;
        vv[c] = d0 < Dp ? *reinterpret_cast<const float4*>(Vs + kk * Dp + d0)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float pk = __shfl_sync(FULL, s[i], kk);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          acc[i][c].x += pk * vv[c].x; acc[i][c].y += pk * vv[c].y;
          acc[i][c].z += pk * vv[c].z; acc[i][c].w += pk * vv[c].w;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const long long fr = row0 + warp * ROWS + i;
    if (fr >= n_rows) continue;
    const int h = kvh * group + (int)(fr % group);
    T* orow = o + ((b * (long long)S + qpos[i]) * H + h) * D;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int d0 = c * 128 + 4 * lane;
      const float a[4] = {acc[i][c].x, acc[i][c].y, acc[i][c].z, acc[i][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d0 + e < D) store(orow + d0 + e, a[e] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int MROWS = WARPS * 16;            // flat query rows per block
constexpr int MBK = 32;                      // keys per tile

__device__ __forceinline__ unsigned ld32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&t);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// four 8x8 bf16 tiles, transposed: thread i names row i % 8 of tile i / 8
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const bf16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(row)));
}

// d (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layouts (PTX ISA, mma.m16n8k16): with g = lane / 4 and t = lane % 4,
// A holds rows {g, g+8} x cols {2t, 2t+1, 2t+8, 2t+9}; B holds k {2t, 2t+1,
// 2t+8, 2t+9} x col g; C holds rows {g, g+8} x cols {2t, 2t+1}. A transposed
// ldmatrix of an 8x8 tile of row-major V (rows = keys) hands thread (g, t)
// keys {2t, 2t+1} of column g: one half of a B fragment of PV.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H, int Hkv,
                 int window, float scale, float cap) {
  constexpr int STR = D + 8;                 // row stride of every tile
  constexpr int NTD = D / 8;                 // 8-wide output column tiles
  constexpr int KSD = D / 16;                // 16-deep steps over the head dim
  constexpr int CH = D / 8;                  // 16-byte chunks in a row
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);   // MROWS x STR
  bf16* Ks = Qs + MROWS * STR;                    // 2 stages x MBK x STR
  bf16* Vs = Ks + 2 * MBK * STR;                  // 2 stages x MBK x STR

  const int group = H / Hkv;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const long long n_rows = (long long)S * group;
  const long long row0 = (long long)blockIdx.x * MROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const int qpos_min = (int)(row0 / group);
  const int qpos_max = (int)min((row0 + MROWS - 1) / group, (long long)S - 1);
  const int k_begin = window > 0 ? max(0, qpos_min - window + 1) : 0;
  const int k_end = qpos_max + 1;
  const bf16* kvbase_k = k + ((long long)b * S * Hkv + kvh) * D;
  const bf16* kvbase_v = v + ((long long)b * S * Hkv + kvh) * D;

  // K and V tiles of keys t0..t0+MBK-1 into stage st; keys past S become zeros
  auto load_tile = [&](int t0, int st) {
    for (int idx = tid; idx < MBK * CH; idx += THREADS) {
      const int kk = idx / CH, c = idx % CH;
      const int key = t0 + kk;
      const long long off = (long long)min(key, S - 1) * Hkv * D + c * 8;
      const int bytes = key < S ? 16 : 0;
      cp_async16(Ks + (st * MBK + kk) * STR + c * 8, kvbase_k + off, bytes);
      cp_async16(Vs + (st * MBK + kk) * STR + c * 8, kvbase_v + off, bytes);
    }
    cp_async_commit();
  };

  int t0 = (k_begin / MBK) * MBK;
  load_tile(t0, 0);

  for (int idx = tid; idx < MROWS * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    const long long fr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (fr < n_rows) {
      const long long qp = fr / group;
      const int h = kvh * group + (int)(fr % group);
      val = *reinterpret_cast<const uint4*>(q + ((b * (long long)S + qp) * H + h) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(Qs + r * STR + c * 8) = val;
  }

  // this thread's two rows: warp * 16 + g and + 8
  int qpos[2];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NTD][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = (int)((row0 + warp * 16 + g + 8 * i) / group);
#pragma unroll
  for (int n = 0; n < NTD; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const bf16* qa = Qs + (warp * 16 + g) * STR + 2 * t;

  for (int st = 0; t0 < k_end; t0 += MBK, st ^= 1) {
    // prefetch the next tile into the other stage, then wait for this one
    if (t0 + MBK < k_end) load_tile(t0 + MBK, st ^ 1);
    else cp_async_commit();                  // an empty group keeps the count
    cp_async_wait_one();
    __syncthreads();
    const bf16* Kt = Ks + st * MBK * STR;
    const bf16* Vt = Vs + st * MBK * STR;

    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSD; ++ks) {
      const unsigned a[4] = {ld32(qa + ks * 16), ld32(qa + 8 * STR + ks * 16),
                             ld32(qa + ks * 16 + 8), ld32(qa + 8 * STR + ks * 16 + 8)};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const bf16* kb = Kt + (n * 8 + g) * STR + ks * 16 + 2 * t;
        const unsigned bb[2] = {ld32(kb), ld32(kb + 8)};
        mma_bf16(s[n], a, bb);
      }
    }

    // online softmax over this tile; a row's 32 scores sit in the 4 threads of a quad
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = t0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale;
        if (cap > 0.f) x = tanhf(x / cap) * cap;
        const bool ok = key < S && key <= qpos[i] && (window <= 0 || key > qpos[i] - window);
        s[n][e] = ok ? x : NEG_INF;
        mx[i] = fmaxf(mx[i], s[n][e]);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(FULL, sum[i], 1);
      sum[i] += __shfl_xor_sync(FULL, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < NTD; ++n) {
      acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
      acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
    }

    // PV: the score accumulators of key tiles 2j, 2j+1 are the A fragment of step j
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* p0 = s[2 * j];
      const float* p1 = s[2 * j + 1];
      unsigned hi[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                        pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
      unsigned lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* p = r < 2 ? p0 : p1;
        const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&hi[r]);
        const int e = 2 * (r & 1);
        lo[r] = pack_bf16(p[e] - __low2float(h2), p[e + 1] - __high2float(h2));
      }
      // thread i names row i % 8 of tile i / 8: tiles (keys +0, cols n), (keys +8,
      // cols n), (keys +0, cols n+1), (keys +8, cols n+1)
      const bf16* vrow = Vt + (j * 16 + (lane & 8) + (lane & 7)) * STR + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < NTD; n += 2) {
        unsigned bb[4];
        ldmatrix_x4_trans(bb, vrow + n * 8);
        mma_bf16(acc[n], hi, bb);
        mma_bf16(acc[n], lo, bb);
        mma_bf16(acc[n + 1], hi, bb + 2);
        mma_bf16(acc[n + 1], lo, bb + 2);
      }
    }
    __syncthreads();                         // stage st is refilled next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long fr = row0 + warp * 16 + g + 8 * i;
    if (fr >= n_rows) continue;
    const int h = kvh * group + (int)(fr % group);
    bf16* orow = o + ((b * (long long)S + qpos[i]) * H + h) * D + 2 * t;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NTD; ++n)
      *reinterpret_cast<unsigned*>(orow + n * 8) =
          pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int S,
                       int H, int Hkv, int window, float scale, float cap,
                       cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (size_t)(MROWS + 4 * MBK) * (D + 8);
  auto kern = flash_mma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_rows = (long long)S * (H / Hkv);
  const dim3 grid((unsigned)((n_rows + MROWS - 1) / MROWS), (unsigned)(B * Hkv));
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                        static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H,
                                        Hkv, window, scale, cap);
  return cudaGetLastError();
}

template <typename T, int NCH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                   int H, int Hkv, int D, int window, float scale, float cap,
                   cudaStream_t stream) {
  const int Dp = (D + 3) / 4 * 4;
  const size_t smem = sizeof(float) * ((size_t)BLOCK_ROWS * Dp + (size_t)BK * (Dp + 4) +
                                       (size_t)BK * Dp);
  auto kern = flash_fwd_kernel<T, NCH>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_rows = (long long)S * (H / Hkv);
  const dim3 grid((unsigned)((n_rows + BLOCK_ROWS - 1) / BLOCK_ROWS), (unsigned)(B * Hkv));
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(o), S, H,
                                        Hkv, D, Dp, window, scale, cap);
  return cudaGetLastError();
}

}  // namespace

// q: (B,S,H,D); k, v: (B,S,Hkv,D); o: (B,S,H,D); all contiguous, one dtype
// (0 = float32, 1 = bfloat16). window <= 0 = full causal; cap <= 0 = no cap.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int H, int Hkv, int D, int window,
                                   float scale, float cap, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 256 || B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = D > 128;
  if (dtype == 1) {
    if (D == 256) return (int)launch_mma<256>(q, k, v, o, B, S, H, Hkv, window, scale, cap, st);
    if (D == 128) return (int)launch_mma<128>(q, k, v, o, B, S, H, Hkv, window, scale, cap, st);
    if (D == 64) return (int)launch_mma<64>(q, k, v, o, B, S, H, Hkv, window, scale, cap, st);
  }
  if (dtype == 1)
    return (int)(wide ? launch<__nv_bfloat16, 2>(q, k, v, o, B, S, H, Hkv, D, window, scale, cap, st)
                      : launch<__nv_bfloat16, 1>(q, k, v, o, B, S, H, Hkv, D, window, scale, cap, st));
  if (dtype == 0)
    return (int)(wide ? launch<float, 2>(q, k, v, o, B, S, H, Hkv, D, window, scale, cap, st)
                      : launch<float, 1>(q, k, v, o, B, S, H, Hkv, D, window, scale, cap, st));
  return (int)cudaErrorInvalidValue;
}
